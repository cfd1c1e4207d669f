"""The PyTorch port (``horovod_tpu_torch``) stands alone: it imports torch,
numpy and the standard library, never jax, flax, ml_dtypes or the JAX
package.

Mind the prefix: ``horovod_tpu_torch`` starts with ``horovod_tpu``, so a
module counts as the JAX package only when it IS ``horovod_tpu`` or lies
under ``horovod_tpu.``.
"""

import ast
import json
import os
import pkgutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "horovod_tpu_torch")
# ml_dtypes too: JAX's payload codec falls back to it for bf16 / fp8, and
# the card's machine does not have it.
FORBIDDEN_ROOTS = ("jax", "jaxlib", "flax", "optax", "horovod_tpu",
                   "ml_dtypes")


def _forbidden(module: str) -> bool:
    root = module.split(".", 1)[0]
    return root in FORBIDDEN_ROOTS


def _port_modules():
    import horovod_tpu_torch
    names = ["horovod_tpu_torch"]
    for info in pkgutil.walk_packages(horovod_tpu_torch.__path__,
                                      "horovod_tpu_torch."):
        names.append(info.name)
    return sorted(names)


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_forbidden_prefix_rule():
    assert _forbidden("horovod_tpu")
    assert _forbidden("horovod_tpu.serve.engine")
    assert _forbidden("jax.numpy")
    assert not _forbidden("horovod_tpu_torch.serve.engine")
    assert not _forbidden("torch")


def test_importing_every_port_module_loads_no_jax():
    """A fresh interpreter imports every module of the port (and the chip
    smoke script); afterwards ``sys.modules`` holds nothing of jax, flax
    or the JAX package."""
    modules = _port_modules()
    for name in ("serve.engine", "csrc.build", "config", "exceptions",
                 "topology", "process_sets", "core", "compression",
                 "ops", "ops.collective_ops", "ops.fusion", "ops.eager",
                 "functions", "sparse", "version", "optimizer",
                 "parallel.flash", "models.transformer",
                 "examples.bert_pretraining", "serve.sampling",
                 "serve.replica", "serve.server", "models.mlp",
                 "models.convert", "ops.adasum", "callbacks",
                 "examples.gpt2_adasum", "examples.adasum_bench",
                 "csrc.native", "ops.negotiation", "timeline",
                 "examples.join_bench", "parallel.ring",
                 "parallel.ulysses", "examples.seqpar_bench",
                 "parallel.moe", "parallel.tensor", "parallel.pipeline",
                 "examples.model_parallel_bench", "checkpoint",
                 "elastic", "elastic.state", "elastic.sampler",
                 "elastic.driver", "elastic.discovery",
                 "elastic.registration", "elastic.launch_support",
                 "runner", "runner.launch", "runner.http_server",
                 "runner.hosts", "runner.safe_shell_exec", "data",
                 "data.data_loader_base", "data.service", "autotune",
                 "optim", "examples.elastic_resnet", "faultline",
                 "faultline.plan", "faultline.runtime",
                 "serve.streaming", "serve.structured",
                 "serve.registry", "obs", "obs.tracing", "obs.merge",
                 "obs.cli", "serve.router", "serve.router_server",
                 "serve.controller", "elastic.preemption",
                 "serve.tiering", "serve.seqpar", "analysis",
                 "analysis.findings", "analysis.rules", "analysis.linter",
                 "analysis.lockgraph", "analysis.witness",
                 "analysis.memplan", "analysis.shardplan", "analysis.cli",
                 "analysis.__main__", "analysis.graph_check",
                 "analysis.hook", "runner.lsf", "runner.jsrun_shim",
                 "runner.nic_probe", "spark", "spark.store",
                 "spark.estimator", "spark.elastic", "spark_integration",
                 "ray", "ray_integration", "ray_elastic"):
        assert f"horovod_tpu_torch.{name}" in modules, name
    code = (
        "import importlib, json, sys\n"
        f"for m in {modules!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in loaded if _forbidden(m)]
    assert not bad, f"the port pulled in {bad}"
    assert "torch" in loaded


def _imports_of(path):
    """Absolute names of every module a file imports (relative imports
    resolved against the file's package)."""
    rel = os.path.relpath(path, REPO)
    package = os.path.dirname(rel).replace(os.sep, ".")
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                names.append(node.module)
                continue
            parts = package.split(".") if package else []
            base = parts[:len(parts) - (node.level - 1)]
            names.append(".".join(base + ([node.module] if node.module
                                          else [])))
    return names


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_port_file_imports_jax(path):
    """AST scan: no import statement of the port, at any depth (inside
    functions too), names jax, flax or the JAX package; relative imports
    stay inside ``horovod_tpu_torch``."""
    names = _imports_of(path)
    bad = [n for n in names if _forbidden(n)]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"
    if path.startswith(PORT):
        for n in names:
            if n.startswith("horovod_tpu"):
                assert n.startswith("horovod_tpu_torch"), n


@pytest.mark.parametrize("name", ["serve/blocks.py", "serve/batcher.py",
                                  "serve/tenancy.py", "exceptions.py",
                                  "version.py", "timeline.py", "optim.py",
                                  "autotune.py", "runner/hosts.py",
                                  "runner/safe_shell_exec.py",
                                  "serve/structured.py",
                                  "faultline/__init__.py",
                                  "faultline/runtime.py"])
def test_copied_modules_match_their_source(name):
    """The pure-Python modules the port copies keep the source's code:
    only the module docstring (which names the source) differs."""
    def body(path):
        with open(path) as f:
            tree = ast.parse(f.read())
        if (tree.body and isinstance(tree.body[0], ast.Expr)
                and isinstance(tree.body[0].value, ast.Constant)):
            doc = tree.body[0].value.value
            tree.body = tree.body[1:]
        else:
            doc = ""
        return doc, ast.dump(tree)

    doc, port = body(os.path.join(PORT, name))
    _, src = body(os.path.join(REPO, "horovod_tpu", name))
    assert f"horovod_tpu/{name}" in doc
    assert port == src


_LOGGER_IMPORT = {"removed": {"from ..utils import get_logger"},
                  "added": {"from ..utils.logging import get_logger"}}

# The copies that differ from their source on purpose, each difference
# named by symbol (``Class.method`` for a method, the source text for an
# import): what the source has and the copy does not ("removed"), what
# both have but not alike ("changed"), what only the copy has ("added").
# Docstrings are not compared.  Every copy imports its logger from
# ``utils.logging``: the port's ``utils`` package re-exports nothing.
COPY_EDITS = {
    "serve/streaming.py": {},
    "faultline/plan.py": {},
    "obs/tracing.py": {},
    "obs/merge.py": {},
    # The CLIs' help text names no document of the JAX package.
    "obs/cli.py": {"changed": {"run_commandline"}},
    "obs/__init__.py": {},
    "serve/controller.py": {},
    "serve/router.py": {},
    "serve/router_server.py": {"changed": {"run_commandline"}},
    "elastic/preemption.py": {},
    "elastic/discovery.py": dict(_LOGGER_IMPORT),
    "elastic/registration.py": {},
    "elastic/launch_support.py": {},
    "elastic/sampler.py": {},
    "elastic/driver.py": dict(
        _LOGGER_IMPORT,
        # Stops the driver and the rendezvous in ``finally``.
        changed={"launch_elastic"}),
    "runner/http_server.py": dict(
        _LOGGER_IMPORT,
        # A native server that fails to build or bind raises (no fallback
        # to Python); ``STARTS`` counts the servers started by backend;
        # the Python listener's backlog is 128.
        changed={"KVStoreServer.start"},
        added=_LOGGER_IMPORT["added"] | {
            "STARTS", "_KVHTTPServer", "_KVHTTPServer.request_queue_size"}),
    "runner/launch.py": dict(
        # No flags of knobs the port does not read; ``--check-build``
        # reports PyTorch, NCCL and gloo; the store's base port lies below
        # the ephemeral range; the jsrun shim and the NIC probe are the
        # port's modules.
        changed={"check_build", "parse_args", "_apply_config_file",
                 "env_from_args", "_run_static", "_jsrun_spawn",
                 "pick_coordinator_base_port"},
        added={"_ephemeral_port_range"}),
    # The pickled function's error names the port.
    "runner/__init__.py": {"changed": {"run"}},
    "runner/lsf.py": {},
    "runner/jsrun_shim.py": {},
    "runner/nic_probe.py": {},
    "spark/store.py": {},
    # A slot whose incarnation adopted the newer world and published
    # that world's result is not launched again; it is settled for that
    # world under the driver's lock (``_settle``).
    "spark/elastic.py": {"changed": {"run_elastic"}, "added": {"_settle"}},
    "spark/__init__.py": {},
    # The missing-package errors name the port.
    "spark_integration.py": {"changed": {"_require_pyspark", "run"}},
    "ray_integration.py": {"changed": {"_require_ray"}},
    "ray_elastic.py": {"changed": {"_require_ray"}},
    "ray.py": {},
    # The estimator's torch idiom: an nn.Module with its weights, an
    # optimizer factory, named losses in torch.nn.functional, a state_dict
    # checkpoint, a transformer holding the one trained module and
    # predicting on a device (the workers' platform after a fit).  RowGroupStream and the data layer stay
    # JAX's.
    "spark/estimator.py": dict(
        changed={"_resolve_loss", "_estimator_train_fn",
                 "_estimator_train_loop", "HorovodTpuEstimator.__init__",
                 "HorovodTpuEstimator.fit",
                 "_append_predictions", "_transform_partition",
                 "TpuTransformer.__init__", "TpuTransformer.predict",
                 "TpuTransformer._udf_payload", "TpuTransformer.transform",
                 "TpuTransformer.save", "TpuTransformer.load"},
        added={"WORKER_PLATFORMS", "_mse", "_mae",
               "_sparse_categorical_crossentropy", "_to_tensor"}),
    "data/service.py": dict(
        # Batches are pickled with their tensors on the host.
        removed=_LOGGER_IMPORT["removed"],
        changed={"DataServiceWorker.start"},
        added=_LOGGER_IMPORT["added"] | {"_to_host"}),
    "data/data_loader_base.py": dict(
        # ``device_prefetch`` copies to the rank's device.
        changed={"ShardedDataLoader.__init__", "ShardedDataLoader._iterate"},
        added={"import torch", "_tree_to"}),
    # hvdlint's host-side half.  The catalogue keeps the rules the port
    # fires, worded for torch.
    "analysis/findings.py": dict(
        removed={"from typing import Dict, Optional"},
        changed={"RULES"}, added={"from typing import Dict"}),
    # The traced-code and serving rules read torch's spellings; the
    # collective rules also torch.distributed's, HVD006 the port's axis
    # keywords.
    "analysis/rules.py": dict(
        removed={"PRNG_KEY_FNS", "SYNC_DOTTED", "_HOST_NP_ALIASES",
                 "_chain_attrs"},
        changed={"HOST_EFFECT_DOTTED", "HOST_EFFECT_DOTTED_ROOTS",
                 "MUTATOR_METHODS", "SYNC_METHODS", "TRACER_CALLS",
                 "_Module._decorator_traces", "_Module._mark_traced_roots",
                 "_axis_use", "_check_mutation", "_host_effect",
                 "_is_collective_call", "_rule_lock_held_sync",
                 "_rule_serve_prng", "_rule_traced_body_calls",
                 "_sync_call_kind", "_unseeded_random"},
        added={"AXIS_KEYWORDS", "DIST_BASES", "DIST_COLLECTIVES",
               "TORCH_RANDOM_FNS", "_GLOBAL_RNG_BASES", "_is_tracer"}),
    # The walk prunes the kernel build's directory.
    "analysis/linter.py": {"changed": {"_SKIP_DIRS"}},
    # HVD201's compiled-step arm names torch.compile; HVD202's message
    # names the shape by its component.
    "analysis/lockgraph.py": {"changed": {"_Analyzer._check_blocking",
                                          "_Analyzer._check_callback"}},
    "analysis/witness.py": {},
    "analysis/__main__.py": {},
    # No --mem pass (torch has no donate_argnums to read).
    "analysis/cli.py": dict(removed={"_run_mem", "run_commandline"},
                            changed={"PASSES", "build_parser"}),
    # The graph source is a make_fx trace: analyze_traceable walks its
    # graph (no donation to read; shard_step's specs feed HVD402), and
    # DistributedOptimizer calls analyze_reduction where optax's update
    # was wrapped.
    "analysis/hook.py": dict(
        removed={"wrap_optimizer", "_maybe_analyze_update"},
        changed={"analyze_traceable"},
        added={"analyze_reduction", "next_instance"}),
}


def _symbols(path):
    """Each top-level statement and each class member of ``path``, by
    name, as its AST without docstrings."""
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                node.body = body[1:] or [ast.Pass()]

    def name(node):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return node.name
        if isinstance(node, ast.Assign):
            return ", ".join(ast.unparse(t) for t in node.targets)
        if isinstance(node, ast.AnnAssign):
            return ast.unparse(node.target)
        return ast.unparse(node)

    out = {}
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            members, node.body = node.body, []
            out[node.name] = ast.dump(node)
            for m in members:
                out[f"{node.name}.{name(m)}"] = ast.dump(m)
        else:
            out[name(node)] = ast.dump(node)
    return out


@pytest.mark.parametrize("name", sorted(COPY_EDITS))
def test_copies_differ_from_their_source_only_where_stated(name):
    """A copy drifts from its source only in the symbols ``COPY_EDITS``
    names, and each symbol named there does differ."""
    port = _symbols(os.path.join(PORT, name))
    src = _symbols(os.path.join(REPO, "horovod_tpu", name))
    found = {
        "removed": {k for k in src if k not in port},
        "changed": {k for k in src if k in port and port[k] != src[k]},
        "added": {k for k in port if k not in src},
    }
    stated = {k: set(COPY_EDITS[name].get(k, ())) for k in found}
    assert found == stated
    with open(os.path.join(PORT, name)) as f:
        doc = ast.get_docstring(ast.parse(f.read())) or ""
    assert f"horovod_tpu/{name}" in doc


def test_analysis_package_is_under_the_ban():
    """The analyzers are the port's own copies: every file of
    ``analysis/`` is among the files the AST scan above holds to the
    ban, and none of them imports torch at module level (the CLI runs
    on a bare interpreter)."""
    files = [f for f in _port_files()
             if os.sep + "analysis" + os.sep in f]
    assert sorted(os.path.basename(f) for f in files) == [
        "__init__.py", "__main__.py", "cli.py", "findings.py",
        "graph_check.py", "hook.py", "linter.py", "lockgraph.py",
        "memplan.py", "rules.py", "shardplan.py", "witness.py"]
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        top = [a.name for node in tree.body if isinstance(node, ast.Import)
               for a in node.names]
        top += [node.module for node in tree.body
                if isinstance(node, ast.ImportFrom) and node.level == 0]
        assert not [m for m in top if m and (m == "torch" or _forbidden(m))]


def test_native_core_builds_from_the_port_alone():
    """The native core is built from ``horovod_tpu_torch/csrc/hvd_core.cc``
    and ``kv_server.cc``, which include system headers only, into the
    port's ``_build``; the build command names no file outside the
    port."""
    from horovod_tpu_torch.csrc import native
    assert native.SOURCE == os.path.join(PORT, "csrc", "hvd_core.cc")
    assert native.SOURCES == (native.SOURCE,
                              os.path.join(PORT, "csrc", "kv_server.cc"))
    assert native.library_path().startswith(
        os.path.join(PORT, "csrc", "_build") + os.sep)
    for source in native.SOURCES:
        with open(source) as f:
            includes = [line for line in f if line.startswith("#include")]
        assert includes and all("<" in line and '"' not in line
                                for line in includes)
    with open(native.__file__) as f:
        text = f.read()
    assert "libhvdcore.so" not in text
    assert "horovod_tpu.csrc" not in text
