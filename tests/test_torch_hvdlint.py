"""The port's AST linter against the JAX package's, on the JAX corpus.

Every source string of ``tests/test_hvdlint.py`` (read from that file,
so the corpus stays the JAX tests' own) goes through both linters, once
under a plain path and once under a ``serve/`` path:

* the framework-neutral sources — rank-guarded and swallowed
  collectives (HVD001, HVD002), undeclared axes (HVD006), swallowed
  faults (HVD009), the collective-name heuristics — give identical
  ``(rule, line, col, suppressed)`` lists;
* the jax-spelled sources (``jax.jit``, ``block_until_ready``,
  ``jax.random``, ``jax.device_get``) are rewritten in torch's
  spellings (``torch.compile``, ``.item()`` / ``.cpu()`` / ``.tolist()``,
  ``torch.Generator().manual_seed``, ``torch.rand*``) on the same lines,
  and the port's ``(rule, line, suppressed)`` on the rewrite equals
  JAX's on the original.

Then the torch-only shapes (``torch.distributed`` collectives, the
global torch generator in serving code, a stream's ``synchronize``),
HVD000, one pragma silencing both linters, and the CLI's exit codes
against JAX's on ``tests/test_analysis_cli.py``'s cases.
"""

import ast
import json
import os
import re
import textwrap

import pytest

from horovod_tpu.analysis import lint_source as jax_lint
from horovod_tpu.analysis.cli import main as jax_cli
from horovod_tpu_torch.analysis import (RULES, lint_paths, lint_source,
                                        unsuppressed)
from horovod_tpu_torch.analysis.cli import PASSES, build_parser
from horovod_tpu_torch.analysis.cli import main as cli_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATHS = ("corpus.py", "horovod_tpu_torch/serve/corpus.py")


def corpus_sources(test_file):
    """``{(test name, variable): dedented source}`` for every string
    literal a test function of ``test_file`` assigns to a name, plus the
    module-level ones."""
    tree = ast.parse(open(os.path.join(REPO, "tests", test_file)).read())
    out = {}
    for top in tree.body:
        scope = top.name if isinstance(top, ast.FunctionDef) else "<module>"
        if scope != "<module>" and not scope.startswith("test_"):
            continue
        nodes = ast.walk(top) if scope != "<module>" else [top]
        for node in nodes:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, ast.Constant) \
                    and isinstance(node.value.value, str) \
                    and "\n" in node.value.value:
                out[(scope, node.targets[0].id)] = textwrap.dedent(
                    node.value.value)
    return out


LINT_CORPUS = corpus_sources("test_hvdlint.py")

# Spellings that only the JAX package's traced-code and serving rules
# read: a source holding one of them needs a torch rewrite.
JAX_SPELLED = re.compile(r"jax\.jit|@jit|jax\.random|device_get|"
                         r"block_until_ready|jax\.debug|jnp|\.at\[|"
                         r"np\.asarray")


def to_torch(src):
    """The mechanical part of a rewrite: the tracer and its import."""
    return (src.replace("import jax\n", "import torch\n")
            .replace("@jax.jit", "@torch.compile")
            .replace("jax.jit(", "torch.compile("))


# Sources whose rewrite is more than ``to_torch``: the torch spelling of
# each construct sits on the JAX line it replaces.
REWRITES = {
    ("test_hvd003_clean_seeded_and_untraced", "src"): """\
import torch
import numpy as np

def host_data():
    return np.random.rand(8)          # not traced: fine

@torch.compile
def step(x, gen):
    rng = np.random.RandomState(0)    # seeded: fine
    return x + torch.randn(x.shape, generator=gen)
""",
    ("test_hvd004_print_in_traced_fn_and_clean_debug_print", "src"): """\
import torch

@torch.compile
def step(x):
    print("tracing", x)
    x = x * 2
    return x
""",
    ("test_hvd005_block_until_ready_in_traced_fn", "src"): """\
import torch

@torch.compile
def step(x):
    y = (x * 2).sum().item()
    return x.cpu()
""",
    ("test_hvd007_clean_local_mutation_and_functional_update", "src"): """\
import torch

@torch.compile
def step(x, buf):
    local = {}
    local["x"] = x              # local: fine
    buf = buf.add(x)            # out of place: fine
    return x, buf
""",
    ("test_hvd010_clock_seeded_serving_prng", "src"): """\
import time
import torch

def handler():
    return torch.Generator().manual_seed(int(time.time()))
""",
    ("test_hvd010_clock_seeded_serving_prng", "src_dt"): """\
import datetime
import torch

def handler():
    seed = int(datetime.datetime.now().timestamp())
    return torch.Generator().manual_seed(seed)
""",
    ("test_hvd010_clock_seeded_serving_prng", "src_inline"): """\
import datetime
import torch

def handler():
    return torch.Generator().manual_seed(
        int(datetime.datetime.now().timestamp()))
""",
    ("test_hvd010_constant_seeded_serving_prng", "src"): """\
import torch

def handler():
    g = torch.Generator().manual_seed(0)
    return torch.randint(0, 9, (1,), generator=g)
""",
    ("test_hvd010_constant_seeded_serving_prng", "both_const"): """\
import torch

def handler():
    return torch.Generator().manual_seed(seed * 1000 + 3)
""",
    ("test_hvd010_request_derived_keys_are_clean_and_rule_is_serve_scoped",
     "clean"): """\
import torch

def seq_key(seed, sample_index):
    key = torch.Generator().manual_seed((seed % (2 ** 31)) * 7919
                                        + sample_index)
    return key

def token_draw(gen, probs):
    return torch.multinomial(probs, 1, generator=gen)
""",
    ("test_hvd010_request_derived_keys_are_clean_and_rule_is_serve_scoped",
     "dirty_elsewhere"): """\
import torch
g = torch.Generator().manual_seed(0)
""",
    ("test_hvd010_request_derived_keys_are_clean_and_rule_is_serve_scoped",
     "not_prng"): """\
def f(d):
    return d.seed(0)
""",
    ("test_hvd011_sync_under_lock_three_shapes", "src"): """\
import torch
import numpy as np

class Engine:
    def snapshot(self):
        with self._lock:
            out = self._logits.tolist()
            host = self._kv.cpu()
            arr = self._cache.item()
        return out, host, arr
""",
    ("test_hvd011_snapshot_then_fetch_is_clean_and_serve_scoped",
     "clean"): """\
import torch
import numpy as np

class Engine:
    def snapshot(self):
        with self._lock:
            ref = self._logits
            dev = torch.as_tensor(self._cache)
        return ref.tolist(), dev
""",
    ("test_hvd011_snapshot_then_fetch_is_clean_and_serve_scoped",
     "dirty_elsewhere"): """\
import torch

def checkpoint(state, lock):
    with lock:
        return state.cpu()
""",
    ("test_hvd011_nested_defs_and_acquire_spelling", "src"): """\
import torch

class Engine:
    def deferred(self):
        with self._lock:
            def fetch():
                return self._kv.cpu()
            self._pending = fetch
        return self._pending

    def direct(self, lock):
        with self._kv_lock.acquire():
            a = self._kv.cpu()
        with lock:
            b = self._x.item()
        return a, b
""",
}

NEUTRAL = sorted(k for k, src in LINT_CORPUS.items()
                 if k not in REWRITES and not JAX_SPELLED.search(src))
SPELLED = sorted(k for k in LINT_CORPUS if k not in NEUTRAL)


def _full(findings):
    return [(f.rule, f.line, f.col, f.suppressed) for f in findings]


def _short(findings):
    return [(f.rule, f.line, f.suppressed) for f in findings]


def test_corpus_is_read_and_split():
    """The JAX corpus was found, and every jax-spelled source has a
    rewrite that no longer spells jax."""
    assert len(LINT_CORPUS) >= 40
    assert len(NEUTRAL) >= 15 and len(SPELLED) >= 20
    for key in SPELLED:
        torch_src = REWRITES.get(key, to_torch(LINT_CORPUS[key]))
        assert "jax" not in torch_src and "jnp" not in torch_src, key


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("key", NEUTRAL, ids="/".join)
def test_neutral_sources_give_identical_findings(key, path):
    src = LINT_CORPUS[key]
    assert _full(lint_source(src, path=path)) == \
        _full(jax_lint(src, path=path))


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("key", SPELLED, ids="/".join)
def test_torch_rewrites_fire_where_jax_fires(key, path):
    src = LINT_CORPUS[key]
    torch_src = REWRITES.get(key, to_torch(src))
    assert len(torch_src.splitlines()) == len(src.splitlines())
    assert _short(lint_source(torch_src, path=path)) == \
        _short(jax_lint(src, path=path))


def test_hvd000_syntax_error_is_identical():
    for src in ("def broken(:\n    pass\n", "x = (\n"):
        got, want = lint_source(src, path="bad.py"), \
            jax_lint(src, path="bad.py")
        assert [f.to_dict() for f in got] == [f.to_dict() for f in want]
        assert [f.rule for f in got] == ["HVD000"]


def test_one_pragma_silences_both_linters():
    src = """\
import horovod_tpu_torch as hvd

def main(x):
    if hvd.rank() == 0:
        x = hvd.allreduce(x)  # hvdlint: disable=HVD001
    return x
"""
    for lint in (lint_source, jax_lint):
        assert _short(lint(src)) == [("HVD001", 5, True)]


def _fired(src, path="corpus.py"):
    return [(f.rule, f.line) for f in lint_source(textwrap.dedent(src),
                                                  path=path)
            if not f.suppressed]


def test_torch_distributed_collectives_count_through_a_dist_base():
    src = """\
    import torch
    import torch.distributed as dist

    def main(x, rank):
        if rank == 0:
            dist.all_reduce(x)
        try:
            dist.barrier()
        except Exception:
            pass
        y = torch.gather(x, 0, x.long())
        if rank == 0:
            z = torch.distributed.broadcast(x, src=0)
        return y
    """
    assert _fired(src) == [("HVD001", 6), ("HVD002", 8), ("HVD009", 8),
                           ("HVD001", 13)]


def test_global_torch_generator_in_serving_code():
    src = """\
    import torch

    def handler(probs, seed):
        torch.manual_seed(seed)
        a = torch.multinomial(probs, 1)
        torch.cuda.manual_seed_all(seed)
        g = torch.Generator().manual_seed(seed)
        return a, torch.multinomial(probs, 1, generator=g)
    """
    assert _fired(src, path="x/serve/corpus.py") == [
        ("HVD010", 4), ("HVD010", 5), ("HVD010", 6)]
    assert _fired(src) == []


def test_torch_tracers_and_syncs():
    src = """\
    import functools
    import re
    import time
    import torch

    PAT = re.compile("x")

    @functools.partial(torch.compile, mode="max-autotune")
    def a(x):
        return x + time.time()

    def b(x):
        torch.cuda.synchronize()
        return x.numpy()

    c = torch.jit.trace(b, (1,))

    def host(x):
        return x.item() + time.time()
    """
    assert _fired(src) == [("HVD008", 10), ("HVD005", 13),
                           ("HVD005", 14)]


def test_stream_synchronize_under_a_serve_lock():
    src = """\
    class Engine:
        def step(self):
            with self._lock:
                self._stream.synchronize()
            self._event.synchronize()
    """
    assert _fired(src, path="serve/corpus.py") == [("HVD011", 4)]


def test_axis_keywords_are_checked_against_the_mesh():
    src = """\
    from horovod_tpu_torch.parallel import make_mesh

    def step(opt, ring, q):
        mesh = make_mesh({"dp": 2, "sp": 2})
        opt = DistributedOptimizer(opt, reduce_axes=("dp", "tp"))
        return ring(q, axis_name="sp"), opt
    """
    assert _fired(src) == [("HVD006", 5)]


def test_catalogue_holds_only_rules_the_port_fires():
    have = set(RULES)
    assert {"HVD000", "HVD001", "HVD011", "HVD100", "HVD101", "HVD102",
            "HVD200", "HVD203", "HVD210", "HVD211", "HVD300", "HVD302",
            "HVD303", "HVD304", "HVD401", "HVD402", "HVD403",
            "HVD404"} <= have
    assert not have & {"HVD301", "HVD400"}
    for rule in RULES.values():
        assert "jax" not in (rule.summary + rule.fix_hint).lower(), rule.id


# -- the CLI against the JAX CLI ------------------------------------------------

DIRTY_LINT = """\
import horovod_tpu as hvd

def train():
    if hvd.rank() == 0:
        hvd.allreduce_("x", 1.0)
"""

# A dead mesh axis both --comm passes read: "tp" is named, "dp" never.
DIRTY_COMM = """\
from horovod_tpu_torch.parallel import P, make_mesh

def step(x):
    mesh = make_mesh({"dp": 2, "tp": 2})
    return shard(x, P(None, "tp"))
"""

DIRTY_RACE = """\
import threading

class Srv:
    def start(self):
        self._thread = threading.Thread(target=print)
        self._thread.start()
"""


@pytest.fixture()
def cli_corpus(tmp_path):
    (tmp_path / "dirty_lint.py").write_text(DIRTY_LINT)
    (tmp_path / "dirty_comm.py").write_text(DIRTY_COMM)
    (tmp_path / "dirty_race.py").write_text(DIRTY_RACE)
    (tmp_path / "clean.py").write_text("x = 1\n")
    (tmp_path / "bad.py").write_text("def broken(:\n")
    return tmp_path


CLI_CASES = [
    ([], "dirty_lint.py"), ([], "clean.py"), ([], "bad.py"),
    ([], "/nonexistent/hvdlint/path"), ([], "."),
    (["--race"], "dirty_race.py"), (["--race"], "clean.py"),
    (["--race"], "bad.py"), (["--race"], "/nonexistent/race/path"),
    (["--race", "--ignore", "HVD203"], "."),
    (["--race", "--select", "HVD201"], "."),
    (["--comm"], "dirty_comm.py"), (["--comm"], "clean.py"),
    (["--comm"], "bad.py"), (["--comm"], "/nonexistent/hvdshard/path"),
    (["--comm", "--select", "HVD4"], "dirty_comm.py"),
    (["--comm", "--ignore", "HVD4"], "dirty_comm.py"),
    (["--select", "HVD4"], "dirty_comm.py"),
    (["--all"], "."), (["--all"], "clean.py"),
    (["--all", "--ignore", "HVD0,HVD2,HVD4"], "."),
    (["--list-rules"], None), (["--comm", "--race"], "."),
    (["--all", "--comm"], "."), (["--format", "yaml"], "."),
]


@pytest.mark.parametrize("args,target", CLI_CASES,
                         ids=[" ".join(a + [t or ""]) for a, t in CLI_CASES])
def test_cli_exit_codes_equal_jax(cli_corpus, capsys, args, target):
    argv = list(args)
    if target is not None:
        argv.append(target if target.startswith("/")
                    else str(cli_corpus / target).rstrip("."))

    def run(main):
        try:
            return main(argv)
        except SystemExit as e:  # argparse's usage errors
            return e.code

    want, got = run(jax_cli), run(cli_main)
    capsys.readouterr()
    assert got == want


def test_cli_json_and_passes(cli_corpus, capsys):
    assert list(PASSES) == ["lint", "race", "comm"]
    rc = cli_main(["--comm", "--format", "json",
                   str(cli_corpus / "dirty_comm.py")])
    payload = json.loads(capsys.readouterr().out)
    assert rc == 1 and payload["pass"] == "comm"
    assert payload["summary"]["by_rule"] == {"HVD404": 1}
    (f,) = payload["findings"]
    assert (f["rule"], f["line"], f["source"]) == ("HVD404", 4, "comm")
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--mem", "."])
    capsys.readouterr()


def test_lint_paths_dedups_and_prunes(cli_corpus):
    (cli_corpus / "_build").mkdir()
    (cli_corpus / "_build" / "x.py").write_text("def broken(:\n")
    fs = lint_paths([str(cli_corpus / "dirty_lint.py"), str(cli_corpus)])
    assert sorted((os.path.basename(f.path), f.rule)
                  for f in unsuppressed(fs)) == [
        ("bad.py", "HVD000"), ("dirty_lint.py", "HVD001")]
