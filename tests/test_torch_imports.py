"""The PyTorch port (``horovod_tpu_torch``) stands alone: it imports torch,
numpy and the standard library, never jax, flax or the JAX package.

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
FORBIDDEN_ROOTS = ("jax", "jaxlib", "flax", "optax", "horovod_tpu")


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
    assert "horovod_tpu_torch.serve.engine" in modules
    assert "horovod_tpu_torch.csrc.build" in modules
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
                                  "serve/tenancy.py"])
def test_copied_modules_match_their_source(name):
    """The pure-Python serving modules the port copies keep the source's
    code: only the module docstring (which names the source) differs."""
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
