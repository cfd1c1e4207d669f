"""Build and load the port's CUDA kernels.

``nvcc`` compiles the sources in this directory into one shared library
with a plain C interface, for ``sm_90a`` (Hopper), which ``ctypes``
loads.  The build runs at first use, from the repository's sources
only, into ``_build/<hash>/`` beside this file (listed in .gitignore);
the hash covers the sources and the flags, so an edited source builds
anew and an unchanged one is reused.  Nothing here runs at import time:
the CPU tests import every module of the package on a machine without
``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional, Tuple

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("paged_attention.cu",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libhvd_torch_kernels.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else
    the first ``nvcc`` on PATH."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built")
    return found


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(_HERE, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build() -> Tuple[str, str]:
    """Compile the kernels unless this source hash is already built.
    Returns ``(library path, compiler log)``; the log holds ``ptxas``'s
    register, shared-memory and spill report for every kernel."""
    out_dir = os.path.join(_HERE, "_build", _source_hash())
    lib_path = os.path.join(out_dir, LIB_NAME)
    log_path = os.path.join(out_dir, "build.log")
    if os.path.exists(lib_path):
        with open(log_path) as f:
            return lib_path, f.read()
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           *(os.path.join(_HERE, s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n{log}")
    with open(log_path, "w") as f:
        f.write(log)
    os.replace(tmp, lib_path)  # atomic: a reader never sees half a file
    return lib_path, log


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process,
    with ``argtypes``/``restype`` declared for every entry point."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(path)
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.hvd_paged_attention.argtypes = [
                p, p, p, p, p, p, p, p, p,  # q k v ks vs tables pos out scratch
                i, i, i, i, i, i, i, i,     # B C H Dh NB BT MB split_blocks
                ctypes.c_float, i, i, i,    # scale mask q_kind kv_kind
                p]                          # stream
            lib.hvd_paged_attention.restype = i
            lib.hvd_cuda_error_string.argtypes = [i]
            lib.hvd_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib
