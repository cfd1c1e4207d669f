"""ctypes bindings for the port's native control-plane core.

Port of ``horovod_tpu/csrc/__init__.py:165-424``: ``NativeResponseCache``,
``NativeMessageTable``, ``plan_fusion``, ``NativeTensorQueue`` and
``NativeStallInspector`` over ``hvd_core.cc``, and ``NativeKVServer`` over
``kv_server.cc`` (the KV / rendezvous server ``runner/http_server.py``
runs by default), both in this directory (copies of the JAX package's
sources).

The host C++ compiler builds ONE library from both sources at first use,
never at import, as the JAX package's Makefile does:
``g++ -O2 -std=c++17 -shared -fPIC hvd_core.cc kv_server.cc -lpthread``
into ``_build/libhvdcore-<hash>.so`` beside this file (listed in
.gitignore), where the hash covers the sources and the flags, so an
edited source builds anew.  Processes that race on the first use (the
ranks of a world, the test workers) take an exclusive file lock; one
builds, writing to a temporary name and renaming it, and the others
load the finished library.  A failed build raises: there is no Python
stand-in for the core.
"""

from __future__ import annotations

import base64
import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional, Sequence, Tuple

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "hvd_core.cc")
KV_SOURCE = os.path.join(_HERE, "kv_server.cc")
SOURCES = (SOURCE, KV_SOURCE)
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
LIBS = ("-lpthread",)
ABI = 2  # hvd_core_abi_version() of the source

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler (g++) on PATH: the native "
                           "core cannot be built")
    return cxx


def library_path() -> str:
    """Where the build of these sources and these flags lands."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    for src in SOURCES:
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(_HERE, "_build",
                        f"libhvdcore-{h.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    import fcntl
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(os.path.join(os.path.dirname(path), ".hvdcore.lock"),
              "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            if os.path.exists(path):
                return  # another process built it while this one waited
            tmp = f"{path}.{os.getpid()}.tmp"
            res = subprocess.run(
                [_cxx(), *CXX_FLAGS, "-o", tmp, *SOURCES, *LIBS],
                capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(
                    f"building the native core from "
                    f"{' and '.join(SOURCES)} failed:\n{res.stderr}")
            os.replace(tmp, path)
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def lib() -> ctypes.CDLL:
    """The native core, built at its first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path):
            _build(path)
        l = ctypes.CDLL(path)
        l.hvd_core_abi_version.restype = ctypes.c_int
        if l.hvd_core_abi_version() != ABI:
            raise RuntimeError(f"{path} reports ABI "
                               f"{l.hvd_core_abi_version()}, expected {ABI}")
        sig = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
               ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int,
               ctypes.c_double, ctypes.c_double, ctypes.c_int]
        vp, cp = ctypes.c_void_p, ctypes.c_char_p
        for name, res, args in (
                ("hvd_cache_create", vp, [ctypes.c_int64]),
                ("hvd_cache_destroy", None, [vp]),
                ("hvd_cache_lookup", ctypes.c_int, sig),
                ("hvd_cache_put", ctypes.c_int64, sig),
                ("hvd_cache_invalidate", ctypes.c_int, [vp, cp]),
                ("hvd_cache_clear", None, [vp]),
                ("hvd_cache_size", ctypes.c_int64, [vp]),
                ("hvd_msgtable_create", vp, [ctypes.c_int]),
                ("hvd_msgtable_destroy", None, [vp]),
                ("hvd_msgtable_set_size", None, [vp, ctypes.c_int]),
                ("hvd_msgtable_increment", ctypes.c_int,
                 sig + [ctypes.c_int]),
                ("hvd_msgtable_validate", cp, [vp, cp]),
                ("hvd_msgtable_erase", None, [vp, cp]),
                ("hvd_msgtable_pending", cp, [vp]),
                ("hvd_msgtable_reported_ranks", cp, [vp, cp]),
                ("hvd_fusion_plan", ctypes.c_int, [
                    ctypes.POINTER(cp), ctypes.POINTER(cp),
                    ctypes.POINTER(ctypes.c_int64),
                    ctypes.POINTER(ctypes.c_int),
                    ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                    ctypes.c_int64, ctypes.POINTER(ctypes.c_int)]),
                ("hvd_queue_create", vp, []),
                ("hvd_queue_destroy", None, [vp]),
                ("hvd_queue_add", ctypes.c_int, sig),
                ("hvd_queue_finish", None, [vp, cp]),
                ("hvd_queue_size", ctypes.c_int64, [vp]),
                ("hvd_queue_pop", cp, [vp, ctypes.c_int64]),
                ("hvd_stall_create", vp,
                 [ctypes.c_double, ctypes.c_double, ctypes.c_int]),
                ("hvd_stall_destroy", None, [vp]),
                ("hvd_stall_record", None,
                 [vp, cp, ctypes.c_int, ctypes.c_double]),
                ("hvd_stall_done", None, [vp, cp]),
                ("hvd_stall_check", ctypes.c_int,
                 [vp, ctypes.c_double, ctypes.POINTER(cp)]),
                ("hvd_kv_start", vp,
                 [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]),
                ("hvd_kv_stop", ctypes.c_int, [vp]),
                ("hvd_kv_destroy", None, [vp]),
                ("hvd_kv_port", ctypes.c_int, [vp]),
                ("hvd_kv_put", None,
                 [vp, cp, cp, cp, ctypes.c_int64]),
                ("hvd_kv_get", ctypes.POINTER(ctypes.c_uint8),
                 [vp, cp, cp, ctypes.POINTER(ctypes.c_int64)]),
                ("hvd_kv_scan_json", vp, [vp, cp]),
                ("hvd_kv_free", None, [vp])):
            fn = getattr(l, name)
            fn.restype = res
            fn.argtypes = args
        _lib = l
        return _lib


def _sig_args(name: str, dtype: str, shape: Sequence[int], op: int,
              prescale: float, postscale: float, ps_id: int):
    arr = (ctypes.c_int64 * len(shape))(*shape)
    return (name.encode(), dtype.encode(), arr, len(shape), op,
            prescale, postscale, ps_id)


CACHE_MISS, CACHE_HIT, CACHE_INVALID = 0, 1, 2


class _Handle:
    """Owns one native object; ``_destroy`` names its destructor."""

    _destroy = ""

    def __del__(self):
        try:
            getattr(self._l, self._destroy)(self._h)
        except Exception:
            pass


class NativeResponseCache(_Handle):
    """LRU response cache (response_cache.h:45)."""

    _destroy = "hvd_cache_destroy"

    def __init__(self, capacity: int):
        self._l = lib()
        self._h = self._l.hvd_cache_create(capacity)

    def lookup(self, name, dtype, shape, op=0, prescale=1.0, postscale=1.0,
               ps_id=0) -> int:
        return self._l.hvd_cache_lookup(
            self._h, *_sig_args(name, dtype, shape, op, prescale, postscale,
                                ps_id))

    def put(self, name, dtype, shape, op=0, prescale=1.0, postscale=1.0,
            ps_id=0) -> int:
        return self._l.hvd_cache_put(
            self._h, *_sig_args(name, dtype, shape, op, prescale, postscale,
                                ps_id))

    def invalidate(self, name: str) -> bool:
        return bool(self._l.hvd_cache_invalidate(self._h, name.encode()))

    def clear(self):
        self._l.hvd_cache_clear(self._h)

    def __len__(self):
        return self._l.hvd_cache_size(self._h)


class NativeMessageTable(_Handle):
    """The coordinator's negotiation table (controller.cc:1115)."""

    _destroy = "hvd_msgtable_destroy"

    def __init__(self, world_size: int):
        self._l = lib()
        self._h = self._l.hvd_msgtable_create(world_size)

    def set_size(self, size: int):
        self._l.hvd_msgtable_set_size(self._h, size)

    def increment(self, name, dtype, shape, op, rank, prescale=1.0,
                  postscale=1.0, ps_id=0) -> int:
        """0 = recorded, 1 = ready, -1 = duplicate from this rank."""
        return self._l.hvd_msgtable_increment(
            self._h, *_sig_args(name, dtype, shape, op, prescale, postscale,
                                ps_id), rank)

    def validate(self, name: str) -> str:
        """'' when the ranks agree; else the error text
        (ConstructResponse's error checking)."""
        return self._l.hvd_msgtable_validate(self._h,
                                             name.encode()).decode()

    def erase(self, name: str):
        self._l.hvd_msgtable_erase(self._h, name.encode())

    def pending(self) -> List[str]:
        raw = self._l.hvd_msgtable_pending(self._h).decode()
        return raw.split("\n") if raw else []

    def reported_ranks(self, name: str) -> List[int]:
        raw = self._l.hvd_msgtable_reported_ranks(
            self._h, name.encode()).decode()
        return [int(r) for r in raw.split(",")] if raw else []


def plan_fusion(entries: Sequence[Tuple[str, str, int, int, int]],
                threshold_bytes: int) -> List[List[int]]:
    """Fusion buckets (controller.cc:901 FuseResponses).  ``entries``:
    (name, dtype, bytes, op, process_set_id) per tensor, in submission
    order.  Returns the entry indices of each bucket."""
    l = lib()
    n = len(entries)
    if n == 0:
        return []
    names = (ctypes.c_char_p * n)(*[e[0].encode() for e in entries])
    dtypes = (ctypes.c_char_p * n)(*[e[1].encode() for e in entries])
    nbytes = (ctypes.c_int64 * n)(*[e[2] for e in entries])
    ops = (ctypes.c_int * n)(*[e[3] for e in entries])
    ps = (ctypes.c_int * n)(*[e[4] for e in entries])
    out = (ctypes.c_int * n)()
    nb = l.hvd_fusion_plan(names, dtypes, nbytes, ops, ps, n,
                           threshold_bytes, out)
    buckets: List[List[int]] = [[] for _ in range(nb)]
    for i in range(n):
        buckets[out[i]].append(i)
    return buckets


class NativeTensorQueue(_Handle):
    """Thread-safe queue of in-flight ops (tensor_queue.h:28)."""

    _destroy = "hvd_queue_destroy"

    def __init__(self):
        self._l = lib()
        self._h = self._l.hvd_queue_create()

    def add(self, name, dtype, shape, op=0, prescale=1.0, postscale=1.0,
            ps_id=0) -> bool:
        """False on a duplicate in-flight name (DUPLICATE_NAME_ERROR)."""
        return bool(self._l.hvd_queue_add(
            self._h, *_sig_args(name, dtype, shape, op, prescale, postscale,
                                ps_id)))

    def finish(self, name: str):
        self._l.hvd_queue_finish(self._h, name.encode())

    def pop(self, max_items: int = 64) -> List[str]:
        raw = self._l.hvd_queue_pop(self._h, max_items).decode()
        return raw.split("\n") if raw else []

    def __len__(self):
        return self._l.hvd_queue_size(self._h)


class NativeStallInspector(_Handle):
    """Stalled-collective detector (stall_inspector.h:30)."""

    _destroy = "hvd_stall_destroy"
    OK, WARN, SHUTDOWN = 0, 1, 2

    def __init__(self, warning_time_s: float = 60.0,
                 shutdown_time_s: float = 0.0, world_size: int = 1):
        self._l = lib()
        self._h = self._l.hvd_stall_create(warning_time_s, shutdown_time_s,
                                           world_size)

    def record_request(self, name: str, rank: int, now: float):
        self._l.hvd_stall_record(self._h, name.encode(), rank, now)

    def record_done(self, name: str):
        self._l.hvd_stall_done(self._h, name.encode())

    def check(self, now: float):
        """(status, [(name, waited_s, ready_ranks, missing_ranks)])."""
        report = ctypes.c_char_p()
        status = self._l.hvd_stall_check(self._h, now, ctypes.byref(report))
        out = []
        for line in (report.value or b"").decode().splitlines():
            name, waited, ready, missing = line.split(";")
            out.append((name, float(waited),
                        [int(r) for r in ready.split(",") if r],
                        [int(r) for r in missing.split(",") if r]))
        return status, out


class NativeKVServer:
    """The C++ HTTP KV / rendezvous server (``kv_server.cc``), the
    counterpart of ``horovod_tpu/csrc/__init__.py:365-424``: the same
    wire protocol as the Python ``_KVHandler``.  The store stays readable
    (``get`` / ``scan_scope``) after ``stop()`` until the object dies:
    ``hvd.run`` gathers its results after the launcher's shutdown
    (``runner/__init__.py``)."""

    def __init__(self):
        self._l = lib()
        self._h = None
        self.port = None

    def start(self, port: int = 0) -> int:
        actual = ctypes.c_int(0)
        h = self._l.hvd_kv_start(port, ctypes.byref(actual))
        if not h:
            raise OSError(f"native KV server failed to bind port {port}")
        self._h = h
        self.port = actual.value
        return self.port

    def stop(self) -> int:
        """Stop serving: the listening socket is closed and every
        connection thread has left when this returns (the count of those
        still alive after 10 s, else 0)."""
        if self._h is None:
            return 0
        return self._l.hvd_kv_stop(self._h)

    def put(self, scope: str, key: str, value: bytes) -> None:
        self._l.hvd_kv_put(self._h, scope.encode(), key.encode(), value,
                           len(value))

    def get(self, scope: str, key: str) -> Optional[bytes]:
        n = ctypes.c_int64(-1)
        p = self._l.hvd_kv_get(self._h, scope.encode(), key.encode(),
                               ctypes.byref(n))
        if not p:
            return None
        try:
            return ctypes.string_at(p, n.value)
        finally:
            self._l.hvd_kv_free(p)

    def scan_scope(self, scope: str) -> Dict[str, bytes]:
        p = self._l.hvd_kv_scan_json(self._h, scope.encode())
        if not p:
            return {}
        try:
            raw = ctypes.string_at(p)
        finally:
            self._l.hvd_kv_free(p)
        return {k: base64.b64decode(v)
                for k, v in json.loads(raw.decode()).items()}

    def __del__(self):
        try:
            if self._h is not None:
                self._l.hvd_kv_destroy(self._h)
        except Exception:
            pass
