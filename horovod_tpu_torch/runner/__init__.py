"""The port's launcher and its in-process API: ``horovod_tpu_torch.run(func, np=...)``.

``run`` is a copy of ``horovod_tpu/runner/__init__.py`` (framework-free):
it cloudpickles ``(func, args, kwargs)`` to a temp file, launches the
workers through ``launch._run_static`` (one process per slot, each with
the slot's ``HOROVOD_*`` variables and ``HVD_TPU_COORDINATOR``), and
gathers each rank's pickled result from the ``runresults`` scope of the
rendezvous KV store, ordered by rank.  The function calls ``hvd.init()``
itself: a gloo world with ``device="cpu"``, an NCCL world on cards.
Reference: horovod/runner/__init__.py:95 ``horovod.run``.

The rest of the package: ``launch.py`` (``python -m
horovod_tpu_torch.runner.launch``), ``http_server.py`` (the KV store and
rendezvous), ``hosts.py``, ``safe_shell_exec.py``, ``lsf.py``,
``jsrun_shim.py`` and ``nic_probe.py``, copies of the JAX package's;
the elastic driver is in ``elastic/``.
"""

from __future__ import annotations

import os
import pickle
import sys
import tempfile
from typing import Any, Callable, List, Optional

from .launch import parse_args, _run_static


def run(func: Callable,
        args: tuple = (),
        kwargs: Optional[dict] = None,
        np: int = 1,
        hosts: Optional[str] = None,
        hostfile: Optional[str] = None,
        start_timeout: Optional[int] = None,
        ssh_port: Optional[int] = None,
        ssh_identity_file: Optional[str] = None,
        verbose: bool = False,
        use_gloo: Optional[bool] = None,
        use_mpi: Optional[bool] = None,
        network_interface: Optional[str] = None) -> List[Any]:
    """Run ``func(*args, **kwargs)`` on ``np`` ranks and return the list of
    per-rank results ordered by rank (horovod.run, runner/__init__.py:95).

    ``network_interface`` and ``start_timeout`` are the launcher's
    ``--network-interface`` (the address remote workers reach the
    launcher at) and ``--start-timeout`` (how long its NIC probe waits);
    ``use_gloo`` / ``use_mpi`` pass its ``--gloo`` / ``--mpi``, which it
    accepts and ignores.

    The function is cloudpickled to a temp file, each worker executes a
    bootstrap that initializes the runtime, calls it, and writes its result
    to ``result_<rank>.pkl``; the launcher collects them.
    """
    import cloudpickle
    from . import hosts as _hosts_mod
    from .launch import _is_local
    kwargs = kwargs or {}
    has_remote = bool(hosts) and any(
        not _is_local(h.hostname) for h in _hosts_mod.parse_hosts(hosts))
    if has_remote:
        # Remote workers cd into this cwd over ssh (launch._ssh_command),
        # so a cwd-anchored workdir is readable exactly when the job's
        # working tree is on a shared mount — the reference's assumption
        # for shipping the pickled function.  /tmp is per-machine.
        base = os.path.join(os.getcwd(), ".hvd_tpu_run")
        os.makedirs(base, exist_ok=True)
        workdir = tempfile.mkdtemp(prefix="run_", dir=base)
        from ..utils import get_logger
        get_logger().warning(
            "run(): remote hosts %s read the pickled function from %s — "
            "the working tree must be a shared mount",
            [h.hostname for h in _hosts_mod.parse_hosts(hosts)
             if not _is_local(h.hostname)], workdir)
    else:
        workdir = tempfile.mkdtemp(prefix="hvd_tpu_run_")
    fn_path = os.path.join(workdir, "func.pkl")
    with open(fn_path, "wb") as f:
        cloudpickle.dump((func, args, kwargs), f)

    # Workers must resolve the same modules the caller sees (the pickled
    # function is serialized by reference when its module is importable):
    # ship the parent's full sys.path, not just its cwd.
    parent_path = [p for p in [os.getcwd()] + sys.path if p]
    # Results travel back through the launcher's rendezvous KV store
    # (runner/__init__.py:95 reference contract) so REMOTE ranks work too;
    # the temp-dir file is kept as a local-host fallback.  The function
    # itself ships via a shared-filesystem path like the reference's
    # cloudpickle-through-KV (remote hosts need the repo + workdir mounted).
    bootstrap = f"""
import pickle, os, sys, urllib.request
sys.path[:0] = [p for p in {parent_path!r} if p not in sys.path]
try:
    fh = open({fn_path!r}, 'rb')
except FileNotFoundError:
    print('horovod_tpu_torch.run: cannot read the pickled function at '
          {fn_path!r} + ' — remote hosts need the launcher working tree '
          'on a SHARED mount (the function ships via the filesystem; '
          'results return via the rendezvous KV)', file=sys.stderr)
    raise
fn, a, kw = pickle.load(fh)
r = fn(*a, **kw)
rank = int(os.environ.get('HOROVOD_RANK', 0))
payload = pickle.dumps(r)
sent = False
try:
    addr = os.environ['HOROVOD_GLOO_RENDEZVOUS_ADDR']
    port = os.environ['HOROVOD_GLOO_RENDEZVOUS_PORT']
    req = urllib.request.Request(
        'http://%s:%s/runresults/%d' % (addr, port, rank),
        data=payload, method='PUT')
    urllib.request.urlopen(req, timeout=30).read()
    sent = True
except Exception as e:
    print('result KV put failed: %r' % (e,), file=sys.stderr)
if not sent:
    open(os.path.join({workdir!r}, 'result_%d.pkl' % rank), 'wb') \\
        .write(payload)
"""
    argv = ["-np", str(np)]
    if hosts:
        argv += ["-H", hosts]
    if hostfile:
        argv += ["--hostfile", hostfile]
    if ssh_port:
        argv += ["-p", str(ssh_port)]
    if ssh_identity_file:
        argv += ["-i", ssh_identity_file]
    if verbose:
        argv += ["--verbose"]
    if start_timeout is not None:
        argv += ["--start-timeout", str(start_timeout)]
    if network_interface:
        argv += ["--network-interface", network_interface]
    # The launcher's compatibility no-ops: it notes that it ignores them.
    if use_gloo:
        argv += ["--gloo"]
    if use_mpi:
        argv += ["--mpi"]
    argv += [sys.executable, "-c", bootstrap]
    parsed = parse_args(argv)
    captured = {}

    def _capture(rendezvous):
        # The store outlives the server shutdown (KVStoreServer keeps it
        # readable post-stop, whichever backend serves it).
        captured["server"] = rendezvous

    try:
        ret = _run_static(parsed, on_rendezvous=_capture)
        if ret != 0:
            raise RuntimeError(
                f"horovod_tpu_torch.run failed with exit code {ret}")
        srv = captured.get("server")
        kv_results = srv.scan_scope("runresults") if srv is not None else {}
        results = []
        for rank in range(np):
            raw = kv_results.get(str(rank))
            if raw is not None:
                results.append(pickle.loads(raw))
                continue
            path = os.path.join(workdir, f"result_{rank}.pkl")
            with open(path, "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        # The staged function pickle can embed caller data; it must not
        # linger (especially on a shared mount) on ANY exit path.
        import shutil
        shutil.rmtree(workdir, ignore_errors=True)
