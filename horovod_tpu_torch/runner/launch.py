"""The launcher CLI (``horovodrun``) of the port.

Copy of ``horovod_tpu/runner/launch.py`` (framework-free; the port keeps
its own copy because the card's machine has no jax, and every import of
the JAX package's launcher runs ``horovod_tpu/__init__.py``).  Kept: the
flags whose knobs the port reads, the static ``-np`` path
(``_run_static``), the elastic path (``_run_elastic`` →
``elastic/driver.py``), ``pick_coordinator_base_port``, ``_run``, LSF
host discovery, ``--jsrun`` (``_jsrun_spawn`` and ``jsrun_shim.py``)
and the NIC probe of a multi-host job (``nic_probe.py``;
``--network-interface`` names the address instead).  Left out: the
flags of knobs the port does not read (``--cycle-time-ms``,
``--hierarchical-allreduce``, ``--hierarchical-allgather``,
``--thread-affinity``, ``--log-with-timestamp``), so passing one is an
error.  ``--gloo``, ``--mpi``, ``--mpi-threads-disable`` and
``--num-nccl-streams`` are accepted and print that they are ignored.  ``--check-build`` reports
what this build of PyTorch has.

Each worker gets the slot's ``HOROVOD_*`` variables, the rendezvous
address and ``HVD_TPU_COORDINATOR``, where rank 0's ``core.init`` serves
the world's ``TCPStore``.  So

    python -m horovod_tpu_torch.runner.launch -np 2 python train.py

forms a gloo world on the CPU (``hvd.init(device="cpu")``) and an NCCL
world on cards (``hvd.init()``, one card a rank by local rank).

Reference: horovod/runner/launch.py:286 (parse_args), :594 (_run_static),
:689 (_run_elastic), and the YAML ``--config-file`` layer.
"""

from __future__ import annotations

import argparse
import os
import socket
import sys
import threading
from typing import Dict, List

from .. import config as _config
from ..version import __version__
from . import hosts as _hosts
from . import safe_shell_exec
from .http_server import RendezvousServer


def make_override_action(override_args):
    """argparse action that records explicitly-set flags
    (launch.py:158 make_override_action)."""
    class StoreOverrideAction(argparse.Action):
        def __call__(self, parser, namespace, values, option_string=None):
            override_args.add(self.dest)
            setattr(namespace, self.dest, values)

    class StoreTrueOverrideAction(argparse.Action):
        def __init__(self, option_strings, dest, nargs=0, **kwargs):
            super().__init__(option_strings, dest, nargs=0, **kwargs)

        def __call__(self, parser, namespace, values, option_string=None):
            override_args.add(self.dest)
            setattr(namespace, self.dest, True)

    return StoreOverrideAction, StoreTrueOverrideAction


def check_build() -> str:
    """The ``--check-build`` matrix (reference runner/launch.py:110
    check_build), in the reference's format: one framework (PyTorch),
    the gloo controller, and the tensor-op backends this PyTorch build
    has (NCCL with CUDA, gloo)."""
    import torch
    import torch.distributed as dist

    def c(v):
        return "X" if v else " "

    nccl = dist.is_available() and dist.is_nccl_available() and \
        torch.cuda.is_available()
    gloo = dist.is_available() and dist.is_gloo_available()
    return f"""\
Horovod-TPU (PyTorch port) v{__version__}:

Available Frameworks:
    [ ] TensorFlow
    [X] PyTorch
    [ ] MXNet
    [ ] JAX

Available Controllers:
    [ ] MPI
    [{c(gloo)}] Gloo

Available Tensor Operations:
    [{c(nccl)}] NCCL
    [ ] DDL
    [ ] CCL
    [ ] MPI
    [{c(gloo)}] Gloo"""


def parse_args(argv=None):
    """Flag surface mirroring runner/launch.py:286-578."""
    override_args = set()
    Store, StoreTrue = make_override_action(override_args)

    parser = argparse.ArgumentParser(
        prog="horovodrun",
        description="Horovod-compatible launcher for horovod_tpu_torch.")
    parser.add_argument("-v", "--version", action="version",
                        version=__version__)
    parser.add_argument("-cb", "--check-build", action="store_true",
                        dest="check_build",
                        help="Print the framework/controller/tensor-op "
                             "build matrix and exit.")
    parser.add_argument("-np", "--num-proc", dest="np", type=int,
                        help="Total number of training processes.")
    parser.add_argument("-p", "--ssh-port", dest="ssh_port", type=int,
                        help="SSH port on all hosts.")
    parser.add_argument("-i", "--ssh-identity-file", dest="ssh_identity_file",
                        help="SSH identity (private key) file.")
    parser.add_argument("--network-interface", dest="nics",
                        help="Comma-separated network interfaces to use.")
    parser.add_argument("--output-filename", dest="output_filename",
                        help="Per-rank output redirection directory.")
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--config-file", dest="config_file",
                        help="YAML config file (launch.py --config-file).")
    parser.add_argument("--disable-cache", action=StoreTrue,
                        dest="disable_cache",
                        help="Disable the response cache.")
    parser.add_argument("--start-timeout", dest="start_timeout", type=int,
                        help="Seconds the NIC probe of a multi-host job "
                             "waits for its reports (default "
                             "HVD_TPU_NIC_PROBE_TIMEOUT or 30) and an "
                             "elastic job for its first slots (default "
                             "600).")
    parser.add_argument("--binding-args", dest="binding_args",
                        help="jsrun binding arguments (replaces the "
                             "generated --erf_input rankfile; reference "
                             "launch.py --binding-args).")

    group_host = parser.add_argument_group("host arguments")
    group_host.add_argument("-H", "--hosts", dest="hosts",
                            help='Host list, e.g. "h1:4,h2:4".')
    group_host.add_argument("-hostfile", "--hostfile", dest="hostfile",
                            help='Hostfile with "hostname slots=N" lines.')

    group_controller = parser.add_mutually_exclusive_group()
    group_controller.add_argument("--gloo", "--use-gloo", dest="use_gloo",
                                  action="store_true",
                                  help="Compatibility no-op (single backend).")
    group_controller.add_argument("--mpi", "--use-mpi", dest="use_mpi",
                                  action="store_true",
                                  help="Compatibility no-op (single backend).")
    group_controller.add_argument("--jsrun", "--use-jsrun",
                                  dest="use_jsrun",
                                  action="store_true",
                                  help="Spawn every rank with one jsrun "
                                       "inside an LSF allocation.")

    group_params = parser.add_argument_group("tuneable parameter arguments")
    group_params.add_argument("--fusion-threshold-mb", action=Store,
                              type=int, dest="fusion_threshold_mb",
                              help="Fusion buffer threshold in MB.")
    group_params.add_argument("--cache-capacity", action=Store, type=int,
                              dest="cache_capacity")

    group_autotune = parser.add_argument_group("autotune arguments")
    group_autotune.add_argument("--autotune", action=StoreTrue,
                                dest="autotune")
    group_autotune.add_argument("--autotune-log-file", action=Store,
                                dest="autotune_log_file")

    group_timeline = parser.add_argument_group("timeline arguments")
    group_timeline.add_argument("--timeline-filename", action=Store,
                                dest="timeline_filename")
    group_timeline.add_argument("--timeline-mark-cycles", action=StoreTrue,
                                dest="timeline_mark_cycles")

    group_stall = parser.add_argument_group("stall check arguments")
    group_stall.add_argument("--no-stall-check", action=StoreTrue,
                             dest="no_stall_check")
    group_stall.add_argument("--stall-check-warning-time-seconds",
                             action=Store, type=int,
                             dest="stall_check_warning_time_seconds")
    group_stall.add_argument("--stall-check-shutdown-time-seconds",
                             action=Store, type=int,
                             dest="stall_check_shutdown_time_seconds")

    group_library = parser.add_argument_group("library arguments")
    group_library.add_argument("--mpi-threads-disable", action=StoreTrue,
                               dest="mpi_threads_disable",
                               help="Compatibility no-op.")
    group_library.add_argument("--num-nccl-streams", action=Store, type=int,
                               dest="num_nccl_streams",
                               help="Compatibility no-op.")

    group_logging = parser.add_argument_group("logging arguments")
    group_logging.add_argument("--log-level", action=Store,
                               dest="log_level",
                               choices=["TRACE", "DEBUG", "INFO", "WARNING",
                                        "ERROR", "FATAL"])
    group_logging.add_argument("--log-hide-timestamp", action=StoreTrue,
                               dest="log_hide_timestamp")
    group_logging.add_argument("--prefix-output-with-timestamp",
                               action="store_true",
                               dest="prefix_output_with_timestamp")

    group_elastic = parser.add_argument_group("elastic arguments")
    group_elastic.add_argument("--min-np", "--min-num-proc", type=int,
                               dest="min_np")
    group_elastic.add_argument("--max-np", "--max-num-proc", type=int,
                               dest="max_np")
    group_elastic.add_argument("--slots", type=int, dest="slots",
                               help="Slots per host for elastic discovery.")
    group_elastic.add_argument("--host-discovery-script",
                               dest="host_discovery_script")
    group_elastic.add_argument("--reset-limit", type=int, dest="reset_limit")
    group_elastic.add_argument("--blacklist-cooldown-range", type=int,
                               nargs=2, dest="blacklist_cooldown_range")

    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help="Command to run on each rank.")

    args = parser.parse_args(argv)
    args.override_args = override_args
    if args.check_build:
        print(check_build())
        raise SystemExit(0)
    if args.use_jsrun:
        # jsrun as the spawn transport (reference launch.py:760
        # run_controller -> js_run): one jsrun covers every rank; each
        # task runs the jsrun_shim, which maps its JSM rank onto the
        # rendezvous slot record.  The world is still NCCL / gloo.
        from . import lsf
        if not lsf.using_lsf():
            parser.error(
                "--jsrun requires an LSF allocation (LSB_JOBID is not "
                "set). Outside LSF, launch with -H/--hostfile over "
                "ssh/loopback instead.")
        if not lsf.is_jsrun_installed():
            parser.error(
                "--jsrun: the jsrun executable is not on PATH in this "
                "LSF allocation.")
        if args.min_np is not None or args.max_np is not None or \
                args.host_discovery_script is not None:
            # The elastic driver respawns workers per reshape over
            # ssh/loopback; jsrun has no per-worker respawn.
            parser.error(
                "--jsrun cannot be combined with elastic flags "
                "(--min-np/--max-np/--host-discovery-script): elastic "
                "worlds respawn workers over ssh/loopback. Run elastic "
                "without --jsrun, or run --jsrun static.")
    if args.use_mpi or args.use_gloo:
        flag = "--mpi" if args.use_mpi else "--gloo"
        print(f"horovodrun: note: {flag} is accepted for compatibility and "
              "ignored — workers always launch over ssh/loopback and form "
              "an NCCL world on cards, a gloo world on the CPU.",
              file=sys.stderr)
    for flag, given in (("--mpi-threads-disable", args.mpi_threads_disable),
                        ("--num-nccl-streams",
                         args.num_nccl_streams is not None)):
        if given:
            print(f"horovodrun: note: {flag} is accepted for compatibility "
                  "and ignored.", file=sys.stderr)
    if args.config_file:
        _apply_config_file(args)
    return args


def _apply_config_file(args):
    """YAML config → args, CLI flags win (config_parser.py precedence)."""
    import yaml
    with open(args.config_file) as f:
        cfg = yaml.safe_load(f) or {}
    mapping = {
        "fusion_threshold_mb": "fusion-threshold-mb",
        "cache_capacity": "cache-capacity",
        "autotune": "autotune",
        "autotune_log_file": "autotune-log-file",
        "timeline_filename": "timeline-filename",
        "timeline_mark_cycles": "timeline-mark-cycles",
        "no_stall_check": "no-stall-check",
        "stall_check_warning_time_seconds":
            "stall-check-warning-time-seconds",
        "stall_check_shutdown_time_seconds":
            "stall-check-shutdown-time-seconds",
        "log_level": "log-level",
    }
    flat = {}
    for section in cfg.values() if isinstance(cfg, dict) else []:
        if isinstance(section, dict):
            flat.update(section)
    if isinstance(cfg, dict):
        flat.update({k: v for k, v in cfg.items()
                     if not isinstance(v, dict)})
    for dest, yaml_key in mapping.items():
        if dest in args.override_args:
            continue  # CLI beats config file
        for k in (yaml_key, dest):
            if k in flat:
                setattr(args, dest, flat[k])
                break


def env_from_args(args) -> Dict[str, str]:
    """Flags → HOROVOD_* env (launch.py + config_parser.set_env_from_args)."""
    env = {}
    if getattr(args, "fusion_threshold_mb", None) is not None:
        env[_config.HOROVOD_FUSION_THRESHOLD] = str(
            args.fusion_threshold_mb * 1024 * 1024)
    if getattr(args, "cache_capacity", None) is not None:
        env[_config.HOROVOD_CACHE_CAPACITY] = str(args.cache_capacity)
    if getattr(args, "disable_cache", None):
        env[_config.HOROVOD_CACHE_CAPACITY] = "0"
    if getattr(args, "autotune", None):
        env[_config.HOROVOD_AUTOTUNE] = "1"
    if getattr(args, "autotune_log_file", None):
        env[_config.HOROVOD_AUTOTUNE_LOG] = args.autotune_log_file
    if getattr(args, "timeline_filename", None):
        env[_config.HOROVOD_TIMELINE] = args.timeline_filename
    if getattr(args, "timeline_mark_cycles", None):
        env[_config.HOROVOD_TIMELINE_MARK_CYCLES] = "1"
    if getattr(args, "no_stall_check", None):
        env[_config.HOROVOD_STALL_CHECK_DISABLE] = "1"
    if getattr(args, "stall_check_warning_time_seconds", None) is not None:
        env[_config.HOROVOD_STALL_CHECK_TIME_SECONDS] = str(
            args.stall_check_warning_time_seconds)
    if getattr(args, "stall_check_shutdown_time_seconds", None) is not None:
        env[_config.HOROVOD_STALL_SHUTDOWN_TIME_SECONDS] = str(
            args.stall_check_shutdown_time_seconds)
    if getattr(args, "log_level", None):
        env[_config.HOROVOD_LOG_LEVEL] = args.log_level.lower()
    if getattr(args, "log_hide_timestamp", None):
        env[_config.HOROVOD_LOG_HIDE_TIME] = "1"
    return env


def _worker_env(base_env: Dict[str, str], slot: _hosts.SlotInfo,
                rendezvous_addr: str, rendezvous_port: int,
                coordinator: str) -> Dict[str, str]:
    """Per-slot rendezvous env (gloo_run.py:66-78)."""
    env = dict(base_env)
    env.update(slot.env())
    env.update({
        _config.HOROVOD_RENDEZVOUS_ADDR: rendezvous_addr,
        _config.HOROVOD_RENDEZVOUS_PORT: str(rendezvous_port),
        "HVD_TPU_COORDINATOR": coordinator,
    })
    return env


def _is_local(hostname: str) -> bool:
    return hostname in ("localhost", "127.0.0.1", socket.gethostname())


def _ssh_command(slot: _hosts.SlotInfo, command: List[str],
                 env: Dict[str, str], args) -> List[str]:
    """Remote launch line (gloo_run.py get_remote_command analog)."""
    import shlex
    exports = " ".join(f"{k}={shlex.quote(str(v))}" for k, v in env.items()
                       if k.startswith(("HOROVOD_", "HVD_TPU_", "PATH",
                                        "PYTHONPATH")))
    ssh = ["ssh", "-o", "StrictHostKeyChecking=no"]
    if args.ssh_port:
        ssh += ["-p", str(args.ssh_port)]
    if args.ssh_identity_file:
        ssh += ["-i", args.ssh_identity_file]
    remote = f"cd {shlex.quote(os.getcwd())} && env {exports} " + \
        " ".join(shlex.quote(c) for c in command)
    return ssh + [slot.hostname, remote]


def _run_static(args, on_rendezvous=None) -> int:
    """Static (fixed world) launch (launch.py:594 _run_static).

    ``on_rendezvous`` (internal): called with the live RendezvousServer
    after init; ``runner.run`` reads the workers' results from its store."""
    if args.hostfile:
        host_list = _hosts.parse_host_files(args.hostfile)
    elif args.hosts:
        host_list = _hosts.parse_hosts(args.hosts)
    else:
        from . import lsf
        if lsf.using_lsf() and (args.np is None or
                                getattr(args, "use_jsrun", False)):
            # Inside an LSF allocation the granted hosts are the world
            # (reference launch.py:295 makes -np optional under LSF).  An
            # explicit -np without --jsrun keeps the localhost default.
            try:
                host_list = lsf.lsf_hosts()
            except RuntimeError as e:
                raise SystemExit(f"horovodrun: {e}")
        else:
            host_list = [_hosts.HostInfo("localhost", args.np or 1)]
    np_ = args.np or sum(h.slots for h in host_list)
    assignments = _hosts.get_host_assignments(host_list, np_)

    rendezvous = RendezvousServer(verbose=args.verbose)
    port = rendezvous.start()
    rendezvous.init(assignments)
    if on_rendezvous is not None:
        on_rendezvous(rendezvous)
    has_remote = any(not _is_local(h.hostname) for h in host_list)
    addr = socket.gethostbyname(socket.gethostname()) if has_remote \
        else "127.0.0.1"
    if has_remote:
        # NIC selection (driver_service.py:122-194): an explicit
        # --network-interface wins; otherwise probe every remote host and
        # pick a launcher address they can all reach.
        from . import nic_probe
        if args.nics:
            explicit = nic_probe.addr_for_interfaces(args.nics.split(","))
            if explicit:
                addr = explicit
        else:
            try:
                import shlex
                remote = sorted({h.hostname for h in host_list
                                 if not _is_local(h.hostname)})
                candidates = [addr] + [
                    a for addrs in
                    nic_probe.local_interfaces().values() for a in addrs
                    if a != addr]
                cand_arg = ",".join(f"{a}:{port}" for a in candidates)

                def spawn_probe(host):
                    cmd = ["ssh", "-o", "StrictHostKeyChecking=no"]
                    if args.ssh_port:
                        cmd += ["-p", str(args.ssh_port)]
                    if args.ssh_identity_file:
                        cmd += ["-i", args.ssh_identity_file]
                    cmd += [host,
                            f"cd {shlex.quote(os.getcwd())} && "
                            f"{shlex.quote(sys.executable)} -m "
                            f"horovod_tpu_torch.runner.nic_probe "
                            f"--candidates {cand_arg} --host {host}"]
                    safe_shell_exec.execute(cmd, env=dict(os.environ))

                _, routable = nic_probe.discover_common_address(
                    rendezvous, remote, spawn_probe, candidates, port,
                    timeout=args.start_timeout or float(os.environ.get(
                        "HVD_TPU_NIC_PROBE_TIMEOUT", "30")))
                if routable:
                    addr = routable
                else:
                    print(f"horovodrun: no probed launcher address was "
                          f"reachable from all hosts; falling back to "
                          f"{addr}", file=sys.stderr)
            except Exception as e:
                print(f"horovodrun: NIC probing failed ({e}); using "
                      f"{addr}", file=sys.stderr)
    # The world's TCPStore runs inside rank 0's process.  With any remote
    # worker in the job, loopback would point remote workers at
    # themselves — use a routable name for rank 0's host instead.
    coord_host = assignments[0].hostname
    if _is_local(coord_host):
        coord_addr = addr  # routable self-address when remotes exist
    else:
        coord_addr = coord_host
    pick_coordinator_base_port(_is_local(coord_host))
    coordinator = f"{coord_addr}:{int(os.environ.get('HVD_TPU_COORD_PORT', 29400))}"

    base_env = {k: v for k, v in os.environ.items()}
    base_env.update(env_from_args(args))

    if getattr(args, "use_jsrun", False):
        try:
            return _jsrun_spawn(args, assignments, base_env, addr, port,
                                coordinator)
        finally:
            rendezvous.stop()

    threads = []
    rets = [None] * len(assignments)
    failure = threading.Event()

    def run_slot(i: int, slot: _hosts.SlotInfo):
        out_fh = err_fh = None
        try:
            env = _worker_env(base_env, slot, addr, port, coordinator)
            prefix = f"[{slot.rank}]<stdout>:" if len(assignments) > 1 else ""
            if _is_local(slot.hostname):
                cmd = args.command
            else:
                cmd = _ssh_command(slot, args.command, env, args)
            stdout = stderr = None
            if args.output_filename:
                # Per-rank output files (reference --output-filename: a
                # directory with rank.N/stdout|stderr).
                d = os.path.join(args.output_filename, f"rank.{slot.rank}")
                os.makedirs(d, exist_ok=True)
                out_fh = open(os.path.join(d, "stdout"), "w")
                err_fh = open(os.path.join(d, "stderr"), "w")
                stdout, stderr, prefix = out_fh, err_fh, ""
            rets[i] = safe_shell_exec.execute(
                cmd, env=env, prefix=prefix, stdout=stdout, stderr=stderr,
                prefix_timestamp=args.prefix_output_with_timestamp,
                events=[failure])
        except Exception as e:  # spawn failure must count as rank failure
            print(f"horovodrun: rank {slot.rank} failed to launch: {e}",
                  file=sys.stderr)
            rets[i] = 1
        finally:
            for fh in (out_fh, err_fh):
                if fh is not None:
                    fh.close()
        if rets[i] != 0:
            failure.set()

    try:
        for i, slot in enumerate(assignments):
            t = threading.Thread(target=run_slot, args=(i, slot), daemon=True)
            t.start()
            threads.append(t)
        for t in threads:
            t.join()
    finally:
        rendezvous.stop()
    bad = [(assignments[i].rank, r) for i, r in enumerate(rets) if r]
    if bad:
        print(f"horovodrun: ranks failed: {bad}", file=sys.stderr)
        return bad[0][1] or 1
    return 0


def _jsrun_spawn(args, assignments, base_env, addr, port,
                 coordinator) -> int:
    """Spawn every rank with ONE jsrun invocation (js_run.py:34 js_run).

    The ERF rankfile (js_run.py:96 generate_jsrun_rankfile) pins each
    rank to its assigned host; per-rank worker env comes from the
    rendezvous ``rank/{n}`` records via the jsrun_shim (jsrun starts all
    tasks with an identical command line, so the shim is how rank
    identity reaches the worker — the reference gets it from the MPI
    runtime instead).  The reference's cpu-range math rides on Summit's
    CSM queries; without CSM the ERF carries host pinning only and
    ``--binding-args`` (if given) is passed through verbatim."""
    import shlex
    import tempfile

    rankfile = None
    if getattr(args, "binding_args", None):
        # User-supplied binding replaces the generated rankfile entirely;
        # it must still start exactly len(assignments) tasks — the shim
        # checks its JSM world size against the slot record and fails
        # fast on a mismatch instead of hanging the collective.
        binding = shlex.split(args.binding_args)
    else:
        fd, rankfile = tempfile.mkstemp(prefix="hvd_tpu_erf_",
                                        suffix=".txt")
        with os.fdopen(fd, "w") as f:
            f.write("overlapping_rs: allow\ncpu_index_using: logical\n")
            for slot in assignments:
                f.write(f"rank: {slot.rank}: "
                        f"{{ hostname: {slot.hostname} }}\n")
        binding = ["--erf_input", rankfile]
    env = dict(base_env)
    env.update({
        _config.HOROVOD_RENDEZVOUS_ADDR: addr,
        _config.HOROVOD_RENDEZVOUS_PORT: str(port),
        "HVD_TPU_COORDINATOR": coordinator,
    })
    if args.output_filename:
        # Keep --output-filename's per-rank directory contract (rank.N/
        # stdout|stderr): the SHIM redirects each task — jsrun's
        # --stdio_* flags write one interleaved file, a different shape.
        env["HVD_TPU_OUTPUT_DIR"] = args.output_filename
    cmd = (["jsrun"] + binding
           + [sys.executable, "-m", "horovod_tpu_torch.runner.jsrun_shim"]
           + args.command)
    if args.verbose:
        print("horovodrun: " + " ".join(shlex.quote(c) for c in cmd),
              file=sys.stderr)
    try:
        return safe_shell_exec.execute(cmd, env=env)
    finally:
        if rankfile is not None:
            try:
                os.remove(rankfile)
            except OSError:
                pass


def _run_elastic(args) -> int:
    """Elastic launch (launch.py:689): delegate to the elastic driver."""
    from ..elastic.driver import launch_elastic
    return launch_elastic(args)


def _ephemeral_port_range():
    """The kernel's range for ephemeral ports (``bind`` to port 0 and the
    local end of an outgoing connection)."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            low, high = (int(x) for x in f.read().split())
        return low, high
    except (OSError, ValueError):
        return 32768, 60999


def pick_coordinator_base_port(coordinator_host_is_local: bool) -> None:
    """Default the world store's BASE port to a free one.

    A fixed default (29400) collides across successive or concurrent jobs
    on one host — e.g. orphaned workers of a killed launcher still bound
    to the old job's coordinator ports livelock the next job's
    registration.  Elastic world incarnations derive their ports from
    this base (elastic.coordinator_port_for), so the whole derived range
    moves with it.  An explicit HVD_TPU_COORD_PORT still wins (multi-host
    jobs where remote firewalls need a pinned port).

    The range lies below the kernel's ephemeral ports where there is
    room: a derived port in the ephemeral range can be taken, by the time
    its generation's rank 0 binds it, by any socket of the job (an NCCL
    bootstrap listener, the local end of a connection), and then every
    other rank of that generation waits out the store's timeout.

    Only applies when the coordinator (rank 0) runs on THIS host — the
    bind probe says nothing about a remote rank-0 host's port space, so
    multi-host jobs keep the pinned default."""
    if os.environ.get("HVD_TPU_COORD_PORT") or not coordinator_host_is_local:
        return
    import random
    port = None
    low, _ = _ephemeral_port_range()
    # Derived incarnation ports span [base, base+2000).
    if low - 2000 > 10000:
        for _ in range(64):
            cand = random.randrange(10000, low - 2000)
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            try:
                s.bind(("", cand))
            except OSError:
                continue
            finally:
                s.close()
            port = cand
            break
    if port is None:
        for _ in range(16):
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            try:
                s.bind(("", 0))
                cand = s.getsockname()[1]
            finally:
                s.close()
            # Keep the whole derived range inside the valid port space.
            if cand <= 63500:
                port = cand
                break
    if port is None:
        port = random.randint(20000, 40000)
    os.environ["HVD_TPU_COORD_PORT"] = str(port)


def _run(args) -> int:
    if not args.command:
        print("horovodrun: no command given; see --help", file=sys.stderr)
        return 2
    if args.command and args.command[0] == "--":
        args.command = args.command[1:]
    elastic = args.host_discovery_script is not None or \
        (args.min_np is not None and args.min_np != (args.max_np or args.min_np))
    if elastic:
        return _run_elastic(args)
    return _run_static(args)


def run_commandline(argv=None) -> None:
    sys.exit(_run(parse_args(argv)))


if __name__ == "__main__":
    run_commandline()
