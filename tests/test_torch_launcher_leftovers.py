"""The launcher parts the port took over last: LSF host discovery, the
``--jsrun`` spawn with its shim, and NIC probing
(``horovod_tpu_torch/runner/lsf.py``, ``jsrun_shim.py``, ``nic_probe.py``
and ``launch.py``), against the JAX package's on the same environment.

Counterparts of ``tests/test_runner.py``'s LSF / jsrun / NIC cases: the
``--jsrun`` flag's errors, ``lsf_hosts``, the probe's report and
reachability, the common-address discovery, and a ``--jsrun`` launch
through a fake ``jsrun`` on ``PATH`` whose two tasks each get their slot
from the shim.  The workers of that launch report their environment and
form no world.
"""

import json
import os
import socket
import stat
import sys
import textwrap

import pytest

from horovod_tpu.runner import launch as jax_launch
from horovod_tpu.runner import lsf as jax_lsf
from horovod_tpu.runner import nic_probe as jax_nic
from horovod_tpu.runner.http_server import KVStoreServer as JaxKV
from horovod_tpu_torch.runner import launch, lsf, nic_probe
from horovod_tpu_torch.runner.http_server import (KVStoreServer,
                                                  RendezvousServer)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.xdist_group("heavy_e2e")

PORTS = ("HOROVOD_GLOO_RENDEZVOUS_PORT", "HVD_TPU_COORDINATOR",
         "HVD_TPU_COORD_PORT")


def _strip(env):
    return {k: v for k, v in env.items() if k not in PORTS}


# -- the --jsrun flag (tests/test_runner.py:122, :135, :762) ----------------

def test_jsrun_flag_outside_lsf_errors(capsys, monkeypatch):
    monkeypatch.delenv("LSB_JOBID", raising=False)
    for mod in (launch, jax_launch):
        with pytest.raises(SystemExit) as ei:
            mod.parse_args(["-np", "1", "--jsrun", "python", "x.py"])
        assert ei.value.code == 2
        assert "requires an LSF allocation" in capsys.readouterr().err


def test_jsrun_flag_inside_lsf_without_jsrun_errors(capsys, monkeypatch):
    monkeypatch.setenv("LSB_JOBID", "1234")
    monkeypatch.setenv("PATH", "/nonexistent")
    for mod in (launch, jax_launch):
        with pytest.raises(SystemExit) as ei:
            mod.parse_args(["-np", "1", "--jsrun", "python", "x.py"])
        assert ei.value.code == 2
        assert "jsrun executable is not on PATH" in capsys.readouterr().err


def _fake_jsrun(tmp_path, body):
    jsrun = tmp_path / "jsrun"
    jsrun.write_text(body)
    jsrun.chmod(jsrun.stat().st_mode | stat.S_IEXEC)
    return jsrun


def test_jsrun_rejects_elastic_flags(monkeypatch, tmp_path, capsys):
    _fake_jsrun(tmp_path, "#!/bin/bash\nexit 0\n")
    monkeypatch.setenv("PATH", f"{tmp_path}:{os.environ['PATH']}")
    monkeypatch.setenv("LSB_JOBID", "1")
    for mod in (launch, jax_launch):
        for extra in (["--min-np", "2", "--max-np", "4"],
                      ["--host-discovery-script", "d.sh"]):
            with pytest.raises(SystemExit) as ei:
                mod.parse_args(["--jsrun"] + extra + ["python", "x.py"])
            assert ei.value.code == 2
            assert "cannot be combined with elastic flags" in \
                capsys.readouterr().err


# -- LSF host discovery (tests/test_runner.py:679) --------------------------

@pytest.mark.parametrize("case", ["hostfile", "mcpu", "batch_node",
                                  "batch_node_kept", "no_hosts", "no_lsf"])
def test_lsf_hosts_match_jax(monkeypatch, tmp_path, case):
    me = socket.gethostname()
    for var in ("LSB_JOBID", "LSB_DJOB_HOSTFILE", "LSB_MCPU_HOSTS",
                "HVD_TPU_LSF_INCLUDE_LAUNCH_HOST"):
        monkeypatch.delenv(var, raising=False)
    if case != "no_lsf":
        monkeypatch.setenv("LSB_JOBID", "77")
    if case == "hostfile":
        hf = tmp_path / "hostfile"
        hf.write_text("nodeA\nnodeA\n\nnodeB\nnodeA\n")
        monkeypatch.setenv("LSB_DJOB_HOSTFILE", str(hf))
    elif case == "mcpu":
        monkeypatch.setenv("LSB_MCPU_HOSTS", "nodeA 4 nodeB 2 nodeA 1")
    elif case.startswith("batch_node"):
        monkeypatch.setenv("LSB_MCPU_HOSTS", f"{me} 1 nodeA 4 nodeB 4")
        if case == "batch_node_kept":
            monkeypatch.setenv("HVD_TPU_LSF_INCLUDE_LAUNCH_HOST", "1")
    answers = []
    for mod in (lsf, jax_lsf):
        try:
            answers.append([(h.hostname, h.slots) for h in mod.lsf_hosts()])
        except RuntimeError as e:
            answers.append(("error", str(e)))
    assert answers[0] == answers[1]
    want = {"hostfile": [("nodeA", 3), ("nodeB", 1)],
            "mcpu": [("nodeA", 5), ("nodeB", 2)],
            "batch_node": [("nodeA", 4), ("nodeB", 4)],
            "batch_node_kept": [(me, 1), ("nodeA", 4), ("nodeB", 4)]}
    if case in want:
        assert answers[0] == want[case]
    else:
        assert answers[0][0] == "error"
    assert lsf.using_lsf() == jax_lsf.using_lsf() == (case != "no_lsf")


def _capture_spawns(monkeypatch, mod):
    calls = []

    def fake_execute(cmd, env=None, **kwargs):
        rankfile = None
        if "--erf_input" in cmd:
            with open(cmd[cmd.index("--erf_input") + 1]) as f:
                rankfile = f.read()
        calls.append((list(cmd), dict(env or {}), rankfile))
        return 0

    monkeypatch.setattr(mod.safe_shell_exec, "execute", fake_execute)
    return calls


def test_lsf_allocation_is_the_world_as_jax(monkeypatch):
    """Inside LSF without -np the granted hosts are the world (reference
    launch.py:295); the slots' environments equal JAX's."""
    monkeypatch.setenv("LSB_JOBID", "5")
    monkeypatch.delenv("LSB_DJOB_HOSTFILE", raising=False)
    monkeypatch.setenv("LSB_MCPU_HOSTS", "localhost 3")
    monkeypatch.setenv("HVD_TPU_COORD_PORT", "29777")
    envs = []
    for mod in (launch, jax_launch):
        calls = _capture_spawns(monkeypatch, mod)
        assert mod._run_static(mod.parse_args(["python", "x.py"])) == 0
        envs.append(sorted(
            (_strip({k: v for k, v in env.items()
                     if k.startswith(("HOROVOD_", "HVD_TPU_"))})
             for _, env, _ in calls), key=lambda e: e["HOROVOD_RANK"]))
    assert envs[0] == envs[1]
    assert [e["HOROVOD_RANK"] for e in envs[0]] == ["0", "1", "2"]
    assert {e["HOROVOD_SIZE"] for e in envs[0]} == {"3"}


@pytest.mark.parametrize("binding", [None, "--rs_per_host 2"])
def test_jsrun_command_matches_jax(monkeypatch, tmp_path, binding):
    """One jsrun covers every rank: the ERF rankfile (or the binding
    arguments), the shim module and the environment equal JAX's."""
    _fake_jsrun(tmp_path, "#!/bin/bash\nexit 0\n")
    monkeypatch.setenv("PATH", f"{tmp_path}:{os.environ['PATH']}")
    monkeypatch.setenv("LSB_JOBID", "9")
    monkeypatch.setenv("LSB_MCPU_HOSTS", "nodeA 2 nodeB 1")
    monkeypatch.setenv("HVD_TPU_COORD_PORT", "29777")
    argv = ["--jsrun", "--output-filename", str(tmp_path / "out")]
    if binding:
        argv += ["--binding-args", binding]
    seen = []
    for mod, shim in ((launch, "horovod_tpu_torch.runner.jsrun_shim"),
                      (jax_launch, "horovod_tpu.runner.jsrun_shim")):
        calls = _capture_spawns(monkeypatch, mod)
        monkeypatch.setattr(mod, "_is_local", lambda h: True)
        assert mod._run_static(mod.parse_args(
            argv + ["python", "train.py"])) == 0
        assert len(calls) == 1
        cmd, env, rankfile = calls[0]
        assert cmd[0] == "jsrun" and shim in cmd
        i = cmd.index(shim)
        assert cmd[i - 2:i] == [sys.executable, "-m"]
        assert cmd[i + 1:] == ["python", "train.py"]
        seen.append((cmd[1:i - 2] if binding else [], rankfile,
                     _strip({k: v for k, v in env.items()
                             if k.startswith(("HOROVOD_", "HVD_TPU_"))})))
    assert seen[0] == seen[1]
    if binding:
        assert seen[0][0] == binding.split() and seen[0][1] is None
    else:
        assert seen[0][1] == (
            "overlapping_rs: allow\ncpu_index_using: logical\n"
            "rank: 0: { hostname: nodeA }\nrank: 1: { hostname: nodeA }\n"
            "rank: 2: { hostname: nodeB }\n")
    assert seen[0][2]["HVD_TPU_OUTPUT_DIR"] == str(tmp_path / "out")


_FAKE_JSRUN = """#!/bin/bash
# Minimal jsrun: read the ERF rankfile, start one local task per rank with
# the JSM namespace env, propagate the worst exit code (what jsrun does).
ERF=""
ARGS=()
while [ $# -gt 0 ]; do
  case "$1" in
    --erf_input) ERF="$2"; shift 2 ;;
    --stdio_stdout|--stdio_stderr) shift 2 ;;
    *) ARGS+=("$1"); shift ;;
  esac
done
N=$(grep -c '^rank:' "$ERF")
pids=()
for ((i=0; i<N; i++)); do
  JSM_NAMESPACE_RANK=$i JSM_NAMESPACE_SIZE=$N "${ARGS[@]}" &
  pids+=($!)
done
rc=0
for p in "${pids[@]}"; do wait "$p" || rc=1; done
exit $rc
"""


@pytest.mark.integration
def test_jsrun_launch_end_to_end(monkeypatch, tmp_path):
    """``--jsrun`` inside a (mocked) LSF allocation (tests/test_runner.py
    :724): hosts come from LSF's environment, one jsrun starts both
    tasks, and the shim maps each JSM rank onto its slot record, with
    ``--output-filename``'s per-rank files."""
    _fake_jsrun(tmp_path, _FAKE_JSRUN)
    # The launcher writes the store's port into the environment; a value
    # recorded by setenv makes monkeypatch remove it afterwards.
    monkeypatch.setenv("HVD_TPU_COORD_PORT", "")
    monkeypatch.delenv("HVD_TPU_COORD_PORT")
    monkeypatch.setenv("PATH", f"{tmp_path}:{os.environ['PATH']}")
    monkeypatch.setenv("LSB_JOBID", "4242")
    monkeypatch.delenv("LSB_DJOB_HOSTFILE", raising=False)
    monkeypatch.setenv("LSB_MCPU_HOSTS", "localhost 2")
    monkeypatch.setenv("PYTHONPATH", REPO + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
    worker = tmp_path / "worker.py"
    worker.write_text(textwrap.dedent("""
        import json, os
        print(json.dumps({k: os.environ[k] for k in (
            "HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_LOCAL_RANK",
            "HOROVOD_HOSTNAME", "HVD_TPU_COORDINATOR")}))
    """))
    out = tmp_path / "out"
    args = launch.parse_args(["--jsrun", "--output-filename", str(out),
                              sys.executable, str(worker)])
    assert launch._run_static(args) == 0
    got = [json.loads((out / f"rank.{r}" / "stdout").read_text())
           for r in (0, 1)]
    assert [(g["HOROVOD_RANK"], g["HOROVOD_SIZE"], g["HOROVOD_LOCAL_RANK"])
            for g in got] == [("0", "2", "0"), ("1", "2", "1")]
    assert got[0]["HVD_TPU_COORDINATOR"] == got[1]["HVD_TPU_COORDINATOR"]
    assert {g["HOROVOD_HOSTNAME"] for g in got} == {"localhost"}


def test_jsrun_shim_sets_the_slot_env_as_jax(monkeypatch):
    """The shim exports its slot's variables into its own environment
    before it execs; here it runs in the test's process, so the
    environment is restored whole after each call."""
    from horovod_tpu.runner import jsrun_shim as jax_shim
    from horovod_tpu_torch.runner import hosts, jsrun_shim
    rdv = RendezvousServer()
    port = rdv.start()
    saved = dict(os.environ)

    def run(shim, rank, size):
        os.environ.update({"HOROVOD_GLOO_RENDEZVOUS_ADDR": "127.0.0.1",
                           "HOROVOD_GLOO_RENDEZVOUS_PORT": str(port),
                           "JSM_NAMESPACE_SIZE": size})
        if rank is not None:
            os.environ["JSM_NAMESPACE_RANK"] = rank
        execs = []
        monkeypatch.setattr(shim.os, "execvp",
                            lambda f, a: execs.append((f, list(a))))
        try:
            shim.main(["python", "train.py"])
            return execs, {k: v for k, v in os.environ.items()
                           if saved.get(k) != v}
        finally:
            os.environ.clear()
            os.environ.update(saved)

    try:
        rdv.init(hosts.get_host_assignments(
            [hosts.HostInfo("nodeA", 2), hosts.HostInfo("nodeB", 1)], 3))
        envs = []
        for shim in (jsrun_shim, jax_shim):
            execs, env = run(shim, "2", "3")
            assert execs == [("python", ["python", "train.py"])]
            envs.append(env)
            with pytest.raises(SystemExit, match="started 5 tasks"):
                run(shim, "2", "5")
            with pytest.raises(SystemExit, match="no task rank"):
                run(shim, None, "3")
        assert envs[0] == envs[1]
        assert envs[0]["HOROVOD_RANK"] == "2" and \
            envs[0]["HOROVOD_SIZE"] == "3" and \
            envs[0]["HOROVOD_HOSTNAME"] == "nodeB"
        assert dict(os.environ) == saved
    finally:
        rdv.stop()


# -- NIC probing (tests/test_runner.py:605, :626, :663) ---------------------

def test_addr_for_interfaces_matches_jax():
    names = list(nic_probe.local_interfaces(include_loopback=True))
    assert nic_probe.local_interfaces() == jax_nic.local_interfaces()
    for nics in ([n] for n in names + ["nonexistent0"]):
        assert nic_probe.addr_for_interfaces(nics) == \
            jax_nic.addr_for_interfaces(nics)
    assert nic_probe.addr_for_interfaces(["nonexistent0"]) is None
    if "lo" in names:
        assert nic_probe.addr_for_interfaces(["nonexistent0", "lo"]) == \
            "127.0.0.1"


@pytest.mark.parametrize("reach", [True, False])
def test_probe_and_report_matches_jax(reach):
    """The probe tests every candidate against the live KV port and
    publishes one report through a working one; both packages' probes
    publish the same report and the same answer."""
    reports = []
    for probe, server in ((nic_probe, KVStoreServer()), (jax_nic, JaxKV())):
        port = server.start()
        try:
            cands = ([("127.0.0.1", port)] if reach else []) + \
                [("127.0.0.2", 1)]
            ok = probe.probe_and_report(
                "h1", cands, interfaces={"eth0": ["10.0.0.9"]})
            assert ok is reach
            raw = server.get(probe.PROBE_SCOPE, "report/h1")
            reports.append(json.loads(raw) if raw else None)
        finally:
            server.stop()
    assert reports[0] == reports[1]
    if reach:
        assert reports[0]["reachable"] == ["127.0.0.1"]
        assert reports[0]["interfaces"] == {"eth0": ["10.0.0.9"]}


def test_discover_common_address_matches_jax():
    """Launcher side with in-process probes standing in for the ssh
    launched ones: the interface intersection includes the launcher's
    own, and the routable pick needs every host."""
    answers = []
    for probe, server in ((nic_probe, KVStoreServer()), (jax_nic, JaxKV())):
        port = server.start()
        local = list(probe.local_interfaces())
        fake = {"hA": {n: ["10.0.0.1"] for n in local + ["ibX"]},
                "hB": {n: ["10.0.0.2"] for n in local}}

        def spawn(host, probe=probe, port=port, fake=fake):
            probe.probe_and_report(host, [("127.0.0.1", port),
                                          ("127.0.0.2", 1)],
                                   interfaces=fake[host])
        try:
            answers.append(probe.discover_common_address(
                server, ["hA", "hB"], spawn,
                candidate_addrs=["127.0.0.2", "127.0.0.1"],
                candidate_port=port, timeout=10))
            with pytest.raises(TimeoutError, match="never reported"):
                probe.discover_common_address(server, ["ghost"],
                                              lambda h: None,
                                              ["127.0.0.1"], 1, timeout=1.0)
        finally:
            server.stop()
    assert answers[0] == answers[1]
    assert answers[0][1] == "127.0.0.1"


@pytest.mark.integration
def test_nic_probe_cli_reports_through_a_live_kv():
    """The module CLI the launcher runs on each remote host."""
    import subprocess
    server = KVStoreServer()
    port = server.start()
    try:
        run = subprocess.run(
            [sys.executable, "-m", "horovod_tpu_torch.runner.nic_probe",
             "--candidates", f"127.0.0.2:1,127.0.0.1:{port}",
             "--host", "hC"], cwd=REPO, capture_output=True, text=True,
            timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
        assert run.returncode == 0, run.stderr[-2000:]
        rep = json.loads(server.get(nic_probe.PROBE_SCOPE, "report/hC"))
        assert rep["reachable"] == ["127.0.0.1"]
        assert rep["interfaces"] == nic_probe.local_interfaces()
    finally:
        server.stop()


def test_remote_launch_probes_nics_with_the_port_module(monkeypatch):
    """A remote host: the launcher runs the port's NIC probe over ssh
    first (it never reports here, so the launcher falls back to its own
    address), then each rank over ssh with the JAX launcher's command."""
    monkeypatch.setenv("HVD_TPU_NIC_PROBE_TIMEOUT", "0.2")
    monkeypatch.setenv("HVD_TPU_COORD_PORT", "29777")
    seen = []
    for mod, probe in ((launch, "horovod_tpu_torch.runner.nic_probe"),
                       (jax_launch, "horovod_tpu.runner.nic_probe")):
        calls = _capture_spawns(monkeypatch, mod)
        assert mod._run_static(mod.parse_args(
            ["-np", "2", "-H", "remotebox:2", "-p", "2222",
             "python", "train.py"])) == 0
        probes = [c for c, _, _ in calls if probe in " ".join(c)]
        assert len(probes) == 1 and probes[0][0] == "ssh"
        assert "remotebox" in probes[0] and "2222" in probes[0]
        ranks = sorted((c for c in calls if probe not in " ".join(c[0])),
                       key=lambda c: c[1]["HOROVOD_RANK"])
        assert len(ranks) == 2
        for i, (cmd, env, _) in enumerate(ranks):
            assert cmd[0] == "ssh" and "remotebox" in cmd
            assert f"HOROVOD_RANK={i}" in cmd[-1]
            assert cmd[-1].endswith("python train.py")
        # The remote command line carries the ports: compare the rest.
        seen.append([(c[:-1], _strip({
            k: v for k, v in env.items()
            if k.startswith(("HOROVOD_", "HVD_TPU_"))}))
            for c, env, _ in ranks])
    assert seen[0] == seen[1]


# -- hvd.run's launcher flags and --network-interface / --start-timeout -----

@pytest.mark.parametrize("given", [False, True])
def test_run_forwards_the_launcher_flags(monkeypatch, given):
    """``run``'s ``network_interface``, ``start_timeout``, ``use_gloo``
    and ``use_mpi`` reach the launcher's parsed arguments; left out, the
    launcher's defaults stand."""
    from horovod_tpu_torch import runner

    class Parsed(Exception):
        pass

    def fake_run_static(args, on_rendezvous=None):
        raise Parsed(args)

    monkeypatch.setattr(runner, "_run_static", fake_run_static)
    kw = dict(network_interface="ib0,eth0", start_timeout=7,
              use_gloo=True) if given else {}
    with pytest.raises(Parsed) as e:
        runner.run(sorted, args=([2, 1],), np=2, hosts="localhost:2", **kw)
    args = e.value.args[0]
    assert (args.np, args.hosts) == (2, "localhost:2")
    assert args.command[0] == sys.executable
    if given:
        assert (args.nics, args.start_timeout) == ("ib0,eth0", 7)
        assert args.use_gloo and not args.use_mpi
    else:
        assert (args.nics, args.start_timeout) == (None, None)
        assert not (args.use_gloo or args.use_mpi)
    with pytest.raises(Parsed) as e:
        runner.run(sorted, np=1, use_mpi=True)
    assert e.value.args[0].use_mpi


def test_network_interface_wins_and_start_timeout_bounds_the_probe(
        monkeypatch):
    """A remote host: ``--network-interface`` names the address the
    ranks reach the launcher at, and no probe runs; without it, the
    probe waits ``--start-timeout`` seconds for its reports."""
    monkeypatch.setenv("HVD_TPU_NIC_PROBE_TIMEOUT", "0.2")
    monkeypatch.setenv("HVD_TPU_COORD_PORT", "29777")
    lo = nic_probe.addr_for_interfaces(["lo"])
    assert lo
    calls = _capture_spawns(monkeypatch, launch)
    assert launch._run_static(launch.parse_args(
        ["-np", "1", "-H", "remotebox:1", "--network-interface", "lo",
         "python", "train.py"])) == 0
    assert len(calls) == 1 and "nic_probe" not in " ".join(calls[0][0])
    assert calls[0][1]["HOROVOD_GLOO_RENDEZVOUS_ADDR"] == lo

    waits = []

    def fake_discover(kv, remote, spawn, candidates, port, timeout):
        waits.append(timeout)
        return [], None

    monkeypatch.setattr(nic_probe, "discover_common_address", fake_discover)
    for argv, want in ((["--start-timeout", "3"], 3),
                       ([], 0.2)):
        _capture_spawns(monkeypatch, launch)
        assert launch._run_static(launch.parse_args(
            ["-np", "1", "-H", "remotebox:1"] + argv +
            ["python", "train.py"])) == 0
        assert waits.pop() == want
