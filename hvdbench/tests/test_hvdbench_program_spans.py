"""The program's spans read onto the profiler's clock
(``hvdbench/program_spans.py``) on synthetic events with a known offset
between the host's clock and the trace's, the new readers, what leaves
them out, and a traced CPU run that records the port's timeline and
removes its file.  The test marked ``gpu`` runs the tiny cell traced on
the card and finds every new metric."""

import json
import os
import subprocess
import sys
import tempfile
import types

import pytest

from hvdbench import program_spans, run, spec, traces
from hvdbench.tests import tiny
from hvdbench.tests.test_hvdbench_traces import (MARKS, NAMES, kernel,
                                                 launch, mark)

# Host clock = trace clock + 5000 µs (the harness's markers); the
# timeline's zero is 4000 µs on the host's clock, so a timeline ts of t
# is trace time t - 1000.
NOTED = [t + 5000.0 for t in MARKS]
ZERO_NS = 4000 * 1000


def _profile(extra=()):
    """One step: data [0, 10], fwd [10, 100], bwd [100, 300], opt
    [300, 400]; kernels launched at 20 and 50 (fwd), 150 (bwd, on
    autograd's thread), 310 and 320 (opt, the second NCCL's)."""
    ev = [mark(t) for t in MARKS + tuple(extra)]
    ev += [launch(20, 1, tid=1), kernel("fwd_gemm", 30, 50, 1),
           launch(50, 5, tid=1), kernel("ln_kernel", 85, 10, 5),
           launch(150, 2), kernel("bwd_gemm", 160, 100, 2),
           launch(310, 3, tid=1), kernel("adamw", 320, 30, 3),
           launch(320, 4, tid=1),
           kernel("ncclDevKernel_AllReduce_Sum_f32", 340, 40, 4, stream=9)]
    return ev


def _span(name, t0, t1, tid="model", **args):
    """A timeline ``X`` event at trace times [t0, t1]."""
    return {"name": name, "ph": "X", "ts": t0 + 1000.0, "dur": t1 - t0,
            "pid": 0, "tid": tid, "args": args}


def _timeline(dropped=0, zero=True):
    meta = {"name": "horovod_tpu rank 0"}
    if zero:
        meta["monotonic_zero_ns"] = ZERO_NS
    lane = "fusedbuf.float32.9"
    return [
        {"name": "process_name", "ph": "M", "pid": 0, "args": meta},
        _span("embed", 12, 15),
        _span("attn", 15, 40, block=0),
        _span("mlp", 40, 95, block=0),
        _span("mlp", 120, 200, tid="model.bwd", block=0, bwd=True),
        _span("opt.inner", 305, 312, tid="DistributedOptimizer"),
        _span("MEMCPY_IN_FUSION_BUFFER", 316, 322, tid=lane, bucket=0),
        {"name": "ALLREDUCE", "ph": "B", "ts": 1318.0, "pid": 0,
         "tid": lane},
        {"name": "ALLREDUCE", "ph": "E", "ts": 1325.0, "pid": 0,
         "tid": lane},
        _span("opt.reduce", 315, 390, tid="DistributedOptimizer"),
        {"name": "opt", "ph": "C", "ts": 1391.0, "pid": 0,
         "args": {"buckets": 1, "bytes": 3_000_000, "dispatches": 1,
                  "negotiations": 0, "cache_hits": 1,
                  "negotiate_us": 12.5}},
        {"name": "hvd_timeline_dropped_events_total", "ph": "C",
         "ts": 1400.0, "pid": 0, "args": {"dropped": dropped}}]


def _read(profile=None, timeline=None, noted=NOTED):
    tr = traces.Trace.from_events(profile or _profile(),
                                  marker_names=NAMES, marker_times=noted)
    prog, why = program_spans.program_on_trace(
        timeline if timeline is not None else _timeline(), NAMES, noted, tr)
    return tr, prog, why


def _ctx(tr, world=1):
    return types.SimpleNamespace(trace=tr, steps_profiled=1, world=world,
                                 device_kind="NVIDIA H100 80GB HBM3",
                                 flops_per_step=1.0, flash_bounds=None,
                                 mfu_steps_s=[])


NEW = ("attention_ms", "mlp_ms", "head_loss_ms", "opt_accumulate_ms",
       "opt_reduce_ms", "opt_inner_step_ms", "allreduce_bus_gbs")


def _readers():
    cell = spec.load_cell("gpt2m.lm1024.4c")
    return {m.name: m.read for m in cell.per_layer if m.name in NEW}


def test_spans_land_on_the_trace_clock():
    tr, prog, why = _read()
    assert why is None
    got = {(n, round(s, 6), round(e, 6)) for s, e, n in prog.spans}
    assert ("attn", 15.0, 40.0) in got and ("mlp", 120.0, 200.0) in got
    assert ("ALLREDUCE", 318.0, 325.0) in got   # a B/E pair
    assert prog.counters[0]["bytes"] == 3_000_000


@pytest.mark.parametrize("rate", [1.0, 1.0 + 2e-5])
def test_the_clocks_line_through_the_markers(rate):
    """The first marker (stamped 850 µs early, as the profiler does) is
    left out; a host clock running 20 ppm fast is undone."""
    noted = [5000.0 + t * rate for t in MARKS]
    noted[0] += 850.0
    tr = traces.Trace.from_events(_profile(), marker_names=NAMES,
                                  marker_times=noted)
    a, b = program_spans.marker_fit(NAMES, noted, tr)
    assert b == pytest.approx(1 / rate, abs=1e-12)
    assert a + b * (5000.0 + 250.0 * rate) == pytest.approx(250.0, abs=1e-6)


def test_a_launch_just_past_a_span_belongs_to_it():
    """A launch in no span is the nearest span's within the slack (the
    markers' largest distance from the line), else nobody's."""
    prog = program_spans.Program(
        [(10.0, 40.0, "head"), (60.0, 90.0, "loss")], [], [3.0, 8.0])
    assert prog.slack == 8.0
    assert prog.nearest(45.0) == "head"       # 5 past head's end
    assert prog.nearest(55.0) == "loss"       # 5 before loss's start
    assert prog.nearest(50.0) is None         # 10 from both
    assert prog.nearest(20.0) is None         # inside head
    merged = prog.covered(("head",))
    assert prog.owns(("head",), 45.0, merged)
    assert not prog.owns(("loss",), 45.0, prog.covered(("loss",)))


def test_each_new_reader_reads_its_number(monkeypatch):
    tr, prog, _ = _read()
    monkeypatch.setattr(program_spans, "LAST", (tr, prog))
    r = _readers()
    assert set(r) == set(NEW)
    ctx = _ctx(tr)
    assert r["attention_ms"](ctx) == pytest.approx(0.050)
    # the forward's LayerNorm and the backward's GEMM
    assert r["mlp_ms"](ctx) == pytest.approx(0.110)
    # the NCCL kernel's launch is in opt.reduce and in its bucket's
    # MEMCPY_IN and ALLREDUCE: counted once
    assert r["opt_reduce_ms"](ctx) == pytest.approx(0.040)
    assert r["opt_inner_step_ms"](ctx) == pytest.approx(0.030)
    assert r["head_loss_ms"](ctx) is None          # no such span
    assert r["opt_accumulate_ms"](ctx) is None
    assert r["allreduce_bus_gbs"](ctx) is None     # a world of one
    # 3 MB × 2 (4 - 1) / 4 over 40 µs of NCCL kernels
    assert r["allreduce_bus_gbs"](_ctx(tr, world=4)) == \
        pytest.approx(3e6 * 1.5 / 40e-6 / 1e9)
    # another trace than the one read: nothing
    other = traces.Trace.from_events(_profile(), marker_names=NAMES,
                                     marker_times=NOTED)
    assert all(read(_ctx(other, world=4)) is None for read in r.values())


def test_idle_gaps_take_the_program_spans_name():
    tr, prog, _ = _read()
    gaps = {label: us for us, label in program_spans.idle_gaps(tr, prog)}
    assert gaps["attn before fwd_gemm"] == 30
    assert gaps["mlp before ln_kernel"] == 5
    assert gaps["mlp before bwd_gemm"] == 65
    assert gaps["opt.inner before adamw"] == 60
    assert gaps["tail"] == 20
    assert sum(gaps.values()) == sum(us for us, _ in tr.idle_gaps())
    # no program span at a launch: the harness's label
    bare = program_spans.Program([], [])
    assert {label for _, label in program_spans.idle_gaps(tr, bare)} == \
        {label for _, label in tr.idle_gaps()}


@pytest.mark.parametrize("timeline,extra,noted,why", [
    (_timeline(dropped=3), (), NOTED, "dropped 3 events"),
    (_timeline(zero=False), (), NOTED, "no monotonic zero"),
    (_timeline()[:-1], (), NOTED, "no trailer"),
    # a noted time far from every call, among calls that are not the
    # harness's (traces.py's own case)
    (_timeline(), (50, 250, 390), NOTED[:-1] + [NOTED[-1] + 9000.0],
     "not all matched"),
])
def test_a_drop_or_unmatched_markers_leave_the_metrics_out(
        monkeypatch, timeline, extra, noted, why):
    tr, prog, got = _read(_profile(extra), timeline, noted)
    assert prog is None and why in got
    monkeypatch.setattr(program_spans, "LAST", (tr, prog))
    for name, read in _readers().items():
        assert read(_ctx(tr, world=4)) is None, name


def test_the_report_prints_counters_and_what_no_span_covers(capsys):
    tr, prog, _ = _read()
    program_spans.report(tr, prog, 1)
    err = capsys.readouterr().err
    assert "program counters a step: buckets 1, bytes 3e+06" in err
    # fwd + bwd: 160 µs, opt: 70, every launch in a program span
    assert "model_fwd_bwd_ms 0.160 ms a step, 0.000 ms (0.000%)" in err
    assert "optimizer_step_ms 0.070 ms a step, 0.000 ms (0.000%)" in err
    assert "idle gaps mlp before bwd_gemm 0.065 ms" in err


def test_a_traced_cpu_run_records_the_timeline_and_removes_it(
        tmp_path, monkeypatch):
    """The wrapped profiler starts the port's timeline and stops it; the
    file is read (on the CPU the harness marks no span, so the program's
    spans are left out) and removed; the port's timeline is off after."""
    from horovod_tpu_torch import timeline
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "tmp"))
    os.makedirs(tmp_path / "tmp")
    cell = tiny.make(tmp_path / "root")
    monkeypatch.setattr(program_spans, "LAST", (None, None))
    _, _, out = run.run(cell, 2**31 + 5, 0.3, True, device="cpu",
                        root=tmp_path / "root")
    assert out["correct"] and out["metrics"] == {}
    tr, prog = program_spans.LAST
    assert tr is not None and prog is None
    assert not [f for f in os.listdir(tmp_path / "tmp")
                if f.startswith("hvdbench-timeline")]
    assert timeline.ACTIVE is None


@pytest.mark.gpu
def test_the_gpu_tiny_cell_reads_every_new_metric(tmp_path):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cell = tiny.make(tmp_path)
    code = ("import json, sys; from hvdbench import run; "
            f"c, parts, out = run.run({cell!r}, 2**31 + 17, 3.0, True, "
            f"root={str(tmp_path)!r}); print(json.dumps(out))")
    r = subprocess.run([sys.executable, "-c", code], cwd=tiny.REPO,
                       capture_output=True, text=True, timeout=900,
                       env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    want = set(NEW) - {"allreduce_bus_gbs"}    # one rank: no exchange
    assert want <= set(out["metrics"]), r.stderr[-3000:]
    assert all(out["metrics"][m]["value"] > 0 for m in want)
    assert "in no program span" in r.stderr
