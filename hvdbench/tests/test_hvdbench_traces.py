"""The trace reader and the per-layer readers on synthetic event lists,
and the reading of NCCL's log on synthetic lines."""

import types

import pytest

from hvdbench import nccl_log, spec, traces


def X(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def kernel(name, ts, dur, corr, stream=7):
    return X("kernel", name, ts, dur, tid=stream, correlation=corr,
             stream=stream, device=0)


def launch(ts, corr, tid=2, name="cudaLaunchKernel"):
    return X("cuda_runtime", name, ts, 1, tid=tid, correlation=corr)


def mark(ts, tid=1):
    return X("cuda_runtime", traces.MARKER, ts, 1, tid=tid, correlation=999)


def test_union_and_length():
    got = traces.union([(5, 7), (0, 2), (1, 3), (7, 8), (10, 11)])
    assert got == [(0, 3), (5, 8), (10, 11)]
    assert traces.length(got) == 7


MARKS = (0, 10, 10, 100, 100, 300, 300, 400)
NAMES = ["data", "fwd", "bwd", "opt"]
#: the host clock of the markers: another origin than the trace's
NOTED = [t + 5000.0 for t in MARKS]


def _step_events(extra=()):
    """One step: data [0, 10], fwd [10, 100], bwd [100, 300], opt
    [300, 400], marked on thread 1; launches on threads 1 and 2 (the
    backward's), kernels on the device after them; ``extra`` marker
    calls that are not the harness's."""
    ev = [mark(t) for t in MARKS + tuple(extra)]
    ev += [launch(20, 1, tid=1), kernel("fwd_gemm", 30, 50, 1),
           launch(150, 2), kernel("bwd_gemm", 160, 100, 2),
           launch(310, 3, tid=1), kernel("adamw", 320, 30, 3),
           launch(320, 4, tid=1),
           kernel("ncclDevKernel_AllReduce_Sum_f32", 340, 40, 4, stream=9)]
    return ev


@pytest.mark.parametrize("extra", [(), (50, 250, 390)])
def test_attribution_by_launch_time_on_any_thread(extra):
    tr = traces.Trace.from_events(_step_events(extra), marker_names=NAMES,
                                  marker_times=NOTED)
    assert [s[2] for s in tr.spans] == NAMES
    spans = {o.name: o.span for o in tr.ops}
    assert spans == {"fwd_gemm": "fwd", "bwd_gemm": "bwd", "adamw": "opt",
                     "ncclDevKernel_AllReduce_Sum_f32": "opt"}
    assert tr.time_in(("fwd", "bwd")) == 150
    assert tr.time_in(("opt",)) == 70
    assert tr.wall() == (0, 400)
    # busy: [30, 80] + [160, 260] + [320, 380]
    assert tr.busy() == 50 + 100 + 60
    assert tr.exposed(traces.is_nccl) == 30


# A traced GPT-2 step on an H100 (three steps, 24 markers): the host's
# noted times and the trace's calls, whose first is stamped ~850 µs early.
NOTED_CHIP = [104014475.357, 104015509.324, 104016515.132, 104059915.053, 104060083.859, 104367034.792, 104367238.148, 104384504.705, 104386064.959, 104386089.435, 104386461.648, 104487586.553, 104487819.351, 104812606.172, 104812793.164, 104829744.526, 104831408.007, 104831440.794, 104831977.017, 104933335.831, 104933521.61, 105257992.735, 105258244.573, 105284757.234]  # noqa: E501
CALLS_CHIP = [1504334275753.98, 1504334277655.703, 1504334278639.172, 1504334322049.902, 1504334322203.564, 1504334629189.629, 1504334629357.077, 1504334646647.094, 1504334648182.701, 1504334648206.162, 1504334648579.823, 1504334749737.663, 1504334749943.433, 1504335074756.187, 1504335074912.911, 1504335091888.819, 1504335093528.821, 1504335093559.332, 1504335094099.182, 1504335195479.372, 1504335195641.584, 1504335520150.815, 1504335520369.393, 1504335546910.262]  # noqa: E501


@pytest.mark.parametrize("extra", [(), (1504334700000.0, 1504335300000.0,
                                        1504335093540.0)])
def test_markers_found_on_chip_data(extra):
    calls = sorted(CALLS_CHIP + list(extra))
    got = traces.match_markers({"1071111424": calls, "7": [1.0]}, NOTED_CHIP)
    assert got == CALLS_CHIP


def test_markers_that_do_not_pair_give_no_spans():
    events = [e for e in _step_events()
              if not (e["name"] == traces.MARKER and e["ts"] == 400)]
    tr = traces.Trace.from_events(events, marker_names=NAMES,
                                  marker_times=NOTED)
    assert tr.spans == []
    assert {o.span for o in tr.ops} == {traces.OUTSIDE}


def test_user_annotations_are_spans_too():
    ev = [X("user_annotation", "fwd", 0, 100), launch(20, 1),
          kernel("k", 30, 10, 1)]
    tr = traces.Trace.from_events(ev)
    assert tr.ops[0].span == "fwd"


def test_idle_gaps_labelled_by_the_launching_span():
    tr = traces.Trace.from_events(_step_events(), marker_names=NAMES,
                                  marker_times=NOTED)
    gaps = tr.idle_gaps()
    assert sum(us for us, _ in gaps) == 400 - tr.busy()
    labels = {label: us for us, label in gaps}
    assert labels["fwd before fwd_gemm"] == 30
    assert labels["bwd before bwd_gemm"] == 80
    assert labels["opt before adamw"] == 60
    assert labels["tail"] == 20
    assert tr.top_gaps(2) == [("bwd before bwd_gemm", 80),
                              ("opt before adamw", 60)]
    assert tr.top_ops(1) == [("bwd_gemm", 100)]


def _ctx(tr, world=1, **kw):
    base = dict(trace=tr, steps_profiled=1, world=world,
                device_kind="NVIDIA H100 80GB HBM3",
                flops_per_step=989e12 * 1e-4,
                flash_bounds={"flash_fwd": 5e-6, "flash_bwd_dq": 5e-6,
                              "flash_bwd_dkv": 5e-6},
                mfu_steps_s=[4e-4, 4e-4])
    base.update(kw)
    return types.SimpleNamespace(**base)


def _readers():
    cell = spec.load_cell("gpt2m.lm1024.4c")
    return {m.name: m.read for m in cell.per_layer}


def test_readers_on_one_step():
    tr = traces.Trace.from_events(
        _step_events() + [
            launch(50, 5, tid=1),
            kernel("void (anonymous namespace)::flash_fwd_kernel<64>(P)",
                   85, 10, 5)],
        marker_names=NAMES, marker_times=NOTED)
    r = _readers()
    assert r["model_fwd_bwd_ms"](_ctx(tr)) == pytest.approx(0.160)
    assert r["optimizer_step_ms"](_ctx(tr)) == pytest.approx(0.070)
    assert r["launches_per_step"](_ctx(tr)) == 5
    assert r["device_idle_share"](_ctx(tr)) == pytest.approx(
        100 * (1 - 220 / 400))
    assert r["flash_roofline"](_ctx(tr)) == pytest.approx(50.0)
    assert r["mfu"](_ctx(tr)) == pytest.approx(25.0)
    assert r["allreduce_exposed_ms"](_ctx(tr)) is None        # world of one
    assert r["allreduce_exposed_ms"](_ctx(tr, world=4)) == \
        pytest.approx(0.030)


def test_readers_find_nothing_to_read():
    r = _readers()
    empty = traces.Trace.from_events([])
    ctx = _ctx(empty, world=4, device_kind="cpu", flash_bounds=None,
               mfu_steps_s=[])
    for name, read in r.items():
        assert read(ctx) is None, name


@pytest.mark.parametrize("extra,noted", [
    ((50, 250, 390), NOTED[:-1] + [NOTED[-1] + 9000.0]),
    ((), NOTED + [9000.0, 9100.0])])
def test_unmatched_markers_give_no_span_metric(extra, noted):
    """Markers that do not all find their calls (a noted time far from
    every call, or more noted times than calls) leave the trace without
    spans: the readers of spans read nothing, the others as before."""
    tr = traces.Trace.from_events(_step_events(extra), marker_names=NAMES,
                                  marker_times=noted)
    assert tr.spans == [] and not tr.has_spans(("opt",))
    assert {o.span for o in tr.ops} == {traces.OUTSIDE}
    r = _readers()
    assert r["model_fwd_bwd_ms"](_ctx(tr)) is None
    assert r["optimizer_step_ms"](_ctx(tr)) is None
    assert r["launches_per_step"](_ctx(tr)) == 4
    assert r["allreduce_exposed_ms"](_ctx(tr, world=4)) == \
        pytest.approx(0.030)


NCCL_LINES = """\
host:10:10 [0] NCCL INFO NCCL version 2.28.9+cuda12.9
host:10:10 [0] NCCL INFO Channel 00/0 : 0[0] -> 1[1] via P2P/CUMEM/read
host:10:10 [0] NCCL INFO Channel 01/0 : 0[0] -> 1[1] via P2P/CUMEM/read
host:10:10 [0] NCCL INFO Channel 00/0 : 0[0] -> 3[3] via SHM/direct/direct
host:10:10 [0] NCCL INFO AllReduce: 134217728 Bytes -> Algo RING proto SIMPLE time 512.000000
host:10:10 [0] NCCL INFO AllReduce: 134217728 Bytes -> Algo 1 proto 2 time 512.000000
host:10:10 [0] NCCL INFO AllReduce: 4096 Bytes -> Algo 1 proto 0 time 9.000000
"""


def test_nccl_log_names_transports_and_choices(tmp_path):
    line = nccl_log.summarize(NCCL_LINES)
    assert line == (
        "NCCL 2.28.9+cuda12.9; transports P2P/CUMEM/read x2, "
        "SHM/direct/direct x1; collectives AllReduce RING/LL x1 "
        "(0.000 GB), AllReduce RING/SIMPLE x2 (0.268 GB)")
    assert nccl_log.summarize("") == "no NCCL communicator"
    assert nccl_log.summarize("x NCCL INFO Init COMPLETE\n") == (
        "NCCL (version not logged); transports not logged; collectives "
        "not logged here (NCCL logs them on a communicator's rank 0)")
    d = tmp_path / "nccl"
    d.mkdir()
    (d / nccl_log.FILE).write_text(NCCL_LINES)
    assert nccl_log.end(str(d)) == line and not d.exists()


def test_short_names_keep_the_kernel():
    assert traces._short("void (anonymous namespace)::flash_fwd_kernel<64, "
                         "128>(Params)") == \
        "anon::flash_fwd_kernel<64, 128>(Params)"
    long = "void at::native::vectorized_elementwise_kernel<4, " \
        "at::native::CUDAFunctor_add<float>, std::array<char*, 3> >(int)"
    assert traces._short(long, 60) == long[5:65]
