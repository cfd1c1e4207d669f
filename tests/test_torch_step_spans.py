"""The port's step-phase spans on the Horovod timeline: the
``DistributedOptimizer``'s parts and per-bucket fusion-buffer activities
with its per-step counter, the ``Transformer``'s regions forward and
backward (with and without ``remat``), nothing at all with the timeline
off or inside the ``HVD_ANALYZE`` pass, the timeline's own span and
counter events and its zero on the host's monotonic clock, and one
``NEGOTIATE_ALLREDUCE`` per dispatch in a two-rank gloo world."""

import json
import textwrap
import time

import pytest
import torch

from test_torch_collectives import run_gloo_world


def _world_of_one(monkeypatch=None, threshold=None):
    import horovod_tpu_torch as hvd
    hvd.shutdown()
    if threshold is not None:
        monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", str(threshold))
    hvd.init(device="cpu")
    return hvd


def _events(path):
    return json.load(open(path))


def _x(events, tid=None):
    return [e for e in events if e["ph"] == "X"
            and (tid is None or e["tid"] == tid)]


def _mlp():
    torch.manual_seed(0)
    # Three parameters of 16 * 16 * 4 = 1024 bytes and three of 64.
    return torch.nn.Sequential(torch.nn.Linear(16, 16), torch.nn.Tanh(),
                               torch.nn.Linear(16, 16), torch.nn.Tanh(),
                               torch.nn.Linear(16, 16))


def _tiny_gpt2(remat=False):
    from horovod_tpu_torch.models import transformer as T
    cfg = T.TransformerConfig(vocab_size=64, num_layers=3, num_heads=2,
                              d_model=32, d_ff=64, max_len=16,
                              dtype=torch.float32, remat=remat)
    model = T.Transformer(cfg)
    T.init_gpt2_(model, torch.Generator().manual_seed(0))
    return T, model


def _lm_step(T, model, opt=None):
    tok = torch.randint(0, 64, (2, 16), generator=torch.Generator()
                        .manual_seed(1))
    loss = T.lm_loss(model(tok)[:, :-1], tok[:, 1:])
    loss.backward()
    if opt is not None:
        opt.step()
    return loss


# -- the optimizer ----------------------------------------------------------

def test_optimizer_step_spans_buckets_and_counter(tmp_path, monkeypatch):
    """One reducing step, world of one, three buckets: the four parts in
    order, each bucket's pack, negotiation, op state and unpack inside
    ``opt.reduce``, and the counter with the buckets and bytes."""
    hvd = _world_of_one(monkeypatch, threshold=1100)
    try:
        model = _mlp()
        opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                       lr=0.1))
        model(torch.randn(4, 16)).sum().backward()
        path = tmp_path / "tl.json"
        hvd.start_timeline(str(path))
        opt.step()
        hvd.stop_timeline()
    finally:
        hvd.shutdown()
    ev = _events(path)
    parts = _x(ev, "DistributedOptimizer")
    assert [e["name"] for e in parts] == ["opt.accumulate", "opt.reduce",
                                          "opt.writeback", "opt.inner"]
    for a, b in zip(parts, parts[1:]):
        assert a["ts"] + a["dur"] <= b["ts"]
    reduce = parts[1]
    lo, hi = reduce["ts"], reduce["ts"] + reduce["dur"]
    bucket_ev = [e for e in ev if e.get("tid", "").startswith("fusedbuf.")]
    assert all(lo <= e["ts"] <= hi for e in bucket_ev)
    # Three buckets of 272 floats each (a weight and its bias), one after
    # another under the one buffer name.
    assert len(bucket_ev) == 3 * 7
    for k in range(3):
        es = bucket_ev[7 * k:7 * k + 7]
        assert [(e["name"], e["ph"]) for e in es] == [
            ("MEMCPY_IN_FUSION_BUFFER", "X"), ("NEGOTIATE_ALLREDUCE", "B"),
            ("0", "i"), ("NEGOTIATE_ALLREDUCE", "E"), ("ALLREDUCE", "B"),
            ("ALLREDUCE", "E"), ("MEMCPY_OUT_FUSION_BUFFER", "X")]
        assert {e["tid"] for e in es} == {"fusedbuf.float32.272"}
        args = es[0]["args"]
        assert es[-1]["args"] == es[3]["args"] == es[4]["args"] == args
        assert args == {"bucket": k, "tensors": 2, "bytes": 4 * 272}
    counter = [e for e in ev if e["ph"] == "C" and e["name"] == "opt"]
    assert len(counter) == 1
    want_bytes = sum(4 * p.numel() for p in model.parameters())
    c = counter[0]["args"]
    assert (c["buckets"], c["bytes"], c["dispatches"]) == (3, want_bytes, 3)
    assert (c["negotiations"], c["cache_hits"]) == (0, 0)
    assert c["negotiate_us"] == 0


def test_accumulating_pass_records_accumulate_only(tmp_path):
    hvd = _world_of_one()
    try:
        model = _mlp()
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            backward_passes_per_step=2)
        path = tmp_path / "tl.json"
        hvd.start_timeline(str(path))
        for _ in range(2):
            opt.zero_grad()
            model(torch.randn(4, 16)).sum().backward()
            opt.step()
        hvd.stop_timeline()
    finally:
        hvd.shutdown()
    ev = _events(path)
    assert [e["name"] for e in _x(ev, "DistributedOptimizer")] == [
        "opt.accumulate", "opt.accumulate", "opt.reduce", "opt.writeback",
        "opt.inner"]
    assert len([e for e in ev if e["ph"] == "C" and e["name"] == "opt"]) == 1


def test_analysis_pass_emits_nothing(tmp_path, monkeypatch):
    """Under ``HVD_ANALYZE=1`` the first step also checks its reduction on
    fake copies: that pass adds no span, the real one its own."""
    monkeypatch.setenv("HVD_ANALYZE", "1")
    hvd = _world_of_one(monkeypatch, threshold=1100)
    try:
        model = _mlp()
        opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                       lr=0.1))
        model(torch.randn(4, 16)).sum().backward()
        path = tmp_path / "tl.json"
        hvd.start_timeline(str(path))
        opt.step()
        hvd.stop_timeline()
    finally:
        hvd.shutdown()
    ev = _events(path)
    names = [e["name"] for e in _x(ev)]
    assert names.count("MEMCPY_IN_FUSION_BUFFER") == 3
    assert names.count("opt.reduce") == 1


# -- the model --------------------------------------------------------------

@pytest.mark.parametrize("remat", [False, True])
def test_transformer_regions_forward_and_backward(tmp_path, remat):
    """``attn`` / ``mlp`` once per block each way, the backward in reverse
    block order, ``head`` and ``loss`` both ways; the backward's spans
    meet end to start; a checkpointed block's recompute adds none."""
    hvd = _world_of_one()
    try:
        T, model = _tiny_gpt2(remat)
        opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                       lr=0.1))
        path = tmp_path / "tl.json"
        hvd.start_timeline(str(path))
        _lm_step(T, model, opt)
        hvd.stop_timeline()
    finally:
        hvd.shutdown()
    ev = _events(path)
    fwd, bwd = _x(ev, "model"), _x(ev, "model.bwd")
    order = ["embed"] + [f"{r}{i}" for i in range(3) for r in ("attn", "mlp")]

    def label(e):
        return e["name"] + str(e["args"].get("block", ""))
    assert [label(e) for e in fwd] == order + ["head", "loss"]
    assert [label(e) for e in bwd] == ["loss", "head"] + order[::-1]
    assert all(e["args"]["bwd"] is True for e in bwd)
    assert not any("bwd" in e["args"] for e in fwd)
    for a, b in zip(bwd, bwd[1:]):
        assert a["ts"] + a["dur"] == pytest.approx(b["ts"], abs=1e-3)
    assert fwd[-1]["ts"] + fwd[-1]["dur"] <= bwd[0]["ts"]


def test_timeline_off_registers_no_hook_and_emits_nothing(monkeypatch):
    """No timeline: a training step registers no tensor hook and emits no
    span, counter or any other event."""
    from horovod_tpu_torch import timeline
    hooks = []
    real = torch.Tensor.register_hook

    def spy(self, fn):
        hooks.append(fn)
        return real(self, fn)
    monkeypatch.setattr(torch.Tensor, "register_hook", spy)

    def refuse(*a, **k):
        raise AssertionError("emitted with the timeline off")
    monkeypatch.setattr(timeline.Timeline, "span", refuse)
    monkeypatch.setattr(timeline.Timeline, "counter", refuse)
    monkeypatch.setattr(timeline.Timeline, "_put", refuse)
    hvd = _world_of_one()
    try:
        T, model = _tiny_gpt2()
        opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                       lr=0.1))
        assert timeline.ACTIVE is None
        tok = torch.randint(0, 64, (2, 16))
        logits = model(tok)
        T.lm_loss(logits[:, :-1], tok[:, 1:]).backward()
        opt.step()
        assert hooks == []
        assert logits._backward_hooks is None
    finally:
        hvd.shutdown()


def test_timeline_on_hooks_each_region_output(tmp_path, monkeypatch):
    hooks = []
    real = torch.Tensor.register_hook

    def spy(self, fn):
        hooks.append(fn)
        return real(self, fn)
    monkeypatch.setattr(torch.Tensor, "register_hook", spy)
    hvd = _world_of_one()
    try:
        T, model = _tiny_gpt2()
        hvd.start_timeline(str(tmp_path / "tl.json"))
        _lm_step(T, model)
        hvd.stop_timeline()
    finally:
        hvd.shutdown()
    assert len(hooks) == 2 * 3 + 3   # attn, mlp a block; embed, head, loss


# -- the timeline ------------------------------------------------------------

def test_span_counter_and_the_monotonic_zero(tmp_path):
    from horovod_tpu_torch.timeline import Timeline
    tl = Timeline(str(tmp_path / "a.json"), monotonic_zero=True, rank=3)
    t0 = time.monotonic_ns()
    tl.span("opt.reduce", t0, tid="t", args={"k": 1},
            end_mono_ns=t0 + 2_500_000)
    tl.counter("opt", {"bytes": 10})
    tl.close()
    ev = _events(tmp_path / "a.json")
    zero = ev[0]["args"]["monotonic_zero_ns"]
    assert ev[0]["name"] == "process_name" and ev[0]["pid"] == 3
    x = ev[1]
    assert (x["name"], x["ph"], x["tid"], x["args"]) == \
        ("opt.reduce", "X", "t", {"k": 1})
    assert x["dur"] == pytest.approx(2500.0)
    assert zero + x["ts"] * 1e3 == pytest.approx(t0, abs=1.0)
    assert ev[2]["ph"] == "C" and ev[2]["args"] == {"bytes": 10}
    plain = Timeline(str(tmp_path / "b.json"))
    plain.close()
    assert _events(tmp_path / "b.json")[0]["args"] == \
        {"name": "horovod_tpu rank 0"}


def test_active_follows_start_stop_init_and_shutdown(tmp_path, monkeypatch):
    from horovod_tpu_torch import timeline
    hvd = _world_of_one()
    try:
        assert timeline.ACTIVE is None
        hvd.start_timeline(str(tmp_path / "a.json"))
        first = timeline.ACTIVE
        assert first is hvd.core._state.timeline is not None
        hvd.start_timeline(str(tmp_path / "b.json"))
        assert timeline.ACTIVE is not first
        hvd.stop_timeline()
        assert timeline.ACTIVE is None
    finally:
        hvd.shutdown()
    monkeypatch.setenv("HOROVOD_TIMELINE", str(tmp_path / "env.json"))
    hvd = _world_of_one()
    try:
        assert timeline.ACTIVE is hvd.core._state.timeline is not None
    finally:
        hvd.shutdown()
    assert timeline.ACTIVE is None
    meta = _events(tmp_path / "env.json")[0]
    assert "monotonic_zero_ns" in meta["args"]


# -- two ranks ---------------------------------------------------------------

WORKER = textwrap.dedent('''
    import json, os, sys
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(16, 16), torch.nn.Tanh(),
                                torch.nn.Linear(16, 16))
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                   lr=0.1))
    path = sys.argv[1] + ".timeline.json"
    hvd.start_timeline(path)
    for step in range(2):
        opt.zero_grad()
        model(torch.randn(4, 16)).sum().backward()
        opt.step()
    hvd.stop_timeline()
    hvd.shutdown()
    np.savez(sys.argv[1], ok=np.ones(1))
''')


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spans2")
    run_gloo_world(WORKER, tmp, size=2)
    return [_events(tmp / f"rank{r}.npz.timeline.json") for r in (0, 1)]


@pytest.mark.parametrize("rank", [0, 1])
def test_one_negotiation_span_per_dispatch_before_the_op(two_ranks, rank):
    """Every rank records; each of the two steps' dispatches has one
    ``NEGOTIATE_ALLREDUCE`` pair, ended before its op state begins, a
    miss on the first step and a cache hit on the second; rank 0 marks
    each rank's request on the miss."""
    ev = two_ranks[rank]
    lane = [e for e in ev if e.get("tid", "").startswith("fusedbuf.")]
    phases = [(e["name"], e["ph"]) for e in lane
              if e["ph"] in ("B", "E")]
    assert phases == [("NEGOTIATE_ALLREDUCE", "B"),
                      ("NEGOTIATE_ALLREDUCE", "E"), ("ALLREDUCE", "B"),
                      ("ALLREDUCE", "E")] * 2
    ends = [e for e in lane if e["name"] == "NEGOTIATE_ALLREDUCE"
            and e["ph"] == "E"]
    assert [e["args"]["cache_hit"] for e in ends] == [False, True]
    ready = [e["name"] for e in lane if e["ph"] == "i"]
    assert ready == (["0", "1"] if rank == 0 else [])
    counters = [e["args"] for e in ev if e["ph"] == "C"
                and e["name"] == "opt"]
    assert [(c["negotiations"], c["cache_hits"]) for c in counters] == \
        [(1, 0), (0, 1)]
    assert all(c["buckets"] == c["dispatches"] == 1 for c in counters)
    assert counters[0]["negotiate_us"] > 0
