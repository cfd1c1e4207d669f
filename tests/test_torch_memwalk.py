"""hvdmem's liveness walk over a ``make_fx`` graph
(``analysis/memplan.py``) against the JAX walk's expected values.

The JAX walk (``horovod_tpu/analysis/memplan.py``) reads
``jax.core.Var``, which this jax no longer has, so it cannot run here:
each test writes the program of a case of ``tests/test_memplan.py`` in
torch and holds the port to the bytes that test writes down.  Torch has
no donation: the caller holds its inputs, so every input is pinned (JAX's
"pinned" figures), and updating a value in place is torch's donation
(JAX's "donated" figures).
"""

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import core
from horovod_tpu_torch.analysis import hook, memplan
from horovod_tpu_torch.models import Transformer, TransformerConfig
from horovod_tpu_torch.serve import (InferenceEngine, ServeMetrics,
                                     TransformerAdapter)

F32 = 4
KB4 = 1024 * F32


def _x(n=1024, dtype=torch.float32, seed=0):
    return torch.as_tensor(
        np.random.RandomState(seed).rand(n).astype(np.float32), dtype=dtype)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in ("HVD_MEM_BUDGET_BYTES", "HVD_MEM_UPCAST_MIN_BYTES",
                 "HOROVOD_FUSION_THRESHOLD"):
        monkeypatch.delenv(name, raising=False)


# -- liveness: hand-computed peaks (:47, :64, :96) --------------------------------

def _out_of_place(x):
    return x * 2.0 + 1.0


def _in_place(x):
    y = x * 2.0
    y.add_(1.0)
    return y


@pytest.mark.parametrize("fn,peak,add", [
    # :64, inputs pinned: x + y + z live at the add.
    (_out_of_place, 3 * KB4, {"aten.add": {"count": 1, "bytes": 4096}}),
    # :47, the update in place: x + y, the add allocates nothing.
    (_in_place, 2 * KB4, {"aten.add_": {"count": 1, "bytes": 0}}),
])
def test_straight_line_peak(fn, peak, add):
    r = memplan.measure_step_fn(fn, (_x(),), label="line")
    assert r.input_bytes == KB4
    assert r.output_bytes == KB4
    assert r.peak_live_bytes == peak
    assert r.by_primitive == dict(
        add, **{"aten.mul": {"count": 1, "bytes": 4096}})


def test_cond_branches_maxed_not_summed():
    """:96 — the fat branch's transient (two 4 KB temps beyond its
    boundary) and the thin one's (one clone) contribute their max, not
    the sum: x + cond out + 8 KB = 16 KB, plus the 1-byte predicate."""
    def step(x):
        return torch.cond(x.sum() > 0, lambda z: (z * 2.0) + (z * 3.0),
                          lambda z: z.clone(), (x,))

    r = memplan.measure_step_fn(step, (_x(),), label="cond")
    assert 4 * KB4 <= r.peak_live_bytes <= 4 * KB4 + 64
    assert r.peak_live_bytes < 5 * KB4


def test_closed_over_tensor_pinned_and_counted_once():
    """:136 — a closed-over weight stays live for the whole call.  JAX's
    peak is 36 KB with x donated; torch's caller holds x too, + 4 KB.
    ``w`` is used twice, once through a view: ``make_fx`` gives each use
    its own ``get_attr`` node, and the walk still counts it once."""
    w = _x(seed=2)

    def f(x):
        y = x + w
        big = torch.cat([y, y, y, w.view(-1)])   # 16 KB
        return big * 2.0                         # 16 KB

    r = memplan.measure_step_fn(f, (_x(),), label="const-pin")
    assert r.input_bytes == 2 * KB4
    assert r.peak_live_bytes == 9 * KB4 + KB4
    assert r.by_primitive["aten.view"]["bytes"] == 0


# -- HVD300, read as "not updated in place" (:202-253) ----------------------------

BIG = 1 << 19   # f32 elements: 2 MiB, above DONATION_MIN_BYTES


def _functional(cache, t):
    out = cache.clone()
    out[0] = t.sum()
    return out, t * 1.0


def _updated(cache, t):
    cache[0] = t.sum()
    return cache, t * 1.0


def _add_into(new, old):
    return new.add_(old)


def _pair(a, b):
    return a + b


@pytest.mark.parametrize("fn,args,rules", [
    # :202, a functional update of a large input fires; the update in
    # place (torch's donation) is clean.
    (_functional, (_x(BIG), torch.ones(4)), ["HVD300"]),
    (_updated, (_x(BIG), torch.ones(4)), []),
    # :216, below the byte floor nothing fires.
    (lambda tok: tok + 1, (torch.ones(8, dtype=torch.int32),), []),
    # :229, the input updated in place takes the one matching output.
    (_add_into, (_x(BIG), _x(BIG, seed=1)), []),
    # :241, one matching output flags one of the two inputs.
    (_pair, (_x(BIG), _x(BIG, seed=1)), ["HVD300"]),
], ids=["functional", "in_place", "small", "aliased", "pair"])
def test_hvd300(fn, args, rules):
    saved = [a.clone() for a in args]
    r = memplan.measure_step_fn(fn, args, label="hvd300")
    assert [f.rule for f in r.findings] == rules
    if rules:
        assert "in place" in r.findings[0].message
    # The trace wrote nothing: the real inputs are as they were.
    assert all(torch.equal(a, s) for a, s in zip(args, saved))


def test_hvd302_peak_exceeds_budget(monkeypatch):
    """:253 — a budget under the 12 KB peak fires; a roomy one leaves
    headroom; the knob is read when no budget is passed."""
    r = memplan.measure_step_fn(_out_of_place, (_x(),), label="tight",
                                budget_bytes=8 * 1024)
    assert [f.rule for f in r.findings] == ["HVD302"]
    assert r.headroom_bytes < 0
    ok = memplan.measure_step_fn(_out_of_place, (_x(),), label="roomy",
                                 budget_bytes=1 << 20)
    assert ok.ok() and ok.headroom_bytes > 0
    monkeypatch.setenv("HVD_MEM_BUDGET_BYTES", str(3 * KB4 - 1))
    env = memplan.measure_step_fn(_out_of_place, (_x(),), label="env")
    assert [f.rule for f in env.findings] == ["HVD302"]
    assert env.headroom_bytes == -1


# -- HVD303 / HVD304 (:267, :283, :298) -----------------------------------------

def _widen(p):
    return p.float() * 2.0


def test_hvd303_upcast_blowup_and_small_island_negative(monkeypatch):
    p = torch.ones(4096, dtype=torch.bfloat16)
    r = memplan.measure_step_fn(_widen, (p,), label="widen",
                                upcast_min_bytes=1024)
    assert [f.rule for f in r.findings] == ["HVD303"]
    assert r.upcast_f32_bytes == 4096 * F32
    # Under the default 8 MiB floor the 16 KB island is clean.
    assert memplan.measure_step_fn(_widen, (p,), label="island").ok()
    # The floor knob is read per call; a malformed value degrades.
    monkeypatch.setenv("HVD_MEM_UPCAST_MIN_BYTES", "8MB")
    assert memplan.upcast_min_bytes_default() == 8 << 20
    monkeypatch.setenv("HVD_MEM_UPCAST_MIN_BYTES", "1024")
    env = memplan.measure_step_fn(_widen, (p,), label="widen-env")
    assert [f.rule for f in env.findings] == ["HVD303"]


@pytest.mark.parametrize("threshold,rules", [(4 * 1024, ["HVD304"]),
                                             (64 * 1024, [])])
def test_hvd304_fusion_bucket(threshold, rules):
    def fused(a, b):
        return torch.cat([a.reshape(-1), b.reshape(-1)])

    r = memplan.measure_step_fn(fused, (_x(), _x(seed=1)), label="bucket",
                                fusion_threshold=threshold)
    assert [f.rule for f in r.findings] == rules
    if rules:
        assert "HOROVOD_FUSION_THRESHOLD" in r.findings[0].message


# -- the serve engine (:512, :535) -------------------------------------------------

@pytest.fixture()
def analyze_env(monkeypatch):
    monkeypatch.setenv("HVD_ANALYZE", "1")
    hook.reset()
    monkeypatch.setattr(core._state, "analysis_reports", [])
    yield
    hook.reset()


_CFG = TransformerConfig(vocab_size=64, num_layers=2, num_heads=2,
                         d_model=32, d_ff=64, max_len=32,
                         dtype=torch.float32)


def _model():
    torch.manual_seed(0)
    return Transformer(_CFG)


def _small_engine(model):
    adapter = TransformerAdapter(_CFG, model, block_tokens=8,
                                 device="cpu")
    engine = InferenceEngine(adapter, max_batch=2, kv_mode="paged",
                             metrics=ServeMetrics(),
                             replica_id="memwalk-test")
    return adapter, engine


def test_serve_programs_census_zero_collectives_and_peak(analyze_env,
                                                        monkeypatch):
    """:512 — the engine's programs publish reports with an empty census
    and no finding but HVD303; :535 — decode_paged's peak is within 2x
    of the weights plus the pool the engine allocates.  The tokens are
    those of an engine over the same weights without the analysis."""
    model = _model()
    adapter, engine = _small_engine(model)
    out = engine.generate([1, 2, 3, 4, 5], max_new_tokens=4)
    engine.stop()
    reports = [r for r in hvd.analysis_reports()
               if r.label.startswith("serve:")]
    labels = [r.label for r in reports]
    assert any("prefill_chunk" in lb for lb in labels), labels
    assert any("decode_paged" in lb for lb in labels), labels
    for r in reports:
        assert r.census == {}, (r.label, r.census)
        assert not [f for f in r.findings if f.rule != "HVD303"], \
            [(f.rule, f.message) for f in r.findings]
    peak = next(r for r in reports
                if r.label.startswith("serve:decode_paged")
                ).memory["peak_live_bytes"]
    actual = (memplan.params_bytes(adapter.params)
              + memplan.params_bytes(engine._cache))
    assert actual / 2 <= peak <= actual * 2, (peak, actual)
    monkeypatch.delenv("HVD_ANALYZE")
    _, plain = _small_engine(model)
    assert plain.generate([1, 2, 3, 4, 5], max_new_tokens=4) == out
    plain.stop()
