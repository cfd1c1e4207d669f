"""The port's plan verdict (hvdmem's pool budget, hvdshard's replica plan)
against the JAX package's.

* ``check_pool_budget`` and ``check_replica_plan`` return ``to_dict()``s
  equal to the JAX package's on every key the port's reports keep (the
  trace-time walks' fields too, empty in a budget check; the port's comm
  report leaves out JAX's cross-host and reshard fields), on the same
  sizes and
  budgets, given as arguments or read from ``HVD_MEM_BUDGET_BYTES`` /
  ``HVD_COMM_BUDGET_BYTES`` — set, unset, empty (read as unset) and
  malformed (read as "no budget").  A finding's ``fix_hint`` is left out
  of the comparison: it is the catalogue's advice, worded for the card
  in the port; rule, severity, path and message are compared.
* The engines' healthz fields (``plan_go``, ``plan_findings``,
  ``kv_headroom_bytes``, ``pool_bytes``, ``weight_bytes``) equal the JAX
  engine's for TINY GPT-2 (the same flax weights, numpy-drawn), within
  and one byte over a budget (an MLP's weights the JAX engine does not
  count: see its test); the over-budget engine
  publishes HVD302 to ``hvd.analysis_reports()`` as JAX's does, and an
  SP engine whose ring bytes exceed the comm budget reports HVD401.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu import core as jax_core
from horovod_tpu.analysis import memplan as jax_memplan
from horovod_tpu.analysis import shardplan as jax_shardplan
from horovod_tpu.models import create_mlp as jax_create_mlp
from horovod_tpu.models import transformer as jt
from horovod_tpu.serve import InferenceEngine as JaxEngine
from horovod_tpu.serve import MLPAdapter as JaxMLPAdapter
from horovod_tpu.serve import Replica as JaxReplica
from horovod_tpu.serve import TransformerAdapter as JaxAdapter
import horovod_tpu_torch as hvd
from horovod_tpu_torch import core
from horovod_tpu_torch.analysis import memplan, shardplan
from horovod_tpu_torch.models import (Transformer, TransformerConfig,
                                      create_mlp, mlp_params_from_jax,
                                      params_from_jax)
from horovod_tpu_torch.serve import (InferenceEngine, MLPAdapter, Replica,
                                     ServeMetrics, TransformerAdapter)

torch.set_num_threads(2)

BT = 8
VOCAB = 61
NB = 24
_JTINY = jt.TransformerConfig(vocab_size=VOCAB, num_layers=2, num_heads=2,
                              d_model=32, d_ff=64, max_len=64, causal=True,
                              dtype=jnp.float32, scan_layers=False)
_TTINY = TransformerConfig(vocab_size=VOCAB, num_layers=2, num_heads=2,
                           d_model=32, d_ff=64, max_len=64,
                           dtype=torch.float32)
# JAX's plan also reads a cross-host sub-budget, which the port leaves
# out: it is cleared with the others so neither side sees one.
ENV = ("HVD_MEM_BUDGET_BYTES", "HVD_COMM_BUDGET_BYTES",
       "HVD_COMM_DCN_BUDGET_BYTES")


def _masked(report):
    d = report.to_dict()
    if "findings" in d:
        d["findings"] = [{k: v for k, v in f.items() if k != "fix_hint"}
                         for f in d["findings"]]
    return d, [(f.rule, f.severity, f.path, f.message)
               for f in report.findings]


def _keys_of(want, got):
    """JAX's report dict cut to the keys of the port's (the ``mem`` /
    ``comm`` halves of a verdict too); a key the port has and JAX lacks
    raises."""
    return {k: _keys_of(want[k], v) if isinstance(v, dict) else want[k]
            for k, v in got.items()}


def _same(got, want):
    (gd, gf), (wd, wf) = _masked(got), _masked(want)
    assert gd == _keys_of(wd, gd)
    assert gf == wf


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(core._state, "analysis_reports", [])
    monkeypatch.setattr(jax_core._state, "analysis_reports", [])


@pytest.mark.parametrize("budget", [None, 0, 1499, 1500, 10 ** 10])
@pytest.mark.parametrize("pool,weights", [(0, 0), (1000, 500),
                                          (10 ** 9, 2 * 10 ** 8)])
def test_pool_budget_matches_jax(pool, weights, budget):
    got = memplan.check_pool_budget("serve:r:kv-pool", pool, weights,
                                    budget=budget)
    want = jax_memplan.check_pool_budget("serve:r:kv-pool", pool, weights,
                                         budget=budget)
    _same(got, want)
    assert set(got.to_dict()) == {"label", "peak_live_bytes", "input_bytes",
                                  "output_bytes", "budget_bytes",
                                  "headroom_bytes", "upcast_f32_bytes",
                                  "by_primitive"}
    assert got.ok() == want.ok()


@pytest.mark.parametrize("comm_env", [None, "", "abc", "100", "99999"])
@pytest.mark.parametrize("mem_env", [None, "", "abc", "1499", "4000"])
def test_replica_plan_matches_jax_under_env_budgets(monkeypatch, mem_env,
                                                    comm_env):
    if mem_env is not None:
        monkeypatch.setenv("HVD_MEM_BUDGET_BYTES", mem_env)
    if comm_env is not None:
        monkeypatch.setenv("HVD_COMM_BUDGET_BYTES", comm_env)
    assert memplan.device_budget_bytes() == \
        jax_memplan.device_budget_bytes()
    assert shardplan.comm_budget_bytes() == \
        jax_shardplan.comm_budget_bytes()
    kw = dict(pool_bytes=1000, weight_bytes=500, step_comm_bytes=4096)
    got = shardplan.check_replica_plan("serve:r:plan", **kw)
    want = jax_shardplan.check_replica_plan("serve:r:plan", **kw)
    _same(got, want)
    assert set(got.comm) == {"label", "total_wire_bytes", "budget_bytes",
                             "headroom_bytes", "dynamic_loops",
                             "axes_declared", "axes_used", "by_primitive",
                             "by_axis"}
    assert got.go == want.go
    pool = memplan.check_pool_budget("serve:r:kv-pool", 1000, 500)
    jpool = jax_memplan.check_pool_budget("serve:r:kv-pool", 1000, 500)
    _same(pool, jpool)


def test_explicit_budgets_override_env(monkeypatch):
    monkeypatch.setenv("HVD_MEM_BUDGET_BYTES", "1")
    monkeypatch.setenv("HVD_COMM_BUDGET_BYTES", "1")
    kw = dict(pool_bytes=10, weight_bytes=5, step_comm_bytes=7,
              mem_budget_bytes=100, comm_budget=8)
    got = shardplan.check_replica_plan("p", **kw)
    want = jax_shardplan.check_replica_plan("p", **kw)
    _same(got, want)
    assert got.go and got.comm["headroom_bytes"] == 1


def test_device_budget_on_the_cpu_is_none():
    """No card, no variable: no budget (the JAX probe reads the CPU
    device's memory stats, which are empty); a CPU device never has
    one."""
    assert memplan.device_budget_bytes() is None
    assert memplan.device_budget_bytes("cpu") is None
    assert jax_memplan.device_budget_bytes() is None


def test_params_bytes_over_tensors_modules_and_state_dicts():
    mlp = create_mlp((16, VOCAB), in_features=VOCAB, device="cpu",
                     seed=None)
    n = sum(p.numel() for p in mlp.parameters()) * 4
    assert memplan.params_bytes(mlp) == n
    assert memplan.params_bytes(mlp.state_dict()) == n
    t = torch.zeros(3, 5, dtype=torch.bfloat16)
    assert memplan.params_bytes({"a": t, "b": [t, (t,)]}) == 30
    assert memplan.params_bytes(np.zeros(7, np.float32)) == 28
    assert memplan.params_bytes(None) == 0


# -- the engines -----------------------------------------------------------------

def _flax_params(seed=0):
    tree = jt.Transformer(_JTINY).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(0.1 * rng.randn(*x.shape), np.float32),
        jax.device_get(tree))


@pytest.fixture(scope="module")
def gpt2_pair():
    params = _flax_params()
    model = Transformer(_TTINY, device="cpu")
    model.load_state_dict(params_from_jax(params))
    return params, model


def _engines(kind, gpt2_pair, kv_dtype=None, **kw):
    if kind == "gpt2":
        params, model = gpt2_pair
        jad = JaxAdapter(_JTINY, params, block_tokens=BT,
                         attn_impl="gather", kv_dtype=kv_dtype)
        pad = TransformerAdapter(_TTINY, model, block_tokens=BT,
                                 device="cpu", kv_dtype=kv_dtype)
    else:
        jmlp = jax_create_mlp(features=(16, VOCAB))
        params = jmlp.init(jax.random.PRNGKey(3),
                           jnp.zeros((1, VOCAB)))["params"]
        mlp = create_mlp((16, VOCAB), in_features=VOCAB, device="cpu",
                         seed=None)
        mlp.load_state_dict(mlp_params_from_jax(jax.device_get(params)))
        jad = JaxMLPAdapter(jmlp, params, vocab_size=VOCAB, max_len=64)
        pad = MLPAdapter(mlp, vocab_size=VOCAB, max_len=64)
    common = dict(kv_mode="paged", max_batch=4, prefill_chunk=5,
                  num_blocks=NB, replica_id="r0", **kw)
    return (JaxEngine(jad, **common),
            InferenceEngine(pad, metrics=ServeMetrics(), **common))


FIELDS = ("plan_go", "plan_findings", "kv_headroom_bytes", "pool_bytes",
          "weight_bytes")


def _fields(kv):
    return {k: kv.get(k) for k in FIELDS}


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
@pytest.mark.parametrize("over", [False, True], ids=["within", "over"])
def test_engine_healthz_plan_fields_match_jax(monkeypatch, gpt2_pair, over,
                                              kv_dtype):
    kind = "gpt2"
    monkeypatch.setenv("HVD_MEM_BUDGET_BYTES", str(10 ** 7))
    jeng, peng = _engines(kind, gpt2_pair, kv_dtype)
    plan = jeng.pool_bytes + jeng.weight_bytes
    if over:
        # One byte below the pool plus the weights.
        monkeypatch.setenv("HVD_MEM_BUDGET_BYTES", str(plan - 1))
        monkeypatch.setattr(core._state, "analysis_reports", [])
        monkeypatch.setattr(jax_core._state, "analysis_reports", [])
        jeng, peng = _engines(kind, gpt2_pair, kv_dtype)
    want = _fields(jeng.kv_stats())
    got = _fields(peng.kv_stats())
    assert got == want
    assert want["plan_go"] is (not over)
    assert want["kv_headroom_bytes"] == (-1 if over else 10 ** 7 - plan)
    jh = JaxReplica("r0", None, jeng).to_dict()["kv_blocks"]
    ph = Replica("r0", None, peng).to_dict()["kv_blocks"]
    assert {k: ph.get(k) for k in FIELDS} == {k: jh.get(k) for k in FIELDS}
    reports = hvd.analysis_reports()
    jreports = jax_core.analysis_reports()
    assert [type(r).__name__ for r in reports] == \
        [type(r).__name__ for r in jreports] == \
        (["MemReport", "PlanVerdict"] if over else [])
    if over:
        assert [[f.rule for f in r.findings] for r in reports] == \
            [["HVD302"], ["HVD302"]]
        _same(reports[1], jreports[1])
        _same(reports[0], jreports[0])


def test_mlp_engine_counts_its_weights(monkeypatch, gpt2_pair):
    """An MLP pool costs nothing (the JAX engine falls back to what its
    pool arrays hold: nothing).  The JAX engine reads weights
    from ``adapter.params``, which its MLP adapter does not have (its
    parameters live in jitted closures), so it reports 0 weight bytes;
    the port reports the MLP's parameter bytes and the headroom left
    after them."""
    monkeypatch.setenv("HVD_MEM_BUDGET_BYTES", str(10 ** 7))
    jeng, peng = _engines("mlp", gpt2_pair)
    got, want = _fields(peng.kv_stats()), _fields(jeng.kv_stats())
    mlp_bytes = memplan.params_bytes(peng.adapter.mlp)
    assert mlp_bytes == (VOCAB * 16 + 16 + 16 * VOCAB + VOCAB) * 4
    assert want["weight_bytes"] == 0
    assert got["weight_bytes"] == mlp_bytes
    assert got["pool_bytes"] == want["pool_bytes"] == 0
    assert got["kv_headroom_bytes"] == 10 ** 7 - mlp_bytes
    assert got["plan_go"] is want["plan_go"] is True
    assert got["plan_findings"] == want["plan_findings"] == 0


def test_sp_engine_over_the_comm_budget_reports_hvd401(monkeypatch,
                                                       gpt2_pair):
    params, model = gpt2_pair
    kw = dict(kv_mode="paged", max_batch=8, prefill_chunk=5,
              prefix_cache=False, sp_ranks=4, sp_min_tokens=16,
              replica_id="sp")
    jeng = JaxEngine(JaxAdapter(_JTINY, params, block_tokens=BT,
                                attn_impl="gather"), **kw)
    assert jeng.sp_comm_bytes > 0
    monkeypatch.setenv("HVD_COMM_BUDGET_BYTES", str(jeng.sp_comm_bytes - 1))
    jeng = JaxEngine(JaxAdapter(_JTINY, params, block_tokens=BT,
                                attn_impl="gather"), **kw)
    peng = InferenceEngine(TransformerAdapter(_TTINY, model, block_tokens=BT,
                                              device="cpu"),
                           metrics=ServeMetrics(), **kw)
    assert peng.sp_comm_bytes == jeng.sp_comm_bytes
    assert _fields(peng.kv_stats()) == _fields(jeng.kv_stats())
    assert peng.kv_stats()["plan_go"] is False
    (verdict,) = hvd.analysis_reports()
    (jverdict,) = jax_core.analysis_reports()
    assert [f.rule for f in verdict.findings] == ["HVD401"]
    _same(verdict, jverdict)


def test_slot_mode_has_no_plan(gpt2_pair):
    _, model = gpt2_pair
    eng = InferenceEngine(TransformerAdapter(_TTINY, model, block_tokens=BT,
                                             device="cpu"),
                          kv_mode="slot", max_batch=2)
    assert eng.plan_verdict is None and eng.kv_stats() is None


def test_reports_survive_shutdown_and_init():
    """``hvd.analysis_reports()`` outlives ``shutdown`` and a new
    ``init``, as the JAX package's does without ``HVD_ANALYZE``."""
    verdict = shardplan.check_replica_plan("p", pool_bytes=2,
                                           mem_budget_bytes=1)
    shardplan.publish_verdict(verdict)
    hvd.init(device="cpu")
    try:
        assert hvd.analysis_reports() == [verdict]
    finally:
        hvd.shutdown()
    assert hvd.analysis_reports() == [verdict]
    assert hvd.analysis_reports() is not core._state.analysis_reports
