"""The ``HVD_ANALYZE=1`` hook of the port (``analysis/hook.py``) at its
three sites, against the JAX hook's expected values.

The JAX hook's walk reads ``jax.core.Var``, which this jax no longer
has, so ``tests/test_jaxpr_check.py:268-366`` cannot run here: each test
writes that case's program in torch and holds the port to the values it
writes down.  Where the port's census differs it is the optimizer's
fusion: the port reduces a step's same-dtype gradients as one flat
buffer (the fusion planner's bucket, ``_fused_allreduce``), where JAX
psums each leaf — the count differs, the bytes do not.

Also here: a 2-process gloo world in which rank 0 alone analyzes a step
with collectives and then both ranks run it (the trace contacts no
peer, or rank 1 would wait on it), and the inert hook (nothing traced
without ``HVD_ANALYZE``).
"""

import json

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import core
from horovod_tpu_torch.analysis import graph_check, hook
from horovod_tpu_torch.models import create_mlp
from horovod_tpu_torch.parallel import P
from horovod_tpu_torch.serve import InferenceEngine, MLPAdapter, ServeMetrics

from test_torch_collectives import run_gloo_world

N = 4


@pytest.fixture()
def world():
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


@pytest.fixture()
def analyze_env(monkeypatch):
    monkeypatch.setenv("HVD_ANALYZE", "1")
    hook.reset()
    monkeypatch.setattr(core._state, "analysis_reports", [])
    yield
    hook.reset()


def _params():
    return {"w": torch.ones(3, 2), "b": torch.ones(2)}


def _local_step(p, xb):
    """JAX's local_step: the squared loss's gradients reduced, SGD."""
    loss = ((xb @ p["w"] + p["b"]) ** 2).sum()
    g = torch.autograd.grad(loss, [p["w"], p["b"]])
    red = [hvd.allreduce(x, op=hvd.Average) for x in g]
    return {"w": (p["w"] - 0.1 * red[0]).detach(),
            "b": (p["b"] - 0.1 * red[1]).detach()}


def _grad_params():
    return {k: v.requires_grad_() for k, v in _params().items()}


def _optimizer():
    params = [torch.nn.Parameter(torch.ones(3, 2)),
              torch.nn.Parameter(torch.ones(2))]
    opt = hvd.DistributedOptimizer(torch.optim.SGD(params, lr=0.1,
                                                   momentum=0.9))
    for p in params:
        p.grad = torch.full_like(p, 0.5)
    return opt, params


def test_hook_shard_step_publishes_report(analyze_env, world):
    """:268 — one report per wrapper and arity: a second call is
    silent; the two gradient allreduces are censused; training trained."""
    step = hvd.shard_step(_local_step, in_specs=(P(), P("hvd")),
                          out_specs=P())
    xb = torch.ones(N, 3)
    p0 = _grad_params()
    p1 = step(p0, xb)
    p1 = step({k: v.requires_grad_() for k, v in p1.items()}, xb)
    reports = hvd.analysis_reports()
    assert [r.label for r in reports] == ["shard_step:_local_step/2"]
    assert reports[0].ok(), [f.message for f in reports[0].findings]
    assert reports[0].census["allreduce"] == {"count": 2, "bytes": 32}
    assert reports[0].memory["peak_live_bytes"] > 0
    assert reports[0].comm["axes_used"] == ["hvd"]
    assert not torch.allclose(p1["w"], _params()["w"])


def test_hook_eager_optimizer_publishes_census(analyze_env, world,
                                               tmp_path):
    """:293 — the first reducing step() publishes one report, its census
    on the timeline (:175); the update is the one the same optimizer
    makes unanalyzed; a second step is silent."""
    hvd.start_timeline(str(tmp_path / "tl.json"))
    opt, params = _optimizer()
    ref, ref_params = _optimizer()
    opt.step()
    hvd.stop_timeline()
    reports = hvd.analysis_reports()
    assert len(reports) == 1
    assert reports[0].label.startswith("DistributedOptimizer:")
    assert reports[0].ok(), [f.message for f in reports[0].findings]
    # JAX: psum count 2, bytes 32; the port: one fused bucket, 32 bytes.
    assert reports[0].census == {"allreduce": {"count": 1, "bytes": 32}}
    with open(tmp_path / "tl.json") as fh:
        events = json.load(fh)
    census = [e for e in events if str(e.get("name", "")).startswith(
        "COLLECTIVE_CENSUS/DistributedOptimizer:")]
    assert [e["args"] for e in census] == [{"count": 1, "bytes": 32}]
    hook.reset()
    ref._analyzed_gen = hook.generation()   # ref steps unanalyzed
    ref.step()
    for a, b in zip(params, ref_params):
        assert torch.equal(a, b)
    opt._analyzed_gen = hook.generation()
    for p in params:
        p.grad = torch.full_like(p, 0.5)
    opt.step()
    assert len(hvd.analysis_reports()) == 1


def test_hook_never_crashes_training_on_untraceable_step(analyze_env,
                                                         world):
    """:319 — a step that refuses the analysis trace still runs; the
    failure is reported as HVD100."""
    calls = {"n": 0}

    def flaky(x):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("refuses the analysis trace")
        return x * 2.0

    step = hvd.shard_step(flaky, in_specs=(P("hvd"),), out_specs=P("hvd"))
    out = step(torch.ones(N))
    assert torch.equal(out, 2.0 * torch.ones(N))
    reports = hvd.analysis_reports()
    assert len(reports) == 1
    assert [f.rule for f in reports[0].findings] == ["HVD100"]
    assert "refuses the analysis trace" in reports[0].findings[0].message


@pytest.mark.parametrize("site", ["shard_step", "optimizer"])
def test_hook_analyzes_every_instance(analyze_env, world, site):
    """:342 / :357 — two same-named steps, and two optimizers, each get
    their own report (the dedup is per instance, never by name or
    id()); the optimizers' labels differ."""
    for scale in (1.0, 2.0):
        if site == "shard_step":
            def step(x, scale=scale):
                return hvd.allreduce(x * scale, op=hvd.Sum)
            hvd.shard_step(step, in_specs=(P("hvd"),),
                           out_specs=P("hvd"))(torch.ones(N))
        else:
            _optimizer()[0].step()
    labels = [r.label for r in hvd.analysis_reports()]
    assert len(labels) == 2
    assert (labels[0] != labels[1]) == (site == "optimizer")


def test_hook_disabled_is_inert(monkeypatch, world):
    """:366 — without HVD_ANALYZE nothing is traced (the trace function
    is never called) and nothing is published, at all three sites."""
    monkeypatch.delenv("HVD_ANALYZE", raising=False)
    hook.reset()
    monkeypatch.setattr(core._state, "analysis_reports", [])
    calls = []
    real = graph_check.trace
    monkeypatch.setattr(graph_check, "trace",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    hvd.shard_step(_local_step, in_specs=(P(), P("hvd")))(
        _grad_params(), torch.ones(N, 3))
    _optimizer()[0].step()
    torch.manual_seed(0)
    mlp = create_mlp((8, 16), in_features=16, device="cpu")
    engine = InferenceEngine(MLPAdapter(mlp, 16), max_batch=2,
                             kv_mode="paged", metrics=ServeMetrics())
    engine.generate([1, 2, 3], max_new_tokens=3)
    engine.stop()
    assert calls == []
    assert hvd.analysis_reports() == []
    # Enabled, the same three sites trace.
    monkeypatch.setenv("HVD_ANALYZE", "1")
    hook.reset()
    hvd.shard_step(_local_step, in_specs=(P(), P("hvd")))(
        _grad_params(), torch.ones(N, 3))
    _optimizer()[0].step()
    engine = InferenceEngine(MLPAdapter(mlp, 16), max_batch=2,
                             kv_mode="paged", metrics=ServeMetrics())
    engine.generate([1, 2, 3], max_new_tokens=3)
    engine.stop()
    labels = [r.label for r in hvd.analysis_reports()]
    assert len(calls) == len(labels) >= 4, labels
    assert labels[0].startswith("shard_step:")
    assert labels[1].startswith("DistributedOptimizer:")
    assert all(lb.startswith("serve:") for lb in labels[2:])


WORKER = r"""
import os, sys
if os.environ["HOROVOD_RANK"] == "0":
    os.environ["HVD_ANALYZE"] = "1"
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.parallel import P

hvd.init(device="cpu")
r = hvd.rank()

def step(x):
    y = hvd.allreduce(x * 2.0, op=hvd.Sum)
    return hvd.allgather(y)

wrapped = hvd.shard_step(step, in_specs=(P(),), out_specs=P())
outs = [wrapped(torch.full((3,), float(r + 1) + i)).numpy()
        for i in range(2)]
reports = hvd.analysis_reports()
census = reports[0].census if reports else {}
np.savez(sys.argv[1], out0=outs[0], out1=outs[1],
         n_reports=len(reports),
         allreduce=census.get("allreduce", {}).get("count", 0),
         allgather_bytes=census.get("allgather", {}).get("bytes", 0))
hvd.shutdown()
"""


def test_rank_alone_analyzes_and_no_rank_hangs(tmp_path):
    """A 2-process gloo world: rank 0 runs under HVD_ANALYZE=1 and
    traces the step (an allreduce and an allgather) before its first
    real call; rank 1 does not.  The trace contacts no peer: both ranks
    then run the step twice and agree, and only rank 0 has a report."""
    res = run_gloo_world(WORKER, tmp_path, size=2, timeout=120)
    want0 = np.tile(2.0 * np.array([3.0, 3.0, 3.0]), 2)
    for r in (0, 1):
        np.testing.assert_allclose(res[r]["out0"], want0)
        np.testing.assert_allclose(res[r]["out1"], want0 + 4.0)
    assert int(res[0]["n_reports"]) == 1
    assert int(res[0]["allreduce"]) == 1
    assert int(res[0]["allgather_bytes"]) == 12
    assert int(res[1]["n_reports"]) == 0
