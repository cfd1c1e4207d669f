"""The port's autotuner (``horovod_tpu_torch/autotune.py``, ``optim.py``)
against the JAX package's: the same scripted samples through both
``ParameterManager``s (sweep and bayes, alone and as a controller /
follower pair) give the same candidate round by round and the same
threshold; the GP's posterior mean and std, expected improvement and the
optimizer's suggestions match at 1e-12.  Then the wiring: ``init`` makes
the manager from ``HOROVOD_AUTOTUNE*``, and ``DistributedOptimizer``
scores its bucket reductions and buckets by the explored threshold.
The 2-process bayes run is in ``tests/test_torch_checkpoint.py``'s
world.
"""

import numpy as np
import pytest
import torch

from horovod_tpu import autotune as JA
from horovod_tpu import optim as JO
from horovod_tpu_torch import autotune as TA
from horovod_tpu_torch import optim as TO


def _drive(pm, score_of, rounds):
    seen = []
    for _ in range(rounds):
        if pm.converged:
            break
        thr = pm.fusion_threshold_bytes
        seen.append(thr)
        pm.record_sample(int(score_of(thr) * 1e6), 1.0)
    return seen, pm.converged, pm.fusion_threshold_bytes


def _peak(thr):
    return -abs(np.log2(thr) - 23.0) + 10.0


@pytest.mark.parametrize("kwargs", [
    dict(candidates_mb=(1, 2, 4), samples_per_candidate=2),
    dict(samples_per_candidate=3),
    dict(search="bayes", bayes_rounds=10, samples_per_candidate=1),
    dict(search="bayes", bayes_rounds=6, samples_per_candidate=2),
])
def test_manager_matches_jax(kwargs, tmp_path):
    logs = []
    out = []
    for mod in (JA, TA):
        log = tmp_path / f"{mod.__name__}.csv"
        pm = mod.ParameterManager(enabled=True, log_path=str(log), **kwargs)
        out.append(_drive(pm, _peak, 100))
        pm.close()
        logs.append(log.read_text())
    assert out[0] == out[1]
    assert out[1][1]  # converged
    assert logs[0] == logs[1]


def test_disabled_manager_is_frozen():
    pm = TA.ParameterManager(enabled=False, initial_threshold=64)
    assert pm.converged and pm.fusion_threshold_bytes == 64
    pm.record_sample(100, 1.0)
    assert pm.converged


def test_controller_follower_pair_matches_jax():
    def pair(mod):
        published, decided = {}, {}

        def controller_decide(local):
            decided["value"] = local
            return local

        ctrl = mod.ParameterManager(
            enabled=True, samples_per_candidate=1, search="bayes",
            bayes_rounds=6, decide_fn=controller_decide,
            candidate_pub=lambda r, v: published.__setitem__(r, v))
        fol = mod.ParameterManager(
            enabled=True, samples_per_candidate=1, search="bayes",
            bayes_rounds=6, decide_fn=lambda local: decided["value"],
            candidate_fetch=lambda r: published[r])
        rounds = []
        for _ in range(6):
            t_c, t_f = ctrl.fusion_threshold_bytes, fol.fusion_threshold_bytes
            assert t_c == t_f
            rounds.append(t_c)
            ctrl.record_sample(int(_peak(t_c) * 1e6), 1.0)
            fol.record_sample(int(_peak(t_c) * 0.7e6), 1.0)
        assert ctrl.converged and fol.converged
        assert fol.fusion_threshold_bytes == ctrl.fusion_threshold_bytes
        return rounds, ctrl.fusion_threshold_bytes

    assert pair(TA) == pair(JA)


def test_gp_and_expected_improvement_match_jax():
    rng = np.random.RandomState(0)
    x = rng.rand(9, 1)
    y = np.sin(3 * x[:, 0]) + 0.1 * rng.randn(9)
    grid = np.linspace(-0.5, 1.5, 41)[:, None]
    for ls in (0.2, 0.3, 1.0):
        j, t = JO.GaussianProcess(length_scale=ls), \
            TO.GaussianProcess(length_scale=ls)
        j.fit(x, y)
        t.fit(x, y)
        jm, js = j.predict(grid)
        tm, ts = t.predict(grid)
        np.testing.assert_allclose(tm, jm, rtol=0, atol=1e-12)
        np.testing.assert_allclose(ts, js, rtol=0, atol=1e-12)
        np.testing.assert_allclose(
            TO.expected_improvement(tm, ts, best=float(y.max())),
            JO.expected_improvement(jm, js, best=float(y.max())),
            rtol=0, atol=1e-12)


def test_bayesian_optimizer_suggestions_match_jax():
    a, b = JO.BayesianOptimizer(20, 28), TO.BayesianOptimizer(20, 28)
    for _ in range(12):
        xa, xb = a.suggest(), b.suggest()
        assert abs(xa - xb) <= 1e-12
        a.observe(xa, -(xa - 24.5) ** 2)
        b.observe(xb, -(xb - 24.5) ** 2)
    assert abs(a.best() - b.best()) <= 1e-12
    assert abs(b.best() - 24.5) < 0.8


def test_init_makes_the_manager_and_the_optimizer_feeds_it(monkeypatch):
    import horovod_tpu_torch as thvd
    from horovod_tpu_torch import optimizer as topt
    monkeypatch.setenv("HOROVOD_AUTOTUNE", "1")
    monkeypatch.setenv("HOROVOD_AUTOTUNE_SEARCH", "bayes")
    monkeypatch.setenv("HOROVOD_AUTOTUNE_BAYES_ROUNDS", "3")
    thresholds = []
    real = topt.plan_fusion

    def spy(entries, threshold):
        thresholds.append(threshold)
        return real(entries, threshold)

    monkeypatch.setattr(topt, "plan_fusion", spy)
    thvd.shutdown()
    thvd.init(device="cpu")
    try:
        pm = thvd.core._state.param_manager
        assert pm.enabled and pm.search == "bayes" and not pm.converged
        params = [torch.nn.Parameter(torch.zeros(32, 32)) for _ in range(4)]
        opt = thvd.DistributedOptimizer(torch.optim.SGD(params, lr=0.1))
        explored = []
        for _ in range(3 * 5):
            explored.append(pm.fusion_threshold_bytes)
            for p in params:
                p.grad = torch.ones(32, 32)
            opt.step()
        assert pm.converged
        # Every reduction bucketed by the threshold explored at the time.
        assert thresholds == explored
        assert len(set(explored)) == 3
    finally:
        thvd.shutdown()
    monkeypatch.delenv("HOROVOD_AUTOTUNE")
    thvd.init(device="cpu")
    try:
        assert not thvd.core._state.param_manager.enabled
    finally:
        thvd.shutdown()
