"""The port's fleet controller (``serve/controller.py``) against the JAX
package's.

``decide`` is pure: every transition of the JAX package's table
(``tests/test_controller.py``) replays through both ``decide``s, which
must return the same actions and leave the same state after every poll.
``windowed_p99``, the config's validation and the env knobs match; the
brownout rungs 1–4 acting on the port's batcher shed, cap and purge as
the JAX batcher does.  Then the loop itself: a ``FleetController`` over
a port scheduler of one healthy replica and one dead spare (TINY GPT-2
on the CPU) under a seeded diurnal load and a ``ctl.poll`` load-spike
scales up by ``mark_alive``, climbs the brownout ladder and walks it
back down, and every answered request equals a single engine's answer.
"""

import dataclasses
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu import faultline as jfl
from horovod_tpu.models import transformer as jt
from horovod_tpu.serve import controller as jctl
from horovod_tpu.serve import DynamicBatcher as JaxBatcher
from horovod_tpu.serve import QueueFullError as JaxQueueFull
from horovod_tpu.serve import Request as JaxRequest
from horovod_tpu_torch import faultline as fl
from horovod_tpu_torch.models import (Transformer, TransformerConfig,
                                      params_from_jax)
from horovod_tpu_torch.serve import (ControllerConfig, ControllerState,
                                     DynamicBatcher, FleetController,
                                     FleetSnapshot, InferenceEngine,
                                     QueueFullError, Replica,
                                     ReplicaScheduler, Request, ServeMetrics,
                                     ServeServer, TransformerAdapter)
from horovod_tpu_torch.serve import controller as ctl

torch.set_num_threads(2)

BT = 8
VOCAB = 61
_JTINY = jt.TransformerConfig(vocab_size=VOCAB, num_layers=2, num_heads=2,
                              d_model=32, d_ff=64, max_len=64, causal=True,
                              dtype=jnp.float32, scan_layers=False)
_TTINY = TransformerConfig(vocab_size=VOCAB, num_layers=2, num_heads=2,
                           d_model=32, d_ff=64, max_len=64,
                           dtype=torch.float32)


# -- decide(): JAX's whole transition table, through both ---------------------

_BASE = dict(poll_s=0.1, min_replicas=1, max_replicas=8, queue_high=8.0,
             queue_low=1.0, up_polls=3, down_polls=4, up_cooldown_s=0.0,
             down_cooldown_s=0.0, brownout_polls=2, brownout_clear_polls=3)


def _hot(healthy=2, spares=1, queued=100, **kw):
    return dict(healthy=healthy, spares=spares, queued=queued, **kw)


def _idle(healthy=2, spares=1, queued=0, **kw):
    return dict(healthy=healthy, spares=spares, queued=queued, **kw)


# Each case: config overrides, then phases of (snapshots, t0, dt) run on
# one state, as JAX's tests run them.
_TABLE = {
    "scale_up_after_sustained_pressure": (
        dict(up_polls=3), [([_hot()] * 4, 0.0, 1.0)]),
    "pressure_blip_resets_hysteresis": (
        dict(up_polls=3),
        [([_hot(), _hot(), _hot(queued=8), _hot(), _hot()], 0.0, 1.0)]),
    "up_cooldown_blocks_then_fires": (
        dict(up_polls=2, up_cooldown_s=3.5), [([_hot()] * 8, 0.0, 1.0)]),
    "pressure_queue": (
        dict(up_polls=2, slo_ms=500.0, headroom_min_bytes=1 << 20),
        [([_hot(queued=100)] * 2, 0.0, 1.0)]),
    "pressure_latency_p99": (
        dict(up_polls=2, slo_ms=500.0, headroom_min_bytes=1 << 20),
        [([_idle(latency_p99_ms=900.0)] * 2, 0.0, 1.0)]),
    "pressure_kv_headroom": (
        dict(up_polls=2, slo_ms=500.0, headroom_min_bytes=1 << 20),
        [([_idle(kv_headroom_bytes=1 << 10)] * 2, 0.0, 1.0)]),
    "pressure_ttft_p99": (
        dict(up_polls=2, ttft_slo_ms=100.0),
        [([_idle(ttft_p99_ms=250.0)] * 2, 0.0, 1.0)]),
    "disabled_slo_and_headroom_ignored": (
        dict(up_polls=1, slo_ms=0.0, headroom_min_bytes=0),
        [([_idle(latency_p99_ms=10_000.0, kv_headroom_bytes=1)] * 3,
          0.0, 1.0)]),
    "scale_down_after_sustained_idleness": (
        dict(down_polls=4), [([_idle()] * 5, 0.0, 1.0)]),
    "scale_down_guards_min_replicas": (
        dict(down_polls=2, min_replicas=2),
        [([_idle(healthy=2)] * 6, 0.0, 1.0)]),
    "scale_down_cooldown": (
        dict(down_polls=2, down_cooldown_s=3.5, min_replicas=1),
        [([_idle(healthy=4)] * 9, 0.0, 1.0)]),
    "dead_band_resets_idle_counter": (
        dict(down_polls=2),
        [([_idle(), _hot(queued=8), _idle(), _idle()], 0.0, 1.0)]),
    "brownout_only_when_envelope_exhausted": (
        dict(up_polls=1, brownout_polls=1),
        [([_hot(healthy=2, spares=3)] * 4, 0.0, 1.0)]),
    "brownout_climbs_at_max_replicas": (
        dict(up_polls=2, brownout_polls=2),
        [([_hot(healthy=8, spares=3)] * 12, 0.0, 1.0)]),
    "brownout_climbs_out_of_spares": (
        dict(up_polls=2, brownout_polls=2),
        [([_hot(healthy=2, spares=0)] * 12, 0.0, 1.0)]),
    "brownout_descends_then_scales_down": (
        dict(up_polls=1, brownout_polls=1, brownout_clear_polls=3,
             down_polls=2),
        [([_hot(healthy=8, spares=0)] * 2, 0.0, 1.0),
         ([_idle(healthy=8)] * 7, 100.0, 1.0)]),
    "brownout_descent_interrupted": (
        dict(up_polls=1, brownout_polls=1, brownout_clear_polls=2),
        [([_hot(healthy=8, spares=0)], 0.0, 1.0),
         ([_idle(healthy=8), _hot(healthy=8, spares=0), _idle(healthy=8),
           _idle(healthy=8)], 50.0, 1.0)]),
}


@pytest.mark.parametrize("case", sorted(_TABLE))
def test_decide_table_matches_jax(case):
    overrides, phases = _TABLE[case]
    cfg = ControllerConfig(**dict(_BASE, **overrides)).validate()
    jcfg = jctl.ControllerConfig(**dict(_BASE, **overrides)).validate()
    state, jstate = ControllerState(), jctl.ControllerState()
    seen = []
    for snaps, t0, dt in phases:
        for i, snap in enumerate(snaps):
            now = t0 + i * dt
            got = ctl.decide(cfg, state, FleetSnapshot(**snap), now)
            want = jctl.decide(jcfg, jstate, jctl.FleetSnapshot(**snap),
                               now)
            assert got == want, (case, now)
            assert dataclasses.asdict(state) == dataclasses.asdict(jstate)
            seen += got
    if case.startswith("brownout_climbs"):
        assert state.brownout_level == ctl.BROWNOUT_MAX_LEVEL
    if case == "brownout_descends_then_scales_down":
        assert state.brownout_level == 0 and "scale_down" in seen


@pytest.mark.parametrize("args", [
    ([1.0, 5.0, 25.0], [3, 3, 3], [3, 3, 3], 3, 3),
    ([1.0, 5.0, 25.0], [0, 0, 3], [0, 3, 6], 3, 6),
    ([1.0, 5.0, 25.0], None, [0, 0, 4], 0, 4),
    ([1.0, 5.0, 25.0], [0, 0, 0], [0, 0, 0], 0, 2),
    ([], None, [], 0, 0),
])
def test_windowed_p99_matches_jax(args):
    assert ctl.windowed_p99(*args) == jctl.windowed_p99(*args)


@pytest.mark.parametrize("bad", [
    dict(min_replicas=0), dict(min_replicas=4, max_replicas=2),
    dict(queue_low=9, queue_high=8), dict(poll_s=0)])
def test_config_validation_matches_jax(bad):
    with pytest.raises(ValueError) as got:
        ControllerConfig(**bad).validate()
    with pytest.raises(ValueError) as want:
        jctl.ControllerConfig(**bad).validate()
    assert str(got.value) == str(want.value)


def test_config_from_env_matches_jax(monkeypatch):
    for k, v in (("HVD_SERVE_CTL_SLO_MS", "250"),
                 ("HVD_SERVE_CTL_MAX_REPLICAS", "12"),
                 ("HVD_SERVE_CTL_BROWNOUT_MAX_NEW", "48"),
                 ("HVD_SERVE_CTL_UP_POLLS", "5")):
        monkeypatch.setenv(k, v)
    assert dataclasses.asdict(ControllerConfig.from_env()) == \
        dataclasses.asdict(jctl.ControllerConfig.from_env())


# -- brownout rungs on the port's batcher against the JAX batcher -------------

def _rung_outcomes(Batcher, Req, QFull, level):
    """Submit a mixed set at ``level`` and admit: the per-request outcome
    (admitted, shed at submit, purged at admission) with its message,
    and the max_new_tokens admission saw."""
    shed = []
    b = Batcher(max_queue=16, max_wait_ms=0,
                on_shed=lambda r, why: shed.append((r.prompt[0], why)))
    reqs = [Req([1], qos="throughput", max_new_tokens=64),
            Req([2], qos="latency", max_new_tokens=64),
            Req([3], temperature=0.5, n=4, seed=7, max_new_tokens=4),
            Req([4], qos="throughput", max_new_tokens=4)]
    out = {}
    queued = []
    for i, r in enumerate(reqs[:2]):
        b.submit(r)  # queued before the rung engages
        queued.append(r)
    b.brownout_level = level
    b.brownout_max_new = 8 if level >= 2 else 0
    for r in reqs[2:]:
        try:
            b.submit(r)
            queued.append(r)
        except QFull as e:
            out[r.prompt[0]] = ("refused", str(e))
    got = b.get_admission(8, budget=100, cost=lambda r: 1)
    for r in got:
        out[r.prompt[0]] = ("admitted", r.max_new_tokens)
    for r in queued:
        if r not in got:
            with pytest.raises(QFull) as e:
                r.result(timeout=1)
            out[r.prompt[0]] = ("purged", str(e.value))
    return out, sorted(shed)


@pytest.mark.parametrize("level", [1, 2, 3, 4])
def test_brownout_rungs_match_jax_batcher(level):
    got = _rung_outcomes(DynamicBatcher, Request, QueueFullError, level)
    want = _rung_outcomes(JaxBatcher, JaxRequest, JaxQueueFull, level)
    assert got == want
    outcomes, _ = got
    assert outcomes[2][0] == "admitted"  # the latency tier always admits
    if level >= 2:
        assert outcomes[2][1] == 8       # capped at admission
    if level >= 3:
        assert outcomes[3][0] == "refused"
    if level >= 4:
        assert outcomes[1][0] == "purged"


def test_diurnal_load_matches_jax():
    for seed in (0, 9):
        assert fl.diurnal_load(8, peak=8, base=1, seed=seed) == \
            jfl.diurnal_load(8, peak=8, base=1, seed=seed)


def test_controller_consumes_load_spike_through_injector():
    bursts = []
    sched = types.SimpleNamespace(fleet=lambda: [], metrics=ServeMetrics())
    c = FleetController(sched, config=ControllerConfig(**_BASE),
                        load_injector=lambda n: bursts.append(n) or n)
    plan = fl.FaultPlan([fl.FaultSpec("load-spike", step=1, repeat=2,
                                      param=5.0)], seed=3)
    fl.install(plan)
    try:
        for _ in range(4):
            c.poll()
        assert plan.exhausted() and bursts == [5, 5]
    finally:
        fl.uninstall()


# -- the loop over a port fleet ------------------------------------------------

def _flax_params(seed=0):
    tree = jt.Transformer(_JTINY).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.RandomState(seed)
    std = {"scale": 0.1, "bias": 0.1, "embedding": 0.5, "kernel": 0.2}
    return jax.tree_util.tree_map_with_path(
        lambda path, x: np.asarray(
            std[path[-1].key] * rng.randn(*x.shape)
            + (path[-1].key == "scale"), np.float32),
        jax.device_get(tree))


@pytest.fixture(scope="module")
def model():
    m = Transformer(_TTINY, device="cpu")
    m.load_state_dict(params_from_jax(_flax_params()))
    return m


def _engine(model, rid, max_batch=1, metrics=None):
    ad = TransformerAdapter(_TTINY, model, block_tokens=BT, device="cpu")
    return InferenceEngine(ad, max_batch=max_batch, prefill_chunk=8,
                           replica_id=rid, metrics=metrics)


def _prompts(n, seed=5):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, (int(rng.randint(3, 12)),)).tolist()
            for _ in range(n)]


def test_fleet_controller_scales_up_and_walks_the_ladder(model):
    """One healthy replica and one dead spare, one slot each; a seeded
    diurnal sweep of greedy requests plus a throughput-tier filler per
    tick, and a ctl.poll load-spike.  The controller revives the spare,
    climbs the ladder at the envelope, walks it back to 0 once the load
    recedes, and every latency-tier answer equals a single engine's."""
    metrics = ServeMetrics()
    reps = [Replica(f"replica-{i}", None,
                    _engine(model, f"replica-{i}", metrics=metrics))
            for i in range(2)]
    sched = ReplicaScheduler(reps, metrics=metrics).start()
    sched.mark_dead("replica-1", reason="spare")
    cfg = ControllerConfig(poll_s=0.05, min_replicas=1, max_replicas=2,
                           queue_high=2.0, queue_low=1.0, up_polls=2,
                           down_polls=2, up_cooldown_s=0.0,
                           down_cooldown_s=0.0, brownout_polls=1,
                           brownout_clear_polls=2, brownout_max_new=8)
    injected = []

    def inject(n):
        for _ in range(n):
            r = Request([1, 2, 3], max_new_tokens=2, qos="throughput")
            try:
                sched.submit(r)
                injected.append(r)
            except QueueFullError:
                pass
        return n

    c = FleetController(sched, config=cfg, metrics=metrics,
                        load_injector=inject)
    shape = fl.diurnal_load(8, peak=8, base=1, seed=3)
    prompts = _prompts(sum(max(n, 1) for n in shape))
    fl.install(fl.FaultPlan([fl.FaultSpec("load-spike", step=4, param=6.0)],
                            seed=3))
    outs, levels, shed = [], [], 0
    try:
        cursor = 0
        for n in shape:
            chunk = prompts[cursor:cursor + max(n, 1)]
            cursor += len(chunk)
            reqs = [Request(p, max_new_tokens=6) for p in chunk]
            for r in reqs:
                sched.submit(r)
            try:
                sched.submit(Request([4, 5], max_new_tokens=2,
                                     qos="throughput"))
            except QueueFullError:
                shed += 1
            while not all(r.done for r in reqs):
                c.poll()
                levels.append(c.stats()["brownout_level"])
                time.sleep(0.01)
            outs += [r.result(timeout=60) for r in reqs]
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and c.stats()["brownout_level"]:
            c.poll()
            levels.append(c.stats()["brownout_level"])
            time.sleep(0.01)
    finally:
        fl.uninstall()
        c.stop()
        sched.stop()
    stats = c.stats()
    assert stats["scale_events"]["scale_up"] >= 1
    assert reps[1].engine.batcher.brownout_level == stats["brownout_level"]
    assert max(levels) >= 1 and levels[-1] == 0
    assert stats["scale_events"]["brownout_down"] >= 1
    assert metrics.snapshot()["replica_events"]["mark_alive"] >= 1
    # Every latency-tier request was answered, as one engine answers it.
    ref = _engine(model, "ref", max_batch=4)
    ref.start()
    try:
        want = [ref.generate(p, max_new_tokens=6) for p in prompts]
    finally:
        ref.stop()
    assert outs == want
    snap = metrics.snapshot()
    assert snap["brownout_level"] == 0
    assert snap["ctl_events"]["scale_up"] == stats["scale_events"]["scale_up"]
    assert "hvd_serve_brownout_level 0" in metrics.render()


def test_controller_thread_recovers_from_poll_errors(model):
    metrics = ServeMetrics()
    sched = ReplicaScheduler([Replica("replica-0", None,
                                      _engine(model, "replica-0"))],
                             metrics=metrics)
    c = FleetController(sched, config=ControllerConfig(poll_s=0.01),
                        metrics=metrics)
    calls = {"n": 0}
    real = c.snapshot

    def flaky():
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected snapshot failure")
        return real()

    c.snapshot = flaky
    server = ServeServer(sched, controller=c)
    server.start(port=0, host="127.0.0.1")
    try:
        deadline = time.monotonic() + 10
        while calls["n"] < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert calls["n"] >= 3, "the poll loop died after one error"
    finally:
        server.stop()  # stops the controller before the scheduler
    assert c._thread is None
    assert metrics.snapshot()["ctl_events"]["poll_error"] == 1


def test_autoscale_flag_and_env(monkeypatch):
    """``--autoscale`` (or HVD_SERVE_CTL_ENABLE=1) hands a
    ``FleetController`` to the CLI's server, as the JAX CLI does; without
    either, none."""
    from horovod_tpu_torch import core
    from horovod_tpu_torch.serve import replica as rep
    from horovod_tpu_torch.serve import server as srv
    seen = []

    class _Stop(Exception):
        pass

    def fake_server(scheduler, controller=None, **kw):
        seen.append(controller)
        raise _Stop

    monkeypatch.setattr(core, "is_initialized", lambda: True)
    monkeypatch.setattr(rep, "build_replicas",
                        lambda factory, **kw: types.SimpleNamespace(
                            metrics=ServeMetrics(), fleet=lambda: []))
    monkeypatch.setattr(srv, "ServeServer", fake_server)
    for argv, env in (([], "0"), (["--autoscale"], "0"), ([], "1")):
        monkeypatch.setenv("HVD_SERVE_CTL_ENABLE", env)
        with pytest.raises(_Stop):
            srv.run_commandline(argv + ["--device", "cpu", "--port", "0",
                                        "--vocab-size", "16"])
    assert [type(c).__name__ for c in seen] == \
        ["NoneType", "FleetController", "FleetController"]
