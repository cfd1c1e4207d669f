"""The port's elastic layer (``horovod_tpu_torch/elastic/``, its
launcher and driver) against the JAX package's.

* The state objects, as ``tests/test_elastic.py:58-160`` holds JAX's,
  with ``TorchState`` over an ``nn.Module`` and Adam: commit, restore in
  place (the optimizer's parameter references survive), reset
  callbacks, host updates, and the disk spill (a torn write ignored).
* The retry loop: one scripted sequence of ``HorovodInternalError`` and
  ``HostsUpdatedInterrupt`` through JAX's ``elastic.run`` and the
  port's gives the same save / restore / sync / reset events.
* ``ElasticSampler``'s indices equal JAX's over seeds, epochs,
  ``record_batch`` and a mid-epoch reshape.
* The driver, discovery and registration scenarios of
  ``tests/test_elastic.py:166-444`` on the port's copies.
* One elastic gloo world through the port's launcher (``--min-np 2
  --max-np 2``): every rank raises ``HorovodInternalError`` at batch 3
  (an in-place reset of the same world), then rank 1 dies abruptly at
  batch 7; the driver respawns it, it resumes from its spill, and both
  ranks end at ``batches=10 w=10.0``.  The survivor leaves its world in
  seconds, not the 300 s negotiation timeout.
All checks are exact.
"""

import json
import os
import re
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import horovod_tpu_torch as thvd  # noqa: E402
from horovod_tpu_torch import elastic as TE  # noqa: E402
from horovod_tpu_torch.exceptions import (  # noqa: E402
    HorovodInternalError, HostsUpdatedInterrupt)
from horovod_tpu_torch.runner.http_server import (  # noqa: E402
    RendezvousServer)


@pytest.fixture()
def world1():
    """The port in a gloo world of one on the CPU."""
    thvd.shutdown()
    thvd.init(device="cpu")
    yield thvd
    thvd.shutdown()


def _model_and_adam():
    from horovod_tpu_torch.models.mlp import create_mlp
    model = create_mlp(features=(6, 3), in_features=4, device="cpu", seed=0)
    opt = thvd.DistributedOptimizer(
        torch.optim.Adam(model.parameters(), lr=1e-2),
        backward_passes_per_step=2)
    return model, opt


def _train(model, opt, steps=1):
    x = torch.from_numpy(np.random.RandomState(3).randn(5, 4)
                         .astype(np.float32))
    for _ in range(steps):
        opt.zero_grad()
        model(x).square().mean().backward()
        opt.step()


def _snapshot(model, opt):
    sd = opt.state_dict()
    return ({k: v.clone() for k, v in model.state_dict().items()},
            {i: {k: v.clone() if torch.is_tensor(v) else v
                 for k, v in st.items()} for i, st in sd["state"].items()},
            None if sd["hvd_acc"] is None
            else [a.clone() for a in sd["hvd_acc"]], sd["hvd_passes"])


def _assert_snapshot(model, opt, snap):
    params, state, acc, passes = _snapshot(model, opt)
    for k, v in snap[0].items():
        torch.testing.assert_close(params[k], v, rtol=0, atol=0)
    assert state.keys() == snap[1].keys()
    for i in state:
        for k, v in snap[1][i].items():
            torch.testing.assert_close(state[i][k], v, rtol=0, atol=0)
    assert passes == snap[3]
    assert (acc is None) == (snap[2] is None)
    for a, b in zip(acc or (), snap[2] or ()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# -- state objects -----------------------------------------------------------

def test_object_state_save_restore(world1):
    state = TE.ObjectState(epoch=1, batch=10)
    state.epoch = 5
    state.batch = 99
    state.restore()
    assert state.epoch == 1 and state.batch == 10
    state.epoch = 7
    state.save()
    state.epoch = 0
    state.restore()
    assert state.epoch == 7


def test_torch_state_model_optimizer_and_objects(world1):
    model, opt = _model_and_adam()
    _train(model, opt, 3)  # mid-cycle: one pass accumulated
    params = list(model.parameters())
    state = TE.TorchState(model, opt, w=torch.ones(4), epoch=0)
    committed = _snapshot(model, opt)
    _train(model, opt, 2)
    state.w.mul_(3)
    state.epoch = 2
    state.restore()  # back to the construction-time commit
    _assert_snapshot(model, opt, committed)
    torch.testing.assert_close(state.w, torch.ones(4))
    assert state.epoch == 0
    # In place: the optimizers still step the model's parameters.
    assert list(model.parameters()) == params
    assert all(a is b for a, b in zip(opt._params, params))
    assert all(a is b for a, b in zip(opt.param_groups[0]["params"], params))
    _train(model, opt, 1)
    state.w.mul_(5)
    state.epoch = 3
    state.commit()
    committed = _snapshot(model, opt)
    _train(model, opt, 3)
    state.w.mul_(100)
    state.restore()
    _assert_snapshot(model, opt, committed)
    torch.testing.assert_close(state.w, 5 * torch.ones(4))
    assert state.epoch == 3
    state.sync()  # a world of one: rank 0's values, unchanged
    _assert_snapshot(model, opt, committed)
    # The commit is a copy: training after a restore leaves it alone.
    _train(model, opt, 2)
    state.restore()
    _assert_snapshot(model, opt, committed)


def test_torch_state_matches_jax_tpu_state_on_the_same_values(world1, hvd8):
    """The JAX package's TpuState and the port's TorchState through one
    script of commits and restores hold the same numbers."""
    import jax.numpy as jnp
    from horovod_tpu import elastic as E
    js = E.TpuState(params={"w": jnp.ones((4,), jnp.float32)}, epoch=0)
    ts = TE.TorchState(w=torch.ones(4), epoch=0)
    for k, (mul, commit) in enumerate([(3, False), (5, True), (100, False),
                                       (2, True), (7, False)]):
        js.params = {"w": js.params["w"] * mul}
        ts.w.mul_(mul)
        js.epoch = ts.epoch = k
        if commit:
            js.commit()
            ts.commit()
        else:
            js.restore()
            ts.restore()
        np.testing.assert_array_equal(np.asarray(js.params["w"]),
                                      ts.w.numpy())
        assert js.epoch == ts.epoch


def test_state_reset_callbacks(world1):
    calls = []
    state = TE.ObjectState(x=1)
    state.register_reset_callbacks([lambda: calls.append("a"),
                                    lambda: calls.append("b")])
    state.on_reset()
    assert calls == ["a", "b"]


def test_check_host_updates_raises_as_jax(world1, hvd8):
    from horovod_tpu import elastic as E
    from horovod_tpu.exceptions import HostsUpdatedInterrupt as JaxHUI
    for cls, exc in ((E.ObjectState, JaxHUI),
                     (TE.ObjectState, HostsUpdatedInterrupt)):
        state = cls(x=1)
        state._host_messages = []
        state.on_hosts_updated({"h1": 2}, 1)
        with pytest.raises(exc) as ei:
            state.commit()
        assert not ei.value.skip_sync  # removal requires sync
        state.on_hosts_updated({"h1": 2, "h2": 2}, 2)
        with pytest.raises(exc) as ei:
            state.check_host_updates()
        assert ei.value.skip_sync  # pure scale-up
        state.check_host_updates()  # drained: nothing pending


# -- retry loop (common/elastic.py:151) ---------------------------------------

SCRIPT = ("internal", "hosts_skip", "hosts_sync", "internal", "internal",
          "done")


def _scripted(run, State, errors):
    events = []

    class FakeState(State):
        def __init__(self):
            super().__init__()

        def save(self):
            events.append("save")

        def restore(self):
            events.append("restore")

        def sync(self):
            events.append("sync")

        def reset(self):
            events.append("reset")

    attempts = []

    @run
    def train(st):
        step = SCRIPT[len(attempts)]
        attempts.append(step)
        events.append(f"train:{step}")
        if step == "internal":
            raise errors[0]("collective failed")
        if step == "hosts_skip":
            raise errors[1](skip_sync=True)
        if step == "hosts_sync":
            raise errors[1](skip_sync=False)
        return "finished"

    assert train(FakeState()) == "finished"
    return events


def test_retry_loop_events_match_jax(world1, hvd8):
    from horovod_tpu import elastic as E
    from horovod_tpu import exceptions as JX
    jax_events = _scripted(E.run, E.State, (JX.HorovodInternalError,
                                            JX.HostsUpdatedInterrupt))
    port_events = _scripted(TE.run, TE.State, (HorovodInternalError,
                                               HostsUpdatedInterrupt))
    assert port_events == jax_events
    assert port_events.count("sync") == 5  # the skip_sync reset skips one
    assert thvd.is_initialized() and thvd.size() == 1


def test_retry_loop_gives_up_without_progress(world1):
    class Never(TE.State):
        def save(self):
            pass

        def restore(self):
            pass

        def sync(self):
            pass

    @TE.run
    def train(st):
        raise HorovodInternalError("deterministic failure")

    with pytest.raises(HorovodInternalError):
        train(Never())


def test_coordinator_port_for_matches_jax():
    from horovod_tpu.elastic import coordinator_port_for as jax_port
    for base, w, c in [(29400, 0, 0), (29400, 1, 0), (29400, 3, 2),
                       (40000, 200, 15), (12345, 125, 1)]:
        assert TE.coordinator_port_for(base, w, c) == jax_port(base, w, c)


# -- ElasticSampler ------------------------------------------------------------

@pytest.mark.parametrize("n,seed,shuffle", [(20, 3, True), (30, 7, True),
                                            (17, 0, False), (101, 11, True)])
def test_elastic_sampler_indices_match_jax(n, seed, shuffle):
    from horovod_tpu.elastic import ElasticSampler as JS
    from horovod_tpu_torch.elastic import ElasticSampler as TS
    for size in (1, 2, 3):
        js = [JS(n, shuffle=shuffle, seed=seed) for _ in range(size)]
        ts = [TS(n, shuffle=shuffle, seed=seed) for _ in range(size)]
        for r in range(size):
            js[r].reset(rank=r, size=size)
            ts[r].reset(rank=r, size=size)
        for epoch in range(3):
            for r in range(size):
                assert ts[r].indices == js[r].indices
                assert len(ts[r]) == len(js[r])
                for b in range(2):
                    assert ts[r].get_indices(b, 2) == \
                        js[r].get_indices(b, 2)
                    ts[r].record_batch(b, 2)
                    js[r].record_batch(b, 2)
                assert ts[r].state_dict() == js[r].state_dict()
            # A mid-epoch reshape to another world size.
            new = size % 3 + 1
            for r in range(new):
                a, b = JS(n, shuffle=shuffle, seed=seed), \
                    TS(n, shuffle=shuffle, seed=seed)
                a.load_state_dict(js[0].state_dict())
                b.load_state_dict(ts[0].state_dict())
                a.reset(rank=r, size=new)
                b.reset(rank=r, size=new)
                assert b.indices == a.indices
                assert list(iter(b)) == list(iter(a))
            for r in range(size):
                js[r].set_epoch(epoch + 1)
                ts[r].set_epoch(epoch + 1)
                js[r].reset(rank=r, size=size)
                ts[r].reset(rank=r, size=size)


def test_torch_state_commits_a_sampler(world1):
    sampler = TE.ElasticSampler(40, seed=2)
    state = TE.TorchState(sampler=sampler, batch=0)
    sampler.record_batch(0, 4)
    state.commit()
    want = TE.ElasticSampler(40, seed=2)
    want.load_state_dict(sampler.state_dict())
    sampler.record_batch(1, 4)
    sampler.record_batch(2, 4)
    state.restore()  # load_state_dict: the commit's progress, re-sharded
    assert sampler.processed_num == 4 and sampler.indices == want.indices


# -- disk spill ----------------------------------------------------------------

def test_state_spill_roundtrip(tmp_path, world1):
    spill = str(tmp_path / "spill")
    model, opt = _model_and_adam()
    _train(model, opt, 3)
    state = TE.TorchState(model, opt, spill_dir=spill, w=torch.ones(3),
                          epoch=0)
    state.w.mul_(4)
    state.epoch = 7
    state.commit()
    committed = _snapshot(model, opt)
    # A FRESH incarnation (same worker identity, new process) adopts the
    # on-disk commit because it is ahead of its own seq 0.
    model2, opt2 = _model_and_adam()
    fresh = TE.TorchState(model2, opt2, spill_dir=spill, w=torch.zeros(3),
                          epoch=0)
    assert fresh.load_spill() is True
    assert fresh._commit_seq == 1
    _assert_snapshot(model2, opt2, committed)
    torch.testing.assert_close(fresh.w, 4 * torch.ones(3))
    assert fresh.epoch == 7
    # The committing state itself must NOT re-adopt its own spill.
    assert state.load_spill() is False
    state.clear_spill()
    later = TE.TorchState(spill_dir=spill, w=torch.zeros(3), epoch=0)
    assert later.load_spill() is False


def test_state_spill_torn_write_ignored(tmp_path, world1):
    spill = str(tmp_path / "spill")
    state = TE.TorchState(spill_dir=spill, w=torch.ones(2), step=3)
    state.commit()
    path = state._spill_path()
    assert not os.path.exists(path + ".tmp")  # published by rename
    with open(path, "wb") as f:
        f.write(b"\x80garbage")
    fresh = TE.TorchState(spill_dir=spill, w=torch.zeros(2), step=0)
    assert fresh.load_spill() is False
    assert fresh.step == 0
    torch.testing.assert_close(fresh.w, torch.zeros(2))


def test_state_spill_disabled_without_dir(world1, monkeypatch):
    monkeypatch.delenv("HVD_TPU_ELASTIC_SPILL_DIR", raising=False)
    state = TE.ObjectState(step=1)
    state.commit()  # no spill dir: must be a no-op, not an error
    assert state._spill_path() is None
    assert state.load_spill() is False


# -- discovery / blacklist ----------------------------------------------------

def test_discovery_script_parsing(tmp_path):
    script = tmp_path / "discover.sh"
    script.write_text("#!/bin/sh\necho h1:4\necho h2\n")
    script.chmod(0o755)
    d = TE.HostDiscoveryScript(str(script), slots=2)
    assert d.find_available_hosts_and_slots() == {"h1": 4, "h2": 2}


def test_blacklist_cooldown():
    from horovod_tpu_torch.elastic.discovery import Blacklist
    bl = Blacklist(cooldown_range=(0.05, 0.2))
    bl.blacklist("h1")
    assert bl.is_blacklisted("h1")
    time.sleep(0.3)
    assert not bl.is_blacklisted("h1")  # cooled down
    bl2 = Blacklist(None)
    bl2.blacklist("h2")
    time.sleep(0.05)
    assert bl2.is_blacklisted("h2")  # permanent without range


def test_host_manager_update_results():
    disc = TE.FixedHostDiscovery({"h1": 2})
    hm = TE.HostManager(disc)
    assert hm.update_available_hosts() == 2  # initial add
    assert hm.update_available_hosts() == 0  # no change
    disc._hosts["h2"] = 2
    assert hm.update_available_hosts() == 2  # scale-up
    del disc._hosts["h1"]
    assert hm.update_available_hosts() == 1  # removal


# -- driver (test_elastic_driver.py analog) -----------------------------------

class RecordingWorkers:
    """Simulated workers: run until told to exit with a given code."""

    def __init__(self):
        self.launched = []
        self.exit_codes = {}
        self.events = {}

    def fn(self, slot, terminate_event, world_version=0):
        key = (slot.hostname, slot.local_rank)
        self.launched.append((slot.rank, key))
        ev = threading.Event()
        self.events[key] = ev
        while not ev.is_set() and not terminate_event.is_set():
            time.sleep(0.01)
        return self.exit_codes.get(key, 0)

    def finish(self, host, slot, code=0):
        self.exit_codes[(host, slot)] = code
        self.events[(host, slot)].set()


def _make_driver(hosts, min_np, max_np, **kwargs):
    rendezvous = RendezvousServer()
    rendezvous.start()
    disc = TE.FixedHostDiscovery(hosts)
    driver = TE.ElasticDriver(rendezvous, disc, min_np, max_np, **kwargs)
    return driver, rendezvous, disc


def _wait(pred, seconds=5.0):
    deadline = time.time() + seconds
    while not pred() and time.time() < deadline:
        time.sleep(0.05)
    return pred()


def test_driver_initial_world_and_rendezvous():
    driver, rdv, disc = _make_driver({"hA": 2, "hB": 2}, 4, 4)
    workers = RecordingWorkers()
    driver.start(workers.fn)
    try:
        assert _wait(lambda: len(workers.launched) == 4)
        rec = json.loads(rdv.get("rendezvous", "rank/0"))
        assert rec["size"] == 4 and rec["version"] == 1
        assert rdv.get("rendezvous", "size") == b"4"
        for host in ("hA", "hB"):
            for s in (0, 1):
                workers.finish(host, s, 0)
        driver.join()
        assert driver.error_message is None
        states = driver.registry.last_rank_states()
        assert all(v == "SUCCESS" for v in states.values())
    finally:
        driver.stop()
        rdv.stop()


def test_driver_failure_blacklists_and_reassigns():
    driver, rdv, disc = _make_driver({"hA": 2, "hB": 2}, 2, 4,
                                     cooldown_range=None)
    workers = RecordingWorkers()
    driver.start(workers.fn)
    try:
        assert _wait(lambda: len(workers.launched) == 4)
        v1 = driver.world_version
        workers.finish("hB", 0, 1)
        assert _wait(lambda: driver.world_version > v1)
        assert driver.host_manager.blacklist.is_blacklisted("hB")
        assignments = driver.current_assignments()
        assert all(s.hostname == "hA" for s in assignments)
        assert len(assignments) == 2
        ranks = {(s.hostname, s.local_rank): s.rank for s in assignments}
        assert ("hA", 0) in ranks and ("hA", 1) in ranks
    finally:
        driver.stop()
        rdv.stop()


def test_driver_reset_limit_stops():
    driver, rdv, disc = _make_driver({"hA": 1, "hB": 1, "hC": 1}, 1, 3,
                                     reset_limit=1, cooldown_range=None)
    workers = RecordingWorkers()
    driver.start(workers.fn)
    try:
        assert _wait(lambda: len(workers.launched) == 3)
        workers.finish("hA", 0, 1)
        time.sleep(0.3)
        workers.finish("hB", 0, 1)
        assert _wait(lambda: driver.error_message is not None)
        assert "Reset limit" in driver.error_message
    finally:
        driver.stop()
        rdv.stop()


def _free_port():
    import socket as _socket
    s = _socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()  # nothing listens on it now
    return port


def test_refresh_world_fails_fast_when_rendezvous_dead(monkeypatch):
    from horovod_tpu_torch import config as _cfg
    from horovod_tpu_torch.exceptions import RendezvousUnreachableError
    monkeypatch.setenv(_cfg.HOROVOD_RENDEZVOUS_ADDR, "127.0.0.1")
    monkeypatch.setenv(_cfg.HOROVOD_RENDEZVOUS_PORT, str(_free_port()))
    monkeypatch.setenv(_cfg.HOROVOD_ELASTIC_TIMEOUT, "120")
    monkeypatch.setenv("HVD_TPU_RENDEZVOUS_DEAD_S", "1")
    t0 = time.time()
    with pytest.raises(RendezvousUnreachableError):
        TE._refresh_world_from_rendezvous()
    assert time.time() - t0 < 30


def test_init_barrier_fails_fast_when_rendezvous_dead(monkeypatch):
    from horovod_tpu_torch import config as _cfg
    from horovod_tpu_torch.exceptions import RendezvousUnreachableError
    monkeypatch.setenv(_cfg.HOROVOD_RENDEZVOUS_ADDR, "127.0.0.1")
    monkeypatch.setenv(_cfg.HOROVOD_RENDEZVOUS_PORT, str(_free_port()))
    monkeypatch.setenv(_cfg.HOROVOD_ELASTIC_TIMEOUT, "120")
    monkeypatch.setenv("HVD_TPU_RENDEZVOUS_DEAD_S", "1")
    monkeypatch.setenv("HOROVOD_ELASTIC", "1")
    monkeypatch.setenv(_cfg.HOROVOD_RANK, "0")
    monkeypatch.setenv(_cfg.HOROVOD_SIZE, "2")
    t0 = time.time()
    with pytest.raises(RendezvousUnreachableError):
        TE._await_world_at_init_barrier()
    assert time.time() - t0 < 30


def test_world_watch_sees_a_newer_world(monkeypatch):
    from horovod_tpu_torch import config as _cfg
    rdv = RendezvousServer()
    port = rdv.start()
    try:
        monkeypatch.setenv(_cfg.HOROVOD_RENDEZVOUS_ADDR, "127.0.0.1")
        monkeypatch.setenv(_cfg.HOROVOD_RENDEZVOUS_PORT, str(port))
        monkeypatch.setenv("HVD_TPU_WORLD_VERSION", "3")
        rdv.put("rendezvous", "world", json.dumps({"version": 3}).encode())
        watch = TE.WorldWatch(period=0.0)
        assert watch.check() is None
        rdv.put("rendezvous", "world", json.dumps({"version": 4}).encode())
        assert "moved past version 3" in watch.check()
    finally:
        rdv.stop()


RELEASE_SCRIPT = textwrap.dedent('''
    import gc, weakref
    import torch
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import elastic
    hvd.init(device="cpu")
    old = weakref.ref(dist.group.WORLD)
    model = torch.nn.Linear(4, 4)
    # A torch.optim optimizer imports torch._dynamo, which imports
    # torch.distributed.nn: its group=WORLD defaults bind at import.
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                   lr=0.1))
    model(torch.ones(2, 4)).sum().backward()
    opt.step()
    hvd.allgather_object(1)
    ps = hvd.add_process_set([0])
    hvd.allreduce(torch.ones(3), process_set=ps)
    elastic._reset()
    gc.collect()
    print("OLD GROUP FREED", old() is None, dist.group.WORLD is not None)
''')


def test_reset_frees_the_old_process_group():
    """After an in-place reset nothing keeps the old world's process group
    alive, so its connections close and a peer still waiting on it leaves
    at once.  A fresh interpreter, so that no earlier test has imported
    ``torch.distributed.nn`` yet."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", RELEASE_SCRIPT], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "OLD GROUP FREED True True" in proc.stdout, proc.stdout


def test_driver_waits_for_min_slots_timeout():
    driver, rdv, disc = _make_driver({}, 2, 2, timeout=0.5)
    with pytest.raises(RuntimeError, match="Timed out waiting"):
        driver.start(lambda s, e, v: 0)
    rdv.stop()


def test_driver_scale_up_bumps_version():
    driver, rdv, disc = _make_driver({"hA": 1}, 1, 2)
    workers = RecordingWorkers()
    driver.start(workers.fn)
    try:
        assert _wait(lambda: len(workers.launched) == 1)
        v1 = driver.world_version
        disc._hosts["hB"] = 1
        assert _wait(lambda: driver.world_version > v1)
        assert len(driver.current_assignments()) == 2
        upd = json.loads(rdv.get("discovery", "update"))
        assert upd["version"] >= v1 and upd["res"] == 2
    finally:
        driver.stop()
        rdv.stop()


def test_concurrent_failures_coalesce_to_one_reset():
    driver, rdv, disc = _make_driver({"hA": 2, "hB": 4}, 2, 6,
                                     reset_limit=1, cooldown_range=None)
    workers = RecordingWorkers()
    driver.start(workers.fn)
    try:
        assert _wait(lambda: len(workers.launched) == 6)
        for s in range(4):
            workers.finish("hB", s, 1)
        _wait(lambda: driver.registry.reset_count > 0)
        time.sleep(0.5)
        assert driver.registry.reset_count <= 2
        assert driver.error_message is None or \
            "Reset limit" not in (driver.error_message or "")
    finally:
        driver.stop()
        rdv.stop()


def test_host_removal_triggers_reactivation():
    driver, rdv, disc = _make_driver({"hA": 1, "hB": 1}, 1, 2,
                                     cooldown_range=None)
    workers = RecordingWorkers()
    driver.start(workers.fn)
    try:
        assert _wait(lambda: len(workers.launched) == 2)
        v1 = driver.world_version
        del disc._hosts["hB"]
        assert _wait(lambda: driver.world_version > v1, 6.0)
        assert all(s.hostname == "hA"
                   for s in driver.current_assignments())
    finally:
        driver.stop()
        rdv.stop()


def test_notification_seq_monotonic():
    driver, rdv, disc = _make_driver({"hA": 1}, 1, 1)
    workers = RecordingWorkers()
    driver.start(workers.fn)
    try:
        driver._notify_workers_host_changes(1)
        v1 = json.loads(rdv.get("discovery", "update"))["version"]
        driver._notify_workers_host_changes(1)
        v2 = json.loads(rdv.get("discovery", "update"))["version"]
        assert v2 > v1
    finally:
        driver.stop()
        rdv.stop()


KEPT_FLAGS = [
    ["--fusion-threshold-mb", "8"], ["--cache-capacity", "16"],
    ["--disable-cache"], ["--autotune", "--autotune-log-file", "t.csv"],
    ["--timeline-filename", "tl.json", "--timeline-mark-cycles"],
    ["--no-stall-check"], ["--stall-check-warning-time-seconds", "7",
                           "--stall-check-shutdown-time-seconds", "9"],
    ["--log-level", "DEBUG", "--log-hide-timestamp"]]


@pytest.mark.parametrize("flags", KEPT_FLAGS, ids=lambda f: f[0])
def test_launcher_flags_export_what_jax_exports(flags):
    """Each flag the port's launcher keeps sets the worker environment as
    the JAX package's launcher does."""
    from horovod_tpu.runner import launch as jax_launch
    from horovod_tpu_torch.runner import launch
    argv = flags + ["-np", "2", "python", "train.py"]
    mine = launch.env_from_args(launch.parse_args(argv))
    assert mine and mine == jax_launch.env_from_args(
        jax_launch.parse_args(argv))


@pytest.mark.parametrize("flags", [
    ["--cycle-time-ms", "5"], ["--hierarchical-allreduce"],
    ["--hierarchical-allgather"], ["--thread-affinity", "1"],
    ["--log-with-timestamp"]], ids=lambda f: f[0])
def test_launcher_rejects_flags_of_knobs_the_port_does_not_read(flags,
                                                                 capsys):
    from horovod_tpu_torch.runner import launch
    with pytest.raises(SystemExit) as e:
        launch.parse_args(flags + ["-np", "2", "python", "train.py"])
    assert e.value.code == 2
    assert flags[0] in capsys.readouterr().err


@pytest.mark.parametrize("flags", [
    ["--gloo"], ["--mpi"], ["--mpi-threads-disable"],
    ["--num-nccl-streams", "2"]], ids=lambda f: f[0])
def test_launcher_notes_the_flags_it_ignores(flags, capsys):
    from horovod_tpu_torch.runner import launch
    args = launch.parse_args(flags + ["-np", "2", "python", "train.py"])
    assert launch.env_from_args(args) == {}
    err = capsys.readouterr().err
    assert f"{flags[0]} is accepted for compatibility and" in err
    assert "ignored" in err


def test_store_base_port_lies_below_the_ephemeral_range(monkeypatch):
    """Every generation's store port (``coordinator_port_for``: base to
    base + 2000) lies outside the kernel's ephemeral ports, so no socket
    of the job can hold it when its rank 0 binds it; a remote coordinator
    keeps the pinned default."""
    from horovod_tpu_torch.runner import launch
    low, _ = launch._ephemeral_port_range()
    if low - 2000 <= 10000:
        pytest.skip(f"ephemeral ports start at {low}: no room below")
    for _ in range(8):
        monkeypatch.delenv("HVD_TPU_COORD_PORT", raising=False)
        launch.pick_coordinator_base_port(True)
        base = int(os.environ["HVD_TPU_COORD_PORT"])
        assert 10000 <= base and TE.coordinator_port_for(base, 124, 15) < low
    monkeypatch.delenv("HVD_TPU_COORD_PORT", raising=False)
    launch.pick_coordinator_base_port(False)
    assert "HVD_TPU_COORD_PORT" not in os.environ


def test_slot_env_matches_jax():
    from horovod_tpu.elastic.launch_support import slot_env as jax_env
    from horovod_tpu.runner.hosts import SlotInfo as JSlot
    from horovod_tpu_torch.elastic.launch_support import slot_env
    from horovod_tpu_torch.runner.hosts import SlotInfo

    class Drv:
        _update_seq = 4

    fields = dict(hostname="hA", rank=3, local_rank=1, cross_rank=1,
                  size=4, local_size=2, cross_size=2)
    mine = slot_env(SlotInfo(**fields), 5, "10.0.0.1", 7000, Drv(),
                    coord_base=29400)
    theirs = jax_env(JSlot(**fields), 5, "10.0.0.1", 7000, Drv(),
                     coord_base=29400)
    assert mine == theirs


# -- one elastic gloo world ----------------------------------------------------

WORKER = textwrap.dedent('''
    import os
    import sys
    import torch
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    state = hvd.elastic.TorchState(w=torch.zeros(2), batch=0)
    marker = sys.argv[1]
    crashed = {"done": False}
    seen = {}

    @hvd.elastic.run
    def train(state):
        seen.setdefault("first_batch", state.batch)
        while state.batch < 10:
            out = hvd.allreduce(torch.ones(2), op=hvd.Sum, name="g")
            assert abs(float(out[0]) - hvd.size()) < 1e-6
            state.w.add_(1.0)
            state.batch += 1
            if state.batch % 2 == 0:
                state.commit()
            if state.batch == 3 and not crashed["done"]:
                # Every rank: an in-place reset of the same world.
                crashed["done"] = True
                raise hvd.HorovodInternalError("simulated fault")
            if state.batch == 7 and hvd.rank() == 1 \\
                    and not os.path.exists(marker):
                open(marker, "w").close()
                os._exit(1)  # abrupt death: no exception, no shutdown
        return float(state.w[0])

    w = train(state)
    print(f"rank{hvd.rank()} SURVIVED size={hvd.size()} "
          f"batches={state.batch} w={w} first_batch={seen['first_batch']}",
          flush=True)
''')


def test_elastic_world_resets_in_place_and_survives_a_kill(tmp_path):
    disc = tmp_path / "disc.sh"
    disc.write_text("#!/bin/sh\necho localhost:2\n")
    disc.chmod(0o755)
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    events = tmp_path / "events.jsonl"
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["HVD_TPU_ELASTIC_SPILL_DIR"] = str(tmp_path / "spill")
    env["HVD_TPU_ELASTIC_EVENT_LOG"] = str(events)
    env.pop("HOROVOD_GLOO_TIMEOUT_SECONDS", None)  # the 300 s default
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
         "--min-np", "2", "--max-np", "2",
         "--host-discovery-script", str(disc),
         "--blacklist-cooldown-range", "1", "3",
         sys.executable, str(worker), str(tmp_path / "crashed.marker")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=90)
    took = time.time() - t0
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-3000:]
    done = re.findall(r"rank(\d) SURVIVED size=(\d) batches=(\d+) "
                      r"w=([0-9.]+) first_batch=(\d+)", proc.stdout)
    assert len(done) == 2, proc.stdout[-4000:]
    for _, size, batches, w, _ in done:
        assert (int(size), int(batches), float(w)) == (2, 10, 10.0)
    first = sorted(int(fb) for *_, fb in done)
    # The survivor started at 0; the respawned rank 1 at its last spill.
    assert first == [0, 6], done
    recs = [json.loads(line) for line in events.read_text().splitlines()]
    failures = [r for r in recs if r["event"] == "failure"]
    # batch 3 on both ranks, then the survivor of the kill.
    assert len(failures) == 3, recs
    assert took < 90
