"""The port's Ray integration (``horovod_tpu_torch/ray.py``,
``ray_integration.py``, ``ray_elastic.py``) against the JAX package's.

ray is not installed here (nor on the card's machine), so the tests stub
it as ``tests/test_ray.py`` does:

* ``RayHostDiscovery`` over JAX's stub ``ray`` (``nodes()`` only) gives
  JAX's slots for CPU, GPU and TPU workers;
* ``ElasticRayExecutor`` on an injected spawn layer (a static world, a
  scale-down that decommissions a slot) spawns the envs JAX's spawns for
  the same discovery sequence, apart from ports;
* ``RayExecutor`` and ``ElasticRayExecutor``'s own actor handle against
  a stub whose actors run in this process, each in its own environment:
  ``start`` / ``run`` / ``run_remote`` / ``execute`` / ``shutdown`` give
  JAX's results, actor options and envs, apart from ports;
* without ray, both modules raise JAX's error.
"""

import os
import sys
import threading
import time
import types

import pytest

from test_ray import FakeHandle, _fake_ray_module

# Environment entries that differ between two runs by their ports.
PORTS = ("HOROVOD_GLOO_RENDEZVOUS_PORT", "HVD_TPU_COORDINATOR",
         "HVD_TPU_COORD_BASE")


def _strip(env):
    return {k: v for k, v in env.items() if k not in PORTS}


def _modules(pkg):
    if pkg == "jax":
        from horovod_tpu import ray_elastic, ray_integration
        from horovod_tpu.elastic import driver
    else:
        from horovod_tpu_torch import ray_elastic, ray_integration
        from horovod_tpu_torch.elastic import driver
    return ray_elastic, ray_integration, driver


@pytest.mark.parametrize("kw", [
    dict(cpus_per_worker=2), dict(cpus_per_worker=3),
    dict(use_gpu=True, gpus_per_worker=2), dict(use_gpu=True),
    dict(tpu_per_worker=4), dict(use_gpu=True, gpus_per_worker=8)],
    ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_ray_host_discovery_matches_jax(monkeypatch, kw):
    nodes = [
        {"Alive": True, "NodeManagerHostname": "n1",
         "Resources": {"CPU": 8.0, "GPU": 4.0, "TPU": 8.0}},
        {"Alive": True, "NodeManagerHostname": "n2",
         "Resources": {"CPU": 3.0}},
        {"Alive": True, "NodeManagerAddress": "10.0.0.7",
         "Resources": {"CPU": 4.0, "GPU": 2.0}},
        {"Alive": True, "NodeManagerHostname": "n1",
         "Resources": {"CPU": 2.0, "GPU": 1.0}},
        {"Alive": False, "NodeManagerHostname": "dead",
         "Resources": {"CPU": 64.0, "GPU": 8.0}},
        {"Alive": True, "Resources": {"CPU": 16.0}},
    ]
    monkeypatch.setitem(sys.modules, "ray", _fake_ray_module(nodes))
    got = _modules("port")[0].RayHostDiscovery(**kw) \
        .find_available_hosts_and_slots()
    want = _modules("jax")[0].RayHostDiscovery(**kw) \
        .find_available_hosts_and_slots()
    assert got == want


class _Discovery:
    """A host list the test changes under the driver."""

    def __init__(self, hosts):
        self.hosts, self.lock = dict(hosts), threading.Lock()

    def find_available_hosts_and_slots(self):
        with self.lock:
            return dict(self.hosts)

    def set(self, hosts):
        with self.lock:
            self.hosts = dict(hosts)


def _executor(pkg, disc, min_w, max_w, finish, killed, spawned):
    holder = {}

    def spawn(entry, args, kwargs, env, slot):
        spawned.append(env)
        return FakeHandle(entry, env, lambda: holder["ex"]._driver, finish,
                          killed)

    ex = _modules(pkg)[0].ElasticRayExecutor(
        min_workers=min_w, max_workers=max_w, override_discovery=disc,
        spawn_fn=spawn, elastic_timeout=30)
    holder["ex"] = ex
    return ex


def test_elastic_ray_executor_static_world_matches_jax():
    envs = {}
    for pkg in ("port", "jax"):
        finish, killed, spawned = threading.Event(), [], []
        ex = _executor(pkg, _Discovery({"h1": 2}), 2, 2, finish, killed,
                       spawned)
        finish.set()
        try:
            assert ex.run(lambda: "ok") == ["ok", "ok"]
        finally:
            ex.shutdown()
        assert killed == []
        envs[pkg] = sorted((_strip(e) for e in spawned),
                           key=lambda e: e["HOROVOD_RANK"])
    assert envs["port"] == envs["jax"]
    assert [e["HOROVOD_RANK"] for e in envs["port"]] == ["0", "1"]
    for e in envs["port"]:
        assert e["HOROVOD_ELASTIC"] == "1" and e["HOROVOD_SIZE"] == "2"


def _scale_down(pkg, monkeypatch):
    """Autoscaler shrink (h1: 3 -> 2) on ``pkg``'s executor; the spawned
    envs by rank, without ports."""
    monkeypatch.setattr(_modules(pkg)[2], "DECOMMISSION_GRACE_S", 0.3)
    disc = _Discovery({"h1": 3})
    finish, killed, spawned = threading.Event(), [], []
    ex = _executor(pkg, disc, 2, 3, finish, killed, spawned)
    box = {}
    t = threading.Thread(target=lambda: box.update(out=ex.run(lambda: "ok")),
                         daemon=True)
    t.start()
    deadline = time.time() + 30
    while len(spawned) < 3 and time.time() < deadline:
        time.sleep(0.05)
    assert len(spawned) == 3
    disc.set({"h1": 2})
    while not killed and time.time() < deadline:
        time.sleep(0.05)
    assert killed == [2], killed
    finish.set()
    t.join(timeout=30)
    assert not t.is_alive()
    ex.shutdown()
    assert box["out"] == ["ok", "ok"]
    return sorted((_strip(e) for e in spawned),
                  key=lambda e: e["HOROVOD_RANK"])


def test_elastic_ray_executor_scale_down_decommissions(monkeypatch):
    """The slot-2 worker is killed and not recorded as a failure; the
    survivors' results form the final world (elastic_v2 shrink
    semantics).  Both packages spawn the same envs."""
    got = _scale_down("port", monkeypatch)
    assert got == _scale_down("jax", monkeypatch)
    assert [e["HOROVOD_RANK"] for e in got] == ["0", "1", "2"]


# ---------------------------------------------------------------------------
# A ray whose actors run in this process
# ---------------------------------------------------------------------------

class _Ref:
    """An object ref: the call's value, or the exception it raised."""

    def __init__(self, fn, *args, **kwargs):
        try:
            self.value, self.error = fn(*args, **kwargs), None
        except Exception as e:  # re-raised by ray.get
            self.value, self.error = None, e


# One actor call at a time swaps os.environ (the elastic executor calls
# from one driver thread per slot).
_ENV_LOCK = threading.Lock()


class _Actor:
    """One actor: its methods run with the actor's own os.environ."""

    def __init__(self, cls, args, kwargs):
        self._env = dict(os.environ)
        self._inst = self._in_env(cls, *args, **kwargs)

    def _in_env(self, fn, *args, **kwargs):
        with _ENV_LOCK:
            return self._swapped(fn, *args, **kwargs)

    def _swapped(self, fn, *args, **kwargs):
        saved = dict(os.environ)
        os.environ.clear()
        os.environ.update(self._env)
        try:
            return fn(*args, **kwargs)
        finally:
            self._env = dict(os.environ)
            os.environ.clear()
            os.environ.update(saved)

    def __getattr__(self, name):
        method = getattr(self._inst, name)
        return types.SimpleNamespace(
            remote=lambda *a, **kw: _Ref(self._in_env, method, *a, **kw))


def _stub_ray(log, nodes=()):
    ray = types.ModuleType("ray")

    class ActorClass:
        def __init__(self, cls, opts):
            self.cls, self.opts = cls, opts

        def options(self, **opts):
            return ActorClass(self.cls, dict(self.opts, **opts))

        def remote(self, *args, **kwargs):
            actor = _Actor(self.cls, args, kwargs)
            log["actors"].append({"opts": self.opts, "args": args,
                                  "actor": actor})
            return actor

    def remote(**opts):
        return lambda cls: ActorClass(cls, opts)

    def get(refs):
        out = []
        for r in (refs if isinstance(refs, list) else [refs]):
            if r.error is not None:
                raise r.error
            out.append(r.value)
        return out if isinstance(refs, list) else out[0]

    ray.remote = remote
    ray.get = get
    ray.wait = lambda refs, timeout=None: (list(refs), [])
    ray.kill = lambda actor: log["killed"].append(actor)
    ray.nodes = lambda: list(nodes)
    util = types.ModuleType("ray.util")
    util.get_current_placement_group = lambda: None
    strategies = types.ModuleType("ray.util.scheduling_strategies")

    class NodeAffinitySchedulingStrategy:
        def __init__(self, node_id, soft):
            self.node_id, self.soft = node_id, soft

        def __eq__(self, other):
            return vars(self) == vars(other)

    strategies.NodeAffinitySchedulingStrategy = NodeAffinitySchedulingStrategy
    util.scheduling_strategies = strategies
    ray.util = util
    return {"ray": ray, "ray.util": util,
            "ray.util.scheduling_strategies": strategies}


class _Model:
    def __init__(self, scale):
        self.scale = scale

    def rank_times_scale(self):
        return int(os.environ["HOROVOD_RANK"]) * self.scale


def _rank_tag(tag):
    return f"{tag}-{os.environ['HOROVOD_RANK']}/{os.environ['HOROVOD_SIZE']}"


def test_ray_executor_against_a_stub_matches_jax(monkeypatch):
    before = dict(os.environ)
    seen = {}
    for pkg in ("port", "jax"):
        log = {"actors": [], "killed": []}
        for name, mod in _stub_ray(log).items():
            monkeypatch.setitem(sys.modules, name, mod)
        ex = _modules(pkg)[1].RayExecutor(num_workers=3, cpus_per_worker=2,
                                          use_gpu=True)
        ex.start(executable_cls=_Model, executable_args=[10],
                 extra_env_vars={"EXTRA": "1"})
        out = {"run": ex.run(_rank_tag, args=("r",)),
               "run_remote": [r.value for r in
                              ex.run_remote(_rank_tag, args=("q",))],
               "execute": ex.execute(lambda m: m.rank_times_scale())}
        actors = list(log["actors"])
        ex.shutdown()
        assert log["killed"] == [a["actor"] for a in actors]
        assert ex._rendezvous is None and ex._workers == []
        seen[pkg] = (out, [(a["opts"], _strip(a["args"][0]))
                           for a in actors])
    assert seen["port"] == seen["jax"]
    out, actors = seen["port"]
    assert out["run"] == ["r-0/3", "r-1/3", "r-2/3"]
    assert out["execute"] == [0, 10, 20]
    assert [a[0] for a in actors] == [{"num_cpus": 2, "num_gpus": 1}] * 3
    assert [a[1]["HOROVOD_RANK"] for a in actors] == ["0", "1", "2"]
    assert all(a[1]["EXTRA"] == "1" for a in actors)
    assert dict(os.environ) == before


def test_elastic_ray_executor_actor_handle_matches_jax(monkeypatch):
    """The default spawn layer (one actor per slot, soft affinity to the
    slot's node) over the in-process stub."""
    nodes = [{"Alive": True, "NodeManagerHostname": "h1", "NodeID": "n-1",
              "Resources": {"CPU": 2.0}}]
    before = dict(os.environ)
    seen = {}
    for pkg in ("port", "jax"):
        log = {"actors": [], "killed": []}
        for name, mod in _stub_ray(log, nodes).items():
            monkeypatch.setitem(sys.modules, name, mod)
        ex = _modules(pkg)[0].ElasticRayExecutor(min_workers=2,
                                                 max_workers=2,
                                                 elastic_timeout=30)
        try:
            out = ex.run(_rank_tag, args=("e",))
        finally:
            ex.shutdown()
        opts = [a["opts"] for a in log["actors"]]
        seen[pkg] = (out, opts)
    assert seen["port"] == seen["jax"]
    out, opts = seen["port"]
    assert out == ["e-0/2", "e-1/2"]
    assert all(o["num_cpus"] == 1 and o["scheduling_strategy"].node_id
               == "n-1" for o in opts)
    assert dict(os.environ) == before


@pytest.mark.parametrize("which", ["ray_integration", "ray_elastic"])
def test_missing_ray_raises_jax_error(monkeypatch, which):
    monkeypatch.setitem(sys.modules, "ray", None)
    errors = []
    for pkg in ("port", "jax"):
        re_, ri, _ = _modules(pkg)
        with pytest.raises(ImportError) as e:
            if which == "ray_integration":
                ri.RayExecutor(num_workers=1).start()
            else:
                re_.RayHostDiscovery().find_available_hosts_and_slots()
        errors.append(str(e.value))
    assert errors[0] == errors[1].replace("horovod_tpu.",
                                          "horovod_tpu_torch.")
    assert "requires the 'ray' package" in errors[0]


def test_ray_namespace_exports():
    import horovod_tpu_torch.ray as tray
    from horovod_tpu_torch.ray_elastic import (ElasticRayExecutor,
                                               RayHostDiscovery)
    from horovod_tpu_torch.ray_integration import RayExecutor
    assert (tray.RayExecutor, tray.ElasticRayExecutor,
            tray.RayHostDiscovery) == (RayExecutor, ElasticRayExecutor,
                                       RayHostDiscovery)
