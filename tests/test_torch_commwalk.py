"""hvdshard's communication walk over a ``make_fx`` graph
(``analysis/shardplan.py``) against the JAX walk's expected values.

The JAX walk (``horovod_tpu/analysis/shardplan.py``) reads
``jax.core.Var``, which this jax no longer has, so it cannot run here:
each test writes the program of a case of ``tests/test_shardplan.py`` in
torch (``hvd.allreduce`` over the process set of mesh axes for
``lax.psum``) and holds the port to the bytes that test writes down.  The
port's per-axis entries carry no ICI/DCN fabric (no configuration of the
port crosses hosts); everything else is JAX's.  HVD402 reads
``shard_step``'s specs, the port's stand-in for pjit shardings.
"""

import json

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.analysis import graph_check, shardplan
from horovod_tpu_torch.parallel import P, axes_process_set
from horovod_tpu_torch.timeline import Timeline

F32 = 4


def _psum(x, axes):
    return hvd.allreduce(x, op=hvd.Sum, process_set=axes_process_set(axes))


def _ones(n):
    return torch.as_tensor(np.ones(n, np.float32))


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("HVD_COMM_BUDGET_BYTES", raising=False)


def test_census_bytes_two_axis_hand_computed():
    """:58 — 64 payload bytes over 'local' (group 4) = 256 wire bytes; 32
    over both axes (group 8) = 256; each axis a collective names is
    charged its wire bytes."""
    def step(x, y):
        return _psum(x, ["local"]), _psum(y, ["cross", "local"])

    r = shardplan.measure_step_fn_comm(
        step, (_ones(16), _ones(8)), axis_env=[("cross", 2), ("local", 4)],
        label="two_axis")
    assert r.by_primitive["allreduce"] == {
        "count": 2, "bytes": 16 * F32 + 8 * F32, "wire_bytes": 256 + 256}
    assert r.total_wire_bytes == 512
    assert r.by_axis["local"] == {"size": 4, "count": 2, "wire_bytes": 512}
    assert r.by_axis["cross"] == {"size": 2, "count": 1, "wire_bytes": 256}
    assert not r.findings


def test_loop_census_multiplied():
    """:119 — unlike the memory census, wire bytes multiply by the trip
    count (the loop unrolls in the trace)."""
    def step(x):
        for _ in range(5):
            x = _psum(x, ["hvd"])
        return x

    r = shardplan.measure_step_fn_comm(step, (_ones(16),),
                                       axis_env=[("hvd", 8)])
    assert r.by_primitive["allreduce"] == {"count": 5, "bytes": 5 * 64,
                                           "wire_bytes": 5 * 64 * 8}
    assert not r.findings


def test_comm_budget_overshoot_fires(monkeypatch):
    """:229 — wire = 512 payload x group 8 = 4096 > 1000; the knob is
    read when no budget is passed."""
    def step(x):
        return _psum(x, ["hvd"])

    r = shardplan.measure_step_fn_comm(step, (_ones(128),),
                                       axis_env=[("hvd", 8)],
                                       budget_bytes=1000, label="budget")
    assert [f.rule for f in r.findings] == ["HVD401"]
    assert r.headroom_bytes == 1000 - 4096
    monkeypatch.setenv("HVD_COMM_BUDGET_BYTES", "4095")
    r = shardplan.measure_step_fn_comm(step, (_ones(128),),
                                       axis_env=[("hvd", 8)])
    assert [f.rule for f in r.findings] == ["HVD401"]
    assert r.headroom_bytes == -1


@pytest.mark.parametrize("replicated,fires", [
    ((512, 512), True),    # :279, 1 MiB, 8 divides 512
    ((512,), False),       # :297, a 2 KiB bias
])
def test_replicated_operand(replicated, fires):
    """A ``P()`` argument next to a peer sharded over 'hvd' (size 8):
    the 1 MiB weight fires HVD402 naming the axis; the small bias is
    the normal data-parallel layout and stays clean."""
    leaves = [(P("hvd", None), (512, 512), "float32", 512 * 512 * F32),
              (P(), replicated, "float32",
               int(np.prod(replicated)) * F32)]
    gm = graph_check.trace(lambda x: x * 2.0, (_ones(4),))
    r = shardplan.measure_graph_comm(gm, label="replicated",
                                     axis_sizes={"hvd": 8},
                                     spec_leaves=leaves)
    fired = [f for f in r.findings if f.rule == "HVD402"]
    assert len(fired) == int(fires), [f.format() for f in r.findings]
    if fires:
        assert "'hvd'" in fired[0].message


def test_undeclared_axis_collective_fires():
    """:317 — the mesh declares only 'hvd'; a collective over 'rogue'
    names a process set that does not exist there."""
    gm = graph_check.trace(lambda x: _psum(x, ["rogue"]), (_ones(4),),
                           axis_env=[("rogue", 2)])
    r = shardplan.measure_graph_comm(gm, label="rogue",
                                     axis_sizes={"hvd": 8})
    fired = [f for f in r.findings if f.rule == "HVD403"]
    assert len(fired) == 1 and "'rogue'" in fired[0].message


def test_dead_mesh_axis_fires_size_one_exempt():
    """:350 — 'dead' (size 4) is never named by a collective or a spec:
    HVD404; a size-1 axis is free."""
    gm = graph_check.trace(lambda x: _psum(x, ["hvd"]), (_ones(4),),
                           axis_env=[("hvd", 8)])
    r = shardplan.measure_graph_comm(
        gm, label="dead", axis_sizes={"hvd": 8, "dead": 4, "solo": 1})
    fired = [f for f in r.findings if f.rule == "HVD404"]
    assert len(fired) == 1 and "'dead'" in fired[0].message
    assert r.axes_used == {"hvd"}


def test_comm_census_lands_on_timeline(tmp_path):
    """:464 — one totals counter, one per collective, one per axis."""
    r = shardplan.measure_step_fn_comm(lambda x: _psum(x, ["hvd"]),
                                       (_ones(128),), axis_env=[("hvd", 8)],
                                       label="comm_step")
    path = str(tmp_path / "comm_timeline.json")
    tl = Timeline(path, rank=0)
    tl.comm_census("comm_step", r.to_dict())
    tl.close()
    with open(path) as fh:
        events = json.load(fh)
    names = [e.get("name", "") for e in events]
    assert "COMM_CENSUS/comm_step" in names
    assert "COMM_CENSUS/comm_step/allreduce" in names
    assert "COMM_CENSUS/comm_step/axis/hvd[ici]" in names
    totals = next(e for e in events
                  if e.get("name") == "COMM_CENSUS/comm_step")
    assert totals["ph"] == "C"
    assert totals["args"]["total_wire_bytes"] == r.total_wire_bytes == 4096
