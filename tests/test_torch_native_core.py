"""The port's native core (``horovod_tpu_torch/csrc/hvd_core.cc``, built by
``csrc/native.py``) against the JAX package's (``horovod_tpu.csrc``), case
by case on the same inputs: the response cache, the message table's
verdicts (identical text), the pending order, the fusion planner, the
tensor queue and the stall inspector.  The behaviour list is
``tests/test_native_core.py``."""

import os

import pytest

from horovod_tpu import csrc as jc
from horovod_tpu_torch.csrc import native as tc


def test_port_builds_its_own_library_from_its_own_source():
    path = tc.library_path()
    here = os.path.dirname(os.path.abspath(tc.__file__))
    assert path.startswith(os.path.join(here, "_build") + os.sep)
    assert tc.lib()._name == path and os.path.exists(path)
    assert tc.lib().hvd_core_abi_version() == tc.ABI == jc._ABI
    assert tc.SOURCE == os.path.join(here, "hvd_core.cc")


def _cache_trace(core):
    c = core.NativeResponseCache(8)
    out = [c.lookup("t", "float32", [4, 4]), c.put("t", "float32", [4, 4]),
           c.lookup("t", "float32", [4, 4]),
           c.lookup("t", "float32", [8, 4]),
           c.lookup("t", "float32", [4, 4], prescale=0.5),
           c.lookup("t", "float32", [4, 4], op=3),
           c.lookup("t", "float32", [4, 4], ps_id=7),
           c.invalidate("t"), c.invalidate("t"),
           c.lookup("t", "float32", [4, 4])]
    c2 = core.NativeResponseCache(2)
    out += [c2.put("a", "float32", [1]), c2.put("b", "float32", [1]),
            c2.lookup("a", "float32", [1]), c2.put("c", "float32", [1]),
            c2.lookup("b", "float32", [1]), c2.lookup("a", "float32", [1]),
            len(c2), c2.put("a", "float16", [1])]
    c2.clear()
    out += [len(c2), c2.put("z", "float32", [2])]
    c0 = core.NativeResponseCache(0)
    out += [c0.put("t", "float32", [1]), c0.lookup("t", "float32", [1])]
    return out


def test_cache_states_lru_and_zero_capacity_match_jax():
    got = _cache_trace(tc)
    assert got == _cache_trace(jc)
    # miss, put bit 0, hit, invalid on shape / scale / op / set, ...
    assert got[:10] == [tc.CACHE_MISS, 0, tc.CACHE_HIT] + \
        [tc.CACHE_INVALID] * 4 + [True, False, tc.CACHE_MISS]
    assert got[-2:] == [-1, tc.CACHE_MISS]


VERDICT_CASES = {
    "ready": [("float32", [4], 1, 0), ("float32", [4], 1, 1)],
    "shape": [("float32", [4], 1, 0), ("float32", [5], 1, 1)],
    "dtype": [("float32", [4], 1, 0), ("float16", [4], 1, 1)],
    "op": [("float32", [4], 1, 0), ("float32", [4], 0, 1)],
    "ragged_ok": [("float32", [4, 7], 1000, 0), ("float32", [9, 7], 1000, 1)],
    "ragged_trailing": [("float32", [4, 7], 1000, 0),
                        ("float32", [9, 8], 1000, 1)],
    "ragged_ndim": [("float32", [4, 7], 1001, 0), ("float32", [4], 1001, 1)],
}


@pytest.mark.parametrize("case", sorted(VERDICT_CASES))
def test_msgtable_verdicts_match_jax_text(case):
    def verdict(core, scale=1.0, ps=(0, 0)):
        mt = core.NativeMessageTable(2)
        res = [mt.increment("g", dt, shape, op, rank=r,
                            postscale=scale if r else 1.0, ps_id=ps[r])
               for dt, shape, op, r in VERDICT_CASES[case]]
        return res, mt.validate("g"), mt.reported_ranks("g")

    for kw in ({}, {"scale": 2.0}, {"ps": (0, 9)}):
        got, want = verdict(tc, **kw), verdict(jc, **kw)
        assert got == want
        assert got[0] == [0, 1] and got[2] == [0, 1]
    if case in ("ready", "ragged_ok"):
        assert verdict(tc)[1] == ""
    else:
        assert verdict(tc)[1].startswith("Mismatched")
    assert "prescale/postscale" in verdict(tc, scale=2.0)[1] or \
        case.endswith(("shape", "dtype", "op", "trailing", "ndim"))
    assert "used set 9" in verdict(tc, ps=(0, 9))[1] or \
        case in ("dtype", "op")


def test_msgtable_duplicate_pending_order_and_erase_match_jax():
    def trace(core):
        mt = core.NativeMessageTable(3)
        out = [mt.increment("b", "float32", [1], 1, rank=0),
               mt.increment("a", "float32", [1], 1, rank=2),
               mt.increment("b", "float32", [1], 1, rank=0),
               mt.increment("b", "float32", [1], 1, rank=1),
               mt.pending(), mt.increment("b", "float32", [1], 1, rank=2),
               mt.validate("b"), mt.validate("nope")]
        mt.erase("b")
        out.append(mt.pending())
        mt.set_size(1)
        out.append(mt.increment("c", "int32", [2], 0, rank=0))
        return out

    got = trace(tc)
    assert got == trace(jc)
    assert got[:6] == [0, 0, -1, 0, ["b", "a"], 1]
    assert got[8:] == [["a"], 1]


FUSION_CASES = [
    ([("g0", "float32", 100, 1, 0), ("g1", "float16", 80, 1, 0),
      ("g2", "float32", 120, 1, 0), ("g3", "float32", 50, 1, 0),
      ("g4", "float16", 60, 1, 0)], 256, [[0, 2], [1, 4], [3]]),
    ([("a", "float32", 10, 1, 0), ("b", "float32", 10, 2, 0),
      ("c", "float32", 10, 1, 5), ("d", "float32", 10, 1, 0)], 1000,
     [[0, 3], [1], [2]]),
    ([("big", "float32", 500, 1, 0), ("s", "float32", 1, 1, 0)], 100,
     [[0], [1]]),
    ([], 128, []),
]


@pytest.mark.parametrize("entries,threshold,want", FUSION_CASES)
def test_plan_fusion_buckets_match_jax(entries, threshold, want):
    got = tc.plan_fusion(entries, threshold)
    assert got == jc.plan_fusion(entries, threshold) == want


def test_tensor_queue_duplicates_and_fifo_match_jax():
    def trace(core):
        q = core.NativeTensorQueue()
        out = [q.add("x", "float32", [4]), q.add("x", "float32", [4]),
               q.add("y", "float32", [4]), q.add("z", "", []), len(q),
               q.pop(2)]
        q.finish("x")
        q.finish("z")
        out += [q.add("x", "float32", [4]), len(q), q.pop(10), len(q)]
        return out

    got = trace(tc)
    assert got == trace(jc)
    assert got == [True, False, True, True, 3, ["x", "y"], True, 1, ["x"],
                   0]


def test_stall_report_matches_jax():
    def trace(core):
        si = core.NativeStallInspector(warning_time_s=1.0,
                                       shutdown_time_s=10.0, world_size=4)
        si.record_request("t", 0, now=0.0)
        si.record_request("t", 2, now=0.1)
        si.record_request("u", 1, now=0.0)
        for r in range(4):
            si.record_request("done", r, now=0.0)
        out = [si.check(now=0.5), si.check(now=2.0), si.check(now=20.0)]
        si.record_done("t")
        si.record_done("u")
        out.append(si.check(now=30.0))
        return out

    got = trace(tc)
    want = trace(jc)
    assert [s for s, _ in got] == [s for s, _ in want] == [0, 1, 2, 0]
    for (_, a), (_, b) in zip(got, want):
        key = sorted  # the report follows the table's hash order
        assert key((n, w, r, m) for n, w, r, m in a) == \
            key((n, w, r, m) for n, w, r, m in b)
    assert ("t", 2.0, [0, 2], [1, 3]) in got[1][1]
    assert ("u", 2.0, [1], [0, 2, 3]) in got[1][1]
    assert all(n != "done" for n, *_ in got[2][1])
