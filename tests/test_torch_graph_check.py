"""The port's graph checker (``analysis/graph_check.py``) against the JAX
checker's expected values.

The JAX checker (``horovod_tpu/analysis/jaxpr_check.py``) reads
``jax.core.Var``, which this jax no longer has, so its walk cannot run
here: each test writes the program of a case of ``tests/test_jaxpr_check.py``
in torch — ``hvd.allreduce`` for ``lax.psum`` (Sum), the ring's rotation
for ``ppermute``, ``torch.cond`` for ``lax.cond``, a Python loop for
``lax.scan`` (it unrolls in the trace), ``while_loop`` for
``lax.while_loop`` — and holds the port's census and findings to the
values that test writes down.  The census keys are the port's collective
names, mapped from JAX's by ``JAX_NAMES``.
"""

import pytest
import torch
from torch._higher_order_ops.while_loop import while_loop

import horovod_tpu_torch as hvd
from horovod_tpu_torch.analysis import check_step_fn, graph_check
from horovod_tpu_torch.parallel import axes_process_set, axis, flash
from horovod_tpu_torch.parallel import ring
from horovod_tpu_torch.serve import paged_attention as pa

N = 8
ENV = [("hvd", N)]
# JAX's census keys -> the port's.
JAX_NAMES = {"psum": "allreduce", "ppermute": "ppermute",
             "all_gather": "allgather", "all_to_all": "alltoall",
             "psum_scatter": "reducescatter", "reduce_scatter": "reducescatter"}


def _psum(x, axes=None):
    ps = hvd.global_process_set if axes is None else axes_process_set(axes)
    return hvd.allreduce(x, op=hvd.Sum, process_set=ps)


def _rules(report):
    return [f.rule for f in report.findings]


def _census(jax_census):
    return {JAX_NAMES[k]: v for k, v in jax_census.items()}


# -- detection (test_jaxpr_check.py:33-105) -------------------------------------

def test_detects_branch_mismatched_cond_collective():
    def step(x):
        return torch.cond(x.sum() > 0, lambda z: _psum(z),
                          lambda z: z.clone(), (x,))

    report = check_step_fn(step, (torch.ones(4),), axis_env=ENV)
    assert _rules(report) == ["HVD102"]
    assert "allreduce" in report.findings[0].message
    # The census still counts the branch's collective (static upper bound).
    assert report.census["allreduce"]["count"] == 1


def test_matched_cond_branches_are_clean():
    def step(x):
        return torch.cond(x.sum() > 0, lambda z: _psum(z) * 2.0,
                          lambda z: _psum(z) + 1.0, (x,))

    report = check_step_fn(step, (torch.ones(4),), axis_env=ENV)
    assert report.ok(), [f.message for f in report.findings]


@pytest.mark.parametrize("case", ["undeclared", "unbound"])
def test_axis_findings(case):
    """:64 — a collective over 'tp', bound but not declared, is HVD101
    with the axis named; :75 — an axis nothing binds fails the trace
    with an unbound axis name, reported (not raised) as HVD101."""
    if case == "undeclared":
        report = check_step_fn(lambda x: _psum(x, ["tp"]), (torch.ones(4),),
                               axis_env=[("hvd", N), ("tp", 2)],
                               declared_axes=("hvd",))
        assert _rules(report) == ["HVD101"]
        assert "'tp'" in report.findings[0].message
    else:
        report = check_step_fn(lambda x: _psum(x, ["no_such_axis"]),
                               (torch.ones(4),), axis_env=ENV)
        assert _rules(report) == ["HVD101"]
        assert "unbound axis" in report.findings[0].message


def _bomb(x):
    raise RuntimeError("synthetic trace bomb")


def _typo(x):
    return x * axis_scale  # noqa: F821


_STATE = torch.zeros(4)


def _writes_state(x):
    _STATE.add_(1.0)
    return x * 2.0


@pytest.mark.parametrize("fn,text", [(_bomb, "synthetic trace bomb"),
                                     (_typo, "axis_scale"),
                                     (_writes_state, "closes over")])
def test_trace_failure_is_hvd100_not_raised(fn, text):
    """:84 / :93 — a step that raises, and a plain NameError whose name
    contains 'axis', are HVD100 (never HVD101), reported not raised; so
    is a step that writes a tensor it closes over, which the trace
    leaves as it was."""
    report = check_step_fn(fn, (torch.ones(4),))
    assert _rules(report) == ["HVD100"]
    assert text in report.findings[0].message
    assert torch.equal(_STATE, torch.zeros(4))


def test_cond_branches_with_different_trip_counts_mismatch():
    """:105 — an allreduce looped 2x vs 5x is a different runtime
    sequence: HVD102, and the census counts both branches (2 + 5)."""
    def looped(n):
        def branch(z):
            for _ in range(n):
                z = _psum(z)
            return z
        return branch

    def step(x):
        return torch.cond(x.sum() > 0, looped(2), looped(5), (x,))

    report = check_step_fn(step, (torch.ones(4),), axis_env=ENV)
    assert _rules(report) == ["HVD102"]
    assert report.census["allreduce"]["count"] == 7


# -- census mechanics (:128, :146) -------------------------------------------------

def test_census_counts_bytes_and_loop_expansion():
    def step(x):
        y = x
        for _ in range(5):
            y = _psum(y)
        (k,), _ = ring._post(axis("hvd"), [x], -1)
        return y + k

    report = check_step_fn(step, (torch.ones(4, dtype=torch.float32),),
                           axis_env=ENV)
    assert report.ok()
    assert report.census == _census({"psum": {"count": 5, "bytes": 5 * 16},
                                     "ppermute": {"count": 1, "bytes": 16}})
    assert report.total_collectives() == 6
    assert report.total_bytes() == 96


def test_while_loop_counts_once_and_marks_dynamic():
    def step(x):
        return while_loop(lambda c: c.sum() < 100.0,
                          lambda c: (_psum(c),), (x,))

    report = check_step_fn(step, (torch.ones(4),), axis_env=ENV)
    assert report.ok()
    assert report.census["allreduce"]["count"] == 1
    assert report.dynamic_loops == 1


# -- a full training step (:233) ----------------------------------------------------

def test_full_training_step_census_includes_metric_allreduce():
    """JAX's step (w [3, 2], b [2], loss) censuses psum 3: one per
    gradient leaf and the loss.  The port's optimizer reduction fuses the
    two same-dtype gradients into one flat buffer (``_fused_allreduce``,
    the fusion planner's one bucket), so it counts allreduce 2 — the
    bucket and the loss — over the same bytes, (6 + 2 + 1) * 4."""
    from horovod_tpu_torch.optimizer import _allreduce_list
    hvd.init(device="cpu")
    try:
        params = {"w": torch.ones(3, 2), "b": torch.ones(2)}
        xb = torch.ones(N, 3)

        def step(p, x):
            loss = ((x @ p["w"] + p["b"]) ** 2).sum()
            g = torch.autograd.grad(loss, [p["w"], p["b"]])
            red = _allreduce_list(list(g), hvd.Average, hvd.Compression.none,
                                  1.0, 1.0, hvd.global_process_set)
            return red, hvd.allreduce(loss.detach(), op=hvd.Average)

        p = {k: v.requires_grad_() for k, v in params.items()}
        report = check_step_fn(step, (p, xb), axis_env=[("hvd", N)],
                               label="train")
    finally:
        hvd.shutdown()
    assert report.ok(), [f.message for f in report.findings]
    assert report.census == {"allreduce": {"count": 2,
                                           "bytes": (6 + 2 + 1) * 4}}


# -- torch.distributed called directly -----------------------------------------------

def test_census_reads_torch_distributed_nodes():
    """A step that calls ``torch.distributed`` itself (here in a gloo
    world of one) enters the graph as ``c10d`` nodes; the census reads
    them under the port's names, with the group's size."""
    import torch.distributed as dist
    hvd.init(device="cpu")
    try:
        def step(x):
            y = x * 2.0
            dist.all_reduce(y)
            z = torch.empty(8)
            dist.all_gather_into_tensor(z, y)
            return y, z

        report = check_step_fn(step, (torch.ones(4),))
    finally:
        hvd.shutdown()
    assert report.ok()
    assert report.census == {"allreduce": {"count": 1, "bytes": 16},
                             "allgather": {"count": 1, "bytes": 16}}


# -- the trace launches nothing --------------------------------------------------------

def test_trace_launches_no_kernel_and_leaves_inputs():
    """A trace through the kernel wrappers takes their fake branch: no
    count moves in ``LAUNCHES`` / ``LAUNCHES_BY_MODE``, the outputs have
    the kernels' shapes and dtypes, and the argument the step writes is
    unchanged."""
    before = (dict(flash.LAUNCHES), dict(flash.LAUNCHES_BY_MODE),
              dict(pa.LAUNCHES))
    q = torch.randn(1, 8, 2, 4, requires_grad=True)
    pool = torch.zeros(3, 4, 2, 4)
    saved = pool.clone()

    def step(q, pool):
        out = flash.flash_attention(q, q, q, causal=True)
        g, = torch.autograd.grad(out.sum(), [q])
        pool[0, 0] = q[0, 0].detach()
        att = pa.paged_decode_attention(
            q[:, 0].detach(), pool, pool,
            torch.zeros(1, 3, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32))
        return out, g, att

    gm = graph_check.trace(step, (q, pool))
    assert (dict(flash.LAUNCHES), dict(flash.LAUNCHES_BY_MODE),
            dict(pa.LAUNCHES)) == before
    assert torch.equal(pool, saved)
    outs = [n for n in gm.graph.nodes if n.op == "output"][0]
    vals = [a.meta["val"] for a in outs.all_input_nodes]
    assert [tuple(v.shape) for v in vals] == [(1, 8, 2, 4), (1, 8, 2, 4),
                                             (1, 2, 4)]
    assert vals[2].dtype == torch.float32
