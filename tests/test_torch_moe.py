"""The port's mixture of experts (``horovod_tpu_torch/parallel/moe.py``
and the MoE transformer) against the JAX package's, in one process on
the CPU, on the same numpy inputs.

``tests/test_moe.py``'s behaviours (top-1 against each token's expert,
top-2 weights, capacity dropping, the aux loss of a balanced and a
skewed router) run through both packages at its tolerance 1e-4 / 1e-5
(``:38``); ``expert_parallel_ffn(axis_name=None)`` and its gradients are
held to JAX's with capacity to spare and with claims dropped; the
port's index dispatch is held to JAX's materialised ``dispatch`` /
``combine``; the TINY MoE transformer's logits and gradients to flax's
in f32 at 2e-3 (``tests/test_moe.py:153``).  The sharded paths run in
``tests/test_torch_model_parallel.py``'s 4-process world.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import transformer as jt
from horovod_tpu.parallel import moe as jmoe
from horovod_tpu_torch.models import (Transformer, TransformerConfig,
                                      lm_loss, params_from_jax)
from horovod_tpu_torch.parallel import moe

torch.set_num_threads(2)
RTOL, ATOL = 1e-4, 1e-5
TINY = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64,
            max_len=16, causal=True)


def _mk(seed, T=16, d=8, f=16, E=8):
    rng = np.random.RandomState(seed)
    return ((rng.randn(T, d)).astype(np.float32),
            (rng.randn(d, E) * 2.0).astype(np.float32),
            (rng.randn(E, d, f) * 0.1).astype(np.float32),
            (rng.randn(E, f, d) * 0.1).astype(np.float32))


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def _port_ffn(arrays, **kw):
    return moe.expert_parallel_ffn(*_t(*arrays), axis_name=None, **kw)


def _jax_ffn(arrays, **kw):
    return jmoe.expert_parallel_ffn(*(jnp.asarray(a) for a in arrays),
                                    axis_name=None, **kw)


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(
        got, torch.Tensor) else got), np.asarray(want), rtol=rtol,
        atol=atol, err_msg=msg)


def test_top1_matches_per_token_expert():
    """top_k=1 with capacity to spare: each token's output is its argmax
    expert's FFN (weight 1), in both packages."""
    arrays = _mk(0)
    x, gate, w_in, w_out = arrays
    got = _port_ffn(arrays, top_k=1, capacity_factor=8.0)
    want = _jax_ffn(arrays, top_k=1, capacity_factor=8.0)
    _close(got.out, want.out)
    choice = np.argmax(x @ gate, axis=-1)
    for t in range(x.shape[0]):
        e = choice[t]
        ref = np.asarray(jax.nn.gelu(x[t] @ w_in[e]) @ w_out[e])
        _close(got.out[t], ref)
    assert float(got.dropped_frac) == 0.0 == float(want.dropped_frac)


def test_top2_weights_blend_two_experts():
    arrays = _mk(1, T=8, E=4)
    x, gate, w_in, w_out = arrays
    got = _port_ffn(arrays, top_k=2, capacity_factor=8.0)
    _close(got.out, _jax_ffn(arrays, top_k=2, capacity_factor=8.0).out)
    probs = np.asarray(jax.nn.softmax(x @ gate, axis=-1))
    for t in range(x.shape[0]):
        top2 = np.argsort(-probs[t])[:2]
        w = probs[t][top2] / probs[t][top2].sum()
        ref = sum(w[i] * np.asarray(jax.nn.gelu(x[t] @ w_in[e]) @ w_out[e])
                  for i, e in enumerate(top2))
        _close(got.out[t], ref)


def test_capacity_drops_tokens():
    """Capacity 1 with every token on expert 0: one row kept,
    dropped_frac 11/12, as JAX."""
    T, d = 12, 4
    x = np.ones((T, d), np.float32)
    gate = np.zeros((d, 2), np.float32)
    gate[0, 0] = 5.0
    rng = np.random.RandomState(2)
    w_in = (rng.randn(2, d, 8) * 0.1).astype(np.float32)
    w_out = (rng.randn(2, 8, d) * 0.1).astype(np.float32)
    arrays = (x, gate, w_in, w_out)
    got = _port_ffn(arrays, top_k=1, capacity_factor=1.0 / 6.0)
    want = _jax_ffn(arrays, top_k=1, capacity_factor=1.0 / 6.0)
    assert (got.out.abs().sum(dim=1) > 0).sum() == 1
    _close(got.out, want.out)
    np.testing.assert_allclose(float(got.dropped_frac), 11 / 12, rtol=1e-6)
    np.testing.assert_allclose(float(got.dropped_frac),
                               float(want.dropped_frac), rtol=1e-6)


def test_aux_loss_balanced_vs_skewed():
    x, _, w_in, w_out = _mk(4, T=64, E=8)
    uniform = np.zeros((x.shape[1], 8), np.float32)
    skewed = uniform.copy()
    skewed[:, 0] = 9.0
    aux = {}
    for name, gate in (("u", uniform), ("s", skewed)):
        arrays = (x, gate, w_in, w_out)
        got = _port_ffn(arrays, top_k=1, capacity_factor=8.0)
        want = _jax_ffn(arrays, top_k=1, capacity_factor=8.0)
        _close(got.aux_loss, want.aux_loss, msg=name)
        aux[name] = float(got.aux_loss)
    assert aux["s"] > 2.0 * aux["u"]
    assert 0.5 < aux["u"] < 2.0


@pytest.mark.parametrize("top_k,cf", [(1, 8.0), (2, 1.25), (2, 0.5),
                                      (3, 0.75)])
def test_unsharded_ffn_and_gradients_match_jax(top_k, cf):
    """``expert_parallel_ffn(axis_name=None)``: output, aux loss, dropped
    share, and the gradients of sum(out · w) + aux with respect to x,
    the gate and both expert weights, against jax.grad; capacity to
    spare and claims dropped (cf 0.5, 0.75)."""
    arrays = _mk(5, T=32, d=8, f=16, E=4)
    w = np.random.RandomState(6).randn(32, 8).astype(np.float32)
    want = _jax_ffn(arrays, top_k=top_k, capacity_factor=cf)

    def jloss(*a):
        r = jmoe.expert_parallel_ffn(*a, axis_name=None, top_k=top_k,
                                     capacity_factor=cf)
        return jnp.sum(r.out * w) + r.aux_loss

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in arrays))
    leaves = [t.requires_grad_() for t in _t(*arrays)]
    got = moe.expert_parallel_ffn(*leaves, axis_name=None, top_k=top_k,
                                  capacity_factor=cf)
    (torch.sum(got.out * torch.from_numpy(w)) + got.aux_loss).backward()
    _close(got.out, want.out, msg="out")
    _close(got.aux_loss, want.aux_loss, msg="aux")
    np.testing.assert_allclose(float(got.dropped_frac),
                               float(want.dropped_frac), rtol=1e-6)
    if cf < 1.0:
        assert float(got.dropped_frac) > 0.0
    for name, t, g in zip(("x", "gate", "w_in", "w_out"), leaves, jg):
        _close(t.grad, g, msg=name)


def test_index_dispatch_matches_materialised_dispatch_combine():
    """The port's slots (index form) against JAX's formula with the
    materialised [T, E, C] tensors: ``_dispatch_combine`` equals JAX's,
    the buckets einsum("tec,td->ecd") and the combined output
    einsum("tec,ecd->td") equal the index form's, and the aux loss from
    ``dispatch`` equals the one from the counts, with claims dropped."""
    T, d, f, E, k, cf = 40, 8, 16, 4, 2, 0.6
    x, gate, w_in, w_out = _mk(7, T=T, d=d, f=f, E=E)
    C = max(1, int(cf * k * T / E))
    logits = torch.from_numpy(x) @ torch.from_numpy(gate)
    idx, wts, probs = moe._top_k_gating(logits, k)
    dispatch, combine, dropped = moe._dispatch_combine(idx, wts, probs, E, C)
    jd, jc, jdrop = jmoe._dispatch_combine(
        jnp.asarray(idx.numpy()), jnp.asarray(wts.numpy()),
        jnp.asarray(probs.numpy()), E, C)
    np.testing.assert_array_equal(dispatch.numpy(), np.asarray(jd))
    _close(combine, jc, rtol=1e-6, atol=1e-7)
    assert float(dropped) == float(jdrop) > 0.0
    slot, kept = moe._routes(idx, E, C)
    assert int(kept.sum()) == int(dispatch.sum())
    for j in range(k):
        for t in range(T):
            e = int(idx[t, j])
            c = int(slot[j, t]) - e * C      # the claim's position
            assert bool(kept[j, t]) == (c < C)
            if c < C:
                assert float(dispatch[t, e, c]) == 1.0
    xt = torch.from_numpy(x)
    buckets = torch.einsum("tec,td->ecd", dispatch, xt)
    h = torch.bmm(moe.gelu(torch.bmm(buckets, torch.from_numpy(w_in))),
                  torch.from_numpy(w_out))
    want = torch.einsum("tec,ecd->td", combine, h)
    got = moe.expert_parallel_ffn(xt, *_t(gate, w_in, w_out),
                                  axis_name=None, top_k=k,
                                  capacity_factor=cf)
    _close(got.out, want, rtol=1e-6, atol=1e-6)
    _close(got.aux_loss, moe.switch_aux_loss(probs, dispatch), rtol=1e-6,
           atol=1e-7)


def test_bf16_combine_rounds_as_jax():
    """bf16 tokens and experts (the model's compute type): the combine
    weights are rounded to bf16 before the sum, as JAX casts
    ``combine``; the two agree within bf16 rounding of the output."""
    arrays = _mk(8, T=32, d=8, f=16, E=4)
    x, gate, w_in, w_out = arrays
    got = moe.expert_parallel_ffn(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(gate),
        torch.from_numpy(w_in).bfloat16(), torch.from_numpy(w_out).bfloat16(),
        axis_name=None, top_k=2, capacity_factor=1.25)
    want = jmoe.expert_parallel_ffn(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(gate),
        jnp.asarray(w_in, jnp.bfloat16), jnp.asarray(w_out, jnp.bfloat16),
        axis_name=None, top_k=2, capacity_factor=1.25)
    assert got.out.dtype == torch.bfloat16
    np.testing.assert_allclose(got.out.float().numpy(),
                               np.asarray(want.out, np.float32),
                               rtol=2**-7, atol=2e-3)
    _close(got.aux_loss, want.aux_loss, rtol=1e-5, atol=1e-6)


def test_gate_expert_count_mismatch_raises():
    x, gate, w_in, w_out = _mk(9, E=4)
    with pytest.raises(ValueError, match="gate maps to 4 experts"):
        moe.expert_parallel_ffn(*_t(x, gate, w_in[:2], w_out[:2]),
                                axis_name=None)


# -- the MoE transformer ------------------------------------------------------

def _jax_moe(remat=False, capacity_factor=1.25):
    cfg = jt.TransformerConfig(**TINY, dtype=jnp.float32, moe_experts=4,
                               moe_capacity_factor=capacity_factor,
                               scan_layers=False, remat=remat)
    toks = np.random.RandomState(1).randint(0, 64, (2, 16))
    params = jt.Transformer(cfg).init(jax.random.PRNGKey(0), toks)
    return cfg, toks, params


def _port_moe(params, remat=False, capacity_factor=1.25):
    model = Transformer(TransformerConfig(
        **TINY, dtype=torch.float32, moe_experts=4,
        moe_capacity_factor=capacity_factor, remat=remat), device="cpu")
    model.load_state_dict(params_from_jax(jax.device_get(params)))
    return model


def test_moe_config_defaults_match_jax():
    for field in ("moe_experts", "moe_top_k", "moe_capacity_factor",
                  "moe_every", "expert_axis"):
        assert getattr(TransformerConfig(), field) == \
            getattr(jt.TransformerConfig(), field), field


def test_moe_transformer_params_convert_leaf_for_leaf():
    """Block i is MoE when i % moe_every == moe_every - 1: block 1 holds
    moe_gate [d, E], moe_w_in [E, d, d_ff], moe_w_out [E, d_ff, d] and no
    fc1 / fc2, as flax's tree, which loads strictly."""
    _, _, params = _jax_moe()
    state = params_from_jax(jax.device_get(params))
    model = Transformer(TransformerConfig(**TINY, dtype=torch.float32,
                                          moe_experts=4), device="cpu")
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in state.items()}
    assert tuple(state["blocks.1.moe_w_in"].shape) == (4, 32, 64)
    assert "blocks.1.fc1.kernel" not in state
    assert "blocks.0.fc1.kernel" in state


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_transformer_logits_and_grads_match_jax(cf):
    """TINY with 4 experts every 2nd block, f32: the logits, the sum of
    the aux losses (one per MoE block) and the gradients of lm_loss +
    0.01 · aux against flax's apply with ``mutable=["losses"]``, at
    2e-3; cf 0.5 drops claims."""
    cfg, toks, variables = _jax_moe(capacity_factor=cf)
    params = {"params": variables["params"]}   # not init's own "losses"
    model_j = jt.Transformer(cfg)

    def jloss(p):
        logits, mut = model_j.apply(p, toks, mutable=["losses"])
        aux = sum(jax.tree.leaves(mut["losses"]))
        return lm_loss_j(logits[:, :-1], toks[:, 1:]) + 0.01 * aux, \
            (logits, aux)

    lm_loss_j = jt.lm_loss
    (_, (jlogits, jaux)), jgrads = jax.value_and_grad(
        jloss, has_aux=True)(params)
    model = _port_moe(params, capacity_factor=cf)
    tt = torch.from_numpy(toks)
    logits = model(tt)
    assert len(model.aux_losses) == 1
    aux = sum(model.aux_losses)
    (lm_loss(logits[:, :-1], tt[:, 1:]) + 0.01 * aux).backward()
    _close(logits, jlogits, rtol=2e-3, atol=2e-3)
    _close(aux, jaux, rtol=2e-3, atol=2e-3)
    want = params_from_jax(jax.device_get(jgrads))
    grads = dict(model.named_parameters())
    for k, v in want.items():
        _close(grads[k].grad, v.numpy(), rtol=2e-3, atol=2e-3, msg=k)


def test_moe_block_remat_records_one_aux_per_block():
    """``remat`` recomputes each block in the backward, the MoE block
    with it, without a second aux entry; the logits, aux and gradients
    equal the model without remat."""
    _, toks, params = _jax_moe()
    tt = torch.from_numpy(toks)
    out = {}
    for remat in (False, True):
        model = _port_moe(params, remat=remat)
        logits = model(tt)
        aux = sum(model.aux_losses)
        (lm_loss(logits[:, :-1], tt[:, 1:]) + 0.01 * aux).backward()
        assert len(model.aux_losses) == 1
        out[remat] = (logits.detach(), aux.detach(),
                      {k: p.grad for k, p in model.named_parameters()})
    _close(out[True][0], out[False][0], rtol=1e-6, atol=1e-6)
    _close(out[True][1], out[False][1], rtol=1e-6, atol=1e-6)
    for k, g in out[False][2].items():
        _close(out[True][2][k], g, rtol=1e-5, atol=1e-6, msg=k)


def test_expert_axis_must_be_bound():
    with pytest.raises(ValueError):
        Transformer(TransformerConfig(**TINY, moe_experts=4,
                                      expert_axis="nope"), device="cpu")


def test_moe_replicated_init_is_seeded():
    """``create_gpt2`` draws the expert weights at GPT-2's 0.02 from the
    seed; the replicated model marks nothing as sharded."""
    from horovod_tpu_torch.models import create_gpt2
    from horovod_tpu_torch.parallel import sharded_axes
    a = create_gpt2("small", device="cpu", seed=3, num_layers=2,
                    vocab_size=256, moe_experts=4)
    b = create_gpt2("small", device="cpu", seed=3, num_layers=2,
                    vocab_size=256, moe_experts=4)
    w = a.blocks[1].moe_w_in
    assert torch.equal(w, b.blocks[1].moe_w_in)
    assert abs(float(w.detach().std()) - 0.02) < 1e-3
    assert not sharded_axes(w)


def test_jax_init_losses_leak_into_apply():
    """A fault of the reference, pinned (ROADMAP Queue C): flax's
    ``init`` returns the sown ``"losses"`` beside ``"params"``, and
    applying those variables with ``mutable=["losses"]`` appends to them,
    so ``dryrun_multichip``'s phase 3 (and ``tests/test_moe.py:117``) add
    the init's aux loss, a constant, to every objective.  The port keeps
    one aux loss per MoE block per forward."""
    cfg, toks, variables = _jax_moe()
    assert "losses" in variables
    _, stale = jt.Transformer(cfg).apply(variables, toks, mutable=["losses"])
    _, fresh = jt.Transformer(cfg).apply({"params": variables["params"]},
                                         toks, mutable=["losses"])
    assert len(jax.tree.leaves(stale["losses"])) == 2
    assert len(jax.tree.leaves(fresh["losses"])) == 1
    model = _port_moe(variables)
    model(torch.from_numpy(toks))
    assert len(model.aux_losses) == 1
    _close(model.aux_losses[0], jax.tree.leaves(fresh["losses"])[0],
           rtol=2e-3, atol=2e-3)
