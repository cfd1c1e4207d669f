"""The port's training model against the JAX package's flax
``Transformer``, and its trainer end to end on the CPU.

Weights are flax parameters drawn with numpy from a seed and converted
with ``params_from_jax``; the flax side runs flash attention as the JAX
package's tests do (Pallas interpret mode), the port its plain versions.
Tolerances: f32 logits rtol 2e-4 / atol 2e-5 (the flash forward's),
f32 gradients 2e-3 / 2e-4 (the flash gradients'), bf16 0.1 / 0.05.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import transformer as jt
from horovod_tpu_torch.models import (BERT_BASE, BERT_LARGE, Transformer,
                                      TransformerConfig, create_bert, lm_loss,
                                      params_from_jax)

torch.set_num_threads(2)

S = 16
_J = jt.TransformerConfig(vocab_size=61, num_layers=2, num_heads=2,
                          d_model=32, d_ff=64, max_len=S, dtype=jnp.float32,
                          scan_layers=False)
_T = TransformerConfig(vocab_size=61, num_layers=2, num_heads=2, d_model=32,
                       d_ff=64, max_len=S, dtype=torch.float32)


def _numpy_params(tree, seed):
    rng = np.random.RandomState(seed)
    std = {"scale": 0.1, "bias": 0.1, "embedding": 0.5, "kernel": 0.2}

    def leaf(path, x):
        name = path[-1].key
        return np.asarray(std[name] * rng.randn(*x.shape) + (name == "scale"),
                          np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _pair(causal, seed, **over):
    jcfg = dataclasses.replace(_J, causal=causal, **over)
    fmodel = jt.Transformer(jcfg)
    tree = fmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, S), jnp.int32))
    params = _numpy_params(jax.device_get(tree["params"]), seed)
    tover = {k: v for k, v in over.items() if k != "dtype"}
    if "dtype" in over:
        tover["dtype"] = torch.bfloat16
    model = Transformer(dataclasses.replace(_T, causal=causal, **tover),
                        device="cpu")
    model.load_state_dict(params_from_jax(params))
    return fmodel, params, model


def _batch(seed, B=3):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, 61, (B, S))
    mask = (rng.rand(B, S) < 0.4).astype(np.float32)
    return tokens, mask


@pytest.mark.parametrize("causal", [False, True], ids=["bert", "gpt2"])
def test_flash_logits_and_gradients_match_flax(causal):
    fmodel, params, model = _pair(causal, seed=1, attention_impl="flash")
    tokens, mask = _batch(2)

    def jloss(p):
        logits = fmodel.apply({"params": p}, jnp.asarray(tokens))
        return jt.lm_loss(logits, jnp.asarray(tokens), jnp.asarray(mask)), \
            logits

    (jl, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    logits = model(torch.from_numpy(tokens))
    loss = lm_loss(logits, torch.from_numpy(tokens), torch.from_numpy(mask))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(float(loss), float(jl), rtol=2e-4, atol=2e-5)
    want = params_from_jax(jax.device_get(jgrads))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=2e-3, atol=2e-4, err_msg=name)


def test_predict_positions_match_flax():
    fmodel, params, model = _pair(False, seed=3, attention_impl="flash")
    tokens, _ = _batch(4)
    pos = np.sort(np.stack([np.random.RandomState(5 + b).choice(
        S, 4, replace=False) for b in range(3)]), axis=1).astype(np.int32)
    want = fmodel.apply({"params": params}, jnp.asarray(tokens),
                        predict_positions=jnp.asarray(pos))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens),
                    predict_positions=torch.from_numpy(pos))
    assert tuple(got.shape) == (3, 4, 61)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-5)


def test_bf16_model_keeps_f32_parameters_and_matches_flax():
    """Parameters stay f32 and are cast to bf16 where they are used, as
    flax's param_dtype=float32 / dtype=bfloat16 does."""
    fmodel, params, model = _pair(False, seed=6, dtype=jnp.bfloat16)
    assert model.cfg.dtype == torch.bfloat16
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    tokens, _ = _batch(7)
    want = fmodel.apply({"params": params}, jnp.asarray(tokens))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=0.1, atol=0.05)


def test_remat_gives_the_same_gradients():
    _, params, model = _pair(False, seed=8, attention_impl="flash")
    remat = Transformer(dataclasses.replace(model.cfg, remat=True),
                        device="cpu")
    remat.load_state_dict(model.state_dict())
    tokens, mask = _batch(9)
    grads = []
    for m in (model, remat):
        loss = lm_loss(m(torch.from_numpy(tokens)), torch.from_numpy(tokens),
                       torch.from_numpy(mask))
        grads.append(torch.autograd.grad(loss, list(m.parameters())))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_lm_loss_matches_jax():
    rng = np.random.RandomState(10)
    logits = rng.randn(2, 5, 7).astype(np.float32)
    targets = rng.randint(0, 7, (2, 5))
    for mask in (None, (rng.rand(2, 5) < 0.5).astype(np.float32),
                 np.zeros((2, 5), np.float32)):
        want = jt.lm_loss(jnp.asarray(logits), jnp.asarray(targets),
                          None if mask is None else jnp.asarray(mask))
        got = lm_loss(torch.from_numpy(logits), torch.from_numpy(targets),
                      None if mask is None else torch.from_numpy(mask))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("name", ["BERT_BASE", "BERT_LARGE"])
def test_bert_configs_match_jax(name):
    port = {"BERT_BASE": BERT_BASE, "BERT_LARGE": BERT_LARGE}[name]
    ref = getattr(jt, name)
    for field in ("vocab_size", "num_layers", "num_heads", "d_model",
                  "d_ff", "max_len", "causal"):
        assert getattr(port, field) == getattr(ref, field), field
    assert port.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16


def test_create_bert_init_and_unknown_attention_impl():
    m = create_bert("base", device="cpu", seed=3, num_layers=1)
    sd = m.state_dict()
    assert abs(float(sd["blocks.0.fc1.kernel"].std()) - 0.02) < 1e-3
    assert abs(float(sd["wpe.embedding"].std()) - 0.01) < 1e-3
    assert not m.cfg.causal and m.cfg.vocab_size == 30522
    with pytest.raises(ValueError, match="unknown attention_impl 'ring'"):
        Transformer(dataclasses.replace(_T, attention_impl="ring"),
                    device="cpu")


def test_bert_pretraining_main_lowers_the_loss_on_the_cpu():
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.examples import bert_pretraining
    hvd.shutdown()
    argv = ["--device", "cpu", "--size", "tiny", "--steps", "6",
            "--seq-len", "32", "--attention", "flash"]
    try:
        losses, samples_s = bert_pretraining.main(argv)
        assert hvd.gloo_enabled() and hvd.size() == 1
        # The trainer main builds, driven to one boundary: the reduced
        # gradients it hands the optimizer are finite.
        model, attn, micro_batch = bert_pretraining.build(
            bert_pretraining.parse_args(argv))
        assert attn == "flash"
        micro_batch()
        first = float(micro_batch())
        assert all(bool(torch.isfinite(p.grad).all())
                   for p in model.parameters())
    finally:
        hvd.shutdown()
    assert len(losses) == 6 and losses[-1] < losses[0]
    # Parameters move only on the accumulation boundary (accum=2).
    assert losses[0] == losses[1] and losses[2] == losses[3]
    assert samples_s > 0 and np.isfinite(losses).all()
    assert first == losses[1]  # the same seeds build the same trainer
