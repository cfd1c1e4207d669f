"""The port's GPT-2 against the JAX package's flax ``Transformer``.

``params_from_jax`` converts the flax tree (unrolled ``block_i`` and the
stacked ``scan_layers`` layout alike) and the port's dense causal
``Transformer`` then gives the flax model's logits in f32, within rtol
1e-4 / atol 1e-5 (the two LayerNorms are different formulas of the same
function, and the sums run in another order).  Weights are made with
numpy from a seed, larger than GPT-2's init so that attention and the
argmax are not trivial.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import transformer as jt
from horovod_tpu_torch.models import (GPT2_LARGE, GPT2_MEDIUM, GPT2_SMALL,
                                      Transformer, TransformerConfig,
                                      create_gpt2, params_from_jax)
from horovod_tpu_torch.models.transformer import layer_norm

torch.set_num_threads(2)

_JTINY = jt.TransformerConfig(vocab_size=61, num_layers=2, num_heads=2,
                              d_model=32, d_ff=64, max_len=64, causal=True,
                              dtype=jnp.float32, scan_layers=False)
_TTINY = TransformerConfig(vocab_size=61, num_layers=2, num_heads=2,
                           d_model=32, d_ff=64, max_len=64)


def numpy_params(tree, seed):
    """Replace every leaf of a flax param tree with numpy draws: unit-ish
    LayerNorm scales, small biases, kernels near 1/sqrt(fan_in) of the
    tiny model, and a token embedding wide enough to spread the logits."""
    rng = np.random.RandomState(seed)
    std = {"scale": 0.1, "bias": 0.1, "embedding": 0.5, "kernel": 0.2}

    def leaf(path, x):
        name = path[-1].key
        v = std[name] * rng.randn(*x.shape) + (name == "scale")
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def flax_tiny(seed=0, scan_layers=False):
    cfg = dataclasses.replace(_JTINY, scan_layers=scan_layers)
    model = jt.Transformer(cfg)
    tree = model.init(jax.random.PRNGKey(0),
                      jnp.zeros((1, 8), jnp.int32))["params"]
    return model, numpy_params(jax.device_get(tree), seed)


def test_params_from_jax_unrolled_layout():
    _, params = flax_tiny()
    state = params_from_jax(params)
    model = Transformer(_TTINY, device="cpu")
    model.load_state_dict(state, strict=True)
    np.testing.assert_array_equal(
        state["blocks.1.attn.qkv.kernel"].numpy(),
        params["block_1"]["attn"]["qkv"]["kernel"])
    assert tuple(state["blocks.0.attn.qkv.kernel"].shape) == (32, 3, 2, 16)
    assert tuple(state["blocks.0.attn.proj.kernel"].shape) == (2, 16, 32)
    assert tuple(state["blocks.0.fc1.kernel"].shape) == (32, 64)
    # A {"params": ...} wrapper is unwrapped.
    assert params_from_jax({"params": params}).keys() == state.keys()


def test_params_from_jax_scan_layout_equals_unrolled():
    """The stacked ``blocks/block`` layout converts to the same state as
    its unrolled form (JAX's own ``unstack_block_params``)."""
    _, stacked = flax_tiny(seed=3, scan_layers=True)
    assert "blocks" in stacked and "block_0" not in stacked
    got = params_from_jax(stacked)
    want = params_from_jax(jax.device_get(jt.unstack_block_params(stacked)))
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k
    Transformer(_TTINY, device="cpu").load_state_dict(got, strict=True)


@pytest.mark.parametrize("scan_layers", [False, True])
def test_logits_match_flax(scan_layers):
    fmodel, params = flax_tiny(seed=1, scan_layers=scan_layers)
    model = Transformer(_TTINY, device="cpu")
    model.load_state_dict(params_from_jax(params))
    tokens = np.random.RandomState(2).randint(0, 61, (3, 13))
    want = np.asarray(fmodel.apply({"params": params}, jnp.asarray(tokens)))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens)).numpy()
    assert got.dtype == np.float32 and got.shape == (3, 13, 61)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    # The weights make the argmax vary along the sequence.
    assert len(set(got.argmax(-1).ravel().tolist())) > 3


def test_layer_norm_matches_flax_layer_norm():
    """The serving LayerNorm formula equals flax's (both epsilons)."""
    import flax.linen as nn
    rng = np.random.RandomState(5)
    x = (rng.randn(4, 32) * 3 + 1).astype(np.float32)
    scale = (1 + 0.1 * rng.randn(32)).astype(np.float32)
    bias = (0.1 * rng.randn(32)).astype(np.float32)
    for eps in (1e-5, 1e-6):
        want = nn.LayerNorm(epsilon=eps, dtype=jnp.float32).apply(
            {"params": {"scale": scale, "bias": bias}}, jnp.asarray(x))
        got = layer_norm(torch.from_numpy(x), torch.from_numpy(scale),
                         torch.from_numpy(bias), eps)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["GPT2_SMALL", "GPT2_MEDIUM", "GPT2_LARGE"])
def test_gpt2_configs_match_jax(name):
    port = {"GPT2_SMALL": GPT2_SMALL, "GPT2_MEDIUM": GPT2_MEDIUM,
            "GPT2_LARGE": GPT2_LARGE}[name]
    ref = getattr(jt, name)
    for field in ("vocab_size", "num_layers", "num_heads", "d_model",
                  "d_ff", "max_len", "causal"):
        assert getattr(port, field) == getattr(ref, field), field


def test_gpt2_small_param_shapes_match_flax():
    """Full-width gpt2-small: the port's parameters (on the meta device,
    no memory) have the names and shapes of the converted flax tree."""
    fmodel = jt.create_gpt2("small", scan_layers=False, dtype=jnp.float32)
    shapes = jax.eval_shape(
        lambda: fmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))["params"])
    flat = {".".join(k.key for k in path).replace("block_", "blocks."):
            tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    port = Transformer(GPT2_SMALL, device="meta")
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == flat


def test_create_gpt2_is_seeded_with_gpt2_init():
    def make(seed):
        return create_gpt2("small", device="cpu", seed=seed, num_layers=2,
                           vocab_size=4096)

    a, b, c = make(7), make(7), make(8)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["wte.embedding"], sc["wte.embedding"])
    assert abs(float(sa["blocks.0.fc1.kernel"].std()) - 0.02) < 1e-3
    assert abs(float(sa["wte.embedding"].std()) - 0.02) < 1e-3
    assert abs(float(sa["wpe.embedding"].std()) - 0.01) < 1e-3
    assert float(sa["blocks.1.attn.qkv.bias"].abs().max()) == 0.0
    assert torch.equal(sa["ln_f.scale"], torch.ones(768))
    assert a.cfg.d_model == 768 and a.cfg.num_layers == 2


def test_entry_points_need_a_card_unless_told(monkeypatch):
    """With no card, asking for the default device raises instead of
    carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_gpt2("small", num_layers=1)
    from horovod_tpu_torch.serve import TransformerAdapter
    model = Transformer(_TTINY, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TransformerAdapter(_TTINY, model)
    assert TransformerAdapter(_TTINY, model, device="cpu").attn_impl == \
        "gather"
