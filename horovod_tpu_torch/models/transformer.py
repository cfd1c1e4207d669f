"""GPT-2 for serving: the configurations, the weights and a dense
reference forward.

Port of what serving needs from ``horovod_tpu/models/transformer.py``:
``TransformerConfig`` with the GPT-2 sizes, ``create_gpt2``, GPT-2's
initialisation, and a dense causal ``Transformer`` whose full-sequence
forward is the recompute reference the serving engine is held against
(the JAX tests use the flax module the same way).  Ring, Ulysses,
flash and MoE attention are training features and are not here.

Parameters keep the flax layouts and names, so a flax tree converts
leaf for leaf (``models/convert.py``) and the engine's einsums read
like the JAX adapter's:

* ``attn.qkv.kernel`` [d, 3, H, Dh], ``attn.qkv.bias`` [3, H, Dh];
* ``attn.proj.kernel`` [H, Dh, d];
* ``fc1``/``fc2`` kernels [in, out];
* ``wte.embedding`` [V, d], tied to the LM head; ``wpe.embedding``
  [max_len, d];
* LayerNorms hold ``scale`` and ``bias``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 50257
    num_layers: int = 12
    num_heads: int = 12
    d_model: int = 768
    d_ff: int = 3072
    max_len: int = 1024
    causal: bool = True              # GPT style; False = BERT style
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


GPT2_SMALL = TransformerConfig(num_layers=12, num_heads=12, d_model=768,
                               d_ff=3072)
GPT2_MEDIUM = TransformerConfig(num_layers=24, num_heads=16, d_model=1024,
                                d_ff=4096)
GPT2_LARGE = TransformerConfig(num_layers=36, num_heads=20, d_model=1280,
                               d_ff=5120)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm in f32, the serving adapter's own formula (the block
    norms use eps 1e-5, ``ln_f`` flax's default 1e-6)."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    y = (x32 - mu) * (1.0 / torch.sqrt(var + eps))
    return y * scale + bias


class LayerNorm(nn.Module):
    def __init__(self, d: int, eps: float, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(d, device=device))
        self.bias = nn.Parameter(torch.zeros(d, device=device))

    def forward(self, x):
        return layer_norm(x, self.scale, self.bias, self.eps)


class Dense(nn.Module):
    """A kernel of any shape ``in_shape + out_shape`` and its bias."""

    def __init__(self, kernel_shape, bias_shape, dtype, device=None):
        super().__init__()
        self.kernel = nn.Parameter(
            torch.empty(kernel_shape, dtype=dtype, device=device))
        self.bias = nn.Parameter(
            torch.zeros(bias_shape, dtype=dtype, device=device))


class Embed(nn.Module):
    def __init__(self, n: int, d: int, dtype, device=None):
        super().__init__()
        self.embedding = nn.Parameter(
            torch.empty((n, d), dtype=dtype, device=device))


class Block(nn.Module):
    """ln1 → qkv → dense causal attention → proj residual → ln2 →
    fc1/gelu(tanh)/fc2 residual."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        d, H, Dh, dt = cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.dtype
        self.cfg = cfg
        self.ln1 = LayerNorm(d, 1e-5, device)
        self.attn = nn.Module()
        self.attn.qkv = Dense((d, 3, H, Dh), (3, H, Dh), dt, device)
        self.attn.proj = Dense((H, Dh, d), (d,), dt, device)
        self.ln2 = LayerNorm(d, 1e-5, device)
        self.fc1 = Dense((d, cfg.d_ff), (cfg.d_ff,), dt, device)
        self.fc2 = Dense((cfg.d_ff, d), (d,), dt, device)

    def forward(self, x):
        cfg = self.cfg
        S = x.shape[1]
        h = self.ln1(x).to(cfg.dtype)
        qkv = torch.einsum("bsd,dthe->bsthe", h, self.attn.qkv.kernel) \
            + self.attn.qkv.bias
        q, k, v = qkv.unbind(dim=2)                       # [B, S, H, Dh]
        s = torch.einsum("bqhe,bkhe->bhqk", q.float(), k.float()) \
            / math.sqrt(cfg.head_dim)
        if cfg.causal:
            keep = torch.ones((S, S), dtype=torch.bool,
                              device=x.device).tril()
            s = torch.where(keep, s, torch.full_like(s, -1e30))
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bhqk,bkhe->bqhe", p, v.float()).to(cfg.dtype)
        x = x + torch.einsum("bshe,hed->bsd", out, self.attn.proj.kernel) \
            + self.attn.proj.bias
        h = self.ln2(x).to(cfg.dtype)
        h = F.gelu(h @ self.fc1.kernel + self.fc1.bias, approximate="tanh")
        return x + (h @ self.fc2.kernel + self.fc2.bias)


class Transformer(nn.Module):
    """Decoder-only GPT-2 producing f32 token logits (the LM head ties the
    token embedding)."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.wte = Embed(cfg.vocab_size, cfg.d_model, cfg.dtype, device)
        self.wpe = Embed(cfg.max_len, cfg.d_model, cfg.dtype, device)
        self.blocks = nn.ModuleList(
            Block(cfg, device) for _ in range(cfg.num_layers))
        self.ln_f = LayerNorm(cfg.d_model, 1e-6, device)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        S = tokens.shape[1]
        x = self.wte.embedding[tokens] \
            + self.wpe.embedding[torch.arange(S, device=tokens.device)][None]
        for blk in self.blocks:
            x = blk(x)
        x = self.ln_f(x)
        return (x.to(self.cfg.dtype) @ self.wte.embedding.T).float()


@torch.no_grad()
def init_gpt2_(model: Transformer, generator: torch.Generator) -> Transformer:
    """GPT-2 initialisation in place, drawn from ``generator`` (on the
    parameters' device): normal(0.02) kernels and token embedding,
    normal(0.01) position embedding, zero biases, unit LayerNorm
    scales."""
    for name, p in model.named_parameters():
        if name == "wpe.embedding":
            p.normal_(0.0, 0.01, generator=generator)
        elif name.endswith(("kernel", "embedding")):
            p.normal_(0.0, 0.02, generator=generator)
        elif name.endswith("scale"):
            p.fill_(1.0)
        else:
            p.zero_()
    return model


def create_gpt2(size: str = "medium", device=None,
                seed: Optional[int] = 0, **overrides) -> Transformer:
    """GPT-2 ``small|medium|large`` on ``device`` (cuda unless named),
    initialised from ``torch.Generator(device).manual_seed(seed)``;
    ``seed=None`` leaves the weights uninitialised for a load."""
    base = {"small": GPT2_SMALL, "medium": GPT2_MEDIUM,
            "large": GPT2_LARGE}[size]
    dev = resolve_device(device)
    model = Transformer(dataclasses.replace(base, **overrides), device=dev)
    if seed is not None:
        init_gpt2_(model, torch.Generator(device=dev).manual_seed(seed))
    return model
