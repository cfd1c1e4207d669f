"""GPT-2 and BERT: the configurations, the weights and the forward pass
for training and for the serving engine's reference.

Port of ``horovod_tpu/models/transformer.py``: ``TransformerConfig``
with the GPT-2 and BERT sizes, ``create_gpt2`` / ``create_bert``, the
GPT-2/BERT initialisation, ``lm_loss``, and the ``Transformer`` module
with the training features of the JAX model — ``attention_impl`` None
(dense) or ``"flash"`` (the FlashAttention-2 kernels of
``parallel/flash.py``), ``remat`` (``torch.utils.checkpoint`` per block),
``predict_positions`` (the LM head only at the gathered masked
positions) and ``seq_parallel`` over the mesh axis ``axis_name``:
``'ring'`` / ``'ring_striped'`` (``parallel/ring.py``: the flash ring
under ``attention_impl='flash'``, else the einsum ring) and
``'ulysses'`` (``parallel/ulysses.py``, the flash kernels as the local
attention under flash).  The tokens are then this rank's sequence
shard, and positions default to the shard's global ones.  ``remat``
with ``seq_parallel`` recomputes a block's rotations or exchanges at
the block's first unpack in the backward, which on every rank comes
after the whole backward of the next block, so every rank runs them in
one order (the recomputed graph is dropped: the inverse rotations run
once).  MoE is not here yet (ROADMAP A6); ``scan_layers`` has no counterpart
(``models/convert.py`` unstacks its parameter layout).

Parameters are float32 and each is cast to ``cfg.dtype`` where it is
used, as flax's ``param_dtype=float32`` / ``dtype=cfg.dtype`` does: a
bf16 model computes its products in bf16 while the optimizer updates f32
weights.  LayerNorms, the softmax and the logits are f32.

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
from torch.utils.checkpoint import checkpoint

from .. import parallel as _parallel
from ..parallel.flash import flash_attention
from ..parallel.ring import (ring_attention, ring_flash_attention,
                             striped_positions)
from ..parallel.ulysses import ulysses_attention
from ..utils.device import resolve_device

SEQ_PARALLEL = (None, "ring", "ring_striped", "ulysses")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 50257
    num_layers: int = 12
    num_heads: int = 12
    d_model: int = 768
    d_ff: int = 3072
    max_len: int = 1024
    causal: bool = True              # GPT style; False = BERT style
    dtype: torch.dtype = torch.bfloat16  # compute type, as in the JAX configs
    attention_impl: Optional[str] = None  # None (dense) | 'flash' (kernels)
    remat: bool = False
    axis_name: str = "hvd"
    seq_parallel: Optional[str] = None   # None|'ring'|'ring_striped'|'ulysses'
    # The ring's hop schedule (parallel/ring.py SCHEDULES); the JAX
    # model always runs the default, "overlap".
    ring_schedule: str = "overlap"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


GPT2_SMALL = TransformerConfig(num_layers=12, num_heads=12, d_model=768,
                               d_ff=3072)
GPT2_MEDIUM = TransformerConfig(num_layers=24, num_heads=16, d_model=1024,
                                d_ff=4096)
GPT2_LARGE = TransformerConfig(num_layers=36, num_heads=20, d_model=1280,
                               d_ff=5120)
BERT_BASE = TransformerConfig(vocab_size=30522, num_layers=12, num_heads=12,
                              d_model=768, d_ff=3072, max_len=512,
                              causal=False)
BERT_LARGE = TransformerConfig(vocab_size=30522, num_layers=24, num_heads=16,
                               d_model=1024, d_ff=4096, max_len=512,
                               causal=False)


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
    """An f32 kernel of any shape ``in_shape + out_shape`` and its bias;
    :meth:`cast` gives both in the compute dtype."""

    def __init__(self, kernel_shape, bias_shape, device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(kernel_shape, device=device))
        self.bias = nn.Parameter(torch.zeros(bias_shape, device=device))

    def cast(self, dtype):
        return self.kernel.to(dtype), self.bias.to(dtype)


class Embed(nn.Module):
    def __init__(self, n: int, d: int, device=None):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty((n, d), device=device))


def dense_attention(q, k, v, causal: bool) -> torch.Tensor:
    """Softmax attention over [B, S, H, D] in f32, output in q's dtype
    (``ring_attention_reference`` of the JAX package)."""
    S = q.shape[1]
    s = torch.einsum("bqhe,bkhe->bhqk", q.float(), k.float()) \
        / math.sqrt(q.shape[-1])
    if causal:
        keep = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = torch.where(keep, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhe->bqhe", p, v.float()).to(q.dtype)


def _local_flash(q, k, v, *, causal, scale=None):
    return flash_attention(q, k, v, causal=causal, scale=scale)


class Block(nn.Module):
    """ln1 → qkv → attention → proj residual → ln2 → fc1/gelu(tanh)/fc2
    residual."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        d, H, Dh = cfg.d_model, cfg.num_heads, cfg.head_dim
        if cfg.attention_impl not in (None, "flash"):
            raise ValueError(
                f"unknown attention_impl {cfg.attention_impl!r}; "
                f"expected None or 'flash'")
        if cfg.seq_parallel not in SEQ_PARALLEL:
            raise ValueError(f"unknown seq_parallel {cfg.seq_parallel!r}; "
                             f"expected one of {SEQ_PARALLEL}")
        self.cfg = cfg
        self.ln1 = LayerNorm(d, 1e-5, device)
        self.attn = nn.Module()
        self.attn.qkv = Dense((d, 3, H, Dh), (3, H, Dh), device)
        self.attn.proj = Dense((H, Dh, d), (d,), device)
        self.ln2 = LayerNorm(d, 1e-5, device)
        self.fc1 = Dense((d, cfg.d_ff), (cfg.d_ff,), device)
        self.fc2 = Dense((cfg.d_ff, d), (d,), device)

    def forward(self, x):
        cfg, dt = self.cfg, self.cfg.dtype
        h = self.ln1(x).to(dt)
        w, b = self.attn.qkv.cast(dt)
        qkv = torch.einsum("bsd,dthe->bsthe", h, w) + b
        q, k, v = qkv.unbind(dim=2)                       # [B, S, H, Dh]
        flash = cfg.attention_impl == "flash"
        if cfg.seq_parallel in ("ring", "ring_striped"):
            ring = ring_flash_attention if flash else ring_attention
            out = ring(q, k, v, axis_name=cfg.axis_name, causal=cfg.causal,
                       striped=cfg.seq_parallel == "ring_striped",
                       schedule=cfg.ring_schedule)
        elif cfg.seq_parallel == "ulysses":
            out = ulysses_attention(
                q, k, v, axis_name=cfg.axis_name, causal=cfg.causal,
                attention_fn=_local_flash if flash else None)
        elif flash:
            out = flash_attention(q, k, v, causal=cfg.causal)
        else:
            out = dense_attention(q, k, v, cfg.causal)
        w, b = self.attn.proj.cast(dt)
        x = x + (torch.einsum("bshe,hed->bsd", out, w) + b)
        h = self.ln2(x).to(dt)
        w, b = self.fc1.cast(dt)
        h = F.gelu(h @ w + b, approximate="tanh")
        w, b = self.fc2.cast(dt)
        return x + (h @ w + b)


class Transformer(nn.Module):
    """Decoder-only (``causal``, GPT-2) or encoder (BERT) producing f32
    token logits (the LM head ties the token embedding)."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.wte = Embed(cfg.vocab_size, cfg.d_model, device)
        self.wpe = Embed(cfg.max_len, cfg.d_model, device)
        self.blocks = nn.ModuleList(
            Block(cfg, device) for _ in range(cfg.num_layers))
        self.ln_f = LayerNorm(cfg.d_model, 1e-6, device)

    def forward(self, tokens: torch.Tensor, *,
                positions: Optional[torch.Tensor] = None,
                predict_positions: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """``predict_positions`` ([B, K] int, BERT MLM): the final
        LayerNorm and the LM head run only at those K positions, giving
        [B, K, vocab] logits."""
        cfg, dt, S = self.cfg, self.cfg.dtype, tokens.shape[1]
        if positions is None and cfg.seq_parallel == "ring_striped":
            # This shard holds global tokens [i, i + n, i + 2n, ...].
            positions = striped_positions(S, axis_name=cfg.axis_name,
                                          device=tokens.device)[None]
        elif positions is None:
            positions = torch.arange(S, device=tokens.device)[None]
            if cfg.seq_parallel is not None:
                # Contiguous shards: this one holds [i·S, (i + 1)·S).
                positions = positions + \
                    _parallel.axis(cfg.axis_name).index * S
        x = self.wte.embedding[tokens].to(dt) \
            + self.wpe.embedding[positions].to(dt)
        for blk in self.blocks:
            if self.cfg.remat and torch.is_grad_enabled():
                x = checkpoint(blk, x, use_reentrant=False)
            else:
                x = blk(x)
        if predict_positions is not None:
            x = torch.take_along_dim(
                x, predict_positions.long()[..., None], dim=1)
        x = self.ln_f(x)
        return (x.to(dt) @ self.wte.embedding.to(dt).T).float()


def lm_loss(logits: torch.Tensor, targets: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token cross-entropy in f32 (BERT MLM or GPT next-token; the caller
    shifts targets for a causal LM); with ``mask``, the masked mean with
    the count floored at 1."""
    losses = F.cross_entropy(
        logits.float().reshape(-1, logits.shape[-1]),
        targets.reshape(-1).long(), reduction="none").view(targets.shape)
    if mask is not None:
        mask = mask.float()
        return (losses * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return losses.mean()


@torch.no_grad()
def init_gpt2_(model: Transformer, generator: torch.Generator) -> Transformer:
    """GPT-2 / BERT initialisation in place, drawn from ``generator`` (on the
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


def _create(base: TransformerConfig, device, seed, overrides
            ) -> Transformer:
    dev = resolve_device(device)
    model = Transformer(dataclasses.replace(base, **overrides), device=dev)
    if seed is not None:
        init_gpt2_(model, torch.Generator(device=dev).manual_seed(seed))
    return model


def create_gpt2(size: str = "medium", device=None,
                seed: Optional[int] = 0, **overrides) -> Transformer:
    """GPT-2 ``small|medium|large`` (bf16 compute, f32 parameters, as the
    JAX configs) on ``device`` (cuda unless named),
    initialised from ``torch.Generator(device).manual_seed(seed)``;
    ``seed=None`` leaves the weights uninitialised for a load."""
    base = {"small": GPT2_SMALL, "medium": GPT2_MEDIUM,
            "large": GPT2_LARGE}[size]
    return _create(base, device, seed, overrides)


def create_bert(size: str = "large", device=None,
                seed: Optional[int] = 0, **overrides) -> Transformer:
    """BERT ``base|large`` (bf16 compute, f32 parameters), as
    :func:`create_gpt2`."""
    base = {"base": BERT_BASE, "large": BERT_LARGE}[size]
    return _create(base, device, seed, overrides)
