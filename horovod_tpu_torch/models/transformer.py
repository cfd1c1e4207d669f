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
once).  ``moe_experts > 0`` makes every ``moe_every``-th block a
mixture of experts (``parallel/moe.py``), its experts sharded over
``expert_axis`` when that names a bound axis (E / n experts a rank,
``models/convert.py`` ``shard_experts`` slices a global state dict) and
replicated when it is None; each forward leaves one aux loss per MoE
block in ``Transformer.aux_losses`` (JAX's sown ``"losses"``), and
``remat`` recomputes an MoE block, its two alltoalls included, at the
same point of the backward on every rank without adding an entry.
``scan_layers`` has no counterpart (``models/convert.py`` unstacks its
parameter layout; JAX refuses it with ``moe_every > 1``).

Parameters are float32 and each is cast to ``cfg.dtype`` where it is
used, as flax's ``param_dtype=float32`` / ``dtype=cfg.dtype`` does: a
bf16 model computes its products in bf16 while the optimizer updates f32
weights.  LayerNorms, the softmax and the logits are f32.

Parameters keep the flax layouts and names, so a flax tree converts
leaf for leaf (``models/convert.py``) and the engine's einsums read
like the JAX adapter's:

* ``attn.qkv.kernel`` [d, 3, H, Dh], ``attn.qkv.bias`` [3, H, Dh];
* ``attn.proj.kernel`` [H, Dh, d];
* ``fc1``/``fc2`` kernels [in, out]; an MoE block has ``moe_gate``
  [d, E], ``moe_w_in`` [E_local, d, d_ff] and ``moe_w_out``
  [E_local, d_ff, d] in their place;
* ``wte.embedding`` [V, d], tied to the LM head; ``wpe.embedding``
  [max_len, d];
* LayerNorms hold ``scale`` and ``bias``.

While a timeline records (``timeline.ACTIVE``), the forward emits a span
for each region of the step: ``embed``, per block ``attn`` (ln1 through
the proj residual) and ``mlp`` (ln2 through the fc2 residual), with the
block's index, ``head`` (``ln_f``, the tied head, the f32 cast), and
``lm_loss`` its ``loss``.  The backward emits spans of the same names
with ``bwd`` in their args: a hook on each region's output, whose
gradient starts the region's backward, opens it and closes the region
open before it (the one whose input that tensor is), and the end of the
backward pass closes the last, ``embed``.  So the backward is covered
end to end, the caller's work between the loss and the head (a slice of
the logits) counted in ``loss``.  A checkpointed block's recompute, run
inside its backward, adds no span of its own.  With no timeline, no
hook is registered and nothing is emitted; inside an ``HVD_ANALYZE``
trace neither.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from .. import parallel as _parallel
from .. import timeline as _timeline
from ..analysis import graph_check as _gc
from ..parallel.flash import flash_attention
from ..parallel.moe import expert_parallel_ffn
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
    # Mixture-of-experts FFN (parallel/moe.py) in every moe_every-th
    # block when moe_experts > 0, experts sharded over expert_axis (None:
    # replicated), as the JAX config.
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_every: int = 2
    expert_axis: Optional[str] = None

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


def experts_per_rank(cfg: TransformerConfig) -> int:
    """E_local: ``moe_experts`` over the size of ``expert_axis`` (the
    axis resolved with ``parallel.axis``; all of them when it is
    None)."""
    n = 1
    if cfg.expert_axis:
        try:
            n = _parallel.axis(cfg.expert_axis).size
        except ValueError as e:
            raise ValueError(
                f"expert_axis={cfg.expert_axis!r} is not bound: build the "
                f"model with expert_axis=None for the global [E, ...] "
                f"expert weights, or make a mesh with the axis first "
                f"(make_mesh) and give each rank its experts "
                f"(models.convert.shard_experts)") from e
    if cfg.moe_experts % n:
        raise ValueError(f"moe_experts ({cfg.moe_experts}) must divide by "
                         f"the {cfg.expert_axis!r} axis size ({n})")
    return cfg.moe_experts // n


class _StepSpans:
    """The regions' spans on the running timeline (module doc).  One per
    process: the forward runs before its backward, and the backward of
    one step before the next forward."""

    TID, BWD_TID = "model", "model.bwd"

    def __init__(self):
        self.open = None          # (timeline, name, start ns, args)
        self.in_backward = False  # from the first backward hook to its end

    @staticmethod
    def timeline():
        """The running timeline, None when none records or inside an
        ``HVD_ANALYZE`` trace."""
        tl = _timeline.ACTIVE
        if tl is not None and _gc.active() is not None:
            return None
        return tl

    def region(self, tl, name: str, args: dict, fn, *inputs):
        """``fn(*inputs)`` as the region ``name``: its forward span, and
        a hook on its output (the first of a tuple) for its backward."""
        if self.in_backward:  # a checkpointed block's recompute
            return fn(*inputs)
        t0 = time.monotonic_ns()
        out = fn(*inputs)
        tl.span(name, t0, tid=self.TID, args=args)
        y = out[0] if isinstance(out, tuple) else out
        if y.requires_grad:
            y.register_hook(functools.partial(self._opened, tl, name, args))
        return out

    def _opened(self, tl, name, args, grad):
        now = time.monotonic_ns()
        if not self.in_backward:
            self.in_backward = True
            torch.autograd.Variable._execution_engine.queue_callback(
                self._ended)
        self._close(now)
        self.open = (tl, name, now, dict(args, bwd=True))

    def _close(self, now: int) -> None:
        if self.open is not None:
            tl, name, t0, args = self.open
            self.open = None
            tl.span(name, t0, tid=self.BWD_TID, args=args, end_mono_ns=now)

    def _ended(self) -> None:
        self._close(time.monotonic_ns())
        self.in_backward = False

    def reset(self) -> None:
        """Drop what a backward that never reached its end left open (a
        forward starts)."""
        self.open, self.in_backward = None, False


_SPANS = _StepSpans()


class Block(nn.Module):
    """ln1 → qkv → attention → proj residual → ln2 → fc1/gelu(tanh)/fc2
    residual, or with ``use_moe`` the mixture of experts in place of
    fc1/fc2.  ``forward`` returns the block's output and, for an MoE
    block, its ``MoEOutput`` (else None)."""

    def __init__(self, cfg: TransformerConfig, device=None,
                 use_moe: bool = False):
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
        self.use_moe = use_moe
        if use_moe:
            e_local = experts_per_rank(cfg)
            mk = lambda *s: nn.Parameter(  # noqa: E731
                torch.empty(s, device=device))
            self.moe_gate = mk(d, cfg.moe_experts)
            self.moe_w_in = mk(e_local, d, cfg.d_ff)
            self.moe_w_out = mk(e_local, cfg.d_ff, d)
            if cfg.expert_axis:
                for p in (self.moe_w_in, self.moe_w_out):
                    _parallel.mark_sharded(p, cfg.expert_axis)
        else:
            self.fc1 = Dense((d, cfg.d_ff), (cfg.d_ff,), device)
            self.fc2 = Dense((cfg.d_ff, d), (d,), device)

    def forward(self, x, index: int = 0, tl=None):
        """The block's output and its ``MoEOutput`` (or None); with a
        timeline ``tl``, as the regions ``attn`` and ``mlp`` of block
        ``index`` (module doc)."""
        if tl is None:
            return self._mlp(self._attn(x))
        args = {"block": index}
        x = _SPANS.region(tl, "attn", args, self._attn, x)
        return _SPANS.region(tl, "mlp", args, self._mlp, x)

    def _attn(self, x):
        """ln1 → qkv → attention → proj residual."""
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
        return x + (torch.einsum("bshe,hed->bsd", out, w) + b)

    def _mlp(self, x):
        """ln2 → fc1/gelu(tanh)/fc2 (or the mixture of experts) residual,
        and the ``MoEOutput`` (or None)."""
        cfg, dt = self.cfg, self.cfg.dtype
        h = self.ln2(x).to(dt)
        if self.use_moe:
            B, S, d = h.shape
            res = expert_parallel_ffn(
                h.reshape(B * S, d), self.moe_gate, self.moe_w_in.to(dt),
                self.moe_w_out.to(dt), axis_name=cfg.expert_axis,
                top_k=cfg.moe_top_k, capacity_factor=cfg.moe_capacity_factor)
            return x + res.out.view(B, S, d), res
        w, b = self.fc1.cast(dt)
        h = F.gelu(h @ w + b, approximate="tanh")
        w, b = self.fc2.cast(dt)
        return x + (h @ w + b), None


class Transformer(nn.Module):
    """Decoder-only (``causal``, GPT-2) or encoder (BERT) producing f32
    token logits (the LM head ties the token embedding).  After a
    forward, ``aux_losses`` holds each MoE block's Switch aux loss and
    ``dropped_fracs`` its share of dropped claims (detached), in block
    order (empty without MoE); ``sum(aux_losses)`` is JAX's
    ``sum(tree.leaves(losses))``."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.wte = Embed(cfg.vocab_size, cfg.d_model, device)
        self.wpe = Embed(cfg.max_len, cfg.d_model, device)
        self.blocks = nn.ModuleList(
            Block(cfg, device, use_moe=cfg.moe_experts > 0
                  and i % cfg.moe_every == cfg.moe_every - 1)
            for i in range(cfg.num_layers))
        self.ln_f = LayerNorm(cfg.d_model, 1e-6, device)
        self.aux_losses: list = []
        self.dropped_fracs: list = []

    def forward(self, tokens: torch.Tensor, *,
                positions: Optional[torch.Tensor] = None,
                predict_positions: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """``predict_positions`` ([B, K] int, BERT MLM): the final
        LayerNorm and the LM head run only at those K positions, giving
        [B, K, vocab] logits."""
        tl = _SPANS.timeline()
        if tl is None:
            x = self._embed(tokens, positions)
        else:
            _SPANS.reset()
            x = _SPANS.region(tl, "embed", {}, self._embed, tokens,
                              positions)
        # A checkpointed block's recompute runs inside the backward and
        # its outputs are dropped, so each MoE block records once.
        self.aux_losses, self.dropped_fracs = [], []
        for i, blk in enumerate(self.blocks):
            if self.cfg.remat and torch.is_grad_enabled():
                x, res = checkpoint(blk, x, i, tl, use_reentrant=False)
            else:
                x, res = blk(x, i, tl)
            if res is not None:
                self.aux_losses.append(res.aux_loss)
                self.dropped_fracs.append(res.dropped_frac.detach())
        if tl is None:
            return self._head(x, predict_positions)
        return _SPANS.region(tl, "head", {}, self._head, x,
                             predict_positions)

    def _embed(self, tokens: torch.Tensor,
               positions: Optional[torch.Tensor]) -> torch.Tensor:
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
        return self.wte.embedding[tokens].to(dt) \
            + self.wpe.embedding[positions].to(dt)

    def _head(self, x: torch.Tensor,
              predict_positions: Optional[torch.Tensor]) -> torch.Tensor:
        dt = self.cfg.dtype
        if predict_positions is not None:
            x = torch.take_along_dim(
                x, predict_positions.long()[..., None], dim=1)
        x = self.ln_f(x)
        return (x.to(dt) @ self.wte.embedding.to(dt).T).float()


def lm_loss(logits: torch.Tensor, targets: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token cross-entropy in f32 (BERT MLM or GPT next-token; the caller
    shifts targets for a causal LM); with ``mask``, the masked mean with
    the count floored at 1.  While a timeline records, the region
    ``loss`` (module doc)."""
    tl = _SPANS.timeline()
    if tl is None:
        return _lm_loss(logits, targets, mask)
    return _SPANS.region(tl, "loss", {}, _lm_loss, logits, targets, mask)


def _lm_loss(logits: torch.Tensor, targets: torch.Tensor,
             mask: Optional[torch.Tensor]) -> torch.Tensor:
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
    parameters' device): normal(0.02) kernels, expert weights and token
    embedding, normal(0.01) position embedding, zero biases, unit
    LayerNorm scales.  An expert-sharded weight takes this rank's slice
    of the global draw."""
    for name, p in model.named_parameters():
        if name == "wpe.embedding":
            p.normal_(0.0, 0.01, generator=generator)
        elif _parallel.sharded_axes(p):
            # This rank's slice of the global [E, ...] draw, so a sharded
            # model holds the experts of the replicated one.
            ax = _parallel.axis(_parallel.sharded_axes(p)[0])
            e = p.shape[0]
            full = torch.empty((e * ax.size,) + tuple(p.shape[1:]),
                               device=p.device)
            p.copy_(full.normal_(0.0, 0.02, generator=generator)[
                ax.index * e:(ax.index + 1) * e])
        elif name.endswith(("kernel", "embedding", "moe_gate", "moe_w_in",
                            "moe_w_out")):
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
