"""Continuous-batching inference engine over the port's GPT-2 and MLP.

Port of the serving core of ``horovod_tpu/serve/engine.py``: the design
is Orca's iteration-level scheduling with vLLM's block-paged KV storage
and Sarathi-Serve's chunked prefill.

* **paged KV cache** — a pool of fixed-size blocks
  (``HVD_SERVE_BLOCK_TOKENS`` positions each, ``serve/blocks.py``); a
  sequence holds the blocks its tokens occupy and addresses them through
  a block table, so admission is bounded by free blocks.  Attention over
  the tables runs in the hand-written CUDA paged-attention kernel
  (``attn_impl="kernel"``, the default on a card) or in its plain
  PyTorch version (``"gather"``, the default on the CPU).  Block storage
  may be int8/fp8 with append-time scale rows (``HVD_SERVE_KV_DTYPE``);
* **chunked prefill** — prompts stream through the per-iteration token
  budget ``HVD_SERVE_PREFILL_CHUNK``;
* **prefix caching** — full prompt blocks are content-hashed and shared
  (copy-on-write protects shared blocks from writes);
* **slot mode** (``kv_mode="slot"``) — the contiguous
  ``[L, max_batch, max_len, H, Dh]`` layout with dense f32 attention,
  for adapters without a paged interface; ``auto`` picks paged when the
  adapter can page;
* **the decode-algorithm layer** (paged mode) — seeded sampling
  (temperature / top-k / top-p, ``serve/sampling.py``), n > 1 forks that
  prefill the prompt once and decode through copy-on-write block tables
  (``_ForkGroup``), and speculative decoding (``spec_k`` /
  ``HVD_SERVE_SPEC_K``: a truncated-stack draft proposes k tokens, the
  target verifies k + 1 positions in one chunk step, ``_spec_once``);
* **the request surface** (paged mode) — per-token logprobs and
  ``score_tokens`` (``/score``), streamed tokens (``Request.sink``,
  ``serve/streaming.py``), grammar-constrained decoding
  (``serve/structured.py``), several resident models sharing the slots
  and the pool (``add_model`` / ``swap_model``, ``serve/registry.py``),
  warmup at every start, and the ``engine.step`` fault-injection point
  (``faultline``).  Rows with a grammar or logprobs decode in host
  mode: a prefill step brings their raw logits to the host
  (``prefill_chunk_logits``) for the mask and the logprob entry; a
  decode step keeps them on the device (``decode_paged_logits``), draws
  there under the masks and brings only the logprob rows to the host.

Exactness: every per-sequence computation is row-independent —
positions past a sequence's length are masked to weight 0 and
block-table holes carry the out-of-bounds sentinel ``NB`` (the scatter
drops those rows, the attention skips them), and every random draw is
keyed by (seed, sample, position) — so a request receives the same
tokens alone or packed in a batch, greedy or sampled with the same seed.
Chunk batches keep the JAX adapter's power-of-two padding and decode
runs at the fixed ``max_batch`` width, which pins the shapes that
contract holds at.  Greedy speculative decoding emits the tokens of
greedy decoding.

``MLPAdapter`` is the engine-mechanics model: next token =
argmax MLP(one_hot(token)), no cache, and its own perfect draft.

Not ported yet (later slices): tiering, sequence-parallel prefill and
request tracing.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.nn import functional as F

from ..faultline import runtime as _faultline
from ..faultline.plan import FaultInjected
from ..models.transformer import layer_norm
from ..utils import get_logger
from ..utils.device import resolve_device
from . import paged_attention as _pa
from . import sampling as _sampling
from .batcher import (DeadlineExceededError, DynamicBatcher, Request,
                      bucket_requests, prompt_bucket)
from .blocks import BlockManager, NoFreeBlocksError, chain_hashes
from .metrics import ServeMetrics

_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _next_pow2(n: int, floor: int = 1) -> int:
    b = max(floor, 1)
    while b < n:
        b *= 2
    return b


def byte_token_strings(vocab_size: int) -> Optional[List[str]]:
    """Token id → emitted text, the vocabulary structured decoding
    builds its grammar masks over (``serve/structured.py``): a
    byte-level vocabulary (``vocab_size <= 256``) maps each id to its
    character, as JAX's ``ModelAdapter.token_strings``
    (``horovod_tpu/serve/engine.py:136``); a larger vocabulary has no
    token strings here (None), so a ``schema`` request fails with HTTP
    400 rather than constrain against a fictional mapping."""
    if vocab_size <= 256:
        return [chr(i) for i in range(vocab_size)]
    return None


# ---------------------------------------------------------------------------
# Model adapter
# ---------------------------------------------------------------------------

class TransformerAdapter:
    """Paged KV-cache decoding for the port's GPT-2 parameters.

    Runs the block math (ln1 → qkv → paged attention → proj residual →
    ln2 → fc1/gelu/fc2 residual; f32 LayerNorm islands, tied LM head) as
    plain functions over the weights, with an explicit per-layer block
    pool ``[L, NB, BT, H, Dh]`` the ``nn.Module`` doesn't carry.
    ``params`` is a ``models.Transformer`` or its ``state_dict`` (e.g.
    from ``models.params_from_jax``).  Serving math runs in
    ``HVD_SERVE_DTYPE`` (f32 by default).

    ``attn_impl`` (``HVD_SERVE_ATTN_IMPL``): ``kernel`` — the CUDA
    paged-attention kernel on a card, its plain version on the CPU;
    ``gather`` — the plain version everywhere; ``auto`` (default) —
    ``kernel`` on CUDA, ``gather`` on the CPU.

    ``kv_dtype`` (``HVD_SERVE_KV_DTYPE``): ``native`` (the compute dtype,
    default), ``f32``/``bf16``, or ``int8``/``fp8`` quantized blocks with
    per-(position, head) f16 scale rows written at append time.

    ``draft_layers`` (``HVD_SERVE_DRAFT_LAYERS``, default 0): the
    speculative draft is the first ``draft_layers`` blocks plus the
    final LayerNorm and the tied head, sharing the target's weights and
    block pool (its layer-l K/V at a verified position is the same math
    the target writes there, so a rejected draft leaves nothing to
    reconcile); 0 disables it (``spec_capable`` False).

    The pool is updated in place: the JAX adapter donates the pool to
    each jitted step and writes it with ``.at[].set``; here the scatter
    is an ``index_put_`` and the CoW block copy a ``copy_`` into the
    same tensors.  Slot mode (``init_cache`` / ``prefill`` /
    ``decode``) runs dense f32 attention over a contiguous
    ``[L, B, max_len, H, Dh]`` cache, in plain PyTorch: the JAX package
    has no kernel there.
    """

    kv_token_cost = 1  # cache positions consumed per token

    def __init__(self, cfg, params, max_len: Optional[int] = None,
                 block_tokens: Optional[int] = None,
                 attn_impl: Optional[str] = None,
                 kv_dtype: Optional[str] = None,
                 draft_layers: Optional[int] = None,
                 device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.vocab_size = cfg.vocab_size
        self.max_len = min(max_len or cfg.max_len, cfg.max_len)
        self.num_layers = cfg.num_layers
        self.num_heads = cfg.num_heads
        self.head_dim = cfg.d_model // cfg.num_heads
        self.block_tokens = int(
            block_tokens if block_tokens is not None
            else os.environ.get("HVD_SERVE_BLOCK_TOKENS", "16"))
        dtype = _DTYPES[os.environ.get("HVD_SERVE_DTYPE", "f32")]
        self._dtype = dtype
        state = (params.state_dict() if isinstance(params, torch.nn.Module)
                 else params)
        self.params = self._layout(state)
        impl = (attn_impl if attn_impl is not None
                else os.environ.get("HVD_SERVE_ATTN_IMPL", "auto")).lower()
        if impl == "auto":
            impl = "kernel" if self.device.type == "cuda" else "gather"
        if impl not in ("gather", "kernel"):
            raise ValueError(
                f"attn_impl must be gather|kernel|auto, got {impl!r}")
        self.attn_impl = impl
        kvd = (kv_dtype if kv_dtype is not None
               else os.environ.get("HVD_SERVE_KV_DTYPE", "native")).lower()
        if kvd not in ("native", "f32", "bf16") and kvd not in _pa.KV_DTYPES:
            raise ValueError(
                f"kv_dtype must be native|f32|bf16|int8|fp8, got {kvd!r}")
        self.kv_dtype = kvd
        self._kv_quantized = kvd in ("int8", "fp8")
        self._kv_store_dtype = {
            "native": dtype, "f32": torch.float32, "bf16": torch.bfloat16,
            "int8": torch.int8, "fp8": torch.float8_e4m3fn}[kvd]
        dl = (draft_layers if draft_layers is not None
              else int(os.environ.get("HVD_SERVE_DRAFT_LAYERS", "0")))
        if not 0 <= dl < self.num_layers:
            raise ValueError(
                f"draft_layers must be in [0, num_layers), got {dl} "
                f"(num_layers {self.num_layers})")
        self.draft_layers = dl

    @property
    def spec_capable(self) -> bool:
        """True when a draft stack is configured (draft_layers >= 1)."""
        return self.draft_layers > 0

    def _layout(self, state) -> dict:
        """Weights on the device in the serving dtype, per layer, with the
        qkv / proj kernels flattened to plain matrices (the same memory
        order as the flax einsums)."""
        def t(name):
            return state[name].detach().to(device=self.device,
                                           dtype=self._dtype)

        def ln(prefix):
            return {"scale": t(f"{prefix}.scale"), "bias": t(f"{prefix}.bias")}

        blocks = []
        for i in range(self.num_layers):
            p = f"blocks.{i}"
            blocks.append({
                "ln1": ln(f"{p}.ln1"), "ln2": ln(f"{p}.ln2"),
                "qkv_w": t(f"{p}.attn.qkv.kernel").flatten(1),
                "qkv_b": t(f"{p}.attn.qkv.bias").flatten(),
                "proj_w": t(f"{p}.attn.proj.kernel").flatten(0, 1),
                "proj_b": t(f"{p}.attn.proj.bias"),
                "fc1_w": t(f"{p}.fc1.kernel"), "fc1_b": t(f"{p}.fc1.bias"),
                "fc2_w": t(f"{p}.fc2.kernel"), "fc2_b": t(f"{p}.fc2.bias"),
            })
        return {"wte": t("wte.embedding"), "wpe": t("wpe.embedding"),
                "ln_f": ln("ln_f"), "blocks": blocks}

    def weight_bytes(self) -> int:
        """Device bytes of the weights this adapter serves from."""
        seen, total = set(), 0
        stack = [self.params]
        while stack:
            node = stack.pop()
            if isinstance(node, dict):
                stack.extend(node.values())
            elif isinstance(node, list):
                stack.extend(node)
            elif id(node) not in seen:
                seen.add(id(node))
                total += node.numel() * node.element_size()
        return total

    # -- cache --------------------------------------------------------------

    @property
    def max_blocks_per_seq(self) -> int:
        return -(-self.max_len // self.block_tokens)

    def init_cache(self, max_batch: int):
        """Slot-mode cache ``[L, max_batch, max_len, H, Dh]`` in the
        compute dtype."""
        shape = (self.num_layers, max_batch, self.max_len, self.num_heads,
                 self.head_dim)
        return {"k": torch.zeros(shape, dtype=self._dtype,
                                 device=self.device),
                "v": torch.zeros(shape, dtype=self._dtype,
                                 device=self.device)}

    def init_paged_cache(self, num_blocks: int, max_batch: int):
        """Block pool ``[L, num_blocks, block_tokens, H, Dh]`` (plus scale
        pools ``[L, num_blocks, block_tokens, H]`` when quantized)."""
        return self._pool_arrays(num_blocks)

    def _pool_arrays(self, num_blocks: int) -> Dict[str, torch.Tensor]:
        shape = (self.num_layers, num_blocks, self.block_tokens,
                 self.num_heads, self.head_dim)
        pool = {"k": torch.zeros(shape, dtype=self._kv_store_dtype,
                                 device=self.device),
                "v": torch.zeros(shape, dtype=self._kv_store_dtype,
                                 device=self.device)}
        if self._kv_quantized:
            for key in ("k_scale", "v_scale"):
                pool[key] = torch.zeros(shape[:-1], dtype=_pa.SCALE_DTYPE,
                                        device=self.device)
        return pool

    def paged_block_bytes(self) -> int:
        """Device bytes one physical block costs across all layers (K + V
        payload plus scale rows when quantized)."""
        per_tok_head = _pa.kv_bytes_per_token(
            self.kv_dtype if self._kv_quantized else "native",
            self.head_dim, self._kv_store_dtype)
        return (self.num_layers * 2 * self.block_tokens * self.num_heads
                * per_tok_head)

    def _write_rows(self, wblk: np.ndarray, woff: np.ndarray, nb: int):
        """Device index tensors for the scatter of the rows whose block is
        real.  Rows carrying the hole sentinel (``wblk >= NB``: padding
        rows, pad tails, inactive slots) are dropped HERE, on the host,
        before any index reaches the device — JAX's scatter drops them
        silently, torch's ``index_put_`` would raise or device-assert.
        ``nb`` comes from the pool argument, never from adapter state: an
        adapter may serve pools of several sizes."""
        keep = np.flatnonzero(wblk.reshape(-1) < nb)
        dev = self.device
        return (torch.as_tensor(keep, device=dev),
                torch.as_tensor(wblk.reshape(-1)[keep], device=dev),
                torch.as_tensor(woff.reshape(-1)[keep], device=dev))

    def _scatter(self, pool, layer: int, rows, k, v) -> None:
        """Append one layer's K/V rows into the pool, in place."""
        keep, wblk, woff = rows
        H, Dh = self.num_heads, self.head_dim
        k = k.reshape(-1, H, Dh)[keep]
        v = v.reshape(-1, H, Dh)[keep]
        if self._kv_quantized:
            kq, ks = _pa.quantize_kv(k, self.kv_dtype)
            vq, vs = _pa.quantize_kv(v, self.kv_dtype)
            pool["k"][layer, wblk, woff] = kq
            pool["v"][layer, wblk, woff] = vq
            pool["k_scale"][layer, wblk, woff] = ks
            pool["v_scale"][layer, wblk, woff] = vs
        else:
            pool["k"][layer, wblk, woff] = k.to(self._kv_store_dtype)
            pool["v"][layer, wblk, woff] = v.to(self._kv_store_dtype)

    def _paged_attend(self, q, pool, layer: int, tables, q_positions):
        """One layer's paged attention over the pool, either impl.  ``q``
        is [n, H, Dh] (decode) or [n, c, H, Dh] (prefill chunk);
        ``q_positions`` [n] is each row's first query position."""
        scale = 1.0 / math.sqrt(self.head_dim)
        ks = pool.get("k_scale")
        vs = pool.get("v_scale")
        ks = None if ks is None else ks[layer]
        vs = None if vs is None else vs[layer]
        if self.attn_impl == "kernel":
            fn = (_pa.paged_decode_attention if q.dim() == 3
                  else _pa.paged_prefill_attention)
            out = fn(q.contiguous(), pool["k"][layer], pool["v"][layer],
                     tables, q_positions, k_scale=ks, v_scale=vs,
                     scale=scale)
        else:
            out = _pa.paged_attention_reference(
                q, pool["k"][layer], pool["v"][layer], tables, q_positions,
                k_scale=ks, v_scale=vs, scale=scale)
        return out.to(self._dtype)

    # -- functional forward pieces -----------------------------------------

    def _ln(self, x, p, eps):
        return layer_norm(x, p["scale"], p["bias"], eps)

    def _ffn(self, x, blk):
        h = self._ln(x, blk["ln2"], 1e-5).to(self._dtype)
        h = F.gelu(h @ blk["fc1_w"] + blk["fc1_b"], approximate="tanh")
        return x + (h @ blk["fc2_w"] + blk["fc2_b"])

    def _qkv(self, x, blk):
        h = self._ln(x, blk["ln1"], 1e-5).to(self._dtype)
        qkv = (h @ blk["qkv_w"] + blk["qkv_b"]).unflatten(
            -1, (3, self.num_heads, self.head_dim))
        return qkv.unbind(dim=-3)

    def _proj(self, x, out, blk):
        return x + (out.flatten(-2) @ blk["proj_w"] + blk["proj_b"])

    def _logits(self, x):
        x = self._ln(x, self.params["ln_f"], 1e-6)  # flax LayerNorm eps
        return (x.to(self._dtype) @ self.params["wte"].T).float()

    def _embed(self, tokens: np.ndarray, pos: np.ndarray):
        dev = self.device
        pos = np.minimum(pos, self.max_len - 1)
        return (self.params["wte"][torch.as_tensor(tokens, device=dev)]
                + self.params["wpe"][torch.as_tensor(pos, device=dev)])

    # -- slot mode ------------------------------------------------------------

    def _dense_attend(self, q, k, v, valid):
        """Dense f32 softmax attention: ``q`` [n, q, H, Dh], ``k``/``v``
        [n, s, H, Dh]; ``valid`` broadcasts to [n, H, q, s].  Masked
        scores are -1e30, so their weight is exactly 0."""
        scale = 1.0 / math.sqrt(self.head_dim)
        s = torch.einsum("nqhe,nkhe->nhqk", q.float(), k.float()) * scale
        s = torch.where(valid, s, torch.tensor(-1e30, device=s.device))
        p = torch.softmax(s, dim=-1)
        return torch.einsum("nhqk,nkhe->nqhe", p, v.float()).to(self._dtype)

    @torch.no_grad()
    def prefill(self, cache, prompts, slots):
        """Slot-mode prompt phase: ``prompts[i]`` into cache row
        ``slots[i]``; returns ``(cache, first_tokens)`` (the argmax at
        each prompt's last position).  The batch pads to the JAX
        adapter's (power-of-two count, ``prompt_bucket`` length) bucket;
        padding rows compute but write nothing (JAX gives them slot
        index ``max_batch`` and its scatter drops them; here they are
        dropped on the host, since ``index_put_`` would raise)."""
        max_p = max(len(p) for p in prompts)
        if max_p > self.max_len:
            raise ValueError(f"prompt length {max_p} exceeds max_len "
                             f"{self.max_len}")
        n_bucket = _next_pow2(len(prompts))
        p_bucket = prompt_bucket(max_p, cap=self.max_len)
        tokens = np.zeros((n_bucket, p_bucket), np.int64)
        lengths = np.ones((n_bucket,), np.int64)
        for i, p in enumerate(prompts):
            tokens[i, :len(p)] = p
            lengths[i] = len(p)
        dev = self.device
        n = len(prompts)
        slot_t = torch.as_tensor(np.asarray(slots[:n], np.int64), device=dev)
        x = self._embed(tokens, np.arange(p_bucket))
        causal = torch.ones((p_bucket, p_bucket), dtype=torch.bool,
                            device=dev).tril()
        for layer, blk in enumerate(self.params["blocks"]):
            q, k, v = self._qkv(x, blk)                  # [n, P, H, Dh]
            cache["k"][layer, slot_t, :p_bucket] = k[:n].to(cache["k"].dtype)
            cache["v"][layer, slot_t, :p_bucket] = v[:n].to(cache["v"].dtype)
            out = self._dense_attend(q, k, v, causal)
            x = self._ffn(self._proj(x, out, blk), blk)
        last = torch.as_tensor(np.maximum(lengths - 1, 0), device=dev)
        logits = self._logits(x[torch.arange(n_bucket, device=dev), last])
        return cache, logits.argmax(dim=-1).cpu().numpy()[:n]

    @torch.no_grad()
    def decode(self, cache, tokens, positions):
        """One slot-mode token step for the whole slot batch: feed
        ``tokens[b]`` at ``positions[b]`` (the cache index its K/V lands
        at); attention over the row's cache positions <= its own.
        Returns ``(cache, next_tokens[max_batch])``; inactive rows carry
        token 0 at position 0 and their output is ignored."""
        S = self.max_len
        pos = np.minimum(np.asarray(positions, np.int64), S - 1)
        x = self._embed(np.asarray(tokens, np.int64), pos)     # [B, d]
        dev = self.device
        pos_t = torch.as_tensor(pos, device=dev)
        rows = torch.arange(len(pos), device=dev)
        valid = (torch.arange(S, device=dev)[None, :]
                 <= pos_t[:, None])[:, None, None, :]          # [B,1,1,S]
        for layer, blk in enumerate(self.params["blocks"]):
            q, k, v = self._qkv(x, blk)                         # [B, H, Dh]
            cache["k"][layer, rows, pos_t] = k.to(cache["k"].dtype)
            cache["v"][layer, rows, pos_t] = v.to(cache["v"].dtype)
            out = self._dense_attend(q[:, None], cache["k"][layer],
                                     cache["v"][layer], valid)[:, 0]
            x = self._ffn(self._proj(x, out, blk), blk)
        return cache, self._logits(x).argmax(dim=-1).cpu().numpy()

    # -- chunked prefill ------------------------------------------------------

    def _chunk_body(self, cache, tokens: np.ndarray, starts: np.ndarray,
                    lengths: np.ndarray, tables: np.ndarray):
        """Scatter + attend for one chunk batch; returns the final hidden
        states ``x`` [n, c, d] at every chunk position.  ``tokens`` [n, c]
        (one prompt chunk per row), ``starts`` [n] (absolute position of
        ``tokens[i, 0]``), ``lengths`` [n] (real chunk length), ``tables``
        [n, MB] (entry NB = hole)."""
        BT, MB = self.block_tokens, self.max_blocks_per_seq
        n, c = tokens.shape
        nb = int(cache["k"].shape[1])
        pos = starts[:, None].astype(np.int64) + np.arange(c)[None, :]
        in_chunk = np.arange(c)[None, :] < lengths[:, None]
        wblk = np.take_along_axis(tables, np.minimum(pos // BT, MB - 1),
                                  axis=1)
        wblk = np.where(in_chunk, wblk, nb)  # pad tail: dropped
        rows = self._write_rows(wblk, pos % BT, nb)
        x = self._embed(tokens, pos)
        dev = self.device
        tables_t = torch.as_tensor(tables, dtype=torch.int32, device=dev)
        starts_t = torch.as_tensor(starts, dtype=torch.int32, device=dev)
        for layer, blk in enumerate(self.params["blocks"]):
            q, k, v = self._qkv(x, blk)                  # [n, c, H, Dh]
            # The chunk's own K/V land in the pool BEFORE the attention, so
            # intra-chunk causality falls out of the positional mask.
            self._scatter(cache, layer, rows, k, v)
            out = self._paged_attend(q, cache, layer, tables_t, starts_t)
            x = self._ffn(self._proj(x, out, blk), blk)
        return x

    def _chunk_forward(self, cache, tokens, starts, lengths, tables):
        """Final-position LM logits [n, V] of each chunk row."""
        x = self._chunk_body(cache, tokens, starts, lengths, tables)
        last = torch.as_tensor(np.maximum(lengths - 1, 0), device=self.device)
        return self._logits(x[torch.arange(x.shape[0], device=self.device),
                              last])

    def _pack_chunk_args(self, cache, chunks, starts, tables):
        """Bucket and pad a chunk batch: the row count to a power of two,
        the chunk length to its ``prompt_bucket`` — the JAX adapter's
        compile-cache buckets, kept because they fix the matmul shapes
        the batched == single contract is pinned at.  Padding rows carry
        length 0 and all-hole tables."""
        n_bucket = _next_pow2(len(chunks))
        max_c = max(len(ch) for ch in chunks)
        c_bucket = prompt_bucket(max_c, cap=self.max_len)
        NB = int(cache["k"].shape[1])
        MB = self.max_blocks_per_seq
        tok = np.zeros((n_bucket, c_bucket), np.int64)
        st = np.zeros((n_bucket,), np.int64)
        ln = np.zeros((n_bucket,), np.int64)
        tab = np.full((n_bucket, MB), NB, np.int64)
        for i, (ch, s0, t) in enumerate(zip(chunks, starts, tables)):
            tok[i, :len(ch)] = ch
            st[i] = s0
            ln[i] = len(ch)
            tab[i, :len(t)] = t
        return tok, st, ln, tab

    @torch.no_grad()
    def prefill_chunk(self, cache, chunks, starts, tables):
        """One iteration's prompt chunks: ``chunks[i]`` continues sequence
        i's prompt at absolute position ``starts[i]`` with physical blocks
        ``tables[i]``.  Returns ``(cache, next_tokens)`` — the argmax at
        each chunk's last position; the pool is updated in place."""
        args = self._pack_chunk_args(cache, chunks, starts, tables)
        logits = self._chunk_forward(cache, *args)
        return cache, logits.argmax(dim=-1).cpu().numpy()[:len(chunks)]

    @torch.no_grad()
    def prefill_chunk_logits(self, cache, chunks, starts, tables):
        """``prefill_chunk`` returning each row's final-position LM logits
        [n, V] instead of their argmax — the sampled / n>1 first-token
        path: the engine draws the first generated token(s) on the host
        (an n-way fork draws n tokens from one logit row, each with its
        own key).  Greedy batches keep ``prefill_chunk``."""
        args = self._pack_chunk_args(cache, chunks, starts, tables)
        logits = self._chunk_forward(cache, *args)
        return cache, logits[:len(chunks)].cpu().numpy()

    @torch.no_grad()
    def verify_chunk(self, cache, chunks, starts, tables):
        """Speculative verify: ``chunks[i]`` (the row's last emitted token
        and its drafted tokens) through the FULL model in one chunk step,
        scattering their K/V, returning the LM logits at every chunk
        position [n, c, V] (c = the longest chunk).  ``logits[i, j]`` is
        the target distribution of the token at absolute position
        ``starts[i] + j + 1``.  The chunk pads to its ``prompt_bucket``
        like a prefill chunk, so on a card it runs the prefill route
        from a start that need not be block-aligned."""
        args = self._pack_chunk_args(cache, chunks, starts, tables)
        x = self._chunk_body(cache, *args)
        n, c = len(chunks), max(len(ch) for ch in chunks)
        return cache, self._logits(x)[:n, :c].cpu().numpy()

    @torch.no_grad()
    def prompt_logits(self, prompt: Sequence[int]) -> np.ndarray:
        """Final-position LM logits for ``prompt`` through the full paged
        pipeline on a throwaway pool (storage quantization and attention
        impl included)."""
        if not 0 < len(prompt) <= self.max_len:
            raise ValueError(f"prompt length {len(prompt)} outside "
                             f"(0, {self.max_len}]")
        MB = self.max_blocks_per_seq
        need = -(-len(prompt) // self.block_tokens)
        pool = self._pool_arrays(need)
        table = np.full((1, MB), need, np.int64)
        table[0, :need] = np.arange(need)
        logits = self._chunk_forward(
            pool, np.asarray(prompt, np.int64)[None], np.zeros(1, np.int64),
            np.asarray([len(prompt)], np.int64), table)
        return logits[0].cpu().numpy()

    @torch.no_grad()
    def score_logits(self, tokens: Sequence[int]) -> np.ndarray:
        """``prompt_logits`` at every position: the LM logits ``[T, V]``
        of ``tokens`` through the paged pipeline on a throwaway pool
        (``logits[p]`` is the distribution of the token at position
        ``p + 1``) — ``/score``'s forward.  It runs ``_chunk_body``, as
        ``verify_chunk`` does, so on a card the whole prompt is one
        chunk of the paged prefill kernel (JAX ``score_logits``,
        ``horovod_tpu/serve/engine.py:635``)."""
        if not 0 < len(tokens) <= self.max_len:
            raise ValueError(f"token count {len(tokens)} outside "
                             f"(0, {self.max_len}]")
        MB = self.max_blocks_per_seq
        need = -(-len(tokens) // self.block_tokens)
        pool = self._pool_arrays(need)
        table = np.full((1, MB), need, np.int64)
        table[0, :need] = np.arange(need)
        x = self._chunk_body(
            pool, np.asarray(tokens, np.int64)[None], np.zeros(1, np.int64),
            np.asarray([len(tokens)], np.int64), table)
        return self._logits(x)[0].cpu().numpy()

    def token_strings(self) -> Optional[List[str]]:
        return byte_token_strings(self.vocab_size)

    # -- paged decode -------------------------------------------------------

    def _paged_step_body(self, cache, tokens, positions, tables,
                         num_layers: Optional[int] = None):
        """The single-token paged decode forward through the first
        ``num_layers`` blocks (all by default; the draft runs fewer) and
        the LM head: ``tokens`` [B], ``positions`` [B] (the cache index
        this token's K/V lands at), ``tables`` [B, MB] (entry NB for
        holes and inactive rows).  Returns the LM logits [B, V]."""
        BT, MB = self.block_tokens, self.max_blocks_per_seq
        nb = int(cache["k"].shape[1])
        tables = np.asarray(tables, np.int64)
        pos = np.minimum(np.asarray(positions, np.int64), self.max_len - 1)
        wblk = np.take_along_axis(
            tables, np.minimum(pos // BT, MB - 1)[:, None], axis=1)[:, 0]
        rows = self._write_rows(wblk, pos % BT, nb)
        x = self._embed(np.asarray(tokens, np.int64), pos)   # [B, d]
        dev = self.device
        tables_t = torch.as_tensor(tables, dtype=torch.int32, device=dev)
        pos_t = torch.as_tensor(pos, dtype=torch.int32, device=dev)
        for layer, blk in enumerate(self.params["blocks"][:num_layers]):
            q, k, v = self._qkv(x, blk)                      # [B, H, Dh]
            self._scatter(cache, layer, rows, k, v)
            out = self._paged_attend(q, cache, layer, tables_t, pos_t)
            x = self._ffn(self._proj(x, out, blk), blk)
        return self._logits(x)

    @torch.no_grad()
    def decode_paged(self, cache, tokens, positions, tables):
        """One greedy token step for the whole (fixed-width) batch."""
        logits = self._paged_step_body(cache, tokens, positions, tables)
        return cache, logits.argmax(dim=-1).cpu().numpy()

    @torch.no_grad()
    def decode_paged_logits(self, cache, tokens, positions, tables,
                            on_device: bool = False):
        """``decode_paged`` returning each row's raw LM logits ``[B, V]``
        on the host instead of their argmax (JAX ``decode_paged_logits``,
        ``horovod_tpu/serve/engine.py:1019``); ``on_device`` keeps them
        on the adapter's device, where the engine's host-mode decode
        step (rows with a grammar mask or a logprobs request) draws."""
        logits = self._paged_step_body(cache, tokens, positions, tables)
        return cache, logits if on_device else logits.cpu().numpy()

    @torch.no_grad()
    def decode_paged_sampled(self, cache, tokens, positions, tables, keys,
                             temps, top_ks, top_ps):
        """One sampled token step for the whole batch: the forward of
        ``decode_paged``, then ``sampling.sample_batched`` on the device
        with per-row base keys and sampling parameters (one host-to-device
        copy of them, one device-to-host copy of the B tokens; the [B, V]
        logits stay on the device).  Rows with temperature 0 return the
        argmax, bit-identical to ``decode_paged``."""
        # The token this step emits OCCUPIES position fed + 1.  The copy
        # comes first: a host-to-device copy synchronizes the stream, and
        # after the forward it would hold the host until the forward ran.
        packed = torch.as_tensor(_sampling.pack_params(
            keys, np.asarray(positions, np.int64) + 1, temps, top_ks,
            top_ps), device=self.device)
        logits = self._paged_step_body(cache, tokens, positions, tables)
        return cache, _sampling.sample_batched(logits, packed).cpu().numpy()

    @torch.no_grad()
    def draft_decode(self, cache, tokens, positions, tables):
        """One draft proposal step: blocks ``0..draft_layers-1``, the
        final LayerNorm and the tied head, writing the draft's K/V for
        those layers into the same pool; returns the draft's argmax (a
        point-mass proposal, which keeps rejection sampling exact
        without shipping draft distributions to the host)."""
        if not self.spec_capable:
            raise ValueError(
                "no draft stack configured: set HVD_SERVE_DRAFT_LAYERS "
                ">= 1 (or pass draft_layers=) to enable speculative "
                "decoding")
        logits = self._paged_step_body(cache, tokens, positions, tables,
                                       self.draft_layers)
        return cache, logits.argmax(dim=-1).cpu().numpy()

    @torch.no_grad()
    def copy_block(self, cache, src: int, dst: int):
        """Copy-on-write data move: duplicate one physical block across all
        layers, in place (the BlockManager already moved the reference)."""
        for a in cache.values():
            a[:, dst].copy_(a[:, src])
        return cache


class MLPAdapter:
    """Cache-free stand-in model for engine-mechanics tests
    (``horovod_tpu/serve/engine.py:1147``): the next token is
    ``argmax(MLP(one_hot(token)))`` — a deterministic Markov chain over
    the vocab.  Serves in both modes; its paged interface consumes zero
    blocks (``kv_token_cost = 0``).  Sampling draws from
    ``softmax(MLP(one_hot(token)))`` through the same keyed sampler as
    the transformer, and the speculative draft is the model ITSELF
    (``draft_decode`` == greedy decode): a perfect proposer, so a spec
    run accepts every draft and makes one target call per k + 1 tokens.

    ``mlp`` is a ``models.MLP`` over ``vocab_size`` one-hot features
    ending in ``vocab_size`` logits (``create_mlp((hidden, vocab),
    in_features=vocab)``; flax weights convert through
    ``models.mlp_params_from_jax``); it runs on the device its
    parameters live on."""

    kv_token_cost = 0
    block_tokens = 1
    max_blocks_per_seq = 0
    spec_capable = True

    def __init__(self, mlp, vocab_size: int, max_len: int = 1024):
        self.mlp = mlp
        self.vocab_size = vocab_size
        self.max_len = max_len
        self.device = next(mlp.parameters()).device

    def weight_bytes(self) -> int:
        return sum(p.numel() * p.element_size()
                   for p in self.mlp.parameters())

    @torch.no_grad()
    def _logits_of(self, tokens) -> torch.Tensor:
        """f32 logits [..., V] of the next token after each of
        ``tokens``."""
        t = torch.as_tensor(np.asarray(tokens, np.int64), device=self.device)
        x = F.one_hot(t.reshape(-1), self.vocab_size).float()
        return self.mlp(x).float().reshape(*t.shape, self.vocab_size)

    def _next(self, tokens) -> np.ndarray:
        return self._logits_of(tokens).argmax(dim=-1).cpu().numpy()

    def init_cache(self, max_batch: int):
        return {}

    def init_paged_cache(self, num_blocks: int, max_batch: int):
        return {}

    def prefill(self, cache, prompts, slots):
        return cache, self._next([p[-1] for p in prompts])

    def prefill_chunk(self, cache, chunks, starts, tables):
        # The next token depends only on the chunk's last token; a
        # non-final chunk's output is ignored by the engine.
        return cache, self._next([ch[-1] for ch in chunks])

    def prefill_chunk_logits(self, cache, chunks, starts, tables):
        return cache, self._logits_of([ch[-1] for ch in chunks]).cpu().numpy()

    def verify_chunk(self, cache, chunks, starts, tables):
        # Markov chain: the logits at chunk position j depend only on the
        # chunk token at j.
        n, c = len(chunks), max(len(ch) for ch in chunks)
        tok = np.zeros((n, c), np.int64)
        for i, ch in enumerate(chunks):
            tok[i, :len(ch)] = ch
        return cache, self._logits_of(tok).cpu().numpy()

    def decode(self, cache, tokens, positions):
        return cache, self._next(tokens)

    def decode_paged(self, cache, tokens, positions, tables):
        return self.decode(cache, tokens, positions)

    def decode_paged_logits(self, cache, tokens, positions, tables,
                            on_device: bool = False):
        logits = self._logits_of(tokens)
        return cache, logits if on_device else logits.cpu().numpy()

    def prompt_logits(self, prompt) -> np.ndarray:
        # Markov chain: the final-position distribution depends only on
        # the last prompt token.
        return self._logits_of([prompt[-1]])[0].cpu().numpy()

    def score_logits(self, tokens) -> np.ndarray:
        if not 0 < len(tokens) <= self.max_len:
            raise ValueError(f"token count {len(tokens)} outside "
                             f"(0, {self.max_len}]")
        return self._logits_of(tokens).cpu().numpy()

    def token_strings(self) -> Optional[List[str]]:
        return byte_token_strings(self.vocab_size)

    def decode_paged_sampled(self, cache, tokens, positions, tables, keys,
                             temps, top_ks, top_ps):
        packed = torch.as_tensor(_sampling.pack_params(
            keys, np.asarray(positions, np.int64) + 1, temps, top_ks,
            top_ps), device=self.device)
        logits = self._logits_of(tokens)
        return cache, _sampling.sample_batched(logits, packed).cpu().numpy()

    def draft_decode(self, cache, tokens, positions, tables):
        # The draft IS the target (perfect proposer).
        return self.decode(cache, tokens, positions)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

class _Slot:
    """Slot-mode sequence state (contiguous per-slot cache rows)."""
    __slots__ = ("request", "length")

    def __init__(self, request: Request, length: int):
        self.request = request
        self.length = length  # prompt + generated so far (cache positions)


class _Seq:
    """Paged-mode sequence state.

    ``generated`` is the authoritative token list of THIS sequence: for
    an n == 1 request it IS ``request.generated``, for a member of an
    n > 1 fork family it is the member's own stream, copied into
    ``request.samples[sample_index]`` at retirement.  ``parked`` marks a
    fork slot reserved at admission but not yet activated (the prompt is
    still prefilling through the family's primary)."""
    __slots__ = ("request", "length", "prompt_pos", "table", "hashes",
                 "admit_seq", "published", "generated", "group",
                 "sample_index", "base_key", "parked", "gstate")

    def __init__(self, request: Request, cached_tokens: int,
                 table: List[int], hashes: List[int], admit_seq: int):
        self.request = request
        self.length = cached_tokens      # tokens with K/V in the pool
        self.prompt_pos = cached_tokens  # prompt tokens consumed so far
        self.table = table               # physical block ids, logical order
        self.hashes = hashes             # prompt full-block chain hashes
        self.admit_seq = admit_seq       # admission order (preempt youngest)
        self.published = 0               # prefix-registered block watermark
        self.generated = request.generated  # n>1 members get own lists
        self.group: Optional[_ForkGroup] = None
        self.sample_index = 0
        self.base_key: Optional[np.ndarray] = None  # sampled only
        self.parked = False              # reserved fork slot, pre-activation
        # Structured decoding: the grammar automaton's state AFTER the
        # tokens in ``generated``.  A requeue builds a fresh _Seq, so a
        # replay restarts from the grammar's start with its empty list.
        self.gstate = (request.grammar.start
                       if request.grammar is not None else None)

    @property
    def decoding(self) -> bool:
        return not self.parked and self.prompt_pos >= len(self.request.prompt)


class _ForkGroup:
    """One n>1 request's fork family (``engine.py:1335``): the primary
    (sample 0) prefills the prompt once; at prompt completion the family
    forks — every member maps the shared full prompt blocks through its
    own CoW block table and decodes on its own.  The request completes
    when the LAST member retires; preemption, expiry and drain treat the
    family as one unit.

    ``reserve`` is the family's not-yet-allocated worst-case decode
    footprint — the (n-1) fork tails admission COUNTED but did not
    allocate; ``_admit_paged`` takes the live families' reserves off the
    pool budget so a later admission round cannot hand those blocks to
    someone else, and each fork-side allocation consumes one unit."""
    __slots__ = ("request", "seqs", "completed", "forked", "reserve",
                 "reserve_cap")

    def __init__(self, request: Request):
        self.request = request
        self.seqs: List[_Seq] = []
        self.completed = 0
        self.forked = False
        self.reserve = 0
        self.reserve_cap = 0  # admission-time value; refunds never exceed it


class InferenceEngine:
    """One continuous-batching decode loop (one per serving replica).

    Owns the model adapter, the slot table, the KV storage (block pool
    and its BlockManager in paged mode, the contiguous cache in slot
    mode), and a worker thread running admit → prefill → decode until
    stopped.  Completion is per request (batcher.Request events).
    """

    def __init__(self, adapter,
                 batcher: Optional[DynamicBatcher] = None,
                 metrics: Optional[ServeMetrics] = None,
                 max_batch: Optional[int] = None,
                 replica_id: str = "replica-0",
                 kv_mode: Optional[str] = None,
                 num_blocks: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 prefix_cache: Optional[bool] = None,
                 spec_k: Optional[int] = None,
                 warmup: Optional[bool] = None):
        self.adapter = adapter
        # Multi-model residency (serve/registry.py): named variants
        # sharing this engine's slots and paged pool.  ``adapter`` stays
        # the default variant's; a request's ``model`` resolves through
        # _adapter_for.  Versions salt the prefix hashes, so cached K/V
        # never crosses a weight boundary.
        self.default_model = "default"
        self._adapters: Dict[str, object] = {self.default_model: adapter}
        self._model_versions: Dict[str, int] = {self.default_model: 0}
        self.max_batch = max_batch if max_batch is not None else int(
            os.environ.get("HVD_SERVE_MAX_BATCH", "8"))
        self.batcher = batcher or DynamicBatcher()
        self.metrics = metrics or ServeMetrics()
        if self.batcher._on_shed is None:
            self.batcher._on_shed = \
                lambda req, why: self.metrics.count_request(
                    why, tenant=req.tenant)
        self.replica_id = replica_id
        mode = (kv_mode or os.environ.get("HVD_SERVE_KV_MODE",
                                          "auto")).lower()
        paged_capable = all(
            hasattr(adapter, m)
            for m in ("init_paged_cache", "prefill_chunk", "decode_paged"))
        if mode == "auto":
            mode = "paged" if paged_capable else "slot"
        if mode not in ("paged", "slot"):
            raise ValueError(f"kv_mode must be paged|slot|auto, got {mode}")
        if mode == "paged" and not paged_capable:
            raise ValueError(
                f"{type(adapter).__name__} has no paged interface "
                f"(prefill_chunk/decode_paged); use kv_mode='slot'")
        self.kv_mode = mode
        self.weight_bytes = adapter.weight_bytes()
        self.blocks: Optional[BlockManager] = None
        if mode == "paged":
            # How attention runs and how KV is stored, as the adapter
            # reports them (an MLP has neither).
            self.attn_impl = getattr(adapter, "attn_impl", "gather")
            self.kv_dtype = getattr(adapter, "kv_dtype", "native")
            self._mb = int(adapter.max_blocks_per_seq)
            nb = (num_blocks if num_blocks is not None
                  else int(os.environ.get("HVD_SERVE_NUM_BLOCKS", "0")))
            if nb <= 0:
                # Default pool = the slot layout's footprint (max_batch ×
                # max_len tokens): same budget, shared across sequences.
                nb = self.max_batch * max(self._mb, 1)
            pc = (prefix_cache if prefix_cache is not None
                  else os.environ.get("HVD_SERVE_PREFIX_CACHE", "1")
                  not in ("0", "false"))
            bpb_fn = getattr(adapter, "paged_block_bytes", None)
            bpb = int(bpb_fn()) if bpb_fn is not None else None
            self.blocks = BlockManager(nb, int(adapter.block_tokens),
                                       prefix_cache=pc, bytes_per_block=bpb)
            chunk = (prefill_chunk if prefill_chunk is not None
                     else int(os.environ.get("HVD_SERVE_PREFILL_CHUNK",
                                             "64")))
            # <= 0 disables chunking: whole prompts prefill in one
            # iteration.
            self._chunk_budget = chunk if chunk > 0 else None
            self._cache = adapter.init_paged_cache(nb, self.max_batch)
            self._verify_pool_budget(nb)
        else:
            # Slot mode ignores both adapter knobs (dense attention over
            # the compute-dtype slot cache): report what runs.
            self.attn_impl = "dense"
            self.kv_dtype = "native"
            self._mb = 0
            self._cache = adapter.init_cache(self.max_batch)
            self.pool_bytes = 0
            self.kv_headroom_bytes = None
        # The decode-algorithm layer: seeded sampling and n>1 forks need
        # the logits / sampled adapter programs and the paged engine
        # (fork tables are CoW block tables); speculative decoding also
        # needs the draft + multi-token verify pair.  Spec is checked
        # loudly here, sampling per request at admission (_fail_doomed).
        self._sample_capable = (
            mode == "paged"
            and hasattr(adapter, "decode_paged_sampled")
            and hasattr(adapter, "prefill_chunk_logits"))
        sk = (spec_k if spec_k is not None
              else int(os.environ.get("HVD_SERVE_SPEC_K", "0")))
        if sk < 0:
            raise ValueError(f"spec_k must be >= 0, got {sk}")
        if sk > 0:
            if mode != "paged":
                raise ValueError(
                    "speculative decoding requires kv_mode='paged' "
                    "(the draft shares the paged pool)")
            if not (hasattr(adapter, "verify_chunk")
                    and hasattr(adapter, "draft_decode")
                    and getattr(adapter, "spec_capable", False)):
                raise ValueError(
                    f"{type(adapter).__name__} has no usable draft for "
                    f"speculative decoding (verify_chunk/draft_decode + "
                    f"spec_capable — transformer adapters need "
                    f"HVD_SERVE_DRAFT_LAYERS >= 1)")
        self.spec_k = sk
        # n>1 fork observability: forked sequences created (n-1 per
        # family) and requests that forked at all.
        self.seq_forks = 0
        self.forked_requests = 0
        # Compiled token grammars (serve/structured.py), keyed by (model,
        # vocab size, canonical schema JSON, eos): compiling is pure, so
        # equal schemas against one resident model share an automaton.
        self._grammar_cache: Dict[tuple, object] = {}
        # Warmup at every start (construction and mark_alive alike): the
        # prefill bucket lattice and one decode step, before the loop
        # runs, so the first real request finds the kernel libraries
        # built and loaded.  Off by default (HVD_SERVE_WARMUP).
        self._warmup_enabled = (
            warmup if warmup is not None
            else os.environ.get("HVD_SERVE_WARMUP", "0")
            not in ("0", "false"))
        self.warmup_runs = 0
        self.last_warmup_ms = 0.0
        self._slots: List[Optional[object]] = [None] * self.max_batch
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._admit_counter = 0
        self._step_anchor: Optional[float] = None
        self.steps = 0           # decode steps (one target call each)
        self.prefill_steps = 0   # prefill chunk calls (one per iteration)
        self.spec_steps = 0      # speculative iterations (one verify each)
        self.draft_steps = 0     # draft_decode calls
        # Fault injection: an env-configured plan installs at the first
        # engine; the per-iteration guard is a None check.
        _faultline.maybe_install_from_env()

    def _verify_pool_budget(self, num_blocks: int) -> None:
        """The pool's and the resident weights' device bytes against the
        memory budget, at construction and after each ``add_model`` /
        ``swap_model`` (JAX ``_verify_pool_budget``,
        ``horovod_tpu/serve/engine.py:1612``).  The budget is
        ``HVD_MEM_BUDGET_BYTES``, else the card's memory (none on the
        CPU); ``kv_headroom_bytes`` is what remains, and an overshoot is
        logged.  Weight bytes sum over the distinct resident adapters (a
        delta variant shares its untouched tensors with the base, so the
        sum is an upper bound)."""
        self.pool_bytes = (self.blocks.bytes_per_block or 0) * num_blocks
        distinct = {id(ad): ad for ad in self._adapters.values()}
        self.weight_bytes = sum(ad.weight_bytes()
                                for ad in distinct.values())
        budget = os.environ.get("HVD_MEM_BUDGET_BYTES")
        device = getattr(self.adapter, "device", None)
        if budget is not None:
            budget = int(budget)
        elif device is not None and torch.device(device).type == "cuda":
            budget = torch.cuda.get_device_properties(
                torch.device(device)).total_memory
        self.kv_headroom_bytes = (
            None if budget is None
            else int(budget) - self.pool_bytes - self.weight_bytes)
        if self.kv_headroom_bytes is not None and self.kv_headroom_bytes < 0:
            get_logger().warning(
                "%s: KV pool %d B + weights %d B exceed the memory budget "
                "%d B", self.replica_id, self.pool_bytes, self.weight_bytes,
                budget)

    # -- multi-model residency (serve/registry.py) ---------------------------

    def _check_geometry(self, adapter) -> None:
        """A co-resident variant shares this engine's slot table and paged
        pool, so every shape they bake in must match the default
        adapter's — checked at add/swap time, not at the first gather."""
        base = self.adapter
        if not all(hasattr(adapter, m) for m in
                   ("init_paged_cache", "prefill_chunk", "decode_paged")):
            raise ValueError(
                f"{type(adapter).__name__} has no paged interface; "
                f"multi-model residency is paged-only")
        for attr in ("max_len", "block_tokens", "max_blocks_per_seq",
                     "kv_token_cost"):
            a, b = getattr(adapter, attr, None), getattr(base, attr, None)
            if a is not None and b is not None and a != b:
                raise ValueError(
                    f"variant adapter {attr}={a} != resident {attr}={b}")
        a_bpb = getattr(adapter, "paged_block_bytes", None)
        b_bpb = getattr(base, "paged_block_bytes", None)
        if callable(a_bpb) and callable(b_bpb) and a_bpb() != b_bpb():
            raise ValueError(
                f"variant paged_block_bytes {a_bpb()} != resident "
                f"{b_bpb()} — the pool layout cannot serve both")
        a_cfg, b_cfg = getattr(adapter, "cfg", None), getattr(base, "cfg",
                                                             None)
        if a_cfg is not None and b_cfg is not None:
            for attr in ("num_layers", "num_heads", "d_model"):
                if getattr(a_cfg, attr) != getattr(b_cfg, attr):
                    raise ValueError(
                        f"variant cfg.{attr}={getattr(a_cfg, attr)} != "
                        f"resident {getattr(b_cfg, attr)}")
        sample_capable = (hasattr(adapter, "decode_paged_sampled")
                          and hasattr(adapter, "prefill_chunk_logits"))
        if self._sample_capable and not sample_capable:
            raise ValueError(
                f"{type(adapter).__name__} lacks the sampled programs "
                f"this engine advertises (decode_paged_sampled/"
                f"prefill_chunk_logits)")

    def add_model(self, name: str, adapter, version: int = 0) -> None:
        """Make variant ``name`` resident: it shares the slot table and
        the paged pool with the default model (each prefill and decode
        step runs one call per model present, threading the one pool).

        Paged-only: the slot-mode decode writes K/V at position 0 of
        every INACTIVE row (harmless with one model, since reads are
        masked), so a second model's decode would corrupt the other's
        live rows.  The paged steps address only through block tables,
        and an all-hole row touches nothing."""
        if self.kv_mode != "paged":
            raise ValueError(
                "multi-model residency requires kv_mode='paged' "
                "(slot-mode decode clobbers inactive rows)")
        if name == self.default_model or name in self._adapters:
            raise ValueError(f"model {name!r} already resident; use "
                             "swap_model to change its weights")
        self._check_geometry(adapter)
        with self._lock:
            self._adapters[name] = adapter
            self._model_versions[name] = int(version)
        self._verify_pool_budget(self.blocks.num_blocks)

    def swap_model(self, name: str, adapter, version: int) -> None:
        """Install new weights for resident variant ``name`` (the
        registry's roll).  Only on a STOPPED engine: the roll drains the
        replica first (mark_dead), so no iteration runs over the old
        adapter; the following start() re-runs warmup."""
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError(
                f"{self.replica_id}: swap_model requires a stopped "
                f"engine (drain it first — registry.roll does)")
        if name not in self._adapters:
            raise KeyError(f"model {name!r} not resident")
        self._check_geometry(adapter)
        self._adapters[name] = adapter
        self._model_versions[name] = int(version)
        if name == self.default_model:
            self.adapter = adapter
        if self.kv_mode == "paged":
            self._verify_pool_budget(self.blocks.num_blocks)

    def _adapter_for(self, model: Optional[str]):
        return self._adapters[model or self.default_model]

    def _grammar_for(self, ad, r: Request):
        """The (cached) token grammar of ``r.schema`` over adapter
        ``ad``'s vocabulary.  Raises ValueError (a 400) on an unsupported
        schema keyword, a missing eos_id or a vocabulary without token
        strings."""
        from .structured import TokenGrammar
        if r.eos_id is None:
            raise ValueError(
                "structured decoding needs eos_id (the grammar allows "
                "EOS exactly at accepting states)")
        vocab = ad.token_strings()
        if vocab is None:
            raise ValueError(
                f"structured decoding needs a byte-transparent "
                f"vocabulary; {type(ad).__name__} (vocab_size="
                f"{ad.vocab_size}) does not expose token strings")
        key = (r.model or self.default_model, int(ad.vocab_size),
               json.dumps(r.schema, sort_keys=True), int(r.eos_id))
        g = self._grammar_cache.get(key)
        if g is None:
            g = TokenGrammar(r.schema, vocab, int(r.eos_id))
            self._grammar_cache[key] = g
        return g

    def score_tokens(self, tokens: Sequence[int],
                     model: Optional[str] = None,
                     top: int = 0) -> List[Optional[dict]]:
        """Per-token logprobs of ``tokens`` under the resident model —
        the ``/score`` endpoint.  The adapter's ``score_logits`` runs on a
        throwaway pool WITHOUT the engine lock (a pure forward: no slot
        or pool state is touched).  Entry ``p`` is None at position 0
        and otherwise ``{"token", "logprob"[, "top"]}`` with ``logprob``
        = ``log_softmax(logits[p-1])[token]``."""
        ad = self._adapter_for(model)
        if not hasattr(ad, "score_logits"):
            raise ValueError(
                f"{type(ad).__name__} has no score_logits program; "
                f"/score needs a paged-capable adapter")
        tokens = [int(t) for t in tokens]
        for t in tokens:
            if not 0 <= t < ad.vocab_size:
                raise ValueError(
                    f"token {t} out of range [0, {ad.vocab_size})")
        logits = ad.score_logits(tokens)  # each row to f64 in the entry
        out: List[Optional[dict]] = [None]
        for p in range(1, len(tokens)):
            out.append(self._logprob_entry(logits[p - 1], tokens[p], top))
        return out

    def _prefix_salt(self, model: Optional[str]) -> int:
        from .registry import model_salt
        name = model or self.default_model
        return model_salt(name, self._model_versions.get(name, 0))

    # -- introspection -------------------------------------------------------

    @property
    def active_count(self) -> int:
        with self._lock:
            return sum(1 for s in self._slots if s is not None)

    def load(self) -> int:
        """Routing load: in-flight sequences + queued requests."""
        return self.active_count + self.batcher.depth()

    def kv_stats(self) -> Optional[dict]:
        """Block-pool utilization / prefix-cache statistics (None in slot
        mode), with the attention impl, KV storage dtype, the fork and
        spec counters and the pool/weight bytes."""
        if self.blocks is None:
            return None
        stats = self.blocks.stats()
        stats["attn_impl"] = self.attn_impl
        stats["kv_dtype"] = self.kv_dtype
        stats["seq_forks"] = self.seq_forks
        stats["forked_requests"] = self.forked_requests
        stats["spec_k"] = self.spec_k
        stats["pool_bytes"] = self.pool_bytes
        stats["weight_bytes"] = self.weight_bytes
        if self.kv_headroom_bytes is not None:
            stats["kv_headroom_bytes"] = self.kv_headroom_bytes
        return stats

    # -- warmup --------------------------------------------------------------

    def _warmup_counts(self) -> List[int]:
        """Every reachable batch-count bucket: the power-of-two ladder up
        to ``max_batch``, plus ``max_batch`` itself."""
        counts: List[int] = []
        n = 1
        while n <= self.max_batch:
            counts.append(n)
            n *= 2
        if counts[-1] != self.max_batch:
            counts.append(self.max_batch)
        return counts

    def warmup(self) -> float:
        """Run every (count, length) prefill bucket and one decode step
        of every resident adapter before the loop serves (JAX
        ``warmup``, ``horovod_tpu/serve/engine.py:1921``).  On a card
        this is the first use of each kernel library: the ``nvcc`` build,
        its ``ctypes`` load, cuBLAS's handles and the allocator's first
        blocks land here instead of in the first request's TTFT.  Only
        against an empty slot table (a busy engine skips: its live pool
        must not see warmup writes).  Returns wall milliseconds; 0.0
        when skipped or failed — a failure leaves the engine serving
        cold, and a kernel that failed to build raises again out of the
        request that needs it."""
        with self._lock:
            if any(s is not None for s in self._slots):
                get_logger().warning(
                    "%s: warmup skipped — slots busy", self.replica_id)
                return 0.0
        t0 = time.monotonic()
        try:
            if self.kv_mode == "paged":
                self._warmup_paged()
            else:
                self._warmup_slot()
            device = getattr(self.adapter, "device", None)
            if device is not None and torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
        except Exception as exc:
            get_logger().warning(
                "%s: warmup failed (%s: %s); serving cold",
                self.replica_id, type(exc).__name__, exc)
            return 0.0
        ms = (time.monotonic() - t0) * 1e3
        self.warmup_runs += 1
        self.last_warmup_ms = ms
        self.metrics.observe_warmup(self.replica_id, ms)
        get_logger().info("%s: warmup #%d done in %.1f ms",
                          self.replica_id, self.warmup_runs, ms)
        return ms

    def _warmup_paged(self) -> None:
        """Every distinct resident adapter through the paged bucket
        lattice.  Chunks carry ALL-HOLE tables, so every K/V write drops
        and retained prefix blocks and pool accounting are untouched;
        decode runs at its one shape (``max_batch`` rows, all holes)."""
        nb = self.blocks.capacity
        distinct = {id(ad): ad for ad in self._adapters.values()}
        for ad in distinct.values():
            cap = min(self._chunk_budget or ad.max_len, ad.max_len)
            lens: List[int] = []
            c = prompt_bucket(1, cap=ad.max_len)
            top = prompt_bucket(cap, cap=ad.max_len)
            while True:
                lens.append(c)
                if c >= top:
                    break
                c = min(c * 2, top)
            for n in self._warmup_counts():
                for c in lens:
                    self._cache, _ = ad.prefill_chunk(
                        self._cache, [[0] * c for _ in range(n)],
                        [0] * n, [[] for _ in range(n)])
            tokens = np.zeros((self.max_batch,), np.int64)
            positions = np.zeros((self.max_batch,), np.int64)
            tables = np.full((self.max_batch, self._mb), nb, np.int64)
            self._cache, _ = ad.decode_paged(
                self._cache, tokens, positions, tables)

    def _warmup_slot(self) -> None:
        """The slot-mode ladder (one adapter: add_model refuses slot
        engines).  Its writes land in real cache rows, which is safe
        only behind warmup()'s empty-slot guard: a real prefill into a
        slot overwrites every position it will read."""
        ad = self.adapter
        lens: List[int] = []
        c = prompt_bucket(1, cap=ad.max_len)
        while True:
            lens.append(c)
            if c >= ad.max_len:
                break
            c = min(c * 2, ad.max_len)
        for n in self._warmup_counts():
            slots = list(range(n))
            for c in lens:
                self._cache, _ = ad.prefill(
                    self._cache, [[0] * c for _ in range(n)], slots)
        self._cache, _ = ad.decode(
            self._cache, np.zeros((self.max_batch,), np.int64),
            np.zeros((self.max_batch,), np.int64))

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "InferenceEngine":
        if self._thread is not None:
            if self._thread.is_alive() and not self._stop.is_set():
                return self  # already running
            # A prior stop() timed out on a wedged iteration: the old loop
            # must be out before the restart.
            self._thread.join(timeout=30)
            if self._thread.is_alive():
                raise RuntimeError(
                    f"{self.replica_id}: previous engine loop has not "
                    f"exited; cannot restart")
            self._thread = None
        self._stop.clear()
        # Warmup at EVERY start, construction and mark_alive revival
        # alike, before the loop spawns: "healthy" then means "warm".
        if self._warmup_enabled:
            self.warmup()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"hvd-serve-engine-{self.replica_id}")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            if not self._thread.is_alive():
                self._thread = None

    def drain(self) -> List[Request]:
        """Stop the loop and return all in-flight requests WITHOUT
        completing them (dead-replica path: the scheduler resubmits them
        elsewhere; position-keyed decoding reproduces the output).  A
        fork family is returned once, its samples cleared."""
        self.stop()
        now = time.monotonic()
        with self._lock:
            inflight = []
            seen = set()
            for i, s in enumerate(self._slots):
                if s is None:
                    continue
                if self.blocks is not None:
                    self.blocks.free_table(s.table)
                self._slots[i] = None
                r = s.request
                if id(r) in seen:
                    continue  # another member of the same fork family
                seen.add(id(r))
                r.generated = []
                if r.token_logprobs is not None:
                    # The replay regenerates them from position 0; the
                    # stream's position dedupe keeps delivery once.
                    r.token_logprobs = []
                if r.samples is not None:
                    r.samples = [None] * r.n
                group = getattr(s, "group", None)  # slot mode holds _Slot
                if group is not None:
                    group.completed = 0
                    group.forked = False
                r.requeues += 1
                r.resubmitted_at = now
                inflight.append(r)
            return inflight

    # -- shared helpers ------------------------------------------------------

    def _free_slots(self) -> List[int]:
        with self._lock:
            return [i for i, s in enumerate(self._slots) if s is None]

    @staticmethod
    def _finished(r: Request, token: int) -> bool:
        """Slot-mode finish check on the request's own stream."""
        if r.eos_id is not None and token == r.eos_id:
            r.finish_reason = "stop"
            return True
        if len(r.generated) >= r.max_new_tokens:
            r.finish_reason = "length"
            return True
        return False

    @staticmethod
    def _seq_finished(s: _Seq, token: int) -> bool:
        """Paged-mode finish check: a fork finishes on its OWN stream;
        only an n == 1 request records its finish reason: ``stop`` (EOS,
        inclusive), ``length`` (max_new_tokens) or ``grammar`` (the
        automaton accepts and admits no continuation)."""
        r = s.request
        solo = s.group is None
        if r.eos_id is not None and token == r.eos_id:
            if solo:
                r.finish_reason = "stop"
            return True
        if len(s.generated) >= r.max_new_tokens:
            if solo:
                r.finish_reason = "length"
            return True
        if (r.grammar is not None and s.gstate is not None
                and r.grammar.exhausted(s.gstate)):
            r.finish_reason = "grammar"
            return True
        return False

    @staticmethod
    def _publish_stream(r: Request, generated: List[int],
                        logprob=None) -> None:
        """Offer the last token of ``generated`` to the request's stream
        (``serve/streaming.py``).  Publishing never blocks and never
        does IO, so the engine lock is never held across a socket write;
        the stream's position dedupe hides replays from the client."""
        if r.sink is not None:
            r.sink.publish(len(generated) - 1, generated[-1], logprob)

    @staticmethod
    def _logprob_entry(raw, tok: int, k: int) -> dict:
        """One ``token_logprobs`` record: the chosen token's
        log-probability under the RAW logits (before any grammar mask or
        temperature / top-k / top-p filter: the model's own belief), and
        the top-``k`` tokens of the same distribution."""
        row = np.asarray(raw, np.float64)
        m = float(np.max(row))
        lse = m + math.log(float(np.sum(np.exp(row - m))))
        entry = {"token": int(tok), "logprob": float(row[tok] - lse)}
        if k > 0:
            # The k largest by a partition, then sorted: JAX sorts the
            # whole row (argsort), the same tokens up to ties.
            idx = np.argpartition(row, -k)[-k:]
            idx = idx[np.argsort(-row[idx], kind="stable")]
            entry["top"] = [{"token": int(i),
                             "logprob": float(row[i] - lse)}
                            for i in idx]
        return entry

    def _retire_seq(self, i: int, s: _Seq) -> None:
        """Free one finished sequence's slot + block refs and complete its
        request — an n>1 request completes when its LAST member retires
        (each member's stream lands in ``request.samples[sample_index]``;
        ``request.generated`` mirrors sample 0).  Caller holds
        ``self._lock``."""
        self.blocks.free_table(s.table)
        # Cleared so a family-wide path (preempt, expiry) walking
        # ``group.seqs`` later can never free it a second time.
        s.table = []
        self._slots[i] = None
        r = s.request
        if s.group is None:
            self._complete(r)
            return
        r.samples[s.sample_index] = list(s.generated)
        s.group.completed += 1
        if s.group.completed == r.n:
            r.generated = list(r.samples[0])
            self._complete(r)

    def _fork_group(self, s: _Seq, logits: np.ndarray, now: float) -> None:
        """The fork moment of an n>1 request (``engine.py:2203``): its
        prompt K/V is in the pool — draw every member's first token from
        the primary's final-position ``logits`` row (each with its own
        (seed, sample) key) and activate the parked forks on the shared
        prompt blocks (one reference each; the first divergent append
        into the shared partial block forks a private copy through
        ``BlockManager.ensure_writable``).  Caller holds ``self._lock``."""
        r = s.request
        group = s.group
        P = len(r.prompt)
        shared = self._blocks_for_tokens(P)
        r.first_token_at = now
        r.stage_add("prefill", now)
        self.metrics.observe_ttft((now - r.submitted_at) * 1e3)
        # observe_ttft counted sample 0's first token; the other n-1
        # members emitted theirs in the same instant.
        self.metrics.count_tokens(r.n - 1)
        self.seq_forks += r.n - 1
        self.forked_requests += 1
        group.forked = True
        # Two passes: EVERY fork takes its block references before ANY
        # member can retire — a primary finishing on its first token
        # would otherwise free the shared prompt blocks while later forks
        # are about to ref them (a ref on a free-listed block aliases it
        # with the next allocation).
        finished: List[_Seq] = []
        for f in group.seqs:
            if f is not s:
                f.table = list(s.table[:shared])
                for bid in f.table:
                    self.blocks.ref(bid)
                f.length = s.length
                f.prompt_pos = P
                f.parked = False
            tok = (_sampling.sample_host(
                logits, f.base_key, P, r.temperature, r.top_k, r.top_p)
                if r.sampled else int(np.argmax(logits)))
            f.generated.append(tok)
            if self._seq_finished(f, tok):
                finished.append(f)
        for f in finished:
            for slot, cur in enumerate(self._slots):
                if cur is f:
                    self._retire_seq(slot, f)
                    break

    def _complete(self, r: Request) -> None:
        now = time.monotonic()
        if r.finish_reason is None:
            r.finish_reason = "length"
        if r.first_token_at is not None:
            r.stage_add("decode", now)
        for stage, ms in r.stage_ms.items():
            if ms > 0.0:
                self.metrics.observe_stage(stage, ms)
                self.metrics.observe_stage(f"{stage}|{r.qos}", ms)
                self.metrics.observe_tenant_stage(r.tenant, stage, ms)
        self.metrics.observe_request_ms(r.qos, sum(r.stage_ms.values()))
        r.complete()
        self.metrics.count_request("ok", tenant=r.tenant)

    def _observe_admission(self, requests: Sequence[Request]) -> None:
        """Credit each admitted request's wait to queue (or retry after a
        failover/preemption requeue)."""
        now = time.monotonic()
        for r in requests:
            r.stage_add("retry" if r.requeues else "queue", now)
            r.resubmitted_at = None

    def _fail(self, r: Request, exc: BaseException, outcome: str) -> bool:
        r.fail(exc)
        self.metrics.count_request(outcome, tenant=r.tenant)
        return True

    def _fail_doomed(self, r: Request) -> bool:
        """Requests that can never run on this engine fail loudly at
        admission.  Returns True when the request was failed."""
        if r.expired():
            return self._fail(r, DeadlineExceededError(
                f"{r.request_id} expired before prefill "
                f"({time.monotonic() - r.submitted_at:.3f}s since submit)"),
                "expired")
        if r.cancelled:
            return self._fail(r, RuntimeError(
                f"{r.request_id} client disconnected before prefill"),
                r.cancel_reason or "client_gone")
        # Unknown model: routing filters on residency, so this fires for
        # direct submits or a variant that left between routing and
        # admission — never silently served by the default model.
        if r.model is not None and r.model not in self._adapters:
            return self._fail(r, ValueError(
                f"{r.request_id}: unknown model {r.model!r} on "
                f"{self.replica_id} (resident: "
                f"{sorted(self._adapters)})"), "error")
        ad = self._adapter_for(r.model)
        total = len(r.prompt) + r.max_new_tokens
        if total > ad.max_len:
            return self._fail(r, ValueError(
                f"{r.request_id}: prompt+max_new_tokens {total} exceeds "
                f"max_len {ad.max_len}"), "error")
        # Sampling / n>1 need the paged engine and the sampled adapter
        # programs: fail loudly rather than serve a greedy single answer
        # to a sampled n-best request.
        if (r.sampled or r.n > 1) and not self._sample_capable:
            return self._fail(r, ValueError(
                f"{r.request_id}: sampling/n>1 needs a paged engine and "
                f"an adapter with prefill_chunk_logits/"
                f"decode_paged_sampled (kv_mode={self.kv_mode}, "
                f"adapter {type(self.adapter).__name__})"), "error")
        if r.n > self.max_batch:
            return self._fail(r, ValueError(
                f"{r.request_id}: n={r.n} exceeds the engine's "
                f"max_batch {self.max_batch} decode slots"), "error")
        # Structured decoding and logprobs need the host-mode steps
        # (raw logits on the host): fail rather than drop the mask or
        # the logprobs.
        if r.schema is not None or r.logprobs is not None:
            if (self.kv_mode != "paged" or not self._sample_capable
                    or not hasattr(ad, "decode_paged_logits")):
                return self._fail(r, ValueError(
                    f"{r.request_id}: schema/logprobs need a paged "
                    f"engine and an adapter with decode_paged_logits + "
                    f"prefill_chunk_logits (kv_mode={self.kv_mode}, "
                    f"adapter {type(ad).__name__})"), "error")
        if r.schema is not None and r.grammar is None:
            try:
                r.grammar = self._grammar_for(ad, r)
            except ValueError as e:
                return self._fail(r, ValueError(f"{r.request_id}: {e}"),
                                  "error")
        # The admission cost formula itself (n>1 shape included): a
        # mismatch with get_admission's hard_cap would requeue forever.
        if self._mb and self._request_cost_blocks(r) > self.blocks.capacity:
            return self._fail(r, ValueError(
                f"{r.request_id}: needs {self._request_cost_blocks(r)} KV "
                f"blocks but the pool holds {self.blocks.capacity}"),
                "error")
        return False

    def _expire_inflight(self) -> int:
        """Fail in-flight sequences whose client deadline passed (or whose
        client went away) and return their slots and blocks.  A fork
        family expires as one unit: failed and counted once, every
        member's blocks freed."""
        expired = 0
        now = time.monotonic()
        with self._lock:
            failed = set()
            for i, s in enumerate(self._slots):
                if s is None or not (s.request.expired(now)
                                     or s.request.cancelled):
                    continue
                r = s.request
                if id(r) not in failed:
                    failed.add(id(r))
                    # Slot-mode _Slot has no stream of its own; the
                    # request's list is the authority there.
                    gen = getattr(s, "generated", None)
                    ntokens = len(gen if gen is not None else r.generated)
                    if r.expired(now):
                        self._fail(r, DeadlineExceededError(
                            f"{r.request_id} deadline expired mid-flight "
                            f"({ntokens} token(s) generated)"), "expired")
                    else:
                        self._fail(r, RuntimeError(
                            f"{r.request_id} client disconnected "
                            f"mid-flight"), r.cancel_reason or "client_gone")
                table = getattr(s, "table", None)
                if self.blocks is not None and table is not None:
                    self.blocks.free_table(table)
                self._slots[i] = None
                expired += 1
        return expired

    def _faultline_step(self) -> None:
        """The ``engine.step`` injection point, at the top of every loop
        iteration (JAX ``horovod_tpu/serve/engine.py:2522``):
        ``poison-step`` raises into the loop's recovery path as an
        organic failure would, ``slow-decode`` stalls the iteration,
        ``pool-corrupt-block`` drops retained prefix blocks (their
        contents are suspect: they leave the registry rather than serve
        stale K/V to a later prefix hit)."""
        for f in _faultline.fire("engine.step", self.replica_id):
            if f.kind == "slow-decode":
                time.sleep(f.param or 0.02)
            elif f.kind == "pool-corrupt-block":
                if self.blocks is not None:
                    n = self.blocks.invalidate_retained(
                        max(int(f.param), 1))
                    get_logger().warning(
                        "%s: faultline scrubbed %d retained KV block(s)",
                        self.replica_id, n)
            elif f.kind == "poison-step":
                raise FaultInjected(
                    f"faultline: poisoned step on {self.replica_id} "
                    f"(step {self.steps})")

    # -- slot-mode loop ------------------------------------------------------

    def _admit(self, block_s: float) -> int:
        free = self._free_slots()
        if not free:
            return 0
        admitted = self.batcher.get_admission(len(free), block_s=block_s)
        if not admitted:
            return 0
        self._observe_admission(admitted)
        cursor = 0
        for _, group in sorted(
                bucket_requests(admitted, cap=self.adapter.max_len).items()):
            # One prefill per shape bucket; requests that can never run
            # fail loudly here.
            runnable = [r for r in group if not self._fail_doomed(r)]
            if not runnable:
                continue
            slots = free[cursor:cursor + len(runnable)]
            cursor += len(runnable)
            self._cache, first = self.adapter.prefill(
                self._cache, [r.prompt for r in runnable], slots)
            self.prefill_steps += 1
            now = time.monotonic()
            with self._lock:
                for r, slot, tok in zip(runnable, slots, first):
                    r.replica_id = self.replica_id
                    r.first_token_at = now
                    r.generated.append(int(tok))
                    self._publish_stream(r, r.generated)
                    r.stage_add("prefill", now)
                    self.metrics.observe_ttft((now - r.submitted_at) * 1e3)
                    if self._finished(r, int(tok)):
                        self._complete(r)
                    else:
                        # Cache holds positions 0..P-1; the first decode
                        # feeds the prefill's token at position P.
                        self._slots[slot] = _Slot(r, len(r.prompt))
        return cursor

    def _decode_once(self) -> int:
        with self._lock:
            active = [(i, s) for i, s in enumerate(self._slots)
                      if s is not None]
        if not active:
            self._step_anchor = None
            return 0
        tokens = np.zeros((self.max_batch,), np.int64)
        positions = np.zeros((self.max_batch,), np.int64)
        for i, s in active:
            tokens[i] = s.request.generated[-1]
            positions[i] = s.length  # next cache index = current length
        t0 = time.monotonic()
        self._cache, nxt = self.adapter.decode(self._cache, tokens,
                                               positions)
        now = time.monotonic()
        dt_ms = (now - (self._step_anchor if self._step_anchor is not None
                        else t0)) * 1e3
        self._step_anchor = now
        with self._lock:
            for i, s in active:
                if self._slots[i] is not s:
                    continue  # drained concurrently
                tok = int(nxt[i])
                s.request.generated.append(tok)
                self._publish_stream(s.request, s.request.generated)
                s.length += 1
                if self._finished(s.request, tok) \
                        or s.length >= self.adapter.max_len:
                    self._complete(s.request)
                    self._slots[i] = None
        self.steps += 1
        self.metrics.observe_decode_step(dt_ms, len(active), len(active))
        return len(active)

    # -- paged-mode loop -----------------------------------------------------

    def _blocks_for_tokens(self, tokens: int) -> int:
        if not self._mb:
            return 0
        return self.blocks.blocks_for(tokens * self.adapter.kv_token_cost)

    def _request_cost_blocks(self, r: Request) -> int:
        """Lifetime KV-block footprint of one request — the admission
        cost.  n == 1: prompt + max_new positions.  n > 1: the FULL
        prompt blocks are shared by every fork (counted once) and each of
        the n forks privately owns its tail — the partial last prompt
        block (CoW-forked on first divergent append) plus its decode
        region."""
        base = self._blocks_for_tokens(len(r.prompt) + r.max_new_tokens)
        if r.n <= 1 or not self._mb:
            return base
        shared_full = (len(r.prompt) * self.adapter.kv_token_cost
                       ) // self.blocks.block_tokens
        return base + (r.n - 1) * (base - shared_full)

    def _reserved_blocks(self) -> int:
        """Outstanding fork-tail reservations across the live fork
        families (each counted once)."""
        seen, total = set(), 0
        with self._lock:
            for s in self._slots:
                g = getattr(s, "group", None) if s is not None else None
                if g is not None and id(g) not in seen:
                    seen.add(id(g))
                    total += g.reserve
        return total

    def _admit_paged(self, block_s: float) -> int:
        free = self._free_slots()
        if not free:
            return 0
        use_blocks = self._mb > 0
        # Admission reserves each sequence's whole lifetime (prompt +
        # max_new_tokens; n>1 fork tails reserved, not allocated), so
        # decode-time growth cannot exhaust the pool and preemption
        # stays a defensive path.
        budget = (max(self.blocks.available() - self._reserved_blocks(), 0)
                  if use_blocks else None)
        admitted = self.batcher.get_admission(
            len(free), block_s=block_s, budget=budget,
            cost=self._request_cost_blocks if use_blocks else None,
            hard_cap=self.blocks.capacity if use_blocks else None)
        if not admitted:
            return 0
        self._observe_admission(admitted)
        cursor = 0
        bt = self.blocks.block_tokens
        for idx, r in enumerate(admitted):
            if self._fail_doomed(r):
                continue
            if r.n > len(free) - cursor:
                # An n>1 request takes its whole family's decode slots at
                # admission; not enough left this round: put it and
                # everything after it back in order.
                self.batcher.requeue_front(admitted[idx:])
                break
            cached_ids: List[int] = []
            cached_tokens = 0
            hashes: List[int] = []
            fresh: List[int] = []
            if use_blocks:
                if self.blocks.prefix_cache_enabled:
                    # Salted per (model, version): equal tokens under
                    # other weights never share K/V; (default, v0)
                    # salts to 0, the unsalted hashes.
                    hashes = chain_hashes(r.prompt, bt,
                                          salt=self._prefix_salt(r.model))
                    cached_ids, cached_tokens = \
                        self.blocks.lookup_prefix(r.prompt, hashes=hashes)
                need = self._blocks_for_tokens(
                    len(r.prompt) + r.max_new_tokens) - len(cached_ids)
                try:
                    fresh = self.blocks.allocate(need) if need > 0 else []
                except NoFreeBlocksError:
                    # The budget counted retained blocks an earlier
                    # request in THIS batch just claimed: requeue this
                    # and the rest.
                    self.blocks.free_table(cached_ids)
                    self.batcher.requeue_front(admitted[idx:])
                    break
            seq = _Seq(r, cached_tokens, cached_ids + fresh, hashes,
                       self._admit_counter)
            self._admit_counter += 1
            if r.sampled:
                seq.base_key = _sampling.seq_key(r.seed, 0)
            group: Optional[_ForkGroup] = None
            if r.n > 1:
                # The fork family: the primary keeps its own token list
                # (request.generated becomes the sample-0 mirror at
                # completion); n-1 parked members take their slots now
                # and activate at the fork moment (_fork_group).
                group = _ForkGroup(r)
                group.reserve = group.reserve_cap = (
                    self._request_cost_blocks(r) - self._blocks_for_tokens(
                        len(r.prompt) + r.max_new_tokens))
                seq.group = group
                seq.generated = []
                group.seqs.append(seq)
            r.replica_id = self.replica_id
            with self._lock:
                self._slots[free[cursor]] = seq
                cursor += 1
                for i in range(1, r.n):
                    f = _Seq(r, 0, [], [], seq.admit_seq)
                    f.group = group
                    f.sample_index = i
                    f.generated = []
                    f.parked = True
                    if r.sampled:
                        f.base_key = _sampling.seq_key(r.seed, i)
                    group.seqs.append(f)
                    self._slots[free[cursor]] = f
                    cursor += 1
        return cursor

    def _prefill_step(self) -> int:
        """Advance prompt prefills by at most ``HVD_SERVE_PREFILL_CHUNK``
        tokens total, oldest sequence first, in ONE batched chunk-prefill
        call.  Returns prompt tokens processed."""
        with self._lock:
            pending = [(i, s) for i, s in enumerate(self._slots)
                       if s is not None and not s.parked
                       and not s.decoding]
        if not pending:
            return 0
        pending.sort(key=lambda t: t[1].admit_seq)
        budget = self._chunk_budget if self._chunk_budget is not None \
            else float("inf")
        sel: List[Tuple[int, _Seq, int]] = []
        for i, s in pending:
            if budget <= 0:
                break
            take = int(min(len(s.request.prompt) - s.prompt_pos, budget))
            sel.append((i, s, take))
            budget -= take
        chunks = [s.request.prompt[s.prompt_pos:s.prompt_pos + take]
                  for _, s, take in sel]
        starts = [s.prompt_pos for _, s, _ in sel]
        tables = [list(s.table) for _, s, _ in sel]
        # A batch with any sampled, n>1, grammar or logprobs row runs the
        # logits variant: first tokens are drawn on the host (an n-way
        # fork draws n tokens from ONE logit row).  Greedy-only batches
        # keep the token-only step, bit for bit.
        use_logits = self._sample_capable and any(
            s.request.sampled or s.request.n > 1
            or s.request.grammar is not None
            or s.request.logprobs is not None for _, s, _ in sel)
        # One chunk-prefill call per resident model in the selection,
        # threading the one pool; a single-model batch is one call over
        # every row.
        by_model: Dict[Optional[str], List[int]] = {}
        for j, (_, s, _) in enumerate(sel):
            by_model.setdefault(s.request.model, []).append(j)
        first: List = [None] * len(sel)
        for model, idxs in by_model.items():
            ad = self._adapter_for(model)
            step = ad.prefill_chunk_logits if use_logits else ad.prefill_chunk
            self._cache, g_first = step(
                self._cache, [chunks[j] for j in idxs],
                [starts[j] for j in idxs], [tables[j] for j in idxs])
            for j, tok in zip(idxs, g_first):
                first[j] = tok
        self.prefill_steps += 1
        now = time.monotonic()
        total = 0
        bt = self.blocks.block_tokens
        with self._lock:
            for (i, s, take), tok in zip(sel, first):
                if self._slots[i] is not s:
                    continue  # drained concurrently
                s.prompt_pos += take
                s.length += take
                total += take
                if self._mb and s.hashes:
                    # Publish the blocks this chunk completed for prefix
                    # reuse (watermarked: never re-walk from 0).
                    for b in range(s.published, s.prompt_pos // bt):
                        self.blocks.register(s.hashes[b], s.table[b])
                    s.published = max(s.published, s.prompt_pos // bt)
                if not s.decoding:
                    continue
                r = s.request
                if r.n > 1:
                    # Fork moment: draw every member's first token from
                    # this row's logits, activate the parked forks.
                    self._fork_group(s, tok, now)
                    continue
                entry = None
                if use_logits:
                    # Host rows: the grammar mask rides sample_host's
                    # ``allowed`` (greedy = masked argmax, sampled =
                    # mask then filters); a logprob entry reads the RAW
                    # row before either.
                    raw = tok
                    mask = (r.grammar.allowed_mask(s.gstate)
                            if r.grammar is not None else None)
                    tok = _sampling.sample_host(
                        raw, s.base_key, len(r.prompt), r.temperature,
                        r.top_k, r.top_p, allowed=mask)
                    if r.logprobs is not None:
                        entry = self._logprob_entry(raw, tok, r.logprobs)
                        r.token_logprobs.append(entry)
                tok = int(tok)
                if r.grammar is not None and tok != r.eos_id:
                    s.gstate = r.grammar.advance_token(s.gstate, tok)
                r.first_token_at = now
                s.generated.append(tok)
                self._publish_stream(r, s.generated, entry)
                r.stage_add("prefill", now)
                self.metrics.observe_ttft((now - r.submitted_at) * 1e3)
                if self._seq_finished(s, tok):
                    self._retire_seq(i, s)
        return total

    def _preempt(self, slot: int, s: _Seq) -> None:
        """Victim path for pool exhaustion: release the sequence's blocks
        and requeue its request at the FRONT of this engine's queue — it
        restarts from the prompt (position-keyed decoding, greedy or
        seeded, reproduces the answer; its prompt blocks likely still sit
        in the prefix cache).  A fork family is preempted as ONE unit."""
        members = s.group.seqs if s.group is not None else [s]
        with self._lock:
            if s.group is None:
                if self._slots[slot] is s:
                    self._slots[slot] = None
            else:
                for i, cur in enumerate(self._slots):
                    if cur in members:
                        self._slots[i] = None
        for m in members:
            self.blocks.free_table(m.table)
            m.table = []
        r = s.request
        if s.group is not None:
            s.group.completed = 0
            s.group.forked = False
            r.samples = [None] * r.n
        r.generated = []
        if r.token_logprobs is not None:
            r.token_logprobs = []
        r.requeues += 1
        r.resubmitted_at = time.monotonic()
        self.metrics.count_request("preempted", tenant=r.tenant)
        self.batcher.requeue_front([r])
        get_logger().warning(
            "%s: preempted %s (KV pool exhausted); requeued",
            self.replica_id, r.request_id)

    def _ensure_write_blocks(self, active, extra=None):
        """Guarantee each decoding sequence owns writable blocks for cache
        positions ``length .. length + extra[i]`` (growing its table,
        CoW-forking shared blocks; ``extra`` is the speculative draft
        span, missing means just ``length``); preempts youngest-first on
        pool exhaustion.  Returns the sequences that still hold a slot."""
        ok = []
        bt = self.blocks.block_tokens
        for i, s in sorted(active, key=lambda t: t[1].admit_seq):
            span = extra.get(i, 0) if extra else 0
            placed = False
            while not placed:
                with self._lock:
                    if self._slots[i] is not s:
                        break  # preempted as an earlier sequence's victim
                # Both arms can exhaust the pool (a CoW fork allocates
                # too): either way the youngest sequence is preempted and
                # the arm retried.
                try:
                    for bidx in range(s.length // bt,
                                      (s.length + span) // bt + 1):
                        allocated = False
                        if bidx < len(s.table):
                            old = s.table[bidx]
                            bid, copied = self.blocks.ensure_writable(old)
                            if copied:
                                # Release the old reference only AFTER
                                # the device copy succeeds.
                                try:
                                    self._cache = self.adapter.copy_block(
                                        self._cache, old, bid)
                                except BaseException:
                                    self.blocks.free(bid)
                                    raise
                                s.table[bidx] = bid
                                self.blocks.free(old)
                                allocated = True
                        else:
                            s.table.extend(self.blocks.allocate(1))
                            allocated = True
                        # A fork-family allocation consumes one unit of
                        # the tails admission reserved.
                        if allocated and s.group is not None \
                                and s.group.reserve > 0:
                            s.group.reserve -= 1
                    placed = True
                    ok.append((i, s))
                except NoFreeBlocksError:
                    with self._lock:
                        live = [(j, t) for j, t in enumerate(self._slots)
                                if t is not None]
                    victim_slot, victim = max(
                        live, key=lambda t: t[1].admit_seq)
                    self._preempt(victim_slot, victim)
                    if victim is s or (s.group is not None
                                       and victim in s.group.seqs):
                        placed = True  # s itself evicted; skip this step
        return ok

    def _decode_rows(self, rows):
        """Fixed ``max_batch``-width step operands: active rows carry
        their last token, next cache index and table; inactive rows
        carry token 0, position 0 and ALL-HOLE tables (their writes
        drop, their reads are 0)."""
        tokens = np.zeros((self.max_batch,), np.int64)
        positions = np.zeros((self.max_batch,), np.int64)
        tables = np.full((self.max_batch, self._mb), self.blocks.capacity,
                         np.int64)
        for i, s in rows:
            tokens[i] = s.generated[-1]
            positions[i] = s.length  # next cache index = length
            tables[i, :len(s.table)] = s.table
        return tokens, positions, tables

    def _draw_params(self, rows):
        """The sampled step's per-row operands at ``max_batch`` width:
        base keys, temperatures, top-k and top-p of the sampled rows in
        ``rows``; every other row draws greedily (temperature 0)."""
        keys = _sampling.base_keys_array([None] * self.max_batch,
                                         self.max_batch)
        temps = np.zeros((self.max_batch,), np.float32)
        top_ks = np.zeros((self.max_batch,), np.int64)
        top_ps = np.ones((self.max_batch,), np.float32)
        for i, s in rows:
            r = s.request
            if r.sampled:
                keys[i] = s.base_key
                temps[i] = r.temperature
                top_ks[i] = r.top_k or 0
                top_ps[i] = r.top_p
        return keys, temps, top_ks, top_ps

    def _decode_group(self, ad, members, nxt_by_slot, entry_by_slot):
        """One model's share of a decode step.  Rows with a grammar or
        logprobs run one ``decode_paged_logits`` call whose logits stay
        on the adapter's device: one ``sample_batched`` call draws them
        all under their grammar masks (an unmasked row draws as the
        fused step does), and only the rows that asked for logprobs
        come to the host for their entry.  The other rows run the fused
        greedy or sampled step, so a request pays for the logits only
        when it asked for one of the two features.  Rows outside each
        call are inactive (all-hole tables): they write and read
        nothing."""
        host = [(i, s) for i, s in members
                if s.request.grammar is not None
                or s.request.logprobs is not None]
        if host:
            members = [(i, s) for i, s in members
                       if s.request.grammar is None
                       and s.request.logprobs is None]
            tokens, positions, tables = self._decode_rows(host)
            keys, temps, top_ks, top_ps = self._draw_params(host)
            # The operands go to the device before the forward is queued,
            # as in ``decode_paged_sampled``.
            packed = torch.as_tensor(_sampling.pack_params(
                keys, positions + 1, temps, top_ks, top_ps),
                device=ad.device)
            allowed = None
            if any(s.request.grammar is not None for _, s in host):
                mask = np.ones((self.max_batch, ad.vocab_size), bool)
                for i, s in host:
                    if s.request.grammar is not None:
                        mask[i] = s.request.grammar.allowed_mask(s.gstate)
                allowed = torch.as_tensor(mask, device=ad.device)
            self._cache, logits = ad.decode_paged_logits(
                self._cache, tokens, positions, tables, on_device=True)
            nxt = _sampling.sample_batched(logits, packed,
                                           allowed).cpu().numpy()
            asked = [i for i, s in host if s.request.logprobs is not None]
            raw = dict(zip(asked, logits[asked].cpu().numpy()))
            for i, s in host:
                nxt_by_slot[i] = int(nxt[i])
                if i in raw:
                    entry_by_slot[i] = self._logprob_entry(
                        raw[i], int(nxt[i]), s.request.logprobs)
        if not members:
            return
        tokens, positions, tables = self._decode_rows(members)
        if any(s.request.sampled for _, s in members):
            # Any sampled row switches the call to the sampled step
            # (greedy rows ride along at temperature 0 and get the same
            # argmax); each row folds only its own key.
            self._cache, nxt = ad.decode_paged_sampled(
                self._cache, tokens, positions, tables,
                *self._draw_params(members))
        else:
            self._cache, nxt = ad.decode_paged(
                self._cache, tokens, positions, tables)
        for i, _ in members:
            nxt_by_slot[i] = int(nxt[i])

    def _decode_once_paged(self) -> int:
        with self._lock:
            active = [(i, s) for i, s in enumerate(self._slots)
                      if s is not None and s.decoding]
        if active and self._mb:
            active = self._ensure_write_blocks(active)
        if not active:
            self._step_anchor = None
            return 0
        # One decode call per resident model with decoding rows,
        # threading the one pool (the prefill step's discipline).
        groups: Dict[Optional[str], List[Tuple[int, _Seq]]] = {}
        for i, s in active:
            groups.setdefault(s.request.model, []).append((i, s))
        t0 = time.monotonic()
        nxt_by_slot: Dict[int, int] = {}
        entry_by_slot: Dict[int, dict] = {}
        for model, members in groups.items():
            self._decode_group(self._adapter_for(model), members,
                               nxt_by_slot, entry_by_slot)
        now = time.monotonic()
        # Inter-decode-step latency: prefill chunks between two decode
        # steps land in this statistic by design.
        dt_ms = (now - (self._step_anchor if self._step_anchor is not None
                        else t0)) * 1e3
        self._step_anchor = now
        with self._lock:
            for i, s in active:
                if self._slots[i] is not s:
                    continue  # drained/preempted concurrently
                tok = nxt_by_slot[i]
                r = s.request
                s.generated.append(tok)
                entry = entry_by_slot.get(i)
                if entry is not None and r.token_logprobs is not None:
                    r.token_logprobs.append(entry)
                if r.grammar is not None and tok != r.eos_id:
                    s.gstate = r.grammar.advance_token(s.gstate, tok)
                if s.group is None:
                    self._publish_stream(r, s.generated, entry)
                s.length += 1
                if self._seq_finished(s, tok) \
                        or s.length >= self.adapter.max_len:
                    self._retire_seq(i, s)
        self.steps += 1
        self.metrics.observe_decode_step(dt_ms, len(active), len(active))
        return len(active)

    # -- speculative decoding (paged mode, spec_k > 0) ------------------------

    def _spec_once(self) -> int:
        """One speculative iteration (``engine.py:3855``; Leviathan et
        al. 2023): the draft proposes up to k greedy tokens per decoding
        sequence (k batched draft steps sharing the target's pool), then
        the target verifies all k+1 positions in ONE chunk step
        (``verify_chunk``).  Greedy requests accept while the draft
        matches the target's argmax and emit the target's token at the
        first mismatch — the tokens of greedy decoding; sampled requests
        accept draft d with probability ``p[d]`` and resample the
        residual, so the marginal is the filtered target distribution.
        K/V past a rejected draft sits at positions >= the rolled-back
        length (masked by position, then overwritten); table entries
        extended for drafting are freed, so a rejection leaks no block
        reference."""
        with self._lock:
            active = [(i, s) for i, s in enumerate(self._slots)
                      if s is not None and s.decoding]
        if not active:
            self._step_anchor = None
            return 0
        # Per-row draft budget: the step always emits >= 1 non-draft
        # token (correction or bonus), so drafting is capped at
        # max_new-1 remaining and at the last cache position.
        ks: Dict[int, int] = {}
        for i, s in active:
            ks[i] = max(min(self.spec_k,
                            s.request.max_new_tokens - len(s.generated) - 1,
                            self.adapter.max_len - 1 - s.length), 0)
        pre_lens: Dict[int, int] = {}
        if self._mb:
            pre_lens = {i: len(s.table) for i, s in active}
            active = self._ensure_write_blocks(active, extra=ks)
            if not active:
                self._step_anchor = None
                return 0
        t0 = time.monotonic()
        drafts: Dict[int, List[int]] = {i: [] for i, _ in active}
        cur = {i: s.generated[-1] for i, s in active}
        pos = {i: s.length for i, s in active}
        for j in range(max(ks[i] for i, _ in active)):
            rows = [(i, s) for i, s in active if ks[i] > j]
            tokens, positions, tables = self._decode_rows(rows)
            for i, _ in rows:
                tokens[i], positions[i] = cur[i], pos[i]
            self._cache, proposed = self.adapter.draft_decode(
                self._cache, tokens, positions, tables)
            self.draft_steps += 1
            for i, _ in rows:
                d = int(proposed[i])
                drafts[i].append(d)
                cur[i] = d
                pos[i] += 1
        chunks = [[s.generated[-1]] + drafts[i] for i, s in active]
        starts = [s.length for _, s in active]
        tables_l = [list(s.table) for _, s in active]
        self._cache, logits = self.adapter.verify_chunk(
            self._cache, chunks, starts, tables_l)
        now = time.monotonic()
        dt_ms = (now - (self._step_anchor if self._step_anchor is not None
                        else t0)) * 1e3
        self._step_anchor = now
        drafted = accepted = rejected = emitted_total = 0
        # Acceptance outside the engine lock (host draws and full-vocab
        # filtered_probs sorts); only this loop thread mutates sequence
        # state, and the application below re-checks slot ownership.
        plan: List[Tuple[int, _Seq, List[int], int]] = []
        for row, (i, s) in enumerate(active):
            r = s.request
            k, lrow, ell = ks[i], logits[row], s.length
            drafted += k
            emit: List[int] = []
            m = 0
            rejected_here = False
            for j in range(1, k + 1):
                pl, d = lrow[j - 1], drafts[i][j - 1]
                if not r.sampled:
                    tgt = int(np.argmax(pl))
                    if d == tgt:
                        emit.append(d)
                        m += 1
                        continue
                    emit.append(tgt)
                    rejected_here = True
                    break
                p = _sampling.filtered_probs(pl, r.temperature, r.top_k,
                                             r.top_p)
                if _sampling.accept_draw(s.base_key, ell + j) < p[d]:
                    emit.append(d)
                    m += 1
                    continue
                emit.append(_sampling.residual_sample(p, d, s.base_key,
                                                      ell + j))
                rejected_here = True
                break
            if not rejected_here:
                # Every draft accepted: the bonus token from the target's
                # last-position logits, keyed as plain decoding keys
                # that position.
                pl = lrow[k]
                emit.append(int(np.argmax(pl)) if not r.sampled
                            else _sampling.sample_host(
                                pl, s.base_key, ell + k + 1, r.temperature,
                                r.top_k, r.top_p))
            accepted += m
            rejected += k - m
            plan.append((i, s, emit, m))
        with self._lock:
            staged = set()
            for i, s, emit, m in plan:
                if self._slots[i] is not s:
                    continue  # drained/preempted concurrently
                r = s.request
                ell = s.length
                if id(r) not in staged:
                    staged.add(id(r))
                    r.stage_add("spec", now)
                finished = False
                for tok in emit:
                    s.generated.append(tok)
                    if s.group is None:
                        self._publish_stream(r, s.generated)
                    emitted_total += 1
                    if self._seq_finished(s, tok):
                        finished = True
                        break
                if finished:
                    self._retire_seq(i, s)
                    continue
                # K/V is valid through position ell+m (the fed token and
                # the accepted drafts); the correction/bonus token is
                # pending exactly like a plain decode step's output.
                s.length = ell + m + 1
                if s.length >= self.adapter.max_len:
                    self._retire_seq(i, s)
                elif self._mb:
                    # Rollback: table entries extended for drafting beyond
                    # what the accepted prefix needs return to the pool.
                    keep = max(pre_lens.get(i, len(s.table)),
                               self._blocks_for_tokens(s.length))
                    if len(s.table) > keep:
                        freed = len(s.table) - keep
                        self.blocks.free_table(s.table[keep:])
                        del s.table[keep:]
                        # Refund the fork-tail reservation (capped at its
                        # admission-time value).
                        if s.group is not None:
                            s.group.reserve = min(
                                s.group.reserve + freed,
                                s.group.reserve_cap)
        self.steps += 1
        self.spec_steps += 1
        self.metrics.observe_decode_step(dt_ms, len(active), emitted_total)
        self.metrics.observe_spec(drafted, accepted, rejected)
        return len(active)

    def _spec_ok(self) -> bool:
        """Speculate this iteration?  The draft is the default model's
        and the draft/verify pair has no logits or mask seam, so a live
        row of another model, with a grammar or with logprobs falls the
        whole iteration back to the plain per-model step: the same
        tokens, without the draft's amortization (JAX ``_run``,
        ``horovod_tpu/serve/engine.py:4160``)."""
        if self.spec_k <= 0:
            return False
        with self._lock:
            return all(
                (s.request.model in (None, self.default_model)
                 or len(self._adapters) == 1)
                and s.request.grammar is None
                and s.request.logprobs is None
                for s in self._slots if s is not None)

    # -- the loop ------------------------------------------------------------

    def _recover(self, e: BaseException) -> None:
        """Poisoned-batch recovery: fail the in-flight requests NOW with
        the real error and keep serving.  Paged mode frees only the
        failed iteration's block references (the pool and the prefix
        registry survive: shared blocks are never written, so a failed
        step cannot have touched them); slot mode re-initialises its
        cache (its rows are suspect and not individually reclaimable)."""
        get_logger().exception(
            "%s: engine step failed: %s", self.replica_id, e)
        with self._lock:
            failed = set()
            for i, s in enumerate(self._slots):
                if s is None:
                    continue
                if id(s.request) not in failed:
                    # One fail/count per request, fork families included.
                    failed.add(id(s.request))
                    self._fail(s.request, e, "error")
                if self.blocks is not None:
                    self.blocks.free_table(s.table)
                self._slots[i] = None
        if self.kv_mode == "slot":
            self._cache = self.adapter.init_cache(self.max_batch)
        self._step_anchor = None

    def _run(self) -> None:
        idle_block_s = float(os.environ.get("HVD_SERVE_IDLE_POLL_S", "0.05"))
        paged = self.kv_mode == "paged"
        while not self._stop.is_set():
            try:
                if _faultline.PLAN is not None:
                    self._faultline_step()
                self._expire_inflight()
                busy = self.active_count > 0
                # Iteration-level scheduling: admission happens BETWEEN
                # decode steps — non-blocking while sequences are active,
                # blocking (bounded) when idle.
                block = 0.0 if busy else idle_block_s
                if paged:
                    self._admit_paged(block)
                    pre = self._prefill_step()
                    dec = (self._spec_once() if self._spec_ok()
                           else self._decode_once_paged())
                    if pre or dec:
                        self.metrics.observe_iteration(pre, dec)
                else:
                    self._admit(block)
                    self._decode_once()
            except Exception as e:
                # One poisoned batch must not take the replica down.
                self._recover(e)

    def generate(self, prompt: Sequence[int], max_new_tokens: int = 16,
                 eos_id: Optional[int] = None,
                 timeout_s: float = 300.0,
                 temperature: float = 0.0,
                 top_k: Optional[int] = None,
                 top_p: float = 1.0,
                 n: int = 1,
                 seed: Optional[int] = None,
                 model: Optional[str] = None,
                 tenant: str = "default") -> List[int]:
        """Submit one request through the running loop and wait (n > 1:
        the returned list is sample 0; the full set is on the request's
        ``samples`` — use a hand-built Request for that)."""
        if self._thread is None:
            self.start()
        r = Request(prompt, max_new_tokens=max_new_tokens, eos_id=eos_id,
                    temperature=temperature, top_k=top_k, top_p=top_p,
                    n=n, seed=seed, model=model, tenant=tenant)
        self.batcher.submit(r)
        return r.result(timeout=timeout_s)
