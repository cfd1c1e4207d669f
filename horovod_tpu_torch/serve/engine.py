"""Continuous-batching inference engine over the port's GPT-2 (paged KV,
greedy decoding).

Port of the paged, greedy path of ``horovod_tpu/serve/engine.py``: the
design is Orca's iteration-level scheduling with vLLM's block-paged KV
storage and Sarathi-Serve's chunked prefill.

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
  (copy-on-write protects shared blocks from writes).

Exactness: decoding is greedy and every per-sequence computation is
row-independent — positions past a sequence's length are masked to
weight 0 and block-table holes carry the out-of-bounds sentinel ``NB``
(the scatter drops those rows, the attention skips them) — so a request
receives the same tokens alone or packed in a batch.  Chunk batches keep
the JAX adapter's power-of-two padding and decode runs at the fixed
``max_batch`` width, which pins the shapes that contract holds at.

Not ported yet (later slices): slot mode and ``MLPAdapter``, seeded
sampling and n>1 forks, speculative decoding, grammars and logprobs,
streaming, tiering, sequence-parallel prefill, warmup, multi-model
residency, faultline injection and request tracing.  A request that
asks for one of these fails with a ValueError naming it (HTTP 400).
"""

from __future__ import annotations

import math
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.nn import functional as F

from ..models.transformer import layer_norm
from ..utils import get_logger
from ..utils.device import resolve_device
from . import paged_attention as _pa
from .batcher import DeadlineExceededError, DynamicBatcher, Request, \
    prompt_bucket
from .blocks import BlockManager, NoFreeBlocksError, chain_hashes
from .metrics import ServeMetrics

_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _next_pow2(n: int, floor: int = 1) -> int:
    b = max(floor, 1)
    while b < n:
        b *= 2
    return b


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

    The pool is updated in place: the JAX adapter donates the pool to
    each jitted step and writes it with ``.at[].set``; here the scatter
    is an ``index_put_`` and the CoW block copy a ``copy_`` into the
    same tensors.
    """

    kv_token_cost = 1  # cache positions consumed per token

    def __init__(self, cfg, params, max_len: Optional[int] = None,
                 block_tokens: Optional[int] = None,
                 attn_impl: Optional[str] = None,
                 kv_dtype: Optional[str] = None,
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

    # -- paged decode -------------------------------------------------------

    def _paged_step_body(self, cache, tokens, positions, tables):
        """The single-token paged decode forward: ``tokens`` [B],
        ``positions`` [B] (the cache index this token's K/V lands at),
        ``tables`` [B, MB] (entry NB for holes and inactive rows).
        Returns the LM logits [B, V]."""
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
        for layer, blk in enumerate(self.params["blocks"]):
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
    def copy_block(self, cache, src: int, dst: int):
        """Copy-on-write data move: duplicate one physical block across all
        layers, in place (the BlockManager already moved the reference)."""
        for a in cache.values():
            a[:, dst].copy_(a[:, src])
        return cache


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

class _Seq:
    """Paged-mode sequence state."""
    __slots__ = ("request", "length", "prompt_pos", "table", "hashes",
                 "admit_seq", "published", "generated")

    def __init__(self, request: Request, cached_tokens: int,
                 table: List[int], hashes: List[int], admit_seq: int):
        self.request = request
        self.length = cached_tokens      # tokens with K/V in the pool
        self.prompt_pos = cached_tokens  # prompt tokens consumed so far
        self.table = table               # physical block ids, logical order
        self.hashes = hashes             # prompt full-block chain hashes
        self.admit_seq = admit_seq       # admission order (preempt youngest)
        self.published = 0               # prefix-registered block watermark
        self.generated = request.generated

    @property
    def decoding(self) -> bool:
        return self.prompt_pos >= len(self.request.prompt)


def unported_feature(r: Request) -> Optional[str]:
    """The first feature ``r`` asks for that the port does not serve yet,
    or None."""
    if r.stream:
        return "stream (token streaming, serve/streaming.py)"
    if r.schema is not None:
        return "schema (grammar-constrained decoding, serve/structured.py)"
    if r.logprobs is not None:
        return "logprobs (per-token logprobs)"
    if r.sampled:
        return "temperature > 0 (seeded sampling, serve/sampling.py)"
    if r.n > 1:
        return "n > 1 (parallel sampling forks)"
    if r.model is not None:
        return "model (multi-model residency, serve/registry.py)"
    return None


class InferenceEngine:
    """One continuous-batching decode loop (one per serving replica).

    Owns the model adapter, the slot table, the block pool and its
    BlockManager, and a worker thread running admit → prefill chunk →
    decode until stopped.  Completion is per request (batcher.Request
    events).
    """

    def __init__(self, adapter: TransformerAdapter,
                 batcher: Optional[DynamicBatcher] = None,
                 metrics: Optional[ServeMetrics] = None,
                 max_batch: Optional[int] = None,
                 replica_id: str = "replica-0",
                 kv_mode: Optional[str] = None,
                 num_blocks: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 prefix_cache: Optional[bool] = None):
        self.adapter = adapter
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
        if mode == "slot":
            raise ValueError("kv_mode='slot' is not ported yet; the port "
                             "serves paged only")
        if mode not in ("paged", "auto"):
            raise ValueError(f"kv_mode must be paged|slot|auto, got {mode}")
        self.kv_mode = "paged"
        self.attn_impl = adapter.attn_impl
        self.kv_dtype = adapter.kv_dtype
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
        bpb = int(adapter.paged_block_bytes())
        self.blocks = BlockManager(nb, int(adapter.block_tokens),
                                   prefix_cache=pc, bytes_per_block=bpb)
        chunk = (prefill_chunk if prefill_chunk is not None
                 else int(os.environ.get("HVD_SERVE_PREFILL_CHUNK", "64")))
        # <= 0 disables chunking: whole prompts prefill in one iteration.
        self._chunk_budget = chunk if chunk > 0 else None
        self._cache = adapter.init_paged_cache(nb, self.max_batch)
        self.pool_bytes = bpb * nb
        self.weight_bytes = adapter.weight_bytes()
        self._slots: List[Optional[_Seq]] = [None] * self.max_batch
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._admit_counter = 0
        self._step_anchor: Optional[float] = None
        self.steps = 0           # decode steps (one adapter call each)
        self.prefill_steps = 0   # prefill chunk calls (one per iteration)

    # -- introspection -------------------------------------------------------

    @property
    def active_count(self) -> int:
        with self._lock:
            return sum(1 for s in self._slots if s is not None)

    def load(self) -> int:
        """Routing load: in-flight sequences + queued requests."""
        return self.active_count + self.batcher.depth()

    def kv_stats(self) -> dict:
        """Block-pool utilization / prefix-cache statistics, with the
        attention impl, KV storage dtype and the pool/weight bytes."""
        stats = self.blocks.stats()
        stats["attn_impl"] = self.attn_impl
        stats["kv_dtype"] = self.kv_dtype
        stats["pool_bytes"] = self.pool_bytes
        stats["weight_bytes"] = self.weight_bytes
        return stats

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
        elsewhere; greedy decoding reproduces the output exactly)."""
        self.stop()
        now = time.monotonic()
        with self._lock:
            inflight = []
            for i, s in enumerate(self._slots):
                if s is None:
                    continue
                self.blocks.free_table(s.table)
                self._slots[i] = None
                r = s.request
                r.generated = []
                r.requeues += 1
                r.resubmitted_at = now
                inflight.append(r)
            return inflight

    # -- shared helpers ------------------------------------------------------

    def _free_slots(self) -> List[int]:
        with self._lock:
            return [i for i, s in enumerate(self._slots) if s is None]

    @staticmethod
    def _seq_finished(s: _Seq, token: int) -> bool:
        r = s.request
        if r.eos_id is not None and token == r.eos_id:
            r.finish_reason = "stop"
            return True
        if len(s.generated) >= r.max_new_tokens:
            r.finish_reason = "length"
            return True
        return False

    def _retire_seq(self, i: int, s: _Seq) -> None:
        """Free one finished sequence's slot + block refs and complete its
        request.  Caller holds ``self._lock``."""
        self.blocks.free_table(s.table)
        s.table = []
        self._slots[i] = None
        self._complete(s.request)

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
        feature = unported_feature(r)
        if feature is not None:
            return self._fail(r, ValueError(
                f"{r.request_id}: {feature} is not supported by "
                f"horovod_tpu_torch yet"), "error")
        total = len(r.prompt) + r.max_new_tokens
        if total > self.adapter.max_len:
            return self._fail(r, ValueError(
                f"{r.request_id}: prompt+max_new_tokens {total} exceeds "
                f"max_len {self.adapter.max_len}"), "error")
        if self._request_cost_blocks(r) > self.blocks.capacity:
            return self._fail(r, ValueError(
                f"{r.request_id}: needs {self._request_cost_blocks(r)} KV "
                f"blocks but the pool holds {self.blocks.capacity}"),
                "error")
        return False

    def _expire_inflight(self) -> int:
        """Fail in-flight sequences whose client deadline passed (or whose
        client went away) and return their slots and blocks."""
        expired = 0
        now = time.monotonic()
        with self._lock:
            for i, s in enumerate(self._slots):
                if s is None or not (s.request.expired(now)
                                     or s.request.cancelled):
                    continue
                r = s.request
                if r.expired(now):
                    self._fail(r, DeadlineExceededError(
                        f"{r.request_id} deadline expired mid-flight "
                        f"({len(s.generated)} token(s) generated)"),
                        "expired")
                else:
                    self._fail(r, RuntimeError(
                        f"{r.request_id} client disconnected mid-flight"),
                        r.cancel_reason or "client_gone")
                self.blocks.free_table(s.table)
                self._slots[i] = None
                expired += 1
        return expired

    def _blocks_for_tokens(self, tokens: int) -> int:
        return self.blocks.blocks_for(tokens * self.adapter.kv_token_cost)

    def _request_cost_blocks(self, r: Request) -> int:
        """Lifetime KV-block footprint of one request: prompt + max_new
        positions (the admission cost)."""
        return self._blocks_for_tokens(len(r.prompt) + r.max_new_tokens)

    # -- the loop ------------------------------------------------------------

    def _admit_paged(self, block_s: float) -> int:
        free = self._free_slots()
        if not free:
            return 0
        # Admission reserves each sequence's whole lifetime (prompt +
        # max_new_tokens), so decode-time growth cannot exhaust the pool
        # and preemption stays a defensive path.
        admitted = self.batcher.get_admission(
            len(free), block_s=block_s, budget=self.blocks.available(),
            cost=self._request_cost_blocks, hard_cap=self.blocks.capacity)
        if not admitted:
            return 0
        self._observe_admission(admitted)
        cursor = 0
        bt = self.blocks.block_tokens
        for idx, r in enumerate(admitted):
            if self._fail_doomed(r):
                continue
            cached_ids: List[int] = []
            cached_tokens = 0
            hashes: List[int] = []
            if self.blocks.prefix_cache_enabled:
                hashes = chain_hashes(r.prompt, bt)
                cached_ids, cached_tokens = \
                    self.blocks.lookup_prefix(r.prompt, hashes=hashes)
            need = self._request_cost_blocks(r) - len(cached_ids)
            try:
                fresh = self.blocks.allocate(need) if need > 0 else []
            except NoFreeBlocksError:
                # The budget counted retained blocks an earlier request in
                # THIS batch just claimed: requeue this and the rest.
                self.blocks.free_table(cached_ids)
                self.batcher.requeue_front(admitted[idx:])
                break
            seq = _Seq(r, cached_tokens, cached_ids + fresh, hashes,
                       self._admit_counter)
            self._admit_counter += 1
            r.replica_id = self.replica_id
            with self._lock:
                self._slots[free[cursor]] = seq
                cursor += 1
        return cursor

    def _prefill_step(self) -> int:
        """Advance prompt prefills by at most ``HVD_SERVE_PREFILL_CHUNK``
        tokens total, oldest sequence first, in ONE batched chunk-prefill
        call.  Returns prompt tokens processed."""
        with self._lock:
            pending = [(i, s) for i, s in enumerate(self._slots)
                       if s is not None and not s.decoding]
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
        self._cache, first = self.adapter.prefill_chunk(
            self._cache, chunks, starts, tables)
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
                if s.hashes:
                    # Publish the blocks this chunk completed for prefix
                    # reuse (watermarked: never re-walk from 0).
                    for b in range(s.published, s.prompt_pos // bt):
                        self.blocks.register(s.hashes[b], s.table[b])
                    s.published = max(s.published, s.prompt_pos // bt)
                if not s.decoding:
                    continue
                r = s.request
                tok = int(tok)
                r.first_token_at = now
                s.generated.append(tok)
                r.stage_add("prefill", now)
                self.metrics.observe_ttft((now - r.submitted_at) * 1e3)
                if self._seq_finished(s, tok):
                    self._retire_seq(i, s)
        return total

    def _preempt(self, slot: int, s: _Seq) -> None:
        """Victim path for pool exhaustion: release the sequence's blocks
        and requeue its request at the FRONT of this engine's queue — it
        restarts from the prompt (greedy decoding reproduces the answer
        exactly; its prompt blocks likely still sit in the prefix
        cache)."""
        with self._lock:
            if self._slots[slot] is s:
                self._slots[slot] = None
        self.blocks.free_table(s.table)
        s.table = []
        s.request.generated = []
        s.request.requeues += 1
        s.request.resubmitted_at = time.monotonic()
        self.metrics.count_request("preempted", tenant=s.request.tenant)
        self.batcher.requeue_front([s.request])
        get_logger().warning(
            "%s: preempted %s (KV pool exhausted); requeued",
            self.replica_id, s.request.request_id)

    def _ensure_write_blocks(self, active):
        """Guarantee each decoding sequence owns a writable block for
        cache position ``length`` (growing its table, CoW-forking a shared
        block); preempts youngest-first on pool exhaustion.  Returns the
        sequences that still hold a slot."""
        ok = []
        bt = self.blocks.block_tokens
        for i, s in sorted(active, key=lambda t: t[1].admit_seq):
            placed = False
            while not placed:
                with self._lock:
                    if self._slots[i] is not s:
                        break  # preempted as an earlier sequence's victim
                try:
                    bidx = s.length // bt
                    if bidx < len(s.table):
                        old = s.table[bidx]
                        bid, copied = self.blocks.ensure_writable(old)
                        if copied:
                            # Release the old reference only AFTER the
                            # device copy succeeds.
                            try:
                                self._cache = self.adapter.copy_block(
                                    self._cache, old, bid)
                            except BaseException:
                                self.blocks.free(bid)
                                raise
                            s.table[bidx] = bid
                            self.blocks.free(old)
                    else:
                        s.table.extend(self.blocks.allocate(1))
                    placed = True
                    ok.append((i, s))
                except NoFreeBlocksError:
                    with self._lock:
                        live = [(j, t) for j, t in enumerate(self._slots)
                                if t is not None]
                    victim_slot, victim = max(
                        live, key=lambda t: t[1].admit_seq)
                    self._preempt(victim_slot, victim)
                    if victim is s:
                        placed = True  # s itself evicted; skip this step
        return ok

    def _decode_once_paged(self) -> int:
        with self._lock:
            active = [(i, s) for i, s in enumerate(self._slots)
                      if s is not None and s.decoding]
        if active:
            active = self._ensure_write_blocks(active)
        if not active:
            self._step_anchor = None
            return 0
        nb = self.blocks.capacity
        # Fixed max_batch width: inactive rows carry token 0, position 0
        # and ALL-HOLE tables (their writes drop, their reads are 0).
        tokens = np.zeros((self.max_batch,), np.int64)
        positions = np.zeros((self.max_batch,), np.int64)
        tables = np.full((self.max_batch, self._mb), nb, np.int64)
        for i, s in active:
            tokens[i] = s.generated[-1]
            positions[i] = s.length  # next cache index = length
            tables[i, :len(s.table)] = s.table
        t0 = time.monotonic()
        self._cache, nxt = self.adapter.decode_paged(
            self._cache, tokens, positions, tables)
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
                tok = int(nxt[i])
                s.generated.append(tok)
                s.length += 1
                if self._seq_finished(s, tok) \
                        or s.length >= self.adapter.max_len:
                    self._retire_seq(i, s)
        self.steps += 1
        self.metrics.observe_decode_step(dt_ms, len(active), len(active))
        return len(active)

    def _recover(self, e: BaseException) -> None:
        """Poisoned-batch recovery: fail the in-flight requests NOW with
        the real error and keep serving.  Only the failed iteration's
        block references are freed; the pool and the prefix registry
        survive (shared blocks are never written, so a failed step cannot
        have touched them)."""
        get_logger().exception(
            "%s: engine step failed: %s", self.replica_id, e)
        with self._lock:
            for i, s in enumerate(self._slots):
                if s is not None:
                    self._fail(s.request, e, "error")
                    self.blocks.free_table(s.table)
                    self._slots[i] = None
        self._step_anchor = None

    def _run(self) -> None:
        idle_block_s = float(os.environ.get("HVD_SERVE_IDLE_POLL_S", "0.05"))
        while not self._stop.is_set():
            try:
                self._expire_inflight()
                busy = self.active_count > 0
                # Iteration-level scheduling: admission happens BETWEEN
                # decode steps — non-blocking while sequences are active,
                # blocking (bounded) when idle.
                self._admit_paged(0.0 if busy else idle_block_s)
                pre = self._prefill_step()
                dec = self._decode_once_paged()
                if pre or dec:
                    self.metrics.observe_iteration(pre, dec)
            except Exception as e:
                # One poisoned batch must not take the replica down.
                self._recover(e)

    def generate(self, prompt: Sequence[int], max_new_tokens: int = 16,
                 eos_id: Optional[int] = None,
                 timeout_s: float = 300.0,
                 tenant: str = "default") -> List[int]:
        """Submit one greedy request through the running loop and wait."""
        if self._thread is None:
            self.start()
        r = Request(prompt, max_new_tokens=max_new_tokens, eos_id=eos_id,
                    tenant=tenant)
        self.batcher.submit(r)
        return r.result(timeout=timeout_s)
