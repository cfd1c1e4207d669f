"""Sequence-parallel long-prompt prefill for the serving engine.

Port of ``horovod_tpu/serve/seqpar.py``.  Single-rank chunked prefill
scales TTFT linearly with the prompt's length.  This module lets a
replica split a long prompt (past ``HVD_SERVE_SP_MIN_TOKENS``) by
SEQUENCE EXTENT across ``HVD_SERVE_SP`` ranks, Ring-Attention style
(``parallel/ring.py``):

* each rank owns one block-aligned extent
  (``batcher.sp_extent_tokens``) and runs it through the adapter's
  ``sp_prefill_chunk``: the chunked-prefill scatter into a per-rank SIDE
  pool plus the ring's ragged fold (``ring.ragged_fold``), with prior
  extents' K/V arriving in hop buffers as the ring would rotate them;
* after an extent finishes, its blocks hand off to the decode-owning
  rank through the tier transport's block serialisation
  (``tiering.pack_payload`` / ``unpack_payload``, scale rows included)
  ahead of decode, so decode stays the single-rank paged path (the
  paged-attention kernel on a card) and the tokens match single-rank
  prefill;
* the first generated token comes from the last extent's final-position
  logits, drawn on the host as the single-rank logits path draws it.

**Emulated world.**  The rank set is emulated in one process: ranks run
one after another on the engine loop thread, one chunk per engine
iteration (so decode keeps interleaving), and the job's *emulated wall
clock* is ``max(per-rank compute) + final handoff``: what a simultaneous
rank set would spend, since every rank's hop inputs are data another
rank finished strictly earlier in ring order.  The hop schedule is
written to the timeline through ``ring.emit_hop_schedule``.

One job runs at a time (the SP world is a latency device for the longest
prompts, not a throughput pool); admission marks overflow prompts
``sp_denied`` (``batcher._sp_charge``) and they prefill single-rank.  A
faultline ``kill-rank`` at the ``sp.prefill`` point aborts the job
mid-flight: every rank's blocks are freed and the request resubmits
whole through the preemption path.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Tuple

import torch

from .batcher import sp_extent_tokens
from .blocks import BlockManager
from .tiering import make_block_io, pack_payload, unpack_payload


class SPConfig:
    """Knob bundle of sequence-parallel prefill (``HVD_SERVE_SP_*``).
    ``ranks < 2`` disables the subsystem: the engine then builds no
    SPWorld."""

    def __init__(self, ranks: Optional[int] = None,
                 min_tokens: Optional[int] = None):
        self.ranks = int(os.environ.get("HVD_SERVE_SP", "0")
                         if ranks is None else ranks)
        self.min_tokens = int(
            os.environ.get("HVD_SERVE_SP_MIN_TOKENS", "256")
            if min_tokens is None else min_tokens)

    @property
    def enabled(self) -> bool:
        return self.ranks >= 2


def _dequant_host(vals: torch.Tensor,
                  scales: Optional[torch.Tensor]) -> torch.Tensor:
    """The dequantizing load of a handed-off host payload, bit-equal to
    ``paged_attention.dequantize_kv`` on the device (the same two IEEE
    f32 operations in the same order): the hop buffers carry what
    single-rank attention reads out of the pool."""
    v32 = vals.float()
    if scales is None:
        return v32
    return v32 * scales.float()[..., None]


class SPJob:
    """One in-flight sequence-parallel prefill: the per-rank extent
    cursors, hop buffers, block tables and the emulated-clock
    accounting.  Owned by the SPWorld; the engine holds it on the
    sequence (``_Seq.sp_state``)."""

    __slots__ = ("seq", "slot", "prompt", "extents", "ltables", "rank",
                 "q_pos", "hop_k", "hop_v", "hop_len", "rank_secs",
                 "handoff_secs", "handoff_tail_s", "handoff_bytes",
                 "ring_hops", "final_logits", "done", "t0", "spans")

    def __init__(self, seq, slot: int, prompt: List[int],
                 extents: List[Tuple[int, int]],
                 ltables: List[List[int]]):
        self.seq = seq
        self.slot = slot
        self.prompt = prompt
        self.extents = extents          # [(start, len)] per rank
        self.ltables = ltables          # per-rank block ids (rank pools)
        self.rank = 0                   # current emulated rank
        self.q_pos = 0                  # absolute cursor in current extent
        # [L, hop_len, H, Dh] f32 on the adapter's device
        self.hop_k: Optional[torch.Tensor] = None
        self.hop_v: Optional[torch.Tensor] = None
        self.hop_len = 0
        self.rank_secs = [0.0] * len(extents)
        self.handoff_secs = 0.0
        self.handoff_tail_s = 0.0
        self.handoff_bytes = 0
        self.ring_hops = 0
        self.final_logits = None        # [V] host logits of the last chunk
        self.done = False
        self.t0 = time.monotonic()
        #: (name, t0, t1, args) span records the engine emits under the
        #: request's prefill stage (the world layer has no tracer).
        self.spans: List[tuple] = []

    @property
    def emulated_wall_s(self) -> float:
        """What a simultaneous rank set would spend: the slowest rank's
        compute plus the LAST extent's handoff (earlier extents' handoffs
        overlap later ranks' compute)."""
        return max(self.rank_secs or [0.0]) + self.handoff_tail_s


class SPWorld:
    """The emulated multi-rank prefill world: per-rank side pools and
    block managers, one job at a time.

    All device IO runs on the engine loop thread (the tiering
    discipline); the world keeps no lock of its own."""

    def __init__(self, adapter, ranks: int, min_tokens: int,
                 replica_id: str = "replica-0"):
        if ranks < 2:
            raise ValueError(f"SP world needs >= 2 ranks, got {ranks}")
        self.adapter = adapter
        self.ranks = ranks
        self.min_tokens = max(int(min_tokens), 1)
        self.replica_id = replica_id
        mb = adapter.max_blocks_per_seq
        #: side-pool geometry shared by every rank
        self.blocks_per_rank = mb
        self.pools = [adapter.sp_pool(mb) for _ in range(ranks)]
        self.managers = [
            BlockManager(mb, adapter.block_tokens, prefix_cache=False,
                         bytes_per_block=adapter.paged_block_bytes())
            for _ in range(ranks)]
        self.job: Optional[SPJob] = None
        # lifetime counters (kv_stats / metrics)
        self.jobs_total = 0
        self.aborts_total = 0
        self.sp_tokens_total = 0
        self.handoff_bytes_total = 0
        self.ring_hops_total = 0
        self.walls: List[float] = []    # emulated wall per finished job

    # -- geometry -------------------------------------------------------------

    def extent_tokens(self, prompt_len: int) -> int:
        return sp_extent_tokens(prompt_len, self.ranks,
                                self.adapter.block_tokens)

    def extents_of(self, prompt_len: int) -> List[Tuple[int, int]]:
        """Block-aligned ``(start, len)`` per rank; trailing ranks can
        be partial or empty (P=33, 4 ranks, BT=16 → 16, 16, 1, 0)."""
        ext = self.extent_tokens(prompt_len)
        return [(r * ext, max(0, min(ext, prompt_len - r * ext)))
                for r in range(self.ranks)]

    def extent_cost_blocks(self, prompt_len: int) -> int:
        """Per-rank transient blocks a job would claim: the batcher's
        ``sp_cost`` (admission costing)."""
        bt = self.adapter.block_tokens
        return -(-self.extent_tokens(prompt_len) // bt)

    def free_extent_blocks(self) -> int:
        """Admission capacity: per-rank free blocks, zero while a job
        runs (one job at a time: a second long prompt prefills
        single-rank rather than queue behind the world)."""
        if self.job is not None:
            return 0
        return min(m.available() for m in self.managers)

    def _hop_bytes(self) -> int:
        """K+V bytes one ring hop rotates (one extent, all layers, f32
        on the wire: dequantized hop buffers)."""
        ad = self.adapter
        ext = self.extent_tokens(ad.max_len)
        return 2 * ext * ad.num_heads * ad.head_dim * 4 * ad.num_layers

    def ring_bytes_per_prefill(self) -> int:
        """Worst-case wire bytes one SP prefill rotates over the ring:
        ``n * (n-1)`` hops (a rotation still runs on a skipped shard;
        only its fold is skipped) × one extent's K+V."""
        n = self.ranks
        return n * (n - 1) * self._hop_bytes()

    def prime(self, engine) -> None:
        """Round-trip one block of the engine's (still empty) pool
        through the handoff path (``make_block_io``'s copies and the
        codec) at construction, so the first real handoff finds its
        copy path loaded."""
        extract, insert = make_block_io(engine)
        insert(0, unpack_payload(pack_payload(extract(0))))

    # -- job lifecycle --------------------------------------------------------

    def begin(self, seq, slot: int) -> Optional[SPJob]:
        """Claim the world for one sequence: allocate every rank's extent
        blocks all-or-nothing.  None (the caller prefills single-rank)
        when a job is active or a rank's pool cannot fit its extent."""
        if self.job is not None:
            return None
        prompt = list(seq.request.prompt)
        extents = self.extents_of(len(prompt))
        bt = self.adapter.block_tokens
        ltables: List[List[int]] = []
        claimed: List[int] = []
        try:
            for r, (_, ln) in enumerate(extents):
                need = -(-ln // bt)
                ltables.append(self.managers[r].allocate(need)
                               if need else [])
                claimed.append(r)
        except Exception:
            for r in claimed:
                self.managers[r].free_table(ltables[r])
            return None
        job = SPJob(seq, slot, prompt, extents, ltables)
        # Skip leading empty extents (not possible for rank 0, but keep
        # the cursor invariant: job.rank always points at a live extent).
        while job.rank < self.ranks and job.extents[job.rank][1] == 0:
            job.rank += 1
        if job.rank < self.ranks:
            job.q_pos = job.extents[job.rank][0]
        self.job = job
        self.jobs_total += 1
        return job

    def step(self, engine, chunk_budget: Optional[int]) -> SPJob:
        """Advance the job ONE chunk on the current emulated rank (at
        most ``chunk_budget`` tokens, the engine's chunked-prefill budget;
        decode interleaves between calls).  A finished extent extends the
        hop buffers and hands its blocks off into the engine's pool; the
        last extent completes the job."""
        job = self.job
        assert job is not None and not job.done
        start, ln = job.extents[job.rank]
        end = start + ln
        take = end - job.q_pos
        if chunk_budget:
            take = min(take, chunk_budget)
        chunk = job.prompt[job.q_pos:job.q_pos + take]
        t0 = time.monotonic()
        pool, logits = self.adapter.sp_prefill_chunk(
            self.pools[job.rank], chunk, job.q_pos, start,
            job.ltables[job.rank],
            hop_k=job.hop_k, hop_v=job.hop_v, hop_len=job.hop_len)
        self.pools[job.rank] = pool
        t1 = time.monotonic()
        job.rank_secs[job.rank] += t1 - t0
        job.spans.append(("sp-extent-chunk", t0, t1,
                          {"rank": job.rank, "start": job.q_pos,
                           "tokens": take, "hop_len": job.hop_len}))
        job.q_pos += take
        self.sp_tokens_total += take
        if job.q_pos >= end:
            job.ring_hops += job.rank  # causal folds this rank performed
            job.final_logits = logits  # the last extent's logits win
            self._finish_extent(engine, job)
            job.rank += 1
            while (job.rank < self.ranks
                   and job.extents[job.rank][1] == 0):
                job.rank += 1
            if job.rank >= self.ranks:
                job.done = True
                self.ring_hops_total += job.ring_hops
                self.walls.append(job.emulated_wall_s)
            else:
                job.q_pos = job.extents[job.rank][0]
        return job

    def _finish_extent(self, engine, job: SPJob) -> None:
        """Extent complete on rank ``job.rank``: extend the hop buffers
        with its (dequantized, pool-roundtripped) K/V for the next ranks'
        folds, and ship its blocks into the engine's pool at the
        sequence's table slots through ``pack_payload`` /
        ``unpack_payload``, the tier transport's serialisation, scale
        rows included.  Ahead of decode: when the last extent finishes,
        every earlier extent's blocks already sit in the decode pool."""
        r = job.rank
        start, ln = job.extents[r]
        bt = self.adapter.block_tokens
        pool = self.pools[r]
        t0 = time.monotonic()
        _, insert = make_block_io(engine)
        ks, vs = [], []
        shipped = 0
        for j, bid in enumerate(job.ltables[r]):
            payload = {k: a[:, bid].to("cpu", copy=True)
                       for k, a in pool.items()}
            # hop extension: what the ring would rotate onward
            ks.append(_dequant_host(payload["k"], payload.get("k_scale")))
            vs.append(_dequant_host(payload["v"], payload.get("v_scale")))
            # handoff: the tier transport's wire format
            blob = pack_payload(payload)
            shipped += len(blob)
            insert(job.seq.table[start // bt + j], unpack_payload(blob))
        self.managers[r].free_table(job.ltables[r])
        job.ltables[r] = []
        if ks:
            dev = self.adapter.device
            hk = torch.cat(ks, dim=1)[:, :ln].to(dev)
            hv = torch.cat(vs, dim=1)[:, :ln].to(dev)
            if job.hop_k is None:
                job.hop_k, job.hop_v = hk, hv
            else:
                job.hop_k = torch.cat([job.hop_k, hk], dim=1)
                job.hop_v = torch.cat([job.hop_v, hv], dim=1)
            job.hop_len += ln
        t1 = time.monotonic()
        # Rank 0 owns the decode: its "handoff" is a local pool move with
        # no wire bytes; only the other extents count.
        if r > 0:
            job.handoff_bytes += shipped
            self.handoff_bytes_total += shipped
        job.handoff_secs += t1 - t0
        job.handoff_tail_s = t1 - t0
        job.spans.append(("sp-handoff", t0, t1,
                          {"rank": r, "blocks": -(-ln // bt),
                           "bytes": shipped if r > 0 else 0}))

    def finish(self, job: SPJob) -> None:
        """Release the world after the engine consumed the job."""
        if self.job is job:
            self.job = None

    def abort(self, job: SPJob) -> None:
        """kill-rank / preemption: free every rank's extent blocks (no
        leak on any rank; the faultline drill pins it) and release the
        world.  The engine requeues the request whole."""
        for r, tbl in enumerate(job.ltables):
            if tbl:
                self.managers[r].free_table(tbl)
                job.ltables[r] = []
        job.done = True
        self.aborts_total += 1
        if self.job is job:
            self.job = None

    # -- warmup ---------------------------------------------------------------

    def warmup(self, chunk_budget: Optional[int]) -> int:
        """Run the largest chunk an eligible prompt can give a rank,
        without and with the largest hop buffer, on rank 0's pool through
        an all-hole table (every write drops; the output is discarded),
        so a revived replica's first long prompt finds the fold's
        kernels and allocations ready.  JAX compiles its whole (chunk,
        hop) bucket lattice here; the port runs true lengths and has no
        lattice.  Returns the number of chunks run."""
        ad = self.adapter
        ext_cap = self.extent_tokens(ad.max_len)
        c = min(chunk_budget or ext_cap, ext_cap)
        hop = min((self.ranks - 1) * ext_cap, ad.max_len - c)
        shape = (ad.num_layers, hop, ad.num_heads, ad.head_dim)
        buf = torch.zeros(shape, dtype=torch.float32, device=ad.device)
        runs = 0
        for kh in (0, hop):
            self.pools[0], _ = ad.sp_prefill_chunk(
                self.pools[0], [0] * c, kh, kh, [],
                hop_k=buf, hop_v=buf, hop_len=kh)
            runs += 1
        return runs

    # -- introspection --------------------------------------------------------

    def stats(self) -> Dict[str, object]:
        """kv_stats["sp"] / the replica's healthz payload."""
        return {
            "ranks": self.ranks,
            "min_tokens": self.min_tokens,
            "blocks_per_rank": self.blocks_per_rank,
            "ring_bytes_per_prefill": self.ring_bytes_per_prefill(),
            "jobs": self.jobs_total,
            "aborts": self.aborts_total,
            "sp_tokens": self.sp_tokens_total,
            "handoff_bytes": self.handoff_bytes_total,
            "ring_hops": self.ring_hops_total,
            "active": self.job is not None,
        }
