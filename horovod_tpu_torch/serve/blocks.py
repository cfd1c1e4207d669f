"""Block-paged KV-cache bookkeeping: pool, block tables, prefix cache.

Copied unchanged from ``horovod_tpu/serve/blocks.py`` (pure Python;
the port keeps its own copy and never imports the JAX package).

The design is vLLM's PagedAttention memory manager (Kwon et al., SOSP '23)
reduced to what a single-replica engine needs:

* the physical cache is a pool of fixed-size **blocks** of
  ``block_tokens`` token positions each (``HVD_SERVE_BLOCK_TOKENS``,
  default 16) instead of one contiguous ``max_len`` region per slot — a
  sequence holds exactly ``ceil(tokens / block_tokens)`` blocks, so a
  short answer no longer reserves a long answer's worth of HBM;
* a sequence addresses its cache through a **block table** (logical block
  index → physical block id); the attention programs gather K/V through
  that table (engine.py), so physical placement is arbitrary;
* **prefix caching**: every *full* block of a prompt is content-hashed by
  the chain ``h_i = hash(h_{i-1}, tokens[i*B:(i+1)*B])`` — equal chains
  mean equal token prefixes mean (causal attention) bit-equal K/V, so a
  later request sharing the prefix maps the same physical blocks and
  skips their prefill entirely.  Blocks whose last active reference drops
  are *retained* (refcount 0, still registered) and only evicted LRU when
  the free list runs dry;
* **copy-on-write**: sharing is only ever of full, immutable prompt
  blocks, so the greedy single-sample engine never writes into a shared
  block — but ``ensure_writable`` implements the CoW step anyway (fork a
  private copy on first divergence) so forked/speculative decoding can
  reuse the manager, and the engine calls it defensively before every
  append into an existing block.

All bookkeeping is host-side integers; the device arrays live in the
adapter's pool (engine.py).  Mutations come from the engine thread while
``stats()`` is sampled by metrics/HTTP threads, hence the internal lock.
"""

from __future__ import annotations

import threading
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Sequence, Tuple


class NoFreeBlocksError(Exception):
    """The pool is exhausted even after evicting every retained
    (prefix-cached, unreferenced) block."""


def chain_hashes(tokens: Sequence[int], block_tokens: int,
                 salt: int = 0) -> List[int]:
    """Chained content hashes of the FULL blocks of ``tokens``.

    ``h_i`` covers tokens ``[0, (i+1)*block_tokens)`` — chaining makes the
    hash positional, so block content [5,6] at offset 0 and at offset 16
    never collide.  Partial tail blocks get no hash (never shared).

    ``salt`` seeds the chain: the engine salts per (model, version)
    (registry.model_salt) so prefixes never match across variants or
    across a weight roll — equal tokens under DIFFERENT weights produce
    different K/V, which sharing must never conflate.  Salt 0 is the
    default model at version 0, keeping legacy hashes byte-exact."""
    out: List[int] = []
    h = salt
    for i in range(len(tokens) // block_tokens):
        h = hash((h, tuple(tokens[i * block_tokens:(i + 1) * block_tokens])))
        out.append(h)
    return out


class BlockManager:
    """Refcounted fixed-size KV block pool with a full-block prefix cache
    (module doc).  Thread-safe; owned by one engine."""

    def __init__(self, num_blocks: int, block_tokens: int,
                 prefix_cache: bool = True,
                 bytes_per_block: Optional[int] = None):
        if num_blocks < 1 or block_tokens < 1:
            raise ValueError(
                f"need positive pool ({num_blocks} blocks x {block_tokens} "
                f"tokens)")
        self.num_blocks = num_blocks
        self.block_tokens = block_tokens
        # HBM bytes one physical block costs (K+V payload across layers
        # + quantization scale rows; adapter.paged_block_bytes) — what
        # makes block counts comparable across KV storage dtypes: the
        # bench's fixed-HBM-budget arms size pools in BYTES and read the
        # admit_ratio win of int8 blocks off this accounting.
        self.bytes_per_block = bytes_per_block
        self.prefix_cache_enabled = prefix_cache
        self._lock = threading.Lock()
        self._free: deque = deque(range(num_blocks))
        self._ref = [0] * num_blocks
        self._hash_of: List[Optional[int]] = [None] * num_blocks
        self._registry: Dict[int, int] = {}   # chain hash -> block id
        # refcount-0 blocks still registered: evictable, LRU order.
        self._retained: "OrderedDict[int, None]" = OrderedDict()
        self.cow_copies = 0
        self.evictions = 0
        self.prefix_hit_tokens = 0
        self.prefix_lookup_tokens = 0
        # High-water mark of referenced blocks — with bytes_per_block
        # this is the pool's peak HBM footprint, which is what makes
        # n>1 prompt-block sharing measurable (an n-way fork's peak must
        # sit strictly below n independent sequences').
        self.used_peak = 0

    # -- sizing ---------------------------------------------------------------

    def blocks_for(self, tokens: int) -> int:
        return -(-max(tokens, 0) // self.block_tokens)

    @property
    def capacity(self) -> int:
        return self.num_blocks

    def available(self) -> int:
        """Blocks an admission could claim right now: free + evictable."""
        with self._lock:
            return len(self._free) + len(self._retained)

    # -- allocation -----------------------------------------------------------

    def allocate(self, n: int = 1) -> List[int]:
        """Claim ``n`` fresh private blocks (refcount 1 each), evicting
        LRU retained blocks if the free list runs dry.  All-or-nothing:
        raises ``NoFreeBlocksError`` without claiming any."""
        with self._lock:
            if n > len(self._free) + len(self._retained):
                raise NoFreeBlocksError(
                    f"need {n} blocks; {len(self._free)} free + "
                    f"{len(self._retained)} evictable of {self.num_blocks}")
            out = []
            for _ in range(n):
                if not self._free:
                    self._evict_retained_locked()
                bid = self._free.popleft()
                self._ref[bid] = 1
                out.append(bid)
            self._note_used_locked()
            return out

    def _note_used_locked(self) -> None:
        used = self.num_blocks - len(self._free) - len(self._retained)
        if used > self.used_peak:
            self.used_peak = used

    def _evict_retained_locked(self) -> int:
        """Evict the LRU retained block (caller holds the lock):
        unregister its hash and return it to the free list.  The single
        home of the registry/retained/free-list invariant — allocation
        pressure and corruption scrubs both go through here.  Subclasses
        that mirror the registry elsewhere (the tiered manager's host
        copies and fleet directory entries, version-salted per model)
        MUST hook this to reclaim those mirrors too: a peer fetching the
        evicted chain hash after the payload is reclaimed — or after its
        model version rolled — would serve wrong K/V silently."""
        victim, _ = self._retained.popitem(last=False)  # LRU
        del self._registry[self._hash_of[victim]]
        self._hash_of[victim] = None
        self._free.append(victim)
        self.evictions += 1
        return victim

    def ref(self, block_id: int) -> None:
        with self._lock:
            self._ref_locked(block_id)

    def _ref_locked(self, block_id: int) -> None:
        if self._ref[block_id] == 0:
            self._retained.pop(block_id, None)
        self._ref[block_id] += 1
        self._note_used_locked()

    def free(self, block_id: int) -> None:
        """Drop one reference.  A registered block with no references is
        RETAINED for prefix reuse (evicted only under pressure); an
        unregistered one returns to the free list immediately."""
        with self._lock:
            self._ref[block_id] -= 1
            if self._ref[block_id] < 0:
                raise ValueError(f"double free of block {block_id}")
            if self._ref[block_id] == 0:
                if self._hash_of[block_id] is not None:
                    self._retained[block_id] = None  # most-recently used
                    self._retained.move_to_end(block_id)
                else:
                    self._free.append(block_id)

    def free_table(self, block_ids: Sequence[int]) -> None:
        for bid in block_ids:
            self.free(bid)

    # -- prefix cache ---------------------------------------------------------

    def lookup_prefix(self, prompt: Sequence[int],
                      hashes: Optional[Sequence[int]] = None
                      ) -> Tuple[List[int], int]:
        """Longest cached full-block prefix of ``prompt``.

        Returns ``(block_ids, matched_tokens)`` with one reference claimed
        on each returned block.  Capped at ``len(prompt) - 1`` tokens: the
        prefill must run at least the prompt's last token to produce the
        first generated token's logits, so a fully-cached prompt reuses
        all but its final block.  ``hashes`` may carry the prompt's
        precomputed ``chain_hashes`` (the caller usually needs them for
        registration anyway — hashing is O(prompt))."""
        if not self.prefix_cache_enabled:
            return [], 0
        usable = (len(prompt) - 1) // self.block_tokens
        if hashes is None:
            hashes = chain_hashes(prompt, self.block_tokens)
        hashes = list(hashes)[:usable]
        with self._lock:
            self.prefix_lookup_tokens += max(len(prompt), 0)
            ids: List[int] = []
            for h in hashes:
                bid = self._registry.get(h)
                if bid is None:
                    break
                self._ref_locked(bid)
                ids.append(bid)
            self.prefix_hit_tokens += len(ids) * self.block_tokens
            return ids, len(ids) * self.block_tokens

    def register(self, chain_hash: int, block_id: int,
                 salt: int = 0) -> None:
        """Publish a full immutable block for prefix reuse.  First writer
        wins: a duplicate hash (two requests prefilling the same prompt
        concurrently) keeps the existing mapping to avoid churn.

        ``salt`` is the (model, version) chain seed the hash was built
        under (registry.model_salt).  The base manager ignores it — the
        hash already encodes it — but the tiered manager (tiering.py)
        records it so spilled/published copies of the block can be
        scrubbed per version on a weight roll."""
        if not self.prefix_cache_enabled:
            return
        with self._lock:
            if chain_hash in self._registry \
                    or self._hash_of[block_id] is not None:
                return
            self._registry[chain_hash] = block_id
            self._hash_of[block_id] = chain_hash

    def invalidate_retained(self, n: int = 1) -> int:
        """Scrub up to ``n`` retained (refcount-0, prefix-registered)
        blocks: unregister and return them to the free list, LRU first.
        This is the recovery action for "this block's contents are
        suspect" (faultline's ``pool-corrupt-block``, or a real ECC/HBM
        scrub): a corrupted block must leave the registry — a later
        prefix hit on it would serve wrong K/V silently — while blocks
        still referenced by live sequences are *not* touched (their
        owners re-prefill on the failure path, not here).  Returns how
        many blocks were scrubbed."""
        with self._lock:
            scrubbed = 0
            while scrubbed < n and self._retained:
                self._evict_retained_locked()
                scrubbed += 1
            return scrubbed

    # -- copy-on-write --------------------------------------------------------

    def ensure_writable(self, block_id: int) -> Tuple[int, bool]:
        """CoW step: before appending K/V into ``block_id``, fork it if
        anything else could observe the write — it is shared (refcount >
        1) or published in the prefix registry (its hash must keep
        matching its contents).  Returns ``(block_to_write, copied)``;
        when ``copied`` the caller must copy the device contents from
        ``block_id`` to the returned block, swap its table entry, and
        only THEN ``free(block_id)`` — the old reference is deliberately
        kept until the copy succeeds, so a failed device copy cannot
        double-free (or, on a truly shared block, silently release) a
        block other sequences still address."""
        with self._lock:
            if self._ref[block_id] <= 1 and self._hash_of[block_id] is None:
                return block_id, False
        fresh = self.allocate(1)[0]
        with self._lock:
            self.cow_copies += 1
        return fresh, True

    # -- introspection --------------------------------------------------------

    def refcount(self, block_id: int) -> int:
        with self._lock:
            return self._ref[block_id]

    def stats(self) -> dict:
        with self._lock:
            free = len(self._free)
            retained = len(self._retained)
            lookups = self.prefix_lookup_tokens
            byte_stats = {}
            if self.bytes_per_block is not None:
                byte_stats = {
                    "bytes_per_block": self.bytes_per_block,
                    "kv_bytes_per_token":
                        self.bytes_per_block / self.block_tokens,
                    "bytes_total": self.bytes_per_block * self.num_blocks,
                }
            return {
                "total": self.num_blocks,
                "block_tokens": self.block_tokens,
                **byte_stats,
                "free": free,
                "retained": retained,
                "used": self.num_blocks - free - retained,
                "used_peak": self.used_peak,
                "cow": self.cow_copies,
                "evictions": self.evictions,
                "prefix_hit_tokens": self.prefix_hit_tokens,
                "prefix_lookup_tokens": lookups,
                "prefix_hit_rate": (self.prefix_hit_tokens / lookups
                                    if lookups else 0.0),
            }
