"""Tiered KV hierarchy: host-RAM block offload, ahead-of-decode prefetch
and cross-replica prefix-block migration.

Port of ``horovod_tpu/serve/tiering.py``.  One card's memory bounds how
many sequences a replica holds, and a cached prefix is lost the moment
routing lands a session's next turn on another replica.  The paged KV
pool (``serve/blocks.py``) grows into a three-level hierarchy:

* **device pool** — the BlockManager's blocks, as before;
* **host tier** (RAM) — under pool pressure ``TieredBlockManager``
  spills the coldest *retained* prefix blocks host-ward (payload and
  scale rows) instead of evicting them, and the engine swaps whole cold
  sequences out the same way instead of preempting them back to the
  prompt.  A spilled block keeps its chain hash: a later prefix hit
  promotes it into a fresh device block, and ``ensure_writable`` faults
  a staged payload in BEFORE the copy-on-write fork, so the refcount /
  CoW / retained-LRU contract is unchanged;
* **KV-server tier** (fleet-shared) — blocks cold past
  ``HVD_SERVE_TIER_DEMOTE_ITERS`` engine iterations demote over the KV
  transport (``runner/http_server.py``), content-addressed by their
  version-salted chain hash, next to a **block directory** (chain hash
  → holder replica).  On a local miss the engine probes the directory
  and *migrates* the prefix blocks into its own pool instead of
  prefilling them again; version salts (``registry.model_salt``) keep
  rolled models apart, and ``mark_dead`` / a roll unpublish a replica's
  entries so a peer never fetches a payload that was reclaimed.

The ahead-of-decode prefetcher rides the engine loop: migrations and
swap-ins are issued as fetches on the tier worker thread one iteration
early and applied at the next iteration top.  The loop stalls only when
a fetch loses that race AND nothing else is runnable; each stall
episode is counted (``tier_faults``), histogrammed
(``hvd_serve_tier_fault_stall_ms``) and traced as a ``tier-fault``
span.  Fetch failure is injectable (faultline ``delay-tier-fetch`` /
``drop-tier-block`` at the ``tier.fetch`` point, once per attempt,
riding the KV client's retry backoff) and degrades to recompute: the
prompt is prefilled from the miss point, which gives the same tokens.

Payloads are dicts of CPU tensors, one per pool leaf (``k``, ``v`` and,
for int8 / fp8 pools, the f16 ``k_scale`` / ``v_scale`` rows).  The
wire format is the JAX package's byte for byte: a JSON header with
numpy's dtype names (``"bfloat16"``, ``"float8_e4m3fn"``, ...) and the
raw bytes, which move through a ``uint8`` view, so neither side needs a
dtype numpy lacks, and one package's blob is the other's.

Lock discipline: device IO (extract / insert) NEVER runs under
``TieredBlockManager._lock`` or the host tier's lock.  Allocation
pre-spills by unregistering the victim under the lock, extracting
outside it, then returning the block to the free list.  All device IO
happens on the engine loop thread; the tier worker thread only does
network and (de)serialisation and takes the manager lock for plain
bookkeeping.
"""

from __future__ import annotations

import json
import os
import queue
import struct
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..utils import get_logger
from .blocks import BlockManager, NoFreeBlocksError, chain_hashes

#: KV-server scopes of the fleet tier: the block directory (chain hash →
#: holder metadata), the content-addressed block payloads, and the
#: replica-private swapped-sequence payloads.
DIR_SCOPE = "hvdtier-dir"
BLK_SCOPE = "hvdtier-blk"
SWAP_SCOPE = "hvdtier-swap"

#: The pool leaves' torch dtypes ↔ the numpy dtype names the JAX
#: package's header carries (K/V storage, f16 scale rows).
_DTYPE_NAMES = {
    torch.float32: "float32", torch.bfloat16: "bfloat16",
    torch.float16: "float16", torch.int8: "int8",
    torch.float8_e4m3fn: "float8_e4m3fn",
}
_DTYPES = {name: dt for dt, name in _DTYPE_NAMES.items()}

Payload = Dict[str, torch.Tensor]


def pack_payload(payload: Payload) -> bytes:
    """Serialize one block's pool rows (K/V payload and scale rows, CPU
    tensors) into a self-describing blob: a JSON header (key → dtype /
    shape, sorted) and the raw bytes in key order."""
    keys = sorted(payload)
    leaves = {k: payload[k].contiguous() for k in keys}
    header = {k: {"dtype": _DTYPE_NAMES[leaves[k].dtype],
                  "shape": list(leaves[k].shape)} for k in keys}
    hb = json.dumps(header, sort_keys=True).encode("ascii")
    parts = [struct.pack("<I", len(hb)), hb]
    for k in keys:
        parts.append(leaves[k].reshape(-1).view(torch.uint8)
                     .numpy().tobytes())
    return b"".join(parts)


def unpack_payload(blob: bytes) -> Payload:
    """Inverse of ``pack_payload``, bit for bit (the spill / promote
    exactness covers the quantized scale rows too)."""
    (hlen,) = struct.unpack_from("<I", blob, 0)
    header = json.loads(blob[4:4 + hlen].decode("ascii"))
    out: Payload = {}
    off = 4 + hlen
    for k in sorted(header):
        dt = _DTYPES[header[k]["dtype"]]
        shape = tuple(header[k]["shape"])
        n = dt.itemsize
        for d in shape:
            n *= d
        raw = (torch.frombuffer(bytearray(blob[off:off + n]),
                                dtype=torch.uint8) if n
               else torch.empty((0,), dtype=torch.uint8))
        out[k] = raw.view(dt).reshape(shape)
        off += n
    return out


def payload_nbytes(payload: Payload) -> int:
    return sum(int(a.numel() * a.element_size()) for a in payload.values())


class TierConfig:
    """Knob bundle of the tier (``HVD_SERVE_TIER_*``).

    ``enabled`` gates everything: with it off (the default) the engine
    builds a plain BlockManager and no tier code runs."""

    def __init__(self, enabled: bool = True,
                 host_blocks: int = 0,
                 demote_iters: int = 128,
                 prefetch: int = 4,
                 oversub: float = 4.0,
                 quantum: int = 8,
                 fetch_timeout_s: float = 2.0,
                 kv_addr: str = "",
                 publish: bool = True):
        self.enabled = enabled
        # 0 = default sizing (4x the device pool, set by the manager).
        self.host_blocks = int(host_blocks)
        self.demote_iters = max(int(demote_iters), 1)
        self.prefetch = max(int(prefetch), 0)
        self.oversub = max(float(oversub), 1.0)
        self.quantum = max(int(quantum), 1)
        self.fetch_timeout_s = max(float(fetch_timeout_s), 0.05)
        self.kv_addr = kv_addr
        self.publish = bool(publish)

    @classmethod
    def from_env(cls) -> Optional["TierConfig"]:
        if os.environ.get("HVD_SERVE_TIER", "0") in ("0", "false", ""):
            return None
        return cls(
            enabled=True,
            host_blocks=int(os.environ.get(
                "HVD_SERVE_TIER_HOST_BLOCKS", "0")),
            demote_iters=int(os.environ.get(
                "HVD_SERVE_TIER_DEMOTE_ITERS", "128")),
            prefetch=int(os.environ.get("HVD_SERVE_TIER_PREFETCH", "4")),
            oversub=float(os.environ.get("HVD_SERVE_TIER_OVERSUB", "4.0")),
            quantum=int(os.environ.get("HVD_SERVE_TIER_QUANTUM", "8")),
            fetch_timeout_s=float(os.environ.get(
                "HVD_SERVE_TIER_FETCH_TIMEOUT_S", "2.0")),
            kv_addr=os.environ.get("HVD_SERVE_TIER_KV", ""),
            publish=os.environ.get("HVD_SERVE_TIER_PUBLISH", "1")
            not in ("0", "false"))


def make_block_io(engine) -> Tuple[Callable, Callable]:
    """Device-IO pair over ``engine._cache`` (the paged pool: every leaf
    has the block dim at axis 1, payload and scale rows alike, so one
    per-block slice covers them all).

    ``extract(bid)`` copies one physical block's rows to the host (a copy
    even when the pool is on the CPU: the pool is written in place).
    ``insert(bid, payload)`` writes them back in place with ``copy_``.
    Both must run on the engine loop thread only, never under a lock."""

    def extract(bid: int) -> Payload:
        return {k: a[:, bid].to("cpu", copy=True)
                for k, a in engine._cache.items()}

    def insert(bid: int, payload: Payload) -> None:
        for k, a in engine._cache.items():
            a[:, bid].copy_(payload[k])

    return extract, insert


class _HostEntry:
    __slots__ = ("payload", "salt", "nbytes", "step", "demoting")

    def __init__(self, payload: Payload, salt: int, step: int):
        self.payload = payload
        self.salt = salt
        self.nbytes = payload_nbytes(payload)
        self.step = step          # engine iteration at spill time
        self.demoting = False     # export to the KV tier in flight


class HostTier:
    """Host-RAM block store: chain hash → spilled payload, LRU-bounded
    at ``capacity`` blocks.  Own lock, never held across device IO and
    never nested inside the manager's."""

    def __init__(self, capacity: int):
        self.capacity = max(int(capacity), 1)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[int, _HostEntry]" = OrderedDict()
        self.evictions = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def bytes(self) -> int:
        with self._lock:
            return sum(e.nbytes for e in self._entries.values())

    def put(self, chain_hash: int, entry: _HostEntry) -> None:
        with self._lock:
            self._entries[chain_hash] = entry
            self._entries.move_to_end(chain_hash)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)  # LRU: the data is lost
                self.evictions += 1

    def pop(self, chain_hash: int) -> Optional[_HostEntry]:
        with self._lock:
            return self._entries.pop(chain_hash, None)

    def drop(self, chain_hash: int) -> None:
        with self._lock:
            self._entries.pop(chain_hash, None)

    def drop_salt(self, salt: int) -> int:
        """Scrub every entry of one (model, version) salt: the roll /
        unpublish path."""
        with self._lock:
            dead = [h for h, e in self._entries.items() if e.salt == salt]
            for h in dead:
                del self._entries[h]
            return len(dead)

    def contains(self, chain_hash: int) -> bool:
        with self._lock:
            return chain_hash in self._entries

    def cold(self, step: int, demote_iters: int) -> List[Tuple[int,
                                                               _HostEntry]]:
        """Entries cold past ``demote_iters`` iterations and not already
        demoting, marked demoting before return so one worker export is
        in flight per entry."""
        out = []
        with self._lock:
            for h, e in self._entries.items():
                if not e.demoting and step - e.step >= demote_iters:
                    e.demoting = True
                    out.append((h, e))
        return out

    def demote_failed(self, chain_hash: int) -> None:
        with self._lock:
            e = self._entries.get(chain_hash)
            if e is not None:
                e.demoting = False


class TierClient:
    """Fleet-tier transport over a ``KVStoreClient``: the block directory,
    content-addressed payload blobs and replica-private swap blobs.

    ``fetch`` / ``fetch_swap`` run their own bounded retry loop on the KV
    client's backoff (``HVD_KV_RETRY_*``), with the ``tier.fetch``
    faultline point consulted once per ATTEMPT: ``delay-tier-fetch``
    stalls the attempt, ``drop-tier-block`` fails it as a transport
    error; a train longer than the retry budget returns None and the
    caller degrades to recompute."""

    def __init__(self, kv, replica_id: str = "replica-0"):
        self.kv = kv
        self.replica_id = replica_id
        self.fetch_attempts = 0
        self.fetch_drops = 0

    @staticmethod
    def _key(chain_hash: int) -> str:
        return format(chain_hash & 0xFFFFFFFFFFFFFFFF, "016x")

    # -- publish / directory --------------------------------------------------

    def publish(self, chain_hash: int, salt: int, blob: bytes) -> bool:
        """Write the payload, then the directory entry (in that order, so
        a directory hit always has bytes behind it).  Best-effort: a
        transport failure logs and returns False (publication is an
        optimisation, never a correctness dependency)."""
        key = self._key(chain_hash)
        entry = json.dumps({"replica": self.replica_id,
                            "salt": salt}).encode("ascii")
        try:
            self.kv.put(BLK_SCOPE, key, blob)
            self.kv.put(DIR_SCOPE, key, entry)
            return True
        except (OSError, ConnectionError) as e:
            get_logger().debug("hvdtier: publish %s failed: %s", key, e)
            return False

    def lookup(self, chain_hash: int) -> Optional[dict]:
        """Directory probe: holder metadata or None."""
        try:
            raw = self.kv.get(DIR_SCOPE, self._key(chain_hash))
        except (OSError, ConnectionError) as e:
            get_logger().debug("hvdtier: dir probe failed: %s", e)
            return None
        if raw is None:
            return None
        try:
            return json.loads(raw.decode("ascii"))
        except (ValueError, UnicodeDecodeError):
            return None

    def unpublish(self, chain_hashes_: Sequence[int]) -> None:
        """Drop directory entries AND their payloads (mark_dead, roll,
        corruption scrub): a peer must never fetch a chain hash whose
        payload was reclaimed or belongs to rolled weights."""
        for h in chain_hashes_:
            key = self._key(h)
            for scope in (DIR_SCOPE, BLK_SCOPE):
                try:
                    self.kv.delete(scope, key)
                except (OSError, ConnectionError) as e:
                    get_logger().debug(
                        "hvdtier: unpublish %s/%s failed: %s",
                        scope, key, e)

    # -- fetch (the injectable path) ------------------------------------------

    def _fetch_raw(self, scope: str, key: str) -> Optional[bytes]:
        from ..faultline import runtime as _flrt
        last: Optional[BaseException] = None
        for attempt in range(self.kv.retry_max):
            self.fetch_attempts += 1
            try:
                if _flrt.PLAN is not None:
                    # ``tier.fetch`` injection point, once per attempt
                    # (a drop train of length n exercises n backoffs).
                    for f in _flrt.fire("tier.fetch", self.replica_id):
                        if f.kind == "delay-tier-fetch":
                            time.sleep(f.param if f.param is not None
                                       else 0.02)
                        elif f.kind == "drop-tier-block":
                            raise ConnectionError(
                                "faultline: tier block dropped")
                return self.kv.get(scope, key)
            except (OSError, ConnectionError) as e:
                last = e
                self.fetch_drops += 1
                if attempt + 1 >= self.kv.retry_max:
                    break
                time.sleep(self.kv._retry_backoff_s(attempt + 1))
        get_logger().warning(
            "hvdtier: fetch %s/%s exhausted %d attempts (%s); degrading "
            "to recompute", scope, key, self.kv.retry_max, last)
        return None

    def fetch(self, chain_hash: int) -> Tuple[Optional[bytes],
                                              Optional[dict]]:
        """Migration fetch: (payload blob, directory entry); (None, _)
        when the entry or its payload vanished (roll, eviction, transport
        failure past the retry budget)."""
        entry = self.lookup(chain_hash)
        if entry is None:
            return None, None
        blob = self._fetch_raw(BLK_SCOPE, self._key(chain_hash))
        return blob, entry

    # -- swapped-sequence payloads (replica-private) --------------------------

    def put_swap(self, key: str, blob: bytes) -> bool:
        try:
            self.kv.put(SWAP_SCOPE, key, blob)
            return True
        except (OSError, ConnectionError) as e:
            get_logger().debug("hvdtier: swap put %s failed: %s", key, e)
            return False

    def fetch_swap(self, key: str) -> Optional[bytes]:
        return self._fetch_raw(SWAP_SCOPE, key)

    def drop_swap(self, keys: Sequence[str]) -> None:
        for key in keys:
            try:
                self.kv.delete(SWAP_SCOPE, key)
            except (OSError, ConnectionError):
                pass  # best-effort GC of an ephemeral private blob


class TieredBlockManager(BlockManager):
    """BlockManager whose eviction pressure spills host-ward (module
    doc).  Every base-contract surface (allocate / free / refcount /
    register / lookup_prefix / ensure_writable / stats) behaves as the
    base class's from the engine's point of view: blocks just come BACK
    from the host and fleet tiers where the base would prefill them
    again."""

    def __init__(self, num_blocks: int, block_tokens: int,
                 config: TierConfig,
                 prefix_cache: bool = True,
                 bytes_per_block: Optional[int] = None,
                 client: Optional[TierClient] = None):
        super().__init__(num_blocks, block_tokens,
                         prefix_cache=prefix_cache,
                         bytes_per_block=bytes_per_block)
        self.config = config
        self.client = client
        hb = config.host_blocks if config.host_blocks > 0 \
            else num_blocks * 4
        self._host = HostTier(hb)
        self._extract: Optional[Callable] = None
        self._insert: Optional[Callable] = None
        # Last-touch engine iteration per physical block (loop-thread
        # writes, stats reads: a plain list of ints) and the manager's
        # view of the engine iteration counter.
        self.last_touch = [0] * num_blocks
        self._step = 0
        # Payloads staged for an allocated device block but not yet
        # inserted: ensure_writable faults these in BEFORE the CoW fork.
        self._pending_payload: Dict[int, Payload] = {}
        # chain hash → salt for blocks this replica registered (a spill
        # tags its host / fleet copy with it) and → directory entries
        # this replica published.
        self._salt_of: Dict[int, int] = {}
        self._published: Dict[int, int] = {}
        self._publishing: set = set()
        # Positive-only directory probe cache (a miss must probe again:
        # a peer may publish between probes).
        self._dir_cache: Dict[int, dict] = {}
        # Hashes reclaimed by base eviction under the lock, flushed (and
        # on a scrub, unpublished) outside it.
        self._reclaimed: List[Tuple[int, int]] = []
        # Tier counters (stats()["tier"]).
        self.spills = 0          # device → host blocks
        self.promotes = 0        # host → device blocks
        self.demotes = 0         # host → KV-server blocks
        self.spill_bytes = 0
        self.promote_bytes = 0
        self.demote_bytes = 0
        self.migrated_blocks = 0
        self.migrated_tokens = 0
        self.migration_failures = 0
        self.swapped_out_seqs = 0
        self.swapped_in_seqs = 0

    # -- engine wiring --------------------------------------------------------

    def set_device_io(self, extract: Callable, insert: Callable) -> None:
        """Install the pool extract / insert pair (``make_block_io``);
        until then the manager evicts as a plain BlockManager."""
        self._extract = extract
        self._insert = insert

    def note_step(self, step: int) -> None:
        self._step = step

    def touch(self, block_ids: Sequence[int], step: int) -> None:
        """Record the last-touch iteration of blocks a decode step read
        (loop thread only)."""
        for bid in block_ids:
            self.last_touch[bid] = step

    def extract_block(self, bid: int) -> Payload:
        return self._extract(bid)

    # -- spill instead of evict -----------------------------------------------

    def allocate(self, n: int = 1) -> List[int]:
        if self._extract is not None:
            self._spill_for(n)
        return super().allocate(n)

    def _spill_for(self, n: int) -> None:
        """Make ``n`` blocks FREE by spilling the coldest retained blocks
        host-ward (the device copy outside the lock), so the base
        allocator never has to drop a prefix block's payload.  The victim
        is unregistered under the lock first (no lookup can hit it
        mid-copy) and returns to the free list only once its payload is
        on the host."""
        while True:
            with self._lock:
                if len(self._free) >= n or not self._retained:
                    return
                victim = min(self._retained,
                             key=lambda b: self.last_touch[b])
                h = self._hash_of[victim]
                salt = self._salt_of.pop(h, 0)
                del self._retained[victim]
                del self._registry[h]
                self._hash_of[victim] = None
            payload = self._extract(victim)  # device IO, no lock held
            entry = _HostEntry(payload, salt, self._step)
            self._host.put(h, entry)
            with self._lock:
                self._free.append(victim)
                self.spills += 1
                self.spill_bytes += entry.nbytes
                self._dir_cache.pop(h, None)

    def _evict_retained_locked(self) -> int:
        # Base eviction still runs when no extract is wired: record the
        # reclaimed hash so a scrub can drop its host copy and directory
        # entry.
        victim = next(iter(self._retained))
        h = self._hash_of[victim]
        bid = super()._evict_retained_locked()
        self._reclaimed.append((h, self._salt_of.pop(h, 0)))
        return bid

    def invalidate_retained(self, n: int = 1) -> int:
        """Corruption scrub: besides the base unregister-and-free, the
        suspect blocks' HOST copies and DIRECTORY entries go too (a
        fleet peer fetching a scrubbed chain hash would serve wrong K/V
        silently)."""
        scrubbed = super().invalidate_retained(n)
        with self._lock:
            dead, self._reclaimed = self._reclaimed, []
        if dead:
            for h, _salt in dead:
                self._host.drop(h)
                self._dir_cache.pop(h, None)
            pub = []
            with self._lock:
                for h, _salt in dead:
                    if self._published.pop(h, None) is not None:
                        pub.append(h)
                    self._publishing.discard(h)
            if pub and self.client is not None:
                self.client.unpublish(pub)
        return scrubbed

    # -- prefix lookup: device, then host, then fleet -------------------------

    def lookup_prefix(self, prompt: Sequence[int],
                      hashes: Optional[Sequence[int]] = None
                      ) -> Tuple[List[int], int]:
        if hashes is None:
            hashes = chain_hashes(prompt, self.block_tokens)
        ids, tok = super().lookup_prefix(prompt, hashes=hashes)
        if not self.prefix_cache_enabled or self._insert is None:
            return ids, tok
        # Host-tier promotion continues the chain where the device
        # registry stopped.  Synchronous: the payload is already in RAM;
        # one block copy each, loop thread, no lock.
        usable = (len(prompt) - 1) // self.block_tokens
        hs = list(hashes)[:usable]
        i = len(ids)
        while i < len(hs):
            entry = self._host.pop(hs[i])
            if entry is None:
                break
            try:
                bid = self.allocate(1)[0]
            except NoFreeBlocksError:
                self._host.put(hs[i], entry)
                break
            self._insert(bid, entry.payload)  # device IO, no lock
            super().register(hs[i], bid)
            with self._lock:
                self._salt_of.setdefault(hs[i], entry.salt)
                self.promotes += 1
                self.promote_bytes += entry.nbytes
                self.prefix_hit_tokens += self.block_tokens
            ids.append(bid)
            i += 1
        return ids, len(ids) * self.block_tokens

    def remote_hits(self, hashes: Sequence[int]) -> int:
        """Longest contiguous directory-hit run over ``hashes`` (the
        fleet-wide continuation of a local lookup): one probe per
        uncached hash, stopping at the first miss.  Misses are never
        cached: a peer may publish them a moment later."""
        if self.client is None:
            return 0
        n = 0
        for h in hashes:
            entry = self._dir_cache.get(h)
            if entry is None:
                entry = self.client.lookup(h)
                if entry is not None:
                    with self._lock:
                        self._dir_cache[h] = entry
            if entry is None:
                break
            n += 1
        return n

    def stage_host(self, chain_hash: int, payload: Payload,
                   entry: Optional[dict]) -> None:
        """Queue-peek prefetch landing zone (worker → loop arrival): a
        fleet payload staged in the host tier, where the NEXT admission's
        ``lookup_prefix`` promotes it synchronously."""
        with self._lock:
            if chain_hash in self._registry:
                return  # already resident
        salt = int(entry.get("salt", 0)) if entry else 0
        e = _HostEntry(payload, salt, self._step)
        self._host.put(chain_hash, e)
        with self._lock:
            self.migrated_blocks += 1

    # -- staged-payload fault-in (a spilled block keeps its chain hash) ------

    def note_pending(self, bid: int, payload: Payload) -> None:
        with self._lock:
            self._pending_payload[bid] = payload

    def apply_pending(self, bid: int) -> bool:
        with self._lock:
            payload = self._pending_payload.pop(bid, None)
        if payload is None or self._insert is None:
            return False
        self._insert(bid, payload)  # device IO, no lock
        return True

    def ensure_writable(self, block_id: int) -> Tuple[int, bool]:
        # Fault a staged payload in BEFORE the CoW decision: the fork
        # copies device contents, which must be the real K/V, not the
        # zeros a not-yet-applied block still holds.
        self.apply_pending(block_id)
        return super().ensure_writable(block_id)

    # -- registration (version-salted) ----------------------------------------

    def register(self, chain_hash: int, block_id: int,
                 salt: int = 0) -> None:
        super().register(chain_hash, block_id)
        with self._lock:
            if self._hash_of[block_id] == chain_hash:
                self._salt_of.setdefault(chain_hash, salt)

    # -- publication bookkeeping (worker-driven) ------------------------------

    def mark_publishing(self, chain_hash: int) -> bool:
        """Claim one in-flight publication per hash; False if already
        published or in flight."""
        with self._lock:
            if chain_hash in self._published \
                    or chain_hash in self._publishing:
                return False
            self._publishing.add(chain_hash)
            return True

    def note_published(self, chain_hash: int, salt: int,
                       ok: bool) -> None:
        with self._lock:
            self._publishing.discard(chain_hash)
            if ok:
                self._published[chain_hash] = salt

    def demote_candidates(self) -> List[Tuple[int, _HostEntry]]:
        if self.client is None:
            return []
        return self._host.cold(self._step, self.config.demote_iters)

    def complete_demote(self, chain_hash: int, ok: bool,
                        nbytes: int) -> None:
        if ok:
            self._host.drop(chain_hash)
            with self._lock:
                self.demotes += 1
                self.demote_bytes += nbytes
        else:
            self._host.demote_failed(chain_hash)

    def count_migrated(self, blocks: int, tokens: int) -> None:
        with self._lock:
            self.migrated_blocks += blocks
            self.migrated_tokens += tokens
            self.prefix_hit_tokens += tokens

    def count_migration_failure(self) -> None:
        with self._lock:
            self.migration_failures += 1

    def count_demote(self, blocks: int) -> None:
        bpb = self.bytes_per_block or 0
        with self._lock:
            self.demotes += blocks
            self.demote_bytes += blocks * bpb

    def registered_block(self, chain_hash: int) -> Optional[int]:
        """Device block holding ``chain_hash`` now, or None (publication
        re-checks it around the device copy)."""
        with self._lock:
            return self._registry.get(chain_hash)

    def host_contains(self, chain_hash: int) -> bool:
        return self._host.contains(chain_hash)

    def count_swap(self, out_blocks: int = 0, in_blocks: int = 0) -> None:
        bpb = self.bytes_per_block or 0
        with self._lock:
            if out_blocks:
                self.swapped_out_seqs += 1
                self.spills += out_blocks
                self.spill_bytes += out_blocks * bpb
            if in_blocks:
                self.swapped_in_seqs += 1
                self.promotes += in_blocks
                self.promote_bytes += in_blocks * bpb

    # -- unpublish (mark_dead / roll) -----------------------------------------

    def unpublish_salt(self, salt: int) -> int:
        """Drop every directory entry and host copy of one (model,
        version) salt, the roll path: a peer mid-migration of the OLD
        version's chain must miss and recompute under the new weights."""
        with self._lock:
            dead = [h for h, s in self._published.items() if s == salt]
            for h in dead:
                del self._published[h]
            self._dir_cache.clear()
        self._host.drop_salt(salt)
        if dead and self.client is not None:
            self.client.unpublish(dead)
        return len(dead)

    def unpublish_all(self) -> int:
        """mark_dead: this replica's directory entries must not outlive
        it (a peer must never resolve a chain hash to a dead holder)."""
        with self._lock:
            dead = list(self._published)
            self._published.clear()
            self._publishing.clear()
            self._dir_cache.clear()
        if dead and self.client is not None:
            self.client.unpublish(dead)
        return len(dead)

    # -- introspection --------------------------------------------------------

    def stats(self) -> dict:
        out = super().stats()
        with self._lock:
            tier = {
                "host_blocks": len(self._host),
                "host_capacity": self._host.capacity,
                "host_bytes": self._host.bytes(),
                "host_evictions": self._host.evictions,
                "spills": self.spills,
                "promotes": self.promotes,
                "demotes": self.demotes,
                "spill_bytes": self.spill_bytes,
                "promote_bytes": self.promote_bytes,
                "demote_bytes": self.demote_bytes,
                "migrated_blocks": self.migrated_blocks,
                "migrated_tokens": self.migrated_tokens,
                "migration_failures": self.migration_failures,
                "swapped_out_seqs": self.swapped_out_seqs,
                "swapped_in_seqs": self.swapped_in_seqs,
                "published": len(self._published),
            }
        if self.client is not None:
            tier["fetch_attempts"] = self.client.fetch_attempts
            tier["fetch_drops"] = self.client.fetch_drops
        out["tier"] = tier
        return out


class TierWorker:
    """The tier's background thread: serialisation and KV transport OFF
    the engine loop (publishes, demotes, migration and swap fetches,
    queue-peek prefetches).  Results reach the loop through ``notify``
    (the engine's arrival deque and event); device IO never happens
    here.  A daemon, and joined in stop()."""

    def __init__(self, manager: TieredBlockManager, client: TierClient,
                 notify: Callable, replica_id: str = "replica-0"):
        self.manager = manager
        self.client = client
        self.notify = notify
        self.replica_id = replica_id
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"hvd-tier-{self.replica_id}")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._q.put(None)
        if self._thread is not None:
            self._thread.join(timeout=10)
            if not self._thread.is_alive():
                self._thread = None

    def submit(self, job: tuple) -> None:
        self._q.put(job)

    def _run(self) -> None:
        while True:
            job = self._q.get()
            if job is None or self._stop.is_set():
                break
            try:
                self._dispatch(job)
            except Exception as e:
                # A failed tier job must never kill the worker: the
                # engine degrades to recompute on the missing result.
                get_logger().warning(
                    "hvdtier[%s]: %s job failed: %s",
                    self.replica_id, job[0], e)

    def _dispatch(self, job: tuple) -> None:
        kind = job[0]
        if kind == "publish":
            _, h, salt, payload = job
            ok = self.client.publish(h, salt, pack_payload(payload))
            self.manager.note_published(h, salt, ok)
        elif kind == "demote":
            _, h, entry = job
            ok = self.client.publish(h, entry.salt,
                                     pack_payload(entry.payload))
            self.manager.note_published(h, entry.salt, ok)
            self.manager.complete_demote(h, ok, entry.nbytes)
        elif kind == "fetch":          # prefix-block migration
            _, seq, slot, idx, h = job
            blob, entry = self.client.fetch(h)
            payload = unpack_payload(blob) if blob is not None else None
            self.notify(("fetch", seq, slot, idx, payload))
        elif kind == "fetch_swap":     # swapped-sequence promote
            _, seq, slot, idx, key = job
            blob = self.client.fetch_swap(key)
            payload = unpack_payload(blob) if blob is not None else None
            self.notify(("swap", seq, slot, idx, payload))
        elif kind == "put_swap":
            _, key, payload = job
            self.client.put_swap(key, pack_payload(payload))
        elif kind == "peek":           # queue-peek prefetch → host tier
            _, h = job
            blob, entry = self.client.fetch(h)
            if blob is not None:
                self.notify(("staged", h, unpack_payload(blob), entry))
        elif kind == "unpublish":
            self.client.unpublish(job[1])
        elif kind == "drop_swap":
            self.client.drop_swap(job[1])
