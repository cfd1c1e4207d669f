"""Seeded sampling for the serve engine: temperature / top-k / top-p with
per-request keys.

Port of ``horovod_tpu/serve/sampling.py``.  ``new_seed`` and
``validate_params`` are copied unchanged; the draws keep the JAX module's
contract — **batched == single given the same key**: every random draw
is keyed by ``(request seed, sample index, token position)`` and never
by batch row, batch width, iteration count, wall clock or replica, so a
sampled request receives the same tokens alone, packed in a full batch,
forked n ways, or resubmitted to another replica.

Keys.  The JAX package keys its draws with ``jax.random.fold_in``; the
port owns its keys instead (it does not reproduce jax's bits, only the
distributions).  A key is two 32-bit words made by a counter-based hash:
``_mix32`` is a 32-bit xorshift-multiply finalizer whose multipliers
are below 2**31, so every product of a 32-bit word stays below 2**63:
it is exact in signed 64-bit arithmetic and gives the same bits on
Python ints, numpy arrays, CPU tensors and CUDA tensors::

    base  = seq_key(seed, sample_index)        # one per sequence
    k_pos = token_key(base, position)          # one per token

``position`` is the 0-indexed position the token OCCUPIES (prompt tokens
occupy ``0..P-1``, the first generated token occupies ``P``).
Speculative decoding draws its accept/resample randomness from the same
per-position keys (``accept_draw`` folds ``_SPEC_ACCEPT_TAG`` so the
accept uniform and the (re)sample draw at one position stay
independent).

Each position is always drawn by the same mechanism, as in JAX:

* **device** — ``sample_batched`` is the decode step's draw: Gumbel-max
  over the filtered logits, each element's noise a function of (token
  key, vocab id) alone.  It runs on the logits' device, so the [B, V]
  logits never travel to the host; rows with temperature <= 0 return
  ``argmax(logits)``, bit-identical to the greedy program.  Its one
  operand besides the logits comes from ``pack_params``, which folds
  each row's key on the host (B rows of hashing) and packs the result
  with the row's filters, so a step copies them to the device once; the
  device hashes only (row words, vocab id);
* **host** — ``sample_host`` (inverse CDF from one uniform) draws the
  first token after prefill (an n-way fork draws n tokens from one logit
  row) and the speculative bonus token; ``accept_draw`` and
  ``residual_sample`` are speculative decoding's accept and resample.
"""

from __future__ import annotations

import random as _stdlib_random
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

#: fold tag separating the speculative ACCEPT uniform from the
#: (re)sample draw at the same token position.
_SPEC_ACCEPT_TAG = 0x5bec


def new_seed() -> int:
    """Server-assigned request seed (echoed in the response so a sampled
    output is reproducible)."""
    return _stdlib_random.getrandbits(31)


def validate_params(temperature, top_k, top_p, n, seed
                    ) -> Tuple[float, Optional[int], float, int, int]:
    """Validate + normalize the sampling fields of one request.

    Raises ``ValueError`` per field (the server maps it to HTTP 400);
    returns ``(temperature, top_k, top_p, n, seed)`` with ``seed``
    assigned when the client sent none."""
    # JSON booleans are client bugs on every field, not numbers to
    # coerce (True -> temperature 1.0 would silently serve a SAMPLED
    # answer to a malformed request).
    for name, value in (("temperature", temperature), ("top_k", top_k),
                        ("top_p", top_p), ("n", n)):
        if isinstance(value, bool):
            raise ValueError(f"{name} must be a number, got {value!r}")
    t = float(temperature)
    if not np.isfinite(t) or t < 0:
        raise ValueError(f"temperature must be >= 0, got {temperature!r}")
    if top_k is not None:
        k = float(top_k)
        if not np.isfinite(k) or k != int(k):
            raise ValueError(f"top_k must be an integer, got {top_k!r}")
        top_k = int(k)
        if top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k!r}")
    p = float(top_p)
    if not np.isfinite(p) or not 0.0 < p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p!r}")
    nf = float(n)
    if not np.isfinite(nf) or nf != int(nf):
        raise ValueError(f"n must be an integer, got {n!r}")
    n = int(nf)
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n!r}")
    if seed is None:
        seed = new_seed()
    elif isinstance(seed, bool) or not isinstance(seed, int):
        # JSON floats/strings/bools are all client errors: a seed is the
        # reproducibility handle, so a lossy coercion would be worse
        # than a 400.
        raise ValueError(f"seed must be an integer, got {seed!r}")
    return t, top_k, p, n, int(seed)


# ---------------------------------------------------------------------------
# Key derivation: one hash for Python ints, numpy int64 arrays and torch
# int64 tensors (every intermediate stays below 2**63)
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_HASH_SEED = 0x243F6A88


def _mulmod32(x, c: int):
    """``(x * c) mod 2**32`` for ``0 <= x < 2**32`` and a constant
    ``c < 2**31``: the product stays below 2**63 (no signed 64-bit
    overflow on any backend)."""
    return (x * c) & _M32


def _mix32(x):
    """A bijective 32-bit finalizer (xorshift-multiply, twice)."""
    x = _mulmod32(x ^ (x >> 16), 0x045D9F3B)
    x = _mulmod32(x ^ (x >> 16), 0x045D9F3B)
    return x ^ (x >> 16)


def _absorb(h, w):
    """Fold one 32-bit word ``w`` into the running hash ``h``."""
    return _mix32(_mulmod32(h, 0x61C88647) ^ w)


def _hash(*words):
    h = _HASH_SEED
    for w in words:
        h = _absorb(h, w)
    return h


def seq_key(seed: int, sample_index: int = 0) -> np.ndarray:
    """Per-sequence base key of ``(seed, sample_index)`` as a host
    uint32[2] array (the engine packs these into a ``[B, 2]`` operand of
    its sampled decode step)."""
    s, i = int(seed) % (2 ** 31), int(sample_index) & _M32
    return np.array([_hash(s, i, 1), _hash(s, i, 2)], np.uint32)


def _fold(k0, k1, d):
    """The two words of the key folded from (k0, k1) and ``d``."""
    d = d & _M32
    return _hash(k0, k1, d, 3), _hash(k1, k0, d, 4)


def fold_in(key, data: int) -> np.ndarray:
    """The key derived from ``key`` (uint32[2]) and ``data`` (an integer
    below 2**32): a pure function of both."""
    return np.array(_fold(int(key[0]), int(key[1]), int(data)), np.uint32)


def token_key(base_key, position: int) -> np.ndarray:
    """The key for the token occupying ``position`` (module doc)."""
    return fold_in(base_key, position)


def _uniform(key) -> float:
    """A float64 uniform in [0, 1) from a key (53 bits)."""
    k0, k1 = int(key[0]), int(key[1])
    hi, lo = _hash(k0, k1, 5), _hash(k1, k0, 6)
    return ((hi << 21) | (lo >> 11)) / float(2 ** 53)


# ---------------------------------------------------------------------------
# Filtered distributions (temperature -> top-k -> top-p)
# ---------------------------------------------------------------------------

def filter_logits(logits: torch.Tensor, temperature, top_k, top_p
                  ) -> torch.Tensor:
    """Filtered sampling logits of each row of ``logits`` [..., V], in
    f32 (``_filter_logits_jnp``, ``horovod_tpu/serve/sampling.py:137``).
    ``temperature``, ``top_k`` and ``top_p`` are scalars or tensors of
    the logits' leading shape.  The temperature is floored at 1e-6;
    ``top_k <= 0`` disables top-k and ties at the k-th value are kept;
    top-p keeps a token while the mass of the strictly better tokens is
    below ``top_p``, so the top-1 token is always kept, and ``top_p >=
    1`` keeps every token of nonzero probability (``filtered_probs``
    keeps the same support).  Every reduction
    runs along one row only: a row's result does not depend on the other
    rows or on how many there are."""
    logits = logits.float()
    dev, lead = logits.device, logits.shape[:-1]
    V = logits.shape[-1]

    def param(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=dev).expand(
            lead).unsqueeze(-1)

    temperature = param(temperature, torch.float32)
    top_k = param(top_k, torch.int64)
    top_p = param(top_p, torch.float32)
    scaled = logits / torch.clamp(temperature, min=1e-6)
    desc = torch.sort(scaled, dim=-1, descending=True).values
    k_eff = torch.where(top_k <= 0, V, top_k).clamp(1, V)
    kth = torch.gather(desc, -1, k_eff - 1)
    # masked_fill with a Python scalar: a device scalar would be a
    # host-to-device copy, which synchronizes the stream.
    masked = scaled.masked_fill(~(scaled >= kth), float("-inf"))
    probs = torch.softmax(masked, dim=-1)
    ps = torch.sort(probs, dim=-1, descending=True).values
    cs = torch.cumsum(ps, dim=-1)
    # top_p == 1 keeps every token of nonzero probability, as the JAX
    # filter documents: an f32 running sum may reach 1 before the tail
    # does (its order of additions differs from XLA's), which would
    # drop tail tokens.
    keep_sorted = ((cs - ps) < top_p) | ((top_p >= 1.0) & (ps > 0))
    thr = ps.masked_fill(~keep_sorted, float("inf")).amin(dim=-1,
                                                          keepdim=True)
    return masked.masked_fill(~(probs >= thr), float("-inf"))


def _masked(logits, allowed):
    """``logits`` with the tokens outside the boolean mask ``allowed``
    at -inf (structured decoding's pre-mask); unchanged when ``allowed``
    is None."""
    logits = np.asarray(logits)
    if allowed is None:
        return logits
    return np.where(np.asarray(allowed, bool), logits, -np.inf)


def filtered_probs(logits: np.ndarray, temperature: float,
                   top_k: Optional[int], top_p: float,
                   allowed: Optional[np.ndarray] = None) -> np.ndarray:
    """Host mirror of ``filter_logits`` as a probability vector, with the
    same support (``top_p >= 1`` included) — the target distribution
    ``p`` speculative rejection sampling must preserve (accept prob,
    residual resample) and the reference the chi-square distribution
    tests check against (``filtered_probs``,
    ``horovod_tpu/serve/sampling.py:165``).  ``allowed`` (a boolean
    ``[V]`` mask, structured decoding) removes the disallowed tokens
    BEFORE temperature, top-k and top-p, as JAX's ``_filter_logits_jnp``
    does, so the filters act on the constrained distribution."""
    logits = np.asarray(_masked(logits, allowed), np.float32)
    V = logits.shape[-1]
    scaled = logits / max(float(temperature), 1e-6)
    desc = np.sort(scaled)[::-1]
    k_eff = min(max(int(top_k) if top_k else V, 1), V)
    kth = desc[k_eff - 1]
    masked = np.where(scaled >= kth, scaled, -np.inf)
    shifted = masked - np.max(masked)
    e = np.exp(shifted, where=np.isfinite(shifted),
               out=np.zeros_like(shifted))
    probs = e / e.sum()
    ps = np.sort(probs)[::-1]
    cs = np.cumsum(ps)
    # The rule of ``filter_logits``: a sequential f32 sum can reach 1
    # before the tail does, so top_p >= 1 keeps every nonzero token.
    keep_sorted = ((cs - ps) < top_p) | ((top_p >= 1.0) & (ps > 0))
    thr = np.min(np.where(keep_sorted, ps, np.inf))
    probs = np.where(probs >= thr, probs, 0.0)
    return probs / probs.sum()


# ---------------------------------------------------------------------------
# The device draw (the decode hot path)
# ---------------------------------------------------------------------------

def row_words(base_keys, positions):
    """The two words row b's noise is hashed from, [B] each: a pure
    function of its base key and of the position its token occupies (the
    token key, folded once more).  ``base_keys`` [B, 2] and
    ``positions`` [B] are int64 numpy arrays or tensors."""
    t0, t1 = _fold(base_keys[:, 0], base_keys[:, 1], positions)
    return _hash(t0, t1, 7), _hash(t1, t0, 8)


def gumbel_noise(words: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Gumbel(0, 1) noise [B, V] in f64: element (b, v) is a function of
    row b's words ``words[b]`` (int64 [B, 2], ``row_words``) and of v
    alone."""
    v = torch.arange(vocab_size, dtype=torch.int64, device=words.device)
    bits = _mix32(_mix32(words[:, 0:1] ^ v[None]) ^ words[:, 1:2])
    u = (bits.double() + 0.5) * (1.0 / 2 ** 32)                 # (0, 1)
    return -torch.log(-torch.log(u))


def pack_params(keys: np.ndarray, positions, temperatures, top_ks,
                top_ps) -> np.ndarray:
    """The device draw's per-row operands in ONE host array ``[B, 5]``
    f64: the row words of (base key ``keys[b]``, the position row b's
    token will OCCUPY), temperature, top_k, top_p, each exact in f64
    (temperature and top_p rounded to f32 first, the type they are used
    in).  The sampled decode step copies it to the device once, and the
    device hashes nothing per row."""
    out = np.empty((len(keys), 5), np.float64)
    r0, r1 = row_words(np.asarray(keys, np.int64),
                       np.asarray(positions, np.int64))
    out[:, 0], out[:, 1] = r0, r1
    out[:, 2] = np.asarray(temperatures, np.float32)
    out[:, 3] = np.asarray(top_ks, np.int64)
    out[:, 4] = np.asarray(top_ps, np.float32)
    return out


def sample_batched(logits: torch.Tensor, packed,
                   allowed=None) -> torch.Tensor:
    """One token per row of ``logits`` [B, V], on their device (int64
    [B]).  ``packed`` is ``pack_params``'s ``[B, 5]`` array, as numpy or
    as a tensor already on the logits' device.  Each row's noise depends
    on its own row words and the vocab id only — nothing here depends on
    b itself or on B, which is the whole batched == single contract.
    Rows with temperature <= 0 return ``argmax(logits[b])``
    bit-identically to the greedy step.  ``allowed`` (a [B, V] boolean
    mask, structured decoding) puts the tokens outside it at -inf before
    the filters, as ``sample_host``: greedy rows take the masked argmax,
    and a row whose mask allows every token draws as with no mask."""
    packed = torch.as_tensor(packed, device=logits.device)
    if allowed is not None:
        allowed = torch.as_tensor(allowed, dtype=torch.bool,
                                  device=logits.device)
        logits = logits.masked_fill(~allowed, float("-inf"))
    temperatures = packed[:, 2].float()
    filtered = filter_logits(logits, temperatures, packed[:, 3].long(),
                             packed[:, 4].float())
    noise = gumbel_noise(packed[:, 0:2].long(), logits.shape[-1])
    sampled = torch.argmax(filtered.double() + noise, dim=-1)
    return torch.where(temperatures > 0, sampled,
                       torch.argmax(logits, dim=-1))


# ---------------------------------------------------------------------------
# Host-side draws (first tokens, speculative accept/resample)
# ---------------------------------------------------------------------------

def _draw_from_probs(probs: np.ndarray, u: float) -> int:
    cdf = np.cumsum(probs)
    return int(min(np.searchsorted(cdf, u * cdf[-1], side="right"),
                   len(probs) - 1))


def sample_host(logits: np.ndarray, base_key, position: int,
                temperature: float, top_k: Optional[int],
                top_p: float, allowed: Optional[np.ndarray] = None) -> int:
    """One host-side token draw for the token occupying ``position`` —
    the first-token path after prefill (n>1 forks draw n tokens from one
    logit row with n different base keys), the speculative bonus token
    and test references: inverse CDF of ``filtered_probs`` at one
    uniform.  ``allowed`` (structured decoding) constrains both arms:
    greedy becomes the masked argmax, sampled applies the mask before
    the filters (``horovod_tpu/serve/sampling.py:239``)."""
    if temperature <= 0:
        return int(np.argmax(_masked(logits, allowed)))
    probs = filtered_probs(logits, temperature, top_k, top_p,
                           allowed=allowed)
    return _draw_from_probs(probs, _uniform(token_key(base_key, position)))


def sample_host_fused(logits, base_key, position: int,
                      temperature: float, top_k: Optional[int],
                      top_p: float, allowed=None) -> int:
    """The device draw (``sample_batched``) of one row on the CPU:
    Gumbel-max over the filtered logits under the token's key, the same
    formula the sampled decode step runs (``sample_host`` keeps the
    inverse-CDF draw the first-token and speculative paths use).
    ``allowed`` masks before the filters, as ``sample_host``."""
    if temperature <= 0:
        return int(np.argmax(_masked(logits, allowed)))
    row = torch.as_tensor(np.asarray(logits, np.float32))[None]
    packed = pack_params(np.asarray(base_key, np.uint32)[None], [position],
                         [temperature], [int(top_k) if top_k else 0], [top_p])
    mask = None if allowed is None else np.asarray(allowed, bool)[None]
    return int(sample_batched(row, packed, mask)[0])


def accept_draw(base_key, position: int) -> float:
    """The speculative ACCEPT uniform for the token at ``position`` —
    folded with a tag so it is independent of the same position's
    (re)sample draw."""
    return _uniform(fold_in(token_key(base_key, position), _SPEC_ACCEPT_TAG))


def residual_sample(probs: np.ndarray, rejected_token: int,
                    base_key, position: int) -> int:
    """Sample the residual distribution after rejecting a greedy draft.

    The draft proposes its argmax (a point mass ``q = delta[d]``), so
    Leviathan-style rejection reduces to: accept ``d`` with probability
    ``p[d]``, else draw from ``max(p - delta[d], 0)`` renormalized —
    i.e. ``p`` with the rejected token zeroed.  The marginal over
    accept+resample is exactly ``p``."""
    residual = np.array(probs, np.float64)
    residual[rejected_token] = 0.0
    total = residual.sum()
    if total <= 0.0:
        # p was a point mass on the rejected token: acceptance prob was
        # 1, so this is unreachable — guard anyway.
        return int(rejected_token)
    residual /= total
    return _draw_from_probs(residual,
                            _uniform(token_key(base_key, position)))


def base_keys_array(seqs_keys: Sequence[Optional[np.ndarray]],
                    width: int) -> np.ndarray:
    """Pack per-row base keys into the ``[B, 2]`` uint32 operand of the
    sampled decode step (rows without a key — greedy or inactive — get
    zeros; their temperature is 0 so the key is never used)."""
    out = np.zeros((width, 2), np.uint32)
    for i, k in enumerate(seqs_keys):
        if k is not None:
            out[i] = k
    return out
