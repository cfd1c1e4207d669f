"""hvdstream: per-request token streaming — the bounded queue between
the engine's decode loop and an HTTP handler writing SSE.

Copied from ``horovod_tpu/serve/streaming.py`` (pure Python; the port
keeps its own copy and never imports the JAX package).

The engine publishes each generated token into a :class:`TokenStream`
(one per streamed request, riding ``Request.sink``) from UNDER the
engine lock — publish is therefore non-blocking and never does socket
IO.  The HTTP handler thread drains events with :meth:`next_event` and
writes them to the client as Server-Sent Events over chunked transfer;
the engine lock is never held across a socket write.

Exactly-once delivery across failover: publishes are POSITION-KEYED
and deduplicated.  A preemption, dead-replica drain, or kill-rank
failover resets ``request.generated`` and re-decodes from position 0 on
another replica; the seeded decoding contract (serve/sampling.py) makes
the replayed tokens bit-identical, and :meth:`publish` drops any
position below the high-water mark — so the client observes every token
exactly once, in order, with no duplicates and no gaps, even when the
sequence was computed twice.

Backpressure: the queue is BOUNDED (``HVD_SERVE_STREAM_QUEUE`` pending
events).  A slow client cannot grow server memory without limit — when
the queue is full, new tokens are COALESCED into the newest pending
token event (never dropped: the concatenated stream stays bit-identical
to the buffered response; the client just receives fewer, fatter
events).  Coalesce/duplicate counts are surfaced via :meth:`counters`
and feed ``ServeMetrics.count_stream`` — the accounting the faultline
``slow-client`` chaos kind asserts against.

Terminal events: ``finish``/``abort`` are wired into
``Request.complete``/``Request.fail`` (serve/batcher.py), so EVERY
request outcome — normal completion, mid-stream deadline expiry,
brownout shed, engine failure, failed failover — lands in the stream as
exactly one terminal event (``done`` or ``error``) instead of a silent
hangup.  ``finish`` also flushes any unpublished tail of the final
token list first, which is what makes "concatenation of token events ==
buffered response" a hard invariant rather than a race.

The module also owns the SSE + chunked-transfer wire helpers shared by
the server (serve/server.py) and the tests.
"""

from __future__ import annotations

import json
import os
import threading
from typing import List, Optional, Tuple

from .batcher import DeadlineExceededError, QueueFullError

__all__ = [
    "TokenStream", "encode_sse", "parse_sse", "chunk_frame",
    "CHUNK_TERMINATOR", "error_status_for", "wants_stream",
]


def _default_maxlen() -> int:
    return int(os.environ.get("HVD_SERVE_STREAM_QUEUE", "64"))


class TokenStream:
    """Bounded, coalescing, position-deduplicating token event queue
    (module doc).  Publisher side (engine threads, under the engine
    lock): ``publish``/``finish``/``abort`` — all non-blocking.
    Consumer side (one HTTP handler thread): ``next_event``."""

    def __init__(self, maxlen: Optional[int] = None,
                 logprobs: bool = False):
        self.maxlen = max(int(maxlen if maxlen is not None
                              else _default_maxlen()), 1)
        self.wants_logprobs = bool(logprobs)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._events: List[Tuple[str, dict]] = []
        self._next = 0            # dedupe high-water mark (position)
        self._terminal = None     # ("done", None) | ("error", exc)
        self.published = 0        # tokens accepted (post-dedupe)
        self.coalesced = 0        # tokens merged into a pending event
        self.duplicates = 0       # replayed positions dropped

    # -- publisher side (engine) ------------------------------------------

    def _publish_locked(self, pos: int, token: int, logprob) -> None:
        if self._terminal is not None:
            return
        if pos < self._next:
            # Failover/preemption replay of an already-delivered
            # position (module doc): seeded decoding regenerated the
            # same token — drop it, exactly-once holds.
            self.duplicates += 1
            return
        self._next = pos + 1
        self.published += 1
        if (len(self._events) >= self.maxlen and self._events
                and self._events[-1][0] == "token"):
            # Queue full: coalesce into the newest pending token event
            # — never drop (the concatenated stream must stay
            # bit-identical to the buffered response).
            data = self._events[-1][1]
            data["tokens"].append(int(token))
            if self.wants_logprobs:
                data.setdefault("logprobs", []).append(logprob)
            self.coalesced += 1
        else:
            data = {"index": int(pos), "tokens": [int(token)]}
            if self.wants_logprobs:
                data["logprobs"] = [logprob]
            self._events.append(("token", data))
        self._cond.notify_all()

    def publish(self, pos: int, token: int, logprob=None) -> None:
        """Offer the token occupying generated-position ``pos`` (0-based
        within the completion).  Non-blocking; never raises."""
        with self._cond:
            self._publish_locked(int(pos), int(token), logprob)

    def finish(self, tokens, logprobs=None) -> None:
        """Terminal success: flush any unpublished tail of the final
        token list, then enqueue the ``done`` sentinel.  Idempotent."""
        with self._cond:
            for pos in range(self._next, len(tokens)):
                lp = (logprobs[pos] if logprobs is not None
                      and pos < len(logprobs) else None)
                self._publish_locked(pos, tokens[pos], lp)
            if self._terminal is None:
                self._terminal = ("done", None)
            self._cond.notify_all()

    def abort(self, exc: BaseException) -> None:
        """Terminal failure (deadline, shed, engine error).  Pending
        token events stay deliverable; the error sentinel follows them.
        Idempotent — the first terminal wins."""
        with self._cond:
            if self._terminal is None:
                self._terminal = ("error", exc)
            self._cond.notify_all()

    # -- consumer side (HTTP handler) -------------------------------------

    def next_event(self, timeout: Optional[float] = None):
        """The next event: ``("token", data)`` then, once, the terminal
        ``("done", None)`` / ``("error", exc)``.  After the terminal has
        been returned it is returned again on every call (the consumer
        breaks on it).  ``None`` on timeout."""
        with self._cond:
            deadline = None
            while True:
                if self._events:
                    return self._events.pop(0)
                if self._terminal is not None:
                    return self._terminal
                if timeout is not None and deadline is None:
                    import time
                    deadline = time.monotonic() + timeout
                if deadline is not None:
                    import time
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None
                    self._cond.wait(remaining)
                else:
                    self._cond.wait()

    def counters(self) -> dict:
        with self._lock:
            return {"published": self.published,
                    "coalesced": self.coalesced,
                    "duplicates": self.duplicates}


# ---------------------------------------------------------------------------
# SSE + chunked-transfer wire format
# ---------------------------------------------------------------------------

#: Final zero-length chunk closing an HTTP/1.1 chunked body.
CHUNK_TERMINATOR = b"0\r\n\r\n"


def encode_sse(event: str, data: dict) -> bytes:
    """One Server-Sent Event: ``event:`` line + single ``data:`` line
    (compact JSON — no embedded newlines, so one line always suffices)
    + blank-line delimiter."""
    payload = json.dumps(data, separators=(",", ":"))
    return f"event: {event}\ndata: {payload}\n\n".encode()


def parse_sse(raw: bytes) -> List[Tuple[str, dict]]:
    """Parse a concatenation of events produced by :func:`encode_sse`
    back into ``(event, data)`` pairs — the test/bench-side consumer."""
    out: List[Tuple[str, dict]] = []
    for block in raw.decode().split("\n\n"):
        if not block.strip():
            continue
        event, lines = "message", []
        for line in block.split("\n"):
            if line.startswith("event:"):
                event = line[len("event:"):].strip()
            elif line.startswith("data:"):
                lines.append(line[len("data:"):].strip())
        if lines:
            out.append((event, json.loads("\n".join(lines))))
    return out


def chunk_frame(data: bytes) -> bytes:
    """Wrap ``data`` as one HTTP/1.1 chunked-transfer chunk."""
    return b"%x\r\n" % len(data) + data + b"\r\n"


def wants_stream(payload: dict, headers) -> bool:
    """The streaming opt-in: ``"stream": true`` in the body,
    or an ``Accept: text/event-stream`` header."""
    if bool(payload.get("stream")):
        return True
    accept = ""
    try:
        accept = headers.get("Accept") or ""
    except Exception:
        pass
    return "text/event-stream" in accept


def error_status_for(exc: BaseException) -> int:
    """Map a terminal stream error onto the HTTP status the buffered
    path would have answered with (serve/server.py status contract) —
    used both for pre-first-byte buffered error replies and as the
    ``code`` field of mid-stream ``error`` events."""
    try:
        from .replica import NoHealthyReplicaError
    except Exception:  # pragma: no cover - import cycle guard
        NoHealthyReplicaError = QueueFullError  # type: ignore
    if isinstance(exc, (QueueFullError, NoHealthyReplicaError)):
        return 503
    if isinstance(exc, (DeadlineExceededError, TimeoutError)):
        return 504
    if isinstance(exc, ValueError):
        return 400
    return 500
