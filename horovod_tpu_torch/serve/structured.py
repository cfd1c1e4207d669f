"""hvdstream structured decoding: JSON-Schema subset → incremental
token-level automaton over the adapter's vocabulary.

Copied unchanged from ``horovod_tpu/serve/structured.py`` (numpy and
Python only; the port keeps its own copy and never imports the JAX
package).

A ``/generate`` request carrying ``"schema": {...}`` is decoded under a
token mask: at every step only the tokens that keep the emitted text a
valid PREFIX of some schema-conforming JSON document are allowed, so
every completion the engine emits parses and validates by construction
(greedy and sampled paths both — the mask rides the logit-filter hook
in serve/sampling.py as a ``-inf`` pre-mask).

Supported subset (anything else is rejected with ``ValueError`` → HTTP
400 at the server): ``type`` object / array / string / number /
integer / boolean / null, ``properties`` + ``required`` (+
``additionalProperties: false``), ``items`` + ``minItems`` /
``maxItems``, ``enum``, ``const``.

The emission grammar is CANONICAL compact JSON: no whitespace, object
properties in declared order (optional properties may be skipped,
required ones must appear), strings over printable ASCII without
escapes, numbers without exponents.  Canonicalization is what makes the
automaton small and the masks exact — the schema constrains the
LANGUAGE, canonicalization picks one spelling per value.

Construction: the schema compiles to a node tree; automaton states are
frozensets of *configs*, each config a tuple of frames — a linearized
parse stack (frame 0 active).  Frames either CONSUME characters
(``lit`` literal text, ``chars`` string bodies, ``num`` the number DFA)
or EXPAND structurally at epsilon-closure time (``node``, array/object
progress frames).  ``_closure`` is the subset construction's epsilon
step; ``_step`` consumes one character.  A state containing the empty
config is ACCEPTING (a complete document has been emitted) — the engine
adds the EOS token to the allowed set exactly there, and finishes the
sequence outright when an accepting state has no other continuation
(finish reason ``grammar``).

Token-level masks: :meth:`TokenGrammar.allowed_mask` walks every vocab
token's string through the char automaton from the given state,
memoized per state — the per-step cost after warm-up is one dict
lookup.  All mutation happens on the engine thread (the engine owns one
``TokenGrammar`` per distinct schema via its compile cache, used under
the engine lock), so this module needs no locking of its own.

Termination caveat: the mask guarantees VALIDITY of
whatever is emitted, not that the document completes within
``max_new_tokens`` — a schema whose tail is unbounded (a trailing
number/string/unbounded array) can end with finish reason ``length``
mid-document.  Schemas that pin their tail (enum/const/bool, bounded
arrays, objects ending in a bounded property) always terminate: the
automaton reaches an accepting state with no continuation and the
engine finishes the sequence itself.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["parse_schema", "TokenGrammar"]

#: Characters a string BODY may contain (canonical emission: printable
#: ASCII, no escapes — the quote and backslash would need them).
_STR_CHARS = frozenset(
    chr(c) for c in range(0x20, 0x7F)) - {'"', "\\"}

_DIGITS = frozenset("0123456789")

#: The whole keyword vocabulary this subset understands; anything else
#: in a schema object is an unsupported keyword → ValueError → 400.
_ALLOWED_KEYS = frozenset((
    "type", "properties", "required", "additionalProperties",
    "items", "minItems", "maxItems", "enum", "const"))

#: Keys meaningful per type — a stray ``items`` on an object (etc.) is
#: rejected rather than silently ignored.
_KEYS_BY_TYPE = {
    "object": frozenset(("type", "properties", "required",
                         "additionalProperties")),
    "array": frozenset(("type", "items", "minItems", "maxItems")),
    "string": frozenset(("type",)),
    "number": frozenset(("type",)),
    "integer": frozenset(("type",)),
    "boolean": frozenset(("type",)),
    "null": frozenset(("type",)),
}


def _canon(value) -> str:
    """Canonical compact JSON spelling of an enum/const value."""
    try:
        s = json.dumps(value, separators=(",", ":"), allow_nan=False)
    except (TypeError, ValueError) as e:
        raise ValueError(f"enum/const value not JSON-serializable: {e}")
    if not all(c.isascii() for c in s):
        raise ValueError(
            f"enum/const value {s!r} is not ASCII (canonical emission "
            "covers printable ASCII only)")
    return s


def parse_schema(schema):
    """Validate ``schema`` against the supported subset and return the
    node tree the automaton expands.  Raises ``ValueError`` naming the
    first unsupported keyword/shape (the server maps it to HTTP 400)."""
    if isinstance(schema, bool) or not isinstance(schema, dict):
        raise ValueError(
            "schema must be a JSON object (boolean/other schemas are "
            f"unsupported), got {type(schema).__name__}")
    unknown = sorted(set(schema) - _ALLOWED_KEYS)
    if unknown:
        raise ValueError(
            "unsupported JSON-Schema keyword(s): " + ", ".join(unknown))
    if "const" in schema:
        if set(schema) - {"const"}:
            raise ValueError(
                "const must be the schema's only keyword, got extra: "
                + ", ".join(sorted(set(schema) - {"const"})))
        return ("enum", (_canon(schema["const"]),))
    if "enum" in schema:
        if set(schema) - {"enum"}:
            raise ValueError(
                "enum must be the schema's only keyword, got extra: "
                + ", ".join(sorted(set(schema) - {"enum"})))
        values = schema["enum"]
        if not isinstance(values, list) or not values:
            raise ValueError("enum must be a non-empty list")
        return ("enum", tuple(_canon(v) for v in values))
    t = schema.get("type")
    if t not in _KEYS_BY_TYPE:
        raise ValueError(
            f"unsupported type {t!r} (supported: "
            + ", ".join(sorted(_KEYS_BY_TYPE)) + ")")
    stray = sorted(set(schema) - _KEYS_BY_TYPE[t])
    if stray:
        raise ValueError(
            f"keyword(s) not applicable to type {t!r}: "
            + ", ".join(stray))
    if t == "object":
        props = schema.get("properties", {})
        if not isinstance(props, dict):
            raise ValueError("properties must be an object")
        ap = schema.get("additionalProperties", False)
        if ap is not False:
            raise ValueError(
                "additionalProperties must be false (canonical "
                "emission only writes declared properties)")
        required = schema.get("required", [])
        if (not isinstance(required, list)
                or not all(isinstance(r, str) for r in required)):
            raise ValueError("required must be a list of strings")
        missing = sorted(set(required) - set(props))
        if missing:
            raise ValueError(
                "required names not in properties: " + ", ".join(missing))
        parsed = []
        for name, sub in props.items():
            if not isinstance(name, str) or not name or \
                    not set(name) <= _STR_CHARS:
                raise ValueError(
                    f"property name {name!r} not emittable (printable "
                    "ASCII without quote/backslash)")
            parsed.append((name, parse_schema(sub), name in set(required)))
        return ("object", tuple(parsed))
    if t == "array":
        if "items" not in schema:
            raise ValueError("array schema requires items")
        lo = schema.get("minItems", 0)
        hi = schema.get("maxItems")
        for label, v in (("minItems", lo), ("maxItems", hi)):
            if v is not None and (isinstance(v, bool)
                                  or not isinstance(v, int) or v < 0):
                raise ValueError(
                    f"{label} must be a non-negative integer, got {v!r}")
        if hi is not None and hi < lo:
            raise ValueError(f"maxItems {hi} < minItems {lo}")
        return ("array", parse_schema(schema["items"]), int(lo),
                None if hi is None else int(hi))
    if t == "string":
        return ("string",)
    if t in ("number", "integer"):
        return ("number", t == "integer")
    if t == "boolean":
        return ("bool",)
    return ("null",)


# ---------------------------------------------------------------------------
# Char-level automaton: configs (frame stacks) + subset construction
# ---------------------------------------------------------------------------

def _expand(node) -> List[Tuple]:
    """The frame sequences a ``node`` frame expands into (one per
    structural alternative)."""
    kind = node[0]
    if kind == "string":
        return [(("lit", '"', 0), ("chars",), ("lit", '"', 0))]
    if kind == "number":
        return [(("num", "start", node[1]),)]
    if kind == "bool":
        return [(("lit", "true", 0),), (("lit", "false", 0),)]
    if kind == "null":
        return [(("lit", "null", 0),)]
    if kind == "enum":
        return [(("lit", s, 0),) for s in node[1]]
    if kind == "array":
        _, item, lo, hi = node
        return [(("lit", "[", 0), ("arr_first", item, lo, hi))]
    # object
    return [(("lit", "{", 0), ("obj", node[1], 0, False))]


def _num_next(sub: str, ch: str, is_int: bool) -> Optional[str]:
    if sub == "start":
        if ch == "-":
            return "neg"
        if ch == "0":
            return "zero"
        if ch in _DIGITS:
            return "int"
    elif sub == "neg":
        if ch == "0":
            return "zero"
        if ch in _DIGITS:
            return "int"
    elif sub == "zero":
        if ch == "." and not is_int:
            return "frac_first"
    elif sub == "int":
        if ch in _DIGITS:
            return "int"
        if ch == "." and not is_int:
            return "frac_first"
    elif sub in ("frac_first", "frac"):
        if ch in _DIGITS:
            return "frac"
    return None


#: num substates where the number may END (epsilon-pop the frame).
_NUM_POPPABLE = frozenset(("zero", "int", "frac"))

_DEAD: frozenset = frozenset()


def _closure(configs) -> frozenset:
    """Epsilon-closure: expand structural frames, pop completed
    consuming frames, spawn the end-here branch of poppable frames.
    The result contains only configs whose head frame CONSUMES (or the
    empty, accepting config)."""
    out = set()
    seen = set()
    stack = list(configs)
    while stack:
        c = stack.pop()
        if c in seen:
            continue
        seen.add(c)
        if not c:
            out.add(c)
            continue
        f = c[0]
        kind = f[0]
        if kind == "lit":
            if f[2] >= len(f[1]):
                stack.append(c[1:])
            else:
                out.add(c)
        elif kind == "chars":
            out.add(c)            # ...another body character
            stack.append(c[1:])   # ...or the body ends here
        elif kind == "num":
            if f[1] in _NUM_POPPABLE:
                stack.append(c[1:])
            out.add(c)
        elif kind == "node":
            for repl in _expand(f[1]):
                stack.append(repl + c[1:])
        elif kind == "arr_first":
            _, item, lo, hi = f
            if lo == 0:
                stack.append((("lit", "]", 0),) + c[1:])
            if hi is None or hi >= 1:
                stack.append(
                    (("node", item), ("arr_sep", item, lo, hi, 1))
                    + c[1:])
        elif kind == "arr_sep":
            _, item, lo, hi, n = f
            if n >= lo:
                stack.append((("lit", "]", 0),) + c[1:])
            if hi is None or n < hi:
                stack.append(
                    (("lit", ",", 0), ("node", item),
                     ("arr_sep", item, lo, hi, n + 1)) + c[1:])
        else:  # obj
            _, props, idx, emitted_any = f
            if idx >= len(props):
                stack.append((("lit", "}", 0),) + c[1:])
            else:
                name, sub, req = props[idx]
                prefix = ("," if emitted_any else "") + f'"{name}":'
                stack.append(
                    (("lit", prefix, 0), ("node", sub),
                     ("obj", props, idx + 1, True)) + c[1:])
                if not req:
                    # Optional property skipped: same emitted_any.
                    stack.append(
                        (("obj", props, idx + 1, emitted_any),) + c[1:])
    return frozenset(out)


def _step(state: frozenset, ch: str) -> frozenset:
    """Consume one character from every config; dead configs drop out.
    Returns ``_DEAD`` (the empty frozenset) when nothing survives."""
    nxt = set()
    for c in state:
        if not c:
            continue
        f = c[0]
        kind = f[0]
        if kind == "lit":
            if f[1][f[2]] == ch:
                nxt.add((("lit", f[1], f[2] + 1),) + c[1:])
        elif kind == "chars":
            if ch in _STR_CHARS:
                nxt.add(c)
        elif kind == "num":
            ns = _num_next(f[1], ch, f[2])
            if ns is not None:
                nxt.add((("num", ns, f[2]),) + c[1:])
    return _closure(nxt) if nxt else _DEAD


class TokenGrammar:
    """The token-level automaton for one (schema, vocab) pair.

    ``vocab`` maps token id → the text that token emits (the adapter's
    ``token_strings()``); ``eos_id`` joins the allowed set exactly at
    accepting states.  States are opaque hashable values; the caller
    (the engine's ``_Seq.gstate``) threads them through
    :meth:`advance_token`."""

    def __init__(self, schema, vocab: Sequence[str],
                 eos_id: Optional[int] = None):
        self.node = parse_schema(schema)
        self.vocab = [str(s) for s in vocab]
        self.eos_id = (int(eos_id)
                       if eos_id is not None
                       and 0 <= int(eos_id) < len(self.vocab) else None)
        self.start = _closure([(("node", self.node),)])
        self._steps: Dict[Tuple[frozenset, str], frozenset] = {}
        self._tok: Dict[Tuple[frozenset, int], frozenset] = {}
        self._masks: Dict[frozenset, np.ndarray] = {}

    def _step_char(self, state: frozenset, ch: str) -> frozenset:
        key = (state, ch)
        nxt = self._steps.get(key)
        if nxt is None:
            nxt = self._steps[key] = _step(state, ch)
        return nxt

    def _walk(self, state: frozenset, tok: int) -> frozenset:
        key = (state, tok)
        nxt = self._tok.get(key)
        if nxt is None:
            s = self.vocab[tok] if 0 <= tok < len(self.vocab) else ""
            nxt = state if s else _DEAD
            for ch in s:
                if not nxt:
                    break
                nxt = self._step_char(nxt, ch)
            if not s:
                nxt = _DEAD  # empty-text tokens would loop forever
            self._tok[key] = nxt
        return nxt

    def advance_token(self, state: frozenset, tok: int) -> frozenset:
        """The state after emitting token ``tok`` (``_DEAD`` if the
        token was not allowed — callers that honor the mask never see
        it)."""
        return self._walk(state, tok)

    def accepting(self, state: frozenset) -> bool:
        """True when the text emitted so far is a COMPLETE conforming
        document (the empty config survived)."""
        return () in state

    def allowed_mask(self, state: frozenset) -> np.ndarray:
        """Boolean ``[V]`` mask of tokens that keep the emission a valid
        prefix; EOS is allowed exactly at accepting states.  Memoized
        per state (the per-step steady-state cost is one dict hit)."""
        mask = self._masks.get(state)
        if mask is None:
            mask = np.zeros(len(self.vocab), dtype=bool)
            for tok in range(len(self.vocab)):
                if self._walk(state, tok):
                    mask[tok] = True
            if self.eos_id is not None:
                mask[self.eos_id] = self.accepting(state)
            self._masks[state] = mask
        return mask

    def exhausted(self, state: frozenset) -> bool:
        """Accepting with NO other continuation — the engine finishes
        the sequence outright here (finish reason ``grammar``) instead
        of waiting for the model to draw EOS."""
        if not self.accepting(state):
            return False
        mask = self.allowed_mask(state)
        if self.eos_id is not None:
            live = int(mask.sum()) - int(mask[self.eos_id])
        else:
            live = int(mask.sum())
        return live == 0

    def matches(self, tokens: Sequence[int]) -> bool:
        """Offline check: does this exact token sequence spell a
        complete conforming document?  A trailing EOS is accepted
        exactly where the live mask allows it — at an accepting state —
        so engine outputs that stopped on EOS validate as-is.
        (Tests/bench validation.)"""
        state = self.start
        for pos, tok in enumerate(tokens):
            if self.eos_id is not None and int(tok) == self.eos_id:
                return (pos == len(tokens) - 1
                        and self.accepting(state))
            state = self._walk(state, int(tok))
            if not state:
                return False
        return self.accepting(state)
