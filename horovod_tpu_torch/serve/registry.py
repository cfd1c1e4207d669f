"""Model registry and live weight hot-swap for the serving fleet.

Port of ``horovod_tpu/serve/registry.py``.  A ``ModelRegistry`` holds
several *named model variants* resident across the fleet — a full
parameter set (a ``state_dict``, or a checkpoint read by
``checkpoint.load_params``), or a LoRA-style **delta** over a shared
base (``apply_delta`` materializes ``W + alpha * A @ B`` per targeted
tensor, so the variant shares every untouched tensor with the base by
reference).  ``/generate`` requests carrying a ``model`` field route
through the ``ReplicaScheduler`` to the replicas holding that variant
(replica.py filters candidates on ``engine._adapters``).

Live rollout (``roll``): new weights for a registered variant walk the
fleet **replica by replica** through drain → ``mark_dead`` → swap →
``mark_alive`` (which re-runs warmup), so at every instant all but one
replica serve traffic and no request fails: the drained replica's work
moves to the survivors still holding the variant, and version-salted
prefix hashes (``engine._prefix_salt``) keep cached prefixes from
crossing the version boundary.  Each replica transition emits a
timeline instant (``ServeMetrics.swap_event``) and advances the
``hvd_serve_swap_progress`` gauge.

A roll is **resumable**: the pending (version, adapter) pair persists
until every replica reports that version, so a roll aborted mid-fleet
(faultline's ``swap-abort`` at the ``registry.roll`` point) leaves a
half-rolled fleet that keeps serving both versions, and a bare
``roll(name)`` finishes the walk.

Locking: ``_lock`` protects ONLY the registry's own tables and is never
held across scheduler or engine calls.

Parameters are the port's ``state_dict`` names (``blocks.0.attn.qkv.kernel``,
the flax leaf layouts, ``models/convert.py``).  One difference from JAX:
a low-rank pair is contracted as ``tensordot(A, B, 1)`` (A's last axis
with B's first), which is ``A @ B`` for 2-D pairs and lets B carry the
leaf's output layout — a rank-r update of the qkv kernel ``[d, 3, H,
Dh]`` is ``A [d, r]``, ``B [r, 3, H, Dh]``.  JAX's ``a @ b`` broadcasts
such a B instead, and its shape check then refuses the pair.
"""

from __future__ import annotations

import threading
import zlib
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch

from ..faultline import runtime as _faultline
from ..faultline.plan import FaultInjected
from ..utils import get_logger
from .metrics import ServeMetrics


def model_salt(name: str, version: int) -> int:
    """Prefix-hash salt for a (variant, version) pair.  The default
    variant at version 0 salts to 0, so single-model deployments keep
    the unsalted chain hashes; everything else gets a distinct crc32 — a
    version bump invalidates prefix reuse across a roll."""
    if version == 0 and name == "default":
        return 0
    return zlib.crc32(f"{name}:{version}".encode("utf-8")) or 1


def apply_delta(base_params, delta: Dict[str, object],
                alpha: float = 1.0) -> Dict[str, torch.Tensor]:
    """Materialize a LoRA-style variant over ``base_params`` (a
    ``state_dict`` or an ``nn.Module``).

    ``delta`` maps a ``state_dict`` name to a full replacement (a tensor
    or array) or a ``{"a": A, "b": B}`` low-rank pair, materialized as
    ``W + alpha * tensordot(A, B, 1)`` (module doc).  Untouched tensors
    are shared BY REFERENCE with the base; a result whose shape differs
    from the base tensor's raises ValueError."""
    if isinstance(base_params, torch.nn.Module):
        base_params = base_params.state_dict()
    params = dict(base_params)
    for path, patch in delta.items():
        if path not in params:
            raise KeyError(f"delta names {path!r}, which the base "
                           f"parameters do not have")
        base = params[path]

        def like(x):
            return torch.as_tensor(x).to(device=base.device,
                                         dtype=base.dtype)

        if isinstance(patch, Mapping) and "a" in patch and "b" in patch:
            new = base + alpha * torch.tensordot(
                like(patch["a"]), like(patch["b"]), dims=1)
        else:
            new = like(patch)
        if new.shape != base.shape:
            raise ValueError(
                f"delta for {path!r} has shape {tuple(new.shape)}, "
                f"base leaf is {tuple(base.shape)}")
        params[path] = new
    return params


def load_serving_params(path: str) -> Dict[str, torch.Tensor]:
    """A checkpoint's parameters as the port's ``state_dict``
    (``checkpoint.load_params``, host tensors).  A checkpoint holding the
    JAX package's parameter tree (flax names, nested dicts: what orbax
    restores of the JAX ``save_model``, written with ``checkpoint.save``)
    is converted through ``checkpoint.params_from_jax_checkpoint``; the
    port does not read orbax's own format."""
    from .. import checkpoint as _ckpt
    from ..models.convert import params_from_jax
    params = _ckpt.load_params(path)
    if any(isinstance(v, Mapping) for v in params.values()):
        params = _ckpt.params_from_jax_checkpoint(
            {"params": params}, convert=params_from_jax)["params"]
    return params


class ModelVariant:
    """One named variant's fleet-wide record."""

    def __init__(self, name: str, adapter, version: int = 0):
        self.name = name
        self.adapter = adapter
        self.version = version

    def to_dict(self) -> dict:
        return {"name": self.name, "version": self.version}


class ModelRegistry:
    """Named model variants + per-replica placement + live rollout
    (module doc).  ``adapter_builder(params)`` makes an adapter from a
    ``state_dict``; ``base_params`` is the base a delta applies to."""

    def __init__(self, scheduler,
                 adapter_builder: Optional[Callable] = None,
                 metrics: Optional[ServeMetrics] = None,
                 base_params=None):
        self.scheduler = scheduler
        self.adapter_builder = adapter_builder
        self.metrics = metrics if metrics is not None \
            else getattr(scheduler, "metrics", None) or ServeMetrics()
        self.base_params = base_params
        self._lock = threading.Lock()
        self._variants: Dict[str, ModelVariant] = {}
        # (replica_id, name) -> version that replica currently serves.
        self._replica_versions: Dict[Tuple[str, str], int] = {}
        # name -> (target_version, adapter): a roll in flight (or
        # aborted mid-fleet and awaiting resume).
        self._pending: Dict[str, Tuple[int, object]] = {}
        self._rolling: set = set()
        _faultline.maybe_install_from_env()

    # -- introspection -------------------------------------------------------

    def has(self, name: str) -> bool:
        with self._lock:
            return name in self._variants

    def models(self) -> List[dict]:
        with self._lock:
            out = []
            for v in self._variants.values():
                d = v.to_dict()
                d["pending_version"] = self._pending.get(v.name,
                                                         (None,))[0]
                out.append(d)
            return out

    def replicas_for(self, name: str) -> List[str]:
        """Replica ids currently holding ``name`` (any version)."""
        return [r.replica_id for r in self.scheduler.fleet()
                if name in r.engine._adapters]

    # -- registration --------------------------------------------------------

    def adopt(self, name: str = "default") -> ModelVariant:
        """Record a variant the engines ALREADY hold (their construction
        default) so it takes part in ``roll()`` / ``models()``."""
        holders = [r for r in self.scheduler.fleet()
                   if name in r.engine._adapters]
        if not holders:
            raise KeyError(f"no replica holds model {name!r}")
        eng = holders[0].engine
        with self._lock:
            if name in self._variants:
                return self._variants[name]
            variant = ModelVariant(name, eng._adapters[name],
                                   version=eng._model_versions[name])
            self._variants[name] = variant
            for r in holders:
                self._replica_versions[(r.replica_id, name)] = \
                    r.engine._model_versions[name]
        return variant

    def _build_adapter(self, params=None,
                       checkpoint_path: Optional[str] = None,
                       delta: Optional[Dict[str, object]] = None,
                       alpha: float = 1.0):
        if sum(x is not None for x in (params, checkpoint_path,
                                       delta)) != 1:
            raise ValueError(
                "pass exactly one of params / checkpoint_path / delta")
        if checkpoint_path is not None:
            params = load_serving_params(checkpoint_path)
        elif delta is not None:
            if self.base_params is None:
                raise ValueError(
                    "delta registration needs base_params on the "
                    "registry")
            params = apply_delta(self.base_params, delta, alpha=alpha)
        if self.adapter_builder is None:
            raise ValueError("registry has no adapter_builder")
        return self.adapter_builder(params)

    def register(self, name: str, params=None,
                 checkpoint_path: Optional[str] = None,
                 delta: Optional[Dict[str, object]] = None,
                 alpha: float = 1.0, adapter=None,
                 replica_ids: Optional[List[str]] = None) -> ModelVariant:
        """Make variant ``name`` resident on the targeted replicas (all
        of them when ``replica_ids`` is None).  One adapter object serves
        every placement."""
        from .tenancy import safe_tenant
        if safe_tenant(name) is None:
            raise ValueError(f"invalid model name {name!r}")
        if adapter is None:
            adapter = self._build_adapter(
                params=params, checkpoint_path=checkpoint_path,
                delta=delta, alpha=alpha)
        with self._lock:
            if name in self._variants:
                raise ValueError(
                    f"model {name!r} already registered; use roll() to "
                    "update its weights")
            variant = ModelVariant(name, adapter, version=0)
            self._variants[name] = variant
        targets = [r for r in self.scheduler.fleet()
                   if replica_ids is None or r.replica_id in replica_ids]
        for r in targets:
            r.engine.add_model(name, adapter, version=0)
            with self._lock:
                self._replica_versions[(r.replica_id, name)] = 0
        get_logger().info("registry: model %r resident on %d replica(s)",
                          name, len(targets))
        return variant

    # -- live rollout (module doc) -------------------------------------------

    def roll(self, name: str, checkpoint_path: Optional[str] = None,
             params=None, delta: Optional[Dict[str, object]] = None,
             alpha: float = 1.0, adapter=None) -> int:
        """Roll variant ``name`` to new weights replica by replica with
        zero failed requests (module doc).  With no weight source, a
        pending (aborted) roll is RESUMED.  Returns the number of
        replicas transitioned by this call."""
        with self._lock:
            if name not in self._variants:
                raise KeyError(f"unknown model {name!r}")
            if name in self._rolling:
                raise RuntimeError(f"a roll of {name!r} is already "
                                   "in flight")
            if any(x is not None for x in (checkpoint_path, params,
                                           delta, adapter)):
                target = self._variants[name].version + 1
                pend = self._pending.get(name)
                if pend is not None and pend[0] != target:
                    raise RuntimeError(
                        f"model {name!r} has an unfinished roll to "
                        f"version {pend[0]}; resume it with roll("
                        f"{name!r}) first")
            elif name in self._pending:
                target = self._pending[name][0]
            else:
                raise ValueError(
                    f"no new weights and no pending roll for {name!r}")
            self._rolling.add(name)
        try:
            return self._walk(name, target, checkpoint_path, params,
                              delta, alpha, adapter)
        finally:
            with self._lock:
                self._rolling.discard(name)

    def _walk(self, name: str, target: int, checkpoint_path, params,
              delta, alpha: float, adapter=None) -> int:
        with self._lock:
            pending = self._pending.get(name)
        if pending is not None:
            adapter = pending[1]
        elif adapter is None:
            adapter = self._build_adapter(
                params=params, checkpoint_path=checkpoint_path,
                delta=delta, alpha=alpha)
        if pending is None:
            with self._lock:
                self._pending[name] = (target, adapter)
        holders = [r for r in self.scheduler.fleet()
                   if name in r.engine._adapters]
        total = len(holders)
        with self._lock:
            done = sum(
                1 for r in holders
                if self._replica_versions.get((r.replica_id, name), 0)
                >= target)
        self.metrics.set_swap_progress(name, done, total)
        moved = 0
        for r in holders:
            with self._lock:
                if self._replica_versions.get((r.replica_id, name), 0) \
                        >= target:
                    continue
            # The ``registry.roll`` injection point: a swap-abort fires
            # BEFORE this replica is touched, so it keeps serving the
            # old version and the pending record makes roll(name)
            # resumable.
            for f in _faultline.fire("registry.roll", r.replica_id):
                if f.kind == "swap-abort":
                    self.metrics.swap_event(name, r.replica_id,
                                            "abort", target)
                    raise FaultInjected(
                        f"swap-abort at registry.roll "
                        f"({name} -> v{target}, replica "
                        f"{r.replica_id})")
            self.metrics.swap_event(name, r.replica_id, "drain", target)
            r.rolling = True
            try:
                # mark_dead closes the batcher and requeues this
                # replica's queued and in-flight work onto the survivors
                # that hold the variant; the swap happens on the stopped
                # engine; mark_alive reopens, re-warms and rejoins.
                self.scheduler.mark_dead(
                    r.replica_id, reason=f"roll {name} -> v{target}")
                r.engine.swap_model(name, adapter, version=target)
                self.metrics.swap_event(name, r.replica_id, "swap",
                                        target)
                self.scheduler.mark_alive(
                    r.replica_id, reason=f"rolled {name} to v{target}")
            finally:
                r.rolling = False
            with self._lock:
                self._replica_versions[(r.replica_id, name)] = target
            done += 1
            moved += 1
            self.metrics.set_swap_progress(name, done, total)
            self.metrics.swap_event(name, r.replica_id, "alive", target)
        with self._lock:
            self._variants[name].adapter = adapter
            self._variants[name].version = target
            self._pending.pop(name, None)
        get_logger().info(
            "registry: model %r now at version %d fleet-wide "
            "(%d replica(s) transitioned this call)", name, target,
            moved)
        return moved
