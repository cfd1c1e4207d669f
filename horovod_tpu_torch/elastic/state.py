"""Elastic state objects: in-memory commit, disk spill and cross-rank sync.

Port of ``horovod_tpu/elastic/state.py``: ``State`` (``:30``, commit and
the disk spill ``:63-160``), ``ObjectState`` (``:187``) and, in place of
``ArrayState`` / ``TpuState`` (``:223``, ``:261``), ``TorchState``, the
reference's own torch name (``torch/elastic/state.py``).

``TorchState(model=None, optimizer=None, **kwargs)``: a commit copies
every ``nn.Module``'s ``state_dict``, every optimizer's ``state_dict``
(a ``DistributedOptimizer``'s carries its aggregation cycle), every
tensor and every ``state_dict`` / ``load_state_dict`` object (an
``ElasticSampler``) to host memory, CUDA tensors through pinned buffers
reused from commit to commit and one synchronize before anything reads
them; plain attributes are deep-copied.  ``restore`` copies back in
place on the rank's device (``copy_`` into the live parameters and
buffers), so the optimizer's and ``DistributedOptimizer``'s parameter
references survive; an optimizer gets ``load_state_dict`` of a fresh
copy of the commit.  ``sync`` broadcasts rank 0's values: parameters and
buffers in place, an optimizer's and a stateful object's state and the
plain attributes as one pickled object each (a new rank's optimizer has
no state yet, so a tensor-by-tensor broadcast would not line up).

The spill (``HVD_TPU_ELASTIC_SPILL_DIR`` or ``spill_dir``) pickles the
host commit atomically (tmp + ``os.replace``) to a file keyed by host
and local rank; a respawned incarnation adopts it at ``elastic.run``
entry when it is ahead of its own commit.

``check_host_updates`` (``:164``) follows the reference
(``common/elastic.py`` ``State.check_host_updates``) where the JAX
package does not: in a world of more than one rank, rank 0's view of
the pending host updates is broadcast, so every rank raises
``HostsUpdatedInterrupt`` at the same commit.
"""

from __future__ import annotations

import copy
import os
import pickle
import socket
import time
from typing import Any, Callable, Dict, List, Optional

import torch
from torch import nn

from ..exceptions import HostsUpdatedInterrupt
from .. import config as _config
from .. import functions as _functions
from ..utils.host import clone_tree, host_copy, host_tree, settle


class State:
    """State representation for ``elastic.run`` (common/elastic.py:26).

    Subclasses implement save/restore/sync; users call ``commit()`` at
    safe points (typically every N batches) and the elastic loop calls
    ``restore()`` after a failure or ``sync()`` after a topology
    change."""

    def __init__(self, spill_dir: Optional[str] = None, **kwargs):
        self._reset_callbacks: List[Callable] = []
        self._host_messages = None  # set by the notification manager
        self._commit_seq = 0  # progress marker for the elastic retry bound
        # Disk spill: survives ABRUPT peer death, which the in-memory
        # commit cannot — a survivor that leaves a broken world by exiting
        # takes its memory with it.  The respawned incarnation picks the
        # spill up via load_spill().
        self._spill_dir = spill_dir or os.environ.get(
            "HVD_TPU_ELASTIC_SPILL_DIR")

    def register_reset_callbacks(self, callbacks) -> None:
        """Callbacks invoked after a world reset (rebuild data sharding,
        re-register process sets — common/elastic.py
        register_reset_callbacks)."""
        self._reset_callbacks.extend(callbacks)

    def on_reset(self) -> None:
        self.reset()
        for cb in self._reset_callbacks:
            cb()

    def on_hosts_updated(self, updated_hosts, update_res) -> None:
        if self._host_messages is not None:
            self._host_messages.append((updated_hosts, update_res))

    def commit(self) -> None:
        """Checkpoint to memory (and to disk when spill is enabled) and
        check for host changes (common/elastic.py State.commit).
        ``last_commit_ms`` holds the host ms of the save and the spill."""
        t0 = time.perf_counter()
        self.save()
        t1 = time.perf_counter()
        self._commit_seq = getattr(self, "_commit_seq", 0) + 1
        self._spill()
        self.last_commit_ms = (1e3 * (t1 - t0),
                               1e3 * (time.perf_counter() - t1))
        self.check_host_updates(collective=True)

    # Disk spill ------------------------------------------------------------
    def _spill_path(self) -> Optional[str]:
        """Spill file keyed by (hostname, local_rank): stable across a full
        job restart even when global ranks are reshuffled by the new world
        (the post-restart ``sync()`` broadcast from rank 0 makes whichever
        copy the new rank 0 loaded authoritative)."""
        if not getattr(self, "_spill_dir", None):
            return None
        host = os.environ.get(_config.HOROVOD_HOSTNAME, socket.gethostname())
        local_rank = os.environ.get(_config.HOROVOD_LOCAL_RANK, "0")
        return os.path.join(self._spill_dir, f"state-{host}-{local_rank}.pkl")

    def _spill(self) -> None:
        path = self._spill_path()
        if path is None:
            return
        try:
            data = self._spill_payload()
        except NotImplementedError:
            # Custom State subclasses written against the original
            # save/restore/sync contract: degrade gracefully (warn once)
            # instead of failing the first commit() mid-training.
            if not getattr(self, "_spill_warned", False):
                self._spill_warned = True
                from ..utils.logging import get_logger
                get_logger().warning(
                    "%s does not implement _spill_payload/"
                    "_load_spill_payload; disk spill is disabled for it "
                    "(implement both hooks to survive abrupt crashes)",
                    type(self).__name__)
            return
        try:
            os.makedirs(self._spill_dir, exist_ok=True)
            payload = {"seq": self._commit_seq, "data": data}
            # Atomic publish: a crash mid-pickle leaves the previous
            # commit's file intact (tmp + rename on the same filesystem).
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(tmp, path)
        except Exception as e:
            # A full/unwritable spill directory — or an unpicklable state
            # attribute — must not kill the job the spill exists to
            # harden: the in-memory commit remains valid, only
            # crash-survival degrades.  Warn (throttled).
            now = time.time()
            if now - getattr(self, "_spill_err_ts", 0.0) > 60.0:
                self._spill_err_ts = now
                from ..utils.logging import get_logger
                get_logger().warning(
                    "elastic spill to %s failed (%s); training continues "
                    "but a crash now loses progress since the last good "
                    "spill", path, e)

    def load_spill(self) -> bool:
        """Adopt a previous process incarnation's last on-disk commit if it
        is AHEAD of this object's in-memory commit.  Returns True when state
        was loaded.  Called automatically at ``elastic.run`` entry."""
        path = self._spill_path()
        if path is None or not os.path.exists(path):
            return False
        try:
            with open(path, "rb") as f:
                payload = pickle.load(f)
        except Exception:
            return False  # torn/corrupt file: fall back to in-memory state
        if payload.get("seq", 0) <= getattr(self, "_commit_seq", 0):
            return False
        try:
            self._load_spill_payload(payload["data"])
        except NotImplementedError:
            return False  # subclass without spill hooks (see _spill)
        self._commit_seq = payload["seq"]
        return True

    def clear_spill(self) -> None:
        """Remove the spill file (on successful training completion, so a
        LATER job reusing the directory does not resurrect stale state)."""
        path = self._spill_path()
        if path is not None and os.path.exists(path):
            try:
                os.remove(path)
            except OSError:
                pass

    def _spill_payload(self) -> Any:
        raise NotImplementedError

    def _load_spill_payload(self, data: Any) -> None:
        raise NotImplementedError

    def check_host_updates(self, collective: bool = False) -> None:
        """Raise HostsUpdatedInterrupt when membership changed
        (common/elastic.py:83 check_host_updates).  ``collective`` (a
        commit): in a world of more than one rank, rank 0's pending
        updates are broadcast and decide for every rank, as in the
        reference, so all ranks leave at the same commit."""
        if self._host_messages is None:
            return
        pending = [res for _, res in self._host_messages]
        self._host_messages.clear()
        if collective:
            from .. import core as _core
            if _core.is_initialized() and _core.size() > 1:
                pending = _functions.broadcast_object(pending, root_rank=0)
        if pending:
            # skip_sync if only scale-up: HostManager encodes additive
            # updates as res == 2 and removals as res == 1.  elastic.run
            # syncs all the same when any rank of the new world (a new
            # worker) asks for it.
            raise HostsUpdatedInterrupt(
                skip_sync=all(res == 2 for res in pending))

    # Subclass interface -----------------------------------------------------
    def save(self) -> None:
        raise NotImplementedError

    def restore(self) -> None:
        raise NotImplementedError

    def sync(self) -> None:
        raise NotImplementedError

    def reset(self) -> None:
        pass


class ObjectState(State):
    """State for arbitrary pickleable attributes (common/elastic.py:116
    ObjectState): attributes set via kwargs, saved/restored by deep copy,
    synced by rank-0 object broadcast."""

    def __init__(self, bcast_object=None, get_rank=None, spill_dir=None,
                 **kwargs):
        self._bcast_object = bcast_object or _functions.broadcast_object
        self._saved_state = dict(kwargs)
        self.__dict__.update(kwargs)
        super().__init__(spill_dir=spill_dir)

    def save(self) -> None:
        new_state = {}
        for attr in self._saved_state.keys():
            new_state[attr] = copy.deepcopy(getattr(self, attr))
        self._saved_state = new_state

    def restore(self) -> None:
        self.__dict__.update(copy.deepcopy(self._saved_state))

    def sync(self) -> None:
        if self._saved_state:
            synced = self._bcast_object(self._saved_state, root_rank=0)
            self._saved_state = synced
            self.__dict__.update(
                {k: copy.deepcopy(v) for k, v in synced.items()})

    def _spill_payload(self):
        return self._saved_state

    def _load_spill_payload(self, data) -> None:
        self._saved_state = data
        self.restore()


def _is_optimizer(v) -> bool:
    from ..optimizer import DistributedOptimizer
    return isinstance(v, (torch.optim.Optimizer, DistributedOptimizer))


def _is_stateful(v) -> bool:
    return callable(getattr(v, "state_dict", None)) and \
        callable(getattr(v, "load_state_dict", None))


class TorchState(ObjectState):
    """Model, optimizer, tensors, samplers and plain attributes
    (``hvd.elastic.TorchState(model, optimizer, epoch=0, batch=0)``,
    the reference's torch/elastic/state.py TorchState; the JAX package's
    ``TpuState``).  Attributes are reached as ``state.model``,
    ``state.optimizer``, ``state.<name>``."""

    def __init__(self, model: Optional[nn.Module] = None, optimizer=None,
                 bcast_object=None, spill_dir=None, **kwargs):
        if model is not None:
            kwargs["model"] = model
        if optimizer is not None:
            kwargs["optimizer"] = optimizer
        self._modules_keys = [k for k, v in kwargs.items()
                              if isinstance(v, nn.Module)]
        self._optim_keys = [k for k, v in kwargs.items() if _is_optimizer(v)]
        self._tensor_keys = [k for k, v in kwargs.items()
                             if isinstance(v, torch.Tensor)]
        handled = set(self._modules_keys + self._optim_keys
                      + self._tensor_keys)
        self._stateful_keys = [k for k, v in kwargs.items()
                               if k not in handled and _is_stateful(v)]
        handled |= set(self._stateful_keys)
        self._object_keys = [k for k in kwargs if k not in handled]
        # The host commit: one entry per handled attribute.
        self._host: Dict[str, Any] = {}
        objects = {k: kwargs[k] for k in self._object_keys}
        super().__init__(bcast_object=bcast_object, spill_dir=spill_dir,
                         **objects)
        for k in handled:
            setattr(self, k, kwargs[k])
        self.save()

    # -- commit / restore --------------------------------------------------

    def save(self) -> None:
        host = self._host
        for k in self._modules_keys:
            host[k] = host_tree(getattr(self, k).state_dict(), host.get(k))
        for k in self._optim_keys:
            host[k] = host_tree(getattr(self, k).state_dict(), host.get(k))
        for k in self._tensor_keys:
            host[k] = host_copy(getattr(self, k), host.get(k))
        for k in self._stateful_keys:
            host[k] = copy.deepcopy(getattr(self, k).state_dict())
        settle()
        self._saved_state = {k: copy.deepcopy(getattr(self, k))
                             for k in self._object_keys}

    @torch.no_grad()
    def restore(self) -> None:
        """The last commit, in place; ``last_restore_ms`` holds its host
        ms."""
        t0 = time.perf_counter()
        for k in self._modules_keys:
            live = getattr(self, k).state_dict()
            saved = self._host[k]
            for name, t in live.items():
                t.copy_(saved[name])
        for k in self._optim_keys:
            getattr(self, k).load_state_dict(clone_tree(self._host[k]))
        for k in self._tensor_keys:
            live = getattr(self, k)
            saved = self._host[k]
            if live.shape == saved.shape and live.dtype == saved.dtype:
                live.copy_(saved)
            else:
                setattr(self, k, saved.to(live.device, copy=True))
        for k in self._stateful_keys:
            getattr(self, k).load_state_dict(copy.deepcopy(self._host[k]))
        self.__dict__.update(copy.deepcopy(self._saved_state))
        settle()
        self.last_restore_ms = 1e3 * (time.perf_counter() - t0)

    def sync(self) -> None:
        """Rank 0's values on every rank (after a reset)."""
        from .. import core as _core
        for k in self._modules_keys:
            _functions.broadcast_variables(getattr(self, k), root_rank=0)
        for k in self._optim_keys:
            opt = getattr(self, k)
            sd = host_tree(opt.state_dict()) if _core.rank() == 0 else None
            settle()
            opt.load_state_dict(self._bcast_object(sd, root_rank=0))
        for k in self._tensor_keys:
            _functions.broadcast_variables(getattr(self, k), root_rank=0)
        for k in self._stateful_keys:
            obj = getattr(self, k)
            obj.load_state_dict(self._bcast_object(
                obj.state_dict() if _core.rank() == 0 else None,
                root_rank=0))
        if self._object_keys:
            synced = self._bcast_object(
                {k: getattr(self, k) for k in self._object_keys},
                root_rank=0)
            self.__dict__.update(copy.deepcopy(synced))

    # -- spill ---------------------------------------------------------------

    def _spill_payload(self):
        # Host tensors (pinned ones pickle as plain CPU tensors) and deep
        # copies of plain attributes.
        return {"host": self._host, "objects": self._saved_state}

    def _load_spill_payload(self, data) -> None:
        self._host = data["host"]
        self._saved_state = data["objects"]
        self.restore()
