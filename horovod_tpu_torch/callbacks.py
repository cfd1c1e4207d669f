"""Training callbacks — the Keras callback surface, framework-neutral.

Port of ``horovod_tpu/callbacks.py`` (the reference's
``horovod/_keras/callbacks.py``): ``BroadcastGlobalVariablesCallback``
(rank 0's initial model and optimizer state to all),
``MetricAverageCallback`` (allreduce-average epoch metrics),
``LearningRateScheduleCallback`` / ``LearningRateWarmupCallback`` (scale
and warm up the learning rate with the world size, the "1-hour
ImageNet" recipe), ``EarlyStoppingCallback`` and ``CallbackList``.

They are plain objects with ``on_train_begin`` / ``on_epoch_begin`` /
``on_epoch_end`` / ``on_batch_begin`` hooks that any training loop
drives.  Where the JAX package's ``state`` carries ``params`` and
``opt_state``, a torch loop's carries its ``model`` and ``optimizer``,
which the broadcast changes in place.
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, List, Optional

import torch

from . import core as _core
from . import functions as _functions
from . import ops as _ops
from .utils.logging import get_logger


class Callback:
    def on_train_begin(self, state=None):
        pass

    def on_epoch_begin(self, epoch: int, state=None):
        pass

    def on_epoch_end(self, epoch: int, logs: Optional[Dict] = None,
                     state=None):
        pass

    def on_batch_begin(self, batch: int, state=None):
        pass


class BroadcastGlobalVariablesCallback(Callback):
    """Broadcast the initial parameters (and optimizer state) from
    ``root_rank`` at train begin (``_keras/callbacks.py``
    ``BroadcastGlobalVariablesCallbackImpl``).  ``state`` must expose
    ``model`` (anything ``broadcast_parameters`` takes) and may expose
    ``optimizer`` (through ``broadcast_optimizer_state``)."""

    def __init__(self, root_rank: int = 0):
        self.root_rank = root_rank

    def on_train_begin(self, state=None):
        if state is None:
            return
        if hasattr(state, "model"):
            _functions.broadcast_parameters(state.model,
                                            root_rank=self.root_rank)
        if getattr(state, "optimizer", None) is not None:
            _functions.broadcast_optimizer_state(state.optimizer,
                                                 root_rank=self.root_rank)


class MetricAverageCallback(Callback):
    """Average metrics over ranks at epoch end
    (``_keras/callbacks.py`` ``MetricAverageCallbackImpl``), each as an
    f32 scalar on this rank's device."""

    def on_epoch_end(self, epoch: int, logs: Optional[Dict] = None,
                     state=None):
        if not logs:
            return
        for k, val in list(logs.items()):
            arr = torch.as_tensor(val, dtype=torch.float32,
                                  device=_core.device())
            avg = _ops.allreduce(arr, op=_ops.ReduceOp.AVERAGE)
            logs[k] = float(avg.reshape(-1)[0])


class LearningRateScheduleCallback(Callback):
    """Multiply the LR by ``multiplier`` within [start_epoch, end_epoch)
    (``_keras/callbacks.py`` ``LearningRateScheduleCallbackImpl``).
    ``set_lr`` is a callable the training loop provides (for a
    ``torch.optim`` optimizer, one that writes each param group's
    ``lr``)."""

    def __init__(self, set_lr: Callable[[float], None], initial_lr: float,
                 multiplier, start_epoch: int = 0,
                 end_epoch: Optional[int] = None, staircase: bool = True):
        self.set_lr = set_lr
        self.initial_lr = initial_lr
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        self.staircase = staircase
        if callable(multiplier):
            self.multiplier_fn = multiplier
        else:
            self.multiplier_fn = lambda epoch: multiplier

    def _in_range(self, epoch) -> bool:
        if epoch < self.start_epoch:
            return False
        return self.end_epoch is None or epoch < self.end_epoch

    def on_epoch_begin(self, epoch: int, state=None):
        if self._in_range(epoch):
            self.set_lr(self.initial_lr * self.multiplier_fn(epoch))


class LearningRateWarmupCallback(LearningRateScheduleCallback):
    """Linear warm-up from lr to lr·size over ``warmup_epochs``
    (``_keras/callbacks.py`` ``LearningRateWarmupCallbackImpl``, the
    linear-scaling + warm-up recipe).  After warm-up the multiplier is
    the world size (``num_slots()``)."""

    def __init__(self, set_lr: Callable[[float], None], initial_lr: float,
                 warmup_epochs: int = 5, momentum_correction: bool = True,
                 verbose: bool = False):
        self.warmup_epochs = warmup_epochs
        self.momentum_correction = momentum_correction
        if momentum_correction:
            warnings.warn(
                "momentum_correction is accepted for API parity but not "
                "applied automatically: rescale the optimizer's momentum "
                "alongside set_lr", stacklevel=2)

        def multiplier(epoch):
            size = _core.num_slots()
            if epoch >= warmup_epochs:
                return float(size)
            # epoch 0 -> exactly 1.0 (true warm start), reaching `size` at
            # epoch == warmup_epochs (linear, the 1-hour-ImageNet recipe).
            return 1.0 + (size - 1.0) * epoch / max(warmup_epochs, 1)

        super().__init__(set_lr, initial_lr, multiplier,
                         start_epoch=0, end_epoch=None)


class EarlyStoppingCallback(Callback):
    """Stop training when a monitored metric stops improving (the Keras
    EarlyStopping the reference's estimators accept as a fit callback).

    SPMD contract: the decision must be IDENTICAL on every rank — monitor
    only metrics that are already rank-consistent (apply
    MetricAverageCallback first).  The driving loop checks
    ``stop_training`` after ``on_epoch_end``."""

    def __init__(self, monitor: str = "val_loss", patience: int = 0,
                 min_delta: float = 0.0, mode: str = "min"):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.mode = mode
        self.best: Optional[float] = None
        self.wait = 0
        self.stop_training = False
        self.stopped_epoch: Optional[int] = None

    def _improved(self, value: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "min":
            return value < self.best - self.min_delta
        return value > self.best + self.min_delta

    def on_epoch_end(self, epoch: int, logs: Optional[Dict] = None,
                     state=None):
        if not logs or self.monitor not in logs:
            # Keras parity: warn, don't silently disable — the default
            # monitor 'val_loss' is absent when no validation is
            # configured, and a typoed name would otherwise train every
            # epoch with the user none the wiser.
            if not getattr(self, "_warned_missing", False):
                self._warned_missing = True
                get_logger().warning(
                    "EarlyStoppingCallback: monitored metric %r not in "
                    "epoch logs (keys: %s) — early stopping inactive",
                    self.monitor, sorted(logs or {}))
            return
        value = float(logs[self.monitor])
        if self._improved(value):
            self.best = value
            self.wait = 0
            return
        self.wait += 1
        # Keras semantics: stop once `patience` epochs pass with no
        # improvement (wait >= patience; patience=0 stops on the first).
        if self.wait >= max(self.patience, 1):
            self.stop_training = True
            self.stopped_epoch = epoch


class CallbackList:
    def __init__(self, callbacks: List[Callback]):
        self.callbacks = list(callbacks)

    @property
    def stop_training(self) -> bool:
        return any(getattr(cb, "stop_training", False)
                   for cb in self.callbacks)

    def __getattr__(self, hook):
        if not hook.startswith("on_"):
            raise AttributeError(hook)

        def fire(*args, **kwargs):
            for cb in self.callbacks:
                getattr(cb, hook)(*args, **kwargs)

        return fire
