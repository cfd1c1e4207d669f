"""Checkpoint helpers: the rank-0-writes / broadcast-on-load convention.

Port of ``horovod_tpu/checkpoint.py``: ``save`` (``:40``), ``save_model``
(``:61``), ``load_model`` (``:83``), ``load_params`` (``:121``) and
``restore`` (``:136``), over ``torch.save`` / ``torch.load`` where JAX
uses orbax.  A checkpoint is a directory: ``state.pt`` (host copies of
the tensors) and, from ``save_model``, the ``extra.json`` sidecar.

* Only rank 0 writes.  The barrier that holds the other ranks runs in
  ``finally``, so a failed rank-0 write cannot hang them, and the
  sidecar is written before the barrier releases anyone.
* Loading happens on rank 0; the values reach the other ranks by
  ``broadcast_variables`` (a model's parameters and buffers, in place),
  ``broadcast_object`` (the optimizer's state, the sidecar, a tree
  without a template).
* ``load_model`` re-wraps the base optimizer in
  ``DistributedOptimizer(**wrap_kwargs)`` and restores its full state,
  the local-aggregation cycle included, so a checkpoint taken
  mid-cycle resumes the exact trajectory.

``params_from_jax_checkpoint`` converts what orbax restores from the JAX
package's ``save_model`` (``{"params", "opt_state"}`` as numpy arrays)
into the port's ``state_dict`` and Adam state (optax ``ScaleByAdamState``
``count`` / ``mu`` / ``nu`` → torch ``step`` / ``exp_avg`` /
``exp_avg_sq``), in the style of ``models/convert.py``;
``params_to_jax`` goes back for the parameters.  The port never reads
orbax's format itself: a caller (a test) restores the tree with orbax.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from . import core as _core
from . import functions as _functions
from .utils.host import host_tree, settle

STATE_FILE = "state.pt"
EXTRA_FILE = "extra.json"


def _to_host(obj):
    """Host copies of a module's ``state_dict`` or a tree of tensors."""
    out = host_tree(obj.state_dict() if isinstance(obj, nn.Module) else obj)
    settle()
    return out


def _to_device(obj, device):
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, Mapping):
        return {k: _to_device(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_device(v, device) for v in obj)
    return obj


def _state_dict_of(opt):
    return None if opt is None else opt.state_dict()


def save(path: str, state: Any, force: bool = True,
         _rank0_post: Optional[Callable[[], None]] = None) -> None:
    """Write ``state`` (a tree of tensors, a module or a ``state_dict``)
    from rank 0 only; the other ranks wait at a barrier so nobody races
    ahead of an incomplete write.  ``_rank0_post`` runs on rank 0 after
    the write but BEFORE the barrier, so sidecar files are in place
    before any rank is released to read."""
    from . import ops as _ops
    try:
        if _core.rank() == 0:
            path = os.path.abspath(path)
            target = os.path.join(path, STATE_FILE)
            if os.path.exists(target) and not force:
                raise FileExistsError(f"{target} exists (force=False)")
            os.makedirs(path, exist_ok=True)
            tmp = target + ".tmp"
            torch.save(_to_host(state), tmp)
            os.replace(tmp, target)
            if _rank0_post is not None:
                _rank0_post()
    finally:
        # The barrier must run even when the rank-0 write raises: the
        # other ranks are already blocking in it, so skipping it would
        # turn a local write failure into a distributed hang.
        if _core.size() > 1:
            _ops.barrier()


def save_model(path: str, model, optimizer=None,
               extra: Optional[dict] = None) -> None:
    """Persist a model (an ``nn.Module`` or its ``state_dict``) WITH its
    optimizer's state (a ``DistributedOptimizer``'s carries the
    aggregation cycle), so retraining resumes the exact trajectory.
    Rank-0-writes semantics of :func:`save` apply."""
    def write_sidecar():
        with open(os.path.join(os.path.abspath(path), EXTRA_FILE),
                  "w") as f:
            json.dump(extra or {}, f)

    params = model.state_dict() if isinstance(model, nn.Module) else model
    save(path, {"params": params, "opt_state": _state_dict_of(optimizer)},
         _rank0_post=write_sidecar)


def _read(path: str) -> Any:
    return torch.load(os.path.join(os.path.abspath(path), STATE_FILE),
                      map_location="cpu", weights_only=True)


def load_model(path: str, model: Optional[nn.Module] = None,
               optimizer: Optional[torch.optim.Optimizer] = None,
               broadcast: bool = True, **wrap_kwargs):
    """Load a checkpoint written by :func:`save_model`.

    ``model``: its parameters and buffers are set from the checkpoint in
    place (rank 0 reads, ``broadcast_variables`` sends).  ``optimizer``
    is the BASE optimizer over ``model``'s parameters, as first passed
    to ``DistributedOptimizer``: it is wrapped again in
    ``DistributedOptimizer(optimizer, **wrap_kwargs)`` and gets the
    saved state, aggregation cycle included.  With ``broadcast=False``
    every rank reads the file itself (a shared filesystem).

    Returns ``(params, opt, opt_state, extra)``: the ``state_dict`` read
    (on the rank's device), the wrapped optimizer (or None), its
    restored ``state_dict`` and the sidecar dict."""
    from .optimizer import DistributedOptimizer
    st = _core._require_init()
    share = broadcast and st.topology.size > 1
    root = _core.rank() == 0
    blob = _read(path) if root or not share else None
    extra = None
    if root or not share:
        extra_path = os.path.join(os.path.abspath(path), EXTRA_FILE)
        if os.path.exists(extra_path):
            with open(extra_path) as f:
                extra = json.load(f)
    if model is not None:
        if blob is not None:
            model.load_state_dict(blob["params"])
        if share:
            _functions.broadcast_variables(model, root_rank=0)
        params = model.state_dict()
    else:
        params = blob["params"] if blob is not None else None
        if share:
            params = _functions.broadcast_object(params, root_rank=0)
        params = _to_device(params, st.device)
    opt_state = blob.get("opt_state") if blob is not None else None
    if share:
        opt_state, extra = _functions.broadcast_object(
            (opt_state, extra), root_rank=0)
    opt = None
    if optimizer is not None:
        opt = DistributedOptimizer(optimizer, **wrap_kwargs)
        if opt_state is not None:
            opt.load_state_dict(opt_state)
    return params, opt, opt_state, extra or {}


def load_params(path: str, template: Optional[Any] = None) -> Any:
    """Serving-plane load: just the params of a checkpoint written by
    :func:`save_model` (or a bare :func:`save` of params), WITHOUT
    ``init()`` or a broadcast, as host tensors.  ``template`` is
    accepted for the JAX signature and not needed."""
    del template
    blob = _read(path)
    if isinstance(blob, Mapping) and "params" in blob:
        return blob["params"]
    return blob


def restore(path: str, template: Optional[Any] = None,
            broadcast: bool = True) -> Any:
    """Load on rank 0 and broadcast to every rank, on the rank's device.
    ``template`` (a tree of tensors like the saved one) lets the other
    ranks receive by ``broadcast_variables`` into it; without one the
    tree travels as one object.  With a shared filesystem every rank may
    read directly (``broadcast=False``)."""
    st = _core._require_init()
    if st.topology.size == 1 or not broadcast:
        return _to_device(_read(path), st.device)
    if _core.rank() == 0:
        restored = _to_device(_read(path), st.device)
    elif template is not None:
        restored = _to_device(_to_host(template), st.device)
    else:
        restored = None
    if template is None:
        return _to_device(_functions.broadcast_object(
            _to_host(restored), root_rank=0), st.device)
    return _functions.broadcast_variables(restored, root_rank=0)


# ---------------------------------------------------------------------------
# The JAX package's checkpoints
# ---------------------------------------------------------------------------

def _find_adam(tree) -> Optional[Mapping]:
    """The first mapping holding optax ``ScaleByAdamState``'s fields."""
    if isinstance(tree, Mapping):
        if {"count", "mu", "nu"} <= set(tree):
            return tree
        items = tree.values()
    elif isinstance(tree, (list, tuple)):
        items = tree
    else:
        return None
    for v in items:
        found = _find_adam(v)
        if found is not None:
            return found
    return None


def _mlp_resnet(params: Mapping) -> Dict[str, torch.Tensor]:
    from .models.convert import resnet_params_from_jax
    return resnet_params_from_jax({"params": params})


def params_from_jax_checkpoint(
        tree: Mapping,
        convert: Callable[[Mapping], Dict[str, torch.Tensor]] = _mlp_resnet
        ) -> Dict[str, Any]:
    """The port's state from what orbax restores of a JAX ``save_model``
    (``{"params": ..., "opt_state": ...}``, numpy leaves).

    ``convert`` maps a flax ``params`` tree to a ``state_dict`` (default:
    the ResNet / MLP / MnistCNN names of ``models/convert.py``; pass
    ``models.convert.params_from_jax`` for a transformer).  The Adam
    moments go through the same mapping, so a conv kernel's moments are
    transposed as the kernel is.  Returns ``{"params": state_dict,
    "adam": {name: {"step", "exp_avg", "exp_avg_sq"}} or None}``; load
    the Adam state with :func:`load_adam_state`."""
    params = tree["params"]
    if isinstance(params, Mapping) and "params" in params and \
            isinstance(params["params"], Mapping):
        params = params["params"]
    out: Dict[str, Any] = {"params": convert(params), "adam": None}
    adam = _find_adam(tree.get("opt_state"))
    if adam is not None:
        def unwrap(t):
            return t["params"] if isinstance(t, Mapping) and \
                "params" in t and isinstance(t["params"], Mapping) else t
        mu, nu = convert(unwrap(adam["mu"])), convert(unwrap(adam["nu"]))
        step = torch.tensor(float(np.asarray(adam["count"])),
                            dtype=torch.float32)
        out["adam"] = {name: {"step": step.clone(), "exp_avg": mu[name],
                              "exp_avg_sq": nu[name]}
                       for name in out["params"]}
    return out


def load_adam_state(optimizer, named_parameters,
                    adam: Mapping[str, Mapping[str, torch.Tensor]]) -> None:
    """Set a ``torch.optim.Adam`` (or a ``DistributedOptimizer`` over one)
    to the state :func:`params_from_jax_checkpoint` converted, parameter
    by parameter (``named_parameters``: ``model.named_parameters()``)."""
    inner = getattr(optimizer, "optimizer", optimizer)
    for name, p in named_parameters:
        rec = adam[name]
        inner.state[p] = {
            "step": rec["step"].clone(),
            "exp_avg": rec["exp_avg"].to(p.device, p.dtype, copy=True),
            "exp_avg_sq": rec["exp_avg_sq"].to(p.device, p.dtype,
                                               copy=True)}


def params_to_jax(state_dict: Mapping[str, torch.Tensor]
                  ) -> Dict[str, Dict[str, Any]]:
    """The flax variables (``{"params": ..., "batch_stats": ...}``,
    nested dicts of numpy arrays) of a ResNet / MLP / MnistCNN
    ``state_dict`` of the port: the inverse of
    ``models.convert.resnet_params_from_jax`` (OIHW conv kernels back to
    HWIO, the stem's kernel as it is)."""
    out: Dict[str, Dict[str, Any]] = {}
    for name, t in state_dict.items():
        key = name.split(".")
        value = t.detach().cpu().numpy()
        if key[-1] == "kernel" and value.ndim == 4 and \
                key[-2] != "conv_init":
            value = value.transpose(2, 3, 1, 0)              # OIHW -> HWIO
        coll = "batch_stats" if key[-1] in ("mean", "var") else "params"
        node = out.setdefault(coll, {})
        for k in key[:-1]:
            node = node.setdefault(k, {})
        node[key[-1]] = value
    return out
