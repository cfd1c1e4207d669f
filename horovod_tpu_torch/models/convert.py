"""Flax parameters → the port's parameters.

``params_from_jax`` takes the JAX package's ``models.Transformer`` param
tree, as nested dicts of numpy arrays (``jax.device_get`` of the flax
tree, or the tree itself: leaves go through ``numpy.asarray``), and
returns the port's ``state_dict`` for ``models.transformer.Transformer``
(GPT-2 and BERT share the module and its names).
Both flax layouts are accepted: unrolled ``block_i`` and the stacked
``blocks/block`` layout of ``scan_layers=True`` (unstacked here by this
module's own copy of ``unstack_block_params``,
``horovod_tpu/models/transformer.py:296``).  The port keeps the flax
leaf layouts (qkv kernel [d, 3, H, Dh], proj kernel [H, Dh, d], dense
kernels [in, out], tied ``wte``), so conversion renames and never
transposes.  ``shard_experts`` slices the global expert weights of such
a state dict (an MoE model's ``moe_w_in`` / ``moe_w_out``, [E, ...]) to
one rank's experts on the expert axis, the port's counterpart of JAX's
``in_specs=P("ep")`` on those leaves.

``resnet_params_from_jax`` takes the ``{"params", "batch_stats"}``
variables of the JAX package's ``ResNet`` (or the ``params`` of its
``MLP`` / ``MnistCNN``) and returns the state dict of
``models.resnet.ResNet`` (``models.mlp``), parameters and running
statistics: HWIO conv kernels become OIHW, the stem's (7, 7, C, F)
kernel and the (in, out) Dense kernels keep their layout.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()
             ) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v)
    return out


def unstack_block_params(flat: Dict[Tuple[str, ...], np.ndarray]
                         ) -> Dict[Tuple[str, ...], np.ndarray]:
    """``scan_layers`` layout (``blocks/block/...`` leaves stacked on a
    leading layer axis) → unrolled ``block_i/...`` leaves; other entries
    pass through."""
    out = {}
    for k, v in flat.items():
        if k[:2] == ("blocks", "block"):
            for i in range(v.shape[0]):
                out[(f"block_{i}",) + k[2:]] = v[i]
        else:
            out[k] = v
    return out


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """The port's ``Transformer`` state dict (CPU tensors) from a flax
    GPT-2 or BERT param tree; a ``{"params": ...}`` wrapper is
    unwrapped."""
    if "params" in tree and isinstance(tree["params"], Mapping):
        tree = tree["params"]
    flat = unstack_block_params(_flatten(tree))
    state = {}
    for key, value in flat.items():
        if key[0].startswith("block_"):
            key = ("blocks", key[0][len("block_"):]) + key[1:]
        state[".".join(key)] = torch.from_numpy(np.array(value))
    return state


EXPERT_LEAVES = ("moe_w_in", "moe_w_out")


def shard_experts(state: Mapping[str, torch.Tensor], axis_name: str = "ep",
                  *, mesh=None) -> Dict[str, torch.Tensor]:
    """``state`` with each expert weight (a key ending in
    ``EXPERT_LEAVES``, [E, ...]) cut to this rank's E / n experts: the
    block of its index on ``axis_name`` (``parallel.axis``), of size n.
    Other entries pass through."""
    from .. import parallel
    ax = parallel.axis(axis_name, mesh)
    n, index = ax.size, ax.index
    out = {}
    for key, value in state.items():
        if key.endswith(EXPERT_LEAVES):
            if value.shape[0] % n:
                raise ValueError(f"{key}: {value.shape[0]} experts do not "
                                 f"divide over {n} ranks of "
                                 f"{axis_name!r}")
            e = value.shape[0] // n
            value = value[index * e:(index + 1) * e]
        out[key] = value
    return out


# The flax module names of the ResNet, MLP and MnistCNN trees, and the
# leaves each holds.
_RESNET_MODULE = re.compile(
    r"(conv_init|bn_init|BottleneckBlock_\d+|Conv_\d+|BatchNorm_\d+|"
    r"conv_proj|norm_proj|Dense_\d+)$")
_RESNET_LEAVES = {"params": ("kernel", "bias", "scale"),
                  "batch_stats": ("mean", "var")}


def resnet_params_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The port's state dict (CPU tensors) from flax ResNet variables
    ``{"params", "batch_stats"}`` (or MLP / MnistCNN ``{"params"}``), as
    nested dicts of arrays.  Every leaf is mapped exactly once; a name
    the models do not have raises ``KeyError``."""
    state = {}
    for collection, tree in variables.items():
        if collection not in _RESNET_LEAVES:
            raise KeyError(f"unknown variable collection {collection!r}")
        for key, value in _flatten(tree).items():
            if key[-1] not in _RESNET_LEAVES[collection] or not all(
                    _RESNET_MODULE.match(m) for m in key[:-1]):
                raise KeyError(f"{collection}/{'/'.join(key)} is no "
                               f"ResNet, MLP or MnistCNN leaf")
            if key[-1] == "kernel" and value.ndim == 4 \
                    and key[-2] != "conv_init":
                value = value.transpose(3, 2, 0, 1)          # HWIO -> OIHW
            name = ".".join(key)
            if name in state:
                raise KeyError(f"{name} appears twice")
            state[name] = torch.from_numpy(np.array(value, np.float32))
    return state


def mlp_params_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's ``MLP`` state dict (CPU tensors) from the ``params`` of
    the JAX package's ``MLP`` (``Dense_i`` kernels [in, out] and biases,
    kept as they are) — what ``serve.MLPAdapter`` serves."""
    return resnet_params_from_jax({"params": params})
