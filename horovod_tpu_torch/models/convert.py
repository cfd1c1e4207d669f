"""Flax GPT-2 / BERT parameters → the port's parameters.

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
transposes.
"""

from __future__ import annotations

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
