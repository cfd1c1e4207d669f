"""The model's parameters, in the port's flax layouts, made from the seed.

Both sides get the same tensors: the program copies them into its
modules, the reference computes on them.  They are drawn on the device
in four calls into one flat f32 buffer ordered by how each parameter is
initialised (GPT-2 / BERT: normal(0.02) kernels and token embedding,
normal(0.01) position embedding, zero biases, unit LayerNorm scales),
and each parameter is a view of its slice.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Tuple

from . import seeds


def layout(model: dict) -> "OrderedDict[str, Tuple[int, ...]]":
    """Each parameter's name and shape, in the port's module order."""
    V, L, H = model["vocab_size"], model["num_layers"], model["num_heads"]
    d, f, n_pos = model["d_model"], model["d_ff"], model["max_len"]
    Dh = d // H
    out = OrderedDict()
    out["wte.embedding"] = (V, d)
    out["wpe.embedding"] = (n_pos, d)
    for i in range(L):
        b = f"blocks.{i}."
        out[b + "ln1.scale"] = (d,)
        out[b + "ln1.bias"] = (d,)
        out[b + "attn.qkv.kernel"] = (d, 3, H, Dh)
        out[b + "attn.qkv.bias"] = (3, H, Dh)
        out[b + "attn.proj.kernel"] = (H, Dh, d)
        out[b + "attn.proj.bias"] = (d,)
        out[b + "ln2.scale"] = (d,)
        out[b + "ln2.bias"] = (d,)
        out[b + "fc1.kernel"] = (d, f)
        out[b + "fc1.bias"] = (f,)
        out[b + "fc2.kernel"] = (f, d)
        out[b + "fc2.bias"] = (d,)
    out["ln_f.scale"] = (d,)
    out["ln_f.bias"] = (d,)
    return out


def _group(name: str) -> int:
    if name == "wpe.embedding":
        return 1
    if name.endswith(("kernel", "embedding")):
        return 0
    if name.endswith("bias"):
        return 2
    return 3  # LayerNorm scale


def numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def make(config: dict, seed: int, device) -> Dict[str, "object"]:
    """``{name: f32 tensor}`` on ``device``, views of one flat buffer."""
    import torch
    model, init = config["model"], config["init"]
    if init["token_embedding_std"] != init["kernel_std"]:
        raise ValueError("the token embedding is drawn with the kernels: "
                         "token_embedding_std must equal kernel_std")
    lay = layout(model)
    order = sorted(lay, key=_group)  # stable: module order inside a group
    sizes = {g: sum(numel(lay[n]) for n in order if _group(n) == g)
             for g in range(4)}
    flat = torch.empty(sum(sizes.values()), dtype=torch.float32,
                       device=device)
    gen = seeds.generator(device, seed, seeds.WEIGHTS)
    a = sizes[0]
    b = a + sizes[1]
    c = b + sizes[2]
    flat[:a].normal_(0.0, init["kernel_std"], generator=gen)
    flat[a:b].normal_(0.0, init["position_embedding_std"], generator=gen)
    flat[b:c].zero_()
    flat[c:].fill_(1.0)
    out, at = {}, 0
    for name in order:
        n = numel(lay[name])
        out[name] = flat[at:at + n].view(lay[name])
        at += n
    return {name: out[name] for name in lay}
