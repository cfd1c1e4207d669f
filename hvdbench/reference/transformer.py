"""GPT-2 / BERT as the configuration files write them, in f32.

Parameters come as ``{name: tensor}`` in the port's flax layouts
(``hvdbench/weights.py``): ``attn.qkv.kernel`` [d, 3, H, Dh],
``attn.proj.kernel`` [H, Dh, d], ``fc1``/``fc2`` [in, out], the LM head
tied to ``wte.embedding``.  Pre-LN blocks, tanh GELU, softmax attention
(causal for GPT-2), a final LayerNorm.  Every product goes through
``prod.mm`` (``reference/products.py``).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch.nn import functional as F

from .products import Products


def layer_norm(x, scale, bias, eps: float):
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * scale + bias


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(
        math.sqrt(2.0 / math.pi) * (x + 0.044715 * x * x * x)))


def hidden(P: Dict[str, torch.Tensor], model: dict, ids: torch.Tensor,
           prod: Products) -> torch.Tensor:
    """The last block's output [B, S, d] for token ids [B, S]."""
    B, S = ids.shape
    d, H = model["d_model"], model["num_heads"]
    Dh, eps = d // H, model["block_ln_eps"]
    x = P["wte.embedding"][ids] + P["wpe.embedding"][:S][None]
    keep = None
    if model["causal"]:
        keep = torch.ones((S, S), dtype=torch.bool, device=ids.device).tril()
    for i in range(model["num_layers"]):
        b = f"blocks.{i}."
        h = layer_norm(x, P[b + "ln1.scale"], P[b + "ln1.bias"], eps)
        qkv = prod.mm(h, P[b + "attn.qkv.kernel"].reshape(d, 3 * d)) \
            + P[b + "attn.qkv.bias"].reshape(3 * d)
        q, k, v = qkv.view(B, S, 3, H, Dh).permute(2, 0, 3, 1, 4)
        s = prod.mm(q, k.transpose(-1, -2)) / math.sqrt(Dh)
        if keep is not None:
            s = s.masked_fill(~keep, float("-inf"))
        a = prod.mm(torch.softmax(s, dim=-1), v)            # [B, H, S, Dh]
        a = a.permute(0, 2, 1, 3).reshape(B, S, d)
        x = x + prod.mm(a, P[b + "attn.proj.kernel"].reshape(d, d)) \
            + P[b + "attn.proj.bias"]
        h = layer_norm(x, P[b + "ln2.scale"], P[b + "ln2.bias"], eps)
        h = gelu_tanh(prod.mm(h, P[b + "fc1.kernel"]) + P[b + "fc1.bias"])
        x = x + prod.mm(h, P[b + "fc2.kernel"]) + P[b + "fc2.bias"]
    return x


def loss_sum(P: Dict[str, torch.Tensor], model: dict, task: str,
             batch: Dict[str, torch.Tensor], prod: Products
             ) -> Tuple[torch.Tensor, int]:
    """(sum of the token cross-entropies, number of tokens predicted)
    over the rows of ``batch``."""
    head = P["wte.embedding"].t()
    eps = model["final_ln_eps"]
    if task == "causal_lm":
        tokens = batch["tokens"]
        x = hidden(P, model, tokens, prod)
        h = layer_norm(x[:, :-1], P["ln_f.scale"], P["ln_f.bias"], eps)
        logits = prod.mm(h, head)
        targets = tokens[:, 1:]
    elif task == "masked_lm":
        x = hidden(P, model, batch["inputs"], prod)
        pos = batch["positions"]
        x = torch.gather(x, 1, pos[..., None].expand(-1, -1, x.shape[-1]))
        h = layer_norm(x, P["ln_f.scale"], P["ln_f.bias"], eps)
        logits = prod.mm(h, head)
        targets = batch["labels"]
    else:
        raise ValueError(f"unknown task {task!r}")
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         targets.reshape(-1), reduction="sum")
    return ce, targets.numel()
