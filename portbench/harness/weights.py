"""Random starting weights made on the device from the seed.

Each leaf is one call of its own ``torch.Generator``, seeded from the run's
weight seed and the leaf's index, so that any one leaf can be drawn again
alone (the correctness check re-draws ``w_0`` a leaf at a time instead of
keeping a copy of the whole model).  A leaf is zeros or
``normal(0, std)``, in fp32, the server state's dtype.  Trees are flat
dicts keyed by path (``groups/b0/attn/wq``); ``nest`` gives the program's
nested layout.
"""
from __future__ import annotations

import math

import torch

_MIX = 0x9E3779B97F4A7C15


def leaf_seed(seed: int, index: int) -> int:
    return ((seed * 1_000_003 + (index + 1) * _MIX) & ((1 << 63) - 1))


def lenet_rule(path: str, shape: tuple):
    if path.startswith("b"):
        return None                                   # biases: zeros
    return 1.0 / math.sqrt(math.prod(shape[:-1]))     # HWIO / [in, out]


def moe_lm_rule(path: str, shape: tuple):
    name = path.split("/")[-1]
    if path in ("final_norm",) or name in ("ln1", "ln2"):
        return None
    if path == "embed":
        return 0.02
    if path == "lm_head":
        return 1.0 / math.sqrt(shape[0])
    per_layer = shape[1:]
    if path.endswith("attn/wo"):
        fan_in = per_layer[0] * per_layer[1]
    elif path.endswith("mlp/router") or "/attn/" in path:
        fan_in = per_layer[0]
    else:                                             # [E, in, out] experts
        fan_in = per_layer[1]
    return 1.0 / math.sqrt(fan_in)


def draw_leaf(shapes: dict, rule, seed: int, path: str,
              device) -> torch.Tensor:
    index = sorted(shapes).index(path)
    shape = tuple(shapes[path])
    std = rule(path, shape)
    if std is None:
        return torch.zeros(shape, dtype=torch.float32, device=device)
    g = torch.Generator(device=device)
    g.manual_seed(leaf_seed(seed, index))
    return torch.randn(shape, generator=g, device=device).mul_(std)


def draw(shapes: dict, rule, seed: int, device) -> dict:
    return {p: draw_leaf(shapes, rule, seed, p, device) for p in shapes}


def nest(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        p = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, p + "/"))
        else:
            out[p] = v
    return out
