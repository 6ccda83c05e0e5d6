"""Local (client-side) optimizers.

Algorithm 2 of the paper uses plain SGD; momentum and Adam are provided
for ablations.  All are pure (init, update) pairs over parameter trees, so
``core.client.local_update`` can run them under ``torch.func.vmap``.

``lr`` is a float32 0-d tensor.  As in the JAX package, a float32 ``lr``
promotes a bf16 gradient to float32 in the update; the caller rounds the
new parameters back to their own dtype.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Tuple

import torch

from repro_torch.tree import leaves, tree_map


@dataclass(frozen=True)
class LocalOpt:
    name: str
    init: Callable[[Any], Any]                 # params -> opt_state
    update: Callable[[Any, Any, Any, Any], Tuple[Any, Any]]
    # (grads, opt_state, params, lr) -> (updates, opt_state')


def _f32(x):
    return x.to(torch.float32)


def sgd() -> LocalOpt:
    return LocalOpt(
        name="sgd",
        init=lambda params: (),
        update=lambda g, s, p, lr: (tree_map(lambda gi: -lr * _f32(gi), g),
                                    s),
    )


def momentum(beta: float = 0.9, nesterov: bool = False) -> LocalOpt:
    def init(params):
        return tree_map(torch.zeros_like, params)

    def update(g, m, p, lr):
        m = tree_map(lambda mi, gi: beta * mi + gi, m, g)
        if nesterov:
            upd = tree_map(lambda mi, gi: -lr * _f32(beta * mi + gi), m, g)
        else:
            upd = tree_map(lambda mi: -lr * _f32(mi), m)
        return upd, m

    return LocalOpt("momentum", init, update)


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> LocalOpt:
    def init(params):
        z = tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                           device=x.device), params)
        dev = next((x.device for x in leaves(params)), None)
        return {"m": z, "v": tree_map(torch.clone, z),
                "t": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(g, s, p, lr):
        t = s["t"] + 1
        m = tree_map(lambda mi, gi: b1 * mi + (1 - b1) * _f32(gi),
                     s["m"], g)
        v = tree_map(lambda vi, gi: b2 * vi + (1 - b2) * torch.square(
            _f32(gi)), s["v"], g)
        tf = t.to(torch.float32)
        # the bases are filled on the device: no host copy inside a graph
        bc1 = 1 - torch.pow(torch.full((), b1, dtype=torch.float32,
                                       device=tf.device), tf)
        bc2 = 1 - torch.pow(torch.full((), b2, dtype=torch.float32,
                                       device=tf.device), tf)
        upd = tree_map(
            lambda mi, vi, pi: (-lr * (mi / bc1)
                                / (torch.sqrt(vi / bc2) + eps)).to(pi.dtype),
            m, v, p)
        return upd, {"m": m, "v": v, "t": t}

    return LocalOpt("adam", init, update)


def get(name: str, **kw) -> LocalOpt:
    return {"sgd": sgd, "momentum": momentum, "adam": adam}[name](**kw)
