"""Plain PyTorch versions of the fused server updates (FedMom + FedAvgM).

The CUDA kernel (``kernel.py``, ``csrc/fedmom_update.cu``) computes the same
functions.  Each line here is one elementwise operation in float32, in the
order the kernel rounds them, so on the card the kernel agrees with this
version bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.tree import leaves, unflatten_like


def fedmom_flat(w, v, delta, eta: float, beta: float):
    """(w', v') per Algorithm 3 steps 8-9 on float32 tensors."""
    v_new = w - eta * delta
    w_new = v_new + beta * (v_new - v)
    return w_new, v_new


def fedavgm_flat(w, m, delta, eta: float, beta: float):
    """(w', m') for the heavy-ball server update on float32 tensors."""
    m_new = beta * m + delta
    w_new = w - eta * m_new
    return w_new, m_new


def _tree(flat_fn, w, s, delta, eta, beta):
    lw, ls, ld = leaves(w), leaves(s), leaves(delta)
    f32 = lambda x: x.to(torch.float32)
    pairs = [flat_fn(f32(a), f32(b), f32(c), eta, beta)
             for a, b, c in zip(lw, ls, ld)]
    return (unflatten_like(w, [p[0] for p in pairs]),
            unflatten_like(w, [p[1] for p in pairs]))


def fedmom_update(w, v, delta, eta: float, beta: float):
    """Returns (w', v') over parameter trees, float32 leaves."""
    return _tree(fedmom_flat, w, v, delta, eta, beta)


def fedavgm_update(w, m, delta, eta: float, beta: float):
    """Returns (w', m') over parameter trees, float32 leaves."""
    return _tree(fedavgm_flat, w, m, delta, eta, beta)
