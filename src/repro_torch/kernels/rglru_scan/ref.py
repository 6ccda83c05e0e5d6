"""Sequential RG-LRU recurrence h_t = a_t h_{t-1} + b_t: the rglru_scan
kernel's plain version.

The same function as the JAX package's ``kernels/rglru_scan/ref.py``
``rglru_sequential``: one fp32 step a token, the state [B, R] from zero.
Each step is two torch operations (a product, then a sum), two roundings,
as the CUDA kernel rounds them, so on the card the two agree bit for bit.
CPU tensors take it in place of the kernel, and ``chip_smoke.py`` holds the
kernel to it on the card.
"""
from __future__ import annotations

import torch


def rglru_sequential(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a/b [B,S,R] -> h [B,S,R] (fp32 scan)."""
    f32 = torch.float32
    a, b = a.to(f32), b.to(f32)
    B, S, R = a.shape
    h = torch.zeros((B, R), dtype=f32, device=a.device)
    out = torch.empty((B, S, R), dtype=f32, device=a.device)
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out
