"""Plain PyTorch dense attention: the flash kernel's plain version.

The same function as the JAX package's ``kernels/flash_attention/ref.py``:
the full fp32 score matrix, masked, softmaxed, times V, cast to the input
dtype.  CPU tensors take it in place of the kernel, and ``chip_smoke.py``
holds the kernel to it on the card.
"""
from __future__ import annotations

import math

import torch


def attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: int = 0) -> torch.Tensor:
    """q [BH,S,d], k/v [BH,T,d] -> [BH,S,d] (fp32 math)."""
    S, T = q.shape[1], k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.to(torch.float32),
                     k.to(torch.float32)) / math.sqrt(q.shape[-1])
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window > 0:
        mask = mask & (kpos > qpos - window)
    s = s.masked_fill(~mask[None], -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p,
                        v.to(torch.float32)).to(q.dtype)
