"""Sequential (per-token) RWKV6 recurrence: the rwkv6_scan kernel's plain
version.

The same function as the JAX package's ``kernels/rwkv6_scan/ref.py``
``rwkv6_sequential``: one fp32 step a token,

    o_t = r_t S_{t-1} + (r_t . u . k_t) v_t
    S_t = diag(w_t) S_{t-1} + k_t v_t^T,   w_t = exp(log_w_t)

CPU tensors take it in place of the kernel, and ``chip_smoke.py`` holds the
kernel to it on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def rwkv6_sequential(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     log_w: torch.Tensor, u: torch.Tensor,
                     state: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k [BH,S,Dk], v [BH,S,Dv], log_w [BH,S,Dk], u [BH,Dk].
    Returns (o [BH,S,Dv] in v's dtype, final state [BH,Dk,Dv] fp32)."""
    BH, S, Dk = r.shape
    Dv = v.shape[-1]
    f32 = torch.float32
    s = (torch.zeros((BH, Dk, Dv), dtype=f32, device=r.device)
         if state is None else state.to(f32))
    rf, kf, vf = r.to(f32), k.to(f32), v.to(f32)
    wf = torch.exp(log_w.to(f32))
    uf = u.to(f32)
    outs = []
    for t in range(S):
        rt, kt, vt = rf[:, t], kf[:, t], vf[:, t]
        bonus = torch.sum(rt * uf * kt, -1, keepdim=True) * vt
        outs.append(torch.einsum("bk,bkv->bv", rt, s) + bonus)
        s = wf[:, t, :, None] * s + torch.einsum("bk,bv->bkv", kt, vt)
    o = (torch.stack(outs, dim=1) if outs
         else torch.zeros((BH, 0, Dv), dtype=f32, device=r.device))
    return o.to(v.dtype), s
