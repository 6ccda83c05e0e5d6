"""MoE routing by index in plain PyTorch: the moe_route kernels' plain
version.

The same three functions as ``csrc/moe_route.cu``, over N independent
groups, with the same tables (``slot`` [N, G, k] int32, ``owner`` [N, S]
int32; see the note in the ``.cu`` file) and the same roundings in the
same order: each product and each sum rounded once in fp32, ``sum_rows``
adding a token's kept routes in ascending slot order, ``route_dots`` each
lane's vectors in order and then the warp's 32 partial sums by halves.
So on the card the two agree bit for bit.  CPU tensors take it in place
of the kernels, and ``chip_smoke.py`` times it beside them.
"""
from __future__ import annotations

from typing import Optional

import torch

LANES = 32                    # a warp: the kernels' lanes a row


def vec_width(D: int, dtype: torch.dtype) -> int:
    """The elements a lane loads at once: a 16-byte vector where D is a
    multiple of one, else 1.  It fixes ``route_dots``' summation order."""
    v = 16 // torch.empty((), dtype=dtype).element_size()
    return v if D % v == 0 else 1


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The accumulation dtype: fp32 for fp32 and bf16 rows, as the kernels
    accumulate (float64 rows, which only the CPU takes, keep float64)."""
    return torch.promote_types(dtype, torch.float32)


def _rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """src [N, R, D] at idx [N, M] (clamped into range) -> [N, M, D]."""
    idx = idx.clamp(min=0).long()
    return torch.gather(src, 1, idx[..., None].expand(-1, -1, src.shape[2]))


def gather_rows(src: torch.Tensor, owner: torch.Tensor,
                w: Optional[torch.Tensor], k: int) -> torch.Tensor:
    """src [N, G, D], owner [N, S], w [N, G, k] or None -> [N, S, D]:
    ``w[owner] * src[owner // k]``, zero where ``owner < 0``."""
    rows = _rows(src, torch.div(owner, k, rounding_mode="floor"))
    if w is not None:
        scale = torch.gather(w.reshape(w.shape[0], -1), 1,
                             owner.clamp(min=0).long())
        acc = _acc(src.dtype)
        rows = (rows.to(acc) * scale.to(acc)[..., None]).to(src.dtype)
    return torch.where((owner >= 0)[..., None], rows,
                       torch.zeros((), dtype=src.dtype, device=src.device))


def sum_rows(src: torch.Tensor, slot: torch.Tensor,
             w: Optional[torch.Tensor]) -> torch.Tensor:
    """src [N, S, D], slot [N, G, k], w [N, G, k] or None -> [N, G, D]:
    the sum over kept routes of ``w * src[slot]``, in ascending slot order
    from fp32 zero, rounded once to src's dtype."""
    dt = _acc(src.dtype)
    order = torch.argsort(slot, dim=-1, stable=True)   # dropped (-1) first
    slot = torch.gather(slot, -1, order)
    if w is not None:
        w = torch.gather(w, -1, order).to(dt)
    N, G, k = slot.shape
    acc = torch.zeros((N, G, src.shape[2]), dtype=dt, device=src.device)
    for j in range(k):
        term = _rows(src, slot[..., j]).to(dt)
        if w is not None:
            term = term * w[..., j, None]
        acc = acc + torch.where((slot[..., j] >= 0)[..., None], term, 0.0)
    return acc.to(src.dtype)


def route_dots(a: torch.Tensor, b: torch.Tensor,
               slot: torch.Tensor) -> torch.Tensor:
    """a [N, G, D], b [N, S, D], slot [N, G, k] -> [N, G, k] in a's dtype:
    ``<a[g], b[slot[g, j]]>``, 0 where dropped.  Vector c of a row (V
    elements, ``vec_width``) belongs to lane c % 32, which adds its
    products in order; the 32 partial sums are then added by halves."""
    N, G, k = slot.shape
    D = a.shape[2]
    V = vec_width(D, a.dtype)
    width = LANES * V
    pad = -D % width
    dt = _acc(a.dtype)
    bs = _rows(b, slot.reshape(N, G * k)).reshape(N, G, k, D).to(dt)
    af = a.to(dt)[:, :, None, :]
    if pad:
        bs = torch.nn.functional.pad(bs, (0, pad))
        af = torch.nn.functional.pad(af, (0, pad))
    chunks = (D + pad) // width
    bs = bs.reshape(N, G, k, chunks, LANES, V)
    af = af.reshape(N, G, 1, chunks, LANES, V)
    acc = torch.zeros((N, G, k, LANES), dtype=dt, device=a.device)
    for c in range(chunks):
        for e in range(V):
            acc = acc + af[..., c, :, e] * bs[..., c, :, e]
    while acc.shape[-1] > 1:
        h = acc.shape[-1] // 2
        acc = acc[..., :h] + acc[..., h:]
    return torch.where(slot >= 0, acc[..., 0], 0.0).to(a.dtype)
