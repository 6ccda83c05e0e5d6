"""Public wrapper: a MoE group's tokens moved into their experts' slots and
back by index.

``route_tables`` turns routes (``layers.moe_routes``) into the two index
tables; ``gather_rows``, ``sum_rows`` and ``route_dots`` are the three
moves over N groups at once (see the note in ``csrc/moe_route.cu``).
Together they compute what the JAX package's dense products
``gec,gd->ecd`` and ``gec,ecd->gd`` (and their gradients) compute, with
none of the products by 0 and 1.  ``layers._MoEGroup`` calls them, in its
forward and its hand-written backward.

Dispatch is by where the tensors lie: CUDA tensors go to the hand-written
kernels (``kernel.py``), CPU tensors to the plain version (``ref.py``),
meta tensors to shape rules (the dry run: the moves do none of the
products ``FlopCounterMode`` counts).  There is no fallback: a CUDA input
the kernels cannot take raises.  The three take plain tensors: they have
no autograd and no ``vmap`` rule of their own.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.moe_route import kernel as _k
from repro_torch.kernels.moe_route import ref as _ref


def route_tables(gate_idx: torch.Tensor, pos: torch.Tensor,
                 keep: torch.Tensor, cap: int, n_experts: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routes [..., G, k] -> (slot [..., G, k] int32: ``e * cap + pos``, -1
    where dropped; owner [..., E * cap] int32: the route ``g * k + j``
    holding each slot, -1 where empty).  Kept slots are distinct, and each
    dropped route writes a dump entry of its own past the slots, so the
    inverse is one scatter with distinct targets: no atomics, no host
    sync, no shape that depends on the data."""
    lead, (G, k) = gate_idx.shape[:-2], gate_idx.shape[-2:]
    S = n_experts * cap
    route = torch.arange(G * k, device=gate_idx.device).reshape(G, k)
    target = torch.where(keep, gate_idx * cap + pos.long(), S + route)
    owner = torch.full((*lead, S + G * k), -1, dtype=torch.long,
                       device=gate_idx.device)
    owner = owner.scatter(-1, target.reshape(*lead, G * k),
                          route.reshape(G * k).expand(*lead, G * k))
    slot = torch.where(keep, target, -1)
    return slot.to(torch.int32), owner[..., :S].to(torch.int32)


def _ready(x):
    """Contiguous and 16-byte aligned, as the kernels load rows."""
    if x is None:
        return None
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def gather_rows(src: torch.Tensor, owner: torch.Tensor,
                w: Optional[torch.Tensor], k: int) -> torch.Tensor:
    """src [N, G, D], owner [N, S], w [N, G, k] or None -> [N, S, D]:
    ``w[owner] * src[owner // k]``, zero where a slot is empty."""
    if src.device.type == "meta":
        return src.new_empty((src.shape[0], owner.shape[1], src.shape[2]))
    if src.is_cuda:
        return _k.gather_rows(_ready(src), owner.contiguous(), _ready(w), k)
    return _ref.gather_rows(src, owner, w, k)


def sum_rows(src: torch.Tensor, slot: torch.Tensor,
             w: Optional[torch.Tensor]) -> torch.Tensor:
    """src [N, S, D], slot [N, G, k], w [N, G, k] or None -> [N, G, D]:
    each token's kept ``w * src[slot]``, in ascending slot order in
    fp32."""
    if src.device.type == "meta":
        return src.new_empty((src.shape[0], slot.shape[1], src.shape[2]))
    if src.is_cuda:
        return _k.sum_rows(_ready(src), slot.contiguous(), _ready(w))
    return _ref.sum_rows(src, slot, w)


def route_dots(a: torch.Tensor, b: torch.Tensor,
               slot: torch.Tensor) -> torch.Tensor:
    """a [N, G, D], b [N, S, D], slot [N, G, k] -> [N, G, k]:
    ``<a[g], b[slot[g, j]]>``, 0 where dropped."""
    if a.device.type == "meta":
        return a.new_empty(slot.shape)
    if a.is_cuda:
        return _k.route_dots(_ready(a), _ready(b), slot.contiguous())
    return _ref.route_dots(a, b, slot)
