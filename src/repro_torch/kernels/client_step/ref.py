"""Plain PyTorch version of the fused client step (gather + H local SGD).

The same function as the JAX package's ``kernels/client_step/ref.py``: H
plain-SGD steps of the linear-regression MSE loss
``mean((x @ w + b - y)^2)`` per client, on minibatch rows gathered from the
client's cache slot of a tier corpus.  A masked step (``step_mask[c, h] ==
0``) freezes ``w`` and ``b`` and drops out of the loss mean, as in
``core.client.local_update``.

The CUDA kernel (``kernel.py``, ``csrc/client_step.cu``) computes the same
steps with hand-fused gradients and sums in another order, so the two agree
within fp32 tolerance, not bit for bit.
"""
from __future__ import annotations

from typing import Optional

import torch


def client_step(xs: torch.Tensor, ys: torch.Tensor, slots: torch.Tensor,
                idx: torch.Tensor, w: torch.Tensor, b: torch.Tensor, lr,
                local_steps: int, batch_size: int,
                step_mask: Optional[torch.Tensor] = None):
    """H local SGD steps per client over slot-gathered minibatches.

    ``xs``: [S, N, D] tier corpus (S cache slots), ``ys``: [S, N];
    ``slots``: [C] cache slot per client; ``idx``: [C, H*b] row indices
    (each ``< n_k <= N``); ``w``: [D] / ``b``: [] start params broadcast to
    every client; ``lr``: the client stepsize; ``step_mask``: optional
    [C, H] {0,1} heterogeneous-H_k masks.

    Returns ``(w_out [C, D], b_out [C], mean_loss [C])``.
    """
    H, bsz = int(local_steps), int(batch_size)
    C, D = slots.shape[0], xs.shape[-1]
    lr = torch.as_tensor(lr, dtype=torch.float32, device=xs.device)
    rows = (slots.long()[:, None], idx.long())
    xb = xs[rows].reshape(C, H, bsz, D)
    yb = ys[rows].reshape(C, H, bsz)
    mask = (torch.ones((C, H), dtype=torch.float32, device=xs.device)
            if step_mask is None else step_mask.to(torch.float32))
    wc = w.to(torch.float32).expand(C, D)
    bc = b.to(torch.float32).expand(C)
    losses = []
    for h in range(H):
        x_h, y_h, active = xb[:, h], yb[:, h], mask[:, h]
        err = (x_h @ wc[:, :, None])[..., 0] + bc[:, None] - y_h   # [C, b]
        loss = torch.mean(torch.square(err), dim=1)
        gw = (2.0 / bsz) * (err[:, None, :] @ x_h)[:, 0]             # [C, D]
        gb = (2.0 / bsz) * torch.sum(err, dim=1)
        on = active > 0
        wc = torch.where(on[:, None], wc - lr * gw, wc)
        bc = torch.where(on, bc - lr * gb, bc)
        losses.append(loss * active)
    mean_loss = (torch.sum(torch.stack(losses, dim=1), dim=1)
                 / torch.clamp(torch.sum(mask, dim=1), min=1.0))
    return wc, bc, mean_loss
