"""Client-side local solver — Algorithm 2 of the paper.

``local_update`` receives the broadcast server model ``w_t`` and a stack of
``H`` minibatches (one per local iteration, matching Alg. 2's fresh sample
per step), runs H optimizer steps, and returns the updated local model
``w^k_{t+1}`` plus the mean loss.  It is written for one client; the round
engine batches clients with ``torch.func.vmap``.
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

import torch
from torch.func import grad_and_value

from repro_torch.optim.local import LocalOpt, sgd
from repro_torch.tree import leaves, tree_map

LossFn = Callable[[Any, Any], Tuple[torch.Tensor, Any]]  # (params, batch)


def local_update(loss_fn: LossFn, params: Any, batches: Any,
                 lr: torch.Tensor, opt: LocalOpt = None,
                 step_mask: torch.Tensor = None):
    """Run H local steps.  ``batches`` leaves have leading axis H.

    ``step_mask``: optional [H] {0,1} — heterogeneous H_k support.  A masked
    step freezes both the parameters and the local optimizer state, so a
    client with mask [1,1,0,...,0] produces *exactly* the model it would
    after H_k=2 steps of the unmasked loop (stragglers / partial work).
    Masked-step losses are excluded from the mean.

    Returns (params', mean_loss).
    """
    opt = opt or sgd()
    state = opt.init(params)
    grad_fn = grad_and_value(lambda p, b: loss_fn(p, b)[0])
    n_steps = leaves(batches)[0].shape[0]
    losses = []
    for h in range(n_steps):
        batch = tree_map(lambda x: x[h], batches)
        g, loss = grad_fn(params, batch)
        upd, new_state = opt.update(g, state, params, lr)
        del g          # a model-sized tree a client: free it before the sum
        new_params = tree_map(lambda pi, ui: (pi + ui).to(pi.dtype),
                              params, upd)
        del upd        # and this one before the next step's grads
        if step_mask is None:
            params, state = new_params, new_state
            losses.append(loss)
            continue
        active = step_mask[h]
        keep = active != 0
        params = tree_map(lambda n, o: torch.where(keep, n, o),
                          new_params, params)
        state = tree_map(lambda n, o: torch.where(keep, n, o),
                         new_state, state)
        losses.append(loss * active.to(loss.dtype))
    losses = torch.stack(losses)
    if step_mask is None:
        return params, torch.mean(losses)
    active = step_mask.to(torch.float32)
    return params, torch.sum(losses) / torch.clamp(torch.sum(active),
                                                    min=1.0)


def local_gradient(loss_fn: LossFn, params: Any, batch: Any):
    """Single gradient (FedSGD-style probing)."""
    return grad_and_value(lambda p: loss_fn(p, batch)[0])(params)
