"""Public wrapper for the fused client step: the gather + local-SGD contract.

* INPUT: streaming-cache coordinates, not batches.  A tier's ``[S, N, ...]``
  corpus plus per-client cache ``slots`` and ``idx``, the keyed
  ``minibatch_indices(key, t, cid, n_k, H*b)`` draws every other plane
  makes, so fusion cannot move the trajectory.  No ``[C, H, b, ...]`` batch
  stack is materialized.
* COMPUTE: each client gathers its rows from its own slot and runs H plain
  SGD steps of the linear-regression MSE loss, honouring ``step_mask`` as
  ``core.client.local_update`` does.
* OUTPUT: ``(final_params, per-client mean loss)``, what the per-tier vmap
  of ``core.round.bucketed_round_step`` would have produced.

Dispatch is by where the tensors lie: CUDA tensors go to the hand-written
kernel (``kernel.py``), CPU tensors, and any call with ``use_kernel=False``,
to the plain version (``ref.py``).  There is no fallback: a CUDA input the
kernel cannot take raises.  The reference's ``interpret`` argument names a
Pallas mode and has no counterpart here: where the kernel runs is decided
by the tensors' device.
"""
from __future__ import annotations

import torch

from repro_torch.device import refuse_meta
from repro_torch.kernels.client_step import kernel as _k
from repro_torch.kernels.client_step import ref as _ref


def client_step(xs, ys, slots, idx, w, b, lr, local_steps: int,
                batch_size: int, step_mask=None, use_kernel: bool = True):
    """Fused gather + H local SGD steps over one tier's C clients.

    Array contract of ``ref.client_step``; ``lr`` is a host float.
    ``use_kernel=False`` takes the plain version on any device.
    Returns ``(w_out [C, D], b_out [C], mean_loss [C])``.
    """
    if use_kernel:
        refuse_meta("client_step", xs, ys, w, b)
    if use_kernel and xs.is_cuda:
        return _k.client_step(xs, ys, slots, idx, w, b, lr, local_steps,
                              batch_size, step_mask)
    return _ref.client_step(xs, ys, slots, idx, w, b, lr, local_steps,
                            batch_size, step_mask)


def linreg_tier_step(use_kernel: bool = True):
    """The ``client_step_fn`` hook of ``core.multiround.scan_rounds_bucketed``
    for the linear-regression family: dataset fields ``{'x', 'y'}``, params
    ``{'w': [D], 'b': []}``, fp32 compute and plain-SGD local steps (the
    trainer checks the last two before it wires the hook in).
    ``use_kernel=False`` routes every call to the plain version.

    ``fn(view, tier, cids, idx, w_c, lr, mask, local_steps, batch_size)``:
    ``cids`` [C_i] are the tier's clients, ``idx`` [C_i, H*b] their staged
    keyed minibatch draws (the JAX package's hook draws them itself inside
    its compiled scan; eagerly, one batched host draw per chunk replaces
    hundreds of small device launches per tier and round).  Returns
    ``({'w': [C_i, D], 'b': [C_i]}, losses [C_i])``.
    """
    def fn(view, tier, cids, idx, w_c, lr, mask, local_steps, batch_size):
        arrs = view.tier_arrays[tier]
        if sorted(arrs) != ["x", "y"]:
            raise ValueError(
                "the fused client-step kernel covers the linear-regression "
                f"family (fields {{'x', 'y'}}); got {sorted(arrs)}")
        if not (isinstance(w_c, dict) and sorted(w_c) == ["b", "w"]):
            raise ValueError(
                "the fused client-step kernel needs linreg params "
                "{'w': [D], 'b': []}; got a different parameter tree")
        slots = view.client_slots[torch.as_tensor(cids, device=view.device)
                                  .long()]
        idx = torch.as_tensor(idx, dtype=torch.int32, device=view.device)
        wf, bf, losses = client_step(
            arrs["x"], arrs["y"], slots.to(torch.int32), idx, w_c["w"],
            w_c["b"], lr, local_steps, batch_size, step_mask=mask,
            use_kernel=use_kernel)
        return {"w": wf, "b": bf}, losses

    return fn
