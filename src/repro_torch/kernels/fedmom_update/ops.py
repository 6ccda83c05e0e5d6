"""Public wrapper for the fused FedMom / FedAvgM server update.

Dispatch is by where the tensors lie: CUDA tensors go to the hand-written
kernel (``kernel.py``), CPU tensors, and any call with ``use_kernel=False``,
to the plain version (``ref.py``).  There is no fallback — a CUDA tree that
the kernel cannot take raises, and a tree whose leaves lie on different
devices raises.  Outputs follow the input leaves' dtypes on both paths.
The reference's ``interpret`` argument names a Pallas mode and has no
counterpart here: where the kernel runs is decided by the leaves' device.
"""
from __future__ import annotations

from repro_torch.device import refuse_meta
from repro_torch.kernels.fedmom_update import kernel as _k
from repro_torch.kernels.fedmom_update import ref as _ref
from repro_torch.tree import leaves, tree_map, unflatten_like


def _on_cuda(*leaf_lists) -> bool:
    devices = {x.device for xs in leaf_lists for x in xs}
    if len(devices) > 1:
        raise ValueError(f"fedmom_update: leaves on several devices "
                         f"{sorted(map(str, devices))}")
    return bool(devices) and next(iter(devices)).type == "cuda"


def _as_dtypes(tree, like):
    return tree_map(lambda x, l: x.to(l.dtype), tree, like)


def _update(ref_fn, kind, w, s, delta, eta, beta, use_kernel):
    lw, ls, ld = leaves(w), leaves(s), leaves(delta)
    on_cuda = _on_cuda(lw, ls, ld)
    if use_kernel:
        refuse_meta("fedmom_update", *lw, *ls, *ld)
    if on_cuda and use_kernel:
        # the trees are flattened once, here, for the check and the launch
        w_new, s_new = _k.update_leaves(lw, ls, ld, eta=eta, beta=beta,
                                        kind=kind)
        return unflatten_like(w, w_new), unflatten_like(s, s_new)
    w_new, s_new = ref_fn(w, s, delta, eta, beta)
    return _as_dtypes(w_new, w), _as_dtypes(s_new, s)


def fused_update_tree(w, v, delta, *, eta: float, beta: float,
                      use_kernel: bool = True):
    """FedMom (Nesterov): one fused launch over the whole parameter tree
    (``use_kernel=False``: the plain version on any device)."""
    return _update(_ref.fedmom_update, "fedmom", w, v, delta, eta, beta,
                   use_kernel)


def fused_avgm_tree(w, m, delta, *, eta: float, beta: float,
                    use_kernel: bool = True):
    """FedAvgM (heavy-ball): same fused stream, different update body."""
    return _update(_ref.fedavgm_update, "fedavgm", w, m, delta, eta, beta,
                   use_kernel)
