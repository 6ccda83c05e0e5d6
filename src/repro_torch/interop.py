"""Carry parameter trees and server states across packages as numpy.

The port and the JAX package share a parameter layout (NHWC/HWIO LeNet,
the zoo's nested dicts with ``[n_groups, ...]``-stacked ``groups``, the
same dict keys), so a tree initialised on one side can drive the other:
hand the leaves over as numpy arrays (``np.asarray`` of a JAX array is one)
and build tensors on the wanted device here.  Parameter, cache and server
state trees all carry this way; bfloat16 leaves arrive as bfloat16 and
leave widened to float32, exactly, so a cast back restores their bits.
This module imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.server_opt import ServerState
from repro_torch.tree import tree_map


def _tensor(x, device) -> torch.Tensor:
    a = np.array(x)
    if a.dtype.name == "bfloat16":             # ml_dtypes' numpy bfloat16
        return torch.as_tensor(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.as_tensor(a).to(device)


def tree_from_numpy(tree, device) -> object:
    """A tree of array-likes -> the same tree of tensors on ``device``,
    dtypes kept."""
    return tree_map(lambda x: _tensor(x, device), tree)


def tree_to_numpy(tree) -> object:
    """A tree of tensors -> the same tree of numpy arrays on the host
    (bfloat16 leaves widen to float32, which numpy can hold)."""
    def conv(x):
        if not isinstance(x, torch.Tensor):
            return np.asarray(x)
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.to(torch.float32)
        return x.numpy()
    return tree_map(conv, tree)


def server_state_from_numpy(w, extra, t, device) -> ServerState:
    """Build a ``ServerState`` from numpy (or JAX) leaves: ``w`` and
    ``extra`` trees become float32 tensors on ``device``, ``t`` an int."""
    f32 = lambda tree: tree_map(lambda x: x.to(torch.float32),
                                tree_from_numpy(tree, device))
    return ServerState(w=f32(w), extra=f32(extra), t=int(np.asarray(t)))
