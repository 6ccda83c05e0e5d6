"""The RG-LRU linear recurrence on the card: binding and launch of
``csrc/rglru_scan.cu``.

Hopper port of the JAX package's Pallas kernel
(``repro/kernels/rglru_scan/kernel.py:50`` ``rglru_bsr``).  The TPU kernel
grids over (batch, chunk) and carries the [R] state across its sequential
chunk axis; this one gives every (batch, channel) a thread that walks the
whole sequence with the state in a register (see the note in the ``.cu``
file for the bound and the design).

``launches`` counts kernel launches (one per call).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

launches = 0


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("rglru_scan").rglru_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def rglru(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One launch: a/b [B,S,R] fp32 contiguous CUDA tensors -> h [B,S,R]
    fp32.  Raises on anything else."""
    global launches
    if a.dim() != 3:
        raise ValueError(f"rglru_scan: want a [B,S,R], got {tuple(a.shape)}")
    for name, x in (("a", a), ("b", b)):
        if not x.is_cuda:
            raise ValueError(f"rglru_scan: {name} is on {x.device}, the "
                             f"kernel takes CUDA tensors only")
        if x.device != a.device:
            raise ValueError(f"rglru_scan: {name} is on {x.device} but a is "
                             f"on {a.device}")
        if x.dtype != torch.float32:
            raise ValueError(f"rglru_scan: {name} is {x.dtype}, the kernel "
                             f"takes torch.float32")
        if tuple(x.shape) != tuple(a.shape):
            raise ValueError(f"rglru_scan: {name} has shape "
                             f"{tuple(x.shape)}, want {tuple(a.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"rglru_scan: {name} must be contiguous")
    B, S, R = a.shape
    if min(B, S, R) < 1 or B > 65535:
        raise ValueError(f"rglru_scan: shape {tuple(a.shape)}; the kernel "
                         f"takes 1 <= B <= 65535 and S, R >= 1")
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _entry()(a.data_ptr(), b.data_ptr(), out.data_ptr(), B, S, R,
                       stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan launch failed: cudaError {err}")
    launches += 1
    return out
