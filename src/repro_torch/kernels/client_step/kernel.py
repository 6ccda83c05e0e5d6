"""The fused client step on the card: binding and launch of
``csrc/client_step.cu``.

Hopper port of the JAX package's Pallas kernel
(``repro/kernels/client_step/kernel.py:75`` ``client_step_flat``).  The TPU
kernel pads D to 128 lanes and N to 8 sublanes and copies each client's
whole ``[N, D]`` slot into VMEM; this one takes any D up to 1,024 and any N
unpadded, and gathers only the H*b rows each client uses (see the note in
the ``.cu`` file for the bound and the design).

``launches`` counts kernel launches (one per call of ``client_step``, one
per occupied size tier and round on the bucketed streaming plane).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build

launches = 0


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("client_step")
    lib.client_step_launch.argtypes = [ctypes.c_void_p] * 10 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    lib.client_step_launch.restype = ctypes.c_int
    lib.client_step_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.client_step_smem_bytes.restype = ctypes.c_longlong
    lib.client_step_smem_limit.argtypes = [ctypes.c_int]
    lib.client_step_smem_limit.restype = ctypes.c_int
    lib.client_step_max_features.argtypes = []
    lib.client_step_max_features.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _smem_limit(device_index: int) -> int:
    limit = _lib().client_step_smem_limit(device_index)
    if limit < 0:
        raise RuntimeError(f"client_step: cannot read the shared-memory limit "
                           f"of cuda:{device_index}")
    return limit


def _check(name, x, dtype, shape, like):
    if not x.is_cuda:
        raise ValueError(f"client_step: {name} is on {x.device}, the kernel "
                         f"takes CUDA tensors only")
    if x.device != like.device:
        raise ValueError(f"client_step: {name} is on {x.device} but xs is on "
                         f"{like.device}")
    if x.dtype != dtype:
        raise ValueError(f"client_step: {name} is {x.dtype}, the kernel "
                         f"takes {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"client_step: {name} has shape {tuple(x.shape)}, "
                         f"want {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"client_step: {name} must be contiguous")


def client_step(xs: torch.Tensor, ys: torch.Tensor, slots: torch.Tensor,
                idx: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                lr: float, local_steps: int, batch_size: int,
                step_mask: Optional[torch.Tensor] = None):
    """One launch over a tier's C clients, on CUDA tensors.

    ``xs`` [S, N, D] / ``ys`` [S, N] float32; ``slots`` [C] / ``idx``
    [C, H*b] int32; ``w`` [D] / ``b`` [] float32 (device pointers: nothing
    is read back to the host); ``lr`` a host float; ``step_mask`` optional
    [C, H] float32.  Returns ``(w_out [C, D], b_out [C], mean_loss [C])``.
    Slot and row ids out of range stop the kernel with a device-side
    assert; everything else the kernel cannot take raises here.
    """
    global launches
    H, B = int(local_steps), int(batch_size)
    if H < 1 or B < 1:
        raise ValueError(f"client_step: local_steps and batch_size must be "
                         f">= 1, got {H}, {B}")
    if xs.dim() != 3:
        raise ValueError(f"client_step: xs must be [S, N, D], got shape "
                         f"{tuple(xs.shape)}")
    S, N, D = xs.shape
    C = slots.shape[0] if slots.dim() == 1 else -1
    _check("xs", xs, torch.float32, (S, N, D), xs)
    _check("ys", ys, torch.float32, (S, N), xs)
    _check("slots", slots, torch.int32, (C,), xs)
    _check("idx", idx, torch.int32, (C, H * B), xs)
    _check("w", w, torch.float32, (D,), xs)
    _check("b", b, torch.float32, (), xs)
    if step_mask is not None:
        _check("step_mask", step_mask, torch.float32, (C, H), xs)
    lib = _lib()
    if D > lib.client_step_max_features():
        raise ValueError(f"client_step: D={D} features, the kernel takes at "
                         f"most {lib.client_step_max_features()}")
    smem = lib.client_step_smem_bytes(D, B)
    limit = _smem_limit(xs.device.index)
    if smem > limit:
        raise ValueError(f"client_step: a block needs {smem} B of shared "
                         f"memory for b={B}, D={D}; the card allows {limit}")
    w_out = torch.empty((C, D), dtype=torch.float32, device=xs.device)
    b_out = torch.empty((C,), dtype=torch.float32, device=xs.device)
    loss = torch.empty((C,), dtype=torch.float32, device=xs.device)
    if C == 0:
        return w_out, b_out, loss
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        err = lib.client_step_launch(
            xs.data_ptr(), ys.data_ptr(), slots.data_ptr(), idx.data_ptr(),
            w.data_ptr(), b.data_ptr(),
            None if step_mask is None else step_mask.data_ptr(),
            w_out.data_ptr(), b_out.data_ptr(), loss.data_ptr(), S, N, D, C,
            H, B, float(lr), stream)
    if err != 0:
        raise RuntimeError(f"client_step launch failed: cudaError {err}")
    launches += 1
    return w_out, b_out, loss
