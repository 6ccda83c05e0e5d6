"""The RWKV6 time-mix recurrence on the card: binding and launch of
``csrc/rwkv6_scan.cu``.

Hopper port of the JAX package's Pallas kernel
(``repro/kernels/rwkv6_scan/kernel.py:81`` ``rwkv6_bhsd``).  It takes the
model's layout, r/k/log_w [B, S, H, Dk], v [B, S, H, Dv] and u [H, Dk],
where the TPU path folds (B, H) and broadcasts u first; one block per
(batch, head) carries the fp32 state across the chunks itself.  bf16 runs
on the tensor cores (sub-chunks of 16 carried through the state, decays as
running products, operands in bf16 hi + lo parts, TMA loads); fp32
on the CUDA cores (see the note in the ``.cu`` file for the bound and the
design).

``launches`` counts kernel launches (one per call: one per RWKV layer of
a forward with ``rwkv_impl="pallas"``).  ``rwkv6_design`` runs one of the
designs on the same contract, as a yardstick to time and check the path's
kernel against: on no path, and not counted.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

launches = 0
HEAD_DIMS = (32, 64, 128)
CHUNKS = (16, 32, 64)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the C entry's design codes, and the one the path runs for each dtype
DESIGNS = {"cuda_cores": 0, "tensor_cores": 1}
_PATH_DESIGN = {torch.float32: "cuda_cores", torch.bfloat16: "tensor_cores"}


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("rwkv6_scan")
    lib.rwkv6_scan_launch.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int] * 7 + [ctypes.c_void_p, ctypes.c_int]
    lib.rwkv6_scan_launch.restype = ctypes.c_int
    return lib


def _check(name, x, like, shape, dtype):
    if not x.is_cuda:
        raise ValueError(f"rwkv6_scan: {name} is on {x.device}, the kernel "
                         f"takes CUDA tensors only")
    if x.device != like.device:
        raise ValueError(f"rwkv6_scan: {name} is on {x.device} but r is on "
                         f"{like.device}")
    if x.dtype != dtype:
        raise ValueError(f"rwkv6_scan: {name} is {x.dtype}, want {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"rwkv6_scan: {name} has shape {tuple(x.shape)}, "
                         f"want {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"rwkv6_scan: {name} must be contiguous")


def rwkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          log_w: torch.Tensor, u: torch.Tensor, *, chunk: int
          ) -> torch.Tensor:
    """One launch: r/k/log_w [B,S,H,Dk], v [B,S,H,Dv], u [H,Dk] (CUDA;
    r/k/v one dtype, fp32 or bf16; log_w and u fp32) -> o [B,S,H,Dv] in
    v's dtype.  Raises on anything the kernel does not take: Dk or Dv not
    in (32, 64, 128), chunk not in (16, 32, 64) or not dividing S."""
    global launches
    out = _launch(r, k, v, log_w, u, chunk, _PATH_DESIGN.get(r.dtype))
    launches += 1
    return out


def rwkv6_design(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 log_w: torch.Tensor, u: torch.Tensor, *, chunk: int,
                 design: str) -> torch.Tensor:
    """One launch of ``design`` (a key of ``DESIGNS``; ``tensor_cores``
    takes bf16 only) on the same contract, not counted in ``launches``."""
    if design not in DESIGNS:
        raise ValueError(f"rwkv6_scan: design {design!r}, want one of "
                         f"{sorted(DESIGNS)}")
    if design != "cuda_cores" and r.dtype != torch.bfloat16:
        raise ValueError(f"rwkv6_scan: design {design!r} takes bfloat16, "
                         f"got {r.dtype}")
    return _launch(r, k, v, log_w, u, chunk, design)


def _aligned(x):
    """``x``, or a fresh copy of it when its data is not 16-byte aligned
    (the tensor-core kernel's TMA maps take 16-byte aligned tensors)."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _launch(r, k, v, log_w, u, chunk, design):
    if r.dim() != 4 or v.dim() != 4:
        raise ValueError(f"rwkv6_scan: want r [B,S,H,Dk] and v [B,S,H,Dv], "
                         f"got {tuple(r.shape)}, {tuple(v.shape)}")
    B, S, H, Dk = r.shape
    Dv = v.shape[-1]
    if r.dtype not in _DTYPES:
        raise ValueError(f"rwkv6_scan: r is {r.dtype}, the kernel takes "
                         f"float32 or bfloat16")
    if Dk not in HEAD_DIMS or Dv not in HEAD_DIMS:
        raise ValueError(f"rwkv6_scan: head dims Dk={Dk}, Dv={Dv}; the "
                         f"kernel takes {HEAD_DIMS}")
    if chunk not in CHUNKS:
        raise ValueError(f"rwkv6_scan: chunk {chunk}, the kernel takes "
                         f"{CHUNKS}")
    if S < 1 or S % chunk:
        raise ValueError(f"rwkv6_scan: S={S} is not a multiple of the chunk "
                         f"of {chunk}")
    _check("r", r, r, (B, S, H, Dk), r.dtype)
    _check("k", k, r, (B, S, H, Dk), r.dtype)
    _check("v", v, r, (B, S, H, Dv), r.dtype)
    _check("log_w", log_w, r, (B, S, H, Dk), torch.float32)
    _check("u", u, r, (H, Dk), torch.float32)
    if design == "tensor_cores":
        r, k, v, log_w = (_aligned(x) for x in (r, k, v, log_w))
    lib = _lib()
    out = torch.empty_like(v)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.rwkv6_scan_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(),
            u.data_ptr(), out.data_ptr(), _DTYPES[r.dtype], B, S, H, Dk, Dv,
            chunk, stream, DESIGNS[design])
    if err != 0:
        raise RuntimeError(f"rwkv6_scan launch failed: cudaError {err}")
    return out
