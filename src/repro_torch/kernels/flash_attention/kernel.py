"""The flash-attention forward on the card: binding and launch of
``csrc/flash_attention.cu``.

Hopper port of the JAX package's Pallas kernel
(``repro/kernels/flash_attention/kernel.py:94`` ``flash_attention_bhsd``).
It takes the model's layout, q [B, S, Hq, d] and k/v [B, S, Hkv, d], and
indexes each query head's KV head itself, where the TPU path repeats K/V
to every query head and folds (B, H) first.  bf16 runs on the tensor cores
(wgmma fed by TMA, the query heads of a KV head packed into one tile, P
carried into P.V in bf16 hi + lo parts); fp32 on the CUDA cores (see the
note in the ``.cu`` file for the bound and the design).

``launches`` counts kernel launches (one per call: one per attention layer
of a prefill whose length is a multiple of 128).
``flash_attention_design`` runs one of the other designs on the same
contract, as a yardstick to time and check the path's kernel against: on
no path, and not counted.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

launches = 0
HEAD_DIMS = (64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the C entry's design codes, and the one the path runs for each dtype
DESIGNS = {"cuda_cores": 0, "p_bf16": 1, "p_hi_lo": 2}
_PATH_DESIGN = {torch.float32: "cuda_cores", torch.bfloat16: "p_hi_lo"}


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("flash_attention")
    lib.flash_attention_launch.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int]
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_s_multiple.restype = ctypes.c_int
    return lib


def _check(name, x, like, shape):
    if not x.is_cuda:
        raise ValueError(f"flash_attention: {name} is on {x.device}, the "
                         f"kernel takes CUDA tensors only")
    if x.device != like.device:
        raise ValueError(f"flash_attention: {name} is on {x.device} but q is "
                         f"on {like.device}")
    if x.dtype != like.dtype:
        raise ValueError(f"flash_attention: {name} is {x.dtype} but q is "
                         f"{like.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"flash_attention: {name} has shape "
                         f"{tuple(x.shape)}, want {tuple(shape)}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"flash_attention: {name} must be contiguous and "
                         f"16-byte aligned")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """One launch: q [B,S,Hq,d], k/v [B,S,Hkv,d] (CUDA, one dtype, fp32 or
    bf16) -> [B,S,Hq,d] in q's dtype.  Raises on anything the kernel does
    not take: d not in (64, 128, 256), key length other than S, S not a
    multiple of the kernel's tiles, Hq not a multiple of Hkv."""
    global launches
    out = _launch(q, k, v, causal, window, _PATH_DESIGN.get(q.dtype))
    launches += 1
    return out


def flash_attention_design(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, design: str,
                           causal: bool = True,
                           window: int = 0) -> torch.Tensor:
    """One launch of ``design`` (a key of ``DESIGNS``; the tensor-core ones
    take bf16 only) on the same contract, not counted in ``launches``."""
    if design not in DESIGNS:
        raise ValueError(f"flash_attention: design {design!r}, want one of "
                         f"{sorted(DESIGNS)}")
    if design != "cuda_cores" and q.dtype != torch.bfloat16:
        raise ValueError(f"flash_attention: design {design!r} takes "
                         f"bfloat16, got {q.dtype}")
    return _launch(q, k, v, causal, window, design)


def _launch(q, k, v, causal, window, design):
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_attention: want q [B,S,Hq,d] and k/v "
                         f"[B,T,Hkv,d], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    B, S, Hq, d = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: q is {q.dtype}, the kernel takes "
                         f"float32 or bfloat16")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d}, the kernel takes "
                         f"{HEAD_DIMS}")
    if T != S:
        raise ValueError(f"flash_attention: {T} keys for {S} queries; the "
                         f"kernel takes self-attention (T == S)")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"flash_attention: {Hq} query heads over {Hkv} KV "
                         f"heads")
    _check("q", q, q, (B, S, Hq, d))
    _check("k", k, q, (B, S, Hkv, d))
    _check("v", v, q, (B, S, Hkv, d))
    lib = _lib()
    tile = lib.flash_attention_s_multiple()
    if S % tile:
        raise ValueError(f"flash_attention: S={S} is not a multiple of the "
                         f"kernel's tile of {tile} rows")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], B, S, Hq, Hkv, d, int(bool(causal)),
            int(window), 1.0 / math.sqrt(d), stream, DESIGNS[design])
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")
    return out
