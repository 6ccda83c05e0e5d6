"""MoE routing by index on the card: binding and launch of
``csrc/moe_route.cu``.

Replaces no TPU kernel: the JAX package dispatches tokens to experts and
combines them back with dense one-hot products over [G, E, C] (see the
note in the ``.cu`` file for why that is waste on this card, and for the
bound and the design).  Three launches, each over N independent groups:
``gather_rows`` (tokens into slots), ``sum_rows`` (slots into tokens) and
``route_dots`` (the gate gradient).

``launches`` counts kernel launches (one per call); with the recorder on
each launch also counts ``moe.route_launches`` (``repro_torch/spans.py``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import spans
from repro_torch.kernels import _build
from repro_torch.kernels.moe_route.ref import vec_width

launches = 0
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ENTRIES = ("moe_gather_rows", "moe_sum_rows", "moe_route_dots")


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("moe_route")
    for name in _ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.moe_route_max_k.restype = ctypes.c_int
    return lib


def _check(name, x, like, dtype, dims):
    if not x.is_cuda:
        raise ValueError(f"moe_route: {name} is on {x.device}, the kernels "
                         f"take CUDA tensors only")
    if x.device != like.device:
        raise ValueError(f"moe_route: {name} is on {x.device} but the rows "
                         f"are on {like.device}")
    if x.dtype != dtype:
        raise ValueError(f"moe_route: {name} is {x.dtype}, want {dtype}")
    if x.dim() != dims:
        raise ValueError(f"moe_route: {name} has shape {tuple(x.shape)}, "
                         f"want {dims} dimensions")
    if not x.is_contiguous():
        raise ValueError(f"moe_route: {name} must be contiguous")


def _launch(entry, rows, tables, w, out_shape, S, G, k):
    """Check the operands, allocate the output and launch ``entry``."""
    global launches
    if rows[0].dtype not in _DTYPES:
        raise ValueError(f"moe_route: rows are {rows[0].dtype}, the kernels "
                         f"take float32 or bfloat16")
    dt = rows[0].dtype
    for i, x in enumerate(rows):
        _check(f"rows[{i}]", x, rows[0], dt, 3)
    for i, t in enumerate(tables):
        _check(f"table[{i}]", t, rows[0], torch.int32, t.dim())
    if w is not None:
        _check("w", w, rows[0], dt, 3)
    N, D = rows[0].shape[0], rows[0].shape[2]
    if k < 1 or k > _lib().moe_route_max_k():
        raise ValueError(f"moe_route: {k} routes a token; the kernels take "
                         f"1 to {_lib().moe_route_max_k()}")
    out = torch.empty(out_shape, dtype=dt, device=rows[0].device)
    ptrs = [x.data_ptr() for x in (*rows, out) + ((w,) if w is not None
                                                  else ())]
    vec = vec_width(D, dt) > 1 and all(p % 16 == 0 for p in ptrs)
    if vec_width(D, dt) > 1 and not vec:
        raise ValueError("moe_route: rows must be 16-byte aligned where D "
                         "is a multiple of a 16-byte vector")
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        fn = getattr(_lib(), entry)
        args = [x.data_ptr() for x in (*rows, *tables)]
        if entry != "moe_route_dots":
            args.insert(2, 0 if w is None else w.data_ptr())
        err = fn(*args, out.data_ptr(), N, G, k, S, D, _DTYPES[dt],
                 int(vec), stream)
    if err != 0:
        raise RuntimeError(f"moe_route: {entry} failed: cudaError {err}")
    launches += 1
    spans.count("moe.route_launches")
    return out


def gather_rows(src: torch.Tensor, owner: torch.Tensor,
                w, k: int) -> torch.Tensor:
    """One launch: src [N, G, D], owner [N, S] int32, w [N, G, k] or None
    -> [N, S, D]: ``w[owner] * src[owner // k]``, zero where empty."""
    N, G, _ = src.shape
    S = owner.shape[1]
    if owner.shape[0] != N or (w is not None and w.shape != (N, G, k)):
        raise ValueError(f"moe_route: gather_rows of src {tuple(src.shape)} "
                         f"by owner {tuple(owner.shape)}")
    return _launch("moe_gather_rows", (src,), (owner,), w,
                   (N, S, src.shape[2]), S, G, k)


def sum_rows(src: torch.Tensor, slot: torch.Tensor, w) -> torch.Tensor:
    """One launch: src [N, S, D], slot [N, G, k] int32, w [N, G, k] or None
    -> [N, G, D]: the kept routes' ``w * src[slot]`` summed in ascending
    slot order in fp32."""
    N, S, D = src.shape
    G, k = slot.shape[1], slot.shape[2]
    if slot.shape[0] != N or (w is not None and w.shape != slot.shape):
        raise ValueError(f"moe_route: sum_rows of src {tuple(src.shape)} by "
                         f"slot {tuple(slot.shape)}")
    return _launch("moe_sum_rows", (src,), (slot,), w, (N, G, D), S, G, k)


def route_dots(a: torch.Tensor, b: torch.Tensor,
               slot: torch.Tensor) -> torch.Tensor:
    """One launch: a [N, G, D], b [N, S, D], slot [N, G, k] int32 ->
    [N, G, k]: ``<a[g], b[slot[g, j]]>``, 0 where dropped."""
    N, G, D = a.shape
    S = b.shape[1]
    if b.shape[0] != N or b.shape[2] != D or slot.shape[:2] != (N, G):
        raise ValueError(f"moe_route: route_dots of a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)} by slot {tuple(slot.shape)}")
    k = slot.shape[2]
    return _launch("moe_route_dots", (a, b), (slot,), None, (N, G, k), S, G,
                   k)
