"""The fused server update on the card: binding and launch of
``csrc/fedmom_update.cu``.

Hopper port of the JAX package's Pallas kernel
(``repro/kernels/fedmom_update/kernel.py:61`` ``fused_flat``).  The TPU
kernel tiles a padded ``[rows, 128]`` stream into VMEM; this one is a single
grid-stride pass over a flat float32 stream of any length (see the source
note in the ``.cu`` file for the bound and the design).

``fused_update_tree`` packs every leaf of the parameter tree into one flat
stream with ``torch.cat``, launches once, and splits the result back into
the leaves' shapes and dtypes — one launch per server step.

``launches`` counts kernel launches (one per call of ``fused_flat``), so a
run can show that its server steps went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.tree import leaves, unflatten_like

KINDS = {"fedmom": 0, "fedavgm": 1}
launches = 0


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("fedmom_update").fedmom_update_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(name, x, like):
    if not x.is_cuda:
        raise ValueError(f"fedmom_update: {name} is on {x.device}, the "
                         f"kernel takes CUDA tensors only")
    if x.device != like.device:
        raise ValueError(f"fedmom_update: {name} is on {x.device} but w is "
                         f"on {like.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"fedmom_update: {name} is {x.dtype}, the kernel "
                         f"takes float32")
    if x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"fedmom_update: {name} must be a contiguous 1-D "
                         f"stream, got shape {tuple(x.shape)}")
    if x.numel() != like.numel():
        raise ValueError(f"fedmom_update: {name} holds {x.numel()} values "
                         f"but w holds {like.numel()}")


def fused_flat(w: torch.Tensor, s: torch.Tensor, delta: torch.Tensor,
               kind: str, eta: float, beta: float):
    """One launch over flat float32 CUDA streams; returns new ``(w', s')``
    for the update ``kind`` (``"fedmom"``: s is v; ``"fedavgm"``: s is m)."""
    global launches
    if kind not in KINDS:
        raise ValueError(f"unknown update kind {kind!r}: want {sorted(KINDS)}")
    for name, x in (("w", w), ("state", s), ("delta", delta)):
        _check(name, x, w)
    w_out = torch.empty_like(w)
    s_out = torch.empty_like(s)
    fn = _entry()
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = fn(w.data_ptr(), s.data_ptr(), delta.data_ptr(),
                 w_out.data_ptr(), s_out.data_ptr(), w.numel(), KINDS[kind],
                 float(eta), float(beta), stream)
    if err != 0:
        raise RuntimeError(f"fedmom_update launch failed: cudaError {err}")
    launches += 1
    return w_out, s_out


def _pack(xs):
    flat = [x.reshape(-1).to(torch.float32) for x in xs]
    return torch.cat(flat) if len(flat) > 1 else flat[0].contiguous()


def _unpack(flat, like):
    sizes = [x.numel() for x in like]
    return [p.reshape(x.shape).to(x.dtype)
            for p, x in zip(torch.split(flat, sizes), like)]


def fused_update_tree(w_tree, s_tree, d_tree, *, eta: float, beta: float,
                      kind: str = "fedmom"):
    """The fused update over parameter trees of CUDA tensors: leaves are
    concatenated into one float32 stream (ragged, bf16 and scalar leaves
    included), updated in a single launch, and split back; outputs follow
    the input leaves' dtypes."""
    lw, ls, ld = leaves(w_tree), leaves(s_tree), leaves(d_tree)
    if not lw:
        return w_tree, s_tree
    wn, sn = fused_flat(_pack(lw), _pack(ls), _pack(ld), kind, eta, beta)
    return (unflatten_like(w_tree, _unpack(wn, lw)),
            unflatten_like(s_tree, _unpack(sn, ls)))
