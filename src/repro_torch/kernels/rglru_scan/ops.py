"""Public wrapper for the RG-LRU scan (gates precomputed): a/b [B,S,R]
-> h [B,S,R] fp32, with a the per-step decay and b the gated input.

The reference's signature and default chunk.  The chunk is checked and
halved until it divides S, as the reference's kernel does, so every call
it accepts is accepted here; the hand-written kernel walks all of S in
every thread, so the chunk changes neither its result nor its tiles.
Inputs are cast to fp32, as the reference's oracle casts them.  Dispatch
is by where the tensors lie: CUDA tensors go to the hand-written kernel
(``kernel.py``), CPU tensors, and any call with ``use_kernel=False``, to
the plain version (``ref.py``).  There is no fallback: a CUDA input the
kernel cannot take raises.

Forward only, as the reference's kernel: inputs that require grad raise
until the zoo trains (ROADMAP Queue 1, training the zoo).  No model calls
this wrapper, as in the reference: the RG-LRU block runs
``layers.rglru_scan``.
"""
from __future__ import annotations

import torch

from repro_torch.device import refuse_meta
from repro_torch.kernels.rglru_scan import kernel as _k
from repro_torch.kernels.rglru_scan import ref as _ref

DEFAULT_CHUNK = 128


def fit_chunk(S: int, chunk: int) -> int:
    """The reference kernel's chunk for S: ``min(chunk, S)``, halved until
    it divides S."""
    if chunk < 1:
        raise ValueError(f"rglru_scan: chunk {chunk}, want >= 1")
    chunk = min(chunk, S)
    while S % chunk:
        chunk //= 2
    return chunk


def rglru_scan(a: torch.Tensor, b: torch.Tensor, *,
               chunk: int = DEFAULT_CHUNK, use_kernel: bool = True
               ) -> torch.Tensor:
    """a/b [B,S,R] -> h [B,S,R] fp32."""
    if a.requires_grad or b.requires_grad:
        raise NotImplementedError(
            "rglru_scan is forward only: it has no backward yet (ROADMAP "
            "Queue 1, training the zoo)")
    a, b = a.to(torch.float32), b.to(torch.float32)
    if use_kernel:
        fit_chunk(a.shape[1], chunk)
        refuse_meta("rglru_scan", a, b)
        if a.is_cuda:
            return _k.rglru(a.contiguous(), b.contiguous())
    return _ref.rglru_sequential(a, b)
