"""Public wrapper: the RWKV6 recurrence in the model's layout, r/k/log_w
[B,S,H,Dk], v [B,S,H,Dv], u [H,Dk].

Dispatch is by where the tensors lie: CUDA tensors go to the hand-written
kernel (``kernel.py``), which indexes each head in place; CPU tensors, and
any call with ``use_kernel=False``, go to the plain version (``ref.py``)
the way the JAX package's ``ops.py`` feeds its kernel: (B, H) folded and u
broadcast to every (batch, head).  There is no fallback: a CUDA input the
kernel cannot take raises, and with ``use_kernel=True`` a chunk that does
not divide S raises on any device, where the reference's kernel asserts.

Forward only, as the reference's kernel: inputs that require grad raise
until the zoo trains (ROADMAP Queue 1, training the zoo).
"""
from __future__ import annotations

import torch

from repro_torch.device import refuse_meta
from repro_torch.kernels.rwkv6_scan import kernel as _k
from repro_torch.kernels.rwkv6_scan import ref as _ref

DEFAULT_CHUNK = 32


def rwkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          log_w: torch.Tensor, u: torch.Tensor, *,
          chunk: int = DEFAULT_CHUNK, use_kernel: bool = True
          ) -> torch.Tensor:
    """r/k [B,S,H,Dk], v [B,S,H,Dv], log_w [B,S,H,Dk], u [H,Dk]
    -> o [B,S,H,Dv] in v's dtype."""
    if any(x.requires_grad for x in (r, k, v, log_w, u)):
        raise NotImplementedError(
            "rwkv6 is forward only: it has no backward yet (ROADMAP Queue 1, "
            "training the zoo)")
    B, S, H, Dk = r.shape
    Dv = v.shape[-1]
    if use_kernel:
        chunk = min(chunk, S)
        if S % chunk:
            raise ValueError(f"rwkv6: S={S} is not a multiple of the chunk "
                             f"of {chunk}")
        refuse_meta("rwkv6_scan", r, k, v, log_w, u)
        if r.is_cuda:
            return _k.rwkv6(r.contiguous(), k.contiguous(), v.contiguous(),
                            log_w.contiguous(), u.contiguous(), chunk=chunk)

    def fold(x):
        return x.transpose(1, 2).reshape(B * H, S, x.shape[-1])

    uf = u[None].expand(B, H, Dk).reshape(B * H, Dk)
    of, _ = _ref.rwkv6_sequential(fold(r), fold(k), fold(v), fold(log_w), uf)
    return of.reshape(B, H, S, Dv).transpose(1, 2)
