"""Public wrapper: model-layout attention, q [B,S,Hq,d], k/v [B,T,Hkv,d].

Dispatch is by where the tensors lie: CUDA tensors go to the hand-written
kernel (``kernel.py``), which indexes the KV head of each query head
itself; CPU tensors, and any call with ``use_kernel=False``, go to the
plain version (``ref.py``) the way the JAX package's ``ops.py`` feeds its
kernel: K/V repeated to every query head and (B, H) folded.  There is no
fallback: a CUDA input the kernel cannot take raises.

Forward only, as the reference's kernel: inputs that require grad raise
until the kernel has a backward (ROADMAP Queue 1, training the zoo).
"""
from __future__ import annotations

import torch

from repro_torch.device import refuse_meta
from repro_torch.kernels.flash_attention import kernel as _k
from repro_torch.kernels.flash_attention import ref as _ref

# the reference's block defaults (repro/kernels/flash_attention/kernel.py)
DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    block_q: int = DEFAULT_BLOCK_Q,
                    block_k: int = DEFAULT_BLOCK_K,
                    use_kernel: bool = True) -> torch.Tensor:
    """q [B,S,Hq,d], k/v [B,T,Hkv,d] -> [B,S,Hq,d] in q's dtype.

    ``block_q`` / ``block_k`` are the reference's signature: with
    ``use_kernel`` they are cut to ``min(block, S)`` / ``min(block, T)`` and
    must divide S and T, else ``ValueError`` (where the reference asserts).
    They choose no tile here: the CUDA kernels' tiles are their own, and
    they take any S that is a multiple of 64.
    """
    if any(x.requires_grad for x in (q, k, v)):
        raise NotImplementedError(
            "flash_attention is forward only: it has no backward yet "
            "(ROADMAP Queue 1, training the zoo: the autograd.Function)")
    B, S, Hq, d = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if use_kernel:
        bq, bk = min(block_q, S), min(block_k, T)
        if S % bq or T % bk:
            raise ValueError(f"flash_attention: S={S}, T={T} are not "
                             f"multiples of block_q={bq}, block_k={bk} "
                             f"(min(block, length), the reference's check)")
        refuse_meta("flash_attention", q, k, v)
        if q.is_cuda:
            return _k.flash_attention(q.contiguous(), k.contiguous(),
                                      v.contiguous(), causal=causal,
                                      window=window)
    groups = Hq // Hkv
    if groups > 1:
        k = torch.repeat_interleave(k, groups, dim=2)
        v = torch.repeat_interleave(v, groups, dim=2)
    qf = q.transpose(1, 2).reshape(B * Hq, S, d)
    kf = k.transpose(1, 2).reshape(B * Hq, T, d)
    vf = v.transpose(1, 2).reshape(B * Hq, T, d)
    of = _ref.attention_bhsd(qf, kf, vf, causal=causal, window=window)
    return of.reshape(B, Hq, S, d).transpose(1, 2)
