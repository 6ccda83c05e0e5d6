"""Operand precision of the reference's products.

``"fp32"`` leaves an operand as it is: the reference's own precision, with
TF32 off.  The lower modes are the controls of the correctness check: each
rounds both operands of every product to a narrower format and multiplies
them in fp32, as a tensor core does; the backward rounds the gradient
that reaches an operand the same way, so the backward's products take
narrow operands too.

* ``"tf32"``: 10 mantissa bits, rounded to nearest, ties away from zero.
* ``"bf16"``: 7 mantissa bits, rounded to nearest even.
* ``"fp8"``: float8 under one scale a tensor (its largest magnitude to
  the format's largest), e4m3 forward and e5m2 for gradients, the usual
  recipe for fp8 training.
"""
from __future__ import annotations

import contextlib

import torch

MODES = ("fp32", "tf32", "bf16", "fp8")


_FP8 = {False: (torch.float8_e4m3fn, 448.0), True: (torch.float8_e5m2,
                                                     57344.0)}


def _round(x: torch.Tensor, mode: str, grad: bool = False) -> torch.Tensor:
    if mode == "bf16":
        return x.to(torch.bfloat16).to(x.dtype)
    if mode == "tf32":
        bits = x.float().contiguous().view(torch.int32)
        bits = (bits + (1 << 12)) & ~((1 << 13) - 1)
        return bits.view(torch.float32).to(x.dtype)
    if mode == "fp8":
        dtype, top = _FP8[grad]
        scale = x.abs().amax().float().clamp(min=1e-30) / top
        return (x / scale).to(dtype).to(x.dtype) * scale
    raise ValueError(f"unknown precision {mode!r}: want one of {MODES}")


class _Rounded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mode):
        ctx.mode = mode
        return _round(x, mode)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.mode, grad=True), None


def round_operand(x: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "fp32":
        return x
    if mode not in MODES:
        raise ValueError(f"unknown precision {mode!r}: want one of {MODES}")
    return _Rounded.apply(x, mode)


@contextlib.contextmanager
def exact_fp32():
    """Products in full fp32 on the card: TF32 off for matmuls and
    convolutions while the reference runs (restored after)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
