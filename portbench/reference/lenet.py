"""Plain LeNet-5 for 28x28 one-channel images (LeCun et al. 1998), as the
paper's FEMNIST experiment trains it.

Images are NHWC, convolution kernels HWIO and dense kernels ``[in, out]``:
conv 5x5 (1 -> 6), tanh, 2x2 max pool, conv 5x5 (6 -> 16), tanh, 2x2 max
pool, flatten in NHWC order, dense 256 -> 120, tanh, dense 120 -> classes.
The loss is the mean softmax cross entropy.  ``prec`` rounds the operands
of each convolution and dense product (``precision.round_operand``).  A
convolution is computed as the product of the image's patches with the
kernel, so that its fp32 sums are plain dot products.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .precision import round_operand

LEAVES = ("conv1", "b1", "conv2", "b2", "fc1", "bf1", "fc2", "bf2")


def shapes(n_classes: int) -> dict:
    return {"conv1": (5, 5, 1, 6), "b1": (6,), "conv2": (5, 5, 6, 16),
            "b2": (16,), "fc1": (256, 120), "bf1": (120,),
            "fc2": (120, n_classes), "bf2": (n_classes,)}


def _conv(h, w_hwio, b, prec):
    """A valid 2-D convolution as one product of the image's patches
    (NCHW) with the HWIO kernel: every output is a plain fp32 dot product,
    with no transform of a fast convolution algorithm between."""
    kh, kw, cin, cout = w_hwio.shape
    n, _, hh, ww = h.shape
    cols = F.unfold(round_operand(h, prec), (kh, kw))       # [n, cin*kh*kw, L]
    w = round_operand(w_hwio.permute(2, 0, 1, 3).reshape(cin * kh * kw,
                                                          cout), prec)
    out = cols.transpose(1, 2) @ w + b                      # [n, L, cout]
    return out.transpose(1, 2).reshape(n, cout, hh - kh + 1, ww - kw + 1)


def logits(p: dict, x: torch.Tensor, prec: str = "fp32") -> torch.Tensor:
    h = x.permute(0, 3, 1, 2)
    h = F.max_pool2d(torch.tanh(_conv(h, p["conv1"], p["b1"], prec)), 2, 2)
    h = F.max_pool2d(torch.tanh(_conv(h, p["conv2"], p["b2"], prec)), 2, 2)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    h = torch.tanh(round_operand(h, prec) @ round_operand(p["fc1"], prec)
                   + p["bf1"])
    return round_operand(h, prec) @ round_operand(p["fc2"], prec) + p["bf2"]


def loss(p: dict, batch: dict, prec: str = "fp32") -> torch.Tensor:
    z = logits(p, batch["x"], prec)
    y = batch["y"].long()
    return torch.mean(torch.logsumexp(z, -1)
                      - torch.gather(z, -1, y[:, None])[:, 0])


def batches(client: dict, rows, local_steps: int, b: int) -> list:
    """The ``local_steps`` minibatches of one client: ``rows`` [H * b]
    indices into its samples."""
    rows = torch.as_tensor(rows, device=client["x"].device)
    return [{"x": client["x"][rows[h * b:(h + 1) * b]],
             "y": client["y"][rows[h * b:(h + 1) * b]]}
            for h in range(local_steps)]
