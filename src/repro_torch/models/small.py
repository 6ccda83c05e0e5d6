"""The paper's own experiment models: LeNet (FEMNIST digit/char recognition,
LeCun et al. 1998) and a 1-layer 128-unit character-level LSTM (Kim et al.
2016) for Shakespeare next-char prediction — §5.1 of the paper.

Pure functions over parameter dicts (``loss_fn(params, batch) -> (loss,
metrics)``), so ``torch.func`` can differentiate and batch them.  The
parameters keep the JAX package's layout — images NHWC, convolution
kernels HWIO, dense kernels ``[in, out]`` — so the same trees load in both
packages; ``lenet_apply`` permutes to PyTorch's NCHW/OIHW around each
convolution and flattens in NHWC order, as the reference does.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import random as prng
from repro_torch.data.synthetic import (
    FEMNIST_CLASSES,
    SHAKESPEARE_VOCAB,
)


def _dense_init(key, shape, scale=None, device=None):
    fan_in = shape[0] if len(shape) == 1 else math.prod(shape[:-1])
    scale = scale or 1.0 / math.sqrt(max(fan_in, 1))
    return (prng.normal(key, shape) * scale).to(device)


def _zeros(n, device):
    return torch.zeros((n,), dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# LeNet
# ---------------------------------------------------------------------------
def lenet_init(key, n_classes: int = FEMNIST_CLASSES, device=None):
    """Random LeNet weights from a threefry key (the draws equal the JAX
    package's ``lenet_init`` within the ``erfinv`` tolerance of
    ``repro_torch.random.normal``)."""
    ks = prng.split(key, 4)
    return {
        "conv1": _dense_init(ks[0], (5, 5, 1, 6), device=device),
        "b1": _zeros(6, device),
        "conv2": _dense_init(ks[1], (5, 5, 6, 16), device=device),
        "b2": _zeros(16, device),
        "fc1": _dense_init(ks[2], (16 * 4 * 4, 120), device=device),
        "bf1": _zeros(120, device),
        "fc2": _dense_init(ks[3], (120, n_classes), device=device),
        "bf2": _zeros(n_classes, device),
    }


def _conv(x_nchw, w_hwio, b):
    return F.conv2d(x_nchw, w_hwio.permute(3, 2, 0, 1), b)


def lenet_apply(params, x):
    """x [B,28,28,1] NHWC -> logits [B,n_classes]."""
    h = x.permute(0, 3, 1, 2)
    h = torch.tanh(_conv(h, params["conv1"], params["b1"]))   # 6x24x24
    h = F.max_pool2d(h, 2, 2)                                  # 6x12x12
    h = torch.tanh(_conv(h, params["conv2"], params["b2"]))   # 16x8x8
    h = F.max_pool2d(h, 2, 2)                                  # 16x4x4
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)         # NHWC order
    h = torch.tanh(h @ params["fc1"] + params["bf1"])
    return h @ params["fc2"] + params["bf2"]


def _xent(logits, labels):
    labels = labels.long()
    nll = (torch.logsumexp(logits, -1)
           - torch.gather(logits, -1, labels[..., None])[..., 0])
    loss = torch.mean(nll)
    acc = torch.mean((torch.argmax(logits, -1) == labels).to(torch.float32))
    return loss, {"loss": loss, "acc": acc}


def lenet_loss(params, batch):
    return _xent(lenet_apply(params, batch["x"]), batch["y"])


# ---------------------------------------------------------------------------
# char-LSTM (1 layer, 128 units, 8-dim char embedding per LEAF)
# ---------------------------------------------------------------------------
LSTM_HIDDEN = 128
CHAR_EMBED = 8


def lstm_init(key, vocab: int = SHAKESPEARE_VOCAB,
              hidden: int = LSTM_HIDDEN, embed: int = CHAR_EMBED,
              device=None):
    ks = prng.split(key, 4)
    return {
        "embed": _dense_init(ks[0], (vocab, embed), scale=0.1,
                             device=device),
        "wx": _dense_init(ks[1], (embed, 4 * hidden), device=device),
        "wh": _dense_init(ks[2], (hidden, 4 * hidden), device=device),
        "b": _zeros(4 * hidden, device),
        "head": _dense_init(ks[3], (hidden, vocab), device=device),
        "head_b": _zeros(vocab, device),
    }


def lstm_apply(params, tokens):
    """tokens [B,S] -> logits [B,S,V]."""
    B, S = tokens.shape
    H = params["wh"].shape[0]
    x = params["embed"][tokens.long()]                 # [B,S,E]
    h = torch.zeros((B, H), dtype=x.dtype, device=x.device)
    c = torch.zeros((B, H), dtype=x.dtype, device=x.device)
    hs = []
    for s in range(S):
        z = x[:, s] @ params["wx"] + h @ params["wh"] + params["b"]
        i, f, g, o = torch.chunk(z, 4, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    hs = torch.stack(hs, dim=1)                        # [B,S,H]
    return hs @ params["head"] + params["head_b"]


def lstm_loss(params, batch):
    return _xent(lstm_apply(params, batch["tokens"]), batch["labels"])
