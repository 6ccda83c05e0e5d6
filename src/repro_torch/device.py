"""Which device an entry point of the port runs on.

The port is written for the card: ``FederatedTrainer``, ``round_step`` and
the examples run on ``cuda`` unless the caller asks for another device
(``device="cpu"``, as the tests do).  Without a card and without such a
request they raise — they never carry on silently on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda``, which
    must then be available.  A CUDA device without an index gets the
    current one, so it compares equal to the device of tensors on it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the port runs on the card by "
            "default — pass device='cpu' to run on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def to_device(value, device: torch.device, dtype=None) -> torch.Tensor:
    """``torch.as_tensor(value, dtype=dtype, device=device)`` that never
    makes the host wait for the card: a host value (array, number, CPU
    tensor) goes through pinned memory and a non-blocking copy on the
    current stream, which runs after the kernels queued before it (a copy
    from pageable memory would hold the host until they end).  A tensor
    already on ``device`` is returned as it is; on the CPU this is
    ``torch.as_tensor``."""
    if isinstance(value, torch.Tensor) and value.device == device:
        return value if dtype is None else value.to(dtype)
    if device.type != "cuda":
        return torch.as_tensor(value, dtype=dtype, device=device)
    x = (value if isinstance(value, torch.Tensor)
         else torch.as_tensor(np.asarray(value)))
    if dtype is not None:
        x = x.to(dtype)
    return x.pin_memory().to(device, non_blocking=True)


def refuse_meta(kernel: str, *tensors) -> None:
    """Raise where a hand-written kernel is asked for on meta tensors: the
    dry run counts on the meta device, and counting the kernel's plain
    version in its place would be counting another program."""
    if any(t.device.type == "meta" for t in tensors):
        raise NotImplementedError(
            f"{kernel}: a hand-written CUDA kernel has no meta-device "
            f"counterpart to count; count the plain path instead "
            f"(attention_impl='xla', rwkv_impl='xla', "
            f"use_fused_kernel=False, use_kernel=False)")
