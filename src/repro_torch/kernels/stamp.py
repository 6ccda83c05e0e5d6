"""Binding of ``csrc/stamp.cu``: one device clock stamp, the recorder's
(``repro_torch/spans.py``).  Its plain counterpart is the host clock that
``spans`` writes into a CPU buffer; a CUDA slot goes to the kernel, which
is built at first use."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

launches = 0        # stamps launched in this process


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("stamp")
    lib.stamp_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_void_p]
    lib.stamp_launch.restype = ctypes.c_int
    return lib


def launch(address: int, device_index: int, end: bool):
    """Add ``%globaltimer`` (``end``) or its negation (a start) into the
    int64 at ``address`` on card ``device_index``, on its current
    stream.  The recorder passes an address (``spans._Slots``): a stamp
    may run inside ``torch.func`` transforms, where a tensor of the
    buffer would be wrapped."""
    global launches
    stream = torch._C._cuda_getCurrentRawStream(device_index)
    err = _lib().stamp_launch(address, int(bool(end)), stream)
    if err:
        raise RuntimeError(f"stamp: launch failed with CUDA error {err}")
    launches += 1
