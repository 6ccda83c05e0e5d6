"""The fused client step on the card: binding and launch of
``csrc/client_step.cu``.

Hopper port of the JAX package's Pallas kernel
(``repro/kernels/client_step/kernel.py:75`` ``client_step_flat``).  The TPU
kernel pads D to 128 lanes and N to 8 sublanes and copies each client's
whole ``[N, D]`` slot into VMEM; this one takes any D up to 1,024 and any N
unpadded, and gathers only the H*b rows each client uses (see the note in
the ``.cu`` file for the bound and the design).  The path's design stages a
client's rows in shared memory up front, in a ring of K step buffers that
``staging_plan`` sizes here, on the host.

``launches`` counts kernel launches: one per call of ``client_step`` over
at least one client (one per occupied size tier and round on the bucketed
streaming plane), added where the launch returns.
``client_step_design`` runs one of the designs on the same contract, as a
yardstick to time and check the path's kernel against: on no path, and not
counted.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build

launches = 0
# the C entry's design codes; the path runs "staged", the others are
# yardsticks: the first design, and the staged one without helper warps
DESIGNS = {"v1": 0, "staged": 1, "staged_solo": 2}
# shared memory the card keeps back for each resident block
# (cudaDevAttrReservedSharedMemoryPerBlock on sm_80 and later)
RESERVED_SMEM = 1024


def _smem_bytes(b, D, K, G):
    """Mirrors ``staged::smem_bytes`` in the ``.cu`` file."""
    warps = -(-D // 128)
    return 4 * K * b * (D + 2) + (4 * 2 * warps * G if warps > 1 else 0)


def staging_plan(H: int, b: int, D: int, smem_limit: int,
                 blocks_per_sm: int = 1):
    """The staged design's plan: ``(K, G, bytes)``, K step buffers (1 <= K
    <= H), groups of G rows and the shared memory a block then takes.

    A step buffer holds b rows of D floats, their b y values and b row ids;
    with more than one warp a client also keeps two buffers of per-warp
    partials of a group of G rows.  G is the least of 8, 16 and 32 that
    holds b, or 8 where the wider group's partials would not leave room
    for one step (at an H100's 227 KB every shape the first design takes
    then fits).  K = H where
    the whole client fits the budget, else as many steps as fit it, at
    least one.  The budget is the opt-in shared memory ``smem_limit`` of
    one block, shared by the ``blocks_per_sm`` blocks a launch wants
    resident on one SM.  Raises ``ValueError`` where even one step does not
    fit one block.
    """
    G = 8 if b <= 8 else (16 if b <= 16 else 32)
    if _smem_bytes(b, D, 1, G) > smem_limit:
        G = 8
    if _smem_bytes(b, D, 1, G) > smem_limit:
        raise ValueError(f"client_step: a block needs "
                         f"{_smem_bytes(b, D, 1, G)} B of shared memory for "
                         f"b={b}, D={D}; the card allows {smem_limit}")
    fixed = _smem_bytes(b, D, 0, G)
    budget = (smem_limit + RESERVED_SMEM) // blocks_per_sm - RESERVED_SMEM
    K = max(1, min(H, (budget - fixed) // (4 * b * (D + 2))))
    return K, G, _smem_bytes(b, D, K, G)


def blocks_wanted(C: int, sm_count: int) -> int:
    """Blocks a launch of C clients wants resident on one SM: one while the
    grid fits the card in one wave, else two, so one block's start-up (its
    ids, its first copies) runs under another's stream of rows."""
    return 1 if C <= sm_count else 2


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("client_step")
    lib.client_step_launch.argtypes = [ctypes.c_void_p] * 10 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.client_step_launch.restype = ctypes.c_int
    lib.client_step_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.client_step_smem_bytes.restype = ctypes.c_longlong
    lib.client_step_smem_limit.argtypes = [ctypes.c_int]
    lib.client_step_smem_limit.restype = ctypes.c_int
    lib.client_step_max_features.argtypes = []
    lib.client_step_max_features.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _smem_limit(device_index: int) -> int:
    limit = _lib().client_step_smem_limit(device_index)
    if limit < 0:
        raise RuntimeError(f"client_step: cannot read the shared-memory limit "
                           f"of cuda:{device_index}")
    return limit


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _check(name, x, dtype, shape, like):
    if not x.is_cuda:
        raise ValueError(f"client_step: {name} is on {x.device}, the kernel "
                         f"takes CUDA tensors only")
    if x.device != like.device:
        raise ValueError(f"client_step: {name} is on {x.device} but xs is on "
                         f"{like.device}")
    if x.dtype != dtype:
        raise ValueError(f"client_step: {name} is {x.dtype}, the kernel "
                         f"takes {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"client_step: {name} has shape {tuple(x.shape)}, "
                         f"want {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"client_step: {name} must be contiguous")


def client_step(xs: torch.Tensor, ys: torch.Tensor, slots: torch.Tensor,
                idx: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                lr: float, local_steps: int, batch_size: int,
                step_mask: Optional[torch.Tensor] = None):
    """One launch over a tier's C clients, on CUDA tensors.

    ``xs`` [S, N, D] / ``ys`` [S, N] float32; ``slots`` [C] / ``idx``
    [C, H*b] int32; ``w`` [D] / ``b`` [] float32 (device pointers: nothing
    is read back to the host); ``lr`` a host float; ``step_mask`` optional
    [C, H] float32.  Returns ``(w_out [C, D], b_out [C], mean_loss [C])``.
    Slot and row ids out of range stop the kernel with a device-side
    assert; everything else the kernel cannot take raises here.
    """
    return _launch(xs, ys, slots, idx, w, b, lr, local_steps, batch_size,
                   step_mask, "staged", None, None, counted=True)


def client_step_design(xs: torch.Tensor, ys: torch.Tensor,
                       slots: torch.Tensor, idx: torch.Tensor,
                       w: torch.Tensor, b: torch.Tensor, lr: float,
                       local_steps: int, batch_size: int,
                       step_mask: Optional[torch.Tensor] = None, *,
                       design: str, ring: Optional[int] = None,
                       group: Optional[int] = None):
    """One launch of ``design`` (a key of ``DESIGNS``) on the contract of
    ``client_step``, not counted in ``launches``.  ``ring`` (1..H) and
    ``group`` (8, 16 or 32) set the staged designs' K and G in place of
    ``staging_plan``'s."""
    if design not in DESIGNS:
        raise ValueError(f"client_step: design {design!r}, want one of "
                         f"{sorted(DESIGNS)}")
    return _launch(xs, ys, slots, idx, w, b, lr, local_steps, batch_size,
                   step_mask, design, ring, group)


def plan_for(xs: torch.Tensor, C: int, local_steps: int, batch_size: int,
             blocks_per_sm: Optional[int] = None):
    """``staging_plan``'s ``(K, G, bytes)`` for a launch of C clients over
    the CUDA tensor ``xs`` [S, N, D], on its card (``blocks_per_sm``:
    ``blocks_wanted``'s unless given)."""
    dev = xs.device.index
    if blocks_per_sm is None:
        blocks_per_sm = blocks_wanted(C, _sm_count(dev))
    return staging_plan(int(local_steps), int(batch_size), xs.shape[-1],
                        _smem_limit(dev), blocks_per_sm)


def _launch(xs, ys, slots, idx, w, b, lr, local_steps, batch_size,
            step_mask, design, ring, group, counted=False):
    global launches
    H, B = int(local_steps), int(batch_size)
    if H < 1 or B < 1:
        raise ValueError(f"client_step: local_steps and batch_size must be "
                         f">= 1, got {H}, {B}")
    if xs.dim() != 3:
        raise ValueError(f"client_step: xs must be [S, N, D], got shape "
                         f"{tuple(xs.shape)}")
    S, N, D = xs.shape
    C = slots.shape[0] if slots.dim() == 1 else -1
    _check("xs", xs, torch.float32, (S, N, D), xs)
    _check("ys", ys, torch.float32, (S, N), xs)
    _check("slots", slots, torch.int32, (C,), xs)
    _check("idx", idx, torch.int32, (C, H * B), xs)
    _check("w", w, torch.float32, (D,), xs)
    _check("b", b, torch.float32, (), xs)
    if step_mask is not None:
        _check("step_mask", step_mask, torch.float32, (C, H), xs)
    lib = _lib()
    if D > lib.client_step_max_features():
        raise ValueError(f"client_step: D={D} features, the kernel takes at "
                         f"most {lib.client_step_max_features()}")
    limit = _smem_limit(xs.device.index)
    K, G = 1, 8
    if design != "v1":
        K, G, _ = plan_for(xs, C, H, B)
        K = K if ring is None else int(ring)
        G = G if group is None else int(group)
        if not 1 <= K <= H or G not in (8, 16, 32):
            raise ValueError(f"client_step: ring {K}, group {G}; want "
                             f"1..{H} and 8, 16 or 32")
    smem = lib.client_step_smem_bytes(D, B, K, G, DESIGNS[design])
    if smem > limit:
        raise ValueError(f"client_step: a block needs {smem} B of shared "
                         f"memory for b={B}, D={D}; the card allows {limit}")
    w_out = torch.empty((C, D), dtype=torch.float32, device=xs.device)
    b_out = torch.empty((C,), dtype=torch.float32, device=xs.device)
    loss = torch.empty((C,), dtype=torch.float32, device=xs.device)
    if C == 0:
        return w_out, b_out, loss
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        err = lib.client_step_launch(
            xs.data_ptr(), ys.data_ptr(), slots.data_ptr(), idx.data_ptr(),
            w.data_ptr(), b.data_ptr(),
            None if step_mask is None else step_mask.data_ptr(),
            w_out.data_ptr(), b_out.data_ptr(), loss.data_ptr(), S, N, D, C,
            H, B, float(lr), K, G, DESIGNS[design], stream)
    if err != 0:
        raise RuntimeError(f"client_step launch failed: cudaError {err}")
    if counted:
        launches += 1
    return w_out, b_out, loss
