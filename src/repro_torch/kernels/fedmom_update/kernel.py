"""The fused server update on the card: binding and launch of
``csrc/fedmom_update.cu``.

Hopper port of the JAX package's Pallas kernel
(``repro/kernels/fedmom_update/kernel.py:61`` ``fused_flat``) and of the
tree packing around it.  The TPU kernel tiles one padded ``[rows, 128]``
stream of the concatenated leaves into VMEM; this one reads every leaf where
it lies and writes each output leaf directly (see the source note in the
``.cu`` file for the bound and the design).

``tree_plan`` cuts the leaves into chunks, (leaf, offset, length), and
groups them into tables that fit one launch's parameter block;
``fused_update_tree`` launches once per table -- once per server step for
any model of at most 24 leaves -- with no pack and no split.
``fused_update_tree_design(..., design="packed")`` keeps the first design
(pack every leaf into one stream with ``torch.cat``, one launch, split back)
as a yardstick to time the path's call against: on no path, and not
counted.  ``update_leaves`` is ``fused_update_tree`` on the trees' leaf
lists (``ops`` flattens each tree once, for its device check and the
launch).  ``fused_flat`` is the reference's flat contract, one launch over
flat float32 streams.

``launches`` counts kernel launches, added where a launch returns success:
a tree with no elements launches nothing and counts nothing.
"""
from __future__ import annotations

import ctypes
import functools
from array import array
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.tree import leaves, unflatten_like

KINDS = {"fedmom": 0, "fedavgm": 1}
DESIGNS = ("packed",)
# leaf dtypes the kernel reads and writes natively (``Leaf::codes``); other
# floating dtypes go through float32 and back, as the packed design did
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
ALIGNED = 1 << 8
# one launch's tables: (kMaxLeaves, kMaxChunks) of the .cu, and the size
# past which a launch streams (kStreamElems); both checked at load
CAPACITY = (24, 182)
STREAM_ELEMS = 1 << 22
MIN_CHUNK = 256        # elements; a shorter chunk is not worth its block
MAX_CHUNK = 1 << 30    # a chunk's length is an int32 on the card
SM_COUNT = 132         # an H100 SXM's; the wrapper passes its card's count
launches = 0


class Table(NamedTuple):
    """One launch: the tree's leaves it covers (indices, in order), each
    one's alignment flag, and its chunks as (row of the leaf in this table,
    offset, length)."""
    leaves: tuple
    aligned: tuple
    chunks: tuple


def tree_plan(sizes, aligned, capacity=CAPACITY, blocks=SM_COUNT // 2):
    """The launches of a tree whose leaves hold ``sizes`` elements:
    a list of ``Table``s.

    Every leaf is cut into chunks of ``step`` elements (its last chunk
    shorter), step a multiple of 4 so that each chunk of an aligned leaf
    starts on a 16-byte boundary.  Up to ``STREAM_ELEMS`` elements in all,
    the step is the least that (a) spreads the tree over about ``blocks``
    chunks, one block each, counting one ragged chunk a leaf, (b) is at
    least ``MIN_CHUNK``, and (c) lets a table of ``capacity[0]`` leaves hold
    all their chunks in ``capacity[1]`` entries; past it, each leaf is one
    chunk (up to ``MAX_CHUNK``), which every block of the card streams
    through.  Tables take leaves in order until one more would pass either
    capacity.  Zero-size leaves take no chunk and no table row.
    ``aligned[i]`` is leaf i's flag: all five of its pointers 16-byte
    aligned.
    """
    max_leaves, max_chunks = capacity
    live = [i for i, n in enumerate(sizes) if n > 0]
    total = sum(sizes[i] for i in live)
    spare = blocks - min(len(live), max_leaves)
    if total > STREAM_ELEMS:
        step = max(sizes[i] for i in live)
    else:
        step = max(MIN_CHUNK, -(-total // (max_chunks - max_leaves)),
                   -(-total // spare) if spare > 0 else 0)
    step = min(-(-step // 4) * 4, MAX_CHUNK)
    tables = []
    rows, flags, chunks = [], [], []
    for i in live:
        n = int(sizes[i])
        need = -(-n // step)
        if need > max_chunks:
            raise ValueError(f"fedmom_update: a leaf of {n} elements needs "
                             f"{need} chunks, a launch takes {max_chunks}")
        if rows and (len(rows) == max_leaves
                     or len(chunks) + need > max_chunks):
            tables.append(Table(tuple(rows), tuple(flags), tuple(chunks)))
            rows, flags, chunks = [], [], []
        r = len(rows)
        rows.append(i)
        flags.append(bool(aligned[i]))
        chunks.extend((r, off, min(step, n - off))
                      for off in range(0, n, step))
    if rows:
        tables.append(Table(tuple(rows), tuple(flags), tuple(chunks)))
    return tables


@functools.lru_cache(maxsize=256)
def _launch_plan(sizes, aligned, sm_count):
    """``tree_plan`` on a card of ``sm_count`` SMs, each table's chunks
    packed for the C entry: [(leaf indices, alignment flags, int64 chunk
    rows, chunk count)].  A small tree is spread over one block for every
    two SMs: on an H100 fewer, fuller blocks finished sooner than one a
    SM."""
    return [(t.leaves, t.aligned,
             array("q", [v for c in t.chunks for v in c]), len(t.chunks))
            for t in tree_plan(sizes, aligned, blocks=sm_count // 2)]


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("fedmom_update")
    lib.fedmom_update_tree_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p]
    lib.fedmom_update_tree_launch.restype = ctypes.c_int
    lib.fedmom_update_limits.argtypes = [
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_longlong)]
    lib.fedmom_update_limits.restype = None
    got = (ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong())
    lib.fedmom_update_limits(*map(ctypes.byref, got))
    limits = tuple(v.value for v in got)
    if limits != (*CAPACITY, STREAM_ELEMS):
        raise RuntimeError(f"fedmom_update: the library's limits are "
                           f"{limits} (leaves, chunks, stream elements), "
                           f"kernel.py plans for {(*CAPACITY, STREAM_ELEMS)}")
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _launch(index, sizes, ptrs, codes, kind, eta, beta, counted):
    """One launch per table of the plan, on card ``index``: leaf i holds
    ``sizes[i]`` elements at the five addresses ``ptrs[i]`` (w, state,
    delta, w', state') in the dtypes ``codes[i]`` (``Leaf::codes`` without
    the plan's alignment flag)."""
    global launches
    aligned = tuple(not (p[0] | p[1] | p[2] | p[3] | p[4]) & 15 for p in ptrs)
    sms = _sm_count(index)
    plan = _launch_plan(tuple(sizes), aligned, sms)
    if not plan:
        return
    fn = _lib().fedmom_update_tree_launch
    if torch.cuda.current_device() != index:
        with torch.cuda.device(index):
            return _launch(index, sizes, ptrs, codes, kind, eta, beta,
                           counted)
    # the current stream's handle, without building a Stream object
    stream = torch._C._cuda_getCurrentRawStream(index)
    for rows, flags, chunk_rows, n_chunks in plan:
        table = array("q")
        for i, flag in zip(rows, flags):
            table.extend(ptrs[i])
            table.append(codes[i] | (ALIGNED if flag else 0))
        err = fn(table.buffer_info()[0], len(rows),
                 chunk_rows.buffer_info()[0], n_chunks, KINDS[kind],
                 float(eta), float(beta), sms, stream)
        if err != 0:
            raise RuntimeError(f"fedmom_update launch failed: cudaError "
                               f"{err}")
        if counted:
            launches += 1


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


def _flat(w, s, delta, kind, eta, beta, counted):
    if kind not in KINDS:
        raise ValueError(f"unknown update kind {kind!r}: want {sorted(KINDS)}")
    for name, x in (("w", w), ("state", s), ("delta", delta)):
        _check(name, x, w)
    w_out = torch.empty_like(w)
    s_out = torch.empty_like(s)
    _launch(w.get_device(), [w.numel()],
            [tuple(x.data_ptr() for x in (w, s, delta, w_out, s_out))], [0],
            kind, eta, beta, counted)
    return w_out, s_out


def fused_flat(w: torch.Tensor, s: torch.Tensor, delta: torch.Tensor,
               kind: str, eta: float, beta: float):
    """One launch over flat float32 CUDA streams; returns new ``(w', s')``
    for the update ``kind`` (``"fedmom"``: s is v; ``"fedavgm"``: s is m).
    Streams of no element launch nothing."""
    return _flat(w, s, delta, kind, eta, beta, counted=True)


def _card(x):
    """The CUDA device index of ``x``, w's first leaf; raises for any other
    device."""
    index = x.get_device()
    if index < 0:
        raise ValueError(f"fedmom_update: leaf 0 of w is on {x.device}, the "
                         f"kernel takes CUDA tensors only")
    return index


def _leaf(name, i, x, index, shape):
    """Leaf i of tree ``name`` as the kernel reads it: on card ``index``,
    contiguous, in a native dtype (other floating dtypes in float32), of
    w's leaf's ``shape`` (None: it is w's leaf)."""
    if (x.get_device() == index and x.dtype in DTYPE_CODES
            and x.is_contiguous() and (shape is None or x.shape == shape)):
        return x
    if x.get_device() != index:
        where = ("the kernel takes CUDA tensors only" if not x.is_cuda else
                 f"w's first leaf is on cuda:{index}")
        raise ValueError(f"fedmom_update: leaf {i} of {name} is on "
                         f"{x.device}, {where}")
    if shape is not None and x.shape != shape:
        raise ValueError(f"fedmom_update: leaf {i} of {name} has shape "
                         f"{tuple(x.shape)}, w's has {tuple(shape)}")
    if x.dtype not in DTYPE_CODES:
        if not x.is_floating_point():
            raise ValueError(f"fedmom_update: leaf {i} of {name} is "
                             f"{x.dtype}, the kernel takes floating leaves")
        x = x.to(torch.float32)
    return x if x.is_contiguous() else x.contiguous()


def _outputs(xs, sizes):
    """Fresh outputs shaped and typed as ``xs`` (``sizes`` elements each):
    one allocation, each leaf a view that starts on a 16-byte boundary.
    Returns the views and their addresses."""
    dtype = xs[0].dtype
    if all(x.dtype == dtype for x in xs):
        itemsize = xs[0].element_size()
        per = 16 // itemsize
        offsets, total = [], 0
        for n in sizes:
            offsets.append(total)
            total += -(-n // per) * per
        buf = torch.empty(total, dtype=dtype, device=xs[0].device)
        base = buf.data_ptr()
        return ([buf.as_strided(x.shape, x.stride(), o)
                 for x, o in zip(xs, offsets)],
                [base + o * itemsize for o in offsets])
    offsets, total = [], 0
    for x, n in zip(xs, sizes):
        offsets.append(total)
        total += -(-n * x.element_size() // 16) * 16
    buf = torch.empty(total, dtype=torch.uint8, device=xs[0].device)
    base = buf.data_ptr()
    return ([buf[o:o + n * x.element_size()].view(x.dtype).view(x.shape)
             for x, n, o in zip(xs, sizes, offsets)],
            [base + o for o in offsets])


def update_leaves(lw, ls, ld, *, eta: float, beta: float,
                  kind: str = "fedmom", fuse_tree: bool = True):
    """``fused_update_tree`` on the trees' leaf lists (``tree.leaves``
    order): returns the lists of new w and state leaves."""
    if kind not in KINDS:
        raise ValueError(f"unknown update kind {kind!r}: want {sorted(KINDS)}")
    if not len(lw) == len(ls) == len(ld):
        raise ValueError(f"fedmom_update: trees of {len(lw)}, {len(ls)} and "
                         f"{len(ld)} leaves")
    if not lw:
        return [], []
    index = _card(lw[0])
    xw = [_leaf("w", i, x, index, None) for i, x in enumerate(lw)]
    xs = [_leaf("state", i, x, index, w.shape)
          for i, (x, w) in enumerate(zip(ls, lw))]
    xd = [_leaf("delta", i, x, index, w.shape)
          for i, (x, w) in enumerate(zip(ld, lw))]
    sizes = [x.numel() for x in xw]
    ow, pw = _outputs(xw, sizes)
    os_, ps = _outputs(xs, sizes)
    ptrs = [(a.data_ptr(), b.data_ptr(), c.data_ptr(), x, y)
            for a, b, c, x, y in zip(xw, xs, xd, pw, ps)]
    codes = [DTYPE_CODES[a.dtype] | DTYPE_CODES[b.dtype] << 2
             | DTYPE_CODES[c.dtype] << 4 for a, b, c in zip(xw, xs, xd)]
    if fuse_tree:
        _launch(index, sizes, ptrs, codes, kind, eta, beta, counted=True)
    else:
        for leaf in zip(sizes, ptrs, codes):
            _launch(index, *([v] for v in leaf), kind, eta, beta,
                    counted=True)
    # leaves of another floating dtype went through float32: back again
    ow = [o if o.dtype == x.dtype else o.to(x.dtype) for o, x in zip(ow, lw)]
    os_ = [o if o.dtype == x.dtype else o.to(x.dtype)
           for o, x in zip(os_, ls)]
    return ow, os_


def fused_update_tree(w_tree, s_tree, d_tree, *, eta: float, beta: float,
                      kind: str = "fedmom", fuse_tree: bool = True):
    """The fused update over parameter trees of CUDA tensors on one card:
    every leaf read where it lies and every output leaf written directly,
    one launch per table of ``tree_plan`` (``fuse_tree=False``: one launch
    per leaf, as the reference's per-leaf path).  Outputs follow the input
    leaves' dtypes; each output tree is one fresh allocation, so no output
    aliases an input."""
    lw = leaves(w_tree)
    if not lw:
        return w_tree, s_tree
    ow, os_ = update_leaves(lw, leaves(s_tree), leaves(d_tree), eta=eta,
                            beta=beta, kind=kind, fuse_tree=fuse_tree)
    return unflatten_like(w_tree, ow), unflatten_like(s_tree, os_)


def _pack(xs):
    flat = [x.reshape(-1).to(torch.float32) for x in xs]
    return torch.cat(flat) if len(flat) > 1 else flat[0].contiguous()


def _unpack(flat, like):
    sizes = [x.numel() for x in like]
    return [p.reshape(x.shape).to(x.dtype)
            for p, x in zip(torch.split(flat, sizes), like)]


def fused_update_tree_design(w_tree, s_tree, d_tree, *, eta: float,
                             beta: float, kind: str = "fedmom",
                             design: str = "packed"):
    """The update by an earlier design, on the contract of
    ``fused_update_tree``, not counted in ``launches``: ``"packed"``
    concatenates every leaf into one float32 stream with ``torch.cat``,
    launches once over it and splits the result back."""
    if design not in DESIGNS:
        raise ValueError(f"fedmom_update: design {design!r}, want one of "
                         f"{list(DESIGNS)}")
    lw, ls, ld = leaves(w_tree), leaves(s_tree), leaves(d_tree)
    if not lw:
        return w_tree, s_tree
    wn, sn = _flat(_pack(lw), _pack(ls), _pack(ld), kind, eta, beta,
                   counted=False)
    return (unflatten_like(w_tree, _unpack(wn, lw)),
            unflatten_like(s_tree, _unpack(sn, ls)))
