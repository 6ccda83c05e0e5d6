"""The port's recorder: host spans, device stamps and counters.

Off by default.  ``with spans.recording(device=False) as rec:`` turns it on
for a block; afterwards

* ``rec.spans`` holds the host spans in the order they opened, each a
  ``Span(name, start_ns, end_ns, parent, id, thread, seq)``: ``parent`` is
  the ``seq`` of the span it opened under on its thread (spans nest
  through a per-thread stack), ``id`` the chunk or round it serves (the
  chunk's first round, or the round; inherited from the parent when not
  given), ``thread`` the ``threading.get_ident()`` of its thread;
* ``rec.counters`` the counters, name -> total;
* ``rec.device`` the device spans, round -> {name: ns}: with
  ``device=True`` each layer boundary of a round writes a device clock
  stamp, in stream order, into a small buffer that travels with the
  round's metrics (``stamps``) and is read where the trainer already reads
  them.

Off, each call site costs one check of the module's ``_rec``: it enqueues
no device work and allocates nothing, and the chunk graphs are the ones
the port captures without the recorder (the device flag keys them).  On,
the trajectory is bit-equal: stamps read a clock and write their own
buffer alone.

One clock with the device trace: host spans are stamped with the clock
``torch.profiler``'s events carry, the Unix time in ns (the profiler
converts its approximate clock to it; ``tests/test_torch_spans.py``
holds a span inside the profiler's event of the same name).  While a
profiler is active each host span also opens a
``torch.profiler.record_function`` of its name, so the profiler's own
trace shows the spans beside the kernels.

Device stamps: a span's start adds ``-t`` and its end ``+t`` into its
slot of ``[R, len(DEVICE_SPANS), 2]`` int64 (mod 2**64), so a span
stamped many times a round (``moe``: every MoE layer's forward and
backward) sums its intervals.  On the card ``t`` is ``%globaltimer``
read by a one-thread kernel (``csrc/stamp.cu``), which a captured chunk
replays with the rest of the round; on the CPU it is the host clock.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import Counter, namedtuple
from typing import Optional

import numpy as np
import torch

DEVICE_SPANS = ("sample", "gather", "local_update", "aggregate",
                "server_step", "moe")
_SLOT = {name: i for i, name in enumerate(DEVICE_SPANS)}

Span = namedtuple("Span", "name start_ns end_ns parent id thread seq")

_now_ns = time.time_ns        # the clock of torch.profiler's events
_NULL = contextlib.nullcontext()
_rec: Optional["Recorder"] = None     # the active recorder; None = off


class Recorder:
    """What one ``recording`` block recorded (see the module note)."""

    def __init__(self, device: bool):
        self.device_on = bool(device)
        self.spans: list = []
        self.counters: Counter = Counter()
        self.device: dict = {}
        self._seq = itertools.count()
        self._local = threading.local()
        self._frame = None            # (_Slots of the stamp buffer, row)

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st


class _HostSpan:
    __slots__ = ("rec", "name", "id", "seq", "parent", "start", "prof")

    def __init__(self, rec: Recorder, name: str, id_):
        self.rec, self.name, self.id = rec, name, id_

    def __enter__(self):
        st = self.rec._stack()
        top = st[-1] if st else None
        self.parent = None if top is None else top.seq
        if self.id is None and top is not None:
            self.id = top.id
        self.seq = next(self.rec._seq)
        self.prof = None
        if torch._C._autograd._profiler_enabled():
            self.prof = torch.profiler.record_function(self.name)
            self.prof.__enter__()
        st.append(self)
        self.start = _now_ns()
        return self

    def __exit__(self, *exc):
        end = _now_ns()
        self.rec._stack().pop()
        if self.prof is not None:
            self.prof.__exit__(*exc)
        self.rec.spans.append(Span(self.name, self.start, end, self.parent,
                                   self.id, threading.get_ident(),
                                   self.seq))
        return False


@contextlib.contextmanager
def recording(device: bool = False):
    """Record host spans and counters (and, with ``device``, device
    stamps) for the block; yields the ``Recorder``, whose spans are sorted
    by the order they opened once the block ends."""
    global _rec
    if _rec is not None:
        raise RuntimeError("a recording is already active")
    rec = _rec = Recorder(device)
    try:
        yield rec
    finally:
        _rec = None
        rec.spans.sort(key=lambda s: s.seq)


def span(name: str, id_=None):
    """A host span around the ``with`` block (a shared no-op when off)."""
    rec = _rec
    return _NULL if rec is None else _HostSpan(rec, name, id_)


def count(name: str, n: int = 1):
    """Add ``n`` to a counter."""
    rec = _rec
    if rec is not None:
        rec.counters[name] += int(n)


def device_on() -> bool:
    """Whether device stamps are recorded (it keys the chunk graphs)."""
    rec = _rec
    return rec is not None and rec.device_on


# ---------------------------------------------------------------------------
# device stamps
# ---------------------------------------------------------------------------
def stamps(n_rounds: int, device) -> Optional[torch.Tensor]:
    """A zeroed ``[n_rounds, len(DEVICE_SPANS), 2]`` int64 stamp buffer on
    ``device`` when device stamps are recorded, else None."""
    if not device_on():
        return None
    return torch.zeros((n_rounds, len(DEVICE_SPANS), 2), dtype=torch.int64,
                       device=device)


class _Slots:
    """Where a stamp buffer's slots lie, taken outside any transform: a
    stamp may run under ``torch.func.grad`` or ``vmap``, where even
    ``.numpy()`` or an index of a plain tensor reaches the dispatcher,
    which wraps it.  A CUDA buffer is kept as its address and strides (the
    stamp kernel writes there), a CPU one as its words."""
    __slots__ = ("buf", "words", "base", "strides", "index")

    def __init__(self, buf: torch.Tensor):
        self.buf = buf                 # keeps the memory alive
        cuda = buf.device.type == "cuda"
        self.words = None if cuda else buf.numpy().view(np.uint64)
        self.base = buf.data_ptr()
        self.strides = buf.stride()
        self.index = buf.device.index

    def address(self, at: tuple) -> int:
        return self.base + 8 * sum(i * s for i, s in zip(at, self.strides))


@contextlib.contextmanager
def _framed(rec: Recorder, buf: torch.Tensor, r: int):
    prev, rec._frame = rec._frame, (_Slots(buf), r)
    try:
        yield
    finally:
        rec._frame = prev


def frame(buf: Optional[torch.Tensor], r: int):
    """Stamps inside the block go to row ``r`` of ``buf`` (a no-op for
    ``buf`` None).  The frame is the recorder's, not a thread's: the
    autograd engine runs a card's backward on a thread of its own."""
    rec = _rec
    if buf is None or rec is None:
        return _NULL
    return _framed(rec, buf, r)


def _stamp(rec: Recorder, name: str, end: bool):
    slots, r = rec._frame
    at = (r, _SLOT[name], int(end))
    if slots.words is None:
        from repro_torch.kernels import stamp as stamp_kernel
        stamp_kernel.launch(slots.address(at), slots.index, end)
        return
    t = _now_ns() if end else -_now_ns()
    slots.words[at] = (int(slots.words[at]) + t) % (1 << 64)


class _DeviceSpan:
    __slots__ = ("rec", "name")

    def __init__(self, rec: Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        _stamp(self.rec, self.name, False)
        return self

    def __exit__(self, *exc):
        _stamp(self.rec, self.name, True)
        return False


def _framed_rec() -> Optional[Recorder]:
    rec = _rec
    return rec if rec is not None and rec._frame is not None else None


def device_span(name: str):
    """Stamp the start and the end of the block on the device, into the
    current frame's row (a shared no-op when off or outside a frame)."""
    rec = _framed_rec()
    return _NULL if rec is None else _DeviceSpan(rec, name)


class _Mark(torch.autograd.Function):
    """The identity, whose backward stamps one end of a device span: the
    backward of whatever lies between a pair of marks is timed."""
    generate_vmap_rule = True

    @staticmethod
    def forward(x, name, end):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.name, ctx.end = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        rec = _framed_rec()
        if rec is not None:
            _stamp(rec, ctx.name, ctx.end)
        return g, None, None


def backward_span(x: torch.Tensor, name: str, end: bool) -> torch.Tensor:
    """``x``, marked so that the backward reaching it stamps ``name``'s
    start (``end`` False: put it on a block's output) or end (``end``
    True: on its input); ``x`` itself when off, outside a frame, or where
    no gradient flows into ``x``."""
    if _framed_rec() is None or not (torch.is_grad_enabled()
                                     and x.requires_grad):
        return x
    return _Mark.apply(x, name, end)


def stamp_ns(stamps_host) -> np.ndarray:
    """``[R, S]`` ns of each device span from a stamp buffer on the host,
    -1 where the span was not stamped."""
    a = np.asarray(stamps_host).astype(np.int64)
    u = a.view(np.uint64)
    ns = (u[..., 0] + u[..., 1]).view(np.int64)
    return np.where(a[..., 0] != 0, ns, -1)


def device_rounds(t0: int, stamps_host):
    """Book a read-back stamp buffer of rounds ``t0 ..`` into
    ``rec.device``."""
    rec = _rec
    if rec is None or stamps_host is None:
        return
    for r, row in enumerate(stamp_ns(stamps_host)):
        rec.device[int(t0) + r] = {name: int(ns) for name, ns
                                   in zip(DEVICE_SPANS, row) if ns >= 0}
