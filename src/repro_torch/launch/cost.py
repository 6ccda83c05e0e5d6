"""The cost of one step on the meta device: flops, an HBM-traffic model,
peak bytes and collectives, the inputs of the roofline terms.

The port's counterpart of the reference's ``launch/hlo_cost.py``, under
another name because there is no HLO: the reference compiles a step and
walks the per-device program's text; the port runs the step itself, eagerly,
on tensors of the meta device (shapes and dtypes, no memory, no
arithmetic), and counts what it dispatches.

  * ``flops``       — ``FlopCounterMode``'s count of the run, made by its
                      own formulas (``torch.utils.flop_counter``'s
                      ``flop_registry``) and its own rule for an op it
                      has none for, in the meter below it
                      (``tests/test_torch_cost.py`` holds the two equal):
                      2 per multiply-add of every matrix product,
                      batched product and convolution (the ops the
                      reference counts as ``dot`` and ``convolution``),
                      the backward's and a remat's recompute included.
                      Every iteration of the step's Python loops (stacked
                      layer groups, local steps, clients, MoE groups) is
                      run, so nothing is scaled by a trip count;
  * ``bytes``       — an HBM-traffic model: for every dispatched op, its
                      tensor operands' bytes plus its results' bytes,
                      leaving out views, aliases and uninitialised
                      allocations (the reference's ``_SKIP_BYTES_OPS``) and
                      a result that aliases an operand (an in-place op).
                      The run is eager and unfused, so every intermediate
                      goes through memory: the figure is the port's own
                      traffic as it runs eagerly, not XLA's fused one, and
                      the two are not compared;
  * ``peak_bytes``  — the most bytes of storage alive at once during the
                      call, the arguments' included: every storage is
                      counted from the op that made it until its last
                      tensor dies;
  * ``collectives`` — per kind ``{count, bytes}`` under the reference's
                      ``COLLECTIVE_KINDS`` names: the calls the live
                      ``RecordingMesh`` saw (the round engine's own
                      ``all_reduce_``, ``all_gather_blocks`` and
                      ``all_to_all``), each at its result's bytes, as the
                      reference counts a collective.  No count comes from
                      a formula.

The quantities are one rank's: under a live ``RecordingMesh`` the round
engine runs as rank 0 of it.  Ops on the meta device are run once per
distinct signature and their results' shapes reused after (``_Meter``): a
step's Python loops repeat the same ops, and the meta kernels of many of
them are slow Python (a grok-1-314b round at full depth, 4 clients of 4
steps, dispatches millions of ops).  ``FlopCounterMode`` itself is not
entered: its dispatch handler cost as much again as the whole run.
"""
from __future__ import annotations

import math
import os
import sys
import weakref
from collections import defaultdict
from typing import Mapping

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.launch.mesh import Mesh
from repro_torch.sharding import current_mesh

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")

_aten = torch.ops.aten
# moves no data: an alias, or storage that nothing has written yet
_SKIP_BYTES_OPS = {
    _aten.detach.default, _aten.alias.default, _aten.lift_fresh.default,
    _aten._unsafe_view.default, _aten.empty.memory_format,
    _aten.empty_strided.default, _aten.empty_like.default,
    _aten.new_empty.default, _aten.new_empty_strided.default,
}
META = torch.device("meta")
_HERE = os.path.abspath(__file__)
_PACKAGE = os.path.dirname(os.path.dirname(_HERE)) + os.sep


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class RecordingMesh(Mesh):
    """Rank 0 of a data mesh of ``shape`` (mesh-axis sizes, e.g. ``{"pod":
    2, "data": 16}``) on the meta device: it has the collectives the
    round engine calls, and each records its kind and its result's bytes
    and returns meta tensors of the right shape.  Make it live with
    ``sharding.axis_rules(mesh, rules)``."""

    def __init__(self, shape: Mapping[str, int]):
        super().__init__("data", math.prod(shape.values()), 0, META,
                         "recording")
        self._shape = dict(shape)
        self.calls: list = []

    def __repr__(self):
        return f"RecordingMesh({self._shape}, rank 0)"

    @property
    def shape(self) -> dict:
        return dict(self._shape)

    @property
    def axis_names(self) -> tuple:
        return tuple(self._shape)

    def _record(self, kind: str, nbytes: int) -> None:
        self.calls.append((kind, int(nbytes)))

    def all_reduce_(self, x: torch.Tensor) -> torch.Tensor:
        self._record("all-reduce", _nbytes(x))
        return x

    def all_gather_blocks(self, parts: list) -> list:
        widths = [-(-int(n) // self.size) for _, n in parts]
        x0 = parts[0][0]
        row = math.prod(x0.shape[1:]) * x0.element_size()
        self._record("all-gather", self.size * sum(widths) * row)
        return [x.new_empty((int(n),) + tuple(x.shape[1:]))
                for x, n in parts]

    def all_to_all(self, send: torch.Tensor) -> torch.Tensor:
        self._record("all-to-all", _nbytes(send))
        return torch.empty_like(send)

    def barrier(self) -> None:
        pass


_PLAIN = (bool, int, float, str, torch.dtype, torch.device, torch.layout,
          torch.memory_format, type(None))


def _scan(x, key: list, tensors: list) -> bool:
    """Append ``x``'s tensors to ``tensors`` and its part of an op's memo
    key to ``key``: a tensor's shape, strides and dtype, any other
    argument itself.  False where the memo cannot be keyed: an argument of
    another type, or a tensor off the meta device (a 0-d host tensor, a
    wrapped Python number, may key it)."""
    ok = True
    for e in x:
        if isinstance(e, torch.Tensor):
            tensors.append(e)
            if e.device.type != "meta" and e.dim():
                ok = False
            key.append((e.shape, e.stride(), e.dtype))
        elif isinstance(e, (list, tuple)):
            key.append(len(e))
            ok = _scan(e, key, tensors) and ok
        elif isinstance(e, _PLAIN):
            key.append(e)
        else:
            ok = False
    return ok


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for e in x:
            yield from _tensors(e)
    elif isinstance(x, dict):
        for e in x.values():
            yield from _tensors(e)


def _call_site() -> str:
    """The innermost frame of the port's package outside this module, as
    ``path:function``."""
    f = sys._getframe(2)
    while f is not None:
        path = os.path.abspath(f.f_code.co_filename)
        if path.startswith(_PACKAGE) and path != _HERE:
            return f"{path[len(_PACKAGE):]}:{f.f_code.co_name}"
        f = f.f_back
    return "?"


class _Op:
    """What the meter needs to know of one op, found once: whether it is
    functional (its results are new tensors, so their shapes can be
    memoised), whether it moves bytes (not a view, an alias or an
    uninitialised allocation), ``FlopCounterMode``'s formula for it, and
    whether it has a CompositeImplicitAutograd decomposition."""
    __slots__ = ("functional", "moves", "flops", "composite", "name")

    def __init__(self, func):
        s = func._schema
        self.functional = (not s.is_mutable and not func.is_view
                           and len(s.returns) > 0
                           and all(r.alias_info is None
                                   and str(r.type) == "Tensor"
                                   for r in s.returns))
        self.moves = not func.is_view and func not in _SKIP_BYTES_OPS
        self.flops = flop_registry.get(func._overloadpacket)
        self.composite = self.flops is None and (
            torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), "CompositeImplicitAutograd"))
        self.name = str(func._overloadpacket)


class _Meter(TorchDispatchMode):
    """Sees every op the step dispatches: counts its flops with
    ``FlopCounterMode``'s formulas (``torch.utils.flop_counter``'s
    ``flop_registry``) and FlopCounterMode's rule for an op without one
    (its CompositeImplicitAutograd decomposition is run and counted
    instead), the bytes model and the live storages, and runs each
    functional op once per signature (its results' shapes, strides and
    dtypes reused after; views and in-place ops always run).  With
    ``attribute`` it also adds each op's bytes and flops to its call site
    in the port's package."""

    def __init__(self, attribute: bool = False):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: dict = {}
        self._memo: dict = {}
        self._ops: dict = {}
        self.rows = defaultdict(lambda: [0, 0]) if attribute else None

    def hold(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live until its last tensor dies."""
        s = t.untyped_storage()
        k = s._cdata
        if k in self._live:
            return
        n = s.nbytes()
        self._live[k] = n
        self.live_bytes += n
        if self.live_bytes > self.peak_bytes:
            self.peak_bytes = self.live_bytes
        weakref.finalize(s, self._free, k)

    def _free(self, k) -> None:
        self.live_bytes -= self._live.pop(k, 0)

    def _run(self, func, op: _Op, args, kwargs, ins: list):
        key = [id(func)]
        keyed = _scan(args, key, ins)
        if kwargs:
            keyed = _scan(kwargs.items(), key, ins) and keyed
        if not (op.functional and keyed):
            return func(*args, **kwargs)
        key = tuple(key)
        hit = self._memo.get(key)
        if hit is not None:
            outs = [torch.empty_strided(sh, st, dtype=dt, device=META)
                    for sh, st, dt in hit[1]]
            return outs[0] if hit[0] else tuple(outs)
        out = func(*args, **kwargs)
        single = isinstance(out, torch.Tensor)
        outs = [out] if single else list(out)
        if all(o.device.type == "meta" for o in outs):
            self._memo[key] = (single, [(o.shape, o.stride(), o.dtype)
                                        for o in outs])
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        op = self._ops.get(id(func))
        if op is None:
            op = self._ops[id(func)] = _Op(func)
        if op.composite:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        ins = []
        out = self._run(func, op, args, kwargs, ins)
        outs = [out] if isinstance(out, torch.Tensor) else list(
            _tensors(out))
        for o in outs:
            self.hold(o)
        flops = (op.flops(*args, **kwargs, out_val=out)
                 if op.flops is not None else 0)
        self.flops += flops
        if not op.moves:
            return out
        seen = {t.untyped_storage()._cdata for t in ins}
        n = sum(_nbytes(t) for t in ins) + sum(
            _nbytes(o) for o in outs
            if o.untyped_storage()._cdata not in seen)
        self.bytes += n
        if self.rows is not None:
            row = self.rows[f"{_call_site()} {op.name}"]
            row[0] += n
            row[1] += flops
        return out


def _measure(fn, args, attribute: bool):
    mesh = current_mesh()
    recording = mesh if isinstance(mesh, RecordingMesh) else None
    if recording is not None:
        recording.calls.clear()
    meter = _Meter(attribute)
    for t in _tensors(args):
        meter.hold(t)
    with meter:
        fn(*args)
    coll = {k: {"count": 0, "bytes": 0} for k in COLLECTIVE_KINDS}
    for kind, nbytes in (recording.calls if recording is not None else ()):
        coll[kind]["count"] += 1
        coll[kind]["bytes"] += nbytes
    return meter, coll


def analyze(fn, *args) -> dict:
    """Run ``fn(*args)`` once on its (meta) arguments and return one
    rank's ``flops``, ``bytes`` (the traffic model), ``peak_bytes``,
    ``collectives`` (the kinds seen, ``{count, bytes}`` each),
    ``collective_bytes`` and ``collective_count``; collectives are those
    of the live ``RecordingMesh``, if any."""
    meter, coll = _measure(fn, args, attribute=False)
    return {
        "flops": float(meter.flops),
        "bytes": float(meter.bytes),
        "peak_bytes": int(meter.peak_bytes),
        "collective_bytes": float(sum(v["bytes"] for v in coll.values())),
        "collective_count": float(sum(v["count"] for v in coll.values())),
        "collectives": {k: v for k, v in coll.items() if v["count"]},
    }


def profile(fn, *args, top: int = 25, by: str = "bytes") -> list:
    """Where ``fn(*args)``'s bytes and flops go (the reference's
    ``hlo_cost.profile``): ``[(site, bytes, flops)]``, a site being the
    innermost function of the port's package that dispatched the op (``?``
    where none is on the stack, as in the autograd engine's backward of a
    step called from outside the package) and the op's name, the ``top``
    largest ``by`` "bytes" or "flops"."""
    if by not in ("bytes", "flops"):
        raise ValueError(f"by must be 'bytes' or 'flops', got {by!r}")
    meter, _ = _measure(fn, args, attribute=True)
    col = 1 if by == "bytes" else 2
    rows = sorted(((k, v[0], v[1]) for k, v in meter.rows.items()),
                  key=lambda r: -r[col])
    return rows[:top]
