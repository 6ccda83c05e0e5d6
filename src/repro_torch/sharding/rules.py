"""Logical-axis sharding.

Model and round code name *logical* axes ('clients', 'embed', 'heads',
...), never devices: ``init`` returns a parameter tree with its twin tree
of logical-axis tuples (``param_axes``), and a rule table maps logical
axes to mesh axes.  ``axis_rules(mesh, rules)`` makes a mesh and a table
live for the code under it (thread-local, as in the reference); outside
it ``shard``, ``shard_tree`` and ``put_logical`` are identities, so the
same code runs on one device and across ranks.

Rule tables (the reference's, verbatim):

- ``FED_MESH_RULES``  — federated ``mesh`` placement: active clients tile the
  ('pod','data') axes, each client's replica is tensor-parallel on 'model'.
- ``FSDP_RULES``      — ``scan`` placement for 72B/314B: parameters are
  fully sharded over ('pod','data') x 'model'; clients are sequential.
- ``REPLICATED_SERVER_RULES`` — paper-faithful baseline where the server
  master state is replicated over ('pod','data') (only 'model'-sharded).

The port's live mesh is ``launch.mesh.Mesh``: one ``torch.distributed``
rank per device along one axis, each rank running the same program.  Of
the tables it places only the 'clients' axis: under a live mesh a
'clients' dimension holds this rank's contiguous block of the clients
(``put_logical`` cuts it; the round engine splits its cohort the same
way), and every other logical axis stays replicated.  The other entries
(the 'model' axis, and 'data' on weights and server state) are tables and
arithmetic: ``tree_shardings`` maps a model's logical axes to each leaf's
mesh axes and per-device shape, and the dry run (``launch/dryrun.py``)
sums what a device of a production mesh holds.  ``logical_spec`` takes
the mesh as its axis sizes (``{"pod": 2, "data": 16, "model": 16}``, or a
``Mesh``'s ``shape``) and returns a tuple of mesh-axis entries where the
reference returns a ``PartitionSpec``; ``logical_sharding`` returns a
``MeshSharding`` where the reference returns a ``NamedSharding``.
"""
from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass
from typing import Any, Mapping, Optional, Sequence

import torch

from repro_torch.tree import _is_namedtuple

AxisRules = Mapping[str, object]  # logical axis -> mesh axis | tuple | None

# Mesh-axis names; 'pod' only exists on the multi-pod mesh.  Rules reference
# ('pod', 'data') and are filtered against the live mesh's axis names.
_DP = ("pod", "data")

FED_MESH_RULES: AxisRules = {
    "clients": _DP,        # leading axis of per-client params/batches
    "batch": _DP,          # serving batch
    "seq": None,
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "qkv": None,
    "mlp": "model",
    "vocab": "model",
    "expert": "model",
    "expert_mlp": None,
    "moe_group": None,     # group axis of the grouped MoE dispatch
    "capacity": None,
    "rnn": "model",
    "conv": None,
    "layers": None,
    "lora": None,
    # streaming shard cache: slot order is LRU-arbitrary (a round's clients
    # land in unrelated slots of unrelated n_k size tiers), so every tier's
    # [slots_t, n_tier, ...] corpus stays replicated — the in-scan
    # (tier, slot) gather would otherwise cross data shards every round
    "cache_slots": None,
    # server master/momentum state: ZeRO-shard the embed dim over data
    "opt_embed": _DP,
}

# FSDP / scan placement: weights sharded over data on 'embed' too.
FSDP_RULES: AxisRules = dict(
    FED_MESH_RULES,
    embed=_DP,
    clients=None,          # clients are a scan axis, not a mesh axis
    moe_group=_DP,         # align token-routing groups with the data shards
)

# Paper-faithful replicated server state (baseline for the ZeRO hillclimb).
REPLICATED_SERVER_RULES: AxisRules = dict(FED_MESH_RULES, opt_embed=None)


class _Ctx(threading.local):
    mesh: Optional[Any] = None
    rules: Optional[AxisRules] = None


_ctx = _Ctx()


@contextlib.contextmanager
def axis_rules(mesh, rules: Optional[AxisRules]):
    """Make ``mesh`` (a ``launch.mesh.Mesh``, or ``None``) and ``rules``
    live for the code under the ``with``; the previous pair comes back on
    exit."""
    prev = (_ctx.mesh, _ctx.rules)
    _ctx.mesh, _ctx.rules = mesh, rules
    try:
        yield
    finally:
        _ctx.mesh, _ctx.rules = prev


def current_mesh():
    return _ctx.mesh


def current_rules() -> Optional[AxisRules]:
    return _ctx.rules


def _filter_axes(entry, mesh_axes) -> object:
    """Drop mesh axes that don't exist on the live mesh ('pod' on 1-pod)."""
    if entry is None:
        return None
    if isinstance(entry, str):
        return entry if entry in mesh_axes else None
    got = tuple(a for a in entry if a in mesh_axes)
    if not got:
        return None
    return got if len(got) > 1 else got[0]


def logical_spec(axes: Sequence[Optional[str]], rules: AxisRules,
                 mesh: Mapping[str, int],
                 shape: Optional[Sequence[int]] = None) -> tuple:
    """Map logical axes to mesh-axis entries, one per dimension (``None``,
    an axis name, or a tuple of names): the reference's ``PartitionSpec``
    as a tuple.  ``mesh`` maps each mesh-axis name to its size.

    A mesh axis appears at most once.  When ``shape`` is given, mesh axes
    that do not evenly divide a dimension are dropped (from the innermost
    axis outward), as the reference does for jit's in_shardings: e.g.
    kv_heads=1 over a 16-way 'model' axis degrades to replication; a (2,
    ...) 'clients' dim over ('pod','data')=(2,16) keeps 'pod' and drops
    'data'.
    """
    sizes = dict(mesh)
    used: set = set()
    out = []
    for i, ax in enumerate(axes):
        entry = None if ax is None else rules.get(ax)
        entry = _filter_axes(entry, sizes)
        if entry is not None:
            flat = (entry,) if isinstance(entry, str) else tuple(entry)
            flat = tuple(a for a in flat if a not in used)
            if shape is not None:
                while flat:
                    prod = 1
                    for a in flat:
                        prod *= sizes[a]
                    if shape[i] % prod == 0:
                        break
                    flat = flat[:-1]
            used.update(flat)
            entry = (flat if len(flat) > 1 else (flat[0] if flat else None))
        out.append(entry)
    return tuple(out)


@dataclass(frozen=True)
class MeshSharding:
    """One array's placement on a mesh: ``spec`` holds one mesh-axis entry
    per dimension (``None``, an axis name, or a tuple of names), ``mesh``
    the mesh's ``(axis, size)`` pairs."""
    spec: tuple
    mesh: tuple

    def shard_shape(self, shape: Sequence[int]) -> tuple:
        """The per-device shape of an array of ``shape``: each dimension
        divided by the product of its mesh axes' sizes, which must divide
        it (as the reference's ``NamedSharding.shard_shape`` requires)."""
        sizes = dict(self.mesh)
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more entries than shape "
                             f"{tuple(shape)} has dimensions")
        out = list(shape)
        for i, entry in enumerate(self.spec):
            if entry is None:
                continue
            axes = (entry,) if isinstance(entry, str) else tuple(entry)
            n = math.prod(sizes[a] for a in axes)
            if out[i] % n:
                raise ValueError(f"dimension {i} of {tuple(shape)} is not "
                                 f"divisible by {axes} = {n}")
            out[i] //= n
        return tuple(out)


def logical_sharding(axes: Sequence[Optional[str]], rules: AxisRules,
                     mesh: Mapping[str, int],
                     shape: Optional[Sequence[int]] = None) -> MeshSharding:
    """``logical_spec``'s entries with the mesh they refer to."""
    return MeshSharding(logical_spec(axes, rules, mesh, shape),
                        tuple(dict(mesh).items()))


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def _map_axes(fn, axes_tree):
    if _is_axes(axes_tree):
        return fn(axes_tree)
    if isinstance(axes_tree, dict):
        return {k: _map_axes(fn, v) for k, v in axes_tree.items()}
    kids = [_map_axes(fn, v) for v in axes_tree]
    return (type(axes_tree)(*kids) if _is_namedtuple(axes_tree)
            else type(axes_tree)(kids))


def tree_shardings(logical_tree: Any, rules: AxisRules,
                   mesh: Mapping[str, int], shapes_tree: Any = None) -> Any:
    """Map a tree of logical-axis tuples to ``MeshSharding``s.  With
    ``shapes_tree`` (the matching tree of tensors, meta ones included),
    mesh axes that do not divide a dimension are dropped, as the
    reference's does for jit's in_shardings."""
    if shapes_tree is None:
        return _map_axes(lambda axes: logical_sharding(axes, rules, mesh),
                         logical_tree)
    return _map_up_to(
        lambda x, axes: logical_sharding(axes, rules, mesh, x.shape),
        shapes_tree, logical_tree)


def _live():
    if _ctx.mesh is None or _ctx.rules is None:
        return None
    return _ctx.mesh


def put_logical(x, *axes: Optional[str], device=None) -> torch.Tensor:
    """``x`` (a host array or tensor) on ``device``: under a live mesh and
    rules, a dimension whose logical axis maps onto the mesh holds this
    rank's contiguous block of ceil(size / n) (the last ranks' blocks may
    be shorter or empty); outside one, the whole of ``x``.  The device
    plane packs its corpus through it."""
    x = torch.as_tensor(x)
    mesh = _live()
    if mesh is not None:
        spec = logical_spec(axes, _ctx.rules, mesh.shape)
        for dim, entry in enumerate(spec):
            if entry is not None:
                lo, hi = mesh.block(x.shape[dim])
                # a copy of the block alone: a view would keep the whole
                # of x alive on a CPU rank
                x = x.narrow(dim, lo, hi - lo).clone()
    return x if device is None else x.to(device)


def shard(x, *axes: Optional[str]):
    """Constrain ``x``'s placement by logical axes: the identity outside a
    mesh.  Under a live mesh the rank must match ``x``'s, and ``x`` is
    already placed (a 'clients' dimension holds this rank's block), so it
    comes back as it is."""
    if _live() is None:
        return x
    if len(axes) != x.dim():
        raise ValueError(f"rank mismatch: {axes} vs shape {tuple(x.shape)}")
    return x


def shard_tree(tree: Any, axes_tree: Any, prefix: tuple = ()) -> Any:
    """Constrain a whole tree by its logical-axes twin tree (``prefix``
    prepends axes, e.g. ``('clients',)`` for the per-client replicas): the
    tree itself outside a mesh, ``shard`` of every leaf under one."""
    if _live() is None:
        return tree
    return _map_up_to(lambda x, axes: shard(x, *(prefix + tuple(axes))),
                      tree, axes_tree)


def _map_up_to(fn, tree, axes_tree):
    """``fn(leaf, axes)`` over ``tree``, whose every leaf sits where
    ``axes_tree`` holds that leaf's tuple of logical axes."""
    if isinstance(tree, dict):
        return {k: _map_up_to(fn, tree[k], axes_tree[k]) for k in tree}
    if isinstance(tree, (tuple, list)):
        kids = [_map_up_to(fn, a, b) for a, b in zip(tree, axes_tree)]
        return type(tree)(*kids) if _is_namedtuple(tree) else type(tree)(
            kids)
    return None if tree is None else fn(tree, axes_tree)


def spmd_client_axes() -> object:
    """Mesh axes the 'clients' logical axis maps to on the live mesh, or
    None outside a mesh."""
    mesh = _live()
    if mesh is None:
        return None
    return _filter_axes(_ctx.rules.get("clients"), mesh.shape)


def client_axis_size() -> int:
    """Number of shards the 'clients' logical axis splits into on the live
    mesh: the product of its mapped mesh-axis sizes.  1 outside a mesh
    context (or when the rules map 'clients' to no live axis), so callers
    can divide cohort and memory math by it unconditionally."""
    entry = spmd_client_axes()
    if entry is None:
        return 1
    axes = (entry,) if isinstance(entry, str) else tuple(entry)
    n = 1
    for a in axes:
        n *= _ctx.mesh.shape[a]
    return n
