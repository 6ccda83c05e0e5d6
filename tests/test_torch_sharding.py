"""The port's logical-axis sharding (``sharding/rules.py``), ``MeshSpec``
and ``MeshShardedCache`` against the JAX package's, on the CPU and without
a process group.

- The rule tables are the reference's, and ``logical_spec`` gives the
  reference's ``PartitionSpec`` entries on the axis names and mesh sizes
  of ``tests/test_sharding.py`` (the 'pod' filter, one use of a mesh axis,
  divisibility) and over a grid of every rule table and logical axis.
- The thread-local context: no-ops outside a mesh, the rank check and the
  'clients' axis under one (a ``Mesh`` of any size places data without a
  group; only its collectives need one), ``put_logical``'s blocks.
- ``MeshSpec`` validation, hashing and its launch message; ``ExecutionPlan``
  takes only a ``MeshSpec``; NCCL ranks beyond the visible cards raise.
- ``MeshShardedCache`` equals the reference's on the same host containers:
  resident sets per shard, counters, capacity, and the composed view's
  slot tables and rows (the reference's three cache tests, held directly).
"""
import itertools

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.data import stream as jstream  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402
from repro_torch.data import stream as tstream  # noqa: E402
from repro_torch.launch.mesh import Mesh, MeshSpec, spawn  # noqa: E402
from repro_torch.launch.plan import ExecutionPlan, PlanError  # noqa: E402
from repro_torch.sharding import rules as trules  # noqa: E402

TABLES = ("FED_MESH_RULES", "FSDP_RULES", "REPLICATED_SERVER_RULES")
# tests/test_sharding.py's meshes (the one-pod and the "16" meshes over a
# device count of 1 and 8) and its abstract production mesh
MESHES = ({"data": 1, "model": 1}, {"data": 8, "model": 1},
          {"pod": 1, "data": 8, "model": 1},
          {"pod": 2, "data": 16, "model": 16})


def _abstract(sizes):
    return AbstractMesh(tuple(sizes.values()), tuple(sizes))


def _jax_spec(axes, table, sizes, shape=None):
    return tuple(jrules.logical_spec(axes, getattr(jrules, table),
                                     _abstract(sizes), shape))


@pytest.mark.parametrize("table", TABLES)
def test_rule_tables_are_the_references(table):
    assert dict(getattr(trules, table)) == dict(getattr(jrules, table))


@pytest.mark.parametrize("sizes", MESHES, ids=lambda s: "x".join(
    f"{k}{v}" for k, v in s.items()))
@pytest.mark.parametrize("table", TABLES)
def test_logical_spec_matches_reference_on_every_axis_pair(table, sizes):
    """Every ordered pair of the table's logical axes (and None), with and
    without shapes that divide or do not divide the mesh axes."""
    names = sorted(getattr(trules, table)) + [None]
    for axes in itertools.product(names, repeat=2):
        for shape in (None, (2, 7), (32, 64), (1, 5120)):
            want = _jax_spec(axes, table, sizes, shape)
            assert trules.logical_spec(axes, getattr(trules, table), sizes,
                                       shape) == want, (axes, shape)


def test_logical_spec_reference_cases():
    """tests/test_sharding.py's cases, spelled as tuples."""
    fed, fsdp = trules.FED_MESH_RULES, trules.FSDP_RULES
    one_pod = {"data": 1, "model": 1}
    assert trules.logical_spec(("embed", "mlp"), fed, one_pod) == (
        None, "model")
    assert trules.logical_spec(("clients", None), fed, one_pod) == (
        "data", None)
    assert trules.logical_spec(("mlp", "vocab"), fed,
                               {"pod": 1, "data": 1, "model": 1}) == (
        "model", None)
    prod = {"pod": 2, "data": 16, "model": 16}
    assert trules.logical_spec(("kv_heads", "head_dim"), fed, prod,
                               shape=(1, 128)) == (None, None)
    assert trules.logical_spec(("embed", "heads", "head_dim"), fed, prod,
                               shape=(5120, 40, 128)) == (None, None, None)
    assert trules.logical_spec(("embed", "heads", "head_dim"), fed, prod,
                               shape=(8192, 64, 128)) == (None, "model",
                                                          None)
    assert trules.logical_spec(("clients", None), fed, prod,
                               shape=(2, 7)) == ("pod", None)
    assert trules.logical_spec(("embed", "mlp"), fsdp, one_pod)[0] in (
        "data", ("data",))


# ---------------------------------------------------------------------------
# the live-mesh context
# ---------------------------------------------------------------------------
def _mesh(size, rank=0, axis="data"):
    return Mesh(axis, size, rank, "cpu", "gloo")


def test_no_active_mesh_noops():
    assert trules.current_mesh() is None and trules.current_rules() is None
    assert trules.spmd_client_axes() is None
    assert trules.client_axis_size() == 1
    x = torch.arange(6.0).reshape(2, 3)
    assert trules.shard(x, "clients", "embed") is x
    tree = {"a": x}
    assert trules.shard_tree(tree, {"a": ("embed",)}) is tree
    y = trules.put_logical(np.ones((2, 3), np.float32), "clients", None)
    assert isinstance(y, torch.Tensor) and y.shape == (2, 3)


def test_shard_rank_mismatch_raises_under_a_mesh():
    with trules.axis_rules(_mesh(2), trules.FED_MESH_RULES):
        with pytest.raises(ValueError, match="rank mismatch"):
            trules.shard(torch.ones((2, 2)), "batch")
        with pytest.raises(ValueError, match="rank mismatch"):
            trules.shard_tree({"w": torch.ones(3)}, {"w": ("embed",)},
                              prefix=("clients",))
        x = torch.ones((4, 3))
        assert trules.shard(x, "clients", "embed") is x


def test_clients_rule_filters_to_live_axes():
    with trules.axis_rules(_mesh(4), trules.FED_MESH_RULES):
        assert trules.spmd_client_axes() == "data"   # 'pod' dropped
        assert trules.client_axis_size() == 4
    with trules.axis_rules(_mesh(2, axis="pod"), trules.FED_MESH_RULES):
        assert trules.spmd_client_axes() == "pod"
        assert trules.client_axis_size() == 2


def test_clients_rule_mapped_to_no_live_axis():
    rules = dict(trules.FED_MESH_RULES, clients=("pod",))
    with trules.axis_rules(_mesh(4, rank=1), rules):
        assert trules.spmd_client_axes() is None
        assert trules.client_axis_size() == 1
        y = trules.put_logical(np.arange(8.0), "clients")
        assert y.tolist() == list(np.arange(8.0))   # replicated


@pytest.mark.parametrize("size,rank,want", [(4, 0, [0, 1, 2]),
                                            (4, 3, [9]), (3, 2, [8, 9]),
                                            (8, 7, []), (1, 0, list(
                                                range(10)))])
def test_put_logical_keeps_this_ranks_block(size, rank, want):
    """A 'clients' dimension holds the rank's contiguous block of
    ceil(K/n) (the last ranks' shorter or empty); others stay whole."""
    x = np.arange(10.0)[:, None] * np.ones((1, 3))
    with trules.axis_rules(_mesh(size, rank), trules.FED_MESH_RULES):
        y = trules.put_logical(x, "clients", None)
        z = trules.put_logical(x, "embed", None)
    assert y[:, 0].tolist() == want and y.shape[1] == 3
    assert z.shape == (10, 3)


def test_context_restored_after_exit():
    with trules.axis_rules(_mesh(2), trules.FED_MESH_RULES):
        assert trules.client_axis_size() == 2
        with trules.axis_rules(None, None):
            assert trules.client_axis_size() == 1
        assert trules.client_axis_size() == 2
    assert trules.current_mesh() is None and trules.client_axis_size() == 1


@pytest.mark.parametrize("n,size", [(7, 4), (8, 4), (3, 4), (1, 2), (0, 3)])
def test_mesh_blocks_partition_in_order(n, size):
    blocks = [_mesh(size, r).block(n) for r in range(size)]
    assert blocks[0][0] == 0 and blocks[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))
    assert all(hi - lo <= -(-n // size) for lo, hi in blocks)


# ---------------------------------------------------------------------------
# MeshSpec and the plan field
# ---------------------------------------------------------------------------
def test_meshspec_validates_and_hashes():
    with pytest.raises(ValueError, match="positive int"):
        MeshSpec(devices=0)
    with pytest.raises(ValueError, match="positive int"):
        MeshSpec(devices=2.0)
    with pytest.raises(ValueError, match="axis"):
        MeshSpec(devices=2, axis="")
    assert hash(MeshSpec(devices=2)) == hash(MeshSpec(devices=2))
    assert MeshSpec(devices=2) != MeshSpec(devices=2, axis="pod")
    assert MeshSpec().n_devices() == 1          # no process group: one rank


def test_meshspec_build_rejects_oversized_mesh():
    with pytest.raises(ValueError, match="wants 2 ranks .* no process "
                                         "group.*spawn"):
        MeshSpec(devices=2).build("cpu")


def test_plan_rejects_non_meshspec():
    with pytest.raises(PlanError, match="MeshSpec"):
        ExecutionPlan(mesh=4)
    assert ExecutionPlan(mesh=MeshSpec(devices=4)).mesh.devices == 4


def test_nccl_ranks_beyond_the_cards_raise():
    with pytest.raises(ValueError, match="NCCL ranks need 2 cards"):
        spawn(print, 2, device="cuda")


@pytest.mark.parametrize("n", [1, 2, 4])
def test_auto_prices_the_streaming_cache_per_rank(n):
    # each rank of an n-rank mesh holds the composed MeshShardedCache, n
    # full-capacity caches: a budget between one cache and n of them keeps
    # streaming on one device and falls back to scanned on the mesh
    from _trajectory_torch import make_trainer, rcfg
    from repro_torch.core import fedmom
    from repro_torch.launch.plan import CacheSpec, _resolve_plane
    rng = np.random.default_rng(0)
    clients = [{"x": rng.normal(size=(20, 5)).astype(np.float32),
                "y": rng.normal(size=20).astype(np.float32)}
               for _ in range(64)]
    tr = make_trainer(fedmom(eta=1.0, beta=0.9), rcfg(4), clients)
    sds = tr.session.streaming_dataset(tr.dataset)
    cache = CacheSpec(clients=2)
    one = sds.tier_layout(cache.tiers).bytes_for_capacity(2)
    budget = 2 * one
    assert -(-sds.n_clients // 4) * sds.slot_nbytes > budget
    plan = ExecutionPlan(plane="auto", chunk_rounds=4, cache=cache,
                         memory_budget_bytes=budget,
                         mesh=None if n == 1 else MeshSpec(devices=n))
    got = _resolve_plane(plan, tr, 4)
    assert got.working_set_nbytes == one
    if n * one <= budget:
        assert got.plane == "streaming"
        assert (f"{n * one} B/device in {n} cache shards" in got.reason) \
            == (n > 1)
    else:
        assert got.plane == "scanned"
        assert f"{n * one} B/device in {n} cache shards" in got.reason


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is visible")
def test_spawn_defaults_to_the_card():
    # like every entry point, spawn runs on cuda unless asked for the CPU:
    # without a card it raises instead of starting gloo ranks on the host
    with pytest.raises(ValueError, match="NCCL ranks need 2 cards"):
        spawn(print, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spawn(print, 2, backend="gloo")


# ---------------------------------------------------------------------------
# MeshShardedCache against the reference's
# ---------------------------------------------------------------------------
def _uniform_clients(k=6, n_k=4, d=2):
    return [{"x": np.full((n_k, d), float(c), np.float32)} for c in range(k)]


def _skewed_clients(k=12, d=3, seed=0):
    rng = np.random.default_rng(seed)
    return [{"x": rng.normal(size=(int(n), d)).astype(np.float32),
             "y": np.full((int(n),), c, np.int32)}
            for c, n in enumerate(rng.integers(1, 40, size=k))]


def _pair(clients, n_shards, **kw):
    j = jstream.MeshShardedCache(
        jstream.StreamingFederatedDataset([dict(c) for c in clients],
                                          seed=0), n_shards, **kw)
    t = tstream.MeshShardedCache(
        tstream.StreamingFederatedDataset([dict(c) for c in clients],
                                          seed=0), n_shards, device="cpu",
        **kw)
    return j, t


def _assert_same(j, t):
    assert t.resident() == j.resident()
    for js, ts in zip(j.shards, t.shards):
        assert ts.resident() == js.resident()
    for name in ("capacity", "slots", "tier_slots", "tier_sizes", "nbytes",
                 "hits", "misses", "evictions", "tier_hits", "tier_misses",
                 "tier_evictions", "hit_rate"):
        assert getattr(t, name) == getattr(j, name), name
    jv, tv = j.view(), t.view()
    np.testing.assert_array_equal(tv.client_slots.numpy(),
                                  np.asarray(jv.client_slots))
    np.testing.assert_array_equal(tv.client_tiers.numpy(),
                                  np.asarray(jv.client_tiers))
    for ja, ta in zip(jv.tier_arrays, tv.tier_arrays):
        assert ja.keys() == ta.keys()
        for name in ja:
            np.testing.assert_array_equal(ta[name].numpy(),
                                          np.asarray(ja[name]))


@pytest.mark.parametrize("n_shards,kw,seqs", [
    (2, {"capacity_clients": 2}, ([0, 1, 2, 3], [4, 5], [1, 3, 4, 1])),
    (3, {"capacity_clients": 2}, (range(6), [5, 4, 0], [2, 2, 1])),
    (4, {"capacity_clients": 3, "tiers": None},
     ([0, 5, 11, 7, 3], [1, 2, 4, 6, 8, 9], [10, 11, 0, 5])),
    (3, {"capacity_clients": 2, "tiers": 1}, ([0, 4, 8, 1], [2, 3, 7, 11])),
    (2, {"capacity_bytes": 4096}, ([0, 1, 2, 3], [6, 7, 8, 9])),
])
def test_mesh_cache_matches_reference(n_shards, kw, seqs):
    clients = (_uniform_clients() if n_shards == 2 and "tiers" not in kw
               and "capacity_bytes" not in kw else _skewed_clients())
    j, t = _pair(clients, n_shards, **kw)
    _assert_same(j, t)
    for seq in seqs:
        j.ensure(seq)
        t.ensure(seq)
        _assert_same(j, t)


def test_mesh_cache_routes_by_cid_mod_shards():
    sds = tstream.StreamingFederatedDataset(_uniform_clients(), seed=0)
    cache = tstream.MeshShardedCache(sds, 2, capacity_clients=2,
                                     device="cpu")
    cache.ensure([0, 1, 2, 3])
    assert cache.resident() == {0, 1, 2, 3}
    assert cache.shards[0].resident() == {0, 2}      # even cids -> shard 0
    assert cache.shards[1].resident() == {1, 3}
    cache.ensure([4, 5])                 # per-shard LRU evicts 0 and 1
    assert cache.resident() == {2, 3, 4, 5}
    assert cache.evictions == 2
    assert cache.hits == 0 and cache.misses == 6


def test_mesh_cache_view_slots_resolve_to_client_rows():
    sds = tstream.StreamingFederatedDataset(_uniform_clients(), seed=0)
    cache = tstream.MeshShardedCache(sds, 3, capacity_clients=2,
                                     device="cpu")
    cache.ensure([0, 1, 2, 3, 4, 5])
    view = cache.view()
    slots, tiers = view.client_slots.numpy(), view.client_tiers.numpy()
    seen = set()
    for cid in range(6):
        rows = view.tier_arrays[int(tiers[cid])]["x"].numpy()[slots[cid]]
        np.testing.assert_array_equal(rows[:4], np.full((4, 2), float(cid)))
        seen.add((int(tiers[cid]), int(slots[cid])))
    assert len(seen) == 6                # no two clients share a slot
    # the composed view is the shards' one buffer: no copy a view
    assert all(view.tier_arrays[t]["x"] is cache.tier_arrays[t]["x"]
               for t in range(len(view.tier_arrays)))


def test_mesh_cache_per_shard_capacity_semantics():
    sds = tstream.StreamingFederatedDataset(_uniform_clients(), seed=0)
    cache = tstream.MeshShardedCache(sds, 3, capacity_clients=2,
                                     device="cpu")
    cache.ensure(range(6))
    assert cache.resident() == set(range(6))
    assert cache.capacity == 6 and cache.evictions == 0
    with pytest.raises(ValueError, match="n_shards"):
        tstream.MeshShardedCache(sds, 0, capacity_clients=2, device="cpu")
