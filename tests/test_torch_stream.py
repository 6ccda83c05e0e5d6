"""The port's streaming data plane (``data/stream.py``) against the JAX
package's, on the CPU.

Host metadata (``TierLayout``, byte accounting) is numpy on both sides and
must be identical.  The shard cache must make the same residency decisions
(hits, misses, evictions, per-tier counters, resident sets, slot tables)
for the same ``ensure`` sequence, and every gather of ``CacheView`` must be
bit-equal: the rows are copies of the same corpus picked by the same keyed
threefry draws.  The batched host replay of a chunk's draws
(``launch/train.py`` ``_staged_indices``) is bit-equal to the reference's
vmapped one.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.data import stream as jstream  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro_torch import random as prng  # noqa: E402
from repro_torch.data import stream as tstream  # noqa: E402
from repro_torch.data.federated import CorpusSchemaError  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402

ZIPF = [max(2, int(256 / (r + 1) ** 1.2)) for r in range(40)]
POW2_EDGES = [1, 2, 4, 8, 16, 3, 5, 9, 17, 32, 32, 7]


def _corpus(counts, d=3, seed=0, y_dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [{"x": rng.normal(size=(n, d)).astype(np.float32),
             "y": rng.normal(size=n).astype(y_dtype)} for n in counts]


def _pair(counts, seed=1, **kw):
    data = _corpus(counts, **kw)
    return (jstream.StreamingFederatedDataset(data, seed=seed),
            tstream.StreamingFederatedDataset(data, seed=seed))


@pytest.mark.parametrize("counts", [ZIPF, POW2_EDGES],
                         ids=["zipf", "pow2-edges"])
@pytest.mark.parametrize("tiers", [None, 1, 3])
def test_tier_layout_identical(counts, tiers):
    jds, tds = _pair(counts)
    a, b = jds.tier_layout(tiers), tds.tier_layout(tiers)
    assert a.sizes == b.sizes and a.tier_counts == b.tier_counts
    assert a.row_nbytes == b.row_nbytes
    np.testing.assert_array_equal(a.tier_of, b.tier_of)
    for cap in (1, 2, 5, len(counts)):
        assert a.bytes_for_capacity(cap) == b.bytes_for_capacity(cap)
    for budget in (a.min_viable_bytes - 1, a.min_viable_bytes,
                   a.bytes_for_capacity(4) + 7, 10 ** 9):
        assert a.capacity_for_bytes(budget) == b.capacity_for_bytes(budget)
    assert (jds.n_max, jds.slot_nbytes, jds.packed_nbytes) == (
        tds.n_max, tds.slot_nbytes, tds.packed_nbytes)
    np.testing.assert_array_equal(jds.counts, tds.counts)
    assert tstream.next_pow2(17) == jstream.next_pow2(17) == 32


def _caches(counts, tiers=None, **cap):
    jds, tds = _pair(counts)
    return (jstream.ShardCache(jds, tiers=tiers, **cap),
            tstream.ShardCache(tds, tiers=tiers, device="cpu", **cap))


def _assert_same_cache(jc, tc):
    assert (jc.hits, jc.misses, jc.evictions) == (tc.hits, tc.misses,
                                                  tc.evictions)
    assert (jc.tier_hits, jc.tier_misses, jc.tier_evictions) == (
        tc.tier_hits, tc.tier_misses, tc.tier_evictions)
    assert jc.resident() == tc.resident()
    assert (jc.slots, jc.tier_sizes, jc.nbytes, jc.capacity) == (
        tc.slots, tc.tier_sizes, tc.nbytes, tc.capacity)
    jv, tv = jc.view(), tc.view()
    np.testing.assert_array_equal(np.asarray(jv.client_slots),
                                  tv.client_slots.numpy())
    np.testing.assert_array_equal(np.asarray(jv.client_tiers),
                                  tv.client_tiers.numpy())
    for ja, ta in zip(jv.tier_arrays, tv.tier_arrays):
        for k in ja:
            np.testing.assert_array_equal(np.asarray(ja[k]), ta[k].numpy())


@pytest.mark.parametrize("tiers,cap", [(None, {"capacity_clients": 6}),
                                       (1, {"capacity_clients": 4}),
                                       (2, {"capacity_bytes": 15000})])
def test_ensure_sequence_same_decisions(tiers, cap):
    """A churning sequence (repeats, LRU refresh in last-use order,
    evictions in every tier) leaves both caches in the same state."""
    jc, tc = _caches(ZIPF[:16], tiers=tiers, **cap)
    rng = np.random.default_rng(3)
    for _ in range(12):
        seq = rng.choice(16, size=rng.integers(1, min(jc.capacity, 5) + 1),
                         replace=False).tolist()
        seq = seq + seq[:2]                      # repeats inside a request
        jc.ensure(seq)
        tc.ensure(seq)
        _assert_same_cache(jc, tc)
    assert tc.evictions > 0


def test_ensure_over_capacity_raises_like_reference():
    jc, tc = _caches(ZIPF[:10], capacity_clients=3)
    for c in (jc, tc):
        with pytest.raises(ValueError, match="distinct clients"):
            c.ensure([0, 1, 2, 3])
    jds, tds = _pair(ZIPF[:10])
    small = jds.tier_layout().min_viable_bytes - 1
    for mod, ds, kw in ((jstream, jds, {}), (tstream, tds, {"device": "cpu"})):
        with pytest.raises(ValueError, match="minimum viable"):
            mod.ShardCache(ds, capacity_bytes=small, **kw)


@pytest.mark.parametrize("t", [0, 7])
def test_gathers_bit_equal(t):
    """gather_round_batch (every tier gathered, the client's own picked),
    gather_tier_batch and gather_tier_rows against the reference on the
    same resident set — including clients whose slot or rows are out of
    range in the other tiers."""
    counts = POW2_EDGES
    jc, tc = _caches(counts, capacity_clients=len(counts))
    cids = [0, 9, 4, 11, 2, 7]
    jc.ensure(cids)
    tc.ensure(cids)
    jv, tv = jc.view(), tc.view()
    jkey, tkey = jax.random.PRNGKey(1), prng.PRNGKey(1)
    H, b = 3, 2
    got = tv.gather_round_batch(tkey, t, cids, H, b)
    want = jv.gather_round_batch(jkey, t, jnp.asarray(cids), H, b)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    tier_of = jc.layout.tier_of
    for tier in sorted({int(tier_of[c]) for c in cids}):
        members = [c for c in cids if tier_of[c] == tier]
        got = tv.gather_tier_batch(tier, tkey, t, members, H, b)
        want = jv.gather_tier_batch(tier, jkey, t, jnp.asarray(members), H,
                                    b)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
        idx = np.stack([np.asarray(jtrain.minibatch_indices(
            jkey, t, c, counts[c], H * b)) for c in members])
        got = tv.gather_tier_rows(tier, members, idx, H, b)
        want = jv.gather_tier_rows(tier, jnp.asarray(members),
                                   jnp.asarray(idx), H, b)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))


def test_staged_indices_bit_equal():
    """The batched host replay of a chunk's (t, cid, n_k) lanes."""
    rng = np.random.default_rng(5)
    L, need = 37, 12
    t = rng.integers(0, 500, size=L)
    cids = rng.integers(0, 1000, size=L)
    n_k = rng.integers(1, 9000, size=L)
    want = np.asarray(jtrain._staged_indices(
        jax.random.PRNGKey(4), t.astype(np.int32), cids.astype(np.int32),
        n_k.astype(np.int32), need))
    got = ttrain._staged_indices(prng.PRNGKey(4), t, cids, n_k, need)
    np.testing.assert_array_equal(got, want)


class _Provider:
    """A lazy corpus: client c's rows are a pure function of c; client
    ``bad`` returns float64 features (a schema breach)."""

    def __init__(self, counts, bad=None):
        self._counts = np.asarray(counts)
        self.bad = bad
        self.calls = 0

    @property
    def n_clients(self):
        return len(self._counts)

    @property
    def counts(self):
        return self._counts

    @property
    def fields(self):
        return {"x": ((3,), np.float32), "y": ((), np.float32)}

    def shard(self, cid):
        self.calls += 1
        rng = np.random.default_rng(100 + cid)
        n = int(self._counts[cid])
        x = rng.normal(size=(n, 3))
        return {"x": x if cid == self.bad else x.astype(np.float32),
                "y": rng.normal(size=n).astype(np.float32)}


@pytest.mark.parametrize("validate", ["first", "always", "never"])
def test_provider_path_matches_reference(validate):
    counts = ZIPF[:12]
    jp, tp = _Provider(counts), _Provider(counts)
    jds = jstream.StreamingFederatedDataset.from_provider(jp, seed=2,
                                                          validate=validate)
    tds = tstream.StreamingFederatedDataset.from_provider(tp, seed=2,
                                                          validate=validate)
    assert tds.fields == jds.fields and tds.row_nbytes == jds.row_nbytes
    jc = jstream.ShardCache(jds, capacity_clients=4)
    tc = tstream.ShardCache(tds, capacity_clients=4, device="cpu")
    for seq in ([0, 5, 6], [1, 2, 3, 0], [7, 8], [0, 5, 9, 10]):
        jc.ensure(seq)
        tc.ensure(seq)
        _assert_same_cache(jc, tc)
    assert tp.calls == jp.calls == tc.misses


def test_provider_schema_error_names_the_client():
    tds = tstream.StreamingFederatedDataset.from_provider(
        _Provider(ZIPF[:6], bad=4))
    cache = tstream.ShardCache(tds, capacity_clients=3, device="cpu")
    cache.ensure([0, 1])
    with pytest.raises(CorpusSchemaError, match="provider shard for 4") as e:
        cache.ensure([4])
    assert e.value.client == 4
    never = tstream.StreamingFederatedDataset.from_provider(
        _Provider(ZIPF[:6], bad=4), validate="never")
    with pytest.raises(CorpusSchemaError) as e:
        tstream.StreamingFederatedDataset.from_provider(
            _Provider([3, 0, 2]))
    assert e.value.client == 1
    assert never.shard(4)["x"].dtype == np.float64     # not checked
    with pytest.raises(ValueError, match="exactly one of"):
        tstream.StreamingFederatedDataset()
    with pytest.raises(ValueError, match="validate must be"):
        tstream.StreamingFederatedDataset(_corpus([2]), validate="sometimes")


def test_padded_client_and_shard_match_reference():
    jds, tds = _pair(POW2_EDGES, y_dtype=np.int32)
    for cid, rows in ((3, None), (9, 32), (0, 4)):
        a, b = jds.padded_client(cid, rows), tds.padded_client(cid, rows)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_array_equal(jds.padded_shard(cid, k, rows),
                                          tds.padded_shard(cid, k, rows))
    cache = tstream.ShardCache(tds, capacity_clients=3, device="cpu")
    cache.ensure([9, 3])
    assert cache.view().tier_arrays[0]["y"].dtype == torch.int32
