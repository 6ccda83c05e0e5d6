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


def _bucketed_cohorts(tier_of, R, rng):
    """Per tier present, [R, C_i] client ids (each round's members of the
    tier, right-padded with a member at weight 0) and weights."""
    tiers = sorted({int(t) for t in tier_of})
    cids, ws = [], []
    for tier in tiers:
        members = [c for c in range(len(tier_of)) if tier_of[c] == tier]
        C = min(2, len(members))
        c = np.stack([rng.choice(members, size=C, replace=False)
                      for _ in range(R)]).astype(np.int32)
        w = rng.uniform(0.1, 0.4, size=(R, C)).astype(np.float32)
        if C > 1:
            c[0, -1] = c[0, 0]
            w[0, -1] = 0.0                     # a padded slot
        cids.append(c)
        ws.append(w)
    return tuple(tiers), tuple(cids), tuple(ws)


@pytest.mark.parametrize("hook", [False, True])
@pytest.mark.parametrize("staged", [False, True])
def test_scan_rounds_bucketed_reference_order(staged, hook):
    """A positional call in the reference's argument order (``data_key``
    after ``tier_weights``), against the reference's
    ``scan_rounds_bucketed`` on the same cache: un-staged (each tier draws
    its own keyed indices from ``data_key``) and with ``tier_idx`` staged
    by the host replay, in the fused-concat form and through the
    ``client_step_fn`` hook.  Multi-tier chunks sum the delta tier by tier
    in another order: rtol 1e-4, atol 1e-6 (``test_torch_round.py``)."""
    from repro.core import multiround as jmr
    from repro.core import round as jround
    from repro.core import server_opt as jso
    from repro.kernels.client_step import ops as jcs
    from repro_torch.core import multiround as tmr
    from repro_torch.core import round as tround
    from repro_torch.core import server_opt as tso
    from repro_torch.interop import tree_from_numpy, tree_to_numpy
    from repro_torch.kernels.client_step import ops as tcs

    def jloss(p, b):
        return jnp.mean(jnp.square(b["x"] @ p["w"] + p["b"] - b["y"])), {}

    def tloss(p, b):
        return torch.mean(torch.square(b["x"] @ p["w"] + p["b"]
                                       - b["y"])), {}

    counts = ZIPF[:12]
    jc, tc = _caches(counts, capacity_clients=len(counts))
    for c in (jc, tc):
        c.ensure(range(len(counts)))
    rng = np.random.default_rng(6)
    R, H, b, t0 = 3, 2, 3, 5
    tiers, cids, ws = _bucketed_cohorts(jc.layout.tier_of, R, rng)
    assert len(tiers) > 1
    w0 = {"w": rng.normal(size=3).astype(np.float32),
          "b": np.float32(0.1)}
    rc = dict(clients_per_round=8, local_steps=H, lr=0.05,
              compute_dtype="float32")
    jopt, topt = jso.fedmom(eta=1.5), tso.fedmom(eta=1.5)
    js, jm = jmr.scan_rounds_bucketed(
        jloss, jopt, jopt.init(jax.tree.map(jnp.asarray, w0)), jc.view(),
        tiers, tuple(map(jnp.asarray, cids)), tuple(map(jnp.asarray, ws)),
        jax.random.PRNGKey(2), jnp.int32(t0), R, jround.RoundConfig(**rc),
        b, client_step_fn=(jcs.linreg_tier_step(use_kernel=False) if hook
                           else None))
    tier_idx = None
    if staged:
        tier_idx = tuple(ttrain._staged_indices(
            prng.PRNGKey(2), np.repeat(np.arange(t0, t0 + R), c.shape[1]),
            c.reshape(-1), np.asarray(counts)[c.reshape(-1)], H * b)
            .reshape(R, c.shape[1], H * b) for c in cids)
    ts, tm = tmr.scan_rounds_bucketed(
        tloss, topt, topt.init(tree_from_numpy(w0, "cpu")), tc.view(),
        tiers, cids, ws, prng.PRNGKey(2), t0, R, tround.RoundConfig(**rc),
        b, None, None, None, tier_idx,
        tcs.linreg_tier_step() if hook else None, device="cpu")
    got = tree_to_numpy(ts.w)
    for k in w0:
        np.testing.assert_allclose(got[k], np.asarray(js.w[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    assert ts.t == int(js.t) == R
    np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                               rtol=1e-4, atol=1e-6)
