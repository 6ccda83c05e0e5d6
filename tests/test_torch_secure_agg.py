"""The port's secure-aggregation codec, mask grid and list API
(``repro_torch.core.secure_agg``) against the JAX package's
(``repro.core.secure_agg``) on the same numpy-made inputs, bit for bit:
ring words, masked messages, survivor sums with dropout recovery and the
decoded aggregates.  Ring words are int64 in the port and uint32 in the
reference; they are compared by value."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import secure_agg as jsa  # noqa: E402
from repro_torch import random as prng  # noqa: E402
from repro_torch.core import secure_agg as tsa  # noqa: E402

SPEC = tsa.SecureAggSpec(masked=True, seed=0)
JSPEC = jsa.SecureAggSpec(masked=True, seed=0)


# the JAX side jitted (eager vmap of its key grid dispatches op by op)
_J_MASK = jax.jit(jsa.mask_cohort, static_argnums=2)
_J_SUM = jax.jit(jsa.ring_survivor_sum, static_argnums=3)
_J_SIGNED = jax.jit(jsa._signed_masks, static_argnums=1)
_J_MRS = jax.jit(jsa.masked_ring_sum, static_argnums=2)
_J_SWS = jax.jit(jsa.secure_weighted_sum, static_argnums=2)


def _both_specs(masked=True, seed=0, frac_bits=20):
    return (jsa.SecureAggSpec(masked=masked, seed=seed, frac_bits=frac_bits),
            tsa.SecureAggSpec(masked=masked, seed=seed, frac_bits=frac_bits))


def _jkey(seed):
    return jax.random.PRNGKey(seed)


def _tkey(seed):
    return prng.PRNGKey(seed)


def _cohort(C=5, seed=0):
    """A [C, ...] weighted-update stack of a mixed tree: a matrix, a
    vector, a 0-d leaf per client and a larger 3-d leaf."""
    rng = np.random.default_rng(seed)
    y = {"a": rng.normal(size=(C, 3, 4)).astype(np.float32),
         "b": rng.normal(size=(C, 7)).astype(np.float32) * 0.01,
         "c": rng.normal(size=(C,)).astype(np.float32),
         "d": rng.normal(size=(C, 2, 5, 3)).astype(np.float32)}
    return ({k: jnp.asarray(v) for k, v in y.items()},
            {k: torch.from_numpy(v.copy()) for k, v in y.items()})


def _eq(t_tree, j_tree):
    if isinstance(t_tree, dict):
        assert sorted(t_tree) == sorted(j_tree)
        for k in t_tree:
            _eq(t_tree[k], j_tree[k])
        return
    j = np.asarray(j_tree)
    t = t_tree.numpy()
    assert t.shape == j.shape, (t.shape, j.shape)
    if j.dtype == np.uint32:
        assert t.dtype == np.int64
        np.testing.assert_array_equal(t, j.astype(np.int64))
    else:
        assert t.dtype == j.dtype
        np.testing.assert_array_equal(t.view(np.int32), j.view(np.int32))


# ---------------------------------------------------------------------------
# codec
# ---------------------------------------------------------------------------
_SPECIAL = [3e9, -3e9, np.nan, np.inf, -np.inf, 2.5, -2.5, 0.5, 1.5, -0.5,
            0.0, -0.0, 2.0 ** 31, -2.0 ** 31, 2.0 ** 31 - 128, 1e-30,
            -1e-30, 2147483520.0, -2147483648.0]


@pytest.mark.parametrize("frac_bits", [1, 20, 30])
def test_encode_bit_equal_with_saturation_and_half_way(frac_bits):
    """Saturation (+-3e9, +-inf, the int32 edges), NaN -> 0, half-way
    values (round half to even) and random values of every magnitude."""
    jspec, tspec = _both_specs(frac_bits=frac_bits)
    rng = np.random.default_rng(frac_bits)
    half = (np.arange(-40, 40) + 0.5) / tspec.scale
    x = np.concatenate([
        np.asarray(_SPECIAL), half,
        rng.normal(size=500) * 10.0 ** rng.integers(-8, 4, size=500)
    ]).astype(np.float32)
    _eq(tsa.encode(torch.from_numpy(x), tspec),
        jsa.encode(jnp.asarray(x), jspec))


@pytest.mark.parametrize("frac_bits", [1, 20, 30])
def test_decode_bit_equal_over_the_ring(frac_bits):
    jspec, tspec = _both_specs(frac_bits=frac_bits)
    rng = np.random.default_rng(1)
    q = np.concatenate([
        np.asarray([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 31 + 1, 2 ** 32 - 1,
                    2 ** 24 + 1, 2 ** 32 - 2 ** 24 - 1], np.uint64),
        rng.integers(0, 2 ** 32, size=1000, dtype=np.uint64)])
    _eq(tsa.decode(torch.from_numpy(q.astype(np.int64)), tspec),
        jsa.decode(jnp.asarray(q.astype(np.uint32)), jspec))


def test_encode_decode_roundtrip_exact_on_grid():
    x = torch.tensor([-3.5, -1.0 / 1024, 0.0, 0.25, 100.125])
    assert torch.equal(tsa.decode(tsa.encode(x, SPEC), SPEC), x)


def test_spec_validation_matches_reference():
    for kw in ({"frac_bits": 0}, {"frac_bits": 31}, {"masked": "yes"},
               {"frac_bits": 2.0}):
        msgs = []
        for cls in (jsa.SecureAggSpec, tsa.SecureAggSpec):
            with pytest.raises(ValueError) as err:
                cls(**kw)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]
    assert tsa.SecureAggSpec(frac_bits=7).scale == 128.0
    assert hash(tsa.SecureAggSpec()) == hash(tsa.SecureAggSpec())


# ---------------------------------------------------------------------------
# keys and the mask grid
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 5, -3])
def test_round_mask_key_bit_equal(seed):
    jspec, tspec = _both_specs(seed=seed)
    for t in (0, 1, 7, 123456):
        want = np.asarray(jax.random.key_data(jsa.round_mask_key(jspec, t)))
        assert tsa.round_mask_key(tspec, t).tolist() == want.tolist()
        got = tsa.round_mask_key(tspec, torch.tensor(t))   # a tensor t
        assert got.tolist() == want.tolist()
    assert (tsa.round_mask_key(tspec, 0).tolist()
            != tsa.round_mask_key(tspec, 1).tolist())


@pytest.mark.parametrize("C", [1, 2, 5])
@pytest.mark.parametrize("shape", [(), (7,), (3, 4), (2, 5, 3)])
def test_signed_masks_words_bit_equal(C, shape):
    leaf = np.zeros(shape, np.float32)
    got = tsa._signed_masks(_tkey(11), C, torch.from_numpy(leaf))
    want = _J_SIGNED(_jkey(11), C, jnp.asarray(leaf))
    _eq(got, want)


def test_shared_pair_draw_is_the_per_leaf_grid():
    """The pair draw at the largest leaf's size, sliced per leaf, is the
    per-leaf draw the reference makes: ``bits(k, shape)`` is the prefix of
    ``bits(k, (N,))``, and (i, j) / (j, i) share a key."""
    C, key = 6, prng.fold_in(_tkey(4), 9)
    lo, hi, bits = tsa._pair_bits(key, C, 30720)
    assert bits.shape == (C * (C - 1) // 2, 30720)
    for shape in ((5, 5, 1, 32), (32,), (2048, 15), (), (15, 62)):
        n = int(np.prod(shape))
        for p in range(len(lo)):
            kij = prng.fold_in(prng.fold_in(key, int(lo[p])), int(hi[p]))
            assert torch.equal(prng.random_bits(kij, shape).reshape(-1),
                               bits[p, :n])
    # row sums from the pair draw equal the per-leaf grid's row sums
    leaf = torch.zeros(3, 4)
    grid = tsa._signed_masks(key, C, leaf)
    rows = tsa._mask_rows(lo, hi, bits, C, leaf.shape)
    assert torch.equal(rows, torch.sum(grid, dim=1) & 0xFFFFFFFF)


def test_sub_cohort_grids_equal_one_draw_a_tier():
    """The bucketed engine's tiers drawn in one pass: tier i's draw is the
    one ``fold_in(round_key, i)`` gives it alone, and a masked tier sum
    over it equals the tier's own ``masked_ring_sum`` under that key."""
    round_key = tsa.round_mask_key(SPEC, 3)
    sizes, n = (4, 1, 2, 8, 2), 40
    grids = tsa.sub_cohort_grids(round_key, sizes, n)
    assert tsa.sub_cohort_grids(round_key, (), n) == []
    for i, (C, (lo, hi, bits)) in enumerate(zip(sizes, grids)):
        want = tsa._pair_bits(prng.fold_in(round_key, i), C, n)
        for a, b in zip((lo, hi, bits), want):
            assert torch.equal(a, b), i
        _, ty = _cohort(C, seed=i)
        ty = {k: v for k, v in ty.items() if v[0].numel() <= n}
        surv = torch.arange(C) % 3 != 1
        for a, b in zip(
                tsa.masked_ring_sum(ty, surv, SPEC, None,
                                    grid=(lo, hi, bits)).values(),
                tsa.masked_ring_sum(ty, surv, SPEC,
                                    prng.fold_in(round_key, i)).values()):
            assert torch.equal(a, b), i


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("C", [1, 3, 8])
def test_mask_cohort_bit_equal(masked, C):
    jspec, tspec = _both_specs(masked=masked, seed=2)
    jy, ty = _cohort(C, seed=C)
    _eq(tsa.mask_cohort(_tkey(6), ty, tspec),
        _J_MASK(_jkey(6), jy, jspec))


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("survivors", [None, [1, 1, 1, 1, 1, 1],
                                       [1, 0, 1, 1, 0, 1], [0, 0, 0, 0, 0, 0],
                                       [0, 1, 0, 0, 0, 0]],
                         ids=["none", "all", "two-dropped", "all-dropped",
                              "one-left"])
def test_ring_survivor_sum_bit_equal(masked, survivors):
    jspec, tspec = _both_specs(masked=masked, seed=3)
    jy, ty = _cohort(6, seed=7)
    jm = _J_MASK(_jkey(8), jy, jspec)
    tm = tsa.mask_cohort(_tkey(8), ty, tspec)
    js = None if survivors is None else jnp.asarray(survivors)
    ts = None if survivors is None else torch.tensor(survivors)
    got = tsa.ring_survivor_sum(_tkey(8), tm, ts, tspec)
    jgot = _J_SUM(_jkey(8), jm, js, jspec)
    _eq(got, jgot)
    _eq(tsa.unmask_sum(_tkey(8), tm, ts, tspec), jsa.decode(jgot, jspec))
    # recovery makes the masked sum the open ring's over the survivors
    open_q = tsa.encode(ty, tspec)
    s = torch.ones(6, dtype=torch.int64) if ts is None else ts
    for k in got:
        want = torch.sum(s.reshape((6,) + (1,) * (open_q[k].dim() - 1))
                         * open_q[k], dim=0) & 0xFFFFFFFF
        assert torch.equal(got[k], want), k


def test_masked_ring_sum_and_secure_weighted_sum_bit_equal():
    jy, ty = _cohort(5, seed=3)
    surv = [1, 0, 1, 1, 1]
    for masked in (True, False):
        jspec, tspec = _both_specs(masked=masked, seed=9, frac_bits=16)
        for s in (None, surv):
            js = None if s is None else jnp.asarray(s, jnp.bool_)
            ts = None if s is None else torch.tensor(s, dtype=torch.bool)
            key = prng.fold_in(tsa.round_mask_key(tspec, 4), 2)
            jkey = jax.random.fold_in(jsa.round_mask_key(jspec, 4), 2)
            _eq(tsa.masked_ring_sum(ty, ts, tspec, key),
                _J_MRS(jy, js, jspec, jkey))
            for t in (0, 4, torch.tensor(4)):
                _eq(tsa.secure_weighted_sum(ty, ts, tspec, t),
                    _J_SWS(jy, js, jspec, int(t)))


def test_secure_weighted_sum_saturating_and_nan_rows():
    """Out-of-range and NaN deltas go through the ring as the reference's
    saturating cast puts them: the decoded sums agree bit for bit."""
    rng = np.random.default_rng(5)
    y = rng.normal(size=(4, 9)).astype(np.float32)
    y[0, :5] = [3e9, -3e9, np.inf, -np.inf, np.nan]
    y[2, 3] = np.nan
    y[3, 0] = 5000.0                     # wraps the aggregate's ring
    for masked in (True, False):
        jspec, tspec = _both_specs(masked=masked)
        for s in (None, [1, 1, 0, 1]):
            _eq(tsa.secure_weighted_sum(
                    {"w": torch.from_numpy(y)},
                    None if s is None else torch.tensor(s), tspec, 3),
                _J_SWS(
                    {"w": jnp.asarray(y)},
                    None if s is None else jnp.asarray(s), jspec, 3))


def test_recovery_needs_the_key():
    _, ty = _cohort(3)
    tm = tsa.mask_cohort(_tkey(4), ty, SPEC)
    with pytest.raises(ValueError, match="per-round mask key"):
        tsa.ring_survivor_sum(None, tm, torch.tensor([1, 1, 0]), SPEC)
    with pytest.raises(ValueError, match="per-round mask key"):
        tsa.aggregate_masked([{"w": torch.zeros(2, dtype=torch.int64)}],
                             spec=SPEC, survivors=torch.tensor([1]))
    # the open ring needs none
    open_spec = dataclasses.replace(SPEC, masked=False)
    tsa.ring_survivor_sum(None, tsa.encode(ty, open_spec),
                          torch.tensor([1, 1, 0]), open_spec)


# ---------------------------------------------------------------------------
# list API
# ---------------------------------------------------------------------------
def _updates(n=4, d=6, seed=0):
    rng = np.random.default_rng(seed)
    ups = [{"w": rng.normal(size=d).astype(np.float32),
            "b": rng.normal(size=()).astype(np.float32)} for _ in range(n)]
    w = rng.uniform(0.1, 0.3, size=n).astype(np.float32)
    return (([{k: jnp.asarray(v) for k, v in u.items()} for u in ups],
             jnp.asarray(w)),
            ([{k: torch.from_numpy(np.array(v)) for k, v in u.items()}
              for u in ups], torch.from_numpy(w)))


@pytest.mark.parametrize("n", [1, 2, 5])
@pytest.mark.parametrize("masked", [True, False])
def test_list_api_bit_equal(n, masked):
    jspec, tspec = _both_specs(masked=masked, seed=1)
    (jups, jw), (tups, tw) = _updates(n, seed=n)
    jmsg = jsa.mask_client_updates(_jkey(3), jups, jw, jspec)
    tmsg = tsa.mask_client_updates(_tkey(3), tups, tw, tspec)
    assert len(tmsg) == len(jmsg) == n
    for a, b in zip(tmsg, jmsg):
        _eq(a, b)
    _eq(tsa.aggregate_masked(tmsg, spec=tspec, key=_tkey(3)),
        jsa.aggregate_masked(jmsg, spec=jspec, key=_jkey(3)))
    if n > 1:
        surv = [1] * (n - 1) + [0]
        _eq(tsa.aggregate_masked(tmsg, spec=tspec, key=_tkey(3),
                                 survivors=torch.tensor(surv)),
            jsa.aggregate_masked(jmsg, spec=jspec, key=_jkey(3),
                                 survivors=jnp.asarray(surv)))
    if masked and n > 1:               # every message blinded
        for i in range(n):
            plain = (tw[i] * tups[i]["w"]).numpy()
            msg = tsa.decode(tmsg[i], tspec)["w"].numpy()
            assert not np.allclose(msg, plain, atol=1e-3)


def test_empty_cohort():
    with pytest.raises(tsa.EmptyCohortError) as err:
        tsa.aggregate_masked([], spec=SPEC, round=12)
    assert err.value.round == 12
    with pytest.raises(jsa.EmptyCohortError) as jerr:
        jsa.aggregate_masked([], spec=JSPEC, round=12)
    assert str(err.value) == str(jerr.value)
    assert tsa.mask_client_updates(_tkey(0), [], torch.zeros(0), SPEC) == []
    like = {"w": torch.ones(3, 2), "b": torch.ones(())}
    z = tsa.aggregate_masked([], spec=SPEC, like=like)
    assert z["w"].shape == (3, 2) and z["b"].shape == ()
    assert z["w"].dtype == torch.float32 and not z["w"].any()
