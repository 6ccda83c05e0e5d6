"""The port's threefry (repro_torch.random) against live ``jax.random``.

Integer and keyed outputs must match bit for bit: keys, folds, splits,
raw bits, randint, permutation, uniform, the minibatch draw and the keyed
samplers.  ``normal`` goes through ``erfinv``, which XLA and torch evaluate
differently: it is held to rtol 2e-5 (measured worst ~6e-6 in the tails).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import sampling as jsampling  # noqa: E402
from repro.data import federated as jfed  # noqa: E402
from repro_torch import random as tr  # noqa: E402
from repro_torch.core import sampling as tsampling  # noqa: E402
from repro_torch.data import federated as tfed  # noqa: E402

SEEDS = [0, 1, 7, 12345, 2 ** 31 - 1]


def _jkey(seed):
    return jax.random.PRNGKey(seed)


def _data(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_split_bits_equal(seed):
    kj, kt = _jkey(seed), tr.PRNGKey(seed)
    np.testing.assert_array_equal(_data(kj), kt.numpy())
    for d in (0, 1, 5, 99, 2 ** 31, 2 ** 32 - 1):
        np.testing.assert_array_equal(_data(jax.random.fold_in(kj, d)),
                                      tr.fold_in(kt, d).numpy())
    for num in (1, 2, 3, 8):
        np.testing.assert_array_equal(_data(jax.random.split(kj, num)),
                                      tr.split(kt, num).numpy())
    for shape in ((1,), (7,), (3, 5), (2, 3, 4)):
        np.testing.assert_array_equal(
            np.asarray(jax.random.bits(kj, shape)).astype(np.int64),
            tr.random_bits(kt, shape).numpy())


@pytest.mark.parametrize("seed", SEEDS[:3])
@pytest.mark.parametrize("n", [1, 2, 3, 60, 1000, 65537, 2 ** 20 + 5])
def test_randint_and_permutation_equal(seed, n):
    kj, kt = _jkey(seed), tr.PRNGKey(seed)
    np.testing.assert_array_equal(
        np.asarray(jax.random.randint(kj, (31,), 0, n)),
        tr.randint(kt, (31,), 0, n).numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.random.randint(kj, (4, 5), 3, 3 + n)),
        tr.randint(kt, (4, 5), 3, 3 + n).numpy())
    if n <= 70000:
        np.testing.assert_array_equal(
            np.asarray(jax.random.permutation(kj, n)),
            tr.permutation(kt, n).numpy())


def test_permutation_multi_round_sort_equal():
    """n large enough that jax runs two rounds of the stable sort."""
    n = 1_500_000
    assert int(np.ceil(3 * np.log(n) / np.log(2 ** 32 - 1))) == 2
    np.testing.assert_array_equal(
        np.asarray(jax.random.permutation(_jkey(4), n)),
        tr.permutation(tr.PRNGKey(4), n).numpy())


def test_randint_degenerate_span_equal():
    kj, kt = _jkey(3), tr.PRNGKey(3)
    np.testing.assert_array_equal(
        np.asarray(jax.random.randint(kj, (9,), 5, 5)),
        tr.randint(kt, (9,), 5, 5).numpy())


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_uniform_bit_equal_normal_close(seed):
    kj, kt = _jkey(seed), tr.PRNGKey(seed)
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(kj, (4096,))),
        tr.uniform(kt, (4096,)).numpy())
    a = np.asarray(jax.random.normal(kj, (8192,)))
    b = tr.normal(kt, (8192,)).numpy()
    np.testing.assert_allclose(b, a, rtol=2e-5, atol=1e-7)


@pytest.mark.parametrize("lo,hi", [(0.9, 0.999), (-3.0, 5.5)])
def test_uniform_over_a_range_bit_equal(lo, hi):
    """Over [lo, hi) the scale and shift round once, as in the fused
    multiply-add of XLA's CPU code (the RG-LRU ``lam`` draw, U(0.9, 0.999);
    rounded twice, ~4% of the values at 4,096 differed by an ulp)."""
    for seed in SEEDS[:3]:
        np.testing.assert_array_equal(
            np.asarray(jax.random.uniform(_jkey(seed), (4096,), minval=lo,
                                          maxval=hi)),
            tr.uniform(tr.PRNGKey(seed), (4096,), lo, hi).numpy())


@pytest.mark.parametrize("t", [0, 1, 17, 4096])
def test_minibatch_indices_equal_batched_and_per_client(t):
    """The batched draw equals the reference's client-vmapped draw AND the
    per-client calls (threefry is counter-based)."""
    rng = np.random.default_rng(t)
    ids = rng.integers(0, 10_000, size=6)
    n_ks = rng.integers(1, 5000, size=6)
    need = 37
    want = np.asarray(jax.vmap(jfed.minibatch_indices,
                               in_axes=(None, None, 0, 0, None))(
        _jkey(11), t, jnp.asarray(ids), jnp.asarray(n_ks), need))
    got = tfed.minibatch_indices(tr.PRNGKey(11), t, torch.as_tensor(ids),
                                 n_ks, need).numpy()
    np.testing.assert_array_equal(got, want)
    for c in range(len(ids)):
        one = tfed.minibatch_indices(tr.PRNGKey(11), t, int(ids[c]),
                                     int(n_ks[c]), need).numpy()
        np.testing.assert_array_equal(one, want[c])


def _pop(k=23, seed=0):
    counts = np.random.default_rng(seed).integers(2, 300, size=k)
    return (jsampling.ClientPopulation(counts=counts),
            tsampling.ClientPopulation(counts=counts))


@pytest.mark.parametrize("seed", [0, 2, 9])
def test_device_uniform_sampler_equal(seed):
    jp, tp = _pop()
    js = jsampling.DeviceUniformSampler(jp, 5, seed=seed)
    ts = tsampling.DeviceUniformSampler(tp, 5, seed=seed)
    assert isinstance(ts, tsampling.KeyedReplayable)
    for t in (0, 1, 2, 50, 999):
        ji, jw = js.sample(t)
        ti, tw = ts.sample(t)
        np.testing.assert_array_equal(ti, np.asarray(ji))
        np.testing.assert_array_equal(tw, np.asarray(jw))


def test_device_diurnal_sampler_equal():
    jp, tp = _pop(k=31, seed=1)
    js = jsampling.DeviceDiurnalSampler(jp, m_min=2, m_max=6, period=7,
                                        seed=3)
    ts = tsampling.DeviceDiurnalSampler(tp, m_min=2, m_max=6, period=7,
                                        seed=3)
    for t in range(15):
        ji, jw = js.sample(t)
        ti, tw = ts.sample(t)
        np.testing.assert_array_equal(ti, np.asarray(ji))
        np.testing.assert_array_equal(tw, np.asarray(jw))
        assert tsampling.diurnal_m_device(t, 2, 6, 7) == int(
            jsampling.diurnal_m_device(t, 2, 6, 7))


def test_participants_in_span_equal_and_needs_keyed_sampler():
    jp, tp = _pop(k=40, seed=2)
    js = jsampling.DeviceUniformSampler(jp, 4, seed=5)
    ts = tsampling.DeviceUniformSampler(tp, 4, seed=5)
    for dedup in (True, False):
        assert tsampling.participants_in_span(ts, 3, 9, dedup) == \
            jsampling.participants_in_span(js, 3, 9, dedup)
    with pytest.raises(ValueError, match="KeyedReplayable"):
        tsampling.participants_in_span(
            tsampling.UniformSampler(tp, 4, seed=5), 0, 2)


def test_stateful_samplers_match_host_numpy_stream():
    jp, tp = _pop(k=19, seed=4)
    js, ts = (jsampling.UniformSampler(jp, 3, seed=8),
              tsampling.UniformSampler(tp, 3, seed=8))
    jd = jsampling.DiurnalSampler(jp, 2, 5, period=9, seed=8)
    td = tsampling.DiurnalSampler(tp, 2, 5, period=9, seed=8)
    for t in range(6):
        for a, b in ((js, ts), (jd, td)):
            ja, jw = a.sample(t)
            ta, tw = b.sample(t)
            np.testing.assert_array_equal(ta, ja)
            np.testing.assert_array_equal(tw, jw)
    assert not isinstance(ts, tsampling.KeyedReplayable)
