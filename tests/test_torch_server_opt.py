"""All eight server optimizers of the port against the JAX package's
``REGISTRY``, over several rounds of the same deltas (numpy-seeded).

Tolerance: rtol 1e-5 / atol 1e-6 on fp32 states after 6 rounds — the
updates are the same elementwise float32 formulas, but XLA may contract a
multiply-add into one FMA and reduces norms in another order.  DP noise
comes from ``repro_torch.random.normal`` (``erfinv`` a few ulps off XLA's),
so the noisy entries are held to the same rtol on values of order
``clip * noise_multiplier``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import server_opt as jso  # noqa: E402
from repro_torch.core import server_opt as tso  # noqa: E402
from repro_torch.interop import (server_state_from_numpy,  # noqa: E402
                                 tree_from_numpy, tree_to_numpy)

RTOL, ATOL = 1e-5, 1e-6
ROUNDS = 6

CASES = [
    ("fedavg", {"eta": 2.0}),
    ("fedmom", {"eta": 2.0, "beta": 0.9}),
    ("fedmom", {"eta": 2.0, "beta": 0.9, "use_fused_kernel": True}),
    ("fedavgm", {"eta": 1.5, "beta": 0.8}),
    ("fedavgm", {"eta": 1.5, "beta": 0.8, "use_fused_kernel": True}),
    ("fedadam", {"eta": 0.1}),
    ("fedyogi", {"eta": 0.1}),
    ("fedlamom", {"eta": 3.0, "beta": 0.9}),
    ("dp_fedavg", {"clip": 0.5, "noise_multiplier": 0.3, "dp_seed": 4}),
    ("dp_fedmom", {"clip": 0.5, "noise_multiplier": 0.0, "eta": 2.0}),
    ("dp_fedmom", {"clip": 0.2, "noise_multiplier": 0.5, "dp_seed": 1,
                   "eta": 2.0}),
]


def _params(rng):
    return {"w": rng.normal(size=(7, 5)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32),
            "s": np.float32(rng.normal())}


def _assert_tree_close(got, want):
    got, want = tree_to_numpy(got), jax.tree.map(np.asarray, want)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def test_registry_names_match():
    assert sorted(tso.REGISTRY) == sorted(jso.REGISTRY)


@pytest.mark.parametrize("name,kw", CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_registry_entry_matches_reference(name, kw):
    rng = np.random.default_rng(len(name))
    w0 = _params(rng)
    deltas = [jax.tree.map(lambda x: (0.1 * rng.normal(size=np.shape(x)))
                           .astype(np.float32), w0) for _ in range(ROUNDS)]
    jopt, topt = jso.get(name, **kw), tso.get(name, **kw)
    assert topt.name == jopt.name
    js = jopt.init(jax.tree.map(jnp.asarray, w0))
    ts = topt.init(tree_from_numpy(w0, "cpu"))
    for d in deltas:
        js = jopt.update(js, jax.tree.map(jnp.asarray, d))
        ts = topt.update(ts, tree_from_numpy(d, "cpu"))
        _assert_tree_close(ts.w, js.w)
        _assert_tree_close(ts.extra, js.extra)
        assert ts.t == int(js.t)


def test_init_copies_w0_and_update_is_functional():
    w0 = tree_from_numpy(_params(np.random.default_rng(0)), "cpu")
    keep = {k: v.clone() for k, v in w0.items()}
    opt = tso.fedmom(eta=1.0, beta=0.9)
    state = opt.init(w0)
    assert all(state.w[k].data_ptr() != w0[k].data_ptr() for k in w0)
    assert all(state.extra["v"][k].data_ptr() != state.w[k].data_ptr()
               for k in w0)
    before = {k: v.clone() for k, v in state.w.items()}
    opt.update(state, {k: torch.ones_like(v) for k, v in w0.items()})
    for k in w0:
        assert torch.equal(w0[k], keep[k])
        assert torch.equal(state.w[k], before[k])


def test_state_carried_across_from_jax():
    """A JAX-initialised state handed over through interop continues the
    same trajectory in the port."""
    rng = np.random.default_rng(3)
    w0 = _params(rng)
    jopt, topt = jso.fedavgm(eta=1.2, beta=0.7), tso.fedavgm(eta=1.2,
                                                             beta=0.7)
    js = jopt.update(jopt.init(jax.tree.map(jnp.asarray, w0)),
                     jax.tree.map(lambda x: jnp.full(np.shape(x), 0.3), w0))
    ts = server_state_from_numpy(js.w, js.extra, js.t, "cpu")
    d = jax.tree.map(lambda x: (0.1 * rng.normal(size=np.shape(x)))
                     .astype(np.float32), w0)
    js = jopt.update(js, jax.tree.map(jnp.asarray, d))
    ts = topt.update(ts, tree_from_numpy(d, "cpu"))
    _assert_tree_close(ts.w, js.w)
    assert ts.t == 2


@pytest.mark.parametrize("kw,match", [({"clip": 0.0}, "clip"),
                                      ({"noise_multiplier": -1.0}, "noise")])
def test_dp_rejects_bad_arguments(kw, match):
    with pytest.raises(ValueError, match=match):
        tso.dp_fedavg(**kw)
