"""The port's LeNet and char-LSTM against the JAX package's, on the same
(carried-across) weights and inputs made from a numpy seed.

Tolerances (fp32, CPU): logits and losses rtol 1e-5 / atol 1e-5,
gradients rtol 1e-4 / atol 1e-6 — the two frameworks sum the convolution
and matmul products in different orders.  ``lenet_init`` draws its weights
through ``normal``, whose ``erfinv`` differs from XLA's by a few ulps:
rtol 2e-5.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import small as jsmall  # noqa: E402
from repro_torch import random as tr  # noqa: E402
from repro_torch.interop import tree_from_numpy, tree_to_numpy  # noqa: E402
from repro_torch.models import small as tsmall  # noqa: E402


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_tree_close(got, want, rtol, atol):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def _lenet_case(seed, batch=6):
    rng = np.random.default_rng(seed)
    w = _np_tree(jsmall.lenet_init(jax.random.PRNGKey(seed)))
    # non-zero biases so every parameter's gradient path is exercised
    w = {k: (v + 0.05 * rng.normal(size=v.shape)).astype(np.float32)
         for k, v in w.items()}
    x = rng.normal(size=(batch, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 62, size=batch).astype(np.int32)
    return w, {"x": x, "y": y}


@pytest.mark.parametrize("seed", [0, 1])
def test_lenet_forward_loss_grads_match(seed):
    w, batch = _lenet_case(seed)
    want_logits = np.asarray(jsmall.lenet_apply(w, batch["x"]))
    (want_loss, want_m), want_g = jax.value_and_grad(
        jsmall.lenet_loss, has_aux=True)(w, batch)
    tw = tree_from_numpy(w, "cpu")
    tb = tree_from_numpy(batch, "cpu")
    got_logits = tsmall.lenet_apply(tw, tb["x"]).numpy()
    np.testing.assert_allclose(got_logits, want_logits, rtol=1e-5, atol=1e-5)
    got_g, (got_loss, got_m) = torch.func.grad_and_value(
        tsmall.lenet_loss, has_aux=True)(tw, tb)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5)
    assert float(got_m["acc"]) == float(want_m["acc"])
    _assert_tree_close(tree_to_numpy(got_g), _np_tree(want_g), 1e-4, 1e-6)


def test_lenet_flatten_is_nhwc_order():
    """fc1 must see the pooled map flattened in NHWC order: permuting the
    fc1 rows the NCHW way would change the logits."""
    w, batch = _lenet_case(3, batch=2)
    tw = tree_from_numpy(w, "cpu")
    x = torch.as_tensor(batch["x"])
    ref = tsmall.lenet_apply(tw, x)
    perm = np.arange(256).reshape(4, 4, 16).transpose(2, 0, 1).reshape(-1)
    tw2 = dict(tw, fc1=tw["fc1"][torch.as_tensor(perm)])
    assert not torch.allclose(tsmall.lenet_apply(tw2, x), ref, atol=1e-4)


def test_lenet_init_matches_reference_draws():
    want = _np_tree(jsmall.lenet_init(jax.random.PRNGKey(5)))
    got = tree_to_numpy(tsmall.lenet_init(tr.PRNGKey(5), device="cpu"))
    _assert_tree_close(got, want, rtol=2e-5, atol=1e-7)
    assert sum(v.size for v in got.values()) == 40914


def test_lstm_forward_loss_grads_match():
    rng = np.random.default_rng(7)
    p = _np_tree(jsmall.lstm_init(jax.random.PRNGKey(2), vocab=20,
                                  hidden=16, embed=4))
    p = {k: (v + 0.05 * rng.normal(size=v.shape)).astype(np.float32)
         for k, v in p.items()}
    tok = rng.integers(0, 20, size=(3, 9)).astype(np.int32)
    lab = rng.integers(0, 20, size=(3, 9)).astype(np.int32)
    batch = {"tokens": tok, "labels": lab}
    want_logits = np.asarray(jsmall.lstm_apply(p, jnp.asarray(tok)))
    (want_loss, _), want_g = jax.value_and_grad(
        jsmall.lstm_loss, has_aux=True)(p, batch)
    tp, tb = tree_from_numpy(p, "cpu"), tree_from_numpy(batch, "cpu")
    np.testing.assert_allclose(tsmall.lstm_apply(tp, tb["tokens"]).numpy(),
                               want_logits, rtol=1e-5, atol=1e-5)
    got_g, (got_loss, _) = torch.func.grad_and_value(
        tsmall.lstm_loss, has_aux=True)(tp, tb)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5)
    _assert_tree_close(tree_to_numpy(got_g), _np_tree(want_g), 1e-4, 1e-6)


def test_lstm_init_shapes_match():
    want = jsmall.lstm_init(jax.random.PRNGKey(0))
    got = tsmall.lstm_init(tr.PRNGKey(0), device="cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
