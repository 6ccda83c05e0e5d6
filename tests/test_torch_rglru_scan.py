"""The port's RG-LRU scan (``kernels/rglru_scan``) against the JAX package's,
on the CPU.

The port's plain version (``ref.rglru_sequential``) and public wrapper
(``ops.rglru_scan``, which takes the plain version for CPU tensors) are
held to the JAX ``ref.rglru_sequential`` and to the JAX Pallas kernel
``rglru_bsr`` in interpret mode, over the reference's sweep
(``tests/test_kernels.py``: three (S, R, chunk) shapes, atol/rtol 1e-5, the
reference's own tolerance between its kernel and its oracle).  Also
ported: the reference's chunk halving (S=100), ``use_kernel=False``, the
refusals of the wrapper and of the kernel's binding, and the model-layer
test: the wrapper on the gates of an RG-LRU layer against that layer's
log-depth ``layers.rglru_scan`` (atol/rtol 1e-4, the reference's).

The CUDA kernel itself is held to the plain version on the card (bit for
bit) in ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.rglru_scan import kernel as jkernel  # noqa: E402
from repro.kernels.rglru_scan import ops as jops  # noqa: E402
from repro.kernels.rglru_scan import ref as jref  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels.rglru_scan import kernel as tkernel  # noqa: E402
from repro_torch.kernels.rglru_scan import ops as tops  # noqa: E402
from repro_torch.kernels.rglru_scan import ref as tref  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

# tests/test_kernels.py test_rglru_scan_kernel_sweep
SWEEP = [(64, 128, 32), (100, 128, 128), (256, 256, 64)]
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one intra-op thread here: the suite runs in several worker
    processes at once, and each one's default thread pool oversubscribes
    the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, S, R, seed):
    """a = sigmoid(normal + 2) in (0, 1) and b = 0.5 normal, as the
    reference's sweep draws them, from a seeded numpy generator."""
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-(rng.normal(size=(B, S, R)) + 2.0)))
    b = 0.5 * rng.normal(size=(B, S, R))
    return a.astype(np.float32), b.astype(np.float32)


@pytest.mark.parametrize("S,R,chunk", SWEEP)
def test_sweep_matches_reference(S, R, chunk):
    """The port's plain version and wrapper against the JAX oracle and the
    interpret-mode Pallas kernel."""
    a, b = _inputs(2, S, R, S + R)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    seq = tref.rglru_sequential(ta, tb)
    before = tkernel.launches
    out = tops.rglru_scan(ta, tb, chunk=chunk)
    assert tkernel.launches == before          # no kernel on the CPU
    assert out.dtype == torch.float32 and out.shape == (2, S, R)
    j_seq = np.asarray(jref.rglru_sequential(jnp.asarray(a), jnp.asarray(b)))
    j_ker = np.asarray(jops.rglru_scan(jnp.asarray(a), jnp.asarray(b),
                                       chunk=chunk))
    for got in (seq, out):
        np.testing.assert_allclose(got.numpy(), j_seq, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(got.numpy(), j_ker, atol=TOL, rtol=TOL)
    assert torch.equal(seq, out)


def test_chunk_halving_matches_reference():
    """The reference halves its chunk until it divides S (S=100: 128 -> 100,
    64 -> 4); the wrapper keeps that rule and accepts every such S."""
    assert tops.fit_chunk(100, 128) == 100
    assert tops.fit_chunk(100, 64) == 4
    assert tops.fit_chunk(4096, 128) == 128
    assert tops.fit_chunk(97, 128) == 97
    assert tops.fit_chunk(8, 128) == 8
    a, b = _inputs(2, 100, 128, 5)
    want = np.asarray(jkernel.rglru_bsr(jnp.asarray(a), jnp.asarray(b),
                                        chunk=64, interpret=True))
    got = tops.rglru_scan(torch.as_tensor(a), torch.as_tensor(b), chunk=64)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_use_kernel_false_and_input_types():
    """``use_kernel=False`` takes the plain version on any device; bf16
    inputs are cast to fp32 first, as the reference's oracle casts them."""
    a, b = _inputs(1, 48, 64, 6)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    off = tops.rglru_scan(ta, tb, use_kernel=False)
    assert torch.equal(off, tref.rglru_sequential(ta, tb))
    half = tops.rglru_scan(ta.bfloat16(), tb.bfloat16())
    assert half.dtype == torch.float32
    assert torch.equal(half, tref.rglru_sequential(ta.bfloat16().float(),
                                                   tb.bfloat16().float()))
    want = np.asarray(jops.rglru_scan(jnp.asarray(a, jnp.bfloat16),
                                      jnp.asarray(b, jnp.bfloat16),
                                      use_kernel=False))
    np.testing.assert_allclose(half.numpy(), want, atol=TOL, rtol=TOL)


def test_wrapper_and_kernel_refuse_what_they_cannot_take():
    a, b = map(torch.as_tensor, _inputs(1, 32, 64, 0))
    with pytest.raises(NotImplementedError, match="training the zoo"):
        tops.rglru_scan(a.clone().requires_grad_(), b)
    with pytest.raises(NotImplementedError, match="training the zoo"):
        tops.rglru_scan(a, b.clone().requires_grad_(), use_kernel=False)
    with pytest.raises(ValueError, match="chunk 0"):
        tops.rglru_scan(a, b, chunk=0)
    # the binding checks devices, types and shapes before it needs a card
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tkernel.rglru(a, b)
    with pytest.raises(ValueError, match=r"want a \[B,S,R\]"):
        tkernel.rglru(a[0], b[0])


def test_kernel_path_matches_model_layer():
    """``tests/test_kernels.py`` test_rglru_scan_kernel_matches_model_layer
    on the port: the wrapper on the gates of an RG-LRU layer against the
    layer's log-depth scan (atol/rtol 1e-4), and both against the same on
    the JAX side."""
    R, B, S = 128, 2, 64
    rng = np.random.default_rng(3)
    p = {"w_a": 0.1 * rng.normal(size=(R, R)),
         "w_i": 0.1 * rng.normal(size=(R, R)),
         "lam": rng.normal(size=(R,))}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    u = rng.normal(size=(B, S, R)).astype(np.float32)
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    tu = torch.as_tensor(u)
    y_model, _ = TL.rglru_scan(tp, tu)
    log_a, x_in = TL._rglru_gates(tp, tu)
    y_kernel = tops.rglru_scan(torch.exp(log_a), x_in)
    np.testing.assert_allclose(y_model.numpy(), y_kernel.numpy(), atol=1e-4,
                               rtol=1e-4)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    j_model, _ = JL.rglru_scan(jp, jnp.asarray(u))
    jla, jx = JL._rglru_gates(jp, jnp.asarray(u))
    j_kernel = jops.rglru_scan(jnp.exp(jla), jx)
    np.testing.assert_allclose(y_kernel.numpy(), np.asarray(j_kernel),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(y_model.numpy(), np.asarray(j_model),
                               atol=TOL, rtol=TOL)
