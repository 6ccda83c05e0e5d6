"""The port's RWKV6 scan (``kernels/rwkv6_scan``) against the JAX package's,
on the CPU.

The port's plain version (``ref.rwkv6_sequential``) is held to the JAX
``ref.rwkv6_sequential``, output and final state, and the public wrapper
(``ops.rwkv6``, which takes the plain version for CPU tensors) to the JAX
Pallas kernel in interpret mode on the model's [B, S, H, D] layout, over
the reference's sweep (``tests/test_kernels.py``: four shapes, fp32 and
bf16, atol 2e-3 / 5e-2, rtol 1e-2: the reference's own tolerances between
its chunked kernel and the sequential oracle).  Also ported: the extreme
decay that must stay finite, chunk invariance (of ``layers.rwkv6_chunked``,
the chunked form on the CPU) and the refusals of the wrapper and of the
kernel's binding.

The CUDA kernel itself is held to the plain version on the card in
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.rwkv6_scan import ops as jops  # noqa: E402
from repro.kernels.rwkv6_scan import ref as jref  # noqa: E402
from repro_torch.kernels.rwkv6_scan import kernel as tkernel  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops as tops  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ref as tref  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

# tests/test_kernels.py test_rwkv6_kernel_sweep
SWEEP = [(64, 2, 64, 64, 32), (128, 4, 64, 64, 32), (96, 1, 32, 32, 32),
         (256, 2, 64, 128, 64)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one intra-op thread here: the suite runs in several worker
    processes at once, and each one's default thread pool oversubscribes
    the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, S, H, Dk, Dv, seed, lw=None):
    """r, k, v (normal), log_w = -exp(normal) and u = 0.1 normal, as the
    reference's tests draw them, from a seeded numpy generator."""
    rng = np.random.default_rng(seed)
    r = rng.normal(size=(B, S, H, Dk)).astype(np.float32)
    k = rng.normal(size=(B, S, H, Dk)).astype(np.float32)
    v = rng.normal(size=(B, S, H, Dv)).astype(np.float32)
    log_w = (-np.exp(rng.normal(size=(B, S, H, Dk))) if lw is None
             else np.full((B, S, H, Dk), lw)).astype(np.float32)
    u = (0.1 * rng.normal(size=(H, Dk))).astype(np.float32)
    return r, k, v, log_w, u


def _both(arrs, dtype):
    """(jax arrays, torch tensors): r/k/v in ``dtype``, log_w and u fp32."""
    r, k, v, lw, u = arrs
    jx = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in (r, k, v)]
    tx = [torch.as_tensor(a).to(getattr(torch, dtype)) for a in (r, k, v)]
    return (jx + [jnp.asarray(lw), jnp.asarray(u)],
            tx + [torch.as_tensor(lw), torch.as_tensor(u)])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_sequential_matches_reference(dtype, with_state):
    """The plain version against the reference's oracle on the folded
    [BH, S, D] layout, output and final state (fp32 sums of 64 products
    in another order: atol/rtol 1e-5 on values of order 10)."""
    B, S, H, Dk, Dv = 2, 48, 2, 64, 32
    (jr, jk, jv, jlw, ju), (tr, tk, tv, tlw, tu) = _both(
        _inputs(B, S, H, Dk, Dv, 1), dtype)
    jf = [x.transpose(0, 2, 1, 3).reshape(B * H, S, -1)
          for x in (jr, jk, jv, jlw)]
    tf = [x.transpose(1, 2).reshape(B * H, S, -1) for x in (tr, tk, tv, tlw)]
    jus = jnp.broadcast_to(ju[None], (B, H, Dk)).reshape(B * H, Dk)
    tus = tu[None].expand(B, H, Dk).reshape(B * H, Dk)
    s0 = (np.random.default_rng(2).normal(size=(B * H, Dk, Dv)).astype(
        np.float32) if with_state else None)
    jo, js = jref.rwkv6_sequential(*jf, jus, None if s0 is None
                                   else jnp.asarray(s0))
    to, ts = tref.rwkv6_sequential(*tf, tus, None if s0 is None
                                   else torch.as_tensor(s0))
    assert to.dtype == tv.dtype and ts.dtype == torch.float32
    assert to.shape == (B * H, S, Dv) and ts.shape == (B * H, Dk, Dv)
    atol = 1e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(_f32(to), _f32(jo), atol=atol, rtol=1e-5)
    np.testing.assert_allclose(_f32(ts), _f32(js), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,H,Dk,Dv,chunk", SWEEP)
def test_wrapper_matches_reference_kernel(S, H, Dk, Dv, chunk, dtype):
    """The wrapper on CPU tensors (the plain version, folded as the
    reference folds) against the interpret-mode Pallas kernel."""
    arrs = _inputs(2, S, H, Dk, Dv, S * H)
    (jr, jk, jv, jlw, ju), (tr, tk, tv, tlw, tu) = _both(arrs, dtype)
    before = tkernel.launches
    out = tops.rwkv6(tr, tk, tv, tlw, tu, chunk=chunk)
    assert tkernel.launches == before          # no kernel on the CPU
    assert out.shape == tv.shape and out.dtype == tv.dtype
    kern = jops.rwkv6(jr, jk, jv, jlw, ju, chunk=chunk)
    atol = 2e-3 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(_f32(out), _f32(kern), atol=atol, rtol=1e-2)
    off = tops.rwkv6(tr, tk, tv, tlw, tu, chunk=chunk, use_kernel=False)
    assert torch.equal(off, out)


def test_extreme_decay_stays_finite():
    """log w = -50 everywhere (near-instant forgetting): the plain version,
    the chunked layer and the reference's kernel stay finite and agree
    (the reference's atol 1e-3)."""
    arrs = _inputs(1, 64, 1, 32, 32, 9, lw=-50.0)
    arrs = arrs[:4] + (np.zeros_like(arrs[4]),)
    (jr, jk, jv, jlw, ju), (tr, tk, tv, tlw, tu) = _both(arrs, "float32")
    out = tops.rwkv6(tr, tk, tv, tlw, tu)
    chunked, _ = TL.rwkv6_chunked(tr, tk, tv, tlw, tu)
    kern = jops.rwkv6(jr, jk, jv, jlw, ju)
    assert bool(torch.isfinite(out).all()) and bool(
        torch.isfinite(chunked).all())
    np.testing.assert_allclose(_f32(out), _f32(kern), atol=1e-3)
    np.testing.assert_allclose(_f32(chunked), _f32(out), atol=1e-3)


def test_chunk_invariance():
    """The chunked algorithm is exact: ``layers.rwkv6_chunked`` at chunk 16
    and 64 agree (the reference's atol 2e-3, rtol 1e-3) and equal the
    sequential plain version; the wrapper's result does not depend on the
    chunk it is given."""
    arrs = _inputs(2, 128, 2, 64, 64, 4)
    _, (tr, tk, tv, tlw, tu) = _both(arrs, "float32")
    o16, s16 = TL.rwkv6_chunked(tr, tk, tv, tlw, tu, chunk=16)
    o64, s64 = TL.rwkv6_chunked(tr, tk, tv, tlw, tu, chunk=64)
    np.testing.assert_allclose(_f32(o16), _f32(o64), atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(_f32(s16), _f32(s64), atol=2e-3, rtol=1e-3)
    seq = tops.rwkv6(tr, tk, tv, tlw, tu, chunk=16)
    np.testing.assert_allclose(_f32(o16), _f32(seq), atol=2e-3, rtol=1e-3)
    assert torch.equal(seq, tops.rwkv6(tr, tk, tv, tlw, tu, chunk=64))


def test_wrapper_and_kernel_refuse_what_they_cannot_take():
    _, (r, k, v, lw, u) = _both(_inputs(1, 48, 2, 64, 64, 0), "float32")
    # the reference asserts S % min(chunk, S) == 0 before its kernel runs
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tops.rwkv6(r, k, v, lw, u, chunk=32)
    tops.rwkv6(r, k, v, lw, u, chunk=32, use_kernel=False)   # no chunks
    tops.rwkv6(r, k, v, lw, u, chunk=16)
    with pytest.raises(NotImplementedError, match="#13g"):
        tops.rwkv6(r.clone().requires_grad_(), k, v, lw, u, chunk=16)
    # the binding checks shapes and types before it needs a card
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tkernel.rwkv6(r, k, v, lw, u, chunk=16)
    with pytest.raises(ValueError, match="head dims"):
        tkernel.rwkv6(r[..., :16].contiguous(), k, v, lw, u, chunk=16)
    with pytest.raises(ValueError, match="chunk 8"):
        tkernel.rwkv6(r, k, v, lw, u, chunk=8)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tkernel.rwkv6(r, k, v, lw, u, chunk=32)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tkernel.rwkv6(r.double(), k, v, lw, u, chunk=16)
