"""The port's flash attention (``kernels/flash_attention``) against the JAX
package's, on the CPU.

The port's plain version (``ref.attention_bhsd``) is held to the JAX
``ref.attention_bhsd`` on the folded [BH, S, d] layout, and the public
wrapper (``ops.flash_attention``, which takes the plain version for CPU
tensors, and for any tensor with ``use_kernel=False``) to the JAX Pallas
kernel in interpret mode on the model's [B, S, H, d] layout.  The shapes
are the reference's sweep (``tests/test_kernels.py``: MHA, GQA, MQA, d=64
and 128, causal, window 64, non-causal, fp32 and bf16) plus gemma3-1b's
MQA head of d=256 under its 512 window.  Tolerances are the reference's
own: fp32 atol 2e-5, bf16 atol 2e-2.

The CUDA kernel itself is held to the plain version on the card in
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention import ops as jops  # noqa: E402
from repro.kernels.flash_attention import ref as jref  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as tkernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as tops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as tref  # noqa: E402

SHAPES = [
    (128, 4, 4, 64),
    (256, 4, 2, 64),      # GQA
    (128, 2, 1, 128),     # MQA
    (512, 2, 2, 64),
    (256, 4, 1, 256),     # gemma3-1b: MQA, d=256
]
MASKS = [(True, 0), (True, 64), (False, 0)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one intra-op thread here: the suite runs in several worker
    processes at once, and each one's default thread pool oversubscribes
    the host (a reduced keyed init then takes minutes, not seconds)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _atol(dtype):
    return 2e-5 if dtype == "float32" else 2e-2


def _inputs(S, Hq, Hkv, d, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(2, S, h, d)).astype(np.float32)
            for h in (Hq, Hkv, Hkv)]
    jx = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]
    tx = [torch.as_tensor(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _masks_for(S, d):
    masks = list(MASKS)
    if d == 256:
        masks.append((True, 512))          # gemma3's LOCAL window
    return masks


CASES = [(s, c, w, dt) for s in SHAPES for (c, w) in _masks_for(s[0], s[3])
         for dt in ("float32", "bfloat16")]


@pytest.mark.parametrize("shape,causal,window,dtype", CASES)
def test_plain_and_wrapper_match_reference(shape, causal, window, dtype):
    S, Hq, Hkv, d = shape
    (jq, jk, jv), (tq, tk, tv) = _inputs(S, Hq, Hkv, d, dtype, S + Hq + d)
    atol = _atol(dtype)
    # plain version against plain version, on the folded layout (MHA
    # views: each query head against its own KV head's repeat)
    fold = lambda x: x.transpose(1, 2).reshape(-1, S, d)  # noqa: E731
    rep = Hq // Hkv
    tk_r = torch.repeat_interleave(tk, rep, dim=2)
    tv_r = torch.repeat_interleave(tv, rep, dim=2)
    jk_r, jv_r = jnp.repeat(jk, rep, axis=2), jnp.repeat(jv, rep, axis=2)
    got = tref.attention_bhsd(fold(tq), fold(tk_r), fold(tv_r),
                              causal=causal, window=window)
    want = jref.attention_bhsd(jq.transpose(0, 2, 1, 3).reshape(-1, S, d),
                               jk_r.transpose(0, 2, 1, 3).reshape(-1, S, d),
                               jv_r.transpose(0, 2, 1, 3).reshape(-1, S, d),
                               causal=causal, window=window)
    assert got.dtype == tq.dtype
    np.testing.assert_allclose(_f32(got), _f32(want), atol=atol, rtol=0)
    # the public wrapper on CPU tensors (plain version, GQA expanded
    # inside) against the interpret-mode Pallas kernel
    before = tkernel.launches
    out = tops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert tkernel.launches == before          # no kernel on the CPU
    assert out.shape == tq.shape and out.dtype == tq.dtype
    kern = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                block_q=64, block_k=64)
    np.testing.assert_allclose(_f32(out), _f32(kern), atol=atol, rtol=0)
    off = tops.flash_attention(tq, tk, tv, causal=causal, window=window,
                               use_kernel=False)
    assert torch.equal(off, out)


def test_window_one_keeps_only_the_diagonal():
    """Window 1 under the causal mask keeps each row's own key alone, so
    the output is V itself, in the plain version and through the
    wrapper."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.as_tensor(rng.normal(size=(1, 128, 2, 64)).astype(
        np.float32)) for _ in range(3))
    torch.testing.assert_close(
        tops.flash_attention(q, k, v, causal=True, window=1), v)


def test_wrapper_refuses_grad_and_kernel_refuses_cpu():
    q = torch.zeros((1, 128, 2, 64), requires_grad=True)
    with pytest.raises(NotImplementedError, match="forward only"):
        tops.flash_attention(q, q.detach(), q.detach())
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tkernel.flash_attention(q.detach(), q.detach(), q.detach())
