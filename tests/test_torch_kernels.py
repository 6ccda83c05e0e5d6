"""The port's ``fedmom_update`` against the JAX package's.

On the CPU: the port's plain version (``ref.py``) against the JAX oracle,
and the port's public wrapper (``ops.py``, which takes the plain version
for CPU tensors) against the JAX Pallas kernel in interpret mode — ragged,
scalar and bf16 leaves, both update kinds.  Both sides compute the same
float32 operations, but XLA on the CPU contracts a multiply-add into one
FMA where torch rounds twice, so fp32 leaves are held to two ulps of the
largest intermediate (|eta * delta| reaches ~15 here: atol 2e-6, rtol
2e-7), bf16 leaves to one bf16 rounding (rtol 8e-3).

The CUDA kernel itself is held to the plain version on the card in
``tests/test_torch_gpu.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.fedmom_update import kernel as jkernel  # noqa: E402
from repro.kernels.fedmom_update import ref as jref  # noqa: E402
from repro_torch.interop import tree_from_numpy, tree_to_numpy  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.fedmom_update import kernel as tkernel  # noqa: E402
from repro_torch.kernels.fedmom_update import ops as tops  # noqa: E402
from repro_torch.kernels.fedmom_update import ref as tref  # noqa: E402

KINDS = ("fedmom", "fedavgm")
F32_RTOL, F32_ATOL = 2e-7, 2e-6
BF16_RTOL, BF16_ATOL = 8e-3, 1e-3


def _mixed_tree(seed):
    """Ragged sizes (not multiples of any tile), a stream past one TPU tile,
    a bf16 leaf and a scalar leaf, in one tree."""
    rng = np.random.default_rng(seed)
    w = {"ragged": rng.normal(size=(513, 9)).astype(np.float32),
         "big": rng.normal(size=(256 * 128 + 1,)).astype(np.float32),
         "bf16": rng.normal(size=(37, 5)).astype(np.float32),
         "scalar": np.float32(rng.normal())}
    s = {k: (v + 1.0).astype(np.float32) for k, v in w.items()}
    d = {k: (0.05 * v).astype(np.float32) for k, v in w.items()}
    return w, s, d


def _jax_tree(tree):
    return {k: jnp.asarray(v, jnp.bfloat16 if k == "bf16" else jnp.float32)
            for k, v in tree.items()}


def _torch_tree(tree):
    t = tree_from_numpy(tree, "cpu")
    t["bf16"] = t["bf16"].to(torch.bfloat16)
    return t


def _assert_close(got, want):
    for k in want:
        g = np.asarray(got[k], np.float32)
        w = np.asarray(want[k], np.float32)
        tol = ((BF16_RTOL, BF16_ATOL) if k == "bf16"
               else (F32_RTOL, F32_ATOL))
        np.testing.assert_allclose(g, w, rtol=tol[0], atol=tol[1],
                                   err_msg=k)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("eta,beta", [(1.0, 0.9), (3.5, 0.0), (62.5, 0.99)])
def test_ref_matches_jax_ref(kind, eta, beta):
    w, s, d = _mixed_tree(0)
    jfn = jref.fedmom_update if kind == "fedmom" else jref.fedavgm_update
    tfn = tref.fedmom_update if kind == "fedmom" else tref.fedavgm_update
    jw, js = jfn(_jax_tree(w), _jax_tree(s), _jax_tree(d), eta, beta)
    tw, ts = tfn(_torch_tree(w), _torch_tree(s), _torch_tree(d), eta, beta)
    assert all(v.dtype == torch.float32 for v in tw.values())
    _assert_close(tree_to_numpy(tw), jw)
    _assert_close(tree_to_numpy(ts), js)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed", [1, 2])
def test_ops_matches_jax_kernel_interpret(kind, seed):
    """The port's wrapper on CPU tensors against the Pallas kernel run in
    interpret mode (as tests/test_kernels.py runs it): same values, and
    outputs follow the input leaves' dtypes on both sides."""
    w, s, d = _mixed_tree(seed)
    jw, js = jkernel.fused_update_tree(
        _jax_tree(w), _jax_tree(s), _jax_tree(d), eta=1.5, beta=0.9,
        interpret=True, kind=kind)
    fn = tops.fused_update_tree if kind == "fedmom" else tops.fused_avgm_tree
    tw, ts = fn(_torch_tree(w), _torch_tree(s), _torch_tree(d), eta=1.5,
                beta=0.9)
    assert tw["bf16"].dtype == torch.bfloat16
    assert ts["ragged"].dtype == torch.float32
    assert tw["scalar"].shape == ()
    _assert_close(tree_to_numpy(tw), jw)
    _assert_close(tree_to_numpy(ts), js)


def test_pack_unpack_roundtrip_keeps_shapes_and_dtypes():
    """The tree packing the CUDA path uses (one flat fp32 stream, split
    back per leaf) is exact and shape/dtype preserving."""
    t = _torch_tree(_mixed_tree(3)[0])
    leaves = [t[k] for k in sorted(t)]
    flat = tkernel._pack(leaves)
    assert flat.dtype == torch.float32 and flat.dim() == 1
    assert flat.numel() == sum(x.numel() for x in leaves)
    for a, b in zip(tkernel._unpack(flat, leaves), leaves):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)


def test_kernel_refuses_cpu_tensors_and_bad_kind():
    x = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tkernel.fused_flat(x, x, x, "fedmom", 1.0, 0.9)
    with pytest.raises(ValueError, match="unknown update kind"):
        tkernel.fused_flat(x, x, x, "adam", 1.0, 0.9)


def test_ops_refuses_leaves_on_several_devices():
    w = {"a": torch.zeros(3), "b": torch.zeros(3, device="meta")}
    with pytest.raises(ValueError, match="several devices"):
        tops.fused_update_tree(w, w, w, eta=1.0, beta=0.9)


def test_library_path_is_content_addressed():
    p = _build.library_path("fedmom_update")
    assert p.parent == _build.BUILD_DIR
    assert p.name.startswith("fedmom_update-") and p.suffix == ".so"
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "--fmad=false" in _build.NVCC_FLAGS
