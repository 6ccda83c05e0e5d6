"""Tests of the port that need the card (marker ``gpu``).

They skip without a CUDA device.  On a GPU host, which need not have JAX
(so the repo's JAX-importing ``conftest.py`` must not load), they run with

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

This file imports torch and the port only.  Held to: the CUDA
``fedmom_update`` bit-equal to its plain version (both round every
operation to nearest, no FMA); a round on the card equal to the same round
on the CPU within atol 1e-5 (cuBLAS and the CPU sum in other orders).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import round as tround  # noqa: E402
from repro_torch.core import server_opt as tso  # noqa: E402
from repro_torch.interop import tree_from_numpy  # noqa: E402
from repro_torch.kernels.fedmom_update import kernel as tkernel  # noqa: E402
from repro_torch.kernels.fedmom_update import ops as tops  # noqa: E402
from repro_torch.kernels.fedmom_update import ref as tref  # noqa: E402

pytestmark = pytest.mark.gpu
KINDS = ("fedmom", "fedavgm")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tree(seed, device):
    rng = np.random.default_rng(seed)
    w = {"ragged": rng.normal(size=(513, 9)), "big": rng.normal(size=(32769,)),
         "scalar": np.array(rng.normal())}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    s = {k: v + 1 for k, v in w.items()}
    d = {k: 0.05 * v for k, v in w.items()}
    return [tree_from_numpy(t, device) for t in (w, s, d)]


@pytest.mark.parametrize("kind", KINDS)
def test_cuda_kernel_bit_equal_to_plain(cuda, kind):
    gen = torch.Generator(device=cuda).manual_seed(0)
    plain = tref.fedmom_flat if kind == "fedmom" else tref.fedavgm_flat
    for n, off in ((40914, 0), (40913, 1), (7, 0), (1, 0), (1 << 20, 3)):
        w, s, d = (torch.randn(n + off, generator=gen, device=cuda)[off:]
                   for _ in range(3))
        before = tkernel.launches
        wk, sk = tkernel.fused_flat(w, s, d, kind, 30.0, 0.9)
        assert tkernel.launches == before + 1
        wr, sr = plain(w, s, d, 30.0, 0.9)
        torch.cuda.synchronize()
        assert torch.equal(wk, wr) and torch.equal(sk, sr), (kind, n, off)


def test_cuda_kernel_refuses_what_it_cannot_take(cuda):
    x = torch.zeros(8, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        tkernel.fused_flat(x.double(), x, x, "fedmom", 1.0, 0.9)
    with pytest.raises(ValueError, match="contiguous 1-D"):
        tkernel.fused_flat(x.reshape(2, 4), x.reshape(2, 4),
                           x.reshape(2, 4), "fedmom", 1.0, 0.9)
    with pytest.raises(ValueError, match="holds 7 values"):
        tkernel.fused_flat(x, x[:7], x, "fedmom", 1.0, 0.9)


@pytest.mark.parametrize("kind", KINDS)
def test_cuda_ops_tree_goes_through_kernel(cuda, kind):
    w, s, d = _tree(4, cuda)
    fn = tops.fused_update_tree if kind == "fedmom" else tops.fused_avgm_tree
    plain = tref.fedmom_update if kind == "fedmom" else tref.fedavgm_update
    before = tkernel.launches
    tw, ts = fn(w, s, d, eta=2.0, beta=0.9)
    assert tkernel.launches == before + 1
    rw, rs = plain(w, s, d, 2.0, 0.9)
    for k in w:
        assert tw[k].shape == w[k].shape and tw[k].is_cuda
        assert torch.equal(tw[k], rw[k]) and torch.equal(ts[k], rs[k])


def test_cuda_round_matches_cpu_round(cuda):
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(6,)).astype(np.float32),
              "b": np.zeros((), np.float32)}
    batches = {"x": rng.normal(size=(4, 3, 5, 6)).astype(np.float32),
               "y": rng.normal(size=(4, 3, 5)).astype(np.float32)}
    weights = rng.uniform(0.05, 0.3, size=4).astype(np.float32)

    def loss(p, b):
        return torch.mean(torch.square(b["x"] @ p["w"] + p["b"] - b["y"])), {}

    rc = tround.RoundConfig(4, 3, 0.1, compute_dtype="float32")
    out = {}
    for dev in ("cpu", cuda):
        opt = tso.fedmom(eta=2.0, use_fused_kernel=True)
        before = tkernel.launches
        state, _ = tround.round_step(loss, opt,
                                     opt.init(tree_from_numpy(params, dev)),
                                     batches, weights, rc, device=dev)
        assert tkernel.launches == before + (dev == cuda)
        out[str(dev)] = state
    for k in params:
        torch.testing.assert_close(out["cuda"].w[k].cpu(), out["cpu"].w[k],
                                   rtol=1e-5, atol=1e-5)
