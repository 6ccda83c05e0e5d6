"""Tests of the port that need the card (marker ``gpu``).

They skip without a CUDA device.  On a GPU host, which need not have JAX
(so the repo's JAX-importing ``conftest.py`` must not load), they run with

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

This file imports torch and the port only.  Held to: the CUDA
``fedmom_update`` bit-equal to its plain version (both round every
operation to nearest, no FMA); the CUDA ``client_step`` equal to its plain
version within atol/rtol 1e-5 (hand-fused gradients summed in another
order), also with a ring of fewer step buffers than steps and with ``xs``
off a 16-byte boundary, bit-equal to its plain-torch model of the
summation order (``tests/test_torch_client_step_model.py``), its first
design (the yardstick) equal to it within 1e-5 and every ring depth bit
for bit; a
round, and a few rounds of both streaming lanes, on the card
equal to the same on the CPU within atol 1e-5 (cuBLAS and the CPU sum in
other orders); the CUDA ``flash_attention`` equal to its plain version at
the reference's tolerances (fp32 atol 2e-5, bf16 atol 2e-2) over the
reference's sweep, at d=256 and at the bf16 kernel's packed, partial-tile
and ragged-window cases, and a CUDA-graph replay of it equal to the eager
call; prefill through the kernel equal to a plain path with fp32
probabilities (fp32 atol 1e-4, bf16 atol 0.1) and, in bf16, to the xla
path (bf16 probabilities), tolerances that a window off by one in one
layer exceeds; ``use_kernel=False`` on every wrapper launching nothing;
the CUDA
``rwkv6_scan`` equal to its plain version at the reference's tolerances
(fp32 atol 2e-3, bf16 atol 5e-2, rtol 1e-2) over the reference's sweep, at
rwkv6-7b's head shape, at the model's slow decays over 1024 tokens and at
extreme decay (atol 1e-3, both dtypes), and a CUDA-graph replay of it equal
to the eager call; the forward of reduced
rwkv6-7b through the kernel equal to the plain ``rwkv6_chunked`` path
(fp32 atol 5e-4 / rtol 1e-4, the reference's; bf16 atol 0.1), a tolerance
that one layer's kernel run without its bonus ``u`` exceeds; the CUDA
``rglru_scan`` bit-equal to its plain version (both round the product and
the sum each once, in the same order) over the reference's sweep, at a
ragged chunk, at a = 1 - 1e-7 and at recurrentgemma-9b's width; the kernel
on the gates of a reduced recurrentgemma-9b layer equal to the layer's
log-depth scan (atol/rtol 1e-4, the reference's), a tolerance that the
kernel fed ``a`` shifted one step exceeds; teacher-forced prefill + decode
of reduced recurrentgemma-9b in the stacked layout on the card equal to
its full forward; the scanned and device planes' CUDA-graph replays
bit-equal to the eager loop over the same chunks (two and a ragged one)
and to the per-round plane (linreg, so no cuDNN; with H_k, a diurnal
M(t) and DP noise keyed by the device round index), a capture refusing a
pageable copy, a chunk's metrics outliving the next replay, ``plan=None``
staying per-round on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import DeviceUniformSampler  # noqa: E402
from repro_torch.core import round as tround  # noqa: E402
from repro_torch.core import server_opt as tso  # noqa: E402
from repro_torch.data import FederatedDataset  # noqa: E402
from repro_torch.interop import tree_from_numpy  # noqa: E402
from repro_torch.kernels.client_step import kernel as cs_kernel  # noqa: E402
from repro_torch.kernels.client_step import ops as cs_ops  # noqa: E402
from repro_torch.kernels.client_step import ref as cs_ref  # noqa: E402
from repro_torch.kernels.fedmom_update import kernel as tkernel  # noqa: E402
from repro_torch.kernels.fedmom_update import ops as tops  # noqa: E402
from repro_torch.kernels.fedmom_update import ref as tref  # noqa: E402
from repro_torch.kernels.rglru_scan import kernel as rg_kernel  # noqa: E402
from repro_torch.kernels.rglru_scan import ops as rg_ops  # noqa: E402
from repro_torch.kernels.rglru_scan import ref as rg_ref  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402,E501
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.rwkv6_scan import kernel as rw_kernel  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops as rw_ops  # noqa: E402
from repro_torch.launch.plan import CacheSpec, ExecutionPlan  # noqa: E402
from repro_torch.launch.train import FederatedTrainer  # noqa: E402

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


def _tree_case(name, device, seed=0):
    """(w, state, delta) trees of the tree launch's card tests, as in
    ``chip_smoke.py`` phase 3: LeNet's (``small.lenet_init``'s shapes), the
    streaming lanes' linreg tree, a mixed tree (ragged, bf16 and fp16 in
    the vector path, bf16 off a 16-byte boundary, a scalar, a zero-size
    leaf, an offset view, a non-contiguous leaf), 1,000 small ragged leaves
    (several tables), and one leaf long enough to stream its stores."""
    from repro_torch import random as prng
    from repro_torch.models import small
    rng = np.random.default_rng(seed)

    def t(shape, dtype=torch.float32, offset=0, transpose=False):
        n = int(np.prod(shape))
        x = torch.as_tensor(rng.normal(size=n + offset).astype(np.float32),
                            device=device)[offset:]
        x = x.reshape(shape[::-1]).T if transpose else x.reshape(shape)
        return x.to(dtype)

    if name == "lenet":
        shapes = [tuple(x.shape) for x in
                  small.lenet_init(prng.PRNGKey(0)).values()]
        w = {f"l{i}": t(sh) for i, sh in enumerate(shapes)}
    elif name == "linreg":
        w = {"w": t((64,)), "b": t(())}
    elif name == "mixed":
        w = {"ragged": t((513, 9)), "bf16": t((37, 5), torch.bfloat16),
             "f16": t((11, 3), torch.float16), "scalar": t(()),
             "zero": t((0, 4)), "offset": t((1029,), offset=1),
             "bf16_offset": t((77,), torch.bfloat16, offset=1),
             "strided": t((33, 17), transpose=True)}
        w["bf16_offset"] = torch.zeros(78, dtype=torch.bfloat16,
                                       device=device)[1:].copy_(
                                           w["bf16_offset"])
        assert not w["strided"].is_contiguous()
    elif name == "1000-leaves":
        w = {f"l{i:04d}": t((int(n),))
             for i, n in enumerate(rng.integers(1, 200, size=1000))}
    else:
        w = {"big": t(((1 << 22) + 5,)), "small": t((7,))}
    s = {k: (v + 1).to(v.dtype) for k, v in w.items()}
    d = {k: (0.05 * v).float() for k, v in w.items()}
    if name == "mixed":
        s["offset"] = torch.zeros(1030, device=device)[1:].copy_(s["offset"])
    return w, s, d


TREES = ("lenet", "linreg", "mixed", "1000-leaves", "large")


def _n_tables(w):
    sizes = [x.numel() for x in w.values()]
    return len(tkernel.tree_plan(sizes, [True] * len(sizes)))


def _assert_tree_equal(got, want, like):
    for k in like:
        assert got[k].shape == like[k].shape, k
        assert got[k].dtype == like[k].dtype, k
        assert torch.equal(got[k], want[k].to(like[k].dtype)), k


@pytest.mark.parametrize("tree", TREES)
@pytest.mark.parametrize("kind", KINDS)
def test_cuda_tree_bit_equal_to_plain(cuda, kind, tree):
    """The path's call (``ops``) on every tree of phase 3: bit-equal to the
    plain version on every leaf, one launch a table."""
    w, s, d = _tree_case(tree, cuda)
    fn = tops.fused_update_tree if kind == "fedmom" else tops.fused_avgm_tree
    plain = tref.fedmom_update if kind == "fedmom" else tref.fedavgm_update
    before = tkernel.launches
    tw, ts = fn(w, s, d, eta=30.0, beta=0.9)
    assert tkernel.launches == before + _n_tables(w)
    rw, rs = plain(w, s, d, 30.0, 0.9)
    torch.cuda.synchronize()
    _assert_tree_equal(tw, rw, w)
    _assert_tree_equal(ts, rs, s)


@pytest.mark.parametrize("tree", ["mixed", "1000-leaves", "lenet"])
@pytest.mark.parametrize("kind", KINDS)
def test_cuda_tree_per_leaf_equals_fused(cuda, kind, tree):
    """``fuse_tree=False`` (one launch a leaf, none for a zero-size leaf)
    is bit-equal to the one launch a table."""
    w, s, d = _tree_case(tree, cuda, seed=1)
    fw, fs = tkernel.fused_update_tree(w, s, d, eta=2.0, beta=0.9,
                                       kind=kind)
    before = tkernel.launches
    pw, ps = tkernel.fused_update_tree(w, s, d, eta=2.0, beta=0.9,
                                       kind=kind, fuse_tree=False)
    assert tkernel.launches == before + sum(x.numel() > 0
                                            for x in w.values())
    torch.cuda.synchronize()
    _assert_tree_equal(pw, fw, w)
    _assert_tree_equal(ps, fs, s)


def test_cuda_tree_without_elements_launches_nothing(cuda):
    z = {"a": torch.zeros(0, device=cuda), "b": torch.zeros(2, 0,
                                                            device=cuda)}
    before = tkernel.launches
    tw, ts = tops.fused_update_tree(z, z, z, eta=1.0, beta=0.9)
    assert tw["b"].shape == (2, 0) and ts["a"].is_cuda
    assert tops.fused_avgm_tree({}, {}, {}, eta=1.0, beta=0.9) == ({}, {})
    assert tkernel.launches == before


@pytest.mark.parametrize("kind", KINDS)
def test_cuda_packed_design_counts_nothing(cuda, kind):
    """The packed yardstick (pack, one flat launch, split) equals the path's
    call bit for bit and moves no counter."""
    w, s, d = _tree_case("lenet", cuda, seed=2)
    tw, ts = tkernel.fused_update_tree(w, s, d, eta=30.0, beta=0.9,
                                       kind=kind)
    before = tkernel.launches
    pw, ps = tkernel.fused_update_tree_design(w, s, d, eta=30.0, beta=0.9,
                                              kind=kind, design="packed")
    assert tkernel.launches == before
    torch.cuda.synchronize()
    _assert_tree_equal(pw, tw, w)
    _assert_tree_equal(ps, ts, s)


@pytest.mark.parametrize("kind", KINDS)
def test_cuda_tree_graph_replay_equals_eager(cuda, kind):
    """The tables travel in the kernel node: a replay on new inputs in the
    captured buffers equals the eager call on them."""
    w, s, d = _tree_case("lenet", cuda, seed=3)

    def call():
        return tkernel.fused_update_tree(w, s, d, eta=30.0, beta=0.9,
                                         kind=kind)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = tkernel.launches
    with torch.cuda.graph(graph):
        gw, gs = call()
    assert tkernel.launches == before + 1
    new = _tree_case("lenet", cuda, seed=4)
    for dst, src in zip((w, s, d), new):
        for k in dst:
            dst[k].copy_(src[k])
    graph.replay()
    ew, es = tkernel.fused_update_tree(*new, eta=30.0, beta=0.9, kind=kind)
    torch.cuda.synchronize()
    _assert_tree_equal(gw, ew, w)
    _assert_tree_equal(gs, es, s)


def test_cuda_bf16_w_with_fp32_m_keeps_dtypes(cuda):
    """FedAvgM over a bf16 model with its fp32 momentum: outputs follow
    the input leaves' dtypes, each rounded once from the fp32 result."""
    w, _, d = _tree_case("lenet", cuda, seed=5)
    w = {k: v.to(torch.bfloat16) for k, v in w.items()}
    m = {k: torch.randn(v.shape, device=cuda) for k, v in w.items()}
    tw, tm = tops.fused_avgm_tree(w, m, d, eta=3.0, beta=0.9)
    rw, rm = tref.fedavgm_update(w, m, d, 3.0, 0.9)
    torch.cuda.synchronize()
    assert all(v.dtype == torch.bfloat16 for v in tw.values())
    assert all(v.dtype == torch.float32 for v in tm.values())
    _assert_tree_equal(tw, rw, w)
    _assert_tree_equal(tm, rm, m)


def test_cuda_tree_refuses_what_it_cannot_take(cuda):
    w = {"a": torch.zeros(4, device=cuda), "b": torch.zeros(3, device=cuda)}
    with pytest.raises(ValueError, match="floating leaves"):
        tkernel.fused_update_tree(
            w, {"a": w["a"], "b": torch.zeros(3, dtype=torch.int64,
                                               device=cuda)},
            w, eta=1.0, beta=0.9)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tkernel.fused_update_tree(w, {"a": w["a"], "b": torch.zeros(3)}, w,
                                  eta=1.0, beta=0.9)
    with pytest.raises(ValueError, match="has shape"):
        tkernel.fused_update_tree(w, w, {"a": w["a"].reshape(2, 2),
                                         "b": w["b"]}, eta=1.0, beta=0.9)
    with pytest.raises(ValueError, match="several devices"):
        tops.fused_update_tree(w, {"a": w["a"], "b": torch.zeros(3)}, w,
                               eta=1.0, beta=0.9)


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


def _cs_inputs(C, H, b, D, N, device, seed=0, masked=False):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, device=device)
    xs = t(rng.normal(size=(C + 2, N, D)).astype(np.float32))
    ys = t(rng.normal(size=(C + 2, N)).astype(np.float32))
    slots = t(rng.permutation(C + 2)[:C].astype(np.int32))
    idx = t(rng.integers(0, N, size=(C, H * b)).astype(np.int32))
    w = t(rng.normal(size=D).astype(np.float32))
    bias = t(np.float32(rng.normal()))
    mask = None
    if masked:
        h_k = rng.integers(0, H + 1, size=C)
        h_k[0] = 0
        mask = t((np.arange(H)[None, :] < h_k[:, None]).astype(np.float32))
    return xs, ys, slots, idx, w, bias, mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("C,H,b,D,N", [
    (8, 4, 8, 64, 8192), (1, 4, 8, 64, 4), (3, 2, 3, 65, 9),
    (2, 1, 1, 1024, 7), (2, 2, 16, 1024, 20), (4, 3, 130, 8, 50),
    (1, 1, 64, 900, 70)])
def test_client_step_kernel_matches_plain(cuda, C, H, b, D, N, masked):
    """The streaming lane's tier shapes, a ragged D, the largest D, a
    block past 48 KB of shared memory, a batch wider than a block and a
    step within a few hundred bytes of the card's shared memory."""
    xs, ys, slots, idx, w, bias, mask = _cs_inputs(C, H, b, D, N, cuda,
                                                   masked=masked)
    before = cs_kernel.launches
    got = cs_ops.client_step(xs, ys, slots, idx, w, bias, 0.05, H, b,
                             step_mask=mask)
    assert cs_kernel.launches == before + 1
    want = cs_ref.client_step(xs, ys, slots, idx, w, bias, 0.05, H, b,
                              step_mask=mask)
    torch.cuda.synchronize()
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, atol=1e-5, rtol=1e-5)
    if masked:
        assert torch.equal(got[0][0], w) and float(got[2][0]) == 0.0


# SGD at lr 0.05 on 1,024 unit-normal features diverges (w grows ~100x in
# four steps), and there the fp32 plain version is itself 2x the tolerance
# off the fp64 answer; 1e-3 keeps every step stable
RING_LR = 1e-3


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("C,H,b,D,N", [(4, 4, 16, 1024, 64),
                                       (2, 3, 48, 1024, 60)])
def test_client_step_ring_matches_plain(cuda, C, H, b, D, N, masked):
    """The staged design's ring: fewer step buffers than steps (K = 3 of
    4), and one (a step of 192 KB)."""
    xs, ys, slots, idx, w, bias, mask = _cs_inputs(C, H, b, D, N, cuda,
                                                   masked=masked)
    K = cs_kernel.plan_for(xs, C, H, b)[0]
    assert K == (3 if b == 16 else 1)
    before = cs_kernel.launches
    got = cs_ops.client_step(xs, ys, slots, idx, w, bias, RING_LR, H, b,
                             step_mask=mask)
    assert cs_kernel.launches == before + 1
    want = cs_ref.client_step(xs, ys, slots, idx, w, bias, RING_LR, H, b,
                              step_mask=mask)
    torch.cuda.synchronize()
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, atol=1e-5, rtol=1e-5)
    if masked:
        assert torch.equal(got[0][0], w) and float(got[2][0]) == 0.0


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("C,H,b,D,N,lr", [
    (8, 4, 8, 64, 8192, 0.05), (3, 2, 3, 65, 9, 0.05),
    (4, 3, 130, 8, 50, 0.05), (2, 3, 20, 200, 30, 0.05),
    (4, 4, 16, 1024, 64, RING_LR), (1, 1, 64, 900, 70, RING_LR)])
def test_client_step_kernel_bit_equal_to_model(cuda, C, H, b, D, N, lr,
                                               masked):
    """The kernel sums in exactly the order of its plain-torch model
    (``tests/test_torch_client_step_model.py``), the model the CPU tests
    hold to the JAX package: one warp and several, whole and ragged rows
    and groups."""
    from test_torch_client_step_model import staged_model
    xs, ys, slots, idx, w, bias, mask = _cs_inputs(C, H, b, D, N, cuda,
                                                   seed=6, masked=masked)
    got = cs_ops.client_step(xs, ys, slots, idx, w, bias, lr, H, b,
                             step_mask=mask)
    host = [None if a is None else a.cpu().numpy()
            for a in (xs, ys, slots, idx, w, bias, mask)]
    want = staged_model(*host[:6], lr, H, b, host[6],
                        cs_kernel.plan_for(xs, C, H, b)[1])
    for g, r in zip(got, want):
        assert torch.equal(g.cpu(), r)


@pytest.mark.parametrize("D,lr", [(64, 0.05), (1024, RING_LR)])
def test_client_step_kernel_takes_unaligned_xs(cuda, D, lr):
    """``xs`` a contiguous view 4 bytes past a 16-byte boundary: the kernel
    copies rows 4 bytes at a time and still matches its plain version."""
    C, H, b, N = 3, 4, 8, 12
    xs, ys, slots, idx, w, bias, mask = _cs_inputs(C, H, b, D, N, cuda,
                                                   seed=4, masked=True)
    store = torch.empty(xs.numel() + 1, device=cuda)
    view = store[1:].view(xs.shape)
    view.copy_(xs)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    got = cs_ops.client_step(view, ys, slots, idx, w, bias, lr, H, b,
                             step_mask=mask)
    want = cs_ref.client_step(xs, ys, slots, idx, w, bias, lr, H, b,
                              step_mask=mask)
    torch.cuda.synchronize()
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("C,H,b,D,N,lr", [(8, 4, 8, 64, 8192, 0.05),
                                          (4, 4, 16, 1024, 64, RING_LR)])
def test_client_step_designs_agree_and_count_nothing(cuda, C, H, b, D, N,
                                                     lr):
    """The yardstick (v1) agrees with the path's kernel within 1e-5, the
    staged design with and without helper warps at every ring depth that
    fits one block bit for bit (the ring and the helpers move copies, not
    sums); no yardstick moves ``launches``."""
    xs, ys, slots, idx, w, bias, mask = _cs_inputs(C, H, b, D, N, cuda,
                                                   seed=5, masked=True)
    path = cs_ops.client_step(xs, ys, slots, idx, w, bias, lr, H, b,
                              step_mask=mask)
    before = cs_kernel.launches
    v1 = cs_kernel.client_step_design(xs, ys, slots, idx, w, bias, lr, H, b,
                                      step_mask=mask, design="v1")
    rings = [cs_kernel.client_step_design(
        xs, ys, slots, idx, w, bias, lr, H, b, step_mask=mask,
        design=design, ring=ring)
        for ring in range(1, cs_kernel.plan_for(xs, C, H, b, 1)[0] + 1)
        for design in ("staged", "staged_solo")]
    torch.cuda.synchronize()
    assert cs_kernel.launches == before
    for g, r in zip(v1, path):
        torch.testing.assert_close(g, r, atol=1e-5, rtol=1e-5)
    for got in rings:
        for g, r in zip(got, path):
            assert torch.equal(g, r)
    with pytest.raises(ValueError, match="design"):
        cs_kernel.client_step_design(xs, ys, slots, idx, w, bias, 0.05, H,
                                     b, design="v2")


def test_client_step_of_no_clients_launches_nothing(cuda):
    """A tier with no clients returns empty outputs and leaves the launch
    count where it was."""
    xs, ys, slots, idx, w, bias, _ = _cs_inputs(2, 2, 2, 8, 6, cuda)
    before = cs_kernel.launches
    got = cs_ops.client_step(xs, ys, slots[:0], idx[:0], w, bias, 0.1, 2, 2)
    torch.cuda.synchronize()
    assert cs_kernel.launches == before
    assert [tuple(g.shape) for g in got] == [(0, 8), (0,), (0,)]


def test_client_step_kernel_refuses_what_it_cannot_take(cuda):
    xs, ys, slots, idx, w, bias, _ = _cs_inputs(2, 2, 2, 8, 6, cuda)
    args = [xs, ys, slots, idx, w, bias]

    def call(i, x, **kw):
        a = list(args)
        a[i] = x
        return cs_kernel.client_step(*a, 0.1, kw.get("H", 2), kw.get("b", 2))

    with pytest.raises(ValueError, match="float32"):
        call(0, xs.double())
    with pytest.raises(ValueError, match="CUDA tensors only"):
        call(1, ys.cpu())
    with pytest.raises(ValueError, match="int32"):
        call(2, slots.long())
    with pytest.raises(ValueError, match="contiguous"):
        call(3, idx.t().contiguous().t())
    with pytest.raises(ValueError, match="shape"):
        call(3, idx[:, :3].contiguous())
    big = torch.zeros((1, 4, 1025), device=cuda)
    with pytest.raises(ValueError, match="at most 1024"):
        cs_kernel.client_step(big, ys[:1, :4].contiguous(), slots[:1],
                              idx[:1], torch.zeros(1025, device=cuda),
                              bias, 0.1, 2, 2)
    wide = torch.zeros((1, 4, 1024), device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        cs_kernel.client_step(wide, ys[:1, :4].contiguous(), slots[:1],
                              torch.zeros((1, 64), dtype=torch.int32,
                                          device=cuda),
                              torch.zeros(1024, device=cuda), bias, 0.1, 1,
                              64)


def _linreg_loss(p, b):
    return torch.mean(torch.square(b["x"] @ p["w"] + p["b"] - b["y"])), {}


@pytest.mark.parametrize("hook", [False, True])
def test_streaming_lanes_on_cuda_match_cpu(cuda, hook):
    """A few rounds of the padded lane, and of the bucketed lane through
    the fused hook, on the card and on the CPU."""
    rng = np.random.default_rng(0)
    clients = []
    for r in range(24):
        n = max(2, int(256 / (r + 1) ** 1.2))
        x = rng.normal(size=(n, 16)).astype(np.float32)
        clients.append({"x": x, "y": (x @ rng.normal(size=16)).astype(
            np.float32)})
    plan = ExecutionPlan(plane="streaming", chunk_rounds=3,
                         cache=CacheSpec(bucketed=hook))
    out = {}
    for dev in ("cpu", cuda):
        ds = FederatedDataset([dict(c) for c in clients], seed=1)
        opt = tso.fedmom(eta=2.0, use_fused_kernel=True)
        tr = FederatedTrainer(
            loss_fn=_linreg_loss, server_opt=opt,
            rcfg=tround.RoundConfig(4, 3, 0.05, compute_dtype="float32"),
            dataset=ds, sampler=DeviceUniformSampler(ds.population(), 4,
                                                     seed=2),
            state=opt.init({"w": torch.zeros(16), "b": torch.zeros(())}),
            client_step_fn=cs_ops.linreg_tier_step() if hook else None,
            local_batch=4, device=dev)
        before = cs_kernel.launches
        hist = tr.run(6, plan=plan, verbose=False)
        launched = cs_kernel.launches - before
        assert launched == 0 if (dev == "cpu" or not hook) else launched > 0
        out[str(dev)] = (tr.state, [r["loss"] for r in hist])
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-5)
    for k in ("w", "b"):
        torch.testing.assert_close(out["cuda"][0].w[k].cpu(),
                                   out["cpu"][0].w[k], rtol=1e-5, atol=1e-5)


# the reference's sweep (tests/test_kernels.py), gemma3's MQA d=256 shape,
# then the bf16 kernel's cases: 16 query heads over 1 KV head packed into
# a tile at d=256 (recurrentgemma-9b), 8 over 2, a group of 3 (no factor
# of 64 but 1: one head a tile), and S=320 (a multiple of 64, not of 128:
# one head a tile of 128 positions leaves a partial last tile)
FLASH_SHAPES = [(128, 4, 4, 64), (256, 4, 2, 64), (128, 2, 1, 128),
                (512, 2, 2, 64), (1024, 4, 1, 256), (256, 16, 1, 256),
                (256, 8, 2, 64), (256, 3, 1, 64), (320, 3, 1, 64),
                (320, 2, 2, 128)]


def _flash_inputs(S, Hq, Hkv, d, dtype, device, seed):
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)
    return tuple(torch.as_tensor(rng.normal(size=(2, S, h, d)).astype(
        np.float32), device=device).to(dt) for h in (Hq, Hkv, Hkv))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64),
                                           (False, 0), (True, 512),
                                           (True, 100)])
@pytest.mark.parametrize("S,Hq,Hkv,d", FLASH_SHAPES)
def test_flash_attention_kernel_matches_plain(cuda, S, Hq, Hkv, d, causal,
                                              window, dtype):
    """Kernel against the plain version on the same card inputs, at the
    reference's tolerances, over ``FLASH_SHAPES`` and a window (100) that
    is no multiple of any tile.  Called in the reference's sweep form
    (``block_q=64, block_k=64``, which S=320 needs)."""
    dt = getattr(torch, dtype)
    q, k, v = _flash_inputs(S, Hq, Hkv, d, dtype, cuda, S + Hq + d)
    before = fa_kernel.launches
    out = fa_ops.flash_attention(q, k, v, causal=causal, window=window,
                                 block_q=64, block_k=64)
    assert fa_kernel.launches == before + 1
    ref = fa_ops.flash_attention(q, k, v, causal=causal, window=window,
                                 use_kernel=False)
    torch.cuda.synchronize()
    assert out.dtype == dt and out.shape == q.shape
    atol = 2e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_graph_replay_matches_eager(cuda, dtype):
    """The launch captured in a CUDA graph (its tensor maps are kernel
    arguments built at capture) and replayed on new inputs written into
    the captured buffers gives the eager call's output."""
    q, k, v = _flash_inputs(512, 16, 1, 256, dtype, cuda, 3)
    q2, k2, v2 = _flash_inputs(512, 16, 1, 256, dtype, cuda, 4)

    def call():
        return fa_ops.flash_attention(q, k, v, causal=True, window=100)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for src in ((q, k, v), (q2, k2, v2)):
        for dst, x in zip((q, k, v), src):
            dst.copy_(x)
        graph.replay()
        want = fa_ops.flash_attention(*src, causal=True, window=100)
        torch.cuda.synchronize()
        assert torch.equal(out, want)


def test_use_kernel_false_launches_nothing(cuda):
    """Every wrapper that takes ``use_kernel`` routes ``False`` to its
    plain version on the card: no launch counter moves."""
    counters = (tkernel, cs_kernel, fa_kernel, rw_kernel, rg_kernel)
    before = [m.launches for m in counters]
    w, s, d = _tree(5, cuda)
    tops.fused_update_tree(w, s, d, eta=2.0, beta=0.9, use_kernel=False)
    tops.fused_avgm_tree(w, s, d, eta=2.0, beta=0.9, use_kernel=False)
    rng = np.random.default_rng(0)
    t = lambda a: torch.as_tensor(a, device=cuda)  # noqa: E731
    xs = t(rng.normal(size=(3, 10, 6)).astype(np.float32))
    ys = t(rng.normal(size=(3, 10)).astype(np.float32))
    slots = t(np.array([2, 0], np.int32))
    idx = t(rng.integers(0, 10, size=(2, 8)).astype(np.int32))
    wv, bias = t(np.zeros(6, np.float32)), t(np.float32(0.0))
    cs_ops.client_step(xs, ys, slots, idx, wv, bias, 0.1, 4, 2,
                       use_kernel=False)

    class View:
        tier_arrays = ({"x": xs, "y": ys},)
        client_slots = slots.long()
        device = cuda

    cs_ops.linreg_tier_step(use_kernel=False)(
        View(), 0, torch.tensor([0, 1]), idx, {"w": wv, "b": bias}, 0.1,
        None, 4, 2)
    q, k, v = _flash_inputs(128, 4, 1, 64, "bfloat16", cuda, 0)
    fa_ops.flash_attention(q, k, v, use_kernel=False)
    r, kk, vv, lw, u = _rwkv_inputs(1, 64, 2, 64, 64, cuda, "float32", 0)
    rw_ops.rwkv6(r, kk, vv, lw, u, use_kernel=False)
    a = t(rng.uniform(0.5, 1.0, size=(1, 32, 16)).astype(np.float32))
    rg_ops.rglru_scan(a, a, use_kernel=False)
    torch.cuda.synchronize()
    assert [m.launches for m in counters] == before


def test_flash_attention_kernel_refuses_what_it_cannot_take(cuda):
    q = torch.zeros((1, 128, 2, 64), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa_kernel.flash_attention(q[..., :32].contiguous(),
                                  q[..., :32].contiguous(),
                                  q[..., :32].contiguous())
    with pytest.raises(ValueError, match="self-attention"):
        fa_kernel.flash_attention(q, q[:, :64].contiguous(),
                                  q[:, :64].contiguous())
    with pytest.raises(ValueError, match="tile"):
        fa_kernel.flash_attention(q[:, :96].contiguous(),
                                  q[:, :96].contiguous(),
                                  q[:, :96].contiguous())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa_kernel.flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match="contiguous"):
        fa_kernel.flash_attention(q.transpose(1, 2).contiguous()
                                  .transpose(1, 2), q, q)
    with pytest.raises(NotImplementedError, match="forward only"):
        fa_ops.flash_attention(q.requires_grad_(), q, q)


# max abs difference of the prefill logits of reduced gemma3-1b (|logit|
# up to 3.3), kernel path against a plain path with fp32 probabilities
# (the bf16 kernel carries them in two bf16 parts, ~16 bits): above the
# largest sound reading (bf16: 4.9e-2, three bf16 ulps of such a logit),
# below that of one layer's window off by one (0.52)
GENERATE_ATOL = {"float32": 1e-4, "bfloat16": 0.1}


def _reduced_gemma_prefill(cuda, dtype, monkeypatch):
    """Reduced gemma3-1b (window 64) with keyed weights on the card and B=2
    prompts of 256 tokens (every prefill layer takes the kernel).  Returns
    (cfg, params, prompts, prefill, window_off_by_one): ``prefill(cfg,
    attention)`` gives the prefill logits with ``ops.flash_attention``
    replaced by ``attention`` and the kernel launches it made;
    ``window_off_by_one`` is the kernel with the first call's (a LOCAL
    layer's) window one short, its windows kept in ``.seen``."""
    from repro_torch import random as prng
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = get_config("gemma3-1b-reduced").replace(dtype=dtype,
                                                  attention_impl="pallas")
    params, _ = T.init(cfg, prng.PRNGKey(0), device=cuda)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (2, 256))
    tokens = torch.as_tensor(prompts, device=cuda)
    kernel_attention = fa_ops.flash_attention

    def prefill(c, attention=kernel_attention):
        monkeypatch.setattr(fa_ops, "flash_attention", attention)
        cache, _ = T.init_cache(c, 2, 256, device=cuda)
        before = fa_kernel.launches
        logits, _ = T.prefill(params, c, {"tokens": tokens}, cache)
        monkeypatch.setattr(fa_ops, "flash_attention", kernel_attention)
        return logits.float().cpu(), fa_kernel.launches - before

    def window_off_by_one(q, k, v, *, causal, window):
        window_off_by_one.seen.append(window)
        return kernel_attention(q, k, v, causal=causal, window=window - (
            len(window_off_by_one.seen) == 1))

    window_off_by_one.seen = []
    return cfg, params, prompts, prefill, window_off_by_one


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_generate_through_kernel_matches_plain_attention(cuda, dtype,
                                                         monkeypatch):
    """prefill and generate on reduced gemma3-1b (window 64, S0=256 so
    every prefill layer takes the kernel), same weights.  The kernel path
    is held to a plain path with fp32 probabilities: in fp32
    ``attention_impl="xla"``; in bf16 the kernel's plain version
    (``use_kernel=False``), since the xla path rounds the probabilities to
    bf16 before P.V where the bf16 kernel keeps them in two bf16 parts
    (``test_bf16_prefill_through_kernel_matches_xla`` holds it to the xla
    path).  The tolerance must also catch a planted fault: the first
    (LOCAL) layer's kernel run with window 63."""
    from repro_torch.serve import generate
    cfg, params, prompts, prefill, window_off_by_one = (
        _reduced_gemma_prefill(cuda, dtype, monkeypatch))
    kernel_attention = fa_ops.flash_attention

    def plain_probs(q, k, v, *, causal, window):
        return kernel_attention(q, k, v, causal=causal, window=window,
                                use_kernel=False)

    got, launches = prefill(cfg)
    assert launches == cfg.n_layers
    if dtype == "float32":
        want, plain_launches = prefill(cfg.replace(attention_impl="xla"))
    else:
        want, plain_launches = prefill(cfg, plain_probs)
    assert plain_launches == 0
    faulty, _ = prefill(cfg, window_off_by_one)
    assert window_off_by_one.seen[0] == cfg.window
    sound = float((got - want).abs().max())
    fault = float((faulty - want).abs().max())
    reading = (f"{dtype}: sound {sound:.3e}, planted fault {fault:.3e}, "
               f"max |logit| {float(want.abs().max()):.3e}, atol "
               f"{GENERATE_ATOL[dtype]:.0e}")
    print(reading)
    assert sound <= GENERATE_ATOL[dtype] < fault, reading
    res = generate(params, cfg, prompts, 4)
    assert np.isfinite(res.logprobs).all()
    assert res.tokens.shape == (2, 260)


# max abs difference of the bf16 prefill logits of reduced gemma3-1b
# (|logit| up to 3.3), kernel path against attention_impl="xla" (which
# rounds the probabilities to bf16 before P.V, where the kernel keeps two
# bf16 parts): above the sound reading on the card (5.9e-2, four bf16 ulps
# of such a logit), below that of one layer's window off by one (0.50)
XLA_BF16_ATOL = 0.2


def test_bf16_prefill_through_kernel_matches_xla(cuda, monkeypatch):
    """Reduced gemma3-1b bf16 prefill logits through the kernel against
    ``attention_impl="xla"``, and the planted fault (the first LOCAL
    layer's window one short) that the tolerance must catch."""
    cfg, _, _, prefill, window_off_by_one = _reduced_gemma_prefill(
        cuda, "bfloat16", monkeypatch)
    got, launches = prefill(cfg)
    assert launches == cfg.n_layers
    want, xla_launches = prefill(cfg.replace(attention_impl="xla"))
    assert xla_launches == 0
    faulty, _ = prefill(cfg, window_off_by_one)
    assert window_off_by_one.seen[0] == cfg.window
    sound = float((got - want).abs().max())
    fault = float((faulty - want).abs().max())
    reading = (f"bfloat16 against xla: sound {sound:.3e}, planted fault "
               f"{fault:.3e}, max |logit| {float(want.abs().max()):.3e}, "
               f"atol {XLA_BF16_ATOL:.2f}")
    print(reading)
    assert sound <= XLA_BF16_ATOL < fault, reading


# tests/test_kernels.py test_rwkv6_kernel_sweep, plus rwkv6-7b's heads
# (64 of 64) at two chunks of its 32, each with the reference's draws of
# log w (-exp(normal)); and rwkv6-7b's heads over 1024 tokens with the
# model's own slow decays (w0 at init, models/blocks.py: up to w = 0.9975,
# so S sums hundreds of tokens), where rounding S or A to bf16 would show
RWKV_SHAPES = [(64, 2, 64, 64, 32, "normal"), (128, 4, 64, 64, 32, "normal"),
               (96, 1, 32, 32, 32, "normal"), (256, 2, 64, 128, 64, "normal"),
               (64, 64, 64, 64, 32, "normal"),
               (128, 2, 128, 128, 16, "normal"),
               (1024, 4, 64, 64, 32, "model")]


def _rwkv_inputs(B, S, H, Dk, Dv, device, dtype, seed, lw=None):
    """r, k, v normal in ``dtype``; log_w -exp(normal), or -exp(w0) with
    w0 as the model initialises it, linspace(-6, -0.3) over the H * Dk
    channels (``lw="model"``), or the constant ``lw``; u = 0.1 normal;
    log_w and u fp32."""
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)
    r, k = (torch.as_tensor(rng.normal(size=(B, S, H, Dk)).astype(
        np.float32), device=device).to(dt) for _ in range(2))
    v = torch.as_tensor(rng.normal(size=(B, S, H, Dv)).astype(np.float32),
                        device=device).to(dt)
    if lw is None:
        log_w = -np.exp(rng.normal(size=(B, S, H, Dk)))
    elif lw == "model":
        w0 = np.linspace(-6.0, -0.3, H * Dk).reshape(H, Dk)
        log_w = np.ascontiguousarray(np.broadcast_to(-np.exp(w0),
                                                     (B, S, H, Dk)))
    else:
        log_w = np.full((B, S, H, Dk), lw)
    u = 0.1 * rng.normal(size=(H, Dk))
    return (r, k, v, torch.as_tensor(log_w.astype(np.float32), device=device),
            torch.as_tensor(u.astype(np.float32), device=device))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,H,Dk,Dv,chunk,decay", RWKV_SHAPES)
def test_rwkv6_kernel_matches_plain(cuda, S, H, Dk, Dv, chunk, decay, dtype):
    """Kernel against the plain (sequential) version on the same card
    inputs, at the reference's tolerances; in bf16 the CUDA-core design
    (the yardstick) too."""
    r, k, v, lw, u = _rwkv_inputs(2, S, H, Dk, Dv, cuda, dtype, S * H,
                                  None if decay == "normal" else decay)
    before = rw_kernel.launches
    out = rw_ops.rwkv6(r, k, v, lw, u, chunk=chunk)
    assert rw_kernel.launches == before + 1
    ref = rw_ops.rwkv6(r, k, v, lw, u, use_kernel=False)
    torch.cuda.synchronize()
    assert out.dtype == v.dtype and out.shape == v.shape
    atol = 2e-3 if dtype == "float32" else 5e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                               rtol=1e-2)
    if dtype == "bfloat16":
        other = rw_kernel.rwkv6_design(r, k, v, lw, u, chunk=chunk,
                                       design="cuda_cores")
        assert rw_kernel.launches == before + 1
        torch.testing.assert_close(other.float(), ref.float(), atol=atol,
                                   rtol=1e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_kernel_extreme_decay(cuda, dtype):
    """``test_rwkv6_extreme_decay_no_overflow`` on the kernel: log w = -50
    stays finite and agrees (atol 1e-3); so does the clip's floor, log w =
    -exp(8), in every token; in bf16 (the tensor-core kernel, which forms
    its decays as products) and fp32.  bf16 keeps the reference's bf16
    rtol 1e-2 beside atol 1e-3: both sides round o to bf16, whose step at
    |o| ~ 4 is 3e-2, and a last-bit difference of the fp32 sums may round
    the two either way."""
    for lw in (-50.0, -2980.96):
        r, k, v, log_w, u = _rwkv_inputs(1, 64, 1, 32, 32, cuda, dtype, 9,
                                         lw=lw)
        u = torch.zeros_like(u)
        out = rw_ops.rwkv6(r, k, v, log_w, u)
        ref = rw_ops.rwkv6(r, k, v, log_w, u, use_kernel=False)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(out).all()), lw
        torch.testing.assert_close(out.float(), ref.float(), atol=1e-3,
                                   rtol=0.0 if dtype == "float32" else 1e-2)


def test_rwkv6_graph_replay_matches_eager(cuda):
    """The bf16 launch captured in a CUDA graph and replayed on new inputs
    written into the captured buffers gives the eager call's output."""
    first = _rwkv_inputs(2, 256, 4, 64, 64, cuda, "bfloat16", 3)
    second = _rwkv_inputs(2, 256, 4, 64, 64, cuda, "bfloat16", 4)
    bufs = [x.clone() for x in first]

    def call():
        return rw_ops.rwkv6(*bufs)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for src in (first, second):
        for dst, x in zip(bufs, src):
            dst.copy_(x)
        graph.replay()
        want = rw_ops.rwkv6(*src)
        torch.cuda.synchronize()
        assert torch.equal(out, want)


def test_rwkv6_kernel_refuses_what_it_cannot_take(cuda):
    r, k, v, lw, u = _rwkv_inputs(1, 64, 2, 64, 64, cuda, "float32", 0)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        rw_ops.rwkv6(r[:, :48], k[:, :48], v[:, :48], lw[:, :48], u)
    with pytest.raises(ValueError, match="head dims"):
        rw_kernel.rwkv6(r[..., :48].contiguous(), k[..., :48].contiguous(),
                        v, lw[..., :48].contiguous(), u[:, :48].contiguous(),
                        chunk=32)
    with pytest.raises(ValueError, match="chunk 8"):
        rw_kernel.rwkv6(r, k, v, lw, u, chunk=8)
    with pytest.raises(ValueError, match="log_w is torch.bfloat16"):
        rw_kernel.rwkv6(r, k, v, lw.bfloat16(), u, chunk=32)
    with pytest.raises(ValueError, match="contiguous"):
        rw_kernel.rwkv6(r.transpose(1, 2).contiguous().transpose(1, 2), k,
                        v, lw, u, chunk=32)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        rw_kernel.rwkv6(r, k, v, lw, u.cpu(), chunk=32)
    with pytest.raises(NotImplementedError, match="training the zoo"):
        rw_ops.rwkv6(r.requires_grad_(), k, v, lw, u)


# max abs difference of the logits of reduced rwkv6-7b (|logit| up to
# ~5), kernel path against the plain rwkv6_chunked path: fp32 the
# reference's tolerance (tests/test_model_kernel_impls.py); bf16 both paths
# round o to bf16 from fp32 sums taken in other orders (0.033 between the
# sequential and the chunked form on the CPU); one layer's kernel run
# without its bonus u gives ~4.4 on the CPU and must exceed both
RWKV_MODEL_ATOL = {"float32": 5e-4, "bfloat16": 0.1}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_forward_through_kernel_matches_plain(cuda, dtype,
                                                    monkeypatch):
    """``apply`` / ``loss_fn`` of reduced rwkv6-7b (S=256, 8 chunks a
    launch), ``u`` drawn nonzero: the kernel path (one launch per layer)
    against ``rwkv_impl="xla"``, and a planted fault (the first layer's
    kernel run with ``u`` zeroed) that the tolerance must catch."""
    from repro_torch import random as prng
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = get_config("rwkv6-7b-reduced").replace(dtype=dtype,
                                                 rwkv_impl="pallas")
    params, _ = T.init(cfg, prng.PRNGKey(0), device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    for i in range(cfg.n_layers):
        u = params["rem"][f"l{i}"]["tm"]["u"]
        u.copy_(0.1 * torch.randn(u.shape, generator=g, device=cuda))
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 256)), device=cuda)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    kernel_rwkv6 = rw_ops.rwkv6
    seen = []

    def no_bonus_in_first_layer(r, k, v, log_w, u, **kw):
        seen.append(1)
        if len(seen) == 1:
            u = torch.zeros_like(u)
        return kernel_rwkv6(r, k, v, log_w, u, **kw)

    before = rw_kernel.launches
    got, _ = T.apply(params, cfg, batch)
    assert rw_kernel.launches == before + cfg.n_layers
    want, _ = T.apply(params, cfg.replace(rwkv_impl="xla"), batch)
    assert rw_kernel.launches == before + cfg.n_layers
    monkeypatch.setattr(rw_ops, "rwkv6", no_bonus_in_first_layer)
    faulty, _ = T.apply(params, cfg, batch)
    monkeypatch.setattr(rw_ops, "rwkv6", kernel_rwkv6)
    assert len(seen) == cfg.n_layers
    sound = float((got - want).abs().max())
    fault = float((faulty - want).abs().max())
    reading = (f"{dtype}: sound {sound:.3e}, planted fault {fault:.3e}, max "
               f"|logit| {float(want.abs().max()):.3e}, atol "
               f"{RWKV_MODEL_ATOL[dtype]:.0e}")
    print(reading)
    assert sound <= RWKV_MODEL_ATOL[dtype] < fault, reading
    if dtype == "float32":
        torch.testing.assert_close(got, want, atol=5e-4, rtol=1e-4)
    loss_k, _ = T.loss_fn(params, cfg, batch)
    loss_p, _ = T.loss_fn(params, cfg.replace(rwkv_impl="xla"), batch)
    assert bool(torch.isfinite(loss_k))
    # each token's loss moves by at most twice the largest logit change
    assert abs(float(loss_k) - float(loss_p)) <= 2 * RWKV_MODEL_ATOL[dtype]


# tests/test_kernels.py test_rglru_scan_kernel_sweep (B, S, R, chunk), a
# ragged chunk (S=100 at chunk 64 halves to 4), a prime S (tiles of one
# step), an R that is no multiple of the block, and recurrentgemma-9b's
# width
RGLRU_SHAPES = [(2, 64, 128, 32), (2, 100, 128, 128), (2, 256, 256, 64),
                (2, 100, 128, 64), (3, 97, 200, 128), (2, 7, 128, 128),
                (8, 512, 4096, 128)]


def _rglru_inputs(B, S, R, device, seed, a_value=None):
    """a = sigmoid(normal + 2) (or the constant ``a_value``), b = 0.5
    normal, fp32 on ``device``."""
    rng = np.random.default_rng(seed)
    a = (1.0 / (1.0 + np.exp(-(rng.normal(size=(B, S, R)) + 2.0)))
         if a_value is None else np.full((B, S, R), a_value))
    b = 0.5 * rng.normal(size=(B, S, R))
    return (torch.as_tensor(a.astype(np.float32), device=device),
            torch.as_tensor(b.astype(np.float32), device=device))


@pytest.mark.parametrize("B,S,R,chunk", RGLRU_SHAPES)
def test_rglru_kernel_bit_equal_to_plain(cuda, B, S, R, chunk):
    a, b = _rglru_inputs(B, S, R, cuda, S + R)
    before = rg_kernel.launches
    out = rg_ops.rglru_scan(a, b, chunk=chunk)
    assert rg_kernel.launches == before + 1
    ref = rg_ops.rglru_scan(a, b, use_kernel=False)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and out.shape == (B, S, R)
    assert torch.equal(out, ref), float((out - ref).abs().max())


def test_rglru_kernel_slow_decay_stays_finite(cuda):
    """a = 1 - 1e-7 (float32 rounds it to 1 - 2**-23 or so) over 4,096
    steps: h sums its inputs, stays finite and equals the plain version."""
    a, b = _rglru_inputs(2, 4096, 256, cuda, 5, a_value=1.0 - 1e-7)
    out = rg_ops.rglru_scan(a, b)
    ref = rg_ref.rglru_sequential(a, b)
    torch.cuda.synchronize()
    assert float(a.max()) < 1.0
    assert bool(torch.isfinite(out).all()) and torch.equal(out, ref)


def test_rglru_kernel_refuses_what_it_cannot_take(cuda):
    a, b = _rglru_inputs(1, 64, 128, cuda, 0)
    with pytest.raises(ValueError, match="chunk 0"):
        rg_ops.rglru_scan(a, b, chunk=0)
    with pytest.raises(ValueError, match="takes torch.float32"):
        rg_kernel.rglru(a.bfloat16(), b)
    with pytest.raises(ValueError, match="contiguous"):
        rg_kernel.rglru(a.transpose(1, 2).contiguous().transpose(1, 2), b)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        rg_kernel.rglru(a, b.cpu())
    with pytest.raises(ValueError, match="has shape"):
        rg_kernel.rglru(a, b[:, :32].contiguous())
    with pytest.raises(NotImplementedError, match="training the zoo"):
        rg_ops.rglru_scan(a.requires_grad_(), b)


def test_rglru_kernel_matches_model_layer(cuda):
    """``tests/test_kernels.py`` test_rglru_scan_kernel_matches_model_layer
    on the card, on the gates of layer 0 of reduced recurrentgemma-9b
    (u = the conv of w_x of the normed embeddings, S=256): the kernel
    against the layer's own log-depth scan (``layers._linear_scan``, its
    fp32 h) within atol/rtol 1e-4; the kernel fed ``a`` shifted one step
    (0.16 seen on the CPU) must exceed that tolerance."""
    from repro_torch import random as prng
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    cfg = get_config("recurrentgemma-9b-reduced").replace(dtype="float32")
    params, _ = T.init(cfg, prng.PRNGKey(0), device=cuda)
    p = params["rem"]["l0"]
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 256)), device=cuda)
    x = L.rms_norm(params["embed"][tokens], p["ln1"], cfg.norm_eps)
    u, _ = L.causal_conv1d(p["conv_w"], p["conv_b"], x @ p["w_x"])
    log_a, x_in = L._rglru_gates(p, u)
    a = torch.exp(log_a)
    want = L._linear_scan(a, x_in)
    got = rg_ops.rglru_scan(a, x_in)
    shifted = rg_ops.rglru_scan(torch.cat([a[:, :1], a[:, :-1]], 1), x_in)
    torch.cuda.synchronize()
    sound = float((got - want).abs().max())
    fault = float((shifted - want).abs().max())
    print(f"sound {sound:.3e}, planted fault {fault:.3e}")
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    assert not torch.allclose(shifted, want, atol=1e-4, rtol=1e-4), fault
    y, _ = L.rglru_scan(p, u)
    torch.testing.assert_close(y, want, atol=0, rtol=0)   # the layer's h


def test_rglru_stacked_prefill_decode_on_card(cuda):
    """Reduced recurrentgemma-9b in the stacked layout (8 layers: 2 groups
    and a 2-layer remainder), fp32, on the card: prefill of 128 tokens
    (every LOCAL layer through ``flash_attention``, the ring of 64 wraps),
    then teacher-forced decode, equal to the full forward (atol/rtol 2e-3,
    the zoo's tolerance); every RG-LRU cache view was written."""
    from repro_torch import random as prng
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = get_config("recurrentgemma-9b-reduced").replace(
        dtype="float32", attention_impl="pallas", n_layers=8,
        scan_layers=True)
    params, _ = T.init(cfg, prng.PRNGKey(4), device=cuda)
    tokens = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab, (2, 136)), device=cuda)
    full, _ = T.apply(params, cfg, {"tokens": tokens})
    cache, _ = T.init_cache(cfg, 2, 136, device=cuda)
    before = fa_kernel.launches
    lg, cache = T.prefill(params, cfg, {"tokens": tokens[:, :128]}, cache)
    assert fa_kernel.launches == before + 2      # the 2 LOCAL layers
    torch.testing.assert_close(lg, full[:, 127], atol=2e-3, rtol=2e-3)
    for t in range(128, 135):
        lg, cache = T.decode_step(params, cfg, cache, tokens[:, t:t + 1], t)
        torch.testing.assert_close(lg, full[:, t], atol=2e-3, rtol=2e-3)
    for c in (cache["groups"]["b0"]["rnn"], cache["groups"]["b1"]["rnn"],
              cache["rem"]["l0"]["rnn"], cache["rem"]["l1"]["rnn"]):
        for leaf in (c["h"], c["conv"]):
            assert bool((leaf.flatten(-2).abs().amax(-1) > 0).all())


# ---------------------------------------------------------------------------
# the scanned and device planes: each chunk one CUDA-graph replay
# ---------------------------------------------------------------------------
def _plane_fleet():
    rng = np.random.default_rng(3)
    out = []
    for n in (7, 30, 12, 21, 5, 40, 16, 9):
        x = rng.normal(size=(n, 5)).astype(np.float32)
        out.append({"x": x, "y": (x @ np.arange(1, 6) / 5).astype(
            np.float32)})
    return out


def _plane_trainer(device, opt=None, sampler=None, C=3, hetero_fn=None):
    ds = FederatedDataset([dict(c) for c in _plane_fleet()], seed=1)
    opt = opt or tso.fedmom(eta=1.0, beta=0.9, use_fused_kernel=True)
    return FederatedTrainer(
        loss_fn=_linreg_loss, server_opt=opt,
        rcfg=tround.RoundConfig(C, 4, 0.05, compute_dtype="float32"),
        dataset=ds,
        sampler=sampler(ds.population()) if sampler
        else DeviceUniformSampler(ds.population(), C, seed=2),
        state=opt.init({"w": torch.zeros(5), "b": torch.zeros(())}),
        hetero_steps_fn=hetero_fn, local_batch=4, device=device)


def _same_run(a, b):
    assert [r["loss"] for r in a.history if "event" not in r] == [
        r["loss"] for r in b.history if "event" not in r]
    for k in ("w", "b"):
        assert torch.equal(a.state.w[k], b.state.w[k]), k


@pytest.mark.parametrize("plane", ["scanned", "device"])
def test_graph_replay_bit_equal_to_eager_loop(cuda, plane):
    """Two chunks and a ragged last one (4 + 4 + 3 rounds), replayed from
    captured graphs, against the same chunks run eagerly on the card."""
    from repro_torch.core import multiround as tmr
    tr = _plane_trainer(cuda)
    tr.run(11, plan=ExecutionPlan(plane=plane, chunk_rounds=4),
           verbose=False)
    assert len(tr.session.graphs) == 2              # R = 4 and R = 3
    assert all(g.graph is not None for g in tr.session.graphs.values())
    ref = _plane_trainer(cuda)
    state, losses = ref.state, []
    dds = ref.device_dataset()
    for s, e in ((0, 4), (4, 8), (8, 11)):
        if plane == "device":
            lrs, _ = ref._chunk_knobs(s, e)
            state, m = tmr.scan_rounds_ondevice(
                _linreg_loss, ref.server_opt, state, dds, ref.sampler,
                dds.base_key(), ref.sampler.base_key().to(cuda), s, e - s,
                ref.rcfg, 4, lrs=lrs, device=cuda)
        else:
            item = ref._assemble_chunk(s, e)
            state, m = tmr.scan_rounds(
                _linreg_loss, ref.server_opt, state, item["batches"],
                item["weights"], ref.rcfg, lrs=item["lrs"], device=cuda)
        losses += m["loss"].cpu().tolist()
    assert [r["loss"] for r in tr.history] == losses
    for k in ("w", "b"):
        assert torch.equal(tr.state.w[k], state.w[k]), k
    assert tr.state.t == state.t == 11


@pytest.mark.parametrize("case", ["plain", "hetero", "diurnal", "dp"])
@pytest.mark.parametrize("plane", ["scanned", "device"])
def test_graphed_planes_bit_equal_to_per_round_on_card(cuda, plane, case):
    """On the card the graphed chunks train the per-round trajectory bit
    for bit (linreg: no cuDNN); with DP noise, keyed by the device round
    index inside the graph, and with a diurnal M(t) computed there."""
    from repro_torch.core import DeviceDiurnalSampler
    kw = {}
    if case == "hetero":
        kw["hetero_fn"] = lambda t: np.random.default_rng(t).integers(
            0, 5, size=3)
    if case == "diurnal":
        kw.update(C=5, sampler=lambda pop: DeviceDiurnalSampler(
            pop, m_min=2, m_max=5, period=7, seed=3))
    if case == "dp":
        kw["opt"] = tso.dp_fedmom(clip=0.5, noise_multiplier=0.3, dp_seed=7,
                                  use_fused_kernel=True)
    ref = _plane_trainer(cuda, **kw)
    ref.run(11, plan="per_round", verbose=False)
    tr = _plane_trainer(cuda, **kw)
    tr.run(11, plan=ExecutionPlan(plane=plane, chunk_rounds=4),
           verbose=False)
    _same_run(tr, ref)


def test_capture_refuses_a_pageable_copy(cuda):
    """A body that copies from pageable host memory cannot be captured,
    and the chunk raises rather than run it eagerly: so every chunk the
    planes capture holds no such copy."""
    from repro_torch.core.server_opt import ServerState
    from repro_torch.launch.graph import ChunkGraph

    def body(state, inp):
        bump = torch.tensor([1.0], device=cuda)        # pageable H2D copy
        return (ServerState({"w": state.w["w"] + bump}, (), state.t),
                {"loss": state.w["w"].sum()})

    chunk = ChunkGraph(body, 1, cuda)
    with pytest.raises(RuntimeError):
        chunk.run(ServerState({"w": torch.zeros(1, device=cuda)}, (), 0),
                  0, {})
    torch.cuda.synchronize()


def test_chunk_metrics_survive_the_next_replay(cuda):
    """The graph's metric outputs are overwritten by every replay; the
    chunk hands out clones, so chunk i's read after chunk i+1 is
    enqueued (the trainer's order) still holds chunk i's values."""
    tr = _plane_trainer(cuda)
    dds = tr.device_dataset()
    graph = tr._device_chunk_graph(4, False, dds)
    lrs = np.full(4, 0.05, np.float32)
    state, first = graph.run(tr.state, 0, {"lrs": lrs})
    want = first["loss"].cpu().clone()
    clients = first["clients"].cpu().clone()
    state, second = graph.run(state, 4, {"lrs": lrs})
    assert torch.equal(first["loss"].cpu(), want)
    assert not torch.equal(second["clients"].cpu(), clients)
    assert clients.tolist() == [tr.sampler.sample(t)[0].tolist()
                                for t in range(4)]


def test_plan_none_on_cuda_stays_per_round(cuda):
    tr = _plane_trainer(cuda)
    tr.run(3, verbose=False)
    assert tr.session.plan_log[-1]["plane"] == "per_round"
    assert tr.session.graphs == {}


def test_graphed_run_leaves_no_alias_to_the_graph(cuda):
    """After a graphed run the trainer's state is its own: a later run
    through the same graph does not move a state taken before it."""
    tr = _plane_trainer(cuda)
    plan = ExecutionPlan(plane="device", chunk_rounds=4)
    tr.run(4, plan=plan, verbose=False)
    kept = tr.state
    snapshot = kept.w["w"].clone()
    tr.state = tr.server_opt.init({"w": torch.zeros(5, device=cuda),
                                   "b": torch.zeros((), device=cuda)})
    tr.run(4, plan=plan, verbose=False)
    assert torch.equal(kept.w["w"], snapshot)


# ---------------------------------------------------------------------------
# scenarios on the card
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("N", [4, 8, 16, 32, 64])
def test_client_step_scenario_masks_match_plain(cuda, N):
    """The hook lane's tier shapes at BENCH_7's configuration (C=8 slots,
    H=10, b=4, D=16, tier rows 4..64) under a dropout + straggler
    scenario's prefix masks, whole rows of zeros (a cap of 0) included:
    the kernel divides by max(mask sum, 1) as the plain version does."""
    from repro_torch.scenario import (LatencyStragglers, ScenarioSpec,
                                      UniformDropout)
    from repro_torch.scenario.spec import ScenarioRuntime
    C, H, b, D = 8, 10, 4, 16
    xs, ys, slots, idx, w, bias, _ = _cs_inputs(C, H, b, D, N, cuda, seed=N)
    runtime = ScenarioRuntime(ScenarioSpec(
        dropout=UniformDropout(0.6),
        stragglers=LatencyStragglers(deadline_s=6.0), seed=17), H)
    masks = [runtime.masks_for(t, np.arange(C) + 100 * t) for t in range(40)]
    mask = next(m for m in masks if (m.sum(1) == 0).any()
                and (m.sum(1) == H).any())
    zero = int(np.flatnonzero(mask.sum(1) == 0)[0])
    mask = torch.as_tensor(mask, device=cuda)
    before = cs_kernel.launches
    got = cs_ops.client_step(xs, ys, slots, idx, w, bias, 0.05, H, b,
                             step_mask=mask)
    assert cs_kernel.launches == before + 1
    want = cs_ref.client_step(xs, ys, slots, idx, w, bias, 0.05, H, b,
                              step_mask=mask)
    torch.cuda.synchronize()
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, atol=1e-5, rtol=1e-5)
    assert torch.equal(got[0][zero], w) and float(got[2][zero]) == 0.0


@pytest.mark.parametrize("plane", ["scanned", "device"])
def test_scenario_chunk_replayed_at_two_rounds_matches_eager(cuda, plane):
    """One captured chunk under a scenario, replayed at t0 = 0 and t0 =
    20, against the eager loop at those rounds: the masks are staged
    inputs, so a replay uses its own rounds' masks and draws."""
    from repro_torch.core import multiround as tmr
    from repro_torch.scenario import (LatencyStragglers, ScenarioSpec,
                                      UniformDropout)
    from repro_torch.scenario.spec import ScenarioRuntime
    from repro_torch.tree import tree_map
    spec = ScenarioSpec(dropout=UniformDropout(0.5),
                        stragglers=LatencyStragglers(deadline_s=3.0), seed=4)
    tr = _plane_trainer(cuda)
    tr._scenario = ScenarioRuntime(spec, tr.rcfg.local_steps)
    dds = tr.device_dataset()
    key, dkey = tr.sampler.base_key().to(cuda), dds.base_key()
    state = tr.state
    for t0 in (0, 20):
        start = state._replace(w=tree_map(torch.clone, state.w),
                               extra=tree_map(torch.clone, state.extra),
                               t=t0)
        if plane == "device":
            lrs, masks = tr._chunk_knobs(t0, t0 + 4)
            graph = tr._device_chunk_graph(4, True, dds)
            values = {"lrs": lrs, "masks": masks}
        else:
            values = tr._assemble_chunk(t0, t0 + 4)
            masks = values["masks"]
            sig = tuple((k, tuple(v.shape), str(v.dtype))
                        for k, v in sorted(values["batches"].items()))
            graph = tr._scan_chunk_graph(4, True, sig)
        assert (masks.sum(-1) < tr.rcfg.local_steps).any()
        state, got = graph.run(state, t0, values)
        if plane == "device":
            want_state, want = tmr.scan_rounds_ondevice(
                _linreg_loss, tr.server_opt, start, dds, tr.sampler, dkey,
                key, t0, 4, tr.rcfg, 4, lrs=lrs, step_masks=masks,
                device=cuda)
        else:
            want_state, want = tmr.scan_rounds(
                _linreg_loss, tr.server_opt, start, values["batches"],
                values["weights"], tr.rcfg, lrs=values["lrs"],
                step_masks=masks, device=cuda)
        for k in ("loss", "completed"):
            assert torch.equal(got[k], want[k]), (t0, k)
        for k in ("w", "b"):
            assert torch.equal(state.w[k], want_state.w[k]), (t0, k)
    assert len(tr.session.graphs) == 1


@pytest.mark.parametrize("which", ["trace", "constant", "min"])
def test_availability_inside_a_capture_copies_nothing(cuda, which):
    """``m_device`` of a trace's table, a constant and their min inside a
    captured graph: after one eager call (the chunk's warm-up) nothing is
    copied from the host, so the capture succeeds, and each replay reads
    the round the graph's input holds."""
    from repro_torch.scenario import (ConstantAvailability, MinAvailability,
                                      ScenarioSampler)
    from repro_torch.traces import FleetTrace, TraceAvailability
    from repro_torch.core import ClientPopulation
    m = np.array([3, 1, 4, 2, 5, 2], np.int32)
    trace = FleetTrace(n_rounds=6, n_clients=8, local_steps=2, m=m,
                       ev_round=[], ev_client=[], ev_steps=[])
    av = {"trace": TraceAvailability(trace, policy="wrap"),
          "constant": ConstantAvailability(3),
          "min": MinAvailability((TraceAvailability(trace, policy="clamp"),
                                  ConstantAvailability(3)))}[which]
    sampler = ScenarioSampler(ClientPopulation(np.arange(1, 9)), av, seed=5)
    key = sampler.base_key().to(cuda)
    t = torch.zeros((), dtype=torch.int64, device=cuda)
    sampler.sample_device(key, t)                   # the eager warm-up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        idx, w = sampler.sample_device(key, t)
        m_t = av.m_device(t)
    for r in (0, 1, 4, 7):
        t.fill_(r)
        graph.replay()
        torch.cuda.synchronize()
        assert int(m_t) == av.m_at(r)
        want_idx, want_w = sampler.sample(r)
        assert idx.cpu().numpy().tolist() == want_idx.tolist()
        assert np.array_equal(w.cpu().numpy(), want_w)
        assert int((w > 0).sum()) == min(int(m_t), av.peak)
