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
from repro_torch.tree import leaves  # noqa: E402

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


# ---------------------------------------------------------------------------
# the tree launch: its host plan, and the tables it hands the C entry
# ---------------------------------------------------------------------------
LENET_SIZES = (6, 16, 120, 62, 150, 2400, 30720, 7440)


def _ragged_sizes(n, seed=0):
    return tuple(int(v) for v in np.random.default_rng(seed).integers(
        1, 200, size=n))


@pytest.mark.parametrize("sizes", [
    LENET_SIZES, (1, 64), (2 ** 26 + 3,), (0, 5, 0, 1, 1029, 0),
    _ragged_sizes(1000), (7,) * 30, (300_000, 3, 1 << 20)],
    ids=["lenet", "linreg", "large", "zeros", "1000-leaves", "30-leaves",
         "uneven"])
def test_tree_plan_covers_every_element_once_in_leaf_order(sizes):
    tables = tkernel.tree_plan(sizes, [True] * len(sizes))
    max_leaves, max_chunks = tkernel.CAPACITY
    seen = []
    for t in tables:
        assert 1 <= len(t.leaves) <= max_leaves
        assert 1 <= len(t.chunks) <= max_chunks
        assert len(t.aligned) == len(t.leaves)
        for row, off, length in t.chunks:
            assert off % 4 == 0 and 1 <= length <= tkernel.MAX_CHUNK
            seen.append((t.leaves[row], off, length))
    # leaf order, each leaf's chunks contiguous from 0 to its size
    assert [i for i, _, _ in seen] == sorted(i for i, _, _ in seen)
    for i, n in enumerate(sizes):
        mine = [(off, length) for j, off, length in seen if j == i]
        ends = [0] + [off + length for off, length in mine]
        assert [off for off, _ in mine] == ends[:-1]
        assert ends[-1] == n


def test_tree_plan_splits_tables_at_capacity():
    sizes = _ragged_sizes(1000)
    tables = tkernel.tree_plan(sizes, [True] * 1000)
    assert len(tables) == -(-1000 // tkernel.CAPACITY[0])
    assert [i for t in tables for i in t.leaves] == list(range(1000))
    # a small capacity: the chunk rows bind before the leaf rows do
    small = tkernel.tree_plan((2000, 2000, 2000), [True] * 3,
                              capacity=(3, 20), blocks=8)
    assert all(len(t.chunks) <= 20 and len(t.leaves) <= 3 for t in small)
    assert sum(length for t in small for _, _, length in t.chunks) == 6000


def test_tree_plan_skips_zero_size_leaves():
    tables = tkernel.tree_plan((0, 3, 0, 0, 9), [True] * 5)
    assert [t.leaves for t in tables] == [(1, 4)]
    assert tkernel.tree_plan((0, 0), [True, True]) == []
    assert tkernel.tree_plan((), ()) == []


def test_tree_plan_sets_alignment_per_leaf():
    flags = [True, False, True, False, False, True, True, False]
    (table,) = tkernel.tree_plan(LENET_SIZES, flags)
    assert table.aligned == tuple(flags)


def test_tree_plan_spreads_lenet_over_the_sms_in_one_table():
    (table,) = tkernel.tree_plan(LENET_SIZES, [True] * 8)
    assert table.leaves == tuple(range(8))
    # one block a chunk, about one for every two SMs, none past one tile
    assert tkernel.SM_COUNT // 4 <= len(table.chunks) <= tkernel.SM_COUNT // 2
    assert max(length for _, _, length in table.chunks) <= 1024


def test_tree_plan_streams_large_trees_one_chunk_a_leaf():
    sizes = (5, 2 ** 26 + 3, 3 << 20)
    (table,) = tkernel.tree_plan(sizes, [True] * 3)
    assert [length for _, _, length in table.chunks] == list(sizes)
    # at and below the threshold the tree is cut to spread over the card
    (small,) = tkernel.tree_plan((tkernel.STREAM_ELEMS,), [True])
    assert len(small.chunks) > 1


def _full_mixed_tree(seed):
    """The mixed tree as numpy: ragged, bf16, a scalar, a zero-size leaf,
    a leaf the torch side gives as an offset view and one it gives
    non-contiguous."""
    rng = np.random.default_rng(seed)
    w = {"ragged": rng.normal(size=(513, 9)),
         "bf16": rng.normal(size=(37, 5)),
         "scalar": np.array(rng.normal()),
         "zero": np.zeros((0, 4)),
         "offset": rng.normal(size=(1029,)),
         "strided": rng.normal(size=(33, 17))}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    s = {k: (v + 1.0).astype(np.float32) for k, v in w.items()}
    d = {k: (0.05 * v).astype(np.float32) for k, v in w.items()}
    return w, s, d


def _torch_full_tree(tree, device="cpu"):
    out = {}
    for k, v in tree.items():
        if k == "offset":          # one element into a longer buffer
            t = torch.zeros(v.size + 1, device=device)[1:]
            t.copy_(torch.as_tensor(v))
        elif k == "strided":       # the transpose of a contiguous buffer
            t = torch.as_tensor(np.ascontiguousarray(v.T)).to(device).T
        else:
            t = torch.as_tensor(v).to(device)
        out[k] = t.to(torch.bfloat16) if k == "bf16" else t
    assert not out["strided"].is_contiguous()
    assert out["offset"].storage_offset() == 1
    return out


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("fuse_tree", [True, False])
def test_ops_full_mixed_tree_matches_jax_kernel(kind, fuse_tree):
    """The port's tree path (the plain version on the CPU) on the mixed
    tree against the JAX kernel in interpret mode with ``fuse_tree`` True
    and False.  The reference's per-leaf path cannot take a zero-size leaf
    (its pallas_call slices a (256, 128) block out of a (0, 128) stream),
    so there the zero-size leaf is held to its shape and dtype alone."""
    w, s, d = _full_mixed_tree(5)
    keep = [k for k in w if fuse_tree or k != "zero"]
    jw, js = jkernel.fused_update_tree(
        *({k: _jax_tree(t)[k] for k in keep} for t in (w, s, d)),
        eta=1.5, beta=0.9, interpret=True, kind=kind, fuse_tree=fuse_tree)
    fn = tops.fused_update_tree if kind == "fedmom" else tops.fused_avgm_tree
    tw, ts = fn(*(_torch_full_tree(t) for t in (w, s, d)), eta=1.5,
                beta=0.9)
    assert tw["bf16"].dtype == torch.bfloat16
    assert ts["bf16"].dtype == torch.bfloat16
    assert tw["zero"].shape == (0, 4) and ts["zero"].dtype == torch.float32
    assert tw["strided"].shape == (33, 17) and tw["scalar"].shape == ()
    _assert_close({k: tree_to_numpy(tw)[k] for k in keep}, jw)
    _assert_close({k: tree_to_numpy(ts)[k] for k in keep}, js)


class _CEntryModel:
    """A model in torch of ``fedmom_update_tree_launch``: it reads the
    tables the wrapper builds (host int64 rows at the addresses it is
    given), checks what the C entry checks, and runs each chunk through
    the plain version on the memory its pointers name.  On the CPU, with
    host tensors, it shows that the tables name every element of every
    leaf, in its own dtype, with the right alignment flag."""

    DTYPES = (torch.float32, torch.bfloat16, torch.float16)

    def __init__(self):
        self.launches = []

    @staticmethod
    def _rows(addr, n, width):
        import ctypes
        raw = (ctypes.c_longlong * (n * width)).from_address(addr)
        return np.ctypeslib.as_array(raw).reshape(n, width).copy()

    def _at(self, ptr, code, off, length):
        import ctypes
        dt = self.DTYPES[code]
        size = torch.tensor([], dtype=dt).element_size()
        raw = (ctypes.c_char * (length * size)).from_address(
            int(ptr) + int(off) * size)
        return torch.frombuffer(raw, dtype=dt)

    def fedmom_update_tree_launch(self, leaves_addr, n_leaves, chunks_addr,
                                  n_chunks, kind, eta, beta, sms, stream):
        max_leaves, max_chunks = tkernel.CAPACITY
        assert 1 <= n_leaves <= max_leaves and 1 <= n_chunks <= max_chunks
        table = self._rows(leaves_addr, n_leaves, 6)
        chunks = self._rows(chunks_addr, n_chunks, 3)
        eta, beta = float(np.float32(eta)), float(np.float32(beta))
        flat = tref.fedmom_flat if kind == 0 else tref.fedavgm_flat
        for row in table:
            aligned = not np.bitwise_or.reduce(row[:5]) & 15
            assert bool(row[5] & tkernel.ALIGNED) == aligned
            assert row[5] & ~(0x3f | tkernel.ALIGNED) == 0
        for leaf, off, length in chunks:
            assert off % 4 == 0 and length >= 1
            w, s, d, wo, so, codes = table[leaf]
            ins = [self._at(p, (codes >> sh) & 3, off, length)
                   for p, sh in ((w, 0), (s, 2), (d, 4))]
            outs = [self._at(p, (codes >> sh) & 3, off, length)
                    for p, sh in ((wo, 0), (so, 2))]
            new = flat(*(x.to(torch.float32) for x in ins), eta, beta)
            for o, n in zip(outs, new):
                o.copy_(n.to(o.dtype))
        self.launches.append((n_leaves, n_chunks))
        return 0


@pytest.fixture
def c_entry_model(monkeypatch):
    """The wrapper's CUDA route run on host tensors into ``_CEntryModel``."""
    model = _CEntryModel()
    monkeypatch.setattr(tkernel, "_lib",
                        lambda: type("L", (), {
                            "fedmom_update_tree_launch":
                                model.fedmom_update_tree_launch}))
    monkeypatch.setattr(tkernel, "_card", lambda x: x.get_device())
    monkeypatch.setattr(tkernel, "_sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: -1)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 0, raising=False)
    monkeypatch.setattr(tkernel, "launches", 0)
    return model


def _trees(kind_of_tree):
    if kind_of_tree == "mixed":
        return [_torch_full_tree(t) for t in _full_mixed_tree(6)]
    rng = np.random.default_rng(7)
    if kind_of_tree == "lenet":
        sizes = LENET_SIZES
    else:
        sizes = _ragged_sizes(1000, seed=3)
    w = [torch.as_tensor(rng.normal(size=n).astype(np.float32))
         for n in sizes]
    return [w, [x + 1 for x in w], [0.05 * x for x in w]]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("fuse_tree", [True, False])
@pytest.mark.parametrize("tree", ["mixed", "lenet", "1000-leaves"])
def test_tree_tables_name_every_leaf(c_entry_model, kind, fuse_tree, tree):
    """The wrapper's tables, run through the model of the C entry, give
    the plain version bit for bit: every leaf's pointers, dtypes, offsets
    and lengths are the ones the kernel must be given.  One launch a table
    (a leaf with ``fuse_tree=False``), none for a zero-size leaf."""
    w, s, d = _trees(tree)
    tw, ts = tkernel.fused_update_tree(w, s, d, eta=30.0, beta=0.9,
                                       kind=kind, fuse_tree=fuse_tree)
    plain = tref.fedmom_update if kind == "fedmom" else tref.fedavgm_update
    rw, rs = plain(w, s, d, 30.0, 0.9)
    for got, want, like in ((tw, rw, w), (ts, rs, s)):
        for g, r, x in zip(leaves(got), leaves(want), leaves(like)):
            assert g.shape == x.shape and g.dtype == x.dtype
            assert torch.equal(g, r.to(x.dtype))
            assert g.data_ptr() % 16 == 0
    sizes = [x.numel() for x in leaves(w)]
    if fuse_tree:
        want = len(tkernel.tree_plan(sizes, [True] * len(sizes)))
    else:
        want = sum(n > 0 for n in sizes)
    assert tkernel.launches == len(c_entry_model.launches) == want


def test_tree_launch_counts_nothing_without_elements(c_entry_model):
    z = {"a": torch.zeros(0), "b": torch.zeros(3, 0)}
    tw, ts = tkernel.fused_update_tree(z, z, z, eta=1.0, beta=0.9)
    assert tw["b"].shape == (3, 0) and ts["a"].shape == (0,)
    assert tkernel.fused_update_tree({}, {}, {}, eta=1.0, beta=0.9) == ({},
                                                                       {})
    assert tkernel.launches == 0 and c_entry_model.launches == []


def test_tree_outputs_are_fresh_and_16_byte_aligned(c_entry_model):
    """Each output tree is one allocation of 16-byte-aligned leaf views,
    shared with no input (the functional contract of the server step)."""
    w, s, d = _trees("mixed")
    tw, ts = tkernel.fused_update_tree(w, s, d, eta=2.0, beta=0.9)
    ins = {x.untyped_storage().data_ptr() for t in (w, s, d)
           for x in leaves(t)}
    for out in (tw, ts):
        storages = {x.untyped_storage().data_ptr() for x in leaves(out)}
        assert len(storages) == 1 and not storages & ins
        assert all(x.data_ptr() % 16 == 0 for x in leaves(out))


def test_packed_design_is_the_yardstick_and_uncounted(c_entry_model,
                                                      monkeypatch):
    # the flat streams' own checks want CUDA tensors
    monkeypatch.setattr(tkernel, "_check", lambda name, x, like: None)
    w, s, d = _trees("lenet")
    pw, ps = tkernel.fused_update_tree_design(w, s, d, eta=30.0, beta=0.9,
                                              kind="fedavgm")
    rw, rs = tref.fedavgm_update(w, s, d, 30.0, 0.9)
    assert all(torch.equal(a, b) for a, b in zip(pw + ps, rw + rs))
    assert tkernel.launches == 0 and len(c_entry_model.launches) == 1
    with pytest.raises(ValueError, match="design"):
        tkernel.fused_update_tree_design(w, s, d, eta=1.0, beta=0.9,
                                         design="v0")


def test_tree_refuses_what_the_kernel_cannot_take(c_entry_model):
    w = {"a": torch.zeros(4), "b": torch.zeros(3)}
    with pytest.raises(ValueError, match="floating leaves"):
        tkernel.fused_update_tree(w, {"a": torch.zeros(4),
                                      "b": torch.zeros(3, dtype=torch.int32)},
                                  w, eta=1.0, beta=0.9)
    with pytest.raises(ValueError, match="has shape"):
        tkernel.fused_update_tree(w, w, {"a": torch.zeros(2, 2),
                                         "b": torch.zeros(3)},
                                  eta=1.0, beta=0.9)
    with pytest.raises(ValueError, match="leaves"):
        tkernel.fused_update_tree(w, {"a": torch.zeros(4)}, w, eta=1.0,
                                  beta=0.9)
    with pytest.raises(ValueError, match="unknown update kind"):
        tkernel.fused_update_tree(w, w, w, eta=1.0, beta=0.9, kind="sgd")
    assert tkernel.launches == 0


def test_tree_casts_other_floating_dtypes_through_float32(c_entry_model):
    w = {"a": torch.linspace(-1, 1, 9, dtype=torch.float64),
         "b": torch.ones(5, dtype=torch.float16)}
    s = {k: v + 1 for k, v in w.items()}
    d = {k: 0.05 * v for k, v in w.items()}
    tw, ts = tkernel.fused_update_tree(w, s, d, eta=2.0, beta=0.9)
    rw, rs = tref.fedmom_update(w, s, d, 2.0, 0.9)
    for got, want, like in ((tw, rw, w), (ts, rs, s)):
        for k in like:
            assert got[k].dtype == like[k].dtype
            assert torch.equal(got[k], want[k].to(like[k].dtype))


def test_tree_refuses_cpu_tensors():
    x = {"a": torch.zeros(8)}
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tkernel.fused_update_tree(x, x, x, eta=1.0, beta=0.9)


@pytest.mark.parametrize("offset_in", ["w", "state", "delta"])
def test_tree_alignment_flag_reads_every_input(c_entry_model, offset_in):
    """A leaf off a 16-byte boundary in one input alone takes the scalar
    path: the model of the C entry checks each flag against all five
    addresses."""
    rng = np.random.default_rng(8)
    trees = []
    for name in ("w", "state", "delta"):
        t = {"a": torch.as_tensor(rng.normal(size=(9, 7)).astype(np.float32)),
             "b": torch.as_tensor(rng.normal(size=40).astype(np.float32))}
        if name == offset_in:
            t["b"] = torch.zeros(41)[1:].copy_(t["b"])
        trees.append(t)
    tw, ts = tkernel.fused_update_tree(*trees, eta=2.0, beta=0.9)
    rw, rs = tref.fedmom_update(*trees, 2.0, 0.9)
    assert all(torch.equal(tw[k], rw[k]) and torch.equal(ts[k], rs[k])
               for k in rw)


@pytest.mark.parametrize("kind", KINDS)
def test_tree_dtype_codes_follow_each_input(c_entry_model, kind):
    """Each input of a leaf carries its own dtype: a bf16 model with an
    fp32 state and delta, an fp16 state, an fp32 model with a bf16
    delta."""
    rng = np.random.default_rng(9)

    def t(dtype, n=37):
        return torch.as_tensor(rng.normal(size=n).astype(np.float32)).to(
            dtype)

    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    w = {"a": t(bf16), "b": t(f32), "c": t(bf16)}
    s = {"a": t(f32), "b": t(f16), "c": t(bf16)}
    d = {"a": t(f32), "b": t(bf16), "c": t(f16)}
    fn = tops.fused_update_tree if kind == "fedmom" else tops.fused_avgm_tree
    tw, ts = tkernel.fused_update_tree(w, s, d, eta=2.0, beta=0.9,
                                       kind=kind)
    rw, rs = fn(w, s, d, eta=2.0, beta=0.9)        # the plain version
    for got, want, like in ((tw, rw, w), (ts, rs, s)):
        for k in like:
            assert got[k].dtype == like[k].dtype
            assert torch.equal(got[k], want[k])
