"""The port's fused client step (``kernels/client_step``) against the JAX
package's, on the CPU.

The port's plain version (``ref.py``) is held to the JAX ``ref.py`` and to
the JAX Pallas kernel in interpret mode over the reference's own shape
sweep, with and without heterogeneous H_k masks (a straggler, a client with
no work), at atol/rtol 1e-5: the three sum the same fp32 products in other
orders.  The public wrapper (``ops.py``) takes the plain version for CPU
tensors.  The ``client_step_fn`` hook (``linreg_tier_step``) is held to the
JAX hook on the same cache contents.

The CUDA kernel itself is held to the plain version on the card in
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.  Here, with no card, the
staged design is held in two parts: its host-side ring plan
(``kernel.staging_plan``) at the path's, a wide and the card tests' shapes,
and a plain-torch model of its summation order (per-lane partials, the
warp reduce-scatter, the cross-warp sum, per-lane gradients) against the
JAX ``ref.py`` and the JAX Pallas kernel in interpret mode.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.data import stream as jstream  # noqa: E402
from repro.data.federated import minibatch_indices as jdraw  # noqa: E402
from repro.kernels.client_step import ops as jops  # noqa: E402
from repro.kernels.client_step import ref as jref  # noqa: E402
from repro_torch import random as prng  # noqa: E402
from repro_torch.data import stream as tstream  # noqa: E402
from repro_torch.data.federated import minibatch_indices  # noqa: E402
from repro_torch.kernels.client_step import kernel as tkernel  # noqa: E402
from repro_torch.kernels.client_step import ops as tops  # noqa: E402
from repro_torch.kernels.client_step import ref as tref  # noqa: E402
from test_torch_client_step_model import (  # noqa: E402
    reduce_scatter, staged_model)

TOL = 1e-5
SWEEP = [(1, 1, 2, 3, 4), (3, 4, 2, 5, 12), (4, 2, 3, 8, 16),
         (2, 5, 4, 17, 9), (8, 4, 8, 64, 40)]
# the staged design's other block shapes: two features a lane and two
# groups of rows (the last ragged); two warps sharing a client; eight
# warps in groups of 8 rows where groups of 32 would not fit the card
MODEL_EXTRA = [(2, 2, 40, 33, 16), (2, 3, 20, 200, 30), (1, 1, 64, 900, 70)]
H100_SMEM = 232448            # opt-in shared memory of one H100 block


def _inputs(C, H, b, D, N, seed=0, masked=False):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(C + 1, N, D)).astype(np.float32)
    ys = rng.normal(size=(C + 1, N)).astype(np.float32)
    slots = rng.permutation(C + 1)[:C].astype(np.int32)
    idx = rng.integers(0, N, size=(C, H * b)).astype(np.int32)
    w = rng.normal(size=D).astype(np.float32)
    bias = np.float32(rng.normal())
    mask = None
    if masked:
        h_k = rng.integers(0, H + 1, size=C)
        h_k[0] = 0                              # a client with no work
        mask = (np.arange(H)[None, :] < h_k[:, None]).astype(np.float32)
    return xs, ys, slots, idx, w, bias, mask


def _torch(xs, ys, slots, idx, w, bias, mask):
    t = torch.as_tensor
    return (t(xs), t(ys), t(slots), t(idx), t(w), t(bias),
            None if mask is None else t(mask))


def _close(got, want):
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=TOL,
                                   rtol=TOL)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("C,H,b,D,N", SWEEP)
def test_ref_matches_jax_ref_and_interpret_kernel(C, H, b, D, N, masked):
    xs, ys, slots, idx, w, bias, mask = _inputs(C, H, b, D, N, seed=C + D,
                                                masked=masked)
    jm = None if mask is None else jnp.asarray(mask)
    args = (jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(slots),
            jnp.asarray(idx), jnp.asarray(w), jnp.float32(bias), 0.05, H, b)
    want_ref = jref.client_step(*args, step_mask=jm)
    want_kernel = jops.client_step(*args, step_mask=jm, use_kernel=True,
                                   interpret=True)
    tx = _torch(xs, ys, slots, idx, w, bias, mask)
    got = tref.client_step(*tx[:6], 0.05, H, b, step_mask=tx[6])
    _close(got, want_ref)
    _close(got, want_kernel)
    if masked:
        # the client with no work keeps the start params and a zero loss
        assert torch.equal(got[0][0], tx[4]) and float(got[1][0]) == bias
        assert float(got[2][0]) == 0.0


def test_ops_on_cpu_routes_to_the_plain_version():
    xs, ys, slots, idx, w, bias, mask = _inputs(3, 4, 2, 6, 10, masked=True)
    tx = _torch(xs, ys, slots, idx, w, bias, mask)
    got = tops.client_step(*tx[:6], 0.07, 4, 2, step_mask=tx[6])
    want = tref.client_step(*tx[:6], 0.07, 4, 2, step_mask=tx[6])
    for g, r in zip(got, want):
        assert torch.equal(g, r)


@pytest.mark.parametrize("masked", [False, True])
def test_linreg_tier_step_matches_jax_hook(masked):
    """Both hooks on the same resident cache: the JAX hook draws its keyed
    minibatch indices itself, the port's takes them staged — the same
    numbers — and both return per-client params and losses."""
    rng = np.random.default_rng(2)
    counts = [5, 7, 12, 16, 3, 9]
    data = [{"x": rng.normal(size=(n, 4)).astype(np.float32),
             "y": rng.normal(size=n).astype(np.float32)} for n in counts]
    jc = jstream.ShardCache(jstream.StreamingFederatedDataset(data, seed=3),
                            capacity_clients=6)
    tc = tstream.ShardCache(tstream.StreamingFederatedDataset(data, seed=3),
                            capacity_clients=6, device="cpu")
    for c in (jc, tc):
        c.ensure(range(6))
    tier = 1                                    # the 8-row tier
    cids = [c for c in range(6) if jc.layout.tier_of[c] == tier]
    H, b, t = 3, 2, 5
    mask = (np.array([[1, 1, 0], [0, 0, 0], [1, 1, 1]][:len(cids)],
                     np.float32) if masked else None)
    w0 = {"w": rng.normal(size=4).astype(np.float32), "b": np.float32(0.3)}
    jw, jl = jops.linreg_tier_step(use_kernel=True, interpret=True)(
        jc.view(), tier, jax.random.PRNGKey(3), t, jnp.asarray(cids),
        jax.tree.map(jnp.asarray, w0), 0.05,
        None if mask is None else jnp.asarray(mask), H, b)
    tkey = prng.PRNGKey(3)
    idx = minibatch_indices(tkey, t, torch.tensor(cids),
                            torch.tensor([counts[c] for c in cids]), H * b)
    for c, row in zip(cids, idx):
        np.testing.assert_array_equal(
            row.numpy(), np.asarray(jdraw(jax.random.PRNGKey(3), t, c,
                                          counts[c], H * b)))
    tw, tl = tops.linreg_tier_step()(
        tc.view(), tier, torch.tensor(cids), idx,
        {k: torch.as_tensor(v) for k, v in w0.items()}, 0.05,
        None if mask is None else torch.as_tensor(mask), H, b)
    _close((tw["w"], tw["b"], tl), (jw["w"], jw["b"], jl))


def test_linreg_tier_step_rejects_wrong_family():
    fn = tops.linreg_tier_step()

    class View:
        tier_arrays = ({"a": torch.zeros((1, 2, 3))},)
        client_slots = torch.zeros(1, dtype=torch.int32)
        device = torch.device("cpu")

    args = (torch.zeros(1, dtype=torch.int64),
            torch.zeros((1, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="linear-regression family"):
        fn(View(), 0, *args, {"w": torch.zeros(3), "b": torch.zeros(())},
           0.1, None, 2, 2)
    View.tier_arrays = ({"x": torch.zeros((1, 2, 3)),
                         "y": torch.zeros((1, 2))},)
    with pytest.raises(ValueError, match="linreg params"):
        fn(View(), 0, *args, {"kernel": torch.zeros(3)}, 0.1, None, 2, 2)


@pytest.mark.parametrize("H,b,D,blocks,want", [
    (4, 8, 64, 1, (4, 8, 8448)),        # the hook lane: the client fits
    (4, 16, 1024, 1, (3, 16, 198016)),  # the wide shape, one block an SM
    (4, 16, 1024, 2, (1, 16, 66688)),   # ... two blocks an SM
    (2, 16, 1024, 1, (2, 16, 132352)),  # the card tests' shapes
    (4, 16, 1024, 1, (3, 16, 198016)),
    (3, 48, 1024, 1, (1, 32, 199040)),
    (3, 130, 8, 1, (3, 32, 15600)),
    (4, 3, 65, 1, (4, 8, 3216)),
    (1, 1, 1024, 1, (1, 8, 4616)),
    (1, 64, 900, 1, (1, 8, 231424)),    # groups of 32 would not fit
])
def test_staging_plan(H, b, D, blocks, want):
    """K = H where the client fits, K = floor((budget - fixed) / step)
    where it does not; G the least group that holds b unless its partials
    leave no room for a step; the bytes are what the block then takes."""
    assert tkernel.staging_plan(H, b, D, H100_SMEM, blocks) == want
    K, G, smem = want
    warps = -(-D // 128)
    fixed = 4 * 2 * warps * G if warps > 1 else 0
    step = 4 * b * (D + 2)
    budget = (H100_SMEM + 1024) // blocks - 1024
    assert smem == fixed + K * step <= H100_SMEM
    assert K == H or K == max(1, (budget - fixed) // step)
    least = 8 if b <= 8 else (16 if b <= 16 else 32)
    wide_fixed = 4 * 2 * warps * least if warps > 1 else 0
    assert G == least or (G == 8 and wide_fixed + step > H100_SMEM)


def test_staging_plan_refuses_a_step_that_does_not_fit():
    with pytest.raises(ValueError, match=(
            r"client_step: a block needs 263168 B of shared memory for "
            r"b=64, D=1024; the card allows 232448")):
        tkernel.staging_plan(1, 64, 1024, H100_SMEM)
    assert tkernel.blocks_wanted(8, 132) == 1
    assert tkernel.blocks_wanted(512, 132) == 2


@pytest.mark.parametrize("H", [1, 4])
def test_staging_plan_takes_every_shape_the_first_design_took(H):
    """Every (b, D) whose step fits the first design's block (4 b (D + 5)
    bytes) has a plan, at the widest b for each D up to 1,024 (the bytes
    grow with b, so narrower batches fit too); one more row is refused
    where its step does not fit this design's block either."""
    for D in range(1, 1025):
        b = H100_SMEM // (4 * (D + 5))
        K, G, smem = tkernel.staging_plan(H, b, D, H100_SMEM)
        assert 1 <= K <= H and smem <= H100_SMEM
        if 4 * (b + 1) * (D + 2) > H100_SMEM:
            with pytest.raises(ValueError, match="shared memory"):
                tkernel.staging_plan(H, b + 1, D, H100_SMEM)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("C,H,b,D,N", SWEEP + MODEL_EXTRA)
def test_staged_design_model_matches_jax(C, H, b, D, N, masked):
    """The staged design's summation order stays within atol/rtol 1e-5 of
    the JAX oracle and the JAX kernel in interpret mode (and of the port's
    plain version); an all-masked client keeps its start params."""
    xs, ys, slots, idx, w, bias, mask = _inputs(C, H, b, D, N, seed=C + D,
                                                masked=masked)
    jm = None if mask is None else jnp.asarray(mask)
    args = (jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(slots),
            jnp.asarray(idx), jnp.asarray(w), jnp.float32(bias), 0.05, H, b)
    G = tkernel.staging_plan(H, b, D, H100_SMEM)[1]
    got = staged_model(xs, ys, slots, idx, w, bias, 0.05, H, b, mask, G)
    _close(got, jref.client_step(*args, step_mask=jm))
    _close(got, jops.client_step(*args, step_mask=jm, use_kernel=True,
                                 interpret=True))
    tx = _torch(xs, ys, slots, idx, w, bias, mask)
    _close(got, tref.client_step(*tx[:6], 0.05, H, b, step_mask=tx[6]))
    if masked:
        assert torch.equal(got[0][0], tx[4]) and float(got[1][0]) == bias
        assert float(got[2][0]) == 0.0


def test_reduce_scatter_model_sums_each_row():
    """The modelled reduce-scatter gives every row's warp sum (exactly, on
    small integers) for each group width the kernel takes."""
    rng = np.random.default_rng(1)
    for G in (8, 16, 32):
        v = torch.as_tensor(rng.integers(-50, 50, size=(32, G)),
                            dtype=torch.float32)
        assert torch.equal(reduce_scatter(v), v.sum(dim=0))
