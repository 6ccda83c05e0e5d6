"""The port's kernel wrappers called in the reference's keyword form, on the
CPU, each held against the JAX wrapper on the same numpy inputs.

* ``flash_attention`` takes ``block_q`` / ``block_k``: with ``use_kernel``
  they are cut to ``min(block, S)`` and must divide S, as the reference's
  ``flash_attention_bhsd`` asserts; the port raises ``ValueError`` where
  the reference raises ``AssertionError``.  The blocks pick no tile of the
  CUDA kernel, so the values match the reference's interpret-mode kernel at
  any blocks it takes (fp32 atol 2e-5, the reference's tolerance).
* ``client_step``, ``linreg_tier_step`` and ``fused_update_tree`` /
  ``fused_avgm_tree`` take ``use_kernel``; ``False`` routes to the plain
  version on any device, as the reference routes it to its oracle.  The
  reference's ``interpret`` names a Pallas mode and has no counterpart.

That ``use_kernel=False`` launches nothing on the card is held in
``tests/test_torch_gpu.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.data import stream as jstream  # noqa: E402
from repro.kernels.client_step import ops as jcs  # noqa: E402
from repro.kernels.fedmom_update import ops as jfm  # noqa: E402
from repro.kernels.flash_attention import ops as jfa  # noqa: E402
from repro_torch import random as prng  # noqa: E402
from repro_torch.data import stream as tstream  # noqa: E402
from repro_torch.data.federated import minibatch_indices  # noqa: E402
from repro_torch.interop import tree_from_numpy, tree_to_numpy  # noqa: E402
from repro_torch.kernels.client_step import ops as tcs  # noqa: E402
from repro_torch.kernels.client_step import ref as tcs_ref  # noqa: E402
from repro_torch.kernels.fedmom_update import ops as tfm  # noqa: E402
from repro_torch.kernels.flash_attention import ops as tfa  # noqa: E402

FA_ATOL = 2e-5           # tests/test_kernels.py, fp32
CS_TOL = 1e-5            # test_torch_client_step.py: sums in other orders
FM_RTOL, FM_ATOL = 2e-7, 2e-6   # test_torch_kernels.py: XLA's FMA vs torch


def _qkv(S, Hq, Hkv, d, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(2, S, h, d)).astype(np.float32)
            for h in (Hq, Hkv, Hkv)]
    return [jnp.asarray(a) for a in arrs], [torch.as_tensor(a) for a in arrs]


@pytest.mark.parametrize("S,block_q,block_k,causal,window", [
    (128, 64, 64, True, 0),        # the reference's sweep form
    (256, 128, 64, True, 64),
    (64, 128, 128, True, 0),       # blocks cut to S
    (192, 64, 192, False, 0),
])
def test_flash_attention_reference_keyword_form(S, block_q, block_k, causal,
                                                window):
    (jq, jk, jv), (tq, tk, tv) = _qkv(S, 4, 2, 64, S + block_q)
    kw = dict(causal=causal, window=window, block_q=block_q,
              block_k=block_k)
    want = jfa.flash_attention(jq, jk, jv, **kw)
    got = tfa.flash_attention(tq, tk, tv, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FA_ATOL,
                               rtol=0)


@pytest.mark.parametrize("S,block_q,block_k", [(192, 128, 128),
                                               (256, 96, 64),
                                               (256, 128, 96)])
def test_flash_attention_refuses_blocks_the_reference_asserts_on(
        S, block_q, block_k):
    """The reference asserts; the port raises ValueError.  With
    ``use_kernel=False`` neither checks, and both compute the same."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(S, 2, 1, 64, S)
    kw = dict(block_q=block_q, block_k=block_k)
    with pytest.raises(AssertionError):
        jfa.flash_attention(jq, jk, jv, **kw)
    with pytest.raises(ValueError, match="reference's check"):
        tfa.flash_attention(tq, tk, tv, **kw)
    want = jfa.flash_attention(jq, jk, jv, use_kernel=False, **kw)
    got = tfa.flash_attention(tq, tk, tv, use_kernel=False, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FA_ATOL,
                               rtol=0)


def _cs_inputs(C, H, b, D, N, seed):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(C + 1, N, D)).astype(np.float32)
    ys = rng.normal(size=(C + 1, N)).astype(np.float32)
    slots = rng.permutation(C + 1)[:C].astype(np.int32)
    idx = rng.integers(0, N, size=(C, H * b)).astype(np.int32)
    w = rng.normal(size=D).astype(np.float32)
    bias = np.float32(rng.normal())
    h_k = rng.integers(0, H + 1, size=C)
    mask = (np.arange(H)[None, :] < h_k[:, None]).astype(np.float32)
    return xs, ys, slots, idx, w, bias, mask


@pytest.mark.parametrize("use_kernel", [False, True])
def test_client_step_keyword_form_matches_jax(use_kernel):
    """``use_kernel`` in the reference's keyword form; the JAX side runs
    its oracle (``False``) or its kernel in interpret mode (``True``)."""
    C, H, b = 3, 4, 2
    xs, ys, slots, idx, w, bias, mask = _cs_inputs(C, H, b, 6, 10, seed=4)
    extra = {} if not use_kernel else {"interpret": True}
    want = jcs.client_step(jnp.asarray(xs), jnp.asarray(ys),
                           jnp.asarray(slots), jnp.asarray(idx),
                           jnp.asarray(w), jnp.float32(bias), 0.07, H, b,
                           step_mask=jnp.asarray(mask),
                           use_kernel=use_kernel, **extra)
    t = torch.as_tensor
    got = tcs.client_step(t(xs), t(ys), t(slots), t(idx), t(w), t(bias),
                          0.07, H, b, step_mask=t(mask),
                          use_kernel=use_kernel)
    plain = tcs_ref.client_step(t(xs), t(ys), t(slots), t(idx), t(w),
                                t(bias), 0.07, H, b, step_mask=t(mask))
    for g, p, r in zip(got, plain, want):
        assert torch.equal(g, p)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=CS_TOL,
                                   rtol=CS_TOL)


def test_linreg_tier_step_use_kernel_false_matches_jax_hook():
    """Both hooks built with ``use_kernel=False`` on the same resident
    cache: the JAX hook draws its keyed indices, the port's takes them
    staged (the same numbers)."""
    rng = np.random.default_rng(7)
    counts = [5, 7, 12, 16, 3, 9]
    data = [{"x": rng.normal(size=(n, 4)).astype(np.float32),
             "y": rng.normal(size=n).astype(np.float32)} for n in counts]
    jc = jstream.ShardCache(jstream.StreamingFederatedDataset(data, seed=3),
                            capacity_clients=6)
    tc = tstream.ShardCache(tstream.StreamingFederatedDataset(data, seed=3),
                            capacity_clients=6, device="cpu")
    for c in (jc, tc):
        c.ensure(range(6))
    tier = 1
    cids = [c for c in range(6) if jc.layout.tier_of[c] == tier]
    H, b, t = 3, 2, 4
    w0 = {"w": rng.normal(size=4).astype(np.float32), "b": np.float32(-0.2)}
    jw, jl = jcs.linreg_tier_step(use_kernel=False)(
        jc.view(), tier, jax.random.PRNGKey(9), t, jnp.asarray(cids),
        jax.tree.map(jnp.asarray, w0), 0.05, None, H, b)
    idx = minibatch_indices(prng.PRNGKey(9), t, torch.tensor(cids),
                            torch.tensor([counts[c] for c in cids]), H * b)
    tw, tl = tcs.linreg_tier_step(use_kernel=False)(
        tc.view(), tier, torch.tensor(cids), idx,
        {k: torch.as_tensor(v) for k, v in w0.items()}, 0.05, None, H, b)
    for g, r in zip((tw["w"], tw["b"], tl), (jw["w"], jw["b"], jl)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=CS_TOL,
                                   rtol=CS_TOL)


@pytest.mark.parametrize("kind", ["fedmom", "fedavgm"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_fedmom_wrappers_keyword_form_match_jax(kind, use_kernel):
    rng = np.random.default_rng(11)
    w = {"a": rng.normal(size=(33, 7)).astype(np.float32),
         "s": np.float32(rng.normal())}
    s = {k: (v + 1.0).astype(np.float32) for k, v in w.items()}
    d = {k: (0.05 * v).astype(np.float32) for k, v in w.items()}
    jfn = jfm.fused_update_tree if kind == "fedmom" else jfm.fused_avgm_tree
    tfn = tfm.fused_update_tree if kind == "fedmom" else tfm.fused_avgm_tree
    extra = {} if not use_kernel else {"interpret": True}
    jt = [jax.tree.map(jnp.asarray, x) for x in (w, s, d)]
    jw, js = jfn(*jt, eta=2.5, beta=0.9, use_kernel=use_kernel, **extra)
    tw, ts = tfn(*[tree_from_numpy(x, "cpu") for x in (w, s, d)], eta=2.5,
                 beta=0.9, use_kernel=use_kernel)
    for got, want in ((tw, jw), (ts, js)):
        got = tree_to_numpy(got)
        for k in want:
            np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                       rtol=FM_RTOL, atol=FM_ATOL,
                                       err_msg=k)
