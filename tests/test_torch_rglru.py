"""The port's RG-LRU family (``models/{layers,blocks,transformer}``,
``serve``) against the JAX package's, on the CPU, at reduced
recurrentgemma-9b (6 layers (RGLRU, RGLRU, LOCAL) x 2, d_model 256, 4
query heads over 1 KV head, rnn width 256, conv width 4, window 64,
d_ff 512, vocab 512).

* layers: ``_rglru_gates``, ``rglru_scan`` (with and without ``h0``, an
  fp32 and a bf16 ``scan_dtype``), ``rglru_step`` and ``causal_conv1d``
  (with and without a carried state), fp32 within atol/rtol 1e-5 (values
  of order 1-10; torch's and XLA's ``exp``, ``softplus`` and ``sqrt``
  differ by ulps), bf16 outputs within one bf16 ulp (rtol 2**-7); the
  reference's layer properties on the port: the scan equals the step by
  step recurrence, and a streamed conv equals the whole one (atol/rtol
  1e-4 and 1e-5, the reference's);
* keyed ``init``: the reference's tree, keys, shapes and dtypes, flat and
  stacked; ``lam`` within one float32 ulp (its uniform draw is bit-equal,
  ``tests/test_torch_random.py``; ``log``, ``expm1`` and ``log`` each
  within an ulp on both sides); drawn leaves within the ``normal``
  tolerance of ROADMAP Queue 3;
* ``apply`` on carried weights under both ``attention_impl`` values, fp32
  logits within atol 1e-4 / rtol 1e-4 (1.1e-5 seen) and the loss within
  rtol 1e-5; bf16 logits within atol 0.25 (0.125 seen at |logit| up to
  4.8: torch rounds every bf16 op, XLA's CPU code keeps fused bf16 chains
  in fp32);
* prefill of 128 tokens (longer than the window of 64, so the rings wrap,
  and a multiple of 128, so ``"pallas"`` takes the flash path) and decode
  against the reference, caches written in place and equal to the
  reference's; teacher-forced prefill + decode against the full forward
  in the flat and the stacked layout (8 layers: 2 stacked groups and a
  2-layer remainder, recurrentgemma-9b's own layout; the stacked caches
  are views of [n_groups, ...] tensors, so state that is not written in
  place shows here);
* ``generate``: greedy and sampled tokens equal to the reference's;
  parameter and cache trees carried both ways through ``interop``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import generate as jgenerate  # noqa: E402
from repro_torch import random as prng  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.interop import tree_from_numpy, tree_to_numpy  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402,E501
from repro_torch.kernels.rglru_scan import kernel as rg_kernel  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import generate  # noqa: E402
from repro_torch.tree import flatten_with_paths  # noqa: E402

ARCH = "recurrentgemma-9b"
LAYER_TOL = 1e-5
BF16_RTOL = 2.0 ** -7
LOGIT_ATOL, LOGIT_RTOL = 1e-4, 1e-4
BF16_LOGIT_ATOL = 0.25
STACKED = dict(n_layers=8, scan_layers=True)   # 2 groups + 2 rem


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one intra-op thread here: the suite runs in several worker
    processes at once, and each one's default thread pool oversubscribes
    the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_japply = jax.jit(JT.apply, static_argnums=1)
_jloss = jax.jit(JT.loss_fn, static_argnums=1)
_jprefill = jax.jit(JT.prefill, static_argnums=1)
_jdecode = jax.jit(JT.decode_step, static_argnums=1)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _carry(jtree):
    return tree_from_numpy(jax.tree.map(np.asarray, jtree), "cpu")


def _cfgs(**kw):
    return jget(ARCH).reduced().replace(**kw), tget(ARCH).reduced().replace(
        **kw)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def _layer_inputs(dtype, R=64, B=2, S=40, seed=0):
    """The gate weights (0.1 normal, in ``dtype``), ``lam`` (normal, fp32),
    u [B,S,R] (in ``dtype``) and h0 [B,R] (fp32), on both sides."""
    rng = np.random.default_rng(seed)
    p = {"w_a": 0.1 * rng.normal(size=(R, R)),
         "w_i": 0.1 * rng.normal(size=(R, R)),
         "lam": rng.normal(size=(R,))}
    u = rng.normal(size=(B, S, R))
    h0 = rng.normal(size=(B, R)).astype(np.float32)

    def both(x, dt):
        x = np.asarray(x, np.float32)
        return jnp.asarray(x).astype(dt), torch.as_tensor(x).to(
            getattr(torch, dt))
    jp, tp = {}, {}
    for k, v in p.items():
        jp[k], tp[k] = both(v, "float32" if k == "lam" else dtype)
    ju, tu = both(u, dtype)
    return jp, tp, ju, tu, h0


def _close(got, want, dtype, tol=LAYER_TOL):
    if dtype == "bfloat16":
        np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_RTOL,
                                   atol=1e-6)
    else:
        np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gates_match_reference(dtype):
    """log_a and the gated input are fp32 on both sides, whatever u's
    dtype (the bf16 products are exact in fp32)."""
    jp, tp, ju, tu, _ = _layer_inputs(dtype)
    jla, jx = JL._rglru_gates(jp, ju, gate_gather=False)
    tla, tx = TL._rglru_gates(tp, tu, gate_gather=True)    # a no-op here
    assert tla.dtype == tx.dtype == torch.float32
    np.testing.assert_allclose(_np(tla), _np(jla), atol=LAYER_TOL,
                               rtol=LAYER_TOL)
    np.testing.assert_allclose(_np(tx), _np(jx), atol=LAYER_TOL,
                               rtol=LAYER_TOL)


@pytest.mark.parametrize("dtype,scan_dtype", [
    ("float32", "float32"), ("float32", "bfloat16"),
    ("bfloat16", "float32")])
@pytest.mark.parametrize("carry", [False, True])
def test_rglru_scan_matches_reference(dtype, scan_dtype, carry):
    """S=40 (the odd/even recursion meets odd lengths); y in u's dtype,
    h_last in the scan dtype."""
    jp, tp, ju, tu, h0 = _layer_inputs(dtype, seed=1)
    jy, jh = JL.rglru_scan(jp, ju, jnp.asarray(h0) if carry else None,
                           scan_dtype=getattr(jnp, scan_dtype))
    ty, th = TL.rglru_scan(tp, tu, torch.as_tensor(h0) if carry else None,
                           scan_dtype=getattr(torch, scan_dtype))
    assert ty.dtype == tu.dtype and ty.shape == tu.shape
    assert th.dtype == getattr(torch, scan_dtype) and th.shape == (2, 64)
    narrow = "bfloat16" if "bfloat16" in (dtype, scan_dtype) else "float32"
    _close(ty, jy, narrow)
    _close(th, jh, scan_dtype)


def test_rglru_step_matches_reference():
    jp, tp, ju, tu, h0 = _layer_inputs("float32", seed=2)
    jy, jh = JL.rglru_step(jp, ju[:, :1], jnp.asarray(h0))
    ty, th = TL.rglru_step(tp, tu[:, :1], torch.as_tensor(h0))
    assert ty.shape == (2, 1, 64) and th.dtype == torch.float32
    _close(ty, jy, "float32")
    _close(th, jh, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("carry", [False, True])
def test_causal_conv1d_matches_reference(dtype, carry):
    rng = np.random.default_rng(3)
    W, B, S, R = 4, 2, 10, 64
    arrs = [rng.normal(size=(W, R)), 0.1 * rng.normal(size=(R,)),
            rng.normal(size=(B, S, R)), rng.normal(size=(B, W - 1, R))]
    arrs = [np.asarray(a, np.float32) for a in arrs]
    jw, jb, jx, js = (jnp.asarray(a).astype(dtype) for a in arrs)
    tw, tb, tx, ts = (torch.as_tensor(a).to(getattr(torch, dtype))
                      for a in arrs)
    jy, jst = JL.causal_conv1d(jw, jb, jx, js if carry else None)
    ty, tst = TL.causal_conv1d(tw, tb, tx, ts if carry else None)
    assert ty.dtype == tx.dtype and tst.shape == (B, W - 1, R)
    _close(ty, jy, dtype)
    np.testing.assert_array_equal(_np(tst), _np(jst))


def test_rglru_scan_equals_step_by_step():
    """``tests/test_layers.py`` test_rglru_scan_equals_step_by_step on the
    port (atol/rtol 1e-4)."""
    _, tp, _, tu, _ = _layer_inputs("float32", R=16, S=12, seed=6)
    y_scan, h_last = TL.rglru_scan(tp, tu)
    h = torch.zeros((2, 16))
    outs = []
    for t in range(12):
        y, h = TL.rglru_step(tp, tu[:, t:t + 1], h)
        outs.append(y[:, 0])
    np.testing.assert_allclose(_np(y_scan), _np(torch.stack(outs, 1)),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_np(h_last), _np(h), atol=1e-4, rtol=1e-4)


def test_causal_conv1d_streaming_matches_batch():
    """``tests/test_layers.py`` test_causal_conv1d_streaming_matches_batch
    on the port: one token at a time through the carried state equals the
    whole sequence (atol 1e-5)."""
    rng = np.random.default_rng(7)
    w, b, x = (torch.as_tensor(rng.normal(size=s).astype(np.float32))
               for s in ((4, 8), (8,), (2, 10, 8)))
    y_full, _ = TL.causal_conv1d(w, 0.1 * b, x)
    state = torch.zeros((2, 3, 8))
    outs = []
    for t in range(10):
        y, state = TL.causal_conv1d(w, 0.1 * b, x[:, t:t + 1], state)
        outs.append(y[:, 0])
    np.testing.assert_allclose(_np(torch.stack(outs, 1)), _np(y_full),
                               atol=1e-5)


# ---------------------------------------------------------------------------
# keyed init
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("stacked", [False, True])
def test_init_matches_reference(stacked):
    jcfg, tcfg = _cfgs(**(STACKED if stacked else {}))
    jp, jaxes = JT.init(jcfg, jax.random.PRNGKey(3))
    tp, taxes = TT.init(tcfg, prng.PRNGKey(3), device="cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tpaths, tleaves = flatten_with_paths(tp)
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == [
        p.replace("/", "") for p in tpaths]
    if stacked:
        assert tp["groups"]["b0"]["w_a"].shape == (2, 256, 256)
        assert sorted(tp["rem"]) == ["l0", "l1"]
        assert "w_a" in tp["rem"]["l1"]          # the remainder is RG-LRU
    n_lam = 0
    for (path, a), b in zip(jflat, tleaves):
        name = jax.tree_util.keystr(path)
        assert tuple(a.shape) == tuple(b.shape), name
        assert str(a.dtype) == str(b.dtype).replace("torch.", ""), name
        leaf = name.split("['")[-1].rstrip("']")
        a = np.asarray(a)
        if leaf in ("ln1", "ln2", "conv_b", "final_norm"):
            np.testing.assert_array_equal(_np(b), _np(a), err_msg=name)
        elif leaf == "lam":
            n_lam += 1
            ulps = np.abs(_np(b).view(np.int32).astype(np.int64)
                          - a.view(np.int32).astype(np.int64))
            assert ulps.max() <= 1, (name, ulps.max())
        else:
            rtol = 2e-5 if b.dtype == torch.float32 else 2.0 ** -7
            np.testing.assert_allclose(_np(b), _np(a), rtol=rtol, atol=1e-8,
                                       err_msg=name)
    assert n_lam == 4     # flat: 4 RG-LRU layers; stacked: b0, b1 + 2 rem
    assert jax.tree.leaves(jaxes, is_leaf=lambda x: isinstance(x, tuple)) \
        == jax.tree.leaves(taxes, is_leaf=lambda x: isinstance(x, tuple))


# ---------------------------------------------------------------------------
# forward, prefill and decode on carried weights
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype,impl", [("float32", "xla"),
                                        ("float32", "pallas"),
                                        ("bfloat16", "pallas")])
def test_apply_matches_reference(dtype, impl):
    jcfg, tcfg = _cfgs(dtype=dtype, attention_impl=impl)
    jp, _ = JT.init(jcfg, jax.random.PRNGKey(4))
    tp = _carry(jp)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jcfg.vocab, (2, 128))
    labels = rng.integers(0, jcfg.vocab, (2, 128))
    jb = {"tokens": jnp.asarray(toks, jnp.int32),
          "labels": jnp.asarray(labels, jnp.int32)}
    tb = {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(labels)}
    before = (fa_kernel.launches, rg_kernel.launches)
    got, _ = TT.apply(tp, tcfg, tb)
    assert (fa_kernel.launches, rg_kernel.launches) == before  # CPU: none
    want, _ = _japply(jp, jcfg, jb)
    assert got.dtype == torch.float32 and got.shape == (2, 128, jcfg.vocab)
    if dtype == "bfloat16":
        np.testing.assert_allclose(_np(got), _np(want), atol=BF16_LOGIT_ATOL,
                                   rtol=0)
        return
    np.testing.assert_allclose(_np(got), _np(want), atol=LOGIT_ATOL,
                               rtol=LOGIT_RTOL)
    tl, _ = TT.loss_fn(tp, tcfg, tb)
    jl, _ = _jloss(jp, jcfg, jb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)


def test_prefill_and_decode_match_reference():
    """Prefill of 128 tokens through the flash path's plain version, then 4
    decode steps, in the stacked layout: logits within the forward's
    tolerance; the caches are the tensors ``init_cache`` allocated, and
    hold the reference's values (atol/rtol 1e-5; ring positions equal)."""
    jcfg, tcfg = _cfgs(dtype="float32", attention_impl="pallas", **STACKED)
    jp, _ = JT.init(jcfg, jax.random.PRNGKey(6))
    tp = _carry(jp)
    B, S0, steps = 2, 128, 4
    toks = np.random.default_rng(7).integers(0, jcfg.vocab, (B, S0 + steps))
    jcache, _ = JT.init_cache(jcfg, B, S0 + steps)
    tcache, _ = TT.init_cache(tcfg, B, S0 + steps, device="cpu")
    jlg, jcache = _jprefill(jp, jcfg, {"tokens": jnp.asarray(
        toks[:, :S0], jnp.int32)}, jcache)
    tlg, tcache2 = TT.prefill(tp, tcfg, {"tokens": torch.as_tensor(
        toks[:, :S0])}, tcache)
    assert all(a is b for a, b in zip(flatten_with_paths(tcache2)[1],
                                      flatten_with_paths(tcache)[1]))
    np.testing.assert_allclose(_np(tlg), _np(jlg), atol=LOGIT_ATOL,
                               rtol=LOGIT_RTOL)
    for t in range(S0, S0 + steps):
        jlg, jcache = _jdecode(jp, jcfg, jcache, jnp.asarray(
            toks[:, t:t + 1], jnp.int32), jnp.int32(t))
        tlg, _ = TT.decode_step(tp, tcfg, tcache, torch.as_tensor(
            toks[:, t:t + 1]), t)
        np.testing.assert_allclose(_np(tlg), _np(jlg), atol=LOGIT_ATOL,
                                   rtol=LOGIT_RTOL, err_msg=f"step {t}")
    jflat = jax.tree_util.tree_flatten_with_path(jcache)[0]
    tpaths, tflat = flatten_with_paths(tcache)
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == [
        p.replace("/", "") for p in tpaths]
    for (path, a), b in zip(jflat, tflat):
        name = jax.tree_util.keystr(path)
        assert tuple(a.shape) == tuple(b.shape), name
        assert str(a.dtype) == str(b.dtype).replace("torch.", ""), name
        if b.dtype == torch.int32:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), name)
        else:
            np.testing.assert_allclose(_np(b), _np(a), atol=1e-5, rtol=1e-5,
                                       err_msg=name)


@pytest.mark.parametrize("stacked", [False, True])
def test_prefill_decode_matches_full_forward(stacked):
    """The reference's property (``tests/test_models.py``
    test_prefill_decode_matches_full_forward) on the port, past the ring's
    wrap: teacher-forced decode reproduces the full forward's logits
    (atol/rtol 2e-3, the zoo's tolerance for it)."""
    cfg = tget(ARCH).reduced().replace(dtype="float32",
                                       attention_impl="pallas",
                                       **(STACKED if stacked else {}))
    params, _ = TT.init(cfg, prng.PRNGKey(4), device="cpu")
    assert ("groups" in params) == stacked
    B, S0, S1 = 2, 128, 136
    tokens = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab, (B, S1)))
    full, _ = TT.apply(params, cfg, {"tokens": tokens})
    cache, _ = TT.init_cache(cfg, B, S1, device="cpu")
    lg, cache = TT.prefill(params, cfg, {"tokens": tokens[:, :S0]}, cache)
    np.testing.assert_allclose(_np(lg), _np(full[:, S0 - 1]), rtol=2e-3,
                               atol=2e-3)
    for t in range(S0, S1 - 1):
        lg, cache = TT.decode_step(params, cfg, cache, tokens[:, t:t + 1], t)
        np.testing.assert_allclose(_np(lg), _np(full[:, t]), rtol=2e-3,
                                   atol=2e-3, err_msg=f"step {t}")
    # every RG-LRU cache was written: each group's view of the stack, and
    # the remainder's own tensors
    rnn = ([cache["groups"]["b0"]["rnn"], cache["groups"]["b1"]["rnn"],
            cache["rem"]["l0"]["rnn"], cache["rem"]["l1"]["rnn"]] if stacked
           else [cache["rem"][f"l{i}"]["rnn"] for i in (0, 1, 3, 4)])
    for c in rnn:
        for leaf in (c["h"], c["conv"]):
            per_group = leaf.reshape(-1, *leaf.shape[-2:]) if stacked \
                else leaf[None]
            assert all(float(x.abs().max()) > 0 for x in per_group)


# ---------------------------------------------------------------------------
# serving and interop
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def served():
    jcfg, tcfg = _cfgs(dtype="float32", attention_impl="pallas")
    jp, _ = JT.init(jcfg, jax.random.PRNGKey(0))
    prompts = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 128))
    return jcfg, tcfg, jp, _carry(jp), prompts.astype(np.int32)


def test_greedy_generate_matches_reference(served):
    jcfg, tcfg, jp, tp, prompts = served
    want = jgenerate(jp, jcfg, jnp.asarray(prompts), 6)
    got = generate(tp, tcfg, prompts, 6)
    assert got.tokens.shape == (2, 134) and got.logprobs.shape == (2, 6)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_allclose(got.logprobs, np.asarray(want.logprobs),
                               atol=1e-4, rtol=0)


def test_temperature_generate_matches_reference(served):
    """Sampled tokens equal under the same key (the Gumbel noise equals
    ``jax.random.gumbel``'s within 4 float32 ulps, ROADMAP Queue 3)."""
    jcfg, tcfg, jp, tp, prompts = served
    want = jgenerate(jp, jcfg, jnp.asarray(prompts), 6, temperature=0.7,
                     key=jax.random.PRNGKey(2))
    got = generate(tp, tcfg, torch.as_tensor(prompts), 6, temperature=0.7,
                   key=prng.PRNGKey(2))
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))


def test_param_and_cache_trees_carry_both_ways():
    """bf16 leaves, stacked groups and the RG-LRU caches survive JAX ->
    port -> numpy -> JAX, and the port's own tree carries to numpy and
    back bit for bit."""
    jcfg, tcfg = _cfgs(**STACKED)
    jp, _ = JT.init(jcfg, jax.random.PRNGKey(8))
    jcache, _ = JT.init_cache(jcfg, 2, 80)
    jcache = jax.tree.map(lambda z: z + 1 if z.dtype != jnp.int32 else z,
                          jcache)
    for tree in (jp, jcache):
        carried = _carry(tree)
        back = tree_to_numpy(carried)
        assert jax.tree.structure(back) == jax.tree.structure(tree)
        for a, b, c in zip(jax.tree.leaves(tree), jax.tree.leaves(back),
                           flatten_with_paths(carried)[1]):
            assert str(c.dtype).replace("torch.", "") == str(a.dtype)
            np.testing.assert_array_equal(
                np.asarray(jnp.asarray(b).astype(a.dtype)), np.asarray(a))
    tcache, _ = TT.init_cache(tcfg, 2, 80, device="cpu")
    assert tcache["groups"]["b0"]["rnn"]["h"].shape == (2, 2, 256)
    assert tcache["groups"]["b0"]["rnn"]["conv"].dtype == torch.bfloat16
    for tree in (TT.init(tcfg, prng.PRNGKey(8), device="cpu")[0], tcache):
        paths, leaves = flatten_with_paths(tree)
        bpaths, back = flatten_with_paths(tree_from_numpy(
            tree_to_numpy(tree), "cpu"))
        assert bpaths == paths
        for x, y in zip(leaves, back):
            assert torch.equal(x, y.to(x.dtype))
