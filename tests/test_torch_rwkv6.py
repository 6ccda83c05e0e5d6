"""The port's RWKV6 family (``models/{layers,blocks,transformer}``,
``serve``) against the JAX package's, on the CPU, at reduced rwkv6-7b
(2 layers, d_model 256, 4 heads of 64, d_ff 512, vocab 512, decay LoRA
rank 16) in fp32.

* layers: ``rwkv6_chunked`` (with and without a carried state, and a
  ragged S that takes the chunk fallback) and ``rwkv6_step`` within atol
  2e-5 / rtol 1e-4 (torch contracts the three-operand score einsum
  pairwise, XLA at once: fp32 sums in another order), and the reference's
  chunked-vs-step property (atol/rtol 1e-3);
* keyed ``init``: the reference's tree, keys, shapes and dtypes, stacked
  and flat; ``mu``, ``u`` and ``ln_x`` bit-equal; ``w0`` within one
  float32 ulp (``blocks.linspace_f32``: XLA's CPU code contracts some of
  ``jnp.linspace``'s multiply-adds into FMAs); drawn leaves within the
  ``normal`` tolerance of ROADMAP Queue 3; the tree carries across through
  ``interop`` unchanged;
* ``apply`` and ``loss_fn`` on carried weights, with ``u`` drawn nonzero so
  the bonus term counts, under both ``rwkv_impl`` values on both sides
  (the Pallas kernel in interpret mode; the port's wrapper takes its plain
  version on CPU tensors): logits within atol 2e-4 / rtol 1e-4, losses
  within rtol 1e-5; the port's "pallas" path against its "xla" path at the
  reference's own tolerance (atol 5e-4, rtol 1e-4);
* prefill and decode against the reference, caches written equal; and
  teacher-forced prefill + decode against the full forward in the flat
  and the stacked layout (the stacked cache is written through views of
  ``[n_groups, ...]`` tensors, so state that is not written in place
  shows here);
* ``generate``: greedy and sampled tokens equal to the reference's.
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
from repro_torch.kernels.rwkv6_scan import kernel as rw_kernel  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import generate  # noqa: E402
from repro_torch.tree import flatten_with_paths  # noqa: E402

ARCH = "rwkv6-7b"
LOGIT_ATOL, LOGIT_RTOL = 2e-4, 1e-4
LAYER_ATOL, LAYER_RTOL = 2e-5, 1e-4


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


def _cfgs(**kw):
    kw = dict(dtype="float32", **kw)
    return (jget(ARCH).reduced().replace(**kw),
            tget(ARCH).reduced().replace(**kw))


def _bonus_params(jcfg, seed):
    """The reference's keyed weights with every ``u`` drawn as 0.1 normal
    (``init`` makes it zero, which would leave the bonus term untested),
    and the same tree carried to the port."""
    jp, _ = JT.init(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def draw(path, x):
        if jax.tree_util.keystr(path).endswith("['u']"):
            return jnp.asarray(0.1 * rng.normal(size=x.shape), x.dtype)
        return x
    jp = jax.tree_util.tree_map_with_path(draw, jp)
    return jp, tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _rwkv_inputs(B, S, H, D, seed):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, S, H, D)).astype(np.float32)
               for _ in range(3))
    lw = (-np.exp(rng.normal(size=(B, S, H, D)))).astype(np.float32)
    u = (0.1 * rng.normal(size=(H, D))).astype(np.float32)
    state = rng.normal(size=(B, H, D, D)).astype(np.float32)
    return r, k, v, lw, u, state


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S,chunk,carry", [(64, 32, False), (64, 16, True),
                                           (40, 32, False), (27, 32, True)])
def test_rwkv6_chunked_matches_reference(S, chunk, carry):
    """S=40 at chunk 32 falls back to chunks of 8, S=27 to chunks of 1."""
    r, k, v, lw, u, s0 = _rwkv_inputs(2, S, 2, 16, S + chunk)
    s0 = s0 if carry else None
    jo, js = JL.rwkv6_chunked(*map(jnp.asarray, (r, k, v, lw, u)),
                              state=None if s0 is None else jnp.asarray(s0),
                              chunk=chunk)
    to, ts = TL.rwkv6_chunked(*map(torch.as_tensor, (r, k, v, lw, u)),
                              state=None if s0 is None else torch.as_tensor(
                                  s0), chunk=chunk)
    assert to.shape == (2, S, 2, 16) and ts.dtype == torch.float32
    np.testing.assert_allclose(_np(to), _np(jo), atol=LAYER_ATOL,
                               rtol=LAYER_RTOL)
    np.testing.assert_allclose(_np(ts), _np(js), atol=LAYER_ATOL,
                               rtol=LAYER_RTOL)


def test_rwkv6_step_matches_reference():
    r, k, v, lw, u, s0 = _rwkv_inputs(3, 1, 2, 16, 11)
    jo, js = JL.rwkv6_step(*map(jnp.asarray, (r, k, v, lw, u, s0)))
    to, ts = TL.rwkv6_step(*map(torch.as_tensor, (r, k, v, lw, u, s0)))
    assert to.shape == (3, 1, 2, 16) and ts.shape == (3, 2, 16, 16)
    np.testing.assert_allclose(_np(to), _np(jo), atol=LAYER_ATOL,
                               rtol=LAYER_RTOL)
    np.testing.assert_allclose(_np(ts), _np(js), atol=LAYER_ATOL,
                               rtol=LAYER_RTOL)


def test_rwkv6_chunked_matches_step_decode():
    """``tests/test_layers.py`` test_rwkv6_chunked_matches_step_decode on
    the port (atol/rtol 1e-3)."""
    r, k, v, lw, u, _ = map(torch.as_tensor, _rwkv_inputs(1, 32, 2, 16, 8))
    o_chunk, s_chunk = TL.rwkv6_chunked(r, k, v, lw, u, chunk=16)
    s = torch.zeros((1, 2, 16, 16))
    outs = []
    for t in range(32):
        o, s = TL.rwkv6_step(r[:, t:t + 1], k[:, t:t + 1], v[:, t:t + 1],
                             lw[:, t:t + 1], u, s)
        outs.append(o[:, 0])
    np.testing.assert_allclose(_np(o_chunk), _np(torch.stack(outs, 1)),
                               atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(_np(s_chunk), _np(s), atol=1e-3, rtol=1e-3)


# ---------------------------------------------------------------------------
# keyed init
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("stacked", [False, True])
def test_init_matches_reference(stacked):
    kw = dict(n_layers=4, scan_layers=True) if stacked else {}
    jcfg = jget(ARCH).reduced().replace(**kw)
    tcfg = tget(ARCH).reduced().replace(**kw)
    jp, jaxes = JT.init(jcfg, jax.random.PRNGKey(3))
    tp, taxes = TT.init(tcfg, prng.PRNGKey(3), device="cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tpaths, tleaves = flatten_with_paths(tp)
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == [
        p.replace("/", "") for p in tpaths]
    if stacked:
        assert tp["groups"]["b0"]["tm"]["w_r"].shape[0] == 4
        assert "rem" not in tp
    for (path, a), b in zip(jflat, tleaves):
        name = jax.tree_util.keystr(path)
        assert tuple(a.shape) == tuple(b.shape), name
        assert str(a.dtype) == str(b.dtype).replace("torch.", ""), name
        leaf = name.split("['")[-1].rstrip("']")
        a = np.asarray(a)
        if leaf in ("mu", "u", "ln_x", "ln1", "ln2"):
            np.testing.assert_array_equal(_np(b), a, err_msg=name)
        elif leaf == "w0":
            ulps = np.abs(_np(b).view(np.int32).astype(np.int64)
                          - a.view(np.int32).astype(np.int64))
            assert ulps.max() <= 1, (name, ulps.max())
        else:
            rtol = 2e-5 if b.dtype == torch.float32 else 2.0 ** -7
            np.testing.assert_allclose(_np(b), _np(a), rtol=rtol, atol=1e-8,
                                       err_msg=name)
    assert jax.tree.leaves(jaxes, is_leaf=lambda x: isinstance(x, tuple)) \
        == jax.tree.leaves(taxes, is_leaf=lambda x: isinstance(x, tuple))
    # the reference's tree carries to the port with the port's own paths
    # and dtypes, and the port's to numpy and back bit for bit (bf16 leaves
    # widen to fp32 in numpy, exactly)
    cpaths, carried = flatten_with_paths(tree_from_numpy(
        jax.tree.map(np.asarray, jp), "cpu"))
    assert cpaths == tpaths
    assert [x.dtype for x in carried] == [x.dtype for x in tleaves]
    back = flatten_with_paths(tree_from_numpy(tree_to_numpy(tp), "cpu"))[1]
    for x, y in zip(tleaves, back):
        assert torch.equal(x, y.to(x.dtype))


# ---------------------------------------------------------------------------
# forward and loss on carried weights
# ---------------------------------------------------------------------------
def _batch(vocab, B, S, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S))
    labels = rng.integers(0, vocab, (B, S))
    return ({"tokens": jnp.asarray(toks, jnp.int32),
             "labels": jnp.asarray(labels, jnp.int32)},
            {"tokens": torch.as_tensor(toks),
             "labels": torch.as_tensor(labels)})


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_apply_and_loss_match_reference(impl):
    jcfg, tcfg = _cfgs(rwkv_impl=impl)
    jp, tp = _bonus_params(jcfg, 4)
    jb, tb = _batch(jcfg.vocab, 2, 128, 5)
    before = rw_kernel.launches
    got, _ = TT.apply(tp, tcfg, tb)
    assert rw_kernel.launches == before        # no kernel on the CPU
    want, _ = _japply(jp, jcfg, jb)
    assert got.dtype == torch.float32 and got.shape == (2, 128, jcfg.vocab)
    np.testing.assert_allclose(_np(got), _np(want), atol=LOGIT_ATOL,
                               rtol=LOGIT_RTOL)
    tl, tm = TT.loss_fn(tp, tcfg, tb)
    jl, _ = _jloss(jp, jcfg, jb)
    assert np.isfinite(float(tl)) and float(tm["tokens"]) == 256
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)


def test_pallas_path_matches_xla_path():
    """``tests/test_model_kernel_impls.py`` test_rwkv6_kernel_impl_matches_
    model on the port: the wrapper's path (the kernel's plain version on
    the CPU) against ``layers.rwkv6_chunked`` (atol 5e-4, rtol 1e-4)."""
    jcfg, tcfg = _cfgs()
    _, tp = _bonus_params(jcfg, 0)
    _, tb = _batch(tcfg.vocab, 2, 128, 1)
    l_xla, _ = TT.apply(tp, tcfg, tb)
    l_pal, _ = TT.apply(tp, tcfg.replace(rwkv_impl="pallas"), tb)
    np.testing.assert_allclose(_np(l_xla), _np(l_pal), atol=5e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# caches: prefill and decode
# ---------------------------------------------------------------------------
def test_prefill_and_decode_match_reference():
    """Prefill of 40 tokens (chunk fallback to 8), then 4 decode steps:
    logits within the forward's tolerance, and the recurrent state and
    both token-shift rows written equal to the reference's (atol/rtol
    1e-5)."""
    jcfg, tcfg = _cfgs(rwkv_impl="pallas")
    jp, tp = _bonus_params(jcfg, 6)
    B, S0, steps = 2, 40, 4
    toks = np.random.default_rng(7).integers(0, jcfg.vocab, (B, S0 + steps))
    jcache, _ = JT.init_cache(jcfg, B, S0 + steps)
    tcache, _ = TT.init_cache(tcfg, B, S0 + steps, device="cpu")
    jlg, jcache = _jprefill(jp, jcfg, {"tokens": jnp.asarray(
        toks[:, :S0], jnp.int32)}, jcache)
    tlg, tcache2 = TT.prefill(tp, tcfg, {"tokens": torch.as_tensor(
        toks[:, :S0])}, tcache)
    # the caches were written in place: the returned tree holds the very
    # tensors that init_cache allocated
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
        assert tuple(a.shape) == tuple(b.shape) and b.dtype == torch.float32
        np.testing.assert_allclose(_np(b), _np(a), atol=1e-5, rtol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("stacked", [False, True])
def test_prefill_decode_matches_full_forward(stacked):
    """The reference's property on the port, in the flat layout and in the
    stacked one (``tests/test_scanned_stacks.py``: scan_layers, 4 layers):
    teacher-forced decode reproduces the full forward's logits (atol/rtol
    2e-3, the zoo's tolerance for it)."""
    kw = dict(n_layers=4, scan_layers=True) if stacked else {}
    cfg = tget(ARCH).reduced().replace(dtype="float32", **kw)
    params, _ = TT.init(cfg, prng.PRNGKey(4), device="cpu")
    if stacked:
        assert "groups" in params and "rem" not in params
    B, S0, S1 = 2, 32, 40
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
    states = (cache["groups"]["b0"]["tm"]["s"] if stacked
              else cache["rem"]["l0"]["tm"]["s"])
    assert float(states.abs().max()) > 0      # the state was written


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def served():
    jcfg, tcfg = _cfgs()
    jp, tp = _bonus_params(jcfg, 0)
    prompts = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 64))
    return jcfg, tcfg, jp, tp, prompts.astype(np.int32)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_greedy_generate_matches_reference(served, impl):
    jcfg, tcfg, jp, tp, prompts = served
    jcfg, tcfg = jcfg.replace(rwkv_impl=impl), tcfg.replace(rwkv_impl=impl)
    want = jgenerate(jp, jcfg, jnp.asarray(prompts), 6)
    got = generate(tp, tcfg, prompts, 6)
    assert got.tokens.shape == (2, 70) and got.logprobs.shape == (2, 6)
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
