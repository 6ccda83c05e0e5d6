"""The port's dense model zoo (``configs``, ``models/{config,layers,blocks,
transformer}``) against the JAX package's, on the CPU.

* configs: every architecture's ``ModelConfig`` equal field for field,
  reduced variants and parameter counts too;
* layers: norms, rope, the q-chunked masked attention (causal, window,
  ring-buffer positions, ``kv_len``, grouped and expanded GQA, q chunks)
  and the three MLPs, fp32, within fp32 rounding (atol 1e-5);
* keyed ``init``: the same tree, shapes and dtypes as the reference's, for
  reduced gemma3-1b with stacked groups (14 layers: 2 groups + 2 rem) and
  without, and for reduced qwen3-1.7b; float32 leaves within the
  ``normal`` tolerance of ROADMAP Queue 3 (rtol 2e-5: the two ``erfinv``),
  bfloat16 leaves within one bf16 ulp (rtol 2**-7: two float32 values a
  few ulps apart can round to neighbouring bf16 values);
* ``apply``, ``prefill`` and ``decode_step`` on weights carried from JAX,
  fp32, with ``attention_impl`` "xla" and "pallas" on both sides (the
  Pallas kernel in interpret mode, the port's kernel wrapper taking its
  plain version on CPU tensors): logits within atol 2e-4, rtol 1e-4, and
  the caches written equal;
* the reference's prefill/decode consistency property and its ring-buffer
  wrap (``tests/test_models.py``), run on the port;
* parameter and cache trees carried JAX -> port -> numpy -> JAX unchanged;
* the entry points need a card unless given a device.

The MoE, encoder-decoder and VLM families are held to the reference in
``tests/test_torch_{moe,encdec,vlm}.py``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import random as prng  # noqa: E402
from repro_torch.configs import ARCH_IDS as T_ARCH_IDS  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.interop import tree_from_numpy, tree_to_numpy  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402,E501
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.tree import flatten_with_paths  # noqa: E402

LOGIT_ATOL, LOGIT_RTOL = 2e-4, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one intra-op thread here: the suite runs in several worker
    processes at once, and each one's default thread pool oversubscribes
    the host (a reduced keyed init then takes minutes, not seconds)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
# the reference's functions, jitted (the config is static): the same
# programs, compiled once instead of dispatched op by op
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


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_equal_to_reference(arch):
    assert T_ARCH_IDS == ARCH_IDS
    for suffix in ("", "-reduced"):
        j, t = jget(arch + suffix), tget(arch + suffix)
        assert dataclasses.asdict(j) == dataclasses.asdict(t), arch + suffix
        assert t.n_params() == j.n_params()
        assert t.n_active_params() == j.n_active_params()
        assert (t.n_groups, t.n_remainder) == (j.n_groups, j.n_remainder)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def test_norms_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 3, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    pos = rng.integers(0, 5000, size=(2, 9)).astype(np.int32)
    for fn in ("rms_norm", "head_rms_norm"):
        np.testing.assert_allclose(
            _np(getattr(TL, fn)(torch.as_tensor(x), torch.as_tensor(scale))),
            _np(getattr(JL, fn)(jnp.asarray(x), jnp.asarray(scale))),
            atol=1e-5, rtol=1e-5)
    ts, tc = TL.rope_tables(torch.as_tensor(pos), 16, 1_000_000.0)
    js, jc = JL.rope_tables(jnp.asarray(pos), 16, 1_000_000.0)
    np.testing.assert_allclose(_np(ts), _np(js), atol=1e-5)
    np.testing.assert_allclose(_np(tc), _np(jc), atol=1e-5)
    np.testing.assert_allclose(
        _np(TL.apply_rope(torch.as_tensor(x), ts, tc)),
        _np(JL.apply_rope(jnp.asarray(x), js, jc)), atol=1e-5)


ATTN_CASES = {
    "causal": dict(causal=True),
    "window": dict(causal=True, window=5),
    "noncausal": dict(causal=False),
    "q_chunk": dict(causal=True, window=7, q_chunk=4),
    "grouped": dict(causal=True, grouped=True),
    "decode_kv_len": dict(causal=True, q_offset=11, kv_len=12, S=1),
    "decode_ring": dict(causal=True, q_offset=21, window=8, ring=True, S=1),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_matches_reference(case):
    kw = dict(ATTN_CASES[case])
    S = kw.pop("S", 16)
    ring = kw.pop("ring", False)
    T = 8 if ring else 16
    rng = np.random.default_rng(len(case))
    q = rng.normal(size=(2, S, 4, 8)).astype(np.float32)
    k = rng.normal(size=(2, T, 2, 8)).astype(np.float32)
    v = rng.normal(size=(2, T, 2, 8)).astype(np.float32)
    jkw, tkw = dict(kw), dict(kw)
    if ring:
        # a ring buffer of 8 slots after position 21: slot i holds the
        # latest position congruent to i, one slot still empty (-1)
        kpos = np.array([16, 17, 18, 19, 20, 21, -1, 15], np.int32)
        jkw["k_positions"] = jnp.asarray(kpos)
        tkw["k_positions"] = torch.as_tensor(kpos)
    got = TL.attention(*map(torch.as_tensor, (q, k, v)), **tkw)
    want = JL.attention(*map(jnp.asarray, (q, k, v)), **jkw)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_reference(act):
    rng = np.random.default_rng(3)
    p = {k: rng.normal(size=s).astype(np.float32) / 4 for k, s in
         (("wi_gate", (16, 24)), ("wi_up", (16, 24)), ("wo", (24, 16)))}
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    got = TL.mlp_apply(tree_from_numpy(p, "cpu"), torch.as_tensor(x), act)
    want = JL.mlp_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x), act)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# keyed init
# ---------------------------------------------------------------------------
INIT_CASES = {
    "gemma3-groups": ("gemma3-1b", dict(n_layers=14, scan_layers=True)),
    "gemma3-flat": ("gemma3-1b", {}),
    "qwen3": ("qwen3-1.7b", {}),
}


@pytest.mark.parametrize("case", sorted(INIT_CASES))
def test_init_matches_reference(case):
    arch, kw = INIT_CASES[case]
    jcfg = jget(arch).reduced().replace(**kw)
    tcfg = tget(arch).reduced().replace(**kw)
    jp, jaxes = JT.init(jcfg, jax.random.PRNGKey(3))
    tp, taxes = TT.init(tcfg, prng.PRNGKey(3), device="cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tpaths, tleaves = flatten_with_paths(tp)
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == [
        p.replace("/", "") for p in tpaths]
    if kw.get("scan_layers"):
        assert "groups" in tp and tp["groups"]["b0"]["attn"]["wq"].shape[0] \
            == tcfg.n_groups == 2 and len(tp["rem"]) == 2
    for (path, a), b in zip(jflat, tleaves):
        name = jax.tree_util.keystr(path)
        assert tuple(a.shape) == tuple(b.shape), name
        assert str(a.dtype) == str(b.dtype).replace("torch.", ""), name
        rtol = 2e-5 if b.dtype == torch.float32 else 2.0 ** -7
        np.testing.assert_allclose(_np(b), _np(a), rtol=rtol, atol=1e-8,
                                   err_msg=name)
    # the logical-axes twin tree has the reference's structure and names
    assert jax.tree.structure(jaxes, is_leaf=lambda x: isinstance(x, tuple)) \
        == jax.tree.structure(taxes, is_leaf=lambda x: isinstance(x, tuple))
    assert jax.tree.leaves(jaxes, is_leaf=lambda x: isinstance(x, tuple)) \
        == jax.tree.leaves(taxes, is_leaf=lambda x: isinstance(x, tuple))


# ---------------------------------------------------------------------------
# forward, prefill and decode on carried weights
# ---------------------------------------------------------------------------
def _pair(impl, **kw):
    kw = dict(dtype="float32", attention_impl=impl, n_layers=14,
              scan_layers=True, **kw)
    jcfg = jget("gemma3-1b").reduced().replace(**kw)
    tcfg = tget("gemma3-1b").reduced().replace(**kw)
    jp, _ = JT.init(jcfg, jax.random.PRNGKey(4))
    return jcfg, tcfg, jp, _carry(jp)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_apply_matches_reference(impl):
    jcfg, tcfg, jp, tp = _pair(impl)
    toks = np.random.default_rng(5).integers(0, jcfg.vocab, (2, 128))
    labels = np.random.default_rng(6).integers(0, jcfg.vocab, (2, 128))
    jb = {"tokens": jnp.asarray(toks, jnp.int32),
          "labels": jnp.asarray(labels, jnp.int32)}
    tb = {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(labels)}
    got, _ = TT.apply(tp, tcfg, tb)
    want, _ = _japply(jp, jcfg, jb)
    assert got.dtype == torch.float32 and got.shape == (2, 128, jcfg.vocab)
    np.testing.assert_allclose(_np(got), _np(want), atol=LOGIT_ATOL,
                               rtol=LOGIT_RTOL)
    tl, _ = TT.loss_fn(tp, tcfg, tb)
    jl, _ = _jloss(jp, jcfg, jb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_prefill_and_decode_match_reference(impl):
    """Prefill of 128 tokens (every layer through the flash path under
    "pallas"), then 4 decode steps; the LOCAL layers' window of 64 makes
    the ring buffers wrap."""
    jcfg, tcfg, jp, tp = _pair(impl)
    B, S0, steps = 2, 128, 4
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jcfg.vocab, (B, S0 + steps))
    jcache, _ = JT.init_cache(jcfg, B, S0 + steps)
    tcache, _ = TT.init_cache(tcfg, B, S0 + steps, device="cpu")
    jlg, jcache = _jprefill(jp, jcfg, {"tokens": jnp.asarray(
        toks[:, :S0], jnp.int32)}, jcache)
    tlg, tcache2 = TT.prefill(tp, tcfg, {"tokens": torch.as_tensor(
        toks[:, :S0])}, tcache)
    assert tcache2 is not None
    np.testing.assert_allclose(_np(tlg), _np(jlg), atol=LOGIT_ATOL,
                               rtol=LOGIT_RTOL)
    for t in range(S0, S0 + steps):
        jlg, jcache = _jdecode(jp, jcfg, jcache, jnp.asarray(
            toks[:, t:t + 1], jnp.int32), jnp.int32(t))
        tlg, tcache2 = TT.decode_step(tp, tcfg, tcache2, torch.as_tensor(
            toks[:, t:t + 1]), t)
        np.testing.assert_allclose(_np(tlg), _np(jlg), atol=LOGIT_ATOL,
                                   rtol=LOGIT_RTOL, err_msg=f"step {t}")
    # the caches were written in place, and hold what the reference's hold
    jflat, tflat = jax.tree.leaves(jcache), flatten_with_paths(tcache)[1]
    assert len(jflat) == len(tflat)
    for a, b in zip(jflat, tflat):
        assert tuple(a.shape) == tuple(b.shape)
        if b.dtype == torch.int32:
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        else:
            np.testing.assert_allclose(_np(b), _np(a), atol=1e-5, rtol=1e-5)


def _batch(cfg, B, S, seed):
    return {"tokens": torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S)))}


@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen3-1.7b", "qwen2.5-14b"])
def test_prefill_decode_matches_full_forward(arch):
    """The reference's property on the port: teacher-forced decode
    reproduces the full-sequence forward logits (rtol/atol 2e-3)."""
    cfg = tget(arch).reduced().replace(dtype="float32")
    params, _ = TT.init(cfg, prng.PRNGKey(4), device="cpu")
    B, S0, S1 = 2, 32, 40
    batch = _batch(cfg, B, S1, 5)
    full, _ = TT.apply(params, cfg, batch)
    cache, _ = TT.init_cache(cfg, B, S1, device="cpu")
    lg, cache = TT.prefill(params, cfg, {"tokens": batch["tokens"][:, :S0]},
                           cache)
    np.testing.assert_allclose(_np(lg), _np(full[:, S0 - 1]), rtol=2e-3,
                               atol=2e-3)
    for t in range(S0, S1 - 1):
        lg, cache = TT.decode_step(params, cfg, cache,
                                   batch["tokens"][:, t:t + 1], t)
        np.testing.assert_allclose(_np(lg), _np(full[:, t]), rtol=2e-3,
                                   atol=2e-3, err_msg=f"{arch} step {t}")


def test_sliding_window_ring_buffer_wraps():
    """gemma3's window cut to 16: decode well past the wrap matches the
    full forward (the ring buffer overwrites the right slots)."""
    cfg = tget("gemma3-1b").reduced().replace(dtype="float32", window=16)
    params, _ = TT.init(cfg, prng.PRNGKey(6), device="cpu")
    B, S0, S1 = 1, 24, 48
    batch = _batch(cfg, B, S1, 7)
    full, _ = TT.apply(params, cfg, batch)
    cache, _ = TT.init_cache(cfg, B, S1, device="cpu")
    lg, cache = TT.prefill(params, cfg, {"tokens": batch["tokens"][:, :S0]},
                           cache)
    for t in range(S0, S1 - 1):
        lg, cache = TT.decode_step(params, cfg, cache,
                                   batch["tokens"][:, t:t + 1], t)
        np.testing.assert_allclose(_np(lg), _np(full[:, t]), rtol=2e-3,
                                   atol=2e-3, err_msg=f"step {t}")
    assert fa_kernel.launches == 0


# ---------------------------------------------------------------------------
# interop, and the entry points' device
# ---------------------------------------------------------------------------
def test_param_and_cache_trees_carry_both_ways():
    """bf16 leaves and stacked groups survive JAX -> port -> numpy -> JAX:
    the numpy side widens bf16 to fp32 exactly, so casting back to the
    leaf's dtype gives the same bits."""
    cfg = jget("gemma3-1b").reduced().replace(n_layers=14, scan_layers=True)
    jp, _ = JT.init(cfg, jax.random.PRNGKey(8))
    jcache, _ = JT.init_cache(cfg, 2, 80)
    jcache = jax.tree.map(lambda z: z + 1 if z.dtype != jnp.int32 else z,
                          jcache)
    for tree in (jp, jcache):
        carried = tree_from_numpy(jax.tree.map(np.asarray, tree), "cpu")
        back = tree_to_numpy(carried)
        assert jax.tree.structure(back) == jax.tree.structure(tree)
        for a, b, c in zip(jax.tree.leaves(tree), jax.tree.leaves(back),
                           flatten_with_paths(carried)[1]):
            assert str(c.dtype).replace("torch.", "") == str(a.dtype)
            np.testing.assert_array_equal(
                np.asarray(jnp.asarray(b).astype(a.dtype)), np.asarray(a))


def test_recurrentgemma_initialises():
    """The RG-LRU family is ported (``tests/test_torch_rglru.py``): reduced
    recurrentgemma-9b initialises and allocates its caches."""
    cfg = tget("recurrentgemma-9b").reduced()
    params, _ = TT.init(cfg, prng.PRNGKey(0), device="cpu")
    cache, _ = TT.init_cache(cfg, 1, 8, device="cpu")
    assert params["rem"]["l0"]["lam"].dtype == torch.float32
    assert cache["rem"]["l0"]["rnn"]["h"].shape == (1, cfg.rnn_d)


def test_entry_points_need_a_card_unless_given_a_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = tget("gemma3-1b-reduced")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.init(cfg, prng.PRNGKey(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.init_cache(cfg, 1, 8)
