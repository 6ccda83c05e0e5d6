"""Shared inputs and checks of the port's MoE, encoder-decoder and VLM tests
(``tests/test_torch_{moe,encdec,vlm}.py``): batches made from a numpy
seed, weights carried from the JAX package, the reference's functions
jitted, and the comparisons each of those files runs on its family.

A batch has the reference's ``tests/test_models.py`` ``make_batch``
layout: tokens and labels [B, S]; for a VLM ``patches`` [B, min(256,
S // 2), d_frontend], ``mrope_positions`` [3, B, S] and a ``loss_mask``
that leaves out the patch positions; for an encoder-decoder ``frames``
[B, 64, d_frontend].  The M-RoPE streams differ here
(``examples/serve_demo_torch.py``'s ``mrope_grid``: a t/h/w grid over the
patches, then the text's indices on all three), where the reference's
smoke test repeats one stream three times, so a swapped section shows.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import core as jcore
from repro.models import transformer as JT
from repro.serve import generate as jgenerate
from repro_torch import core as tcore
from repro_torch.interop import tree_from_numpy, tree_to_numpy
from repro_torch.models import transformer as TT
from repro_torch.serve import generate as tgenerate
from repro_torch.tree import flatten_with_paths, leaves

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))
import serve_demo_torch  # noqa: E402

mrope_grid = serve_demo_torch.mrope_grid

LOGIT_ATOL, LOGIT_RTOL = 1e-4, 1e-4      # fp32 logits, port vs JAX
RTOL, ATOL = 1e-4, 1e-5                  # grads and a round's state
DECODE_TOL = 2e-3                        # prefill/decode vs the forward:
                                         # the reference's own tolerance
FRAMES = 64                              # encoder length of the tests

japply = jax.jit(JT.apply, static_argnums=1)
jloss = jax.jit(JT.loss_fn, static_argnums=1)
jprefill = jax.jit(JT.prefill, static_argnums=1)
jdecode = jax.jit(JT.decode_step, static_argnums=1)


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def carry(jtree):
    return tree_from_numpy(jax.tree.map(np.asarray, jtree), "cpu")


def make_batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        P = min(JT.VLM_PATCHES, S // 2)
        batch["patches"] = rng.normal(
            size=(B, P, cfg.d_frontend)).astype(np.float32)
        batch["mrope_positions"] = mrope_grid(B, S, P)
        mask = np.ones((B, S), np.float32)
        mask[:, :P] = 0.0
        batch["loss_mask"] = mask
    if cfg.enc_dec:
        batch["frames"] = rng.normal(
            size=(B, FRAMES, cfg.d_frontend)).astype(np.float32)
    return batch


def jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def tbatch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def prompt_part(batch, S0):
    """The prefill's batch: the first S0 tokens, their M-RoPE ids, the
    patches and frames; no labels or mask."""
    out = {"tokens": batch["tokens"][:, :S0]}
    if "mrope_positions" in batch:
        out["mrope_positions"] = batch["mrope_positions"][:, :, :S0]
    for k in ("patches", "frames"):
        if k in batch:
            out[k] = batch[k]
    return out


def assert_tree_close(got, want, rtol=RTOL, atol=ATOL, what=""):
    paths, g = flatten_with_paths(tree_to_numpy(got))
    w = jax.tree.leaves(want)
    assert len(g) == len(w), what
    for p, a, b in zip(paths, g, w):
        np.testing.assert_allclose(a, np.asarray(b, np.float32), rtol=rtol,
                                   atol=atol, err_msg=f"{what} {p}")


def check_init(jcfg, tcfg, seed=3):
    """The keyed init's tree, shapes, dtypes and axes equal the
    reference's; fp32 leaves within the ``normal`` tolerance (rtol 2e-5),
    bf16 within one bf16 ulp (rtol 2**-7)."""
    from repro_torch import random as prng
    jp, jaxes = JT.init(jcfg, jax.random.PRNGKey(seed))
    tp, taxes = TT.init(tcfg, prng.PRNGKey(seed), device="cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tpaths, tleaves = flatten_with_paths(tp)
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == [
        p.replace("/", "") for p in tpaths]
    for (path, a), b in zip(jflat, tleaves):
        name = jax.tree_util.keystr(path)
        assert tuple(a.shape) == tuple(b.shape), name
        assert str(a.dtype) == str(b.dtype).replace("torch.", ""), name
        rtol = 2e-5 if b.dtype == torch.float32 else 2.0 ** -7
        np.testing.assert_allclose(np32(b), np32(a), rtol=rtol, atol=1e-8,
                                   err_msg=name)
    is_axes = lambda x: isinstance(x, tuple)  # noqa: E731
    assert jax.tree.structure(jaxes, is_leaf=is_axes) == jax.tree.structure(
        taxes, is_leaf=is_axes)
    assert jax.tree.leaves(jaxes, is_leaf=is_axes) == jax.tree.leaves(
        taxes, is_leaf=is_axes)
    return tp


def check_apply_and_grads(jcfg, tcfg, batch, seed=4):
    """``apply`` logits and aux, ``loss_fn`` and its grads (``torch.func.
    grad`` against ``jax.grad``) on weights carried from JAX."""
    jp, _ = JT.init(jcfg, jax.random.PRNGKey(seed))
    tp = carry(jp)
    jb, tb = jbatch(batch), tbatch(batch)
    got, taux = TT.apply(tp, tcfg, tb)
    want, jaux = japply(jp, jcfg, jb)
    assert got.dtype == torch.float32 and tuple(got.shape) == tuple(
        want.shape)
    np.testing.assert_allclose(np32(got), np32(want), atol=LOGIT_ATOL,
                               rtol=LOGIT_RTOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    tl, tm = TT.loss_fn(tp, tcfg, tb)
    jl, jm = jloss(jp, jcfg, jb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tm["tokens"]), float(jm["tokens"]))
    tg = torch.func.grad(lambda p: TT.loss_fn(p, tcfg, tb)[0])(tp)
    jg = jax.grad(lambda p: JT.loss_fn(p, jcfg, jb)[0])(jp)
    assert_tree_close(tg, jg, what="grad")
    return tp, jp


def check_decode_against_forward(cfg, batch, S0, seed=4):
    """The reference's property on the port: teacher-forced prefill +
    decode reproduce the full forward's logits (rtol/atol 2e-3)."""
    from repro_torch import random as prng
    params, _ = TT.init(cfg, prng.PRNGKey(seed), device="cpu")
    B, S1 = batch["tokens"].shape
    tb = tbatch(batch)
    full, _ = TT.apply(params, cfg, tb)
    cache, _ = TT.init_cache(cfg, B, S1, device="cpu")
    lg, cache = TT.prefill(params, cfg, tbatch(prompt_part(batch, S0)),
                           cache)
    np.testing.assert_allclose(np32(lg), np32(full[:, S0 - 1]),
                               rtol=DECODE_TOL, atol=DECODE_TOL)
    for t in range(S0, S1 - 1):
        lg, cache = TT.decode_step(params, cfg, cache,
                                   tb["tokens"][:, t:t + 1], t)
        np.testing.assert_allclose(np32(lg), np32(full[:, t]),
                                   rtol=DECODE_TOL, atol=DECODE_TOL,
                                   err_msg=f"step {t}")


def check_decode_against_reference(jcfg, tcfg, batch, S0, seed=5):
    """Prefill and decode logits against JAX's on carried weights
    (LOGIT_ATOL / LOGIT_RTOL), and the caches written equal."""
    jp, _ = JT.init(jcfg, jax.random.PRNGKey(seed))
    tp = carry(jp)
    B, S1 = batch["tokens"].shape
    pre = prompt_part(batch, S0)
    jcache, _ = JT.init_cache(jcfg, B, S1)
    tcache, _ = TT.init_cache(tcfg, B, S1, device="cpu")
    jlg, jcache = jprefill(jp, jcfg, jbatch(pre), jcache)
    tlg, tcache = TT.prefill(tp, tcfg, tbatch(pre), tcache)
    np.testing.assert_allclose(np32(tlg), np32(jlg), atol=LOGIT_ATOL,
                               rtol=LOGIT_RTOL)
    toks = batch["tokens"]
    for t in range(S0, S1):
        jlg, jcache = jdecode(jp, jcfg, jcache, jnp.asarray(
            toks[:, t:t + 1]), jnp.int32(t))
        tlg, tcache = TT.decode_step(tp, tcfg, tcache, torch.as_tensor(
            toks[:, t:t + 1]), t)
        np.testing.assert_allclose(np32(tlg), np32(jlg), atol=LOGIT_ATOL,
                                   rtol=LOGIT_RTOL, err_msg=f"step {t}")
    jflat, tflat = jax.tree.leaves(jcache), leaves(tcache)
    assert len(jflat) == len(tflat)
    for a, b in zip(jflat, tflat):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(np32(b), np32(a), atol=1e-5, rtol=1e-5)


def check_generate(jcfg, tcfg, batch, S0, n_new, seed=6, extras=()):
    """Greedy ``generate`` with the family's extras (numpy arrays, placed
    by the engine): tokens equal to JAX's."""
    jp, _ = JT.init(jcfg, jax.random.PRNGKey(seed))
    tp = carry(jp)
    pre = prompt_part(batch, S0)
    ex = {k: pre[k] for k in extras}
    jout = jgenerate(jp, jcfg, jnp.asarray(pre["tokens"]), n_new,
                     extras={k: jnp.asarray(v) for k, v in ex.items()})
    tout = tgenerate(tp, tcfg, pre["tokens"], n_new, extras=ex)
    np.testing.assert_array_equal(tout.tokens, np.asarray(jout.tokens))
    np.testing.assert_allclose(tout.logprobs, np.asarray(jout.logprobs),
                               atol=1e-4)


def round_batches(cfg, C, H, B, S, seed):
    """[C, H, ...] stacks of ``make_batch`` (the VLM's M-RoPE ids
    [C, H, 3, B, S], the batch second after the round's axes)."""
    parts = [make_batch(cfg, B, S, seed + i) for i in range(C * H)]
    return {k: np.stack([p[k] for p in parts]).reshape(
        (C, H) + parts[0][k].shape) for k in parts[0]}


def check_round(jcfg, tcfg, seed=2, C=2, H=2, B=2, S=32):
    """One FedMom ``round_step`` (the reference's ``test_arch_smoke_
    federated_train_step`` setup) against JAX's on carried weights: the
    server's w and v, the loss and delta_norm within rtol 1e-4 /
    atol 1e-5."""
    jp, axes = JT.init(jcfg, jax.random.PRNGKey(seed))
    batches = round_batches(jcfg, C, H, B, S, seed + 10)
    weights = np.asarray([0.3, 0.2], np.float32)
    rc = dict(clients_per_round=C, local_steps=H, lr=0.05,
              placement="mesh", compute_dtype="float32")
    jopt = jcore.fedmom(eta=1.0, beta=0.9)
    want, wm = jcore.round_step(
        lambda p, b: JT.loss_fn(p, jcfg, b), jopt, jopt.init(jp),
        jbatch(batches), jnp.asarray(weights), jcore.RoundConfig(**rc),
        param_axes=axes)
    topt = tcore.fedmom(eta=1.0, beta=0.9)
    got, gm = tcore.round_step(
        lambda p, b: TT.loss_fn(p, tcfg, b), topt, topt.init(carry(jp)),
        batches, weights, tcore.RoundConfig(**rc), param_axes=axes,
        device="cpu")
    for key in ("loss", "delta_norm"):
        np.testing.assert_allclose(float(gm[key]), float(wm[key]),
                                   rtol=RTOL, err_msg=key)
    assert_tree_close(got.w, want.w, what="w")
    assert_tree_close(got.extra, want.extra, what="v")
    assert int(got.t) == int(want.t) == 1
    moved = any(not torch.equal(a, b) for a, b in zip(
        leaves(got.w), leaves(carry(jp))))
    assert moved


def check_remat_bit_equal(cfg, batch, seed=1):
    """Grads with ``remat_policy`` "full" and "dots" equal the grads
    without remat bit for bit, under ``torch.func.grad`` and autograd."""
    import dataclasses
    from repro_torch import random as prng
    params, _ = TT.init(cfg, prng.PRNGKey(seed), device="cpu")
    tb = tbatch(batch)

    def func_grads(c):
        return leaves(torch.func.grad(
            lambda p: TT.loss_fn(p, c, tb)[0])(params))

    def autograd_grads(c):
        p = tree_from_numpy(tree_to_numpy(params), "cpu")
        for x in leaves(p):
            x.requires_grad_(True)
        TT.loss_fn(p, c, tb)[0].backward()
        return [x.grad for x in leaves(p)]

    plain_cfg = dataclasses.replace(cfg, remat=False)
    for how in (func_grads, autograd_grads):
        plain = how(plain_cfg)
        for policy in ("full", "dots"):
            got = how(dataclasses.replace(cfg, remat=True,
                                          remat_policy=policy))
            assert len(got) == len(plain)
            assert all(torch.equal(a, b) for a, b in zip(got, plain)), (
                how.__name__, policy)
    return params
