"""Federated training of the zoo's language models in the port against the
JAX package's, on the CPU.

* one federated round per ported family, the reference's
  ``tests/test_models.py`` ``test_arch_smoke_federated_train_step`` setup
  (reduced fp32, which keeps the configs' ``scan_layers`` and ``remat``;
  C=2, H=2, B=2, S=32, weights [0.3, 0.2], FedMom eta 1, beta 0.9, lr
  0.05, ``param_axes``): for qwen3-1.7b, gemma3-1b, recurrentgemma-9b and
  rwkv6-7b the server's w and v, the loss and delta_norm within rtol 1e-4
  / atol 1e-5 of JAX's ``round_step`` on weights carried from JAX (rwkv6's
  w and v by relative L2, see ``_L2_ARCHES``); for
  qwen3-14b and qwen2.5-14b the port's round alone (finite, the server
  moved), which keeps the CPU time down;
* remat on the reference's scanned-stack cases (``tests/
  test_scanned_stacks.py``: gemma3-1b at 12 layers, recurrentgemma-9b at
  6, rwkv6-7b at 4): grads with ``remat_policy`` "full" and "dots" equal
  the grads without remat bit for bit (under ``torch.func.grad`` and under
  autograd), and ``jax.grad`` of the reference within rtol 1e-4 / atol
  1e-5 (rwkv6, ill-conditioned at init, by relative L2: see
  ``_L2_ARCHES``);
* the trainer end to end, the reference's ``tests/test_system.py``
  ``test_end_to_end_reduced_arch_federated_lm`` setup cut to 5 rounds:
  equal keyed cohorts and minibatches, per-round losses within rtol 1e-4,
  final weights within a per-leaf relative L2 error of 2e-3 (the
  trajectory is unstable: see the test), and the trained weights' greedy
  tokens equal to JAX's; the scanned (5 rounds), device and auto (3
  rounds) planes bit-equal to the port's per-round plane;
* ``param_axes`` changes no bit outside a mesh, and the mesh stays
  refused;
* the forward-only kernels (``attention_impl="pallas"``,
  ``rwkv_impl="pallas"``) raise ``NotImplementedError`` under the round
  engine's grad.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import core as jcore  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.data.federated import lm_clients_to_dataset as j_lm_ds  # noqa: E402,E501
from repro.data.synthetic import synthetic_token_clients as j_tokens  # noqa: E402,E501
from repro.launch.train import FederatedTrainer as JTrainer  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import generate as jgenerate  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch import random as prng  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.data import lm_clients_to_dataset as t_lm_ds  # noqa: E402
from repro_torch.data import synthetic_token_clients as t_tokens  # noqa: E402,E501
from repro_torch.interop import tree_from_numpy, tree_to_numpy  # noqa: E402
from repro_torch.launch.plan import ExecutionPlan, PlanError  # noqa: E402
from repro_torch.launch.train import FederatedTrainer  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import generate as tgenerate  # noqa: E402
from repro_torch.tree import flatten_with_paths, leaves, tree_map  # noqa: E402,E501

RTOL, ATOL = 1e-4, 1e-5
C, H, B, S = 2, 2, 2, 32
WEIGHTS = np.asarray([0.3, 0.2], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _carry(jtree):
    return tree_from_numpy(jax.tree.map(np.asarray, jtree), "cpu")


def _batches(vocab, seed=3, C=C, H=H, B=B, S=S):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (C, H, B, S)).astype(np.int32),
            "labels": rng.integers(0, vocab, (C, H, B, S)).astype(np.int32)}


def _rcfg():
    return dict(clients_per_round=C, local_steps=H, lr=0.05,
                placement="mesh", compute_dtype="float32")


# rwkv6 at init: a sequence's first positions reach ln_x's
# rsqrt(var + eps) at o = 0 (the u bonus is 0 and the state empty), which
# multiplies the gradient there by ~1000, and fp32 rounding with it.  Most
# of rwkv6's grad leaves are then 6e-4 to 7e-4 (relative L2) from a float64
# evaluation of the port for JAX and 1.2e-3 to 1.5e-3 for the port, and
# 6e-4 to 8e-4 from each other, a few entries by over 10% (4 layers,
# B=2, S=64).  rwkv6's leaves are held to a relative L2 error of 2e-3,
# every other family's elementwise
_L2_ARCHES = ("rwkv6-7b",)


def _assert_leaf_close(arch, path, a, b, rtol=RTOL, atol=ATOL):
    b = np.asarray(b, np.float32)
    if arch in _L2_ARCHES:
        assert np.linalg.norm(a - b) <= 2e-3 * np.linalg.norm(b), path
        return
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                               err_msg=f"{arch} {path}")


def _assert_tree_close(got, want, arch):
    paths, g = flatten_with_paths(tree_to_numpy(got))
    w = jax.tree.leaves(want)
    assert len(g) == len(w), arch
    for p, a, b in zip(paths, g, w):
        _assert_leaf_close(arch, p, a, b)


def _port_round(cfg, params, batches, axes=None, opt=None, **kw):
    opt = opt or tcore.fedmom(eta=1.0, beta=0.9)
    rcfg = tcore.RoundConfig(**dict(_rcfg(), **kw))
    return tcore.round_step(lambda p, b: TT.loss_fn(p, cfg, b), opt,
                            opt.init(params), batches, WEIGHTS, rcfg,
                            param_axes=axes, device="cpu")


# ---------------------------------------------------------------------------
# one federated round per family
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma3-1b",
                                  "recurrentgemma-9b", "rwkv6-7b"])
def test_federated_round_matches_reference(arch):
    jcfg = jget(arch).reduced().replace(dtype="float32")
    tcfg = tget(arch).reduced().replace(dtype="float32")
    jparams, axes = JT.init(jcfg, jax.random.PRNGKey(2))
    batches = _batches(jcfg.vocab)
    jopt = jcore.fedmom(eta=1.0, beta=0.9)
    want, wm = jcore.round_step(
        lambda p, b: JT.loss_fn(p, jcfg, b), jopt, jopt.init(jparams),
        jax.tree.map(jnp.asarray, batches), jnp.asarray(WEIGHTS),
        jcore.RoundConfig(**_rcfg()), param_axes=axes)
    got, gm = _port_round(tcfg, _carry(jparams), batches, axes=axes)
    for key in ("loss", "delta_norm"):
        np.testing.assert_allclose(float(gm[key]), float(wm[key]),
                                   rtol=RTOL, err_msg=f"{arch} {key}")
    _assert_tree_close(got.w, want.w, arch)
    _assert_tree_close(got.extra, want.extra, arch)
    assert int(got.t) == int(want.t) == 1


@pytest.mark.parametrize("arch", ["qwen3-14b", "qwen2.5-14b"])
def test_federated_round_port_alone(arch):
    cfg = tget(arch).reduced().replace(dtype="float32")
    params, axes = TT.init(cfg, prng.PRNGKey(5), device="cpu")
    w0 = [x.clone() for x in leaves(params)]
    state, m = _port_round(cfg, params, _batches(cfg.vocab), axes=axes)
    assert np.isfinite(float(m["loss"])) and np.isfinite(
        float(m["delta_norm"])), arch
    assert any(not torch.allclose(a, b)
               for a, b in zip(leaves(state.w), w0)), arch


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------
def _lm_batch(vocab, B=2, S=64, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, vocab, (B, S)).astype(np.int32)}


@pytest.mark.parametrize("arch,n_layers", [("gemma3-1b", 12),
                                           ("recurrentgemma-9b", 6),
                                           ("rwkv6-7b", 4)])
def test_remat_grads_equal_and_match_reference(arch, n_layers):
    kw = dict(scan_layers=True, remat=True, n_layers=n_layers,
              dtype="float32")
    jcfg = jget(arch).reduced().replace(**kw)
    tcfg = tget(arch).reduced().replace(**kw)
    jparams, _ = JT.init(jcfg, jax.random.PRNGKey(1))
    params = _carry(jparams)
    assert "groups" in params
    batch = _lm_batch(jcfg.vocab)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}

    def grads(cfg):
        return leaves(torch.func.grad(
            lambda p: TT.loss_fn(p, cfg, tb)[0])(params))

    def autograd_grads(cfg):
        p = tree_from_numpy(tree_to_numpy(params), "cpu")
        for x in leaves(p):
            x.requires_grad_(True)
        TT.loss_fn(p, cfg, tb)[0].backward()
        return [x.grad for x in leaves(p)]

    no_remat = dataclasses.replace(tcfg, remat=False)
    # under torch.func (as the round engine takes grads) and under autograd
    for how in (grads, autograd_grads):
        plain = how(no_remat)
        for policy in ("full", "dots"):
            got = how(dataclasses.replace(tcfg, remat_policy=policy))
            assert all(torch.equal(a, b) for a, b in zip(got, plain)), (
                how.__name__, policy)
    plain = grads(no_remat)
    want = jax.grad(lambda p: JT.loss_fn(p, jcfg, batch)[0])(jparams)
    paths, _ = flatten_with_paths(params)
    for p, a, b in zip(paths, plain, jax.tree.leaves(want)):
        _assert_leaf_close(arch, p, a.numpy(), b)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "gemma3-1b",
                                  "rwkv6-7b"])
def test_remat_grads_bit_equal_under_the_round_engines_vmap(arch):
    """As the round engine's second local step takes them: ``vmap`` over
    two clients, each with weights and tokens of its own, of
    ``torch.func.grad``; the grads with remat (both policies) bit-equal to
    the ones without."""
    cfg = tget(arch).reduced().replace(dtype="float32", n_layers=4,
                                       scan_layers=True, remat=True)
    params, _ = TT.init(cfg, prng.PRNGKey(1), device="cpu")
    pb = tree_map(lambda t: torch.stack([t, t * 1.01]), params)
    batch = {k: torch.as_tensor(v) for k, v in _lm_batch(cfg.vocab, S=32,
                                                         seed=12).items()}
    tb = {k: torch.stack([v, v.flip(0)]) for k, v in batch.items()}

    def grads(c):
        return leaves(torch.func.vmap(torch.func.grad(
            lambda p, b: TT.loss_fn(p, c, b)[0]))(pb, tb))

    plain = grads(dataclasses.replace(cfg, remat=False))
    for policy in ("full", "dots"):
        got = grads(dataclasses.replace(cfg, remat_policy=policy))
        assert all(torch.equal(a, b) for a, b in zip(got, plain)), policy


def test_remat_policy_is_checked():
    cfg = tget("qwen3-1.7b").reduced().replace(
        dtype="float32", scan_layers=True, remat=True,
        remat_policy="offload")
    params, _ = TT.init(cfg, prng.PRNGKey(0), device="cpu")
    tb = {k: torch.as_tensor(v) for k, v in _lm_batch(cfg.vocab).items()}
    with pytest.raises(ValueError, match="remat_policy"):
        torch.func.grad(lambda p: TT.loss_fn(p, cfg, tb)[0])(params)
    # a forward without grad never reaches the remat path
    assert torch.isfinite(TT.loss_fn(params, cfg, tb)[0])


# ---------------------------------------------------------------------------
# param_axes outside a mesh; a mesh that is not a MeshSpec is refused
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("placement", ["mesh", "scan"])
def test_param_axes_changes_nothing(placement):
    cfg = tget("qwen3-1.7b").reduced().replace(dtype="float32")
    params, axes = TT.init(cfg, prng.PRNGKey(2), device="cpu")
    batches = _batches(cfg.vocab)
    a, ma = _port_round(cfg, params, batches, axes=axes, placement=placement)
    b, mb = _port_round(cfg, params, batches, placement=placement)
    assert all(torch.equal(x, y) for x, y in zip(leaves((a.w, a.extra)),
                                                 leaves((b.w, b.extra))))
    assert torch.equal(ma["loss"], mb["loss"])


def test_mesh_still_refused():
    with pytest.raises(PlanError, match="mesh"):
        ExecutionPlan(mesh=object())


# ---------------------------------------------------------------------------
# the forward-only kernels under grad
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,knob", [("gemma3-1b", "attention_impl"),
                                       ("rwkv6-7b", "rwkv_impl")])
@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_kernels_raise_under_grad(arch, knob, remat):
    cfg = tget(arch).reduced().replace(dtype="float32", remat=remat,
                                       **{knob: "pallas"})
    params, _ = TT.init(cfg, prng.PRNGKey(3), device="cpu")
    # 128 positions: the flash kernel's dispatch rule takes multiples of 128
    batches = _batches(cfg.vocab, S=128, H=1)
    with pytest.raises(NotImplementedError, match="backward"):
        _port_round(cfg, params, batches, opt=tcore.fedavg(eta=1.0),
                    local_steps=1)


# ---------------------------------------------------------------------------
# the trainer end to end
# ---------------------------------------------------------------------------
_ROUNDS = 5


def _e2e_cfgs():
    return (jget("gemma3-1b").reduced().replace(dtype="float32"),
            tget("gemma3-1b").reduced().replace(dtype="float32"))


def _port_trainer(cfg, params, axes, sampler_cls, eta):
    ds = t_lm_ds(t_tokens(8, cfg.vocab, 4000, seed=0, skew=2.0),
                 seq_len=32, seed=1)
    pop = ds.population()
    opt = tcore.fedmom(eta=eta, beta=0.9)
    rcfg = tcore.RoundConfig(clients_per_round=2, local_steps=2, lr=0.2,
                             placement="mesh", compute_dtype="float32")
    return FederatedTrainer(
        loss_fn=lambda p, b: TT.loss_fn(p, cfg, b), server_opt=opt,
        rcfg=rcfg, dataset=ds, sampler=sampler_cls(pop, 2, seed=2),
        state=opt.init(params), param_axes=axes, local_batch=4,
        device="cpu")


def _bit_equal(a, b):
    ha, sa = a
    hb, sb = b
    assert [r["loss"] for r in ha] == [r["loss"] for r in hb]
    assert all(torch.equal(x, y) for x, y in zip(leaves((sa.w, sa.extra)),
                                                 leaves((sb.w, sb.extra))))


def _records(hist):
    return [r for r in hist if "loss" in r]


def test_trainer_end_to_end_matches_reference_on_every_plane():
    jcfg, tcfg = _e2e_cfgs()
    jparams, axes = JT.init(jcfg, jax.random.PRNGKey(0))
    streams = j_tokens(8, jcfg.vocab, 4000, seed=0, skew=2.0)
    jds = j_lm_ds(streams, seq_len=32, seed=1)
    jpop = jds.population()
    eta = jpop.n_clients / 2
    jopt = jcore.fedmom(eta=eta, beta=0.9)
    jtr = JTrainer(
        loss_fn=lambda p, b: JT.loss_fn(p, jcfg, b), server_opt=jopt,
        rcfg=jcore.RoundConfig(clients_per_round=2, local_steps=2, lr=0.2,
                               placement="mesh", compute_dtype="float32"),
        dataset=jds, sampler=jcore.UniformSampler(jpop, 2, seed=2),
        state=jopt.init(jparams), param_axes=axes, local_batch=4)
    jhist = jtr.run(_ROUNDS, log_every=10_000, verbose=False)

    params = _carry(jparams)
    tr = _port_trainer(tcfg, params, axes, tcore.UniformSampler, eta)
    # the keyed cohorts and minibatches are the reference's
    jtr2_ds = j_lm_ds(streams, seq_len=32, seed=1)
    jsamp = jcore.UniformSampler(jpop, 2, seed=2)
    tsamp = tcore.UniformSampler(tr.dataset.population(), 2, seed=2)
    for t in range(_ROUNDS):
        ji, jw = jsamp.sample(t)
        ti, tw = tsamp.sample(t)
        np.testing.assert_array_equal(np.asarray(ti), np.asarray(ji))
        np.testing.assert_array_equal(np.asarray(tw), np.asarray(jw))
        jb = jtr2_ds.round_batches(ji, 2, 4, t=t)
        tb = tr.dataset.round_batches(ti, 2, 4, t=t)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(tb[k], np.asarray(jb[k]))
    hist = tr.run(_ROUNDS, verbose=False)
    np.testing.assert_allclose([r["loss"] for r in hist],
                               [r["loss"] for r in jhist], rtol=RTOL)
    # eta = K/M = 4 with lr 0.2 makes this trajectory unstable (the loss
    # goes 7.95, 13.4, 7.9, 19.4, 13.4): by round 5 fp32 rounding has grown
    # to ~1e-2 on embedding entries of up to ~28, and the port differs from
    # itself that much when run on 1 and on 4 CPU threads (per-leaf
    # relative L2 3.5e-4; against JAX 7.4e-4).  Elementwise rtol 1e-4 /
    # atol 1e-5 holds after one round (test_federated_round_matches_
    # reference); after five the per-leaf relative L2 error is held to 2e-3
    for what, got, want in (("w", tr.state.w, jtr.state.w),
                            ("v", tr.state.extra, jtr.state.extra)):
        paths, g = flatten_with_paths(tree_to_numpy(got))
        for p, a, b in zip(paths, g, jax.tree.leaves(want)):
            b = np.asarray(b, np.float32)
            assert np.linalg.norm(a - b) <= 2e-3 * np.linalg.norm(b), (
                what, p)

    # the trained weights serve: greedy tokens equal to JAX's
    prompt = np.zeros((1, 8), np.int32)
    jout = jgenerate(jax.tree.map(lambda x: x.astype(jnp.float32),
                                  jtr.state.w), jcfg, jnp.asarray(prompt), 4)
    tout = tgenerate(tr.state.w, tcfg, torch.as_tensor(prompt), 4)
    np.testing.assert_array_equal(np.asarray(tout.tokens),
                                  np.asarray(jout.tokens))
    assert tuple(tout.tokens.shape) == (1, 12)

    # the scanned plane against the per-round plane, same host sampler
    scanned = _port_trainer(tcfg, params, axes, tcore.UniformSampler, eta)
    scanned.run(_ROUNDS, plan=ExecutionPlan(plane="scanned",
                                            chunk_rounds=2), verbose=False)
    _bit_equal((_records(scanned.history), scanned.state),
               (hist, tr.state))
    # the device and auto planes against the per-round plane, keyed
    # sampler: 3 rounds in chunks of 2 (a whole chunk and a ragged one)
    runs = {}
    for plane in ("per_round", "device", "auto"):
        t = _port_trainer(tcfg, params, axes, tcore.DeviceUniformSampler,
                          eta)
        plan = (None if plane == "per_round"
                else ExecutionPlan(plane=plane, chunk_rounds=2))
        t.run(3, plan=plan, verbose=False)
        runs[plane] = (_records(t.history), t.state)
        if plane == "auto":
            assert t.session.plan_log[-1]["plane"] == "device"
    _bit_equal(runs["device"], runs["per_round"])
    _bit_equal(runs["auto"], runs["per_round"])
