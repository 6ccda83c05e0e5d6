"""The port's MoE family (granite-moe-1b-a400m, grok-1-314b) against the JAX
package's, on the CPU.

* ``layers.moe_apply``: the "map" and "vmap" dispatches, grouped and
  ungrouped, capacity drops (cf 0.1) and none to speak of (1.25), the
  swiglu, geglu and gelu experts: routes (expert ids, slots, keep) equal
  to the reference's on the same inputs (the smallest top-k margin seen is
  printed: routing is discontinuous where the k-th and (k+1)-th router
  probabilities tie), y and the aux in fp32 within atol/rtol 1e-5;
* ``layers.top_k`` orders ties as ``jax.lax.top_k`` (lower index first);
* the keyed ``init`` of both reduced configs, stacked and unstacked;
* ``apply`` logits (fp32 within 1e-4), the aux, ``loss_fn`` and its grads
  against ``jax.grad`` (rtol 1e-4 / atol 1e-5);
* prefill + decode against the full forward in the dropless regime
  (capacity factor 64, the reference's ``tests/test_models.py`` rule) and
  against JAX's own prefill and decode at the default capacity factor;
* greedy ``generate``: tokens equal to JAX's;
* one FedMom ``round_step`` each against JAX's (rtol 1e-4 / atol 1e-5);
* remat: the grads, the router's load-balance grads among them, bit-equal
  with and without remat (``"full"`` and ``"dots"``);
* reduced granite through ``FederatedTrainer``: the scanned, device and
  auto planes bit-equal to the per-round plane;
* ``examples/federated_llm_torch.py --arch granite-moe-1b-a400m``'s
  ``main`` on the CPU;
* the reference's ``test_param_count_analytic_close_to_actual`` on the
  port;
* ``examples/serve_demo_torch.py``'s default family sample, granite among
  it, on the CPU.
"""
import dataclasses
import os
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import _zoo_pairs as Z  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch import random as prng  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.data import lm_clients_to_dataset  # noqa: E402
from repro_torch.data import synthetic_token_clients  # noqa: E402
from repro_torch.interop import tree_from_numpy  # noqa: E402
from repro_torch.launch.plan import ExecutionPlan  # noqa: E402
from repro_torch.launch.train import FederatedTrainer  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.config import MoEConfig  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))
import federated_llm_torch as fed_llm  # noqa: E402

MOE_TOL = 1e-5                  # moe_apply's y and aux, fp32
ARCHES = ["granite-moe-1b-a400m", "grok-1-314b"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **kw):
    kw = dict(dtype="float32", **kw)
    return (jget(arch).reduced().replace(**kw),
            tget(arch).reduced().replace(**kw))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def _j_routes(xf, router, E, k, cf):
    """The reference's routing lines (``repro/models/layers.py``
    ``moe_apply``), on one group."""
    G = xf.shape[0]
    probs = jax.nn.softmax(xf @ router, axis=-1)
    gate_vals, gate_idx = jax.lax.top_k(probs, k)
    cap = int(max(1, np.ceil(k * G * cf / E)))
    onehot = jax.nn.one_hot(gate_idx, E, dtype=jnp.float32)
    pos = jnp.sum((jnp.cumsum(onehot.reshape(G * k, E), axis=0)
                   .reshape(G, k, E) - onehot) * onehot, axis=-1)
    return np.asarray(probs), np.asarray(gate_idx), np.asarray(pos), cap


def _moe_params(rng, E, D, F):
    return {"router": rng.normal(size=(D, E)).astype(np.float32),
            "wi_up": (rng.normal(size=(E, D, F)) / 4).astype(np.float32),
            "wo": (rng.normal(size=(E, F, D)) / 4).astype(np.float32),
            "wi_gate": (rng.normal(size=(E, D, F)) / 4).astype(np.float32)}


MOE_CASES = {
    "ungrouped": dict(group_size=4096, dispatch="map"),
    "grouped-map": dict(group_size=16, dispatch="map"),
    "grouped-vmap": dict(group_size=16, dispatch="vmap"),
}


@pytest.mark.parametrize("cf", [1.25, 0.1])
@pytest.mark.parametrize("case", sorted(MOE_CASES))
@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_moe_apply_matches_reference(act, case, cf):
    kw = MOE_CASES[case]
    E, k, D, F = 4, 2, 16, 24
    rng = np.random.default_rng(len(act) + len(case) + int(10 * cf))
    p = _moe_params(rng, E, D, F)
    # 2 x 40 = 80 tokens: groups of 16 halve the group to 16 (80 % 16 = 0)
    x = rng.normal(size=(2, 40, D)).astype(np.float32)
    g = kw["group_size"] if x.shape[0] * x.shape[1] > kw["group_size"] \
        else x.shape[0] * x.shape[1]
    margin = np.inf
    dropped = 0
    for xi in x.reshape(-1, g, D):
        jprobs, jidx, jpos, cap = _j_routes(jnp.asarray(xi),
                                            jnp.asarray(p["router"]), E, k,
                                            cf)
        _, tidx, _, tpos, tkeep, tcap, _ = TL.moe_routes(
            torch.as_tensor(xi), torch.as_tensor(p["router"]), n_experts=E,
            top_k_=k, capacity_factor=cf)
        assert tcap == cap
        np.testing.assert_array_equal(tidx.numpy(), jidx)
        np.testing.assert_array_equal(tpos.numpy(), jpos)
        np.testing.assert_array_equal(tkeep.numpy(), jpos < cap)
        srt = -np.sort(-jprobs, axis=-1)
        margin = min(margin, float((srt[:, k - 1] - srt[:, k]).min()))
        dropped += int((jpos >= cap).sum())
    print(f"{act} {case} cf={cf}: smallest top-{k} margin {margin:.3e}, "
          f"{dropped} (token, slot) routes dropped")
    if cf < 1:
        assert dropped > 0
    want_y, want_aux = JL.moe_apply(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), n_experts=E, top_k=k,
        capacity_factor=cf, act=act, **kw)
    got_y, got_aux = TL.moe_apply(
        tree_from_numpy(p, "cpu"), torch.as_tensor(x), n_experts=E, top_k=k,
        capacity_factor=cf, act=act, **kw)
    np.testing.assert_allclose(Z.np32(got_y), Z.np32(want_y), atol=MOE_TOL,
                               rtol=MOE_TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), atol=MOE_TOL,
                               rtol=MOE_TOL)


def test_top_k_orders_ties_as_reference():
    x = np.array([[0.1, 0.3, 0.3, 0.2, 0.3, 0.0],
                  [0.5, 0.5, 0.5, 0.5, 0.5, 0.5],
                  [0.0, 0.2, 0.0, 0.2, 0.9, 0.2]], np.float32)
    for k in (1, 2, 3, 5):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = TL.top_k(torch.as_tensor(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_one_hot_matches_reference():
    ids = np.array([[0, 3, -1], [5, 2, 4]], np.int32)
    for n in (4, 6):
        np.testing.assert_array_equal(
            TL.one_hot(torch.as_tensor(ids), n, torch.float32).numpy(),
            np.asarray(jax.nn.one_hot(jnp.asarray(ids), n)))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("stacked", [False, True], ids=["flat", "stacked"])
@pytest.mark.parametrize("arch", ARCHES)
def test_init_matches_reference(arch, stacked):
    kw = dict(n_layers=4, scan_layers=True) if stacked else {}
    jcfg = jget(arch).reduced().replace(**kw)
    tcfg = tget(arch).reduced().replace(**kw)
    tp = Z.check_init(jcfg, tcfg)
    mlp = (tp["groups"]["b0"] if stacked else tp["rem"]["l0"])["mlp"]
    E = tcfg.moe.n_experts
    assert mlp["router"].dtype == torch.float32
    assert mlp["wi_up"].shape[-3:] == (E, tcfg.d_model, tcfg.d_ff)
    assert mlp["wo"].shape[-3:] == (E, tcfg.d_ff, tcfg.d_model)


@pytest.mark.parametrize("arch", ARCHES)
def test_apply_loss_and_grads_match_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    Z.check_apply_and_grads(jcfg, tcfg, Z.make_batch(jcfg, 2, 64, 5))


def test_grouped_forward_matches_reference(monkeypatch):
    """More tokens than a group: 2 x 96 tokens in groups of 64 (the
    capacity per group), stacked layers, "map" and "vmap"."""
    for mod in (JL, TL):
        moe = mod.moe_apply
        monkeypatch.setattr(mod, "moe_apply", lambda *a, _f=moe, **k: _f(
            *a, **{"group_size": 64, **k}))
    for dispatch in ("map", "vmap"):
        jcfg, tcfg = _cfgs("granite-moe-1b-a400m", moe_dispatch=dispatch,
                           n_layers=3, scan_layers=True)
        jp, _ = Z.JT.init(jcfg, jax.random.PRNGKey(7))
        batch = Z.make_batch(jcfg, 2, 96, 8)
        want, jaux = Z.JT.apply(jp, jcfg, Z.jbatch(batch))
        got, taux = TT.apply(Z.carry(jp), tcfg, Z.tbatch(batch))
        np.testing.assert_allclose(Z.np32(got), Z.np32(want),
                                   atol=Z.LOGIT_ATOL, rtol=Z.LOGIT_RTOL)
        np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHES)
def test_prefill_decode_matches_full_forward(arch):
    """Dropless (capacity factor 64): teacher-forced decode reproduces the
    full forward (rtol/atol 2e-3), as the reference's test asks."""
    cfg = tget(arch).reduced().replace(dtype="float32")
    cfg = cfg.replace(moe=MoEConfig(n_experts=cfg.moe.n_experts,
                                    top_k=cfg.moe.top_k,
                                    capacity_factor=64.0))
    Z.check_decode_against_forward(cfg, Z.make_batch(cfg, 2, 40, 9), 32)


@pytest.mark.parametrize("arch", ARCHES)
def test_prefill_and_decode_match_reference(arch):
    """At the default capacity factor 1.25 (drops depend on the group, so
    decode need not match the forward): JAX's own prefill and decode."""
    jcfg, tcfg = _cfgs(arch)
    Z.check_decode_against_reference(jcfg, tcfg,
                                     Z.make_batch(jcfg, 2, 40, 10), 32)


def test_generate_matches_reference():
    jcfg, tcfg = _cfgs("granite-moe-1b-a400m")
    Z.check_generate(jcfg, tcfg, Z.make_batch(jcfg, 2, 24, 11), 24, 6)


@pytest.mark.parametrize("arch", ARCHES)
def test_federated_round_matches_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    Z.check_round(jcfg, tcfg)


def test_remat_grads_bit_equal_with_aux():
    """4 stacked MoE layers: the grads, and the grads of the aux alone
    (the router's load-balance gradient, an output of the remat node),
    bit-equal with and without remat."""
    cfg = tget("granite-moe-1b-a400m").reduced().replace(
        dtype="float32", n_layers=4, scan_layers=True, remat=True)
    batch = Z.make_batch(cfg, 2, 32, 12)
    params = Z.check_remat_bit_equal(cfg, batch)
    tb = Z.tbatch(batch)

    def aux_grads(c):
        return leaves(torch.func.grad(
            lambda p: TT.loss_fn(p, c, tb)[1]["aux"])(params))

    plain = aux_grads(dataclasses.replace(cfg, remat=False))
    router = params["groups"]["b0"]["mlp"]["router"]
    idx = [i for i, x in enumerate(leaves(params)) if x is router]
    assert idx and float(plain[idx[0]].abs().max()) > 0
    for policy in ("full", "dots"):
        got = aux_grads(dataclasses.replace(cfg, remat_policy=policy))
        assert all(torch.equal(a, b) for a, b in zip(got, plain)), policy


def _trainer(cfg, params, axes, sampler_cls):
    ds = lm_clients_to_dataset(synthetic_token_clients(
        8, cfg.vocab, 4000, seed=0, skew=2.0), seq_len=32, seed=1)
    pop = ds.population()
    opt = tcore.fedmom(eta=pop.n_clients / 2, beta=0.9)
    rcfg = tcore.RoundConfig(clients_per_round=2, local_steps=2, lr=0.2,
                             placement="mesh", compute_dtype="float32")
    return FederatedTrainer(
        loss_fn=lambda p, b: TT.loss_fn(p, cfg, b), server_opt=opt,
        rcfg=rcfg, dataset=ds, sampler=sampler_cls(pop, 2, seed=2),
        state=opt.init(params), param_axes=axes, local_batch=4,
        device="cpu")


def test_trainer_planes_bit_equal():
    """Reduced granite through ``FederatedTrainer``: the scanned plane (5
    rounds, chunks of 2, the host sampler) and the device and auto planes
    (3 rounds, the keyed sampler) bit-equal to the per-round plane."""
    cfg = tget("granite-moe-1b-a400m").reduced().replace(dtype="float32")
    params, axes = TT.init(cfg, prng.PRNGKey(0), device="cpu")

    def run(plane, sampler_cls, n):
        tr = _trainer(cfg, params, axes, sampler_cls)
        plan = (None if plane == "per_round"
                else ExecutionPlan(plane=plane, chunk_rounds=2))
        tr.run(n, plan=plan, verbose=False)
        if plane == "auto":
            assert tr.session.plan_log[-1]["plane"] == "device"
        return ([r["loss"] for r in tr.history if "loss" in r],
                leaves((tr.state.w, tr.state.extra)))

    def same(a, b):
        assert a[0] == b[0]
        assert all(torch.equal(x, y) for x, y in zip(a[1], b[1]))

    base = run("per_round", tcore.UniformSampler, 5)
    assert all(np.isfinite(base[0]))
    same(run("scanned", tcore.UniformSampler, 5), base)
    keyed = run("per_round", tcore.DeviceUniformSampler, 3)
    same(run("device", tcore.DeviceUniformSampler, 3), keyed)
    same(run("auto", tcore.DeviceUniformSampler, 3), keyed)


def test_federated_llm_example_trains_moe(capsys):
    trainer, hist = fed_llm.main([
        "--device", "cpu", "--arch", "granite-moe-1b-a400m", "--rounds", "2",
        "--seq", "16", "--clients", "4", "--m", "2", "--plan", "auto",
        "--chunk-rounds", "2"])
    losses = [r["loss"] for r in hist if "loss" in r]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "granite-moe-1b-a400m-reduced" in capsys.readouterr().out
    assert "router" in trainer.state.w["rem"]["l0"]["mlp"]


def test_param_count_analytic_close_to_actual():
    for arch in ARCHES:
        cfg = tget(arch).reduced()
        params, _ = TT.init(cfg, prng.PRNGKey(8), device="cpu")
        actual = sum(x.numel() for x in leaves(params))
        analytic = cfg.n_params()
        assert abs(actual - analytic) / actual < 0.35, (arch, actual,
                                                        analytic)


def test_serve_demo_default_sample_serves_moe():
    """``examples/serve_demo_torch.py --reduced --device cpu`` without
    ``--arch`` serves the family sample, granite-moe-1b-a400m among it (as
    the reference's demo does)."""
    outs = Z.serve_demo_torch.main([
        "--reduced", "--device", "cpu", "--batch", "1", "--prompt-len", "16",
        "--max-new", "3"])
    assert "granite-moe-1b-a400m" in outs and len(outs) == 4
    assert all(o.tokens.shape == (1, 19) for o in outs.values())
