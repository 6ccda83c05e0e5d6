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
  it, on the CPU;
* the routing by index (``kernels/moe_route``, ``layers._MoEGroup``)
  against the dense one-hot yardstick (``layers.moe_dispatch``): the
  dispatched slots bit-equal, y, the aux and the grads of x, the router
  and the experts within bounds from the backward run on magnitudes
  (ungrouped, grouped "map" and "vmap", cf 1.25 and 0.1, fp32 and bf16;
  and under the round engine's ``vmap(grad_and_value)``); the node's
  hand-written backward against autograd on the plain version and
  against finite differences (float64); the grouped "vmap" and "map"
  dispatches; ``moe_apply`` never calling ``moe_dispatch``; the index
  tables; the meta device; the plain version's summation order.
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


# ---------------------------------------------------------------------------
# routing by index (kernels/moe_route, layers._MoEGroup) against the dense
# yardstick
# ---------------------------------------------------------------------------
def _dense_group(p, xf, *, n_experts, top_k_, capacity_factor, act):
    """``layers._moe_group`` in the reference's dense form: the one-hot
    [G, E, C] dispatch and combine tensors (``layers.moe_dispatch``) and
    the two einsums, differentiated by autograd.  The yardstick the index
    path is held to."""
    probs, _, gate_vals, pos, keep, cap, onehot = TL.moe_routes(
        xf, p["router"], n_experts=n_experts, top_k_=top_k_,
        capacity_factor=capacity_factor)
    dispatch, combine = TL.moe_dispatch(onehot, gate_vals, pos, keep, cap)
    xe = torch.einsum("gec,gd->ecd", dispatch.to(xf.dtype), xf)
    ye = TL.moe_experts(p, xe, act)
    y = torch.einsum("gec,ecd->gd", combine.to(xf.dtype), ye)
    frac = torch.mean(onehot.sum(1), dim=0)
    prob = torch.mean(probs, dim=0)
    return y, n_experts * torch.sum(frac * prob)


ROUTE_E, ROUTE_K, ROUTE_D, ROUTE_F = 4, 2, 16, 24
WEIGHTS = ("router", "wi_gate", "wi_up", "wo")


def _route_inputs(dtype, seed, lead=(2, 40), act="swiglu"):
    """Weights (experts in ``dtype``, the router fp32 as ``init`` makes
    it), tokens, and a cotangent for y exact in ``dtype``."""
    rng = np.random.default_rng(seed)
    p = tree_from_numpy(_moe_params(rng, ROUTE_E, ROUTE_D, ROUTE_F), "cpu")
    p = {k: v if k == "router" else v.to(dtype) for k, v in p.items()}
    if act == "gelu":
        del p["wi_gate"]
    x = torch.as_tensor(rng.normal(size=lead + (ROUTE_D,))
                        .astype(np.float32)).to(dtype)
    r = torch.as_tensor(rng.normal(size=lead + (ROUTE_D,))
                        .astype(np.float32)).to(dtype).float()
    return p, x, r


def _groups(x, group_size):
    """x [B, S, D] in the groups ``layers.moe_apply`` routes."""
    G_all, D = x.shape[0] * x.shape[1], x.shape[2]
    if G_all <= group_size:
        return x.reshape(1, G_all, D)
    g = group_size
    while G_all % g:
        g //= 2
    return x.reshape(G_all // g, g, D)


def _layer(p, x, r, kw, cf, monkeypatch=None, act="swiglu"):
    """(y, aux, grads of p and x) of the loss (y r).sum() + aux, which is
    linear in y, so dy = r exactly; with ``monkeypatch`` the dense
    yardstick runs in place of the index path."""
    if monkeypatch is not None:
        monkeypatch.setattr(TL, "_moe_group", _dense_group)

    def loss(p, x):
        y, aux = TL.moe_apply(p, x, n_experts=ROUTE_E, top_k=ROUTE_K,
                              capacity_factor=cf, act=act, **kw)
        return (y.float() * r).sum() + aux, (y, aux)

    grads, (y, aux) = torch.func.grad(loss, (0, 1), has_aux=True)(p, x)
    if monkeypatch is not None:
        monkeypatch.undo()
    return y, aux, {**grads[0], "x": grads[1]}


def _terms(p, x, r, kw, cf, act="swiglu"):
    """The backward run on magnitudes, in float64: for y and for each
    gradient of the loss (y r).sum() + aux / n_groups, the sum over its
    terms of |term|, each stage's from the |terms| of the stage before
    (the experts' products, the activation's derivative, the moves by
    index, the gate's normalisation, the softmax, the router's products).
    A sum of n terms in any order is within (n - 1) u of its exact value
    in units of its sum of |terms|, and a stage's error reaches the next
    through the same magnitudes, so two summation orders of the whole
    chain differ by at most (the chain's total length) x 2u x these
    sums."""
    from repro_torch.kernels.moe_route import ref as mr_ref
    A = lambda t: t.double().abs()  # noqa: E731
    E, k, D = ROUTE_E, ROUTE_K, ROUTE_D
    xg, rg = _groups(x, kw["group_size"]), _groups(r, kw["group_size"])
    n_g, G = xg.shape[:2]
    w = {n: None if p.get(n) is None else p[n][None] for n in WEIGHTS}
    out = {"y": [], "x": [], "router": 0.0, "wi_gate": 0.0, "wi_up": 0.0,
           "wo": 0.0}
    for xf, rf in zip(xg, rg):
        (_, _, probs, gate_idx, gate, slot, owner, frac, xe, g, u,
         ye) = TL._group_forward(xf[None], *(w[n] for n in WEIGHTS), E, k,
                                 cf, act)
        cap = owner.shape[-1] // E
        keep = (slot >= 0).double()
        gate_a = A(gate.to(x.dtype))
        out["y"].append(mr_ref.sum_rows(A(ye), slot, gate_a)[0])
        dye = mr_ref.gather_rows(A(rf)[None], owner, gate_a, k)
        dye3, xe3 = dye.reshape(E, cap, D), A(xe).reshape(E, cap, D)
        wo = A(p["wo"])
        gated = act in ("swiglu", "geglu")
        if gated:
            a = (torch.nn.functional.silu(g.double()) if act == "swiglu"
                 else torch.nn.functional.gelu(g.double(),
                                               approximate="tanh"))
            slope = A(torch.ops.aten.silu_backward(
                torch.ones_like(g.double()), g.double()) if act == "swiglu"
                else torch.ops.aten.gelu_backward(
                    torch.ones_like(g.double()), g.double(),
                    approximate="tanh"))
            h = a.abs() * A(u)
        else:
            h = A(torch.nn.functional.gelu(u.double(), approximate="tanh"))
            slope = A(torch.ops.aten.gelu_backward(
                torch.ones_like(u.double()), u.double(), approximate="tanh"))
        dh = torch.bmm(dye3, wo.transpose(1, 2))
        out["wo"] = out["wo"] + torch.bmm(h.transpose(1, 2), dye3)
        if gated:
            dg, du = dh * A(u) * slope, dh * a.abs()
            out["wi_gate"] = out["wi_gate"] + torch.bmm(xe3.transpose(1, 2),
                                                        dg)
            dxe = (torch.bmm(dg, A(p["wi_gate"]).transpose(1, 2))
                   + torch.bmm(du, A(p["wi_up"]).transpose(1, 2)))
        else:
            du = dh * slope
            dxe = torch.bmm(du, A(p["wi_up"]).transpose(1, 2))
        out["wi_up"] = out["wi_up"] + torch.bmm(xe3.transpose(1, 2), du)
        dx = mr_ref.sum_rows(dxe.reshape(1, E * cap, D), slot, None)[0]
        dgate = mr_ref.route_dots(A(rf)[None], A(ye), slot) * keep
        tv = torch.gather(probs.double(), -1, gate_idx)
        den = tv.sum(-1, keepdim=True) + 1e-9
        dtv = dgate / den + (dgate * tv / den / den).sum(-1, keepdim=True)
        dprobs = torch.zeros_like(probs, dtype=torch.float64).scatter(
            -1, gate_idx, dtv)
        dprobs = dprobs + (E * frac.double() / G / n_g)[:, None, :]
        pr = probs.double()
        dlogits = pr * (dprobs + (pr * dprobs).sum(-1, keepdim=True))
        out["router"] = out["router"] + A(xf)[None].transpose(-1, -2) @ \
            dlogits
        out["x"].append(dx + (dlogits @ A(p["router"]).T)[0])
    n = ROUTE_D + G * k + ROUTE_F + cap + E + G + 16
    unit = 2.0 ** (-23 if x.dtype == torch.float32 else -8)
    tol = {k_: 2 * n * unit * v for k_, v in out.items()
           if k_ not in ("y", "x") and not isinstance(v, float)}
    tol["router"] = tol["router"][0]
    for k_ in ("wi_gate", "wi_up", "wo"):
        if k_ in tol:
            tol[k_] = tol[k_].reshape(p[k_].shape)
    tol["y"] = 2 * n * unit * torch.stack(out["y"]).reshape(x.shape)
    tol["x"] = 2 * n * unit * torch.stack(out["x"]).reshape(x.shape)
    return tol


def _within(got, want, tol, name):
    diff = (got.double() - want.double()).abs()
    worst = float((diff / tol.clamp(min=1e-300)).max())
    print(f"{name}: max |index - dense| {float(diff.max()):.3e}, "
          f"{worst:.4f} of its bound")
    assert bool((diff <= tol).all()), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [1.25, 0.1])
@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_index_path_matches_dense_yardstick(case, cf, dtype, monkeypatch):
    """``moe_apply`` by index against the same layer with the dense
    one-hot dispatch and combine: the dispatched slots bit-equal to the
    one-hot product (one term a slot); the aux bit-equal (the same
    routes); y and the grads of x, the router and the experts within
    ``_terms``' bounds (the sums that change order)."""
    from repro_torch.kernels.moe_route import ops as mr_ops
    kw = MOE_CASES[case]
    dt = getattr(torch, dtype)
    p, x, r = _route_inputs(dt, len(case) + int(10 * cf) + len(dtype))
    for xf in _groups(x, kw["group_size"]):
        _, idx, gate, pos, keep, cap, onehot = TL.moe_routes(
            xf, p["router"], n_experts=ROUTE_E, top_k_=ROUTE_K,
            capacity_factor=cf)
        slot, owner = mr_ops.route_tables(idx, pos, keep, cap, ROUTE_E)
        dispatch, _ = TL.moe_dispatch(onehot, gate, pos, keep, cap)
        dense = torch.einsum("gec,gd->ecd", dispatch.to(dt), xf)
        got = mr_ops.gather_rows(xf[None], owner[None], None, ROUTE_K)
        assert torch.equal(got[0], dense.reshape(-1, ROUTE_D))
    y, aux, grads = _layer(p, x, r, kw, cf)
    y_d, aux_d, grads_d = _layer(p, x, r, kw, cf, monkeypatch)
    assert torch.equal(aux, aux_d)
    tol = _terms(p, x, r, kw, cf)
    _within(y, y_d, tol["y"], "y")
    for name in ("x",) + WEIGHTS:
        _within(grads[name], grads_d[name], tol[name], f"{name} grad")


@pytest.mark.parametrize("case", ["ungrouped", "grouped-vmap"])
def test_index_path_under_round_engine_vmap(case, monkeypatch):
    """As the round engine calls it: ``vmap`` over three clients of
    ``grad_and_value`` over the weights (shared: the node broadcasts
    them and returns each client's grads).  The values within 1e-6 of the
    dense yardstick's under the same transforms and the grads within
    each client's ``_terms`` bounds; each client bit-equal to the same
    step alone."""
    kw = MOE_CASES[case]
    p, _, _ = _route_inputs(torch.float32, 17)
    _, x, r = _route_inputs(torch.float32, 18, lead=(3, 2, 40))

    def loss(p, x, r):
        y, aux = TL.moe_apply(p, x, n_experts=ROUTE_E, top_k=ROUTE_K,
                              capacity_factor=1.25, act="swiglu", **kw)
        return (y * r).sum() + aux

    def engine():
        return torch.func.vmap(torch.func.grad_and_value(loss),
                               in_dims=(None, 0, 0))(p, x, r)

    grads, vals = engine()
    monkeypatch.setattr(TL, "_moe_group", _dense_group)
    grads_d, vals_d = engine()
    monkeypatch.undo()
    for c in range(x.shape[0]):
        torch.testing.assert_close(vals[c], vals_d[c], rtol=1e-6, atol=0)
        tol = _terms(p, x[c], r[c], kw, 1.25)
        for name in WEIGHTS:
            _within(grads[name][c], grads_d[name][c], tol[name],
                    f"client {c} {name} grad")
        alone, val = torch.func.grad_and_value(loss)(p, x[c], r[c])
        assert torch.equal(val, vals[c])
        for name in alone:
            assert torch.equal(alone[name], grads[name][c]), name


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_index_path_with_per_client_weights(case):
    """As the round engine's second local step calls it: ``vmap`` over
    two clients of ``grad_and_value``, each client with weights of its own
    (``in_dims`` 0), so the folded node meets a router and experts a client
    beside groups a client.  Each client bit-equal to the same step alone,
    and within its ``_terms`` bounds of the dense yardstick."""
    kw = MOE_CASES[case]
    ps = [_route_inputs(torch.float32, 31 + c)[0] for c in range(2)]
    p = {n: torch.stack([q[n] for q in ps]) for n in ps[0]}
    _, x, r = _route_inputs(torch.float32, 33, lead=(2, 2, 40))

    def loss(p, x, r):
        y, aux = TL.moe_apply(p, x, n_experts=ROUTE_E, top_k=ROUTE_K,
                              capacity_factor=1.25, act="swiglu", **kw)
        return (y * r).sum() + aux

    grads, vals = torch.func.vmap(torch.func.grad_and_value(loss))(p, x, r)
    for c in range(2):
        alone, val = torch.func.grad_and_value(loss)(ps[c], x[c], r[c])
        assert torch.equal(val, vals[c])
        for name in alone:
            assert torch.equal(alone[name], grads[name][c]), name
        _, _, dense = _layer(ps[c], x[c], r[c], kw, 1.25, pytest.MonkeyPatch())
        tol = _terms(ps[c], x[c], r[c], kw, 1.25)
        for name in WEIGHTS:
            _within(grads[name][c], dense[name], tol[name],
                    f"client {c} {name} grad")


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_backward_matches_autograd(act, dtype):
    """``layers._group_backward`` (the node's hand-written backward)
    against autograd through ``_group_forward`` run on the plain
    version (differentiable torch operations), on two groups that share
    the router and the experts: the experts' grads bit-equal (the same
    products in the same order); x's and the router's within ``_terms``'
    bounds (the gate's normalisation and the router's products are
    rounded in another order)."""
    dt = getattr(torch, dtype)
    p, x, r = _route_inputs(dt, 23, lead=(2, 24), act=act)
    w = [None if p.get(n) is None else p[n][None] for n in WEIGHTS]
    leaves_ = [x] + [t for t in w if t is not None]
    ins = [t.clone().requires_grad_(True) for t in leaves_]
    it = iter(ins[1:])
    wi = [None if t is None else next(it) for t in w]
    outs = TL._group_forward(ins[0], *wi, ROUTE_E, ROUTE_K, 1.25, act)
    daux = torch.full((2,), 0.5)
    want = torch.autograd.grad((outs[0], outs[1]), ins,
                               (r.to(dt), daux))
    with torch.no_grad():
        o = TL._group_forward(x, *w, ROUTE_E, ROUTE_K, 1.25, act)
        got = TL._group_backward(r.to(dt), daux, x, *w, *o[2:], ROUTE_E,
                                 ROUTE_K, act)
    got = [got[0]] + [g.sum(0, keepdim=True) for g in got[1:]
                      if g is not None]
    tol = _terms(p, x, r, {"group_size": 24}, 1.25, act=act)
    names = ["x"] + [n for n in WEIGHTS if p.get(n) is not None]
    for name, a, b in zip(names, got, want):
        if name in ("x", "router"):
            t = tol[name] if name == "x" else tol[name][None]
            _within(a, b, t, f"{name} grad")
        else:
            assert torch.equal(a, b), name


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_group_gradcheck(act, cf, monkeypatch):
    """The node's gradients of x, the router and the experts against
    finite differences, in float64 on the plain version, at gradcheck's
    own tolerances.  The routes (experts, slots, drops) are the fp32
    router's, as the port takes them; the router's probabilities and the
    gates are recomputed from them in float64, so that finite differences
    see the gradient the node derives (the routes do not flip under
    gradcheck's steps at these inputs)."""
    routes = TL.moe_routes

    def routes64(xf, router, **kw):
        probs, idx, _, pos, keep, cap, onehot = routes(xf, router, **kw)
        probs = torch.softmax(xf @ router, dim=-1)
        tv = torch.gather(probs, -1, idx)
        gate = tv / (torch.sum(tv, -1, keepdim=True) + 1e-9) * keep
        return probs, idx, gate, pos, keep, cap, onehot

    monkeypatch.setattr(TL, "moe_routes", routes64)
    g = torch.Generator().manual_seed(int(cf * 4) + len(act))
    E, k, D, F, G = 4, 2, 6, 5, 12
    t = lambda *s: torch.randn(*s, generator=g,  # noqa: E731
                               dtype=torch.float64).requires_grad_(True)
    x, router = t(G, D), t(D, E)
    wi_gate = t(E, D, F) if act == "swiglu" else None
    wi_up, wo = t(E, D, F), t(E, F, D)

    def fn(x, router, wi_up, wo, *gate):
        p = {"router": router, "wi_up": wi_up, "wo": wo,
             "wi_gate": gate[0] if gate else None}
        y, aux = TL._moe_group(p, x, n_experts=E, top_k_=k,
                               capacity_factor=cf, act=act)
        return y, aux

    args = (x, router, wi_up, wo) + ((wi_gate,) if wi_gate is not None
                                     else ())
    assert torch.autograd.gradcheck(fn, args)


def test_grouped_vmap_equals_grouped_map():
    """The groups vmapped (folded into the node's group dimension, the
    weights shared and their grads summed over the groups) against the
    groups one after another: y, the aux and x's grad bit-equal (each
    group's own); the weights' grads, sums of the groups' in another
    order, within n_groups ulps of the sum of the groups' |grads|."""
    p, x, r = _route_inputs(torch.float32, 29)
    kw = MOE_CASES["grouped-vmap"]
    y_v, aux_v, g_v = _layer(p, x, r, kw, 1.25)
    y_m, aux_m, g_m = _layer(p, x, r, MOE_CASES["grouped-map"], 1.25)
    assert torch.equal(y_v, y_m) and torch.equal(aux_v, aux_m)
    assert torch.equal(g_v["x"], g_m["x"])
    xg, rg = _groups(x, kw["group_size"]), _groups(r, kw["group_size"])
    n_g = xg.shape[0]
    mag = {n: torch.zeros_like(v) for n, v in p.items()}
    for xf, rf in zip(xg, rg):
        def loss(p):
            y, aux = TL._moe_group(p, xf, n_experts=ROUTE_E, top_k_=ROUTE_K,
                                   capacity_factor=1.25, act="swiglu")
            return (y * rf).sum() + aux / n_g
        for n, v in torch.func.grad(loss)(p).items():
            mag[n] += v.abs()
    for name in p:
        _within(g_v[name], g_m[name], n_g * 2.0 ** -23 * mag[name],
                f"{name} grad")


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_apply_never_calls_moe_dispatch(case, monkeypatch):
    """The dense dispatch is the yardstick only: ``moe_apply`` forward and
    backward, and a remat'd federated loss of reduced granite, run with
    ``layers.moe_dispatch`` raising."""
    def refuse(*a, **k):
        raise AssertionError("moe_dispatch called")
    monkeypatch.setattr(TL, "moe_dispatch", refuse)
    p, x, r = _route_inputs(torch.float32, 5)
    y, aux, grads = _layer(p, x, r, MOE_CASES[case], 1.25)
    assert bool(torch.isfinite(y).all()) and float(grads["x"].abs().sum())
    if case == "ungrouped":
        cfg = tget("granite-moe-1b-a400m").reduced().replace(
            dtype="float32", n_layers=2, scan_layers=True, remat=True)
        params, _ = TT.init(cfg, prng.PRNGKey(1), device="cpu")
        tb = Z.tbatch(Z.make_batch(cfg, 2, 16, 3))
        g = torch.func.grad(lambda q: TT.loss_fn(q, cfg, tb)[0])(params)
        assert all(bool(torch.isfinite(v).all()) for v in leaves(g))


@pytest.mark.parametrize("cf", [1.25, 0.1])
def test_route_tables_invert_each_other(cf):
    """slot = e C + pos for a kept route and -1 for a dropped one; owner
    is its inverse: the route g k + j for each held slot, -1 for the
    rest; leading dimensions are independent groups."""
    from repro_torch.kernels.moe_route import ops as mr_ops
    p, x, _ = _route_inputs(torch.float32, 9)
    xf = x.reshape(2, -1, ROUTE_D)
    _, idx, _, pos, keep, cap, _ = TL.moe_routes(
        xf, p["router"], n_experts=ROUTE_E, top_k_=ROUTE_K,
        capacity_factor=cf)
    slot, owner = mr_ops.route_tables(idx, pos, keep, cap, ROUTE_E)
    assert slot.dtype == owner.dtype == torch.int32
    assert owner.shape == (2, ROUTE_E * cap)
    routes = torch.arange(xf.shape[1] * ROUTE_K).reshape(-1, ROUTE_K)
    for n in range(2):
        want = torch.where(keep[n], idx[n] * cap + pos[n].long(), -1)
        assert torch.equal(slot[n].long(), want)
        held = owner[n] >= 0
        assert int(held.sum()) == int(keep[n].sum())
        assert torch.equal(owner[n][slot[n][keep[n]].long()].long(),
                           routes[keep[n]])
        one = mr_ops.route_tables(idx[n], pos[n], keep[n], cap, ROUTE_E)
        assert torch.equal(one[0], slot[n]) and torch.equal(one[1],
                                                            owner[n])
    assert bool((cf >= 1) or (~keep).any())


def test_moe_group_on_meta_takes_its_shapes():
    """On the meta device (the dry run) the node gives its shapes,
    forward and backward, under ``vmap``, and launches nothing."""
    from repro_torch.kernels.moe_route import kernel as mr_kernel
    before = mr_kernel.launches
    meta = torch.device("meta")
    E, D, F, G = 4, 16, 8, 12
    p = {"router": torch.empty((D, E), device=meta),
         "wi_gate": torch.empty((E, D, F), device=meta),
         "wi_up": torch.empty((E, D, F), device=meta),
         "wo": torch.empty((E, F, D), device=meta)}
    x = torch.empty((3, G, D), device=meta)

    def loss(p, x):
        y, aux = TL._moe_group(p, x, n_experts=E, top_k_=2,
                               capacity_factor=1.25, act="swiglu")
        return y.sum() + aux

    grads = torch.func.vmap(torch.func.grad(loss, (0, 1)),
                            in_dims=(None, 0))(p, x)
    assert grads[1].shape == x.shape
    assert {n: v.shape[1:] for n, v in grads[0].items()} == {
        n: v.shape for n, v in p.items()}
    assert mr_kernel.launches == before


def test_plain_version_sums_in_the_kernels_order():
    """``sum_rows`` adds a token's kept routes in ascending slot order
    from fp32 zero, and ``route_dots`` each lane's vectors in order then
    the 32 lanes by halves: values chosen so that another order rounds
    otherwise."""
    from repro_torch.kernels.moe_route import ref as mr_ref
    # slots 5, 2, 9 hold 1, 2**24, -2**24: ascending slot order gives
    # (0 + 2**24) + 1 - 2**24 = 0 (the 1 is lost), route order 1
    sl = torch.zeros((1, 10, 1))
    sl[0, 5, 0], sl[0, 2, 0], sl[0, 9, 0] = 1.0, 2.0 ** 24, -2.0 ** 24
    slot = torch.tensor([[[5, 2, 9]]], dtype=torch.int32)
    assert float(mr_ref.sum_rows(sl, slot, None)[0, 0, 0]) == 0.0
    # D = 4 x 64: lane c % 32 of the 64 float4 vectors
    D = 256
    a = torch.randn((1, 1, D), generator=torch.Generator().manual_seed(0))
    b = torch.randn((1, 1, D), generator=torch.Generator().manual_seed(1))
    lanes = [0.0] * 32
    for c in range(D // 4):
        for e in range(4):
            lanes[c % 32] = float(torch.tensor(lanes[c % 32])
                                  + a[0, 0, 4 * c + e] * b[0, 0, 4 * c + e])
    lanes = torch.tensor(lanes)
    while lanes.numel() > 1:
        lanes = lanes[:lanes.numel() // 2] + lanes[lanes.numel() // 2:]
    got = mr_ref.route_dots(a, b, torch.zeros((1, 1, 1), dtype=torch.int32))
    assert float(got[0, 0, 0]) == float(lanes[0])
