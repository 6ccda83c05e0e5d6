"""The port's round engine against the JAX package's ``round_step``.

Same inputs (numpy-seeded params, [C, H, b, ...] batches, weights and step
masks) through both engines: both placements, every local optimizer, with
and without heterogeneous step masks.  fp32 tolerance rtol 1e-4 / atol
1e-6 on the new server state (the reduction over clients and the products
inside each local step run in other orders).  bf16 compute is checked only
loosely (atol 5e-2): the two frameworks round bf16 at other places.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import round as jround  # noqa: E402
from repro.core import server_opt as jso  # noqa: E402
from repro.core.client import local_update as jlocal_update  # noqa: E402
from repro.models import small as jsmall  # noqa: E402
from repro_torch.core import round as tround  # noqa: E402
from repro_torch.core import server_opt as tso  # noqa: E402
from repro_torch.core.client import local_update as tlocal_update  # noqa: E402,E501
from repro_torch.interop import tree_from_numpy, tree_to_numpy  # noqa: E402
from repro_torch.launch.plan import PlanError  # noqa: E402
from repro_torch.models import small as tsmall  # noqa: E402

RTOL, ATOL = 1e-4, 1e-6


def jlinreg(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    return jnp.mean(jnp.square(pred - batch["y"])), {}


def tlinreg(params, batch):
    w = params["w"]
    pred = batch["x"] @ w.to(batch["x"].dtype) + params["b"]
    return torch.mean(torch.square(pred - batch["y"])), {}


def _setup(seed=0, C=4, H=3, b=5, d=6):
    rng = np.random.default_rng(seed)
    params = {"w": rng.normal(size=(d,)).astype(np.float32),
              "b": np.zeros((), np.float32)}
    batches = {"x": rng.normal(size=(C, H, b, d)).astype(np.float32),
               "y": rng.normal(size=(C, H, b)).astype(np.float32)}
    weights = rng.uniform(0.05, 0.3, size=C).astype(np.float32)
    return params, batches, weights


def _mask(C, H, h_k):
    return (np.arange(H)[None, :] < np.asarray(h_k)[:, None]).astype(
        np.float32)


def _run_both(opt_name, rcfg_kw, params, batches, weights, mask=None,
              jloss=jlinreg, tloss=tlinreg, opt_kw=None):
    opt_kw = opt_kw or {}
    jopt, topt = jso.get(opt_name, **opt_kw), tso.get(opt_name, **opt_kw)
    jrc = jround.RoundConfig(**rcfg_kw)
    trc = tround.RoundConfig(**rcfg_kw)
    js, jm = jax.jit(lambda s, b, w, m: jround.round_step(
        jloss, jopt, s, b, w, jrc, step_mask=m))(
        jopt.init(jax.tree.map(jnp.asarray, params)),
        jax.tree.map(jnp.asarray, batches), jnp.asarray(weights),
        None if mask is None else jnp.asarray(mask))
    ts, tm = tround.round_step(tloss, topt,
                               topt.init(tree_from_numpy(params, "cpu")),
                               batches, weights, trc, step_mask=mask,
                               device="cpu")
    return (js, jm), (ts, tm)


def _assert_state_close(ts, js, rtol=RTOL, atol=ATOL):
    got = tree_to_numpy(ts.w)
    for k, v in js.w.items():
        np.testing.assert_allclose(got[k], np.asarray(v), rtol=rtol,
                                   atol=atol, err_msg=k)
    assert ts.t == int(js.t)


def _assert_metrics_close(tm, jm, atol=1e-5):
    for k in ("loss", "delta_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   atol=atol, err_msg=k)
    np.testing.assert_allclose(tm["losses"].numpy(), np.asarray(jm["losses"]),
                               rtol=1e-4, atol=atol)
    assert int(tm["completed"]) == int(jm["completed"])
    assert tm["round"] == int(jm["round"])


@pytest.mark.parametrize("placement", ["mesh", "scan"])
@pytest.mark.parametrize("local_opt", ["sgd", "momentum", "adam"])
@pytest.mark.parametrize("opt_name", ["fedavg", "fedmom"])
def test_round_matches_reference(placement, local_opt, opt_name):
    params, batches, weights = _setup()
    rc = dict(clients_per_round=4, local_steps=3, lr=0.1,
              placement=placement, local_opt=local_opt,
              compute_dtype="float32")
    (js, jm), (ts, tm) = _run_both(opt_name, rc, params, batches, weights)
    _assert_state_close(ts, js)
    _assert_metrics_close(tm, jm)


@pytest.mark.parametrize("placement", ["mesh", "scan"])
@pytest.mark.parametrize("local_opt", ["sgd", "adam"])
def test_masked_round_matches_reference(placement, local_opt):
    """Heterogeneous H_k, including a client with zero work: masked steps
    freeze params and optimizer state, metrics reweight over workers."""
    params, batches, weights = _setup(seed=4)
    mask = _mask(4, 3, [3, 1, 0, 2])
    rc = dict(clients_per_round=4, local_steps=3, lr=0.1,
              placement=placement, local_opt=local_opt,
              compute_dtype="float32")
    (js, jm), (ts, tm) = _run_both("fedmom", rc, params, batches, weights,
                                   mask=mask)
    _assert_state_close(ts, js)
    _assert_metrics_close(tm, jm)
    assert int(tm["completed"]) == 3


def test_placements_agree():
    params, batches, weights = _setup(seed=2)
    out = {}
    for placement in ("mesh", "scan"):
        rc = tround.RoundConfig(4, 3, 0.1, placement=placement,
                                compute_dtype="float32")
        opt = tso.fedmom()
        out[placement] = tround.round_step(
            tlinreg, opt, opt.init(tree_from_numpy(params, "cpu")), batches,
            weights, rc, step_mask=_mask(4, 3, [1, 2, 3, 0]), device="cpu")
    for k in params:
        torch.testing.assert_close(out["mesh"][0].w[k], out["scan"][0].w[k],
                                   rtol=1e-5, atol=1e-6)


def test_lenet_round_matches_reference():
    rng = np.random.default_rng(5)
    params = jax.tree.map(np.asarray,
                          jsmall.lenet_init(jax.random.PRNGKey(1)))
    batches = {"x": rng.normal(size=(2, 2, 4, 28, 28, 1)).astype(np.float32),
               "y": rng.integers(0, 62, size=(2, 2, 4)).astype(np.int32)}
    weights = np.array([0.3, 0.5], np.float32)
    rc = dict(clients_per_round=2, local_steps=2, lr=0.05,
              compute_dtype="float32")
    (js, jm), (ts, tm) = _run_both(
        "fedmom", rc, params, batches, weights, jloss=jsmall.lenet_loss,
        tloss=tsmall.lenet_loss, opt_kw={"eta": 3.0,
                                         "use_fused_kernel": True})
    _assert_state_close(ts, js, atol=1e-5)
    _assert_metrics_close(tm, jm)


def test_eq2_model_averaging_equals_eq3_round_partial_hetero():
    """eq. (2) model averaging == the eq. (3) biased-gradient round under
    partial participation (sum n_k/n < 1) and heterogeneous H_k."""
    params, batches, _ = _setup(seed=7)
    C, H = 4, 3
    weights = np.array([0.15, 0.25, 0.05, 0.2], np.float32)
    h_k = [3, 1, 0, 2]
    rc = tround.RoundConfig(C, H, 0.1, placement="mesh",
                            compute_dtype="float32")
    opt = tso.fedavg(eta=1.0)
    tp = tree_from_numpy(params, "cpu")
    state, _ = tround.round_step(tlinreg, opt, opt.init(tp), batches,
                                 weights, rc, step_mask=_mask(C, H, h_k),
                                 device="cpu")
    lr = torch.tensor(0.1)
    locals_ = []
    for c in range(C):
        if h_k[c] == 0:
            locals_.append(tp)
            continue
        bc = {k: torch.as_tensor(v[c, :h_k[c]]) for k, v in batches.items()}
        locals_.append(tlocal_update(tlinreg, tp, bc, lr)[0])
    stacked = {k: torch.stack([m[k] for m in locals_]) for k in tp}
    eq2 = tround.model_averaging_reference(tp, stacked, weights)
    for k in tp:
        torch.testing.assert_close(state.w[k], eq2[k], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("local_opt", ["sgd", "momentum", "adam"])
def test_local_update_matches_reference(local_opt):
    params, batches, _ = _setup(seed=9)
    b0 = {k: v[0] for k, v in batches.items()}
    from repro.optim import local as jlo
    from repro_torch.optim import local as tlo
    mask = np.array([1, 0, 1], np.float32)
    for m in (None, mask):
        jp, jl = jlocal_update(jlinreg, jax.tree.map(jnp.asarray, params),
                               jax.tree.map(jnp.asarray, b0),
                               jnp.float32(0.1), jlo.get(local_opt),
                               step_mask=None if m is None
                               else jnp.asarray(m))
        tp, tl = tlocal_update(tlinreg, tree_from_numpy(params, "cpu"),
                               tree_from_numpy(b0, "cpu"), torch.tensor(0.1),
                               tlo.get(local_opt),
                               step_mask=None if m is None
                               else torch.as_tensor(m))
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)


def test_local_gradient_matches_reference():
    from repro.core.client import local_gradient as jlocal_gradient
    from repro_torch.core.client import local_gradient as tlocal_gradient
    params, batches, _ = _setup(seed=11)
    b = {k: v[0, 0] for k, v in batches.items()}
    jg, jl = jlocal_gradient(jlinreg, jax.tree.map(jnp.asarray, params),
                             jax.tree.map(jnp.asarray, b))
    tg, tl = tlocal_gradient(tlinreg, tree_from_numpy(params, "cpu"),
                             tree_from_numpy(b, "cpu"))
    for k in params:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)


def test_dynamic_lr_overrides_static():
    params, batches, weights = _setup(seed=5)
    opt = tso.fedavg()
    tp = tree_from_numpy(params, "cpu")
    s1, _ = tround.round_step(tlinreg, opt, opt.init(tp), batches, weights,
                              tround.RoundConfig(4, 3, 0.1,
                                                 compute_dtype="float32"),
                              device="cpu")
    s2, _ = tround.round_step(tlinreg, opt, opt.init(tp), batches, weights,
                              tround.RoundConfig(4, 3, 0.777,
                                                 compute_dtype="float32"),
                              lr=0.1, device="cpu")
    for k in params:
        assert torch.equal(s1.w[k], s2.w[k])


@pytest.mark.parametrize("placement", ["mesh", "scan"])
def test_bf16_delta_is_rounded_fp32_reduction(placement):
    """delta_dtype='bfloat16' rounds the fp32 reduction once (recovered
    through fedavg with eta=1)."""
    params, batches, _ = _setup(seed=7)
    weights = np.array([0.9, 0.0731, 0.0211, 0.0058], np.float32)
    opt = tso.fedavg(eta=1.0)
    tp = tree_from_numpy(params, "cpu")
    deltas = {}
    for ddt in ("float32", "bfloat16"):
        rc = tround.RoundConfig(4, 3, 0.1, placement=placement,
                                compute_dtype="float32", delta_dtype=ddt)
        s, _ = tround.round_step(tlinreg, opt, opt.init(tp), batches,
                                 weights, rc, device="cpu")
        deltas[ddt] = {k: tp[k] - s.w[k] for k in tp}
    for k in tp:
        assert torch.equal(deltas["bfloat16"][k],
                           deltas["float32"][k].to(torch.bfloat16).float())


def test_bf16_compute_loosely_matches_reference():
    params, batches, weights = _setup(seed=3)
    rc = dict(clients_per_round=4, local_steps=3, lr=0.1)   # bf16 default
    assert tround.RoundConfig(4, 3, 0.1).compute_dtype == "bfloat16"
    (js, jm), (ts, tm) = _run_both("fedavg", rc, params, batches, weights)
    _assert_state_close(ts, js, rtol=0, atol=5e-2)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=5e-2)


def test_unported_round_features_raise_plan_error():
    """``secure`` and ``param_axes`` are ported: a ``SecureAggSpec`` is
    accepted, and a round with ``param_axes`` (identities outside a mesh)
    is bit-equal to one without; the mesh, the one layer still to port,
    raises ``PlanError``."""
    from repro_torch.core import SecureAggSpec
    from repro_torch.launch.plan import ExecutionPlan
    spec = SecureAggSpec(masked=True, seed=1)
    assert tround.RoundConfig(2, 1, 0.1, secure=spec).secure == spec
    params, batches, weights = _setup()
    opt = tso.fedavg()
    runs = [tround.round_step(tlinreg, opt,
                              opt.init(tree_from_numpy(params, "cpu")),
                              batches, weights, tround.RoundConfig(4, 3, 0.1),
                              param_axes=axes, device="cpu")[0]
            for axes in ({"w": ("embed",), "b": ()}, None)]
    for a, b in zip(tree_to_numpy(runs[0].w).values(),
                    tree_to_numpy(runs[1].w).values()):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(PlanError, match="mesh"):
        ExecutionPlan(mesh=object())


def _tiers(seed, sizes=(3, 1, 2), H=3, b=5, d=6, masked=False):
    """A cohort split into size tiers: per tier [C_i, H, b, ...] batches,
    [C_i] weights (the last client of the first tier a weight-0 pad) and
    optional [C_i, H] masks, one of them fully masked."""
    rng = np.random.default_rng(seed)
    data, ws, ms = [], [], []
    for c_i in sizes:
        data.append({"x": rng.normal(size=(c_i, H, b, d)).astype(np.float32),
                     "y": rng.normal(size=(c_i, H, b)).astype(np.float32)})
        ws.append(rng.uniform(0.05, 0.3, size=c_i).astype(np.float32))
        ms.append(_mask(c_i, H, rng.integers(0, H + 1, size=c_i)))
    ws[0][-1] = 0.0
    ms[1][:] = 0.0
    return tuple(data), tuple(ws), tuple(ms) if masked else None


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("opt_name", ["fedavg", "fedmom"])
def test_bucketed_round_matches_reference(opt_name, masked):
    """Per-tier vmaps with one fp32 accumulator against the reference's
    ``bucketed_round_step`` (three tiers, a weight-0 pad, a fully masked
    tier)."""
    params = _setup(seed=8)[0]
    data, ws, ms = _tiers(3, masked=masked)
    rc = dict(clients_per_round=6, local_steps=3, lr=0.1,
              compute_dtype="float32")
    jopt, topt = jso.get(opt_name), tso.get(opt_name)
    js, jm = jround.bucketed_round_step(
        jlinreg, jopt, jopt.init(jax.tree.map(jnp.asarray, params)),
        jax.tree.map(jnp.asarray, data), jax.tree.map(jnp.asarray, ws),
        jround.RoundConfig(**rc), lr=jnp.float32(0.1),
        tier_masks=None if ms is None else jax.tree.map(jnp.asarray, ms))
    ts, tm = tround.bucketed_round_step(
        tlinreg, topt, topt.init(tree_from_numpy(params, "cpu")), data, ws,
        tround.RoundConfig(**rc), lr=0.1, tier_masks=ms, device="cpu")
    _assert_state_close(ts, js)
    for k in ("loss", "delta_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-6)
    assert int(tm["completed"]) == int(jm["completed"])
    assert tm["round"] == int(jm["round"]) and "losses" not in tm


def test_bucketed_round_one_tier_bit_equal_to_round_step():
    params, batches, weights = _setup(seed=6)
    mask = _mask(4, 3, [3, 0, 1, 2])
    rc = tround.RoundConfig(4, 3, 0.1, compute_dtype="float32")
    opt = tso.fedmom()
    tp = tree_from_numpy(params, "cpu")
    s1, m1 = tround.round_step(tlinreg, opt, opt.init(tp), batches, weights,
                               rc, step_mask=mask, device="cpu")
    s2, m2 = tround.bucketed_round_step(tlinreg, opt, opt.init(tp),
                                        (batches,), (weights,), rc,
                                        tier_masks=(mask,), device="cpu")
    for k in params:
        assert torch.equal(s1.w[k], s2.w[k])
    for k in ("loss", "delta_norm", "completed"):
        assert torch.equal(m1[k], m2[k]), k


def test_bucketed_round_hook_replaces_the_per_tier_vmap():
    """``tier_update_fn`` gets (w_c, tier, payload, mask) and its
    (final params, losses) are aggregated like the vmap's own."""
    params = _setup(seed=8)[0]
    data, ws, ms = _tiers(5, masked=True)
    rc = tround.RoundConfig(6, 3, 0.1, compute_dtype="float32")
    opt = tso.fedavg()
    tp = tree_from_numpy(params, "cpu")
    seen = []

    def hook(w_c, i, payload, mask):
        seen.append((i, payload))
        b = tree_from_numpy(data[i], "cpu")
        return torch.func.vmap(lambda bb, m: tlocal_update(
            tlinreg, w_c, bb, torch.tensor(0.1), step_mask=m))(b, mask)

    s1, m1 = tround.bucketed_round_step(tlinreg, opt, opt.init(tp),
                                        ("a", "b", "c"), ws, rc,
                                        tier_masks=ms, tier_update_fn=hook,
                                        device="cpu")
    s2, m2 = tround.bucketed_round_step(tlinreg, opt, opt.init(tp), data, ws,
                                        rc, tier_masks=ms, device="cpu")
    assert seen == [(0, "a"), (1, "b"), (2, "c")]
    for k in params:
        assert torch.equal(s1.w[k], s2.w[k])
    assert torch.equal(m1["loss"], m2["loss"])
    with pytest.raises(ValueError, match="placement='mesh'"):
        tround.bucketed_round_step(
            tlinreg, opt, opt.init(tp), data, ws,
            tround.RoundConfig(6, 3, 0.1, placement="scan"), device="cpu")


def test_round_runs_on_cuda_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params, batches, weights = _setup()
    opt = tso.fedavg()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tround.round_step(tlinreg, opt,
                          opt.init(tree_from_numpy(params, "cpu")), batches,
                          weights, tround.RoundConfig(4, 3, 0.1))
