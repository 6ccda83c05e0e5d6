"""The slice as a whole: the port's per-round ``FederatedTrainer`` against
the JAX package's, on LeNet (K=12 clients, M=3, H=3, b=10, 5 rounds), with
the stateful and the keyed sampler, FedAvg and FedMom (fused flag on), a
heterogeneous-H_k case, and resumes from checkpoints written by the other
package.

Tolerance (fp32, CPU): per-round losses rtol 1e-4, final parameters
rtol 1e-4 / atol 1e-5 — the engines agree on every keyed draw bit for bit
and differ only in the summation order of the convolutions and the
client reduction.
"""
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import core as jcore  # noqa: E402
from repro.data import FederatedDataset as JDataset  # noqa: E402
from repro.data import synthetic_femnist  # noqa: E402
from repro.launch.plan import TrainSession  # noqa: E402
from repro.launch.train import FederatedTrainer as JTrainer  # noqa: E402
from repro.models import small as jsmall  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.data import FederatedDataset as TDataset  # noqa: E402
from repro_torch.interop import tree_from_numpy, tree_to_numpy  # noqa: E402
from repro_torch.launch.plan import (CkptSpec, ExecutionPlan,  # noqa: E402
                                     PlanError)
from repro_torch.launch.train import FederatedTrainer as TTrainer  # noqa: E402,E501
from repro_torch.models import small as tsmall  # noqa: E402

K, M, H, B, LR, ROUNDS = 12, 3, 3, 10, 0.05, 5
LOSS_RTOL = 1e-4
W_RTOL, W_ATOL = 1e-4, 1e-5

CONFIGS = {
    "fedavg-uniform": ("fedavg", {"eta": K / M}, "uniform", False),
    "fedmom-keyed": ("fedmom", {"eta": K / M, "beta": 0.9,
                                "use_fused_kernel": True}, "keyed", False),
    "fedmom-keyed-hetero": ("fedmom", {"eta": K / M, "beta": 0.9,
                                       "use_fused_kernel": True}, "keyed",
                            True),
}


def _hetero(t):
    return np.random.default_rng(1000 + t).integers(1, H + 1, size=M)


@pytest.fixture(scope="module")
def world():
    clients, _ = synthetic_femnist(n_clients=K, seed=0)
    w0 = jax.tree.map(np.asarray, jsmall.lenet_init(jax.random.PRNGKey(0)))
    return clients, w0


def _jax_trainer(world, cfg, session, opt, **kw):
    clients, w0 = world
    name, okw, sampler, hetero = CONFIGS[cfg]
    ds = JDataset(clients, seed=1)
    smp = (jcore.UniformSampler if sampler == "uniform"
           else jcore.DeviceUniformSampler)(ds.population(), M, seed=2)
    rcfg = jcore.RoundConfig(M, H, LR, compute_dtype="float32")
    return JTrainer(loss_fn=jsmall.lenet_loss, server_opt=opt, rcfg=rcfg,
                    dataset=ds, sampler=smp, state=opt.init(w0),
                    hetero_steps_fn=_hetero if hetero else None,
                    local_batch=B, session=session, **kw)


def _torch_trainer(world, cfg, **kw):
    clients, w0 = world
    name, okw, sampler, hetero = CONFIGS[cfg]
    opt = tcore.server_opt.get(name, **okw)
    ds = TDataset(clients, seed=1)
    smp = (tcore.UniformSampler if sampler == "uniform"
           else tcore.DeviceUniformSampler)(ds.population(), M, seed=2)
    rcfg = tcore.RoundConfig(M, H, LR, compute_dtype="float32")
    return TTrainer(loss_fn=tsmall.lenet_loss, server_opt=opt, rcfg=rcfg,
                    dataset=ds, sampler=smp,
                    state=opt.init(tree_from_numpy(w0, "cpu")),
                    hetero_steps_fn=_hetero if hetero else None,
                    local_batch=B, device="cpu", **kw)


@pytest.fixture(scope="module")
def jax_runs(world):
    """Uninterrupted JAX per-round runs, one per config (each with its own
    session and optimizer, reused by the resume tests so nothing
    recompiles)."""
    out = {}
    for cfg, (name, okw, _, _) in CONFIGS.items():
        session, opt = TrainSession(), jcore.server_opt.get(name, **okw)
        tr = _jax_trainer(world, cfg, session, opt)
        hist = tr.run(ROUNDS, plan="per_round", verbose=False)
        out[cfg] = (session, opt, hist, tr.state)
    return out


def _assert_same(t_hist, t_state, j_hist, j_state):
    assert [r["round"] for r in t_hist] == [r["round"] for r in j_hist]
    np.testing.assert_allclose([r["loss"] for r in t_hist],
                               [r["loss"] for r in j_hist], rtol=LOSS_RTOL)
    np.testing.assert_allclose([r["delta_norm"] for r in t_hist],
                               [r["delta_norm"] for r in j_hist], rtol=1e-3)
    got = tree_to_numpy(t_state.w)
    for k, v in j_state.w.items():
        np.testing.assert_allclose(got[k], np.asarray(v), rtol=W_RTOL,
                                   atol=W_ATOL, err_msg=k)
    assert t_state.t == int(j_state.t) == ROUNDS


@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_per_round_trajectory_matches_jax(world, jax_runs, cfg):
    tr = _torch_trainer(world, cfg)
    hist = tr.run(ROUNDS, plan="per_round", verbose=False)
    _, _, j_hist, j_state = jax_runs[cfg]
    _assert_same(hist, tr.state, j_hist, j_state)


def test_diurnal_padded_cohort_matches_jax(world):
    """Time-varying M(t) through the padded-C convention: m_max slots, the
    tail past M(t) at zero weight."""
    clients, w0 = world
    m_max, n = 4, 4
    jds, tds = JDataset(clients, seed=1), TDataset(clients, seed=1)
    jopt = jcore.fedmom(eta=2.0, beta=0.9)
    topt = tcore.fedmom(eta=2.0, beta=0.9, use_fused_kernel=True)
    jtr = JTrainer(loss_fn=jsmall.lenet_loss, server_opt=jopt,
                   rcfg=jcore.RoundConfig(m_max, H, LR,
                                          compute_dtype="float32"),
                   dataset=jds, sampler=jcore.DeviceDiurnalSampler(
                       jds.population(), 2, m_max, period=3, seed=5),
                   state=jopt.init(w0), local_batch=B)
    ttr = TTrainer(loss_fn=tsmall.lenet_loss, server_opt=topt,
                   rcfg=tcore.RoundConfig(m_max, H, LR,
                                          compute_dtype="float32"),
                   dataset=tds, sampler=tcore.DeviceDiurnalSampler(
                       tds.population(), 2, m_max, period=3, seed=5),
                   state=topt.init(tree_from_numpy(w0, "cpu")),
                   local_batch=B, device="cpu")
    j_hist = jtr.run(n, plan="per_round", verbose=False)
    t_hist = ttr.run(n, verbose=False)
    np.testing.assert_allclose([r["loss"] for r in t_hist],
                               [r["loss"] for r in j_hist], rtol=LOSS_RTOL)
    got = tree_to_numpy(ttr.state.w)
    for k, v in jtr.state.w.items():
        np.testing.assert_allclose(got[k], np.asarray(v), rtol=W_RTOL,
                                   atol=W_ATOL, err_msg=k)


def test_torch_resumes_from_jax_checkpoint(world, jax_runs, tmp_path):
    cfg = "fedmom-keyed"
    session, opt, j_hist, j_state = jax_runs[cfg]
    ck = str(tmp_path / "jax.npz")
    first = _jax_trainer(world, cfg, session, opt, ckpt_path=ck,
                         ckpt_every=1)
    h1 = first.run(3, plan="per_round", verbose=False)
    second = _torch_trainer(world, cfg, ckpt_path=ck, ckpt_every=1)
    h2 = second.run(ROUNDS, verbose=False, resume=True)
    assert [r["round"] for r in h2] == [3, 4]
    _assert_same(list(h1) + list(h2), second.state, j_hist, j_state)


def test_jax_resumes_from_torch_checkpoint(world, jax_runs, tmp_path):
    cfg = "fedmom-keyed-hetero"
    session, opt, j_hist, j_state = jax_runs[cfg]
    ck = str(tmp_path / "torch.npz")
    metrics = str(tmp_path / "m.jsonl")
    first = _torch_trainer(world, cfg, ckpt_path=ck, ckpt_every=1,
                           metrics_path=metrics)
    h1 = first.run(3, verbose=False)
    second = _jax_trainer(world, cfg, session, opt, ckpt_path=ck,
                          ckpt_every=1)
    h2 = second.run(ROUNDS, plan="per_round", verbose=False, resume=True)
    assert [r["round"] for r in h2] == [3, 4]
    np.testing.assert_allclose([r["loss"] for r in list(h1) + list(h2)],
                               [r["loss"] for r in j_hist], rtol=LOSS_RTOL)
    for k, v in j_state.w.items():
        np.testing.assert_allclose(np.asarray(second.state.w[k]),
                                   np.asarray(v), rtol=W_RTOL, atol=W_ATOL,
                                   err_msg=k)
    assert int(second.state.t) == ROUNDS
    with open(metrics) as f:
        assert [json.loads(ln)["round"] for ln in f] == [0, 1, 2]


def test_resume_rewinds_metrics_and_needs_keyed_sampler(world, tmp_path):
    ck, metrics = str(tmp_path / "ck.npz"), str(tmp_path / "m.jsonl")
    tr = _torch_trainer(world, "fedmom-keyed", ckpt_path=ck, ckpt_every=2,
                        metrics_path=metrics)
    tr.run(4, verbose=False)             # checkpoints at round 2 only
    again = _torch_trainer(world, "fedmom-keyed", ckpt_path=ck,
                           metrics_path=metrics)
    hist = again.run(4, verbose=False, resume=True)
    assert [r["round"] for r in hist] == [3]
    with open(metrics) as f:
        assert [json.loads(ln)["round"] for ln in f] == [0, 1, 2, 3]
    with pytest.raises(PlanError, match="KeyedReplayable"):
        _torch_trainer(world, "fedavg-uniform", ckpt_path=ck).run(
            4, verbose=False, resume=True)


def test_eval_cadence_and_plan_overrides(world, tmp_path):
    tr = _torch_trainer(world, "fedavg-uniform")
    seen = []

    def eval_fn(state):
        seen.append(state.t)
        return {"eval_t": state.t}

    ck = str(tmp_path / "plan.npz")
    plan = ExecutionPlan(plane="per_round", local_batch=4,
                         ckpt=CkptSpec(every=2, path=ck))
    hist = tr.run(5, plan=plan, log_every=2, eval_fn=eval_fn, verbose=False)
    assert seen == [1, 3, 5]             # rounds 0, 2 and the last
    assert [r.get("eval_t") for r in hist] == [1, None, 3, None, 5]
    assert tr.local_batch == B and tr.ckpt_path is None
    from repro_torch.checkpoint import latest_round
    assert latest_round(ck) == 4


@pytest.mark.parametrize("plan", ["scanned", "device", "auto"])
def test_ported_planes_run(world, plan):
    """Each chunked plane trains LeNet and logs its decision, an auto one
    (the stateful sampler has a keyed draw, the corpus fits the CPU's
    unbounded budget: the device plane) into the history too."""
    tr = _torch_trainer(world, "fedavg-uniform")
    hist = tr.run(2, plan=ExecutionPlan(plane=plan, chunk_rounds=2),
                  verbose=False)
    rec = tr.session.plan_log[-1]
    assert rec["plane"] == ("device" if plan == "auto" else plan)
    assert rec["auto"] == (plan == "auto") and rec["chunk_rounds"] == 2
    events = [r for r in hist if "event" in r]
    assert events == ([rec] if plan == "auto" else [])
    losses = [r["loss"] for r in hist if "event" not in r]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert tr.state.t == 2


def test_streaming_plane_trains_the_per_round_trajectory(world, jax_runs):
    """LeNet on the streaming plane: the shard cache feeds round_step the
    rows the per-round plane gathers on the host, so the two planes are
    bit-equal, and both match the reference's per-round run."""
    cfg = "fedmom-keyed-hetero"
    ref = _torch_trainer(world, cfg)
    ref_hist = ref.run(ROUNDS, plan="per_round", verbose=False)
    tr = _torch_trainer(world, cfg)
    hist = tr.run(ROUNDS, plan=ExecutionPlan(plane="streaming",
                                             chunk_rounds=2),
                  verbose=False)
    assert [r["loss"] for r in hist] == [r["loss"] for r in ref_hist]
    for k in ref.state.w:
        assert torch.equal(tr.state.w[k], ref.state.w[k]), k
    _, _, j_hist, j_state = jax_runs[cfg]
    _assert_same(hist, tr.state, j_hist, j_state)
    assert tr.session.plan_log[-1]["plane"] == "streaming"


@pytest.mark.parametrize("plane", ["scanned", "device"])
def test_chunked_planes_train_the_per_round_trajectory(world, jax_runs,
                                                       plane):
    """LeNet on the scanned and device planes: the same round_step on the
    same rows as the per-round plane (host-staged, or gathered from the
    packed corpus), so the planes are bit-equal, and both match the
    reference's per-round run."""
    cfg = "fedmom-keyed-hetero"
    ref = _torch_trainer(world, cfg)
    ref_hist = ref.run(ROUNDS, plan="per_round", verbose=False)
    tr = _torch_trainer(world, cfg)
    hist = tr.run(ROUNDS, plan=ExecutionPlan(plane=plane, chunk_rounds=2),
                  verbose=False)
    assert [r["loss"] for r in hist] == [r["loss"] for r in ref_hist]
    for k in ref.state.w:
        assert torch.equal(tr.state.w[k], ref.state.w[k]), k
    _, _, j_hist, j_state = jax_runs[cfg]
    _assert_same(hist, tr.state, j_hist, j_state)
    assert tr.session.plan_log[-1]["plane"] == plane


@pytest.mark.parametrize("field", ["secure", "mesh"])
def test_unported_plan_fields_raise_plan_error(field):
    """``secure`` and ``mesh`` belong to layers not yet ported: they raise
    a ``PlanError`` naming the nearest plane that runs."""
    with pytest.raises(PlanError, match="not yet ported") as err:
        ExecutionPlan(plane="per_round", **{field: object()})
    assert err.value.nearest == "per_round"
    with pytest.raises(PlanError) as err:
        ExecutionPlan(plane="streaming", **{field: object()})
    assert err.value.nearest == "streaming"


@pytest.mark.parametrize("field,value", [
    ("chunk_rounds", "auto"), ("memory_budget_bytes", 1 << 20),
    ("scenario", None)],
    ids=["chunk_rounds", "memory_budget_bytes", "scenario"])
def test_ported_plan_fields_are_accepted(field, value):
    """``chunk_rounds="auto"``, ``memory_budget_bytes`` and ``scenario``
    are accepted on every plane, and a value of the wrong kind is refused
    with the reference's message: a budget that is not a positive int, a
    scenario that is not a ``ScenarioSpec``."""
    if field == "scenario":
        from repro.launch.plan import ExecutionPlan as JPlan
        from repro.launch.plan import PlanError as JPlanError
        from repro_torch.scenario import ScenarioSpec, UniformDropout
        value = ScenarioSpec(dropout=UniformDropout(0.2), seed=3)
        msgs = []
        for plan_cls, err_cls in ((JPlan, JPlanError),
                                  (ExecutionPlan, PlanError)):
            with pytest.raises(err_cls) as err:
                plan_cls(plane="per_round", scenario=object())
            msgs.append(str(err.value).replace("repro_torch.", "repro."))
            assert err.value.plane == "per_round"
        assert msgs[0] == msgs[1] == (
            "scenario must be a repro.scenario.ScenarioSpec, got object")
    planes = (("per_round", "scanned", "device", "streaming", "auto")
              if field == "scenario" else ("per_round", "streaming", "auto"))
    for plane in planes:
        assert getattr(ExecutionPlan(plane=plane, **{field: value}),
                       field) == value
    if field == "memory_budget_bytes":
        with pytest.raises(PlanError, match="positive int"):
            ExecutionPlan(memory_budget_bytes=0)


@pytest.mark.parametrize("kw,nearest", [
    ({"chunk_rounds": 0}, None), ({"chunk_rounds": 2.5}, None),
    ({"prefetch": -1}, None), ({"cache": {"tiers": 0}}, None),
    ({"cache": {"bytes": -5}}, None), ({"cache": {"bucketed": 1}}, None),
    ({"cache": {"bucketed": True}}, "streaming"), ({"local_batch": 0}, None),
], ids=["chunk_rounds=0", "chunk_rounds=2.5", "prefetch=-1",
        "cache.tiers=0", "cache.bytes<0", "cache.bucketed=1",
        "bucketed-on-per_round", "local_batch=0"])
def test_plan_validation_matches_reference(kw, nearest):
    """The reference's checks with its messages, and the same ``nearest``."""
    from repro.launch.plan import CacheSpec as JCache
    from repro.launch.plan import ExecutionPlan as JPlan
    from repro.launch.plan import PlanError as JPlanError
    from repro_torch.launch.plan import CacheSpec
    errs = []
    for plan_cls, cache_cls, err_cls in ((JPlan, JCache, JPlanError),
                                         (ExecutionPlan, CacheSpec,
                                          PlanError)):
        args = {k: cache_cls(**v) if k == "cache" else v
                for k, v in kw.items()}
        with pytest.raises(err_cls) as err:
            plan_cls(plane="per_round", **args)
        errs.append(err.value)
    assert str(errs[1]) == str(errs[0])
    assert errs[1].nearest == errs[0].nearest == nearest


def test_streaming_plan_defaults_are_the_reference_defaults():
    from repro.launch.plan import ExecutionPlan as JPlan
    got, want = ExecutionPlan(plane="streaming"), JPlan(plane="streaming")
    assert (got.chunk_rounds, got.prefetch) == (want.chunk_rounds,
                                                want.prefetch) == (25, 2)
    assert vars(got.cache) == vars(want.cache)


@pytest.mark.parametrize("field", ["param_axes"])
def test_unported_trainer_fields_raise_plan_error(world, field):
    with pytest.raises(PlanError, match=field):
        _torch_trainer(world, "fedavg-uniform", **{field: object()})


def test_trainer_needs_a_card_unless_told_cpu(world, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    clients, w0 = world
    opt = tcore.fedavg()
    ds = TDataset(clients, seed=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TTrainer(loss_fn=tsmall.lenet_loss, server_opt=opt,
                 rcfg=tcore.RoundConfig(M, H, LR), dataset=ds,
                 sampler=tcore.UniformSampler(ds.population(), M),
                 state=opt.init(tree_from_numpy(w0, "cpu")))


def test_client_extent_mismatch_raises(world):
    tr = _torch_trainer(world, "fedavg-uniform")
    tr.sampler = tcore.UniformSampler(tr.dataset.population(), M + 1)
    with pytest.raises(ValueError, match="client slots"):
        tr.run(1, verbose=False)
