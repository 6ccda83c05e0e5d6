"""The port's scenario engine (``repro_torch.scenario``) against the JAX
package's, on the CPU.

Bit-equal (no tolerance): the keyed hashes, uniforms and normals;
``zipf_counts`` and ``ZipfLinregProvider``'s shards; every lifecycle
model's caps; every availability model's cutoffs; ``ScenarioRuntime``'s
caps, masks, ``last_m`` and adaptive-cohort EMA, through ``warmup`` too;
``ScenarioSampler``'s host replay and keyed draw; the ``completed`` counts
of every plane and lane.  Trajectories under ``UniformDropout`` +
``LatencyStragglers``: LeNet on the per-round plane against the
reference's (losses rtol 1e-4, final parameters rtol 1e-4 / atol 1e-5, as
``tests/test_torch_trainer.py``), and the linreg fleet on the padded,
bucketed and hook lanes against the reference's streaming runs (the same
tolerance, ``tests/_trajectory_torch.py``).  Within the port: every plane
bit-equal to the per-round plane, a resume bit-equal to an uninterrupted
run, a null scenario bit-equal to none, and the device plane's gate.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from _trajectory import make_clients, run_trajectory  # noqa: E402
from _trajectory import default_rcfg as jax_rcfg  # noqa: E402
from _trajectory_torch import (assert_matches_jax, make_trainer, opts,  # noqa: E402,E501
                               rcfg, run_torch, strip_events, torch_flat_w)
from repro import core as jcore  # noqa: E402
from repro import scenario as jscen  # noqa: E402
from repro.data import FederatedDataset as JDataset  # noqa: E402
from repro.data import synthetic_femnist  # noqa: E402
from repro.kernels.client_step.ops import \
    linreg_tier_step as jax_hook  # noqa: E402
from repro.launch.plan import ExecutionPlan as JPlan  # noqa: E402
from repro.launch.train import FederatedTrainer as JTrainer  # noqa: E402
from repro.models import small as jsmall  # noqa: E402
from repro.scenario import lifecycle as jlife  # noqa: E402
from repro.scenario.spec import ScenarioRuntime as JRuntime  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch import scenario as tscen  # noqa: E402
from repro_torch.core import UniformSampler  # noqa: E402
from repro_torch.data import FederatedDataset as TDataset  # noqa: E402
from repro_torch.interop import tree_from_numpy, tree_to_numpy  # noqa: E402
from repro_torch.kernels.client_step.ops import linreg_tier_step  # noqa: E402
from repro_torch.launch.plan import ExecutionPlan, PlanError  # noqa: E402
from repro_torch.launch.train import FederatedTrainer  # noqa: E402
from repro_torch.models import small as tsmall  # noqa: E402
from repro_torch.scenario import lifecycle as tlife  # noqa: E402
from repro_torch.scenario.spec import ScenarioRuntime  # noqa: E402

LOSS_RTOL, W_RTOL, W_ATOL = 1e-4, 1e-4, 1e-5


def _spec(pkg, rate=0.35, deadline=5.0, seed=7, **kw):
    """UniformDropout + LatencyStragglers of one package."""
    return pkg.ScenarioSpec(dropout=pkg.UniformDropout(rate=rate),
                            stragglers=pkg.LatencyStragglers(
                                deadline_s=deadline),
                            seed=seed, **kw)


# ---------------------------------------------------------------------------
# keyed draws, models, runtime: bit-equal to the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,tag,t", [(0, "drop", 0), (17, "lat/jit", 59),
                                        (2**31 + 5, "zipf/n_k", 10**6),
                                        (-3, "", 7)])
def test_keyed_draws_bit_equal(seed, tag, t):
    cids = np.random.default_rng(seed & 0xFFFF).integers(0, 2**40, size=257)
    assert tlife._fnv1a(tag) == jlife._fnv1a(tag)
    for name in ("keyed_u64", "keyed_uniforms", "keyed_normals"):
        a = getattr(tlife, name)(seed, tag, t, cids)
        b = getattr(jlife, name)(seed, tag, t, cids)
        assert a.dtype == b.dtype and np.array_equal(a, b), name


@pytest.mark.parametrize("kw", [
    {"n_clients": 1000}, {"n_clients": 5000, "alpha": 1.1, "n_min": 4,
                          "n_max": 64, "seed": 9}])
def test_zipf_counts_and_provider_bit_equal(kw):
    assert np.array_equal(tscen.zipf_counts(**kw), jscen.zipf_counts(**kw))
    n = kw.pop("n_clients")
    tp = tscen.zipf_linreg_provider(n, dim=16, **kw)
    jp = jscen.zipf_linreg_provider(n, dim=16, **kw)
    assert np.array_equal(tp.counts, jp.counts) and tp.fields == jp.fields
    for cid in (0, 1, n // 2, n - 1):
        a, b = tp.shard(cid), jp.shard(cid)
        assert all(np.array_equal(a[k], b[k]) for k in b), cid


def _models(pkg):
    return [pkg.UniformDropout(0.0), pkg.UniformDropout(0.4),
            pkg.UniformDropout(1.0), pkg.PerClientDropout(),
            pkg.PerClientDropout(scale=0.5, a=1.3, b=0.7),
            pkg.LatencyStragglers(deadline_s=5.0),
            pkg.LatencyStragglers(deadline_s=11.0, mean_step_s=1.0,
                                  sigma=0.9, jitter=0.3)]


def test_lifecycle_caps_bit_equal():
    cids = np.random.default_rng(0).permutation(10**6)[:500]
    for tm, jm in zip(_models(tscen), _models(jscen)):
        for t in (0, 3, 999):
            a = tm.step_caps(17, t, cids, 10)
            b = jm.step_caps(17, t, cids, 10)
            assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)
        assert isinstance(tm, tscen.LifecycleModel)
    tl, jl = tscen.LatencyStragglers(3.0), jscen.LatencyStragglers(3.0)
    assert np.array_equal(tl.step_times(4, 2, cids), jl.step_times(4, 2, cids))


def _availability(pkg):
    return [pkg.ConstantAvailability(5),
            pkg.DiurnalAvailability(2, 9, period=13),
            pkg.MinAvailability((pkg.DiurnalAvailability(3, 8, period=7),
                                 pkg.ConstantAvailability(6)))]


@pytest.mark.parametrize("i", [0, 1, 2])
def test_availability_and_sampler_bit_equal(i):
    """Each availability model's peak and cutoffs (host and device), and
    ``ScenarioSampler``'s keyed draw and host replay, equal to the
    reference's; the port's draw of a batch of rounds equals its draws one
    round at a time."""
    tav, jav = _availability(tscen)[i], _availability(jscen)[i]
    assert tav.peak == jav.peak
    ts = torch.arange(0, 40, dtype=torch.int64)
    dev = tav.m_device(ts)
    for t in range(40):
        assert tav.m_at(t) == jav.m_at(t)
        assert int(dev[t]) == int(tav.m_device(t)) == int(jav.m_device(t))
    counts = np.random.default_rng(i).integers(1, 50, size=30)
    tsamp = tscen.ScenarioSampler(tcore.ClientPopulation(counts), tav, seed=3)
    jsamp = jscen.ScenarioSampler(jcore.ClientPopulation(counts), jav, seed=3)
    assert tsamp.lowered_clients == jsamp.lowered_clients == tav.peak
    assert isinstance(tsamp, tcore.KeyedReplayable)
    batch = tsamp.sample_device(tsamp.base_key(), torch.arange(5, 12))
    for r, t in enumerate(range(5, 12)):
        ti, tw = tsamp.sample(t)
        ji, jw = jsamp.sample(t)
        assert np.array_equal(ti, np.asarray(ji))
        assert np.array_equal(tw, np.asarray(jw, np.float32))
        assert np.array_equal(batch[0][r].numpy(), ti)
        assert np.array_equal(batch[1][r].numpy(), tw)


@pytest.mark.parametrize("case", ["dropout", "availability", "adaptive"])
def test_runtime_bit_equal(case):
    """Caps, masks, ``last_m`` and (adaptive) the EMA over 30 rounds of a
    keyed sampler's cohorts, and a ``warmup`` to round 17 that rebuilds
    the same state."""
    extra = {"availability": lambda p: {"availability":
                                        p.DiurnalAvailability(2, 6, 9)},
             "adaptive": lambda p: {"cohort": p.AdaptiveCohort(goal=3)},
             "dropout": lambda p: {}}[case]
    tspec = _spec(tscen, rate=0.5, deadline=6.0, **extra(tscen))
    jspec = _spec(jscen, rate=0.5, deadline=6.0, **extra(jscen))
    counts = np.random.default_rng(1).integers(1, 40, size=50)
    tsamp = tcore.DeviceUniformSampler(tcore.ClientPopulation(counts), 6,
                                       seed=2)
    jsamp = jcore.DeviceUniformSampler(jcore.ClientPopulation(counts), 6,
                                       seed=2)
    assert tspec.stateful == (case == "adaptive") and not tspec.null
    tr, jr = ScenarioRuntime(tspec, 4), JRuntime(jspec, 4)
    for t in range(30):
        idx = tsamp.sample(t)[0]
        a, b = tr.masks_for(t, idx), jr.masks_for(t, idx)
        assert a.dtype == b.dtype and np.array_equal(a, b), t
        assert tr.last_m == jr.last_m and tr._rate_ema == jr._rate_ema
    tw, jw = ScenarioRuntime(tspec, 4), JRuntime(jspec, 4)
    tw.warmup(17, tsamp)
    jw.warmup(17, jsamp)
    assert tw._rate_ema == jw._rate_ema and tw._next_t == jw._next_t
    idx = tsamp.sample(17)[0]
    assert np.array_equal(tw.steps_for(17, idx), jw.steps_for(17, idx))
    if case == "adaptive":
        with pytest.raises(RuntimeError, match="in order"):
            tw.steps_for(30, idx)


def test_spec_validation_matches_reference():
    assert tscen.ScenarioSpec().null and not _spec(tscen).null
    for bad in ({"dropout": object()}, {"availability": 3},
                {"trace": "path"}):
        with pytest.raises(TypeError):
            tscen.ScenarioSpec(**bad)
        with pytest.raises(TypeError):
            jscen.ScenarioSpec(**bad)
    for ctor in (lambda p: p.UniformDropout(1.5),
                 lambda p: p.LatencyStragglers(deadline_s=0),
                 lambda p: p.AdaptiveCohort(goal=0),
                 lambda p: p.ConstantAvailability(0)):
        with pytest.raises(ValueError):
            ctor(tscen)
        with pytest.raises(ValueError):
            ctor(jscen)


# ---------------------------------------------------------------------------
# trajectories against the reference
# ---------------------------------------------------------------------------
K, M, H, B = 12, 3, 3, 10
LENET_ROUNDS = 5


@pytest.fixture(scope="module")
def lenet_world():
    clients, _ = synthetic_femnist(n_clients=K, seed=0)
    w0 = jax.tree.map(np.asarray, jsmall.lenet_init(jax.random.PRNGKey(0)))
    return clients, w0


def _lenet(world, pkg_core, dataset_cls, trainer_cls, loss, init, **kw):
    clients, w0 = world
    opt = pkg_core.fedmom(eta=K / M, beta=0.9, use_fused_kernel=True)
    ds = dataset_cls(clients, seed=1)
    return trainer_cls(
        loss_fn=loss, server_opt=opt,
        rcfg=pkg_core.RoundConfig(M, H, 0.05, compute_dtype="float32"),
        dataset=ds,
        sampler=pkg_core.DeviceUniformSampler(ds.population(), M, seed=2),
        state=opt.init(init(w0)), local_batch=B, **kw)


def _torch_lenet(world, **kw):
    return _lenet(world, tcore, TDataset, FederatedTrainer,
                  tsmall.lenet_loss, lambda w: tree_from_numpy(w, "cpu"),
                  device="cpu", **kw)


@pytest.fixture(scope="module")
def jax_lenet(lenet_world):
    tr = _lenet(lenet_world, jcore, JDataset, JTrainer, jsmall.lenet_loss,
                lambda w: w)
    hist = tr.run(LENET_ROUNDS, plan=JPlan(plane="per_round",
                                          scenario=_spec(jscen, deadline=2.5)),
                  verbose=False)
    return hist, tr.state


def _records(tr, hist):
    hist = strip_events(hist)
    return ([r["loss"] for r in hist], [r["completed"] for r in hist],
            tree_to_numpy(tr.state.w))


def test_lenet_per_round_matches_reference(lenet_world, jax_lenet):
    tr = _torch_lenet(lenet_world)
    hist = tr.run(LENET_ROUNDS,
                  plan=ExecutionPlan(plane="per_round",
                                     scenario=_spec(tscen, deadline=2.5)),
                  verbose=False)
    j_hist, j_state = jax_lenet
    assert [r["completed"] for r in hist] == [r["completed"]
                                              for r in j_hist]
    assert min(r["completed"] for r in hist) < M        # it bit
    np.testing.assert_allclose([r["loss"] for r in hist],
                               [r["loss"] for r in j_hist], rtol=LOSS_RTOL)
    got = tree_to_numpy(tr.state.w)
    for k, v in j_state.w.items():
        np.testing.assert_allclose(got[k], np.asarray(v), rtol=W_RTOL,
                                   atol=W_ATOL, err_msg=k)
    assert tr.session.plan_log[-1]["scenario"] is True


@pytest.fixture(scope="module")
def lenet_planes(lenet_world):
    """The port's LeNet runs under the scenario on every plane (the
    per-round one first, the yardstick)."""
    out = {}
    spec = _spec(tscen, deadline=2.5)
    for plane in ("per_round", "scanned", "device", "streaming", "auto"):
        tr = _torch_lenet(lenet_world)
        hist = tr.run(LENET_ROUNDS, plan=ExecutionPlan(
            plane=plane, chunk_rounds=2, scenario=spec), verbose=False)
        out[plane] = (_records(tr, hist), tr.session.plan_log[-1])
    return out


@pytest.mark.parametrize("plane", ["scanned", "device", "streaming", "auto"])
def test_lenet_planes_bit_equal_under_scenario(lenet_planes, plane):
    (losses, completed, w), rec = lenet_planes[plane]
    ref_losses, ref_completed, ref_w = lenet_planes["per_round"][0]
    assert losses == ref_losses and completed == ref_completed
    for k in ref_w:
        assert np.array_equal(w[k], ref_w[k]), k
    assert rec["plane"] == ("device" if plane == "auto" else plane)
    assert rec["scenario"] is True and "scenario active" in rec["reason"]


LIN_CLIENTS = make_clients(n=10, lo=4, hi=40)
LIN_ROUNDS = 12


@pytest.mark.parametrize("lane", ["streaming", "streaming-bucketed", "hook"])
def test_linreg_lanes_match_reference_streaming(lane):
    """The linreg fleet under the scenario on the padded, bucketed and
    hook lanes against the reference's streaming run of the same lane
    (the hook against the JAX hook in interpret mode)."""
    jopt, topt = opts("fedmom")
    kw_j, kw_t = {}, {}
    if lane == "hook":
        kw_j["client_step_fn"], kw_t["client_step_fn"] = (jax_hook(),
                                                          linreg_tier_step())
    plane = "streaming" if lane == "streaming" else "streaming-bucketed"
    want = run_trajectory(plane, jopt, jax_rcfg(), LIN_CLIENTS, LIN_ROUNDS,
                          chunk_rounds=4, scenario=_spec(jscen), **kw_j)
    got = run_torch(plane, topt, rcfg(), LIN_CLIENTS, LIN_ROUNDS,
                    chunk_rounds=4, scenario=_spec(tscen), **kw_t)
    assert_matches_jax(got, want)
    assert [r["completed"] for r in strip_events(got[0])] == [
        r["completed"] for r in strip_events(want[0])]
    assert min(r["completed"] for r in got[0]) < 3


# ---------------------------------------------------------------------------
# within the port
# ---------------------------------------------------------------------------
def _lin_run(lane, n_rounds=LIN_ROUNDS, spec=None, **kw):
    _, topt = opts("fedmom")
    hist, state = run_torch(lane, topt, rcfg(), LIN_CLIENTS, n_rounds,
                            chunk_rounds=4,
                            scenario=_spec(tscen) if spec is None else spec,
                            **kw)
    return [r["loss"] for r in hist], [r.get("completed") for r in hist], \
        torch_flat_w(state)


@pytest.mark.parametrize("spec_case", ["dropout", "adaptive", "diurnal"])
@pytest.mark.parametrize("lane", ["per-round", "scanned", "device",
                                  "streaming", "streaming-bucketed"])
def test_resume_bit_equal(tmp_path, lane, spec_case):
    """A run stopped at round 6 and resumed from its checkpoint equals the
    uninterrupted run bit for bit (an adaptive cohort's EMA rebuilt by
    ``warmup``)."""
    extra = {"dropout": {},
             "adaptive": {"cohort": tscen.AdaptiveCohort(goal=2)},
             "diurnal": {"availability": tscen.DiurnalAvailability(1, 3, 5)}}
    spec = _spec(tscen, **extra[spec_case])
    whole = _lin_run(lane, spec=spec)
    resumed = _lin_run(lane, spec=spec, resume_at=6, tmp_path=tmp_path)
    assert whole[0] == resumed[0] and whole[1] == resumed[1]
    assert np.array_equal(whole[2], resumed[2])


def test_linreg_planes_and_null_scenario_bit_equal():
    """Every plane trains the per-round plane's trajectory under the
    scenario; a null scenario is bit-equal to none and records no
    ``completed``."""
    ref = _lin_run("per-round")
    for lane in ("scanned", "device", "streaming", "auto"):
        got = _lin_run(lane)
        assert got[:2] == ref[:2] and np.array_equal(got[2], ref[2]), lane
    null = _lin_run("device", spec=tscen.ScenarioSpec(seed=3))
    _, topt = opts("fedmom")
    hist, state = run_torch("device", topt, rcfg(), LIN_CLIENTS, LIN_ROUNDS,
                            chunk_rounds=4)
    assert null[0] == [r["loss"] for r in hist]
    assert np.array_equal(null[2], torch_flat_w(state))
    assert null[1] == [None] * LIN_ROUNDS


def test_scenario_changes_the_trajectory():
    off = run_torch("per-round", opts("fedmom")[1], rcfg(), LIN_CLIENTS,
                    LIN_ROUNDS)
    on = _lin_run("per-round")
    assert [r["loss"] for r in off[0]] != on[0]


def test_device_plane_scenario_needs_keyed_sampler():
    """The stateful ``UniformSampler`` draws keyed on the device but its
    host sample does not replay it: a scenario there raises the
    reference's ``PlanError``; without one the device plane runs."""
    _, topt = opts("fedmom")
    tr = make_trainer(topt, rcfg(), LIN_CLIENTS,
                      sampler_fn=lambda pop: UniformSampler(pop, 3, seed=2))
    with pytest.raises(PlanError, match="KeyedReplayable") as err:
        tr.run(4, plan=ExecutionPlan(plane="device", chunk_rounds=2,
                                     scenario=_spec(tscen)), verbose=False)
    assert (err.value.plane, err.value.missing, err.value.nearest) == (
        "device", "KeyedReplayable", "scanned")
    assert tr._scenario is None and tr.history == []
    hist = tr.run(4, plan=ExecutionPlan(plane="scanned", chunk_rounds=2,
                                        scenario=_spec(tscen)),
                  verbose=False)
    assert all("completed" in r for r in hist)
    assert len(tr.run(2, plan=ExecutionPlan(plane="device", chunk_rounds=2),
                      verbose=False)) == 6


def test_replay_span_equals_round_by_round_samples(monkeypatch):
    """A chunk's batched replay (in slices of ``_REPLAY_LANES`` lanes)
    equals the per-round host samples of every keyed sampler, a custom
    ``KeyedReplayable`` one through its own ``sample``; an empty span is
    empty and a stateful sampler is refused."""
    from repro_torch.core import sampling as tsampling
    pop = tcore.ClientPopulation(np.random.default_rng(5).integers(1, 30,
                                                                   size=40))
    keyed = tcore.DeviceUniformSampler(pop, 4, seed=1)

    class Custom:
        def base_key(self):
            return keyed.base_key()

        def sample(self, t=0):
            return keyed.sample(t)

        def sample_device(self, key, t):
            return keyed.sample_device(key, t)

    samplers = [keyed, tcore.DeviceDiurnalSampler(pop, 2, 5, 7, seed=3),
                tscen.ScenarioSampler(pop, tscen.DiurnalAvailability(1, 6, 9),
                                      seed=4), Custom()]
    monkeypatch.setattr(tsampling, "_REPLAY_LANES", 3 * 40)
    for smp in samplers:
        ids, ws = tsampling.replay_span(smp, 7, 14)
        assert ids.shape == ws.shape == (7, len(smp.sample(0)[0]))
        for r, t in enumerate(range(7, 14)):
            i, w = smp.sample(t)
            assert np.array_equal(ids[r], i) and np.array_equal(ws[r], w)
    assert tsampling.replay_span(keyed, 4, 4)[0].size == 0
    with pytest.raises(ValueError, match="KeyedReplayable"):
        tsampling.replay_span(UniformSampler(pop, 4, seed=1), 0, 2)
