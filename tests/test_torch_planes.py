"""The scanned and device planes, the auto rule and ``chunk_rounds="auto"``
of the port against the JAX package's, on the CPU.

Against the reference, at ``tests/_trajectory_torch.py``'s tolerance
(losses rtol 1e-4, parameters rtol 1e-4 / atol 1e-5: every keyed draw is
equal, sums run in other orders): ``scan_rounds`` and
``scan_rounds_sampled`` on the same numpy inputs (FedAvg, FedMom, with and
without step masks, both placements); ``run_torch`` against
``run_trajectory`` on the scanned, device and auto lanes (FedAvg and
FedMom, uniform and diurnal samplers, with and without H_k), a resume from
a JAX checkpoint on the device plane, ``chunk_rounds="auto"``; the auto
rule's ``PlanDecision.record()`` equal to the reference's on the cases of
``tests/test_plan.py`` the port can run (no scenario, secure aggregation
or mesh), and ``auto_chunk_rounds`` on a grid.

Within the port, bit for bit: the scanned and device planes against the
per-round plane (the same ``round_step`` on the same rows; DP noise too);
an eval cadence finer than a chunk evals at the per-round plane's rounds
(the reference's own cadence test fails on this JAX version); the
deprecated shims against the plan API; the keyed draws and the round body
with ``t`` and ``lr`` as tensors against host values; a chunk run twice at
different ``t0`` against the eager loop at those rounds.
"""
import json
import warnings

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _trajectory import make_clients, run_trajectory  # noqa: E402
from _trajectory import default_rcfg as jax_rcfg  # noqa: E402
from _trajectory import diurnal_sampler_fn as jax_diurnal  # noqa: E402
from _trajectory import make_trainer as jax_trainer  # noqa: E402
from _trajectory_torch import (LOSS_RTOL, W_ATOL, W_RTOL,  # noqa: E402
                               assert_matches_jax, diurnal_sampler_fn,
                               linreg_loss, make_trainer, opts, plan_for,
                               rcfg, run_torch, strip_events, torch_flat_w)
from repro import core as jcore  # noqa: E402
from repro.launch import plan as jplan  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.core import multiround as tmr  # noqa: E402
from repro_torch.core import sampling as tsampling  # noqa: E402
from repro_torch.data import (DeviceFederatedDataset,  # noqa: E402
                              FederatedDataset, StreamingFederatedDataset)
from repro_torch.interop import tree_from_numpy, tree_to_numpy  # noqa: E402
from repro_torch.launch import plan as tplan  # noqa: E402
from repro_torch.launch.graph import ChunkGraph  # noqa: E402

CLIENTS = make_clients(n=8, lo=4, hi=40)
LANES = ("scanned", "device", "auto")


def _hetero(t, C=3, H=4):
    if t % 3 == 0:                              # every third round: no work
        return np.zeros(C, np.int32)
    return np.random.default_rng(17 + t).integers(0, H + 1, size=C)


def _bit_equal(got, want):
    assert [r["round"] for r in got[0]] == [r["round"] for r in want[0]]
    for key in ("loss", "delta_norm"):
        assert [r[key] for r in got[0]] == [r[key] for r in want[0]], key
    assert np.array_equal(torch_flat_w(got[1]), torch_flat_w(want[1]))
    assert int(got[1].t) == int(want[1].t)


# ---------------------------------------------------------------------------
# scan_rounds / scan_rounds_sampled against the reference's
# ---------------------------------------------------------------------------
def _staged(R=8, C=3, H=2, b=4, d=5, seed=4):
    rng = np.random.default_rng(seed)
    return ({"x": rng.normal(size=(R, C, H, b, d)).astype(np.float32),
             "y": rng.normal(size=(R, C, H, b)).astype(np.float32)},
            rng.uniform(0.05, 0.3, size=(R, C)).astype(np.float32),
            rng.uniform(0.01, 0.1, size=R).astype(np.float32),
            (rng.uniform(size=(R, C, H)) < 0.7).astype(np.float32))


def _opt_pair(name):
    if name == "fedmom":
        return jcore.fedmom(eta=2.0, beta=0.9), tcore.fedmom(eta=2.0,
                                                             beta=0.9)
    return jcore.fedavg(eta=1.5), tcore.fedavg(eta=1.5)


def _params():
    return ({"w": jnp.zeros(5), "b": jnp.zeros(())},
            {"w": torch.zeros(5), "b": torch.zeros(())})


def _assert_scan_equal(t_out, j_out, R):
    (t_st, t_m), (j_st, j_m) = t_out, j_out
    np.testing.assert_allclose(t_m["loss"].numpy(), np.asarray(j_m["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(t_m["delta_norm"].numpy(),
                               np.asarray(j_m["delta_norm"]), rtol=LOSS_RTOL)
    w = tree_to_numpy(t_st.w)
    for k in w:
        np.testing.assert_allclose(w[k], np.asarray(j_st.w[k]), rtol=W_RTOL,
                                   atol=W_ATOL)
    assert int(t_st.t) == int(j_st.t) == R
    assert "losses" not in t_m and tuple(t_m["loss"].shape) == (R,)


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("placement", ["mesh", "scan"])
@pytest.mark.parametrize("opt_name", ["fedavg", "fedmom"])
def test_scan_rounds_matches_reference(opt_name, placement, masked):
    batches, weights, lrs, masks = _staged()
    jopt, topt = _opt_pair(opt_name)
    jp, tp = _params()
    kw = dict(clients_per_round=3, local_steps=2, lr=0.05,
              placement=placement, compute_dtype="float32")
    want = jcore.scan_rounds(
        linreg_loss_jax, jopt, jopt.init(jp),
        {k: jnp.asarray(v) for k, v in batches.items()},
        jnp.asarray(weights), jcore.RoundConfig(**kw), lrs=jnp.asarray(lrs),
        step_masks=jnp.asarray(masks) if masked else None)
    got = tmr.scan_rounds(linreg_loss, topt, topt.init(tp), batches, weights,
                          tcore.RoundConfig(**kw), lrs=lrs,
                          step_masks=masks if masked else None,
                          device="cpu")
    _assert_scan_equal(got, want, 8)


def linreg_loss_jax(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    return jnp.mean(jnp.square(pred - batch["y"])), {}


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("opt_name", ["fedavg", "fedmom"])
def test_scan_rounds_sampled_matches_reference(opt_name, masked):
    """Weights drawn by the keyed sampler on the device, batches assembled
    on the host for the replayed cohorts, t0 = 3."""
    from repro.data import FederatedDataset as JDataset
    ds = FederatedDataset([dict(c) for c in CLIENTS], seed=1)
    jsampler = jcore.DeviceUniformSampler(
        JDataset([dict(c) for c in CLIENTS], seed=1).population(), 3, seed=5)
    tsampler = tcore.DeviceUniformSampler(ds.population(), 3, seed=5)
    R, t0 = 6, 3
    bs = [ds.round_batches(tsampler.sample(t0 + r)[0], 2, 4, t=t0 + r)
          for r in range(R)]
    batches = {k: np.stack([b[k] for b in bs]) for k in bs[0]}
    masks = _staged(R=R)[3] if masked else None
    jopt, topt = _opt_pair(opt_name)
    jp, tp = _params()
    kw = dict(clients_per_round=3, local_steps=2, lr=0.05,
              placement="mesh", compute_dtype="float32")
    want = jcore.scan_rounds_sampled(
        linreg_loss_jax, jopt, jopt.init(jp),
        {k: jnp.asarray(v) for k, v in batches.items()}, jsampler,
        jsampler.base_key(), jnp.int32(t0), jcore.RoundConfig(**kw),
        step_masks=None if masks is None else jnp.asarray(masks))
    got = tmr.scan_rounds_sampled(
        linreg_loss, topt, topt.init(tp), batches, tsampler,
        tsampler.base_key(), t0, tcore.RoundConfig(**kw), step_masks=masks,
        device="cpu")
    _assert_scan_equal(got, want, R)


# ---------------------------------------------------------------------------
# trajectories against the reference's run_trajectory
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("opt_name", ["fedavg", "fedmom"])
@pytest.mark.parametrize("lane", LANES)
def test_lane_matches_jax(lane, opt_name):
    jopt, topt = opts(opt_name)
    want = run_trajectory(lane, jopt, jax_rcfg(), CLIENTS, 11,
                          chunk_rounds=4)
    got = run_torch(lane, topt, rcfg(), CLIENTS, 11, chunk_rounds=4)
    assert_matches_jax(got, want)


@pytest.mark.parametrize("case", ["diurnal", "hetero"])
@pytest.mark.parametrize("lane", LANES)
def test_lane_matches_jax_diurnal_and_hetero(lane, case):
    jopt, topt = opts("fedmom")
    if case == "diurnal":
        jkw, tkw = {"sampler_fn": jax_diurnal()}, {
            "sampler_fn": diurnal_sampler_fn()}
        jrc, trc = jax_rcfg(5), rcfg(5)
    else:
        jkw = tkw = {"hetero_fn": _hetero}
        jrc, trc = jax_rcfg(), rcfg()
    want = run_trajectory(lane, jopt, jrc, CLIENTS, 10, chunk_rounds=4, **jkw)
    got = run_torch(lane, topt, trc, CLIENTS, 10, chunk_rounds=4, **tkw)
    assert_matches_jax(got, want)


def test_torch_resumes_from_jax_checkpoint_on_device_plane(tmp_path):
    from repro.launch.plan import ExecutionPlan as JPlan
    jopt, topt = opts("fedmom")
    ck = str(tmp_path / "jax.npz")
    first = jax_trainer(jopt, jax_rcfg(), CLIENTS, ckpt_path=ck,
                        ckpt_every=1)
    h1 = first.run(5, plan=JPlan(plane="device", chunk_rounds=3),
                   verbose=False)
    second = make_trainer(topt, rcfg(), CLIENTS, ckpt_path=ck, ckpt_every=1)
    h2 = second.run(12, plan=plan_for("device", 3), verbose=False,
                    resume=True)
    assert [r["round"] for r in h2] == list(range(5, 12))
    want = run_trajectory("device", jopt, jax_rcfg(), CLIENTS, 12,
                          chunk_rounds=3)
    assert_matches_jax((strip_events(h1) + h2, second.state), want)


def test_chunk_rounds_auto_matches_jax_and_is_audited():
    jopt, topt = opts("fedmom")
    want = run_trajectory("device", jopt, jax_rcfg(), CLIENTS, 12)
    tr = make_trainer(topt, rcfg(), CLIENTS)
    hist = tr.run(12, plan=tplan.ExecutionPlan(plane="device",
                                               chunk_rounds="auto"),
                  verbose=False)
    assert_matches_jax((hist, tr.state), want)
    rec = tr.session.plan_log[-1]
    overhead = tr.session.dispatch_overhead()
    assert rec["chunk_rounds"] == tplan.auto_chunk_rounds(overhead, 12)
    assert rec["dispatch_overhead_s"] == round(overhead, 9)
    assert "chunk_rounds auto ->" in rec["reason"]


# ---------------------------------------------------------------------------
# within the port: the chunked planes train the per-round trajectory
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["plain", "hetero", "diurnal", "dp"])
@pytest.mark.parametrize("lane", ["scanned", "device"])
def test_lane_bit_equal_to_per_round(lane, case):
    topt = (tcore.dp_fedmom(clip=0.5, noise_multiplier=0.3, dp_seed=7)
            if case == "dp" else opts("fedmom")[1])
    kw = {"hetero": {"hetero_fn": _hetero},
          "diurnal": {"sampler_fn": diurnal_sampler_fn()}}.get(case, {})
    rc = rcfg(5) if case == "diurnal" else rcfg()
    ref = run_torch("per-round", topt, rc, CLIENTS, 11, **kw)
    got = run_torch(lane, topt, rc, CLIENTS, 11, chunk_rounds=4, **kw)
    _bit_equal(got, ref)


@pytest.mark.parametrize("lane", ["scanned", "device"])
def test_eval_cadence_finer_than_chunk_matches_per_round_plane(lane):
    """Chunks end after every eval round (``_eval_spans``), so eval sees
    the states the per-round plane evals, at the same rounds."""
    _, topt = opts("fedavg")
    seen = {}
    for plane in ("per-round", lane):
        states = []

        def eval_fn(state):
            states.append((state.t, torch_flat_w(state)))
            return {"probe": float(state.t)}

        tr = make_trainer(topt, rcfg(), CLIENTS)
        plan = plan_for(plane, 8) if plane != "per-round" else "per_round"
        hist = tr.run(11, plan=plan, verbose=False, eval_fn=eval_fn,
                      log_every=3)
        seen[plane] = (states, [r.get("probe") for r in hist])
    (ref_states, ref_probe), (states, probe) = seen["per-round"], seen[lane]
    assert [t for t, _ in states] == [t for t, _ in ref_states] \
        == [1, 4, 7, 10, 11]
    assert probe == ref_probe
    for (_, a), (_, b) in zip(states, ref_states):
        assert np.array_equal(a, b)


def test_auto_run_logs_its_decision(tmp_path, capsys):
    _, topt = opts("fedmom")
    path = str(tmp_path / "metrics.jsonl")
    tr = make_trainer(topt, rcfg(), CLIENTS, metrics_path=path)
    hist = tr.run(6, plan=tplan.ExecutionPlan(plane="auto", chunk_rounds=3,
                                              memory_budget_bytes=1 << 40))
    dec = tr.session.plan_log[-1]
    assert dec["plane"] == "device" and dec["auto"]
    assert hist[0] == dec and len(strip_events(hist)) == 6
    with open(path) as f:
        assert json.loads(f.readline()) == dec
    assert "plan: auto -> device (packed corpus" in capsys.readouterr().out
    tr.run(6, plan="scanned", verbose=False)       # explicit: not logged
    assert tr.session.plan_log[-1]["auto"] is False
    assert len([r for r in tr.history if "event" in r]) == 1


def test_plan_none_stays_per_round_and_the_default_plane_is_auto():
    assert tplan.as_plan(None).plane == "per_round"
    assert tplan.ExecutionPlan().plane == jplan.ExecutionPlan().plane \
        == "auto"


def test_device_plane_reuses_the_packed_corpus_and_its_chunks():
    _, topt = opts("fedmom")
    tr = make_trainer(topt, rcfg(), CLIENTS)
    tr.run(8, plan=plan_for("device", 4), verbose=False)
    dds, graphs = tr.session.device_ds, dict(tr.session.graphs)
    assert isinstance(dds, DeviceFederatedDataset) and len(graphs) == 1
    tr.run(8, plan=plan_for("device", 4), verbose=False)
    assert tr.session.device_ds is dds and tr.session.graphs == graphs
    tr.run(11, plan=plan_for("device", 4), verbose=False)   # ragged: 4,4,3
    assert len(tr.session.graphs) == 2


# ---------------------------------------------------------------------------
# the auto rule against the reference's
# ---------------------------------------------------------------------------
class _HostOnly:
    """A sampler with no keyed draw (the reference's test_plan case)."""
    lowered_clients = 3
    seed = 2

    def sample(self, t=0):
        rng = np.random.default_rng(1000 + t)
        idx = rng.choice(8, size=3, replace=False)
        return idx, np.full(3, 1 / 8, np.float32)


def _skewed():
    rng = np.random.default_rng(5)
    out = []
    for n in (64, 3, 5, 2, 7, 4, 6, 3):
        x = rng.normal(size=(n, 5)).astype(np.float32)
        out.append({"x": x, "y": x[:, 0].copy()})
    return out


def _pair(clients=CLIENTS, dataset="host", sampler="keyed"):
    """A reference trainer and a port trainer of one config."""
    from repro.data import DeviceFederatedDataset as JDevice
    from repro.data import FederatedDataset as JDataset
    from repro.data import StreamingFederatedDataset as JStream
    jopt, topt = opts("fedmom")
    jrc, trc = jax_rcfg(), rcfg()
    trainers = []
    for pkg, opt, rc, mk in (("jax", jopt, jrc, jax_trainer),
                             ("torch", topt, trc, make_trainer)):
        tr = mk(opt, rc, clients)
        if dataset == "streaming":
            tr.dataset = (JStream if pkg == "jax"
                          else StreamingFederatedDataset)(
                [dict(c) for c in clients], seed=1)
        elif dataset == "packed":
            tr.dataset = (JDevice.pack(clients, seed=1) if pkg == "jax"
                          else DeviceFederatedDataset.pack(
                              clients, seed=1, device="cpu"))
        elif dataset == "assembly-only":
            inner = (JDataset if pkg == "jax" else FederatedDataset)(
                [dict(c) for c in clients], seed=1)

            class HostAssemblyOnly:
                def round_batches(self, ids, H, b, t=0, inner=inner):
                    return inner.round_batches(ids, H, b, t=t)
            tr.dataset = HostAssemblyOnly()
        if sampler == "host-only":
            tr.sampler = _HostOnly()
        trainers.append(tr)
    return trainers


def _sds_bytes(clients, capacity):
    return StreamingFederatedDataset([dict(c) for c in clients],
                                     seed=1).tier_layout().bytes_for_capacity(
                                         capacity)


AUTO_CASES = {
    "device-large-budget": ({}, dict(chunk_rounds=3,
                                     memory_budget_bytes=1 << 40)),
    "device-unbounded": ({}, {}),
    "streaming-mid-budget": ({}, dict(
        chunk_rounds=1, memory_budget_bytes=_sds_bytes(CLIENTS, 3))),
    "streaming-tiered-bytes": ({"clients": _skewed()}, dict(
        chunk_rounds=1, memory_budget_bytes=_sds_bytes(_skewed(), 3))),
    "streaming-bucketed": ({}, dict(
        chunk_rounds=1, memory_budget_bytes=_sds_bytes(CLIENTS, 3),
        cache=("bucketed",))),
    "scanned-tiny-budget": ({}, dict(chunk_rounds=2,
                                     memory_budget_bytes=1)),
    "scanned-cache-below-viable": ({}, dict(
        chunk_rounds=1, cache=("bytes", 1), memory_budget_bytes=1 << 10)),
    "scanned-cache-clients-and-bytes": ({}, dict(
        chunk_rounds=1, cache=("clients+bytes", 3, 1),
        memory_budget_bytes=1 << 10)),
    "scanned-no-device-sampler": ({"sampler": "host-only"}, dict(
        chunk_rounds=2, memory_budget_bytes=1 << 40)),
    "scanned-assembly-only-dataset": ({"dataset": "assembly-only"}, {}),
    "pinned-streaming-dataset": ({"dataset": "streaming"}, {}),
    "pinned-packed-dataset": ({"dataset": "packed"}, {}),
    "chunk-rounds-auto": ({}, dict(chunk_rounds="auto",
                                   memory_budget_bytes=1 << 40)),
}


def _plans(kw):
    kw = dict(kw)
    cache = kw.pop("cache", None)
    out = []
    for mod in (jplan, tplan):
        spec = mod.CacheSpec()
        if cache and cache[0] == "bucketed":
            spec = mod.CacheSpec(bucketed=True)
        elif cache and cache[0] == "bytes":
            spec = mod.CacheSpec(bytes=cache[1])
        elif cache:
            spec = mod.CacheSpec(clients=cache[1], bytes=cache[2])
        out.append(mod.ExecutionPlan(plane="auto", cache=spec, **kw))
    return out


@pytest.mark.parametrize("case", list(AUTO_CASES))
def test_auto_rule_records_equal_the_reference(case):
    pair_kw, plan_kw = AUTO_CASES[case]
    jtr, ttr = _pair(**pair_kw)
    jp, tp = _plans(plan_kw)
    # the same measured overhead on both sides (it is the host's)
    jtr.session._dispatch_overhead_s = 3.3e-4
    ttr.session._dispatch_overhead_s = 3.3e-4
    want = jplan.resolve(jp, jtr, 40).record()
    got = tplan.resolve(tp, ttr, 40).record()
    assert got == want
    assert got["plane"] == case.split("-")[0] or case.startswith(
        ("pinned", "chunk"))


def test_auto_chunk_rounds_prices_the_resolved_chunk():
    """``chunk_rounds="auto"`` past the device plane: the reference prices
    the working set at ``clients_per_round * "auto"`` and raises a
    TypeError; the port prices it at the resolved size, so its record is
    the reference's for that size, with the auto suffix."""
    jtr, ttr = _pair()
    ttr.session._dispatch_overhead_s = 3.3e-4
    with pytest.raises(TypeError):
        jplan.resolve(jplan.ExecutionPlan(plane="auto", chunk_rounds="auto",
                                          memory_budget_bytes=1), jtr, 40)
    got = tplan.resolve(tplan.ExecutionPlan(
        plane="auto", chunk_rounds="auto", memory_budget_bytes=1), ttr, 40)
    size = tplan.auto_chunk_rounds(3.3e-4, 40)
    want = jplan.resolve(jplan.ExecutionPlan(
        plane="auto", chunk_rounds=size, memory_budget_bytes=1), jtr,
        40).record()
    rec = got.record()
    assert rec.pop("dispatch_overhead_s") == 3.3e-4
    assert rec.pop("reason").startswith(want.pop("reason") + "; chunk_rounds"
                                        f" auto -> {size} ")
    assert rec == want and rec["plane"] == "scanned"


def test_auto_rule_raises_where_the_reference_raises():
    """A packable dataset with no host assembly, squeezed to the scanned
    plane: the reference's structured error, the same ``nearest``."""
    jtr, ttr = _pair()

    class ShardOnly:
        data = [dict(c) for c in CLIENTS]
        seed = 1
    jtr.dataset = ttr.dataset = ShardOnly()
    errs = []
    for mod, tr in ((jplan, jtr), (tplan, ttr)):
        with pytest.raises(mod.PlanError, match="round_batches") as ei:
            mod.resolve(mod.ExecutionPlan(plane="auto",
                                          memory_budget_bytes=1), tr, 4)
        errs.append(ei.value)
    assert str(errs[1]) == str(errs[0])
    assert errs[1].nearest == errs[0].nearest


@pytest.mark.parametrize("plane", ["scanned", "device", "streaming"])
def test_explicit_plane_capability_errors_match_reference(plane):
    jtr, ttr = _pair(sampler="host-only")
    errs = []
    for mod, tr in ((jplan, jtr), (tplan, ttr)):
        if plane == "scanned":
            assert mod.resolve(mod.as_plan(plane), tr, 4).plane == plane
            return
        with pytest.raises(mod.PlanError) as ei:
            mod.resolve(mod.as_plan(plane), tr, 4)
        errs.append(ei.value)
    assert str(errs[1]) == str(errs[0])
    assert (errs[1].missing, errs[1].nearest) == (errs[0].missing,
                                                  errs[0].nearest)


def test_auto_chunk_rounds_equals_reference_on_a_grid():
    for overhead in (0.0, 1e-7, 24e-6, 25e-6, 26e-6, 2e-4, 1e-3, 6.4e-3,
                     1.0):
        for n in (1, 5, 8, 9, 100, 300):
            assert tplan.auto_chunk_rounds(overhead, n) \
                == jplan.auto_chunk_rounds(overhead, n)
    assert (tplan._AUTO_CHUNK_TARGET_S, tplan._AUTO_CHUNK_MIN,
            tplan._AUTO_CHUNK_MAX) == (jplan._AUTO_CHUNK_TARGET_S,
                                       jplan._AUTO_CHUNK_MIN,
                                       jplan._AUTO_CHUNK_MAX)


def test_dispatch_overhead_is_measured_once_per_session():
    session = tplan.TrainSession()
    first = session.dispatch_overhead("cpu")
    assert 0.0 < first < 0.1
    assert session.dispatch_overhead("cpu") == first
    assert tplan.device_memory_budget("cpu") is None


def test_a_mesh_corpus_is_refused():
    """A corpus is packed for a ``MeshSpec`` (or none); anything else as
    its mesh is refused.  The sharded corpus itself: test_torch_mesh.py."""
    with pytest.raises(tplan.PlanError, match="MeshSpec"):
        tplan.TrainSession().device_dataset(
            FederatedDataset([dict(c) for c in CLIENTS], seed=1),
            mesh=object(), device="cpu")


# ---------------------------------------------------------------------------
# the deprecated shims
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shim", ["run_scanned", "run_device",
                                  "run_streaming"])
def test_shim_warns_and_equals_the_plan_api(shim):
    _, topt = opts("fedmom")
    plane = shim[len("run_"):]
    ref = make_trainer(topt, rcfg(), CLIENTS)
    ref.run(9, plan=tplan.ExecutionPlan(plane=plane, chunk_rounds=4),
            verbose=False)
    tr = make_trainer(topt, rcfg(), CLIENTS)
    with pytest.warns(DeprecationWarning, match=shim):
        hist = getattr(tr, shim)(9, chunk_rounds=4, verbose=False)
    _bit_equal((hist, tr.state), (ref.history, ref.state))


def test_local_batch_shims_warn_and_equal_the_field():
    _, topt = opts("fedavg")
    tr = make_trainer(topt, rcfg(), CLIENTS)
    with pytest.warns(DeprecationWarning, match="local_batch"):
        assert tr.local_batch_size() == tr.local_batch == 4
    with pytest.warns(DeprecationWarning, match="set_local_batch"):
        assert tr.set_local_batch(6) is tr
    assert tr.local_batch == 6
    ref = make_trainer(topt, rcfg(), CLIENTS, local_batch=6)
    ref.run(5, plan="device", verbose=False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tr.run(5, plan="device", verbose=False)
    _bit_equal((tr.history, tr.state), (ref.history, ref.state))


# ---------------------------------------------------------------------------
# capture-safe draws: the round index and the stepsize as device tensors
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["uniform", "diurnal"])
def test_keyed_draw_with_tensor_round_equals_int_round(kind):
    pop = FederatedDataset([dict(c) for c in CLIENTS], seed=1).population()
    s = (tcore.DeviceUniformSampler(pop, 3, seed=2) if kind == "uniform"
         else tcore.DeviceDiurnalSampler(pop, m_min=1, m_max=5, period=7,
                                         seed=3))
    key = s.base_key()
    for t in range(15):                             # two diurnal periods
        a = s.sample_device(key, t)
        b = s.sample_device(key, torch.tensor(t, dtype=torch.int64))
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        np.testing.assert_array_equal(s.sample(t)[0], b[0].numpy())
    assert list(s._weights) == [torch.device("cpu")]   # one table, kept
    if kind == "diurnal":
        for t in range(15):
            m = tsampling.diurnal_m_device(torch.tensor(t), 1, 5, 7)
            assert m.dtype == torch.int64
            assert int(m) == tsampling.diurnal_m_device(t, 1, 5, 7)


def test_round_body_with_tensor_round_and_lr_equals_host_values():
    _, topt = opts("fedmom")
    tr = make_trainer(topt, rcfg(), CLIENTS)
    dds = DeviceFederatedDataset.from_federated(tr.dataset, device="cpu")
    lrs = np.asarray([0.05, 0.03, 0.07, 0.02], np.float32)
    masks = np.stack([(np.arange(4)[None] < _hetero(t)[:, None])
                      .astype(np.float32) for t in range(5, 9)])
    outs = []
    for as_tensor in (False, True):
        t0 = torch.tensor(5) if as_tensor else 5
        outs.append(tmr.scan_rounds_ondevice(
            linreg_loss, topt, topt.init({"w": torch.zeros(5),
                                          "b": torch.zeros(())}),
            dds, tr.sampler, dds.base_key(), tr.sampler.base_key(), t0, 4,
            tr.rcfg, 4, lrs=torch.from_numpy(lrs) if as_tensor else lrs,
            step_masks=torch.from_numpy(masks) if as_tensor else masks,
            device="cpu"))
    (s0, m0), (s1, m1) = outs
    for k in ("loss", "delta_norm", "completed", "clients"):
        assert torch.equal(m0[k], m1[k]), k
    assert m0["round"] == [0, 1, 2, 3]          # the state's own counter
    for k in s0.w:
        assert torch.equal(s0.w[k], s1.w[k])


def test_chunk_run_at_two_round_indices_equals_the_eager_loop():
    """One chunk object run at t0 = 0 and t0 = 8 trains those rounds: each
    equals the eager loop started at the same state and round."""
    _, topt = opts("fedmom")
    tr = make_trainer(topt, rcfg(), CLIENTS)
    dds = DeviceFederatedDataset.from_federated(tr.dataset, device="cpu")
    skey, dkey = tr.sampler.base_key(), dds.base_key()

    def body(state, inp):
        return tmr.scan_rounds_ondevice(
            linreg_loss, topt, state, dds, tr.sampler, dkey, skey,
            inp["t0"], 4, tr.rcfg, 4, lrs=inp["lrs"], device="cpu")

    chunk = ChunkGraph(body, 4, "cpu")
    lrs = np.full(4, 0.05, np.float32)
    state = tr.state
    for t0 in (0, 8):
        got_state, got = chunk.run(state, t0, {"lrs": lrs})
        want_state, want = tmr.scan_rounds_ondevice(
            linreg_loss, topt, state._replace(t=t0), dds, tr.sampler, dkey,
            skey, t0, 4, tr.rcfg, 4, lrs=lrs, device="cpu")
        assert torch.equal(got["clients"], want["clients"])
        assert torch.equal(got["loss"], want["loss"])
        assert got["round"].tolist() == want["round"] == list(
            range(t0, t0 + 4))
        assert got_state.t == t0 + 4
        for k in state.w:
            assert torch.equal(got_state.w[k], want_state.w[k])
        state = got_state
    with pytest.raises(ValueError, match="captured at"):
        chunk.run(state, 0, {"lrs": np.zeros(3, np.float32)})


def test_prng_key_made_on_the_device_equals_the_host_key():
    from repro_torch import random as prng
    assert prng.PRNGKey(-3).tolist() == [0, (-3) & 0xFFFFFFFF]
    assert torch.equal(prng.PRNGKey(7, device="cpu"),
                       torch.tensor([0, 7], dtype=torch.int64))


def test_trainer_state_from_numpy_runs_on_the_device_plane():
    """A state made with ``interop`` (the checkpoint path) trains on the
    device plane like one made by ``init``."""
    _, topt = opts("fedavg")
    a = make_trainer(topt, rcfg(), CLIENTS)
    b = make_trainer(topt, rcfg(), CLIENTS)
    b.state = topt.init(tree_from_numpy(tree_to_numpy(a.state.w), "cpu"))
    a.run(6, plan="device", verbose=False)
    b.run(6, plan="device", verbose=False)
    _bit_equal((a.history, a.state), (b.history, b.state))
