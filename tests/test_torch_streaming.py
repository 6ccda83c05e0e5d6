"""The streaming plane of the port (padded compute) against the JAX
package's, and against the port's own per-round plane, on the CPU.

Against the reference (``run_trajectory("streaming", ...)`` of
``tests/_trajectory.py``, at ``tests/test_torch_trainer.py``'s tolerance,
rtol 1e-4 / atol 1e-5): FedAvg and FedMom, heterogeneous H_k with fully
masked rounds, diurnal M(t), the per-chunk ``cache_*`` records under forced
evictions, and resumes from checkpoints written by the other package.

Within the port: the padded streaming plane runs the same ``round_step`` on
the same rows as the per-round plane, so the two are bit-equal; ``prefetch``
0 and 2 train the same trajectory; eval lands on the per-round plane's
rounds (the reference's own ``test_eval_cadence_finer_than_chunk`` fails on
this JAX version, so the cadence is held to the torch per-round plane).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _trajectory import flat_w, make_clients, run_trajectory  # noqa: E402
from _trajectory import default_rcfg as jax_rcfg  # noqa: E402
from _trajectory import diurnal_sampler_fn as jax_diurnal  # noqa: E402
from _trajectory_torch import (assert_matches_jax, diurnal_sampler_fn,  # noqa: E402,E501
                               linreg_loss, make_trainer, opts, plan_for,
                               rcfg, run_torch, strip_events, torch_flat_w)
from repro_torch.core import DeviceUniformSampler, UniformSampler  # noqa: E402,E501
from repro_torch.data import (DiskShardProvider,  # noqa: E402
                              StreamingFederatedDataset, write_disk_corpus)
from repro_torch.kernels.client_step.ops import linreg_tier_step  # noqa: E402,E501
from repro_torch.launch.train import FederatedTrainer  # noqa: E402
from repro_torch.launch.plan import (CacheSpec, ExecutionPlan,  # noqa: E402
                                     PlanError, TrainSession)

CLIENTS = make_clients(n=8, lo=4, hi=40)


def _hetero(t, C=3, H=4):
    if t % 3 == 0:                              # every third round: no work
        return np.zeros(C, np.int32)
    return np.random.default_rng(17 + t).integers(0, H + 1, size=C)


def _cache_recs(hist):
    return [{k: v for k, v in r.items() if k.startswith("cache_")}
            for r in hist if "cache_hits" in r]


@pytest.mark.parametrize("opt_name", ["fedavg", "fedmom"])
def test_streaming_matches_jax(opt_name):
    jopt, topt = opts(opt_name)
    want = run_trajectory("streaming", jopt, jax_rcfg(), CLIENTS, 12)
    got = run_torch("streaming", topt, rcfg(), CLIENTS, 12)
    assert_matches_jax(got, want)


def test_streaming_hetero_with_fully_masked_rounds_matches_jax():
    jopt, topt = opts("fedmom")
    want = run_trajectory("streaming", jopt, jax_rcfg(), CLIENTS, 9,
                          hetero_fn=_hetero)
    got = run_torch("streaming", topt, rcfg(), CLIENTS, 9,
                    hetero_fn=_hetero)
    assert_matches_jax(got, want)


def test_streaming_diurnal_matches_jax():
    jopt, topt = opts("fedmom")
    want = run_trajectory("streaming", jopt, jax_rcfg(5), CLIENTS, 10,
                          sampler_fn=jax_diurnal(), chunk_rounds=4)
    got = run_torch("streaming", topt, rcfg(5), CLIENTS, 10,
                    sampler_fn=diurnal_sampler_fn(), chunk_rounds=4)
    assert_matches_jax(got, want)


@pytest.mark.parametrize("tiers", [None, 1])
def test_cache_records_match_jax_under_evictions(tiers):
    """A cache of 7 clients against 3-client rounds in 2-round chunks
    (the uniform layout evicts): each chunk's last record carries the same
    hit/miss/eviction deltas (per tier too) as the reference's."""
    jopt, topt = opts("fedavg")
    kw = dict(chunk_rounds=2, cache_clients=7, cache_tiers=tiers)
    want = run_trajectory("streaming", jopt, jax_rcfg(), CLIENTS, 10, **kw)
    got = run_torch("streaming", topt, rcfg(), CLIENTS, 10, **kw)
    assert_matches_jax(got, want)
    assert _cache_recs(got[0]) == _cache_recs(want[0])
    if tiers == 1:
        assert sum(r["cache_evictions"] for r in _cache_recs(got[0])) > 0


def test_torch_resumes_from_jax_streaming_checkpoint(tmp_path):
    from _trajectory import make_trainer as jax_trainer
    from repro.launch.plan import ExecutionPlan as JPlan
    jopt, topt = opts("fedmom")
    ck = str(tmp_path / "jax.npz")
    first = jax_trainer(jopt, jax_rcfg(), CLIENTS, ckpt_path=ck,
                        ckpt_every=1)
    h1 = first.run(5, plan=JPlan(plane="streaming", chunk_rounds=3),
                   verbose=False)
    second = make_trainer(topt, rcfg(), CLIENTS, ckpt_path=ck, ckpt_every=1)
    h2 = second.run(12, plan=plan_for("streaming", 3), verbose=False,
                    resume=True)
    assert [r["round"] for r in h2] == list(range(5, 12))
    want = run_trajectory("streaming", jopt, jax_rcfg(), CLIENTS, 12,
                          chunk_rounds=3)
    assert_matches_jax(([r for r in h1 if "event" not in r] + h2,
                        second.state), want)


def test_jax_resumes_from_torch_streaming_checkpoint(tmp_path):
    from _trajectory import make_trainer as jax_trainer
    from repro.launch.plan import ExecutionPlan as JPlan
    jopt, topt = opts("fedmom")
    ck = str(tmp_path / "torch.npz")
    first = make_trainer(topt, rcfg(), CLIENTS, ckpt_path=ck, ckpt_every=1,
                         hetero_fn=_hetero)
    h1 = first.run(7, plan=plan_for("streaming", 4), verbose=False)
    second = jax_trainer(jopt, jax_rcfg(), CLIENTS, ckpt_path=ck,
                         ckpt_every=1, hetero_fn=_hetero)
    h2 = second.run(12, plan=JPlan(plane="streaming", chunk_rounds=4),
                    verbose=False, resume=True)
    h2 = [r for r in h2 if "event" not in r]
    assert [r["round"] for r in h2] == list(range(7, 12))
    got = run_torch("streaming", topt, rcfg(), CLIENTS, 12, chunk_rounds=4,
                    hetero_fn=_hetero)
    np.testing.assert_allclose([r["loss"] for r in h1 + h2],
                               [r["loss"] for r in got[0]], rtol=1e-4)
    from _trajectory import flat_w
    np.testing.assert_allclose(flat_w(second.state), torch_flat_w(got[1]),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", ["plain", "hetero", "diurnal"])
def test_padded_streaming_bit_equal_to_per_round(case):
    """The same round_step on the same gathered rows: bit for bit."""
    _, topt = opts("fedmom")
    kw = {"plain": {}, "hetero": {"hetero_fn": _hetero},
          "diurnal": {"sampler_fn": diurnal_sampler_fn()}}[case]
    rc = rcfg(5) if case == "diurnal" else rcfg()
    ref = run_torch("per-round", topt, rc, CLIENTS, 11, **kw)
    got = run_torch("streaming", topt, rc, CLIENTS, 11, chunk_rounds=4,
                    cache_clients=9, **kw)
    assert np.array_equal(torch_flat_w(got[1]), torch_flat_w(ref[1]))
    assert [r["loss"] for r in got[0]] == [r["loss"] for r in ref[0]]
    assert [r["delta_norm"] for r in got[0]] == [
        r["delta_norm"] for r in ref[0]]


# prefetch 0 against 2: two-round chunks over a cache of 6 uniform slots
# (the mesh lane: one-round chunks over 3 a shard), so that span i+1's
# uploads evict clients that chunk i reads
PF_ROUNDS, PF_CHUNK, PF_CAP = 10, 2, 6
_COUNTS = ("cache_hits", "cache_misses", "cache_evictions",
           "cache_tier_hits", "cache_tier_misses", "cache_tier_evictions")


class _ClientsProvider:
    """``CLIENTS`` as a ``ShardProvider``, to write them as a disk corpus."""
    n_clients = len(CLIENTS)
    counts = np.array([len(c["y"]) for c in CLIENTS], np.int64)
    fields = {"x": ((5,), np.dtype(np.float32)),
              "y": ((), np.dtype(np.float32))}

    def shard(self, cid):
        return CLIENTS[int(cid)]


def _port_trainer(lane, root):
    _, topt = opts("fedmom")
    hook = {"client_step_fn": linreg_tier_step()} if lane == "hook" else {}
    if lane != "disk":
        return make_trainer(topt, rcfg(), CLIENTS, **hook)
    ds = StreamingFederatedDataset.from_provider(DiskShardProvider(root),
                                                 seed=1)
    return FederatedTrainer(
        loss_fn=linreg_loss, server_opt=topt, rcfg=rcfg(), dataset=ds,
        sampler=DeviceUniformSampler(ds.population(), 3, seed=2),
        state=topt.init({"w": torch.zeros(5), "b": torch.zeros(())}),
        local_batch=4, device="cpu")


def _jax_trainer(lane, root):
    from _trajectory import linreg_loss as jax_loss
    from _trajectory import linreg_params
    from _trajectory import make_trainer as jax_make
    from repro import core as jcore
    from repro import data as jdata
    from repro.kernels.client_step.ops import linreg_tier_step as jax_hook
    from repro.launch.train import FederatedTrainer as JTrainer
    jopt, _ = opts("fedmom")
    hook = ({"client_step_fn": jax_hook(use_kernel=True, interpret=True)}
            if lane == "hook" else {})
    if lane != "disk":
        return jax_make(jopt, jax_rcfg(), CLIENTS, **hook)
    ds = jdata.StreamingFederatedDataset.from_provider(
        jdata.DiskShardProvider(root), seed=1)
    return JTrainer(
        loss_fn=jax_loss, server_opt=jopt, rcfg=jax_rcfg(), dataset=ds,
        sampler=jcore.DeviceUniformSampler(ds.population(), 3, seed=2),
        state=jopt.init(linreg_params()), local_batch=4)


def _counts(recs):
    return [{k: r[k] for k in _COUNTS} for r in recs]


def _shifted(p0):
    """Prefetch 2's per-chunk records from prefetch 0's: with prefetch,
    span i+1's uploads land on chunk i's record (span 0's and 1's on chunk
    0's; nothing on the last), as in the JAX package."""
    def add(a, b):
        return {k: (a[k] + b[k] if isinstance(a[k], int)
                    else [x + y for x, y in zip(a[k], b[k])]) for k in a}
    zero = {k: (0 if isinstance(v, int) else [0] * len(v))
            for k, v in p0[0].items()}
    return [add(p0[0], p0[1])] + p0[2:] + [zero]


def _chunk_slot_overwrites(trainer, n_rounds, plan, monkeypatch):
    """Run ``plan`` and count the uploads that overwrite a (tier, slot)
    that the chunk dispatched just before them reads."""
    from repro_torch.data.stream import ShardCache
    events = []
    write, view = ShardCache._write, ShardCache.view

    def logged_write(self, tier, fresh, slots):
        events.append(("write", [(tier, s) for s in slots]))
        return write(self, tier, fresh, slots)

    def logged_view(self):
        v = view(self)
        events.append(("view", v.client_tiers.clone(),
                       v.client_slots.clone()))
        return v

    with monkeypatch.context() as m:
        m.setattr(ShardCache, "_write", logged_write)
        m.setattr(ShardCache, "view", logged_view)
        hist = strip_events(trainer.run(n_rounds, plan=plan,
                                        verbose=False))
    spans = [range(s, min(s + PF_CHUNK, n_rounds))
             for s in range(0, n_rounds, PF_CHUNK)]
    hits, i = 0, -1
    for ev in events:
        if ev[0] == "view":
            i += 1
            tiers, slots = ev[1], ev[2]
            reads = {(int(tiers[c]), int(slots[c])) for t in spans[i]
                     for c in trainer.sampler.sample(t)[0]}
        elif i >= 0:
            hits += len(reads & set(ev[1]))
    return hist, hits


@pytest.mark.parametrize(
    "lane", ["streaming", "streaming-bucketed", "hook", "disk", "mesh"])
def test_prefetch_does_not_move_the_trajectory(lane, tmp_path, monkeypatch):
    """``prefetch`` 2 overlaps span i+1's uploads with chunk i (on a card),
    0 drains chunk i first.  Under a cache whose next span evicts clients
    the chunk in flight reads, the two arms train bit-equal trajectories
    and make the same cache decisions (their per-chunk records differ only
    by where span i+1's uploads are booked), and each arm equals the JAX
    package's same arm: the trajectory at ``test_torch_trainer.py``'s
    tolerance, the per-chunk cache records exactly.  On the padded,
    bucketed and hook lanes and a ``DiskShardProvider`` corpus; the mesh
    lane over 2 gloo ranks is held to the JAX package's single-device
    run."""
    from repro.launch.plan import CacheSpec as JCache
    from repro.launch.plan import ExecutionPlan as JPlan
    runs = {}
    if lane == "mesh":
        import _mesh_cases_torch as cases
        from repro_torch.launch.mesh import spawn
        ranks = spawn(cases.prefetch_runs, 2, "cpu",
                      args=(CLIENTS, PF_ROUNDS), timeout=300)
        for other in ranks[1:]:
            for p in (0, 2):
                np.testing.assert_array_equal(other[p][1], ranks[0][p][1])
        runs = {p: ranks[0][p] for p in (0, 2)}
        jplan = {p: JPlan(plane="streaming", chunk_rounds=1, prefetch=p,
                          cache=JCache(clients=3, tiers=1)) for p in (0, 2)}
    else:
        root = None
        if lane == "disk":
            root = write_disk_corpus(str(tmp_path / "corpus"),
                                     _ClientsProvider())
        bucketed = lane in ("streaming-bucketed", "hook")
        overwrites = {}
        for p in (0, 2):
            plan = ExecutionPlan(plane="streaming", chunk_rounds=PF_CHUNK,
                                 prefetch=p, cache=CacheSpec(
                                     clients=PF_CAP, tiers=1,
                                     bucketed=bucketed))
            tr = _port_trainer(lane, root)
            hist, overwrites[p] = _chunk_slot_overwrites(
                tr, PF_ROUNDS, plan, monkeypatch)
            runs[p] = ([r["loss"] for r in hist], torch_flat_w(tr.state),
                       _cache_recs(hist))
        # the same uploads overwrite slots of the chunk before them in
        # both arms; with prefetch they are queued while it is in flight
        assert overwrites[0] == overwrites[2] > 0
        jplan = {p: JPlan(plane="streaming", chunk_rounds=PF_CHUNK,
                          prefetch=p, cache=JCache(clients=PF_CAP, tiers=1,
                                                   bucketed=bucketed))
                 for p in (0, 2)}
    (l0, w0, c0), (l2, w2, c2) = runs[0], runs[2]
    assert l0 == l2
    assert np.array_equal(w0, w2)
    assert _counts(c2) == _shifted(_counts(c0))
    assert sum(r["cache_evictions"] for r in c0) > 0
    for p in (0, 2):
        jt = _jax_trainer("streaming" if lane == "mesh" else lane,
                          None if lane == "mesh" else root)
        jh = strip_events(jt.run(PF_ROUNDS, plan=jplan[p], verbose=False))
        np.testing.assert_allclose(runs[p][0], [r["loss"] for r in jh],
                                   rtol=1e-4)
        np.testing.assert_allclose(runs[p][1], flat_w(jt.state), rtol=1e-4,
                                   atol=1e-5)
        if lane != "mesh":
            # one cache on both sides: the same decisions, chunk by chunk
            assert runs[p][2] == _cache_recs(jh)


def test_cpu_cache_neither_pins_nor_streams(monkeypatch):
    """The CPU path has no copy stream and no pinned memory: the same
    bookkeeping writes synchronously."""
    def no_stream(*a, **k):
        raise AssertionError("a CPU run made a CUDA stream")

    def no_pin(*a, **k):
        raise AssertionError("a CPU run pinned memory")

    empty = torch.empty

    def unpinned(*a, **k):
        if k.get("pin_memory"):
            no_pin()
        return empty(*a, **k)

    monkeypatch.setattr(torch.cuda, "Stream", no_stream)
    monkeypatch.setattr(torch.Tensor, "pin_memory", no_pin)
    monkeypatch.setattr(torch, "empty", unpinned)
    _, topt = opts("fedmom")
    for lane in ("streaming", "streaming-bucketed"):
        hist, _ = run_torch(lane, topt, rcfg(), CLIENTS, 6, chunk_rounds=2,
                            cache_clients=PF_CAP, cache_tiers=1)
        assert sum(r.get("cache_evictions", 0) for r in hist) > 0


@pytest.mark.parametrize("lane", ["streaming", "streaming-bucketed"])
def test_eval_cadence_matches_per_round_plane(lane):
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
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_streaming_needs_a_keyed_sampler():
    _, topt = opts("fedavg")
    tr = make_trainer(topt, rcfg(), CLIENTS,
                      sampler_fn=lambda pop: UniformSampler(pop, 3, seed=2))
    with pytest.raises(PlanError, match="KeyedReplayable") as err:
        tr.run(2, plan="streaming", verbose=False)
    assert err.value.missing == "KeyedReplayable"
    # the stateful sampler has a keyed draw, so the most capable plane it
    # runs is the device plane, as the reference's rule names it
    assert err.value.nearest == "device"


def test_shared_session_reuploads_nothing_on_a_second_run():
    _, topt = opts("fedmom")
    session = TrainSession()
    plan = ExecutionPlan(plane="streaming", chunk_rounds=4,
                         cache=CacheSpec(clients=8))
    first = make_trainer(topt, rcfg(), CLIENTS, session=session)
    w0 = {k: v.clone() for k, v in first.state.w.items()}
    first.run(8, plan=plan, verbose=False)
    cache = first.stream_cache
    misses = cache.misses
    assert misses == len(cache.resident()) == 8
    second = dataclasses.replace(first, state=topt.init(w0), history=[])
    second.run(8, plan=plan, verbose=False)
    assert second.stream_cache is cache and cache.misses == misses
    assert np.array_equal(torch_flat_w(first.state),
                          torch_flat_w(second.state))
    assert [r["plane"] for r in session.plan_log] == ["streaming"] * 2
