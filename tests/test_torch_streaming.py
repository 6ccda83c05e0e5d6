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

from _trajectory import make_clients, run_trajectory  # noqa: E402
from _trajectory import default_rcfg as jax_rcfg  # noqa: E402
from _trajectory import diurnal_sampler_fn as jax_diurnal  # noqa: E402
from _trajectory_torch import (assert_matches_jax, diurnal_sampler_fn,  # noqa: E402,E501
                               make_trainer, opts, plan_for, rcfg,
                               run_torch, torch_flat_w)
from repro_torch.core import UniformSampler  # noqa: E402
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


@pytest.mark.parametrize("lane", ["streaming", "streaming-bucketed"])
def test_prefetch_does_not_move_the_trajectory(lane):
    _, topt = opts("fedmom")
    runs = [run_torch(lane, topt, rcfg(), CLIENTS, 10, chunk_rounds=3,
                      cache_clients=9, prefetch=p) for p in (0, 2)]
    assert np.array_equal(torch_flat_w(runs[0][1]), torch_flat_w(runs[1][1]))
    assert [r["loss"] for r in runs[0][0]] == [r["loss"] for r in runs[1][0]]
    for key in ("cache_hits", "cache_misses", "cache_evictions"):
        assert (sum(r.get(key, 0) for r in runs[0][0])
                == sum(r.get(key, 0) for r in runs[1][0]))


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
