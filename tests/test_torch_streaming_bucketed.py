"""The bucketed streaming plane of the port (``CacheSpec(bucketed=True)``:
n_k-shaped per-tier compute) against the JAX package's, on the CPU.

Against ``run_trajectory("streaming-bucketed", ...)`` at
``tests/test_torch_trainer.py``'s tolerance (rtol 1e-4 / atol 1e-5): FedAvg
and FedMom, heterogeneous H_k with fully masked rounds, diurnal M(t), n_k on
power-of-two tier edges, the per-chunk ``cache_*`` records, and the fused
``client_step_fn`` hook with and without H_k masks (against the JAX hook in
interpret mode).  Within the port: one occupied tier (or ``tiers=1``) makes
the bucketed plane bit-equal to the padded one, a resumed run is bit-equal
to an uninterrupted one, and the hook is refused where it cannot compute
the same update.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _trajectory import make_clients, run_trajectory  # noqa: E402
from _trajectory import default_rcfg as jax_rcfg  # noqa: E402
from _trajectory import diurnal_sampler_fn as jax_diurnal  # noqa: E402
from _trajectory_torch import (assert_matches_jax, diurnal_sampler_fn,  # noqa: E402,E501
                               make_trainer, opts, rcfg, run_torch,
                               torch_flat_w)
from repro.kernels.client_step.ops import \
    linreg_tier_step as jax_hook  # noqa: E402
from repro_torch.core import RoundConfig  # noqa: E402
from repro_torch.kernels.client_step.ops import linreg_tier_step  # noqa: E402
from repro_torch.launch.plan import CacheSpec, ExecutionPlan, PlanError  # noqa: E402,E501

CLIENTS = make_clients(n=8, lo=4, hi=40)
BUCKETED = ExecutionPlan(plane="streaming", chunk_rounds=4,
                         cache=CacheSpec(bucketed=True))


def _hetero(t, C=3, H=4):
    if t % 3 == 0:                              # every third round: no work
        return np.zeros(C, np.int32)
    return np.random.default_rng(300 + t).integers(0, H + 1, size=C)


def _pow2_clients():
    rng = np.random.default_rng(11)
    out = []
    for n in (8, 8, 16, 16, 32, 32, 9, 17):    # edges + just over an edge
        x = rng.normal(size=(n, 5)).astype(np.float32)
        out.append({"x": x, "y": (x @ np.arange(1, 6) / 5).astype(
            np.float32)})
    return out


@pytest.mark.parametrize("opt_name", ["fedavg", "fedmom"])
def test_bucketed_matches_jax(opt_name):
    jopt, topt = opts(opt_name)
    want = run_trajectory("streaming-bucketed", jopt, jax_rcfg(), CLIENTS,
                          12)
    got = run_torch("streaming-bucketed", topt, rcfg(), CLIENTS, 12)
    assert_matches_jax(got, want)
    assert [{k: v for k, v in r.items() if k.startswith("cache_")}
            for r in got[0]] == [
        {k: v for k, v in r.items() if k.startswith("cache_")}
        for r in want[0] if "event" not in r]


def test_bucketed_hetero_with_fully_masked_rounds_matches_jax():
    jopt, topt = opts("fedmom")
    want = run_trajectory("streaming-bucketed", jopt, jax_rcfg(), CLIENTS,
                          9, hetero_fn=_hetero)
    got = run_torch("streaming-bucketed", topt, rcfg(), CLIENTS, 9,
                    hetero_fn=_hetero)
    assert_matches_jax(got, want)


def test_bucketed_diurnal_matches_jax():
    jopt, topt = opts("fedmom")
    want = run_trajectory("streaming-bucketed", jopt, jax_rcfg(5), CLIENTS,
                          10, sampler_fn=jax_diurnal(), chunk_rounds=4)
    got = run_torch("streaming-bucketed", topt, rcfg(5), CLIENTS, 10,
                    sampler_fn=diurnal_sampler_fn(), chunk_rounds=4)
    assert_matches_jax(got, want)


def test_bucketed_pow2_edges_match_jax():
    jopt, topt = opts("fedmom")
    clients = _pow2_clients()
    want = run_trajectory("streaming-bucketed", jopt, jax_rcfg(), clients,
                          10)
    got = run_torch("streaming-bucketed", topt, rcfg(), clients, 10)
    assert_matches_jax(got, want)


@pytest.mark.parametrize("hetero", [False, True])
def test_hook_matches_jax_hook(hetero):
    """The fused client-step hook on both sides (the port's plain version
    on the CPU, the JAX Pallas kernel in interpret mode)."""
    jopt, topt = opts("fedmom")
    hf = _hetero if hetero else None
    want = run_trajectory(
        "streaming-bucketed", jopt, jax_rcfg(), CLIENTS, 8, hetero_fn=hf,
        client_step_fn=jax_hook(use_kernel=True, interpret=True))
    got = run_torch("streaming-bucketed", topt, rcfg(), CLIENTS, 8,
                    hetero_fn=hf, client_step_fn=linreg_tier_step())
    assert_matches_jax(got, want)
    plain = run_torch("streaming-bucketed", topt, rcfg(), CLIENTS, 8,
                      hetero_fn=hf)
    np.testing.assert_allclose(torch_flat_w(got[1]), torch_flat_w(plain[1]),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["one-occupied-tier", "tiers=1"])
def test_single_tier_bit_equal_to_padded(case):
    """One occupied tier: the same rows in the same order through one
    round_step, so bucketed equals padded bit for bit."""
    _, topt = opts("fedmom")
    if case == "tiers=1":
        clients, kw = CLIENTS, {"cache_tiers": 1}
    else:
        clients, kw = make_clients(n=6, lo=17, hi=31), {}  # all 32-row
    ref = run_torch("streaming", topt, rcfg(), clients, 10, **kw)
    got = run_torch("streaming-bucketed", topt, rcfg(), clients, 10, **kw)
    assert np.array_equal(torch_flat_w(got[1]), torch_flat_w(ref[1]))
    assert [r["loss"] for r in got[0]] == [r["loss"] for r in ref[0]]


def test_bucketed_resume_bit_equal(tmp_path):
    _, topt = opts("fedmom")
    ref = run_torch("streaming-bucketed", topt, rcfg(), CLIENTS, 12,
                    hetero_fn=_hetero)
    got = run_torch("streaming-bucketed", topt, rcfg(), CLIENTS, 12,
                    hetero_fn=_hetero, resume_at=7, tmp_path=tmp_path)
    assert np.array_equal(torch_flat_w(got[1]), torch_flat_w(ref[1]))
    assert [r["round"] for r in got[0]] == list(range(12))


@pytest.mark.parametrize("rc_kw", [{"local_opt": "adam"},
                                   {"compute_dtype": "bfloat16"}],
                         ids=["adam", "bf16"])
def test_hook_refused_where_it_cannot_compute_the_update(rc_kw):
    _, topt = opts("fedavg")
    rc = RoundConfig(3, 4, 0.05, **{"compute_dtype": "float32", **rc_kw})
    tr = make_trainer(topt, rc, CLIENTS, client_step_fn=linreg_tier_step())
    with pytest.raises(PlanError, match="plain-SGD fp32") as err:
        tr.run(2, plan=BUCKETED, verbose=False)
    assert err.value.plane == "streaming"


def test_bucketed_needs_mesh_placement():
    _, topt = opts("fedavg")
    rc = RoundConfig(3, 4, 0.05, placement="scan", compute_dtype="float32")
    with pytest.raises(PlanError, match="placement='mesh'"):
        make_trainer(topt, rc, CLIENTS).run(2, plan=BUCKETED, verbose=False)
