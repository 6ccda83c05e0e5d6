"""Secure aggregation on every plane and lane of the port
(``ExecutionPlan(secure=SecureAggSpec(...))``): the masked trajectory
bit-equal to the open ring's (per-round, scanned, device, the three
streaming lanes and the ``client_step`` hook lane), the masked planes'
parameters bit-equal to each other, masked resume and scenario dropout
recovery bit-equal, masked within quantization of plain, DP composed
with masking, each lane held to the JAX package's masked lane within the
trajectory tolerance, and ``_secure_delta`` on the same client results
bit-equal to the reference's.  The counterpart of
``tests/test_secure_agg.py``'s plane matrix, on the linreg fleet of
``tests/_trajectory.py``, on the CPU."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _trajectory import default_rcfg, make_clients, run_trajectory  # noqa
from _trajectory_torch import (assert_matches_jax, make_trainer,  # noqa
                               plan_for, rcfg, run_torch, strip_events,
                               torch_flat_w)
from repro.core import fedmom as jfedmom  # noqa: E402
from repro.core import round as jround  # noqa: E402
from repro.core.secure_agg import SecureAggSpec as JSpec  # noqa: E402
from repro.kernels.client_step.ops import \
    linreg_tier_step as jax_hook  # noqa: E402
from repro_torch.core import (SecureAggSpec, dp_fedavg, dp_fedmom,  # noqa
                              fedmom)
from repro_torch.core import round as tround  # noqa: E402
from repro_torch.kernels.client_step.ops import linreg_tier_step  # noqa
from repro_torch.launch.plan import ExecutionPlan, PlanError  # noqa: E402

MASKED = SecureAggSpec(masked=True, seed=5)
OPEN = SecureAggSpec(masked=False, seed=5)
ROUNDS, CR = 10, 4
LANES = ("per-round", "scanned", "device", "streaming", "streaming-uniform",
         "streaming-bucketed", "hook")
CLIENTS = make_clients()


def _opt():
    return fedmom(eta=1.0, beta=0.9, use_fused_kernel=True)


def _run(lane, spec=None, opt=None, clients=CLIENTS, n_rounds=ROUNDS,
         **kw):
    """(history, state) of ``lane`` ("hook" is the bucketed streaming lane
    through ``client_step``'s hook) under ``secure=spec``."""
    if lane == "hook":
        lane, kw["client_step_fn"] = "streaming-bucketed", linreg_tier_step()
    if spec is not None:
        kw["secure"] = spec
    return run_torch(lane, opt or _opt(), rcfg(), clients, n_rounds,
                     chunk_rounds=CR, **kw)


def _bits(run):
    hist, state = run
    return ([r["loss"] for r in strip_events(hist)],
            [r["delta_norm"] for r in strip_events(hist)],
            torch_flat_w(state), int(state.t))


def _assert_bitwise(got, want):
    a, b = _bits(got), _bits(want)
    assert a[0] == b[0] and a[1] == b[1] and a[3] == b[3]
    np.testing.assert_array_equal(a[2].view(np.int32), b[2].view(np.int32))


@pytest.mark.parametrize("lane", LANES)
def test_masked_lane_bit_equal_to_open(lane):
    _assert_bitwise(_run(lane, MASKED), _run(lane, OPEN))


def test_masked_planes_bit_equal_cross_plane():
    """Every plane and lane under masking trains the same parameters bit
    for bit, on a fleet whose cohorts span several size tiers: the
    bucketed lanes' tier totals add exactly in the ring.  The loss metric
    is held within fp32 noise (the lanes sum it in other orders)."""
    clients = make_clients(n=10, lo=4, hi=40)
    ref = _run("per-round", MASKED, clients=clients)
    for lane in LANES[1:]:
        got = _run(lane, MASKED, clients=clients)
        np.testing.assert_array_equal(torch_flat_w(got[1]),
                                      torch_flat_w(ref[1]))
        np.testing.assert_allclose([r["loss"] for r in got[0]],
                                   [r["loss"] for r in ref[0]], rtol=1e-6)


@pytest.mark.parametrize("lane", ["device", "streaming-bucketed", "hook"])
def test_masked_resume_bit_equal(tmp_path, lane):
    straight = _run(lane, MASKED)
    resumed = _run(lane, MASKED, resume_at=5, tmp_path=tmp_path)
    _assert_bitwise(resumed, straight)


@pytest.mark.parametrize("lane", LANES)
def test_masked_scenario_dropout_recovery_bit_equal(lane):
    """Scenario dropouts compose with masking: the dropped clients'
    pairwise terms are recovered, and masked == open holds bit for bit on
    every lane."""
    from repro_torch.scenario import ScenarioSpec, UniformDropout
    scen = ScenarioSpec(dropout=UniformDropout(rate=0.4), seed=11)
    got = _run(lane, MASKED, scenario=scen)
    _assert_bitwise(got, _run(lane, OPEN, scenario=scen))
    completed = [r["completed"] for r in strip_events(got[0])]
    assert min(completed) < 3          # the scenario dropped someone


def test_masked_close_to_plain_fp32():
    """Secure against plain differs only by fixed-point quantization."""
    got, want = _run("per-round", MASKED), _run("per-round")
    np.testing.assert_allclose(torch_flat_w(got[1]), torch_flat_w(want[1]),
                               atol=1e-4)
    assert not np.array_equal(torch_flat_w(got[1]), torch_flat_w(want[1]))


@pytest.mark.parametrize("mk", [
    lambda: dp_fedavg(clip=0.5, noise_multiplier=0.3, dp_seed=9),
    lambda: dp_fedmom(clip=0.5, noise_multiplier=0.3, dp_seed=9, eta=1.0,
                      beta=0.9, use_fused_kernel=True)],
    ids=["dp_fedavg", "dp_fedmom"])
def test_dp_composes_with_secure_masking(mk):
    """Masked transport + central clip / noise across the port's planes
    and lanes: the aggregate is ring-exact and the noise a pure (seed, t)
    function, so every plane's parameters equal the per-round plane's bit
    for bit (the reference's own planes miss this by 4.77e-7)."""
    ref = _run("per-round", MASKED, opt=mk(), n_rounds=8)
    w_ref = torch_flat_w(ref[1])
    for lane in LANES[1:]:
        got = _run(lane, MASKED, opt=mk(), n_rounds=8)
        np.testing.assert_array_equal(torch_flat_w(got[1]), w_ref)
    # and the noise is really applied: another DP seed moves the params
    other = _run("per-round", MASKED, n_rounds=8, opt=dp_fedavg(
        clip=0.5, noise_multiplier=0.3, dp_seed=10))
    assert not np.array_equal(torch_flat_w(other[1]), w_ref)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lane", LANES)
def test_masked_lane_matches_jax(lane):
    """Each lane's masked trajectory against the JAX package's masked run
    of the same lane (its hook through the plain reference)."""
    kw = {}
    plane = lane
    if lane == "hook":
        plane, kw["client_step_fn"] = ("streaming-bucketed",
                                       jax_hook(use_kernel=False))
    want = run_trajectory(plane, jfedmom(eta=1.0, beta=0.9), default_rcfg(),
                          CLIENTS, ROUNDS, chunk_rounds=CR,
                          secure=JSpec(masked=True, seed=5), **kw)
    assert_matches_jax(_run(lane, MASKED), want)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [True, False])
def test_secure_delta_bit_equal_to_jax(compute, masked):
    """The same client results (numpy-made ``w_t`` and final ``w^k``)
    through ``_secure_delta`` in both packages, with a dropout: the same
    delta, bit for bit."""
    rng = np.random.default_rng(3)
    C = 6
    w_c = {"w": rng.normal(size=(5, 3)).astype(np.float32),
           "b": rng.normal(size=()).astype(np.float32)}
    final = {k: (v[None] + 0.01 * rng.normal(size=(C,) + v.shape)
                 ).astype(np.float32) for k, v in w_c.items()}
    weights = rng.uniform(0.05, 0.3, size=C).astype(np.float32)
    mask = np.ones((C, 4), np.float32)
    mask[2] = 0
    mask[4, 1:] = 0
    jdt = jnp.dtype(compute)
    tdt = tround.DTYPES[compute]
    t = 7
    want = jround._secure_delta(
        JSpec(masked=masked, seed=5),
        {k: jnp.asarray(v).astype(jdt) for k, v in w_c.items()},
        {k: jnp.asarray(v).astype(jdt) for k, v in final.items()},
        jnp.asarray(weights), jnp.asarray(mask), t, jnp.float32)
    for tt in (t, torch.tensor(t)):
        got = tround._secure_delta(
            dataclasses.replace(MASKED, masked=masked),
            {k: torch.from_numpy(v).to(tdt) for k, v in w_c.items()},
            {k: torch.from_numpy(v).to(tdt) for k, v in final.items()},
            torch.from_numpy(weights), torch.from_numpy(mask), tt,
            torch.float32)
        for k in w_c:
            np.testing.assert_array_equal(
                got[k].numpy().view(np.int32),
                np.asarray(want[k]).view(np.int32))


# ---------------------------------------------------------------------------
# the plan and the trainer
# ---------------------------------------------------------------------------
def test_plan_record_and_placement_match_reference():
    from repro.launch.plan import ExecutionPlan as JPlan
    from repro.launch.plan import PlanError as JPlanError
    tr = make_trainer(_opt(), rcfg(), CLIENTS)
    tr.run(2, plan=ExecutionPlan(plane="device", chunk_rounds=2,
                                 secure=OPEN), verbose=False)
    rec = tr.session.plan_log[-1]
    assert rec["secure"] is True
    assert rec["reason"] == ("explicit plane 'device'; secure aggregation "
                             "(open ring, frac_bits=20)")
    assert tr.rcfg.secure is None            # scoped to the run
    msgs = []
    for plan_cls, err_cls in ((JPlan, JPlanError),
                              (ExecutionPlan, PlanError)):
        with pytest.raises(err_cls) as err:
            plan_cls(plane="scanned", secure=object())
        msgs.append(str(err.value).replace("repro_torch.", "repro."))
    assert msgs[0] == msgs[1] == (
        "secure must be a repro.core.SecureAggSpec, got object")
    scan = make_trainer(_opt(), dataclasses.replace(rcfg(),
                                                    placement="scan"),
                        CLIENTS)
    with pytest.raises(PlanError, match="placement='mesh' only"):
        scan.run(2, plan=ExecutionPlan(plane="per_round", secure=MASKED),
                 verbose=False)
    with pytest.raises(ValueError, match="needs placement='mesh'"):
        tround.round_step(
            tround.RoundConfig, None, None, None, None,
            dataclasses.replace(rcfg(), placement="scan", secure=MASKED))


@pytest.mark.parametrize("plane", ["per-round", "device", "streaming"])
def test_plain_masked_open_plain_on_one_trainer(plane):
    """One trainer run plain, masked, open, then plain again: each run
    equals a fresh trainer's of its spec (the spec is scoped to its run;
    the session's chunk graphs are keyed on it, one for each spec), and
    the plain run differs from the ring's."""
    tr = make_trainer(_opt(), rcfg(), CLIENTS)
    init = tr.state
    outs = []
    for spec in (None, MASKED, OPEN, None):
        tr.state, tr.history = init, []
        outs.append(_bits((tr.run(6, plan=plan_for(plane, CR, secure=spec),
                                  verbose=False), tr.state)))
        assert tr.rcfg.secure is None
        fresh = _bits(_run(plane, spec, n_rounds=6))
        assert outs[-1][0] == fresh[0] and outs[-1][3] == fresh[3]
        np.testing.assert_array_equal(outs[-1][2], fresh[2])
    assert outs[0][0] == outs[3][0] and outs[1][0] == outs[2][0]
    assert not np.array_equal(outs[0][2], outs[1][2])
    if plane == "device":
        specs = {k[-2].secure for k in tr.session.graphs}
        assert specs == {None, MASKED, OPEN}
