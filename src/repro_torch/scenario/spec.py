"""ScenarioSpec — the declarative scenario surface on ``ExecutionPlan``.

The port of the JAX package's ``scenario/spec.py``: the same host numpy
runtime, so both packages compile the same caps into the same masks.

A scenario composes lifecycle models (``UniformDropout`` /
``PerClientDropout`` / ``LatencyStragglers``), an availability schedule
(``AvailabilityModel``) and adaptive cohort sizing (``AdaptiveCohort``)
into per-round completed-step caps, which the trainer compiles into the
prefix ``step_mask``s every execution plane already consumes — the engine
itself never learns what a dropout is, it just runs eq. (3) partial-work
aggregation over the masks.  ``ScenarioSpec(...)`` on a plan is therefore
plane-agnostic: per_round, scanned, device, streaming and bucketed
streaming all execute the identical scenario, and
``ScenarioSpec() == no models`` is bit-equal to no scenario at all.

Determinism: the stateless parts (dropouts, stragglers, availability) are
keyed by ``(scenario seed, tag, t, client_id)`` and can be staged in any
order.  Adaptive cohort sizing is the one SEQUENTIAL piece — m_{t+1}
reacts to round t's observed completion — so the runtime enforces
monotone staging when it is enabled and rebuilds the EMA state for a
resume by replaying rounds [0, t0) on the host (``warmup``; cheap: pure
keyed hashing, no device work).  Completion is "observed" from the caps at
STAGING time, which makes the adaptive trajectory a pure function of the
config — bit-reproducible and resumable like everything else.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from repro_torch.scenario.availability import AvailabilityModel
from repro_torch.scenario.lifecycle import LifecycleModel


@dataclass(frozen=True)
class AdaptiveCohort:
    """React to observed completion: aim for ``goal`` COMPLETED clients per
    round by activating ``m_t = clamp(ceil(goal / rate_ema), m_min, C)``
    cohort slots, where ``rate_ema`` is an exponential moving average of
    the fraction of active clients that finished any work (cap > 0).  When
    dropouts spike, the cohort grows to compensate — the over-selection
    strategy production FL servers run (Bonawitz et al. 2019 §2.2).
    """
    goal: int
    m_min: int = 1
    ema: float = 0.3

    def __post_init__(self):
        if self.goal < 1:
            raise ValueError(f"goal must be >= 1, got {self.goal!r}")
        if self.m_min < 1:
            raise ValueError(f"m_min must be >= 1, got {self.m_min!r}")
        if not 0.0 < self.ema <= 1.0:
            raise ValueError(f"ema must be in (0, 1], got {self.ema!r}")


@dataclass(frozen=True)
class ScenarioSpec:
    """What the simulated fleet does to round t (see module docstring).

    ``dropout`` / ``stragglers`` are both ``LifecycleModel``s (the split is
    purely mnemonic; ``extra`` takes any further models) — all compose by
    elementwise min of their step caps.  ``availability`` masks cohort
    slots past M(t); ``cohort`` adaptively shrinks/grows the active slot
    count toward a completed-clients goal.  ``trace`` replays a RECORDED
    fleet log (``repro_torch.traces.TraceSpec``) instead of — or composed by
    min with — the synthetic models.  ``seed`` keys every scenario draw,
    independent of the data/sampler seeds (a trace ignores it: a recorded
    log has no randomness left).
    """
    dropout: Optional[LifecycleModel] = None
    stragglers: Optional[LifecycleModel] = None
    extra: Tuple[LifecycleModel, ...] = ()
    availability: Optional[AvailabilityModel] = None
    cohort: Optional[AdaptiveCohort] = None
    trace: Optional["TraceSpec"] = None   # repro_torch.traces.TraceSpec
    seed: int = 0

    def __post_init__(self):
        if self.trace is not None:
            from repro_torch.traces.replay import TraceSpec

            if not isinstance(self.trace, TraceSpec):
                raise TypeError(
                    f"trace must be a repro_torch.traces.TraceSpec, got "
                    f"{type(self.trace).__name__}")
        for m in self.models:
            if not isinstance(m, LifecycleModel):
                raise TypeError(
                    f"lifecycle models must implement step_caps(seed, t, "
                    f"client_ids, local_steps); {type(m).__name__} does not")
        if self.availability is not None \
                and not isinstance(self.availability, AvailabilityModel):
            raise TypeError(
                f"availability must implement AvailabilityModel (peak, "
                f"m_at, m_device); {type(self.availability).__name__} "
                f"does not")

    @property
    def models(self) -> Tuple[LifecycleModel, ...]:
        out = tuple(m for m in (self.dropout, self.stragglers)
                    if m is not None) + tuple(self.extra)
        if self.trace is not None:
            out += (self.trace.replay(),)
        return out

    @property
    def null(self) -> bool:
        """True when the scenario constrains nothing — the runtime then
        emits no masks at all, keeping the plane bit-equal to scenario-off
        (not merely equivalent)."""
        return (not self.models and self.availability is None
                and self.cohort is None)

    @property
    def stateful(self) -> bool:
        """True when staging must be monotone in t (adaptive cohort)."""
        return self.cohort is not None


class ScenarioRuntime:
    """Host-side evaluator: ``ScenarioSpec`` -> per-round step caps/masks.

    One instance per ``run()`` invocation (created by the trainer at plan
    resolution; cheap).  ``steps_for(t, cids)`` is the single entry point:
    [C] int32 completed-step caps in [0, H], composed as

        min over lifecycle models, then slots past m_t zeroed where
        ``m_t = min(availability.m_at(t), adaptive m_t)``.

    With an ``AdaptiveCohort``, calls must be monotone in t (each round
    observed exactly once, in order) — the trainer stages rounds in order on
    every plane; ``warmup(t0, sampler)`` replays rounds [0, t0) to rebuild
    the EMA state before a resume.  Without one, the runtime is stateless
    and rounds may be staged in any order (the prefetch path does).
    """

    def __init__(self, spec: ScenarioSpec, local_steps: int):
        if local_steps < 1:
            raise ValueError(f"local_steps must be >= 1, got {local_steps!r}")
        self.spec = spec
        self.local_steps = int(local_steps)
        self._rate_ema = 1.0
        self._next_t = 0
        # the applied slot cutoff of the last staged round (what
        # traces.TraceRecorder logs as the trace's per-round m[t])
        self.last_m: Optional[int] = None

    def _adaptive_m(self, n_slots: int) -> int:
        c = self.spec.cohort
        want = math.ceil(c.goal / max(self._rate_ema, 1e-3))
        return min(n_slots, max(c.m_min, want))

    def steps_for(self, t: int, client_ids) -> np.ndarray:
        """[C] completed-step caps for round ``t``'s cohort slots (in
        sampler slot order — slot masking must hit the same padded tail
        the samplers zero-weight)."""
        cids = np.asarray(client_ids)
        n = len(cids)
        spec = self.spec
        if spec.stateful and t != self._next_t:
            raise RuntimeError(
                f"adaptive-cohort scenarios must observe rounds in order: "
                f"expected round {self._next_t}, got {t} (resume should "
                f"warmup(t0) first; prefetch must not stage ahead of "
                f"observation)")
        caps = np.full(n, self.local_steps, np.int32)
        for model in spec.models:
            caps = np.minimum(caps, np.asarray(
                model.step_caps(spec.seed, t, cids, self.local_steps),
                np.int32))
        m_t = n
        if spec.availability is not None:
            m_t = min(m_t, spec.availability.m_at(t))
        if spec.cohort is not None:
            m_t = min(m_t, self._adaptive_m(n))
        self.last_m = int(m_t)
        caps[m_t:] = 0
        if spec.cohort is not None:
            active = max(m_t, 1)
            rate = float((caps[:active] > 0).sum()) / active
            a = spec.cohort.ema
            self._rate_ema = (1.0 - a) * self._rate_ema + a * rate
            self._next_t = t + 1
        return caps

    def masks_for(self, t: int, client_ids,
                  dtype=np.float32) -> np.ndarray:
        """[C, H] prefix step masks (``mask[i, s] = s < caps[i]``) — the
        exact shape/dtype ``round_step``'s ``step_mask`` takes."""
        caps = self.steps_for(t, client_ids)
        return (np.arange(self.local_steps)[None, :]
                < caps[:, None]).astype(dtype)

    def warmup(self, t0: int, sampler) -> None:
        """Rebuild sequential state for a resume at round ``t0`` by
        replaying rounds [_next_t, t0) through the sampler's host replay.
        No-op for stateless scenarios (pure keyed draws need no history)."""
        if not self.spec.stateful:
            self._next_t = max(self._next_t, int(t0))
            return
        for t in range(self._next_t, int(t0)):
            idx, _ = sampler.sample(t)
            self.steps_for(t, idx)
