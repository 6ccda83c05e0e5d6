"""Client availability schedules: how many devices CAN participate at t.

The port of the JAX package's ``scenario/availability.py``.  An
``AvailabilityModel`` gives a host ``m_at(t)`` (the scenario runtime masks
cohort slots past it), a ``m_device(t)`` twin and a ``peak`` bound the
engine runs its client extent at.  Availability is always applied as a
WEIGHT/STEP mask over a ``peak``-sized cohort, never a shape, so a chunk's
captured CUDA graph keeps its shapes while M(t) swings.

``m_device(t)`` takes ``t`` as an int (a host int back) or as an int64
tensor on the device (a tensor back, on that device): inside a captured
chunk the round is ``t0 + r`` on the card, and nothing may be copied from
the host there.  A constant cutoff is a fill on ``t``'s device; a table
(``traces.TraceAvailability``) is copied to a device once and kept.

``ScenarioSampler`` packages any model as a ``KeyedReplayable`` sampler
(``DeviceDiurnalSampler`` generalized to arbitrary schedules).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Protocol, Tuple, runtime_checkable

import torch

from repro_torch import random as prng
from repro_torch.core.sampling import (ClientPopulation, _DeviceReplayMixin,
                                       _weight_table, active_slots,
                                       diurnal_m_device, diurnal_m_host)


@runtime_checkable
class AvailabilityModel(Protocol):
    """Capability: a time-varying available-device count M(t).

    ``m_at(t)`` is the host truth (the scenario runtime uses it to mask
    cohort slots); ``m_device(t)`` takes ``t`` as an int or an int64 device
    tensor and agrees with ``m_at`` (up to the float32 rounding caveat of
    the diurnal schedule); ``peak`` bounds ``m_at`` over all t — it is the
    client extent the engine runs.
    """

    @property
    def peak(self) -> int: ...

    def m_at(self, t: int) -> int: ...

    def m_device(self, t): ...


def _min(a, b):
    return torch.minimum(a, b) if isinstance(a, torch.Tensor) else min(a, b)


@dataclass(frozen=True)
class ConstantAvailability:
    """A flat fleet: M(t) = m."""
    m: int

    def __post_init__(self):
        if self.m < 1:
            raise ValueError(f"m must be >= 1, got {self.m!r}")

    @property
    def peak(self) -> int:
        return self.m

    def m_at(self, t: int) -> int:
        return self.m

    def m_device(self, t):
        """``m``: a host int for an int ``t``, else filled on ``t``'s
        device in ``t``'s shape (no copy from the host)."""
        if isinstance(t, torch.Tensor):
            return torch.full_like(t, self.m, dtype=torch.int64)
        return self.m


@dataclass(frozen=True)
class DiurnalAvailability:
    """The sinusoidal daily cycle ``DiurnalSampler`` hard-codes, as a
    composable model with the same numerics (the shared ``diurnal_m_*``
    helpers of ``core.sampling``)."""
    m_min: int
    m_max: int
    period: int = 1000

    def __post_init__(self):
        if not 1 <= self.m_min <= self.m_max:
            raise ValueError(
                f"need 1 <= m_min <= m_max, got ({self.m_min}, {self.m_max})")
        if self.period < 1:
            raise ValueError(f"period must be >= 1, got {self.period!r}")

    @property
    def peak(self) -> int:
        return self.m_max

    def m_at(self, t: int) -> int:
        return diurnal_m_host(t, self.m_min, self.m_max, self.period)

    def m_device(self, t):
        return diurnal_m_device(t, self.m_min, self.m_max, self.period)


@dataclass(frozen=True)
class MinAvailability:
    """Composition by elementwise min: available devices must satisfy EVERY
    constituent constraint.  ``peak`` is the min of the parts' peaks — a
    bound, tight whenever the parts peak at a common t."""
    models: Tuple[AvailabilityModel, ...]

    def __post_init__(self):
        if not self.models:
            raise ValueError("MinAvailability needs at least one model")

    @property
    def peak(self) -> int:
        return min(m.peak for m in self.models)

    def m_at(self, t: int) -> int:
        return min(m.m_at(t) for m in self.models)

    def m_device(self, t):
        out = self.models[0].m_device(t)
        for m in self.models[1:]:
            out = _min(out, m.m_device(t))
        return out


@dataclass
class ScenarioSampler(_DeviceReplayMixin):
    """Any ``AvailabilityModel`` as a ``KeyedReplayable`` cohort sampler.

    The engine runs ``peak`` client slots; round t draws a keyed
    permutation (exactly ``DeviceUniformSampler``'s draw) and zero-weights
    the slots past ``M(t)``.  The host ``sample`` replays the keyed draw bit
    for bit, so the fused planes, the streaming lookahead and
    ``resume=True`` work unchanged.
    """
    population: ClientPopulation
    availability: AvailabilityModel
    seed: int = 0
    _weights: dict = field(init=False, repr=False, compare=False,
                           default_factory=dict)

    def __post_init__(self):
        if not isinstance(self.availability, AvailabilityModel):
            raise TypeError(
                f"availability must implement AvailabilityModel (peak, "
                f"m_at, m_device); {type(self.availability).__name__} "
                f"does not")
        if self.availability.peak > self.population.n_clients:
            raise ValueError(
                f"availability peaks at {self.availability.peak} devices "
                f"but the population has {self.population.n_clients} "
                f"clients")

    @property
    def lowered_clients(self) -> int:
        """Padded client extent C (= the schedule's peak; inactive slots
        carry zero weight)."""
        return self.availability.peak

    def sample_device(self, key, t):
        """Keyed draw of ``peak`` slots, the tail past M(t) zero-weighted;
        ``t`` an int or an int64 tensor on the key's device (a tensor of R
        rounds gives [R, peak] draws)."""
        peak = self.availability.peak
        kt = prng.fold_in(key, t)
        idx = prng.permutation(kt, self.population.n_clients)[..., :peak]
        m_t = self.availability.m_device(t)
        w = _weight_table(self, idx.device)[idx.long()]
        w = torch.where(active_slots(peak, m_t, idx.device), w,
                        torch.zeros_like(w))
        return idx, w
