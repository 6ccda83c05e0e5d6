"""Client scheduling: uniform sampling of S_t (paper setting) plus a diurnal
participation schedule (a time-varying M).

Two sampling paths with the semantics of the JAX package's
``core/sampling.py``:

* **host** (``sample(t)``): numpy, called from the Python round loop;
* **keyed** (``sample_device(key, t)``): threefry draws from
  ``repro_torch.random``, bit-equal to the reference's ``jax.random`` draw,
  keyed by ``(key, t)`` alone.

The stateful ``UniformSampler`` / ``DiurnalSampler`` host ``sample``
consumes a sequential numpy RNG stream, while ``sample_device`` is keyed by
``(key, t)`` — same distribution, different draws.  The ``Device*``
samplers' host path *replays* the keyed draw exactly, so a run that
resumes from a checkpoint samples the same cohorts as an uninterrupted one.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Protocol, Tuple, runtime_checkable

import numpy as np
import torch

from repro_torch import random as prng


@runtime_checkable
class DeviceSampleable(Protocol):
    """Capability: S_t has a keyed draw ``sample_device(key, t)`` that
    depends on ``(key, t)`` alone.  The host ``sample(t)`` need not replay
    it — see ``KeyedReplayable`` for that stronger contract."""

    def sample(self, t: int = 0) -> Tuple[np.ndarray, np.ndarray]: ...

    def sample_device(self, key, t): ...


@runtime_checkable
class KeyedReplayable(DeviceSampleable, Protocol):
    """Capability: the host path replays the keyed draw exactly.

    ``base_key()`` exposes the draw key and ``sample(t)`` must equal
    ``sample_device(base_key(), t)`` — draws depend only on ``(seed, t)``,
    never on sequential host RNG state, which is what makes resumed runs
    equal to uninterrupted ones.  ``Device*`` samplers provide it; the
    stateful ``UniformSampler`` / ``DiurnalSampler`` deliberately do not.
    """

    def base_key(self): ...


def diurnal_m_host(t: int, m_min: int, m_max: int, period: int) -> int:
    """Sinusoidal M(t) between m_min and m_max (host path, float64 math)."""
    frac = 0.5 * (1 + math.sin(2 * math.pi * t / period))
    return int(round(m_min + frac * (m_max - m_min)))


def diurnal_m_device(t, m_min: int, m_max: int, period: int):
    """M(t) in float32, as the keyed draw of the reference computes it
    (it can differ from ``diurnal_m_host`` by one client at a rounding
    boundary, which is why the engine treats M(t) as a weight mask).

    For an int ``t`` the host int; for a tensor ``t`` a 0-d int64 tensor
    computed on ``t``'s device, so that a captured CUDA graph follows the
    round index it is replayed at."""
    on_device = isinstance(t, torch.Tensor)
    tt = (t.to(torch.float32) if on_device
          else torch.tensor(float(t), dtype=torch.float32))
    frac = 0.5 * (1.0 + torch.sin(2.0 * math.pi * tt / period))
    m_t = torch.round(m_min + frac * (m_max - m_min))
    return m_t.to(torch.int64) if on_device else int(m_t)


@dataclass
class ClientPopulation:
    """K clients with sample counts n_k (unbalanced, non-IID per the data
    partitioner)."""
    counts: np.ndarray                     # [K] int

    @property
    def n_clients(self) -> int:
        return len(self.counts)

    @property
    def weights(self) -> np.ndarray:       # n_k / n
        return self.counts / self.counts.sum()


def _weight_table(sampler, device) -> torch.Tensor:
    """The [K] float32 n_k/n table on ``device``, copied there once per
    device and kept: a keyed draw inside a captured CUDA graph may not copy
    from the host (the first draw, eager, fills the cache)."""
    tab = sampler._weights.get(device)
    if tab is None:
        tab = sampler._weights[device] = torch.as_tensor(
            sampler.population.weights.astype(np.float32), device=device)
    return tab


@dataclass
class UniformSampler:
    """S_t = a uniformly random set of M clients (paper §3.1)."""
    population: ClientPopulation
    m: int
    seed: int = 0
    _rng: np.random.Generator = field(init=False, repr=False, default=None)
    _weights: dict = field(init=False, repr=False, compare=False,
                           default_factory=dict)

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    @property
    def lowered_clients(self) -> int:
        """Client extent C the round engine runs (= M)."""
        return self.m

    def sample(self, t: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        idx = self._rng.choice(self.population.n_clients, size=self.m,
                               replace=False)
        return idx, self.population.weights[idx].astype(np.float32)

    def sample_device(self, key, t):
        """Keyed S_t draw: fold the round index into ``key`` and take the
        first M entries of a permutation of [0, K).  ``t`` is an int or an
        int64 tensor on the key's device (inside a captured chunk)."""
        kt = prng.fold_in(key, t)
        idx = prng.permutation(kt, self.population.n_clients)[: self.m]
        return idx, _weight_table(self, idx.device)[idx.long()]


class _DeviceReplayMixin:
    """Host path = replay of ``sample_device(PRNGKey(seed), t)``."""

    def base_key(self):
        return prng.PRNGKey(self.seed)

    def sample(self, t: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        idx, w = self.sample_device(self.base_key(), t)
        return idx.cpu().numpy(), w.cpu().numpy().astype(np.float32)


@dataclass
class DeviceUniformSampler(_DeviceReplayMixin, UniformSampler):
    """Uniform sampler with the host-replays-keyed-draw contract."""


@dataclass
class DiurnalSampler:
    """Time-varying participation: M(t) swings sinusoidally between
    m_min and m_max with the given period (in rounds).  The round engine
    runs m_max slots; inactive slots get zero weight, which the
    biased-gradient aggregation handles natively (w^k = w_t contributes 0)."""
    population: ClientPopulation
    m_min: int
    m_max: int
    period: int = 1000
    seed: int = 0
    _rng: np.random.Generator = field(init=False, repr=False, default=None)
    _weights: dict = field(init=False, repr=False, compare=False,
                           default_factory=dict)

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    @property
    def lowered_clients(self) -> int:
        """Padded client extent C: m_max slots, zero-weight inactive tail."""
        return self.m_max

    def m_at(self, t: int) -> int:
        return diurnal_m_host(t, self.m_min, self.m_max, self.period)

    def sample(self, t: int) -> Tuple[np.ndarray, np.ndarray]:
        m_t = self.m_at(t)
        idx = self._rng.choice(self.population.n_clients, size=self.m_max,
                               replace=False)
        w = self.population.weights[idx].astype(np.float32)
        w[m_t:] = 0.0                      # padded slots contribute nothing
        return idx, w

    def sample_device(self, key, t):
        """Keyed diurnal draw: m_max slots, the tail past M(t) zeroed.
        Does NOT replay the stateful host ``sample``; use
        ``DeviceDiurnalSampler`` when host batch assembly must match."""
        kt = prng.fold_in(key, t)
        idx = prng.permutation(kt, self.population.n_clients)[: self.m_max]
        m_t = diurnal_m_device(t, self.m_min, self.m_max, self.period)
        w = _weight_table(self, idx.device)[idx.long()]
        w = torch.where(torch.arange(self.m_max, device=idx.device) < m_t,
                        w, torch.zeros_like(w))
        return idx, w


@dataclass
class DeviceDiurnalSampler(_DeviceReplayMixin, DiurnalSampler):
    """Diurnal sampler with the host-replays-keyed-draw contract."""


def participants_in_span(sampler, t_lo: int, t_hi: int,
                         dedup: bool = True) -> list:
    """Client ids drawn in rounds [t_lo, t_hi), via the host replay.

    Requires a ``KeyedReplayable`` sampler (a stateful one would peek a
    different client set than the run then draws).  With ``dedup=True``
    each id appears once, in first-appearance order; ``dedup=False``
    returns the raw round-by-round sequence.  Padded diurnal slots are
    included.
    """
    if not isinstance(sampler, KeyedReplayable):
        raise ValueError(
            "participants_in_span needs the KeyedReplayable capability — a "
            "keyed Device* sampler whose host sample REPLAYS the "
            "(seed, t)-keyed draw (base_key + sample_device, e.g. "
            "DeviceUniformSampler): a stateful host sampler would peek a "
            "different client set than the run then draws")
    seen: dict = {}
    raw: list = []
    for t in range(t_lo, t_hi):
        idx, _ = sampler.sample(t)
        for c in np.asarray(idx).tolist():
            raw.append(int(c))
            seen.setdefault(int(c), None)
    return list(seen) if dedup else raw
