"""Client-lifecycle models: who finishes how much of round t's local work.

The port of the JAX package's ``scenario/lifecycle.py``, kept in host
numpy with uint64 wrap-around: the keyed hash is the reference's bit for
bit, so both packages stage the same fates for the same
``(seed, tag, t, client_id)`` (torch has no uint64 arithmetic to move it
to).

Production FL rounds are lossy (Bonawitz et al. 2019): devices drop
mid-round when they lose connectivity or charge, and slow devices miss the
round deadline after completing only part of the local epoch.  The paper's
eq. (3) aggregation is EXACTLY the partial-work weighting this calls for —
a client that completed h < H local steps contributes its h-step model, and
a client that completed none contributes w^k = w_t, i.e. zero delta — and
the round engine already carries the machinery as ``step_mask`` / ``eff_w``
(``core/round.py``).  A lifecycle model therefore never touches the engine:
it maps ``(seed, t, client_ids)`` to a [C] vector of COMPLETED-STEP CAPS in
[0, H], and the trainer compiles those caps into the prefix step masks every
plane already consumes.

Determinism contract (the same one the minibatch draws obey): every draw is
a pure function of ``(seed, tag, t, client_id)`` through a counter-free
splitmix64-style hash — no sequential RNG state anywhere.  Rounds can be
staged out of order (the streaming prefetch does), chunks can be replayed
after a resume, and two planes staging the same round always see the same
fates.  All draws are vectorized numpy over the cohort (the scenario layer
must keep up with corpora of millions of clients).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Protocol, runtime_checkable

import numpy as np

_U64 = np.uint64


def _fnv1a(tag: str) -> np.uint64:
    """FNV-1a of a tag string — stable across runs/platforms (unlike
    ``hash``), cheap, and only used to separate draw streams."""
    h = 0xCBF29CE484222325
    for b in tag.encode():
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return _U64(h)


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer (Steele et al.): a bijective avalanche on
    uint64, applied elementwise.  Successive ``_mix64(h ^ k)`` rounds build
    a keyed hash whose streams for different (tag, t, cid) are independent
    for scenario purposes."""
    with np.errstate(over="ignore"):
        x = np.asarray(x, _U64) + _U64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> _U64(27))) * _U64(0x94D049BB133111EB)
        return x ^ (x >> _U64(31))


def keyed_u64(seed: int, tag: str, t: int, cids) -> np.ndarray:
    """[C] uint64 hash words keyed by ``(seed, tag, t, client_id)``."""
    h = _mix64(_U64(np.uint64(seed & 0xFFFFFFFFFFFFFFFF)) ^ _fnv1a(tag))
    h = _mix64(h ^ _U64(np.uint64(t & 0xFFFFFFFFFFFFFFFF)))
    return _mix64(h ^ np.asarray(cids, _U64))


def keyed_uniforms(seed: int, tag: str, t: int, cids) -> np.ndarray:
    """[C] float64 uniforms in [0, 1) keyed by ``(seed, tag, t, cid)``."""
    return (keyed_u64(seed, tag, t, cids) >> _U64(11)) * (2.0 ** -53)


def keyed_normals(seed: int, tag: str, t: int, cids) -> np.ndarray:
    """[C] float64 standard normals (Box–Muller over two keyed uniform
    streams; u1 clamped away from 0 so the log is finite)."""
    u1 = np.maximum(keyed_uniforms(seed, tag + "/bm0", t, cids), 2.0 ** -53)
    u2 = keyed_uniforms(seed, tag + "/bm1", t, cids)
    return np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u2)


@runtime_checkable
class LifecycleModel(Protocol):
    """Capability: per-round completed-step caps for a cohort.

    ``step_caps(seed, t, client_ids, local_steps)`` returns [C] int32 caps
    in [0, local_steps]: how many of the H local steps each client finishes
    before its round ends (H = finished everything, 0 = contributed
    nothing; eq. (3) weights the rest).  Must be a pure function of the
    arguments — the runtime composes several models by elementwise min and
    replays rounds freely (prefetch, resume).
    """

    def step_caps(self, seed: int, t: int, client_ids,
                  local_steps: int) -> np.ndarray: ...


@dataclass(frozen=True)
class UniformDropout:
    """I.i.d. mid-round dropout: each participant independently drops this
    round with probability ``rate``; a dropped client completes a uniform
    number of steps in [0, H) before vanishing (connectivity loss is
    oblivious to training progress).  ``rate=0`` is the identity model."""
    rate: float

    def __post_init__(self):
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"dropout rate must be in [0, 1], "
                             f"got {self.rate!r}")

    def step_caps(self, seed, t, client_ids, local_steps):
        dropped = keyed_uniforms(seed, "drop", t, client_ids) < self.rate
        done = np.floor(keyed_uniforms(seed, "drop/when", t, client_ids)
                        * local_steps).astype(np.int32)
        return np.where(dropped, done, np.int32(local_steps)).astype(np.int32)


@dataclass(frozen=True)
class PerClientDropout:
    """Heterogeneous device reliability: each CLIENT has a fixed dropout
    rate drawn once from a Kumaraswamy(a, b) law scaled by ``scale``
    (keyed by client id only, so a flaky device is flaky in every round it
    participates — the realistic correlation i.i.d. dropout misses).  The
    defaults (a=0.6, b=3.0) give the long-tailed fleet shape: most devices
    reliable, a small tail dropping most rounds."""
    scale: float = 1.0
    a: float = 0.6
    b: float = 3.0

    def __post_init__(self):
        if not 0.0 <= self.scale <= 1.0:
            raise ValueError(f"scale must be in [0, 1], got {self.scale!r}")
        if self.a <= 0 or self.b <= 0:
            raise ValueError("Kumaraswamy shapes a, b must be > 0")

    def client_rates(self, seed: int, client_ids) -> np.ndarray:
        """[C] per-client dropout rates (time-invariant; Kumaraswamy icdf
        ``(1 - (1 - u)^(1/b))^(1/a)`` over a keyed uniform)."""
        u = keyed_uniforms(seed, "rate", 0, client_ids)
        return self.scale * (1.0 - (1.0 - u) ** (1.0 / self.b)) \
            ** (1.0 / self.a)

    def step_caps(self, seed, t, client_ids, local_steps):
        rates = self.client_rates(seed, client_ids)
        dropped = keyed_uniforms(seed, "drop", t, client_ids) < rates
        done = np.floor(keyed_uniforms(seed, "drop/when", t, client_ids)
                        * local_steps).astype(np.int32)
        return np.where(dropped, done, np.int32(local_steps)).astype(np.int32)


@dataclass(frozen=True)
class LatencyStragglers:
    """Round-deadline stragglers: each client's per-step latency is
    lognormal around ``mean_step_s`` with a stable per-DEVICE speed factor
    (keyed by client id — a slow phone is slow every round) plus per-round
    jitter; the client completes ``floor(deadline / step_s)`` local steps
    before the server closes the round.  A device slower than
    ``deadline / H`` per step contributes partial work under eq. (3); one
    slower than ``deadline`` contributes nothing (w^k = w_t)."""
    deadline_s: float
    mean_step_s: float = 1.0
    sigma: float = 0.5      # lognormal spread of the stable device speed
    jitter: float = 0.1     # lognormal spread of the per-round jitter

    def __post_init__(self):
        if self.deadline_s <= 0 or self.mean_step_s <= 0:
            raise ValueError("deadline_s and mean_step_s must be > 0")
        if self.sigma < 0 or self.jitter < 0:
            raise ValueError("sigma and jitter must be >= 0")

    def step_times(self, seed: int, t: int, client_ids) -> np.ndarray:
        """[C] per-step latencies (seconds) for round ``t``."""
        z_dev = keyed_normals(seed, "lat", 0, client_ids)
        z_rnd = keyed_normals(seed, "lat/jit", t, client_ids)
        return self.mean_step_s * np.exp(self.sigma * z_dev
                                         + self.jitter * z_rnd)

    def step_caps(self, seed, t, client_ids, local_steps):
        done = np.floor(self.deadline_s / self.step_times(seed, t,
                                                          client_ids))
        return np.clip(done, 0, local_steps).astype(np.int32)
