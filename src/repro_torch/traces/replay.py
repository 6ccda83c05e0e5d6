"""Trace playback: a recorded ``FleetTrace`` as scenario models.

The port of the JAX package's ``traces/replay.py``.  ``TraceAvailability``
keeps its [T] cutoff table on each device it is asked about (copied there
at the first call, which a chunk's warm-up makes before its capture), so
``m_device`` inside a captured CUDA graph is an index, never a host copy.

``TraceReplay`` implements the lifecycle ``step_caps()`` protocol and
``TraceAvailability`` the ``AvailabilityModel`` protocol, so a recorded
trace flows through the exact eq. (3) ``step_mask`` machinery every
execution plane already consumes — the engine never learns it is replaying
a log instead of sampling a distribution.  Both are PURE functions of the
trace (no sequential state), so rounds may be staged out of order (the
streaming prefetch does), chunks replayed after a resume, and every plane
sees the same caps: the properties that make record -> replay round-trips
bit-equal to the originating run.

Out-of-range rounds are governed by one explicit, shared policy:

* ``"raise"`` (default) — replaying past the recorded horizon is an error;
* ``"wrap"``  — ``t % n_rounds`` (periodic playback, e.g. looping a
  recorded day over a longer run);
* ``"clamp"`` — hold the last recorded round.

``TraceSpec`` is the declarative form threaded through ``ScenarioSpec``:
``ScenarioSpec(trace=TraceSpec(path=...))`` replays a trace from disk,
``TraceSpec(trace=fleet_trace)`` an in-memory one.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.traces.fleet import FleetTrace

POLICIES = ("raise", "wrap", "clamp")


def _check_policy(policy: str) -> str:
    if policy not in POLICIES:
        raise ValueError(
            f"out-of-range policy must be one of {POLICIES}, "
            f"got {policy!r}")
    return policy


def _resolve_t(t: int, n_rounds: int, policy: str) -> int:
    """Map a requested round onto the recorded horizon [0, n_rounds)."""
    if n_rounds < 1:
        raise ValueError("cannot replay an empty trace (n_rounds = 0)")
    if 0 <= t < n_rounds:
        return t
    if policy == "wrap":
        return t % n_rounds
    if policy == "clamp":
        return min(max(t, 0), n_rounds - 1)
    raise IndexError(
        f"round {t} outside recorded trace [0, {n_rounds}) and "
        f"policy='raise'; pass policy='wrap' or 'clamp' to replay past "
        f"the recorded horizon")


class TraceReplay:
    """``LifecycleModel`` that replays recorded completed-step caps.

    ``step_caps(seed, t, client_ids, local_steps)``: clients with a
    recorded event in round t get their recorded cap; a recorded-COMPLETE
    client (cap == the trace's H) maps to the replay's ``local_steps``
    (it finished everything, however long the epoch is now), a partial cap
    is clipped to ``local_steps``.  Clients absent from the round's events
    default to FULL work (``local_steps``) — a trace recorded over one
    cohort composes with a larger population without zeroing strangers.
    ``seed`` is ignored: a trace has no randomness left.

    The recorded caps already embed the recording run's availability and
    adaptive-cohort masking (``ScenarioRuntime.steps_for`` zeroes slots
    past m_t BEFORE the recorder sees the caps), so replaying through this
    model alone — with the same keyed sampler — reproduces the originating
    masks bit for bit on every plane.
    """

    def __init__(self, trace: FleetTrace, policy: str = "raise"):
        if not isinstance(trace, FleetTrace):
            raise TypeError(
                f"trace must be a FleetTrace, got {type(trace).__name__}")
        if trace.n_rounds < 1:
            raise ValueError(
                "cannot replay an empty trace (n_rounds = 0): record at "
                "least one round")
        self.trace = trace
        self.policy = _check_policy(policy)

    def step_caps(self, seed, t, client_ids, local_steps):
        tr = self.trace
        r = _resolve_t(int(t), tr.n_rounds, self.policy)
        cids = np.asarray(client_ids, np.int64)
        caps = np.full(len(cids), int(local_steps), np.int32)
        lo, hi = int(tr.row_splits[r]), int(tr.row_splits[r + 1])
        if hi > lo:
            ev_c = tr.ev_client[lo:hi]
            pos = np.searchsorted(ev_c, cids)
            safe = np.minimum(pos, hi - lo - 1)
            hit = (pos < hi - lo) & (ev_c[safe] == cids)
            rec = tr.ev_steps[lo:hi][safe]
            replayed = np.where(rec >= tr.local_steps,
                                np.int32(local_steps),
                                np.minimum(rec, np.int32(local_steps)))
            caps = np.where(hit, replayed, caps).astype(np.int32)
        return caps


class TraceAvailability:
    """``AvailabilityModel`` that replays the recorded per-round device
    cutoff M(t) = trace.m[t].

    ``peak`` is the exact max over recorded rounds (the extent an engine
    lowers for); ``m_at`` honors the shared out-of-range policy on host.
    ``m_device`` must stay traceable with ``t`` a tracer, where raising is
    impossible — under ``policy='raise'`` it CLAMPS the index instead (the
    scenario runtime only consults the host ``m_at``, which does raise;
    the device twin is for ``ScenarioSampler``-style cohort masking, where
    an out-of-horizon round has already been rejected on host).
    """

    def __init__(self, trace: FleetTrace, policy: str = "raise"):
        if not isinstance(trace, FleetTrace):
            raise TypeError(
                f"trace must be a FleetTrace, got {type(trace).__name__}")
        if trace.n_rounds < 1:
            raise ValueError(
                "cannot replay availability from an empty trace "
                "(n_rounds = 0)")
        if trace.peak_m < 1:
            raise ValueError(
                f"trace records peak m = {trace.peak_m}: an availability "
                f"schedule needs at least one device at some round")
        self.trace = trace
        self.policy = _check_policy(policy)
        self._tables: dict = {}

    @property
    def peak(self) -> int:
        return self.trace.peak_m

    def m_at(self, t: int) -> int:
        return int(self.trace.m[_resolve_t(int(t), self.trace.n_rounds,
                                           self.policy)])

    def m_device(self, t):
        """M(t) for an int ``t`` (a host int) or an int64 tensor ``t`` (a
        tensor on its device, indexed from the device's cached [T] table).
        Out of the horizon it wraps or clamps; under ``policy='raise'`` it
        clamps, since a device index cannot raise (the scenario runtime
        consults the host ``m_at``, which does)."""
        T = self.trace.n_rounds
        if not isinstance(t, torch.Tensor):
            ti = int(t) % T if self.policy == "wrap" else min(max(int(t), 0),
                                                              T - 1)
            return int(self.trace.m[ti])
        tab = self._tables.get(t.device)
        if tab is None:
            tab = self._tables[t.device] = torch.as_tensor(
                self.trace.m.astype(np.int64), device=t.device)
        ti = torch.remainder(t, T) if self.policy == "wrap" \
            else t.clamp(0, T - 1)
        # take, not tab[ti]: indexing by a 0-d tensor reads it back to the
        # host, which a capture refuses
        return torch.take(tab, ti)


@dataclass(frozen=True)
class TraceSpec:
    """Declarative trace playback for ``ScenarioSpec(trace=...)``.

    Exactly one of ``trace`` (an in-memory ``FleetTrace``) or ``path``
    (a ``FleetTrace.save`` stem/manifest/npz path, loaded lazily once and
    cached).  ``policy`` is the shared out-of-range-round policy
    (``"raise"`` / ``"wrap"`` / ``"clamp"``).
    """
    trace: Optional[FleetTrace] = None
    path: Optional[str] = None
    policy: str = "raise"

    def __post_init__(self):
        if (self.trace is None) == (self.path is None):
            raise ValueError(
                "TraceSpec takes exactly one of trace= (an in-memory "
                "FleetTrace) or path= (a saved trace to load)")
        if self.trace is not None and not isinstance(self.trace, FleetTrace):
            raise TypeError(
                f"trace must be a FleetTrace, got "
                f"{type(self.trace).__name__}")
        _check_policy(self.policy)

    def load(self) -> FleetTrace:
        """The trace (loaded from ``path`` on first call and cached — the
        frozen dataclass shares one loaded copy across the models/prefetch
        paths that consult it)."""
        tr = self.__dict__.get("_loaded")
        if tr is None:
            tr = (self.trace if self.trace is not None
                  else FleetTrace.load(self.path))
            self.__dict__["_loaded"] = tr
        return tr

    def replay(self) -> TraceReplay:
        """The lifecycle model ``ScenarioSpec.models`` appends."""
        rp = self.__dict__.get("_replay")
        if rp is None:
            rp = TraceReplay(self.load(), policy=self.policy)
            self.__dict__["_replay"] = rp
        return rp

    def availability(self) -> TraceAvailability:
        """The recorded M(t) as an ``AvailabilityModel`` (for composing
        with ``ScenarioSampler`` / ``MinAvailability``; the bit-equal
        replay path does not need it — recorded caps already embed the
        cutoff)."""
        av = self.__dict__.get("_availability")
        if av is None:
            av = TraceAvailability(self.load(), policy=self.policy)
            self.__dict__["_availability"] = av
        return av
