"""FleetTrace — the versioned on-disk record of what a fleet did per round.

The port of the JAX package's ``traces/fleet.py``, with the same format tag,
version and two-file layout: a trace saved by either package loads in the
other.

A trace is the bridge from *simulated* conditions to *replayed* reality
(Bonawitz et al. 2019 drive their production FL system from recorded fleet
logs, not rate parameters): per round t it stores the applied available-
device cutoff ``m[t]`` and one event per (round, joined client) — the
client id, how many of the H local steps it completed before its round
ended (``H`` = finished everything, ``< H`` = dropped/straggled at that
step, ``0`` = joined but contributed nothing; eq. (3) partial-work
aggregation weights the rest) and, when the recording scenario models
latency, its per-step latency in seconds (NaN when unknown).

Storage is two files sharing a stem: ``<stem>.npz`` holds the arrays
(``m``, ``ev_round``, ``ev_client``, ``ev_steps``, ``ev_latency``) and
``<stem>.json`` is the human-readable manifest (format tag, version,
shape counts) that ``load`` validates before touching the arrays — an
unversioned or future-versioned trace fails loudly, never by silently
misreading fields.

Events are kept sorted by ``(round, client)`` (construction sorts; a
duplicated (round, client) pair is rejected — replay lookup would be
ambiguous), so per-round playback is a ``searchsorted`` over a contiguous
slice: ``row_splits[t] : row_splits[t + 1]``.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

TRACE_FORMAT = "repro-fleet-trace"
TRACE_VERSION = 1


def _stem(path: str) -> str:
    base, ext = os.path.splitext(path)
    return base if ext in (".npz", ".json") else path


class FleetTrace:
    """In-memory trace: [T] per-round cutoffs + [N] (round, client) events.

    ``local_steps`` is H at record time — replay against a different H
    clips partial caps and maps recorded-complete (cap == H) to the new H
    (``traces.replay.TraceReplay`` documents the mapping).  ``n_clients``
    is the recorded population size; client ids in events must lie in
    [0, n_clients).
    """

    def __init__(self, n_rounds: int, n_clients: int, local_steps: int,
                 m, ev_round, ev_client, ev_steps, ev_latency=None):
        self.n_rounds = int(n_rounds)
        self.n_clients = int(n_clients)
        self.local_steps = int(local_steps)
        if self.n_rounds < 0 or self.n_clients < 1 or self.local_steps < 1:
            raise ValueError(
                f"need n_rounds >= 0, n_clients >= 1, local_steps >= 1; "
                f"got ({self.n_rounds}, {self.n_clients}, "
                f"{self.local_steps})")
        m = np.asarray(m, np.int32)
        if m.shape != (self.n_rounds,):
            raise ValueError(
                f"m must be [n_rounds]={self.n_rounds} per-round cutoffs, "
                f"got shape {m.shape}")
        ev_round = np.asarray(ev_round, np.int32)
        ev_client = np.asarray(ev_client, np.int64)
        ev_steps = np.asarray(ev_steps, np.int32)
        n = len(ev_round)
        if ev_latency is None:
            ev_latency = np.full(n, np.nan, np.float32)
        ev_latency = np.asarray(ev_latency, np.float32)
        if not (len(ev_client) == len(ev_steps) == len(ev_latency) == n):
            raise ValueError(
                f"event arrays disagree on length: round={n}, "
                f"client={len(ev_client)}, steps={len(ev_steps)}, "
                f"latency={len(ev_latency)}")
        if n:
            if ev_round.min() < 0 or ev_round.max() >= self.n_rounds:
                raise ValueError(
                    f"event rounds must lie in [0, {self.n_rounds}), got "
                    f"[{ev_round.min()}, {ev_round.max()}]")
            if ev_client.min() < 0 or ev_client.max() >= self.n_clients:
                raise ValueError(
                    f"event client ids must lie in [0, {self.n_clients}), "
                    f"got [{ev_client.min()}, {ev_client.max()}]")
            if ev_steps.min() < 0 or ev_steps.max() > self.local_steps:
                raise ValueError(
                    f"event step caps must lie in [0, {self.local_steps}], "
                    f"got [{ev_steps.min()}, {ev_steps.max()}]")
        order = np.lexsort((ev_client, ev_round))
        self.ev_round = ev_round[order]
        self.ev_client = ev_client[order]
        self.ev_steps = ev_steps[order]
        self.ev_latency = ev_latency[order]
        if n > 1:
            dup = ((np.diff(self.ev_round) == 0)
                   & (np.diff(self.ev_client) == 0))
            if dup.any():
                j = int(np.argmax(dup))
                raise ValueError(
                    f"duplicate (round, client) event: round "
                    f"{int(self.ev_round[j])} client "
                    f"{int(self.ev_client[j])} — replay lookup would be "
                    f"ambiguous")
        self.m = m
        # per-round contiguous event slices (events are round-sorted)
        self.row_splits = np.searchsorted(
            self.ev_round, np.arange(self.n_rounds + 1))

    # -- inspection -----------------------------------------------------
    @property
    def n_events(self) -> int:
        return len(self.ev_round)

    @property
    def peak_m(self) -> int:
        """max_t m[t] — the client extent an engine replaying this trace
        would lower for (0 for an empty trace)."""
        return int(self.m.max()) if self.n_rounds else 0

    def summarize(self) -> Dict[str, object]:
        """Fleet analytics over the whole trace (host-side, O(n_events)).

        ``completion_hist``: how many DISTINCT clients fall in each
        participation-outcome bucket over their whole recorded history —
        ``all_complete`` (every joined round finished all H steps),
        ``mixed`` (some rounds complete, some partial), ``all_partial``
        (never finished a round), plus ``never_joined`` (population minus
        participants).  ``steps_hist``: [H + 1] event counts by completed
        step cap (index = steps; index H = finished).  The churn block is
        per round: mean/min/max of joined clients, the mean fraction of a
        round's joiners that completed all H steps, and the mean round-
        over-round cohort turnover (fraction of round t's joiners absent
        from round t+1 — 0.0 for a frozen cohort, 1.0 for full churn)."""
        H = self.local_steps
        steps_hist = np.bincount(self.ev_steps, minlength=H + 1)
        complete = self.ev_steps == H
        participants = np.unique(self.ev_client)
        # per-client complete/partial event counts over the whole trace
        n_ev = np.bincount(self.ev_client, minlength=self.n_clients)
        n_ok = np.bincount(self.ev_client, weights=complete,
                           minlength=self.n_clients).astype(np.int64)
        joined = n_ev > 0
        hist = {
            "all_complete": int(np.sum(joined & (n_ok == n_ev))),
            "mixed": int(np.sum(joined & (n_ok > 0) & (n_ok < n_ev))),
            "all_partial": int(np.sum(joined & (n_ok == 0))),
            "never_joined": int(self.n_clients - len(participants)),
        }
        per_round = np.diff(self.row_splits)
        if self.n_rounds and per_round.min() > 0:
            ok_per_round = np.add.reduceat(
                complete.astype(np.int64), self.row_splits[:-1])
            complete_frac = float(np.mean(ok_per_round / per_round))
        else:
            complete_frac = float("nan")
        turnover = []
        for t in range(self.n_rounds - 1):
            cur = set(self.round_events(t)["client"].tolist())
            if not cur:
                continue
            nxt = set(self.round_events(t + 1)["client"].tolist())
            turnover.append(len(cur - nxt) / len(cur))
        return {
            "n_rounds": self.n_rounds,
            "n_clients": self.n_clients,
            "n_events": self.n_events,
            "participants": int(len(participants)),
            "completion_hist": hist,
            "steps_hist": [int(c) for c in steps_hist],
            "joined_per_round": {
                "mean": float(per_round.mean()) if self.n_rounds else 0.0,
                "min": int(per_round.min()) if self.n_rounds else 0,
                "max": int(per_round.max()) if self.n_rounds else 0,
            },
            "complete_frac_mean": complete_frac,
            "turnover_mean": (float(np.mean(turnover)) if turnover
                              else float("nan")),
        }

    def round_events(self, t: int) -> Dict[str, np.ndarray]:
        """Round ``t``'s events as {client, steps, latency} arrays (sorted
        by client id); raises IndexError outside [0, n_rounds) — the
        policy-mapped entry points live in ``traces.replay``."""
        if not 0 <= int(t) < self.n_rounds:
            raise IndexError(
                f"round {t} outside recorded trace [0, {self.n_rounds})")
        lo, hi = int(self.row_splits[t]), int(self.row_splits[t + 1])
        return {"client": self.ev_client[lo:hi],
                "steps": self.ev_steps[lo:hi],
                "latency": self.ev_latency[lo:hi]}

    # -- persistence ----------------------------------------------------
    def save(self, path: str) -> str:
        """Write ``<stem>.npz`` + ``<stem>.json``; returns the manifest
        path.  ``path`` may carry either extension (or none)."""
        stem = _stem(path)
        d = os.path.dirname(stem)
        if d:
            os.makedirs(d, exist_ok=True)
        np.savez(stem + ".npz", m=self.m, ev_round=self.ev_round,
                 ev_client=self.ev_client, ev_steps=self.ev_steps,
                 ev_latency=self.ev_latency)
        manifest = {
            "format": TRACE_FORMAT,
            "version": TRACE_VERSION,
            "arrays": os.path.basename(stem) + ".npz",
            "n_rounds": self.n_rounds,
            "n_clients": self.n_clients,
            "local_steps": self.local_steps,
            "n_events": self.n_events,
            "peak_m": self.peak_m,
        }
        with open(stem + ".json", "w") as f:
            json.dump(manifest, f, indent=2, sort_keys=True)
            f.write("\n")
        return stem + ".json"

    @classmethod
    def load(cls, path: str) -> "FleetTrace":
        """Load a trace saved by ``save``; ``path`` may name the manifest,
        the npz, or the shared stem.  Validates format tag and version
        before reading arrays."""
        stem = _stem(path)
        manifest_path = stem + ".json"
        if not os.path.exists(manifest_path):
            raise FileNotFoundError(
                f"trace manifest {manifest_path!r} not found (a trace is "
                f"the <stem>.json + <stem>.npz pair FleetTrace.save "
                f"writes)")
        with open(manifest_path) as f:
            manifest = json.load(f)
        if manifest.get("format") != TRACE_FORMAT:
            raise ValueError(
                f"{manifest_path!r} is not a {TRACE_FORMAT} manifest "
                f"(format={manifest.get('format')!r})")
        if manifest.get("version") != TRACE_VERSION:
            raise ValueError(
                f"trace version {manifest.get('version')!r} unsupported "
                f"(this build reads version {TRACE_VERSION})")
        arrays = np.load(os.path.join(os.path.dirname(stem) or ".",
                                      manifest["arrays"]))
        trace = cls(n_rounds=manifest["n_rounds"],
                    n_clients=manifest["n_clients"],
                    local_steps=manifest["local_steps"],
                    m=arrays["m"], ev_round=arrays["ev_round"],
                    ev_client=arrays["ev_client"],
                    ev_steps=arrays["ev_steps"],
                    ev_latency=arrays["ev_latency"])
        if trace.n_events != int(manifest["n_events"]):
            raise ValueError(
                f"trace arrays carry {trace.n_events} events but the "
                f"manifest declares {manifest['n_events']}")
        return trace
