"""TraceRecorder — run a ``ScenarioSpec`` on host and emit the trace it
induces.

The port of the JAX package's ``traces/record.py``: the same keyed
cohorts and caps give the same trace, file for file.

Recording needs no engine and no device work: the scenario layer is pure
host math (keyed hashes -> step caps), and every keyed sampler replays its
device draw on host (``KeyedReplayable``), so the recorder just walks
rounds in order, samples each cohort, stages its caps through the SAME
``ScenarioRuntime`` the trainer would use, and logs one event per cohort
slot.  The caps the recorder sees are the caps the trainer would compile
into step masks — availability and adaptive-cohort cutoffs included
(``steps_for`` zeroes slots past m_t before returning) — which is what
makes a replayed trace bit-equal to the originating synthetic run.

Latency is recorded when a lifecycle model exposes ``step_times(seed, t,
client_ids)`` (``LatencyStragglers`` does); otherwise events carry NaN.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.traces.fleet import FleetTrace


class TraceRecorder:
    """Record ``n_rounds`` of a scenario into a ``FleetTrace``.

    ``spec``: any ``ScenarioSpec`` (stateless or adaptive — the recorder
    walks rounds in order, so the sequential EMA is observed exactly as a
    live run would).  ``local_steps``: the round's H (the trace stores it;
    replay against a different H documents its mapping in ``TraceReplay``).
    """

    def __init__(self, spec, local_steps: int):
        # lazy import: repro_torch.traces must stay importable without pulling
        # the scenario package in (and vice versa — ScenarioSpec imports
        # TraceSpec lazily for the same reason)
        from repro_torch.scenario.spec import ScenarioSpec

        if not isinstance(spec, ScenarioSpec):
            raise TypeError(
                f"spec must be a ScenarioSpec, got {type(spec).__name__}")
        if int(local_steps) < 1:
            raise ValueError(
                f"local_steps must be >= 1, got {local_steps!r}")
        self.spec = spec
        self.local_steps = int(local_steps)

    def record(self, sampler, n_rounds: int,
               n_clients: Optional[int] = None) -> FleetTrace:
        """Sample rounds [0, n_rounds) through ``sampler`` (its host
        ``sample(t)`` replay — the same draw every plane makes) and stage
        them through a fresh ``ScenarioRuntime``; returns the induced
        trace.  ``n_clients`` defaults to the sampler population's size."""
        from repro_torch.scenario.spec import ScenarioRuntime

        if n_clients is None:
            pop = getattr(sampler, "population", None)
            if pop is None:
                raise ValueError(
                    "n_clients not given and the sampler exposes no "
                    "population — pass n_clients explicitly")
            n_clients = int(pop.n_clients)
        rt = ScenarioRuntime(self.spec, self.local_steps)
        stragglers = self.spec.stragglers
        step_times = getattr(stragglers, "step_times", None)
        ev_r, ev_c, ev_s, ev_l, m = [], [], [], [], []
        for t in range(int(n_rounds)):
            idx, _ = sampler.sample(t)
            cids = np.asarray(idx, np.int64)
            caps = rt.steps_for(t, cids)
            m_t = rt.last_m if rt.last_m is not None else len(cids)
            m.append(m_t)
            ev_r.append(np.full(len(cids), t, np.int32))
            ev_c.append(cids)
            ev_s.append(caps)
            if step_times is not None:
                ev_l.append(np.asarray(
                    step_times(self.spec.seed, t, cids), np.float32))
            else:
                ev_l.append(np.full(len(cids), np.nan, np.float32))
        cat = (lambda xs, dt: np.concatenate(xs).astype(dt) if xs
               else np.zeros(0, dt))
        return FleetTrace(
            n_rounds=int(n_rounds), n_clients=n_clients,
            local_steps=self.local_steps,
            m=np.asarray(m, np.int32),
            ev_round=cat(ev_r, np.int32), ev_client=cat(ev_c, np.int64),
            ev_steps=cat(ev_s, np.int32), ev_latency=cat(ev_l, np.float32))


def record_trace(spec, sampler, n_rounds: int, local_steps: int,
                 n_clients: Optional[int] = None) -> FleetTrace:
    """One-call convenience over ``TraceRecorder``."""
    return TraceRecorder(spec, local_steps).record(sampler, n_rounds,
                                                   n_clients=n_clients)
