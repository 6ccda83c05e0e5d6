"""Trace subsystem: record what a scenario did to a fleet, replay it
anywhere.

``FleetTrace`` is the versioned record (npz + json manifest: per-round
available-device cutoffs, per-(round, client) join/dropout-step/latency
events); ``TraceRecorder`` runs any ``ScenarioSpec`` on host and emits the
trace it induced; ``TraceReplay`` / ``TraceAvailability`` play a trace
back through the existing lifecycle ``step_caps()`` and
``AvailabilityModel`` protocols — so a recorded trace drives the eq. (3)
``step_mask`` machinery on every execution plane, keyed, resume-safe and
bit-equal to the originating run.  ``TraceSpec`` is the declarative form:
``ScenarioSpec(trace=TraceSpec(path=...))``.

The port of the JAX package's ``traces`` package, with its exports.
"""
from repro_torch.traces.fleet import (  # noqa: F401
    TRACE_FORMAT,
    TRACE_VERSION,
    FleetTrace,
)
from repro_torch.traces.record import (  # noqa: F401
    TraceRecorder,
    record_trace,
)
from repro_torch.traces.replay import (  # noqa: F401
    POLICIES,
    TraceAvailability,
    TraceReplay,
    TraceSpec,
)
