"""Client-lifecycle scenario engine: simulate production FL conditions —
mid-round dropouts, round-deadline stragglers, availability schedules,
adaptive cohort sizing — on top of the paper's eq. (3) partial-work
aggregation, uniformly across every execution plane.  Declared as
``ScenarioSpec`` on an ``ExecutionPlan``; see ``repro_torch.scenario.spec``.

The port of the JAX package's ``scenario`` package, with its exports.
"""
from repro_torch.scenario.availability import (  # noqa: F401
    AvailabilityModel,
    ConstantAvailability,
    DiurnalAvailability,
    MinAvailability,
    ScenarioSampler,
)
from repro_torch.scenario.lifecycle import (  # noqa: F401
    LatencyStragglers,
    LifecycleModel,
    PerClientDropout,
    UniformDropout,
    keyed_normals,
    keyed_uniforms,
)
from repro_torch.scenario.providers import (  # noqa: F401
    ZipfLinregProvider,
    zipf_counts,
    zipf_linreg_provider,
)
from repro_torch.scenario.spec import (  # noqa: F401
    AdaptiveCohort,
    ScenarioRuntime,
    ScenarioSpec,
)
