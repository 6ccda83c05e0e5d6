"""The paper's primary contribution: federated optimization as a
biased-gradient method (server optimizers + client solver + round engine)."""
from repro_torch.core.round import (  # noqa: F401
    RoundConfig,
    bucketed_round_step,
    round_step,
)
from repro_torch.core.sampling import (  # noqa: F401
    ClientPopulation,
    DeviceDiurnalSampler,
    DeviceSampleable,
    DeviceUniformSampler,
    DiurnalSampler,
    KeyedReplayable,
    UniformSampler,
    participants_in_span,
)
from repro_torch.core.secure_agg import (  # noqa: F401
    EmptyCohortError,
    SecureAggSpec,
    aggregate_masked,
    mask_client_updates,
)
from repro_torch.core.server_opt import (  # noqa: F401
    ServerOpt,
    ServerState,
    dp,
    dp_fedavg,
    dp_fedmom,
    fedadam,
    fedavg,
    fedavgm,
    fedlamom,
    fedmom,
    fedyogi,
)
