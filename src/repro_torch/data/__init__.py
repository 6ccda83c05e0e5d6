from repro_torch.data.device import DeviceFederatedDataset  # noqa: F401
from repro_torch.data.federated import (  # noqa: F401
    CorpusSchemaError,
    FederatedDataset,
    minibatch_indices,
)
from repro_torch.data.stream import (  # noqa: F401
    CacheView,
    DiskShardProvider,
    ShardCache,
    ShardProvider,
    StreamingFederatedDataset,
    TierLayout,
    leaf_to_corpus,
    next_pow2,
    parse_leaf_dir,
    write_disk_corpus,
)
from repro_torch.data.partition import (  # noqa: F401
    dirichlet_partition,
    label_shard_partition,
    lognormal_sizes,
)
from repro_torch.data.synthetic import (  # noqa: F401
    synthetic_femnist,
    synthetic_shakespeare,
    synthetic_token_clients,
)
