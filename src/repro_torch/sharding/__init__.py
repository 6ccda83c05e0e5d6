from repro_torch.sharding.rules import (  # noqa: F401
    shard,
    shard_tree,
)
