from repro_torch.checkpoint.io import (  # noqa: F401
    AsyncCheckpointWriter,
    append_metrics,
    latest_round,
    prune_metrics,
    restore_state,
    save_state,
)
