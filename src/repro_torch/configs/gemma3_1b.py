"""Gemma3-1B [dense] — 5 local (sliding-window) layers per 1 global layer,
128k-context design.  [hf:google/gemma-3-1b-pt]"""
from repro_torch.models.config import ModelConfig, ATTN, LOCAL

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,          # MQA
    d_head=256,
    d_ff=6912,
    vocab=262144,
    layer_pattern=(LOCAL, LOCAL, LOCAL, LOCAL, LOCAL, ATTN),
    window=512,            # gemma3 sliding window
    qk_norm=True,
    rope_theta=1_000_000.0,
    act="geglu",
    source="hf:google/gemma-3-1b-pt (26L d1152 4H/1kv ff6912 v262144, 5:1)",
)
