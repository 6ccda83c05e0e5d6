"""Grok-1 314B [moe] — 8 experts, top-2.  [hf:xai-org/grok-1]"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=32768,
    vocab=131072,
    moe=MoEConfig(n_experts=8, top_k=2),
    act="geglu",
    rope_theta=10_000.0,
    source="hf:xai-org/grok-1 (64L d6144 48H/8kv ff32768 8e top2)",
)
