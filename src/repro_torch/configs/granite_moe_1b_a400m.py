"""Granite-3.0-1B-A400M [moe] — 32 experts, top-8, tiny per-expert FFN.
[hf:ibm-granite/granite-3.0-1b-a400m-base]"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_head=64,
    d_ff=512,              # per-expert FFN width
    vocab=49155,
    moe=MoEConfig(n_experts=32, top_k=8),
    act="swiglu",
    rope_theta=10_000.0,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
