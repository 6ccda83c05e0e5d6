"""Qwen3-1.7B [dense] — qk_norm, GQA.  [hf:Qwen/Qwen3-8B family]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_head=128,
    d_ff=6144,
    vocab=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    act="swiglu",
    source="hf:Qwen/Qwen3-8B (family card; 1.7B dims per assignment)",
)
