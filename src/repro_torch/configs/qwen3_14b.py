"""Qwen3-14B [dense] — qk_norm, GQA.  [hf:Qwen/Qwen3-8B family]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_head=128,
    d_ff=17408,
    vocab=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    act="swiglu",
    source="hf:Qwen/Qwen3-8B (family card; 14B dims per assignment)",
)
