"""Qwen2-VL-72B [vlm] — M-RoPE, dynamic resolution.  The ViT vision encoder +
projector is a STUB per the assignment carve-out (input_specs provides patch
embeddings already projected to d_model).  [arXiv:2409.12191]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=29568,
    vocab=152064,
    qkv_bias=True,
    mrope=True,
    mrope_sections=(16, 24, 24),   # temporal / height / width rope sections
    rope_theta=1_000_000.0,
    act="swiglu",
    d_frontend=8192,
    source="arXiv:2409.12191 (Qwen2-VL-72B)",
)
