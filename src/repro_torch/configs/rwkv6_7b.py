"""RWKV6-7B "Finch" [ssm] — attention-free, data-dependent decay.
[arXiv:2404.05892]"""
from repro_torch.models.config import ModelConfig, RWKV

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,            # 4096 / head_dim 64
    n_kv_heads=64,
    d_head=64,
    d_ff=14336,
    vocab=65536,
    layer_pattern=(RWKV,),
    rwkv_head_dim=64,
    rwkv_decay_lora=64,
    pos="none",            # rwkv has no explicit positional encoding
    act="gelu",            # channel-mix uses squared-relu internally; the
                           # act field is unused for RWKV blocks
    source="arXiv:2404.05892 (RWKV-6 Finch 7B: L32 D4096)",
)
