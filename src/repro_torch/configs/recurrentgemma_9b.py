"""RecurrentGemma-9B [hybrid] — RG-LRU + local attention, 2 recurrent blocks
per 1 local-attention block (the paper's "1:2" attention:recurrent ratio).
[arXiv:2402.19427]"""
from repro_torch.models.config import ModelConfig, RGLRU, LOCAL

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,          # MQA
    d_head=256,
    d_ff=12288,
    vocab=256000,
    layer_pattern=(RGLRU, RGLRU, LOCAL),
    window=2048,           # local attention window per the paper
    rnn_width=4096,
    conv_width=4,
    act="geglu",
    rope_theta=10_000.0,
    source="arXiv:2402.19427 (RecurrentGemma), Griffin block layout",
)
