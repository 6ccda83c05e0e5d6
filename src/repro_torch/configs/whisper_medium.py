"""Whisper-medium [audio] — encoder-decoder transformer backbone; the
mel-spectrogram + conv frontend is a STUB per the assignment carve-out
(input_specs provides precomputed frame embeddings).  [arXiv:2212.04356]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,           # decoder layers
    n_enc_layers=24,
    enc_dec=True,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,         # MHA
    d_head=64,
    d_ff=4096,
    vocab=51865,
    act="gelu",            # plain 2-matrix GELU MLP
    pos="learned",
    max_position=32_768,   # native whisper uses 448 text positions; widened
                           # so the assigned 32k decode shape is exercised
    d_frontend=1024,       # conv-frontend output width (stubbed)
    source="arXiv:2212.04356 (Whisper medium: 24+24L, d=1024, 16H)",
)
