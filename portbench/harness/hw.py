"""The yardstick's peaks: one NVIDIA H100 SXM5 80 GB at its full 700 W
power limit, from NVIDIA's data sheet (SXM5 column, dense rates without
sparsity).  A card set below 700 W runs slower under load, so a share of
these peaks is a share of what a card at its full limit offers; every run
prints the card's power limit beside its numbers."""

PEAK_FLOPS = {
    "bfloat16": 989e12,     # tensor cores, dense bf16 / fp16
    "tf32": 495e12,         # tensor cores, dense TF32
    "float32": 67e12,       # float32 outside the tensor cores (TF32 off)
}
HBM_BW = 3.35e12            # bytes/s

# fedmom_update reads w, v and delta and writes w and v: 5 fp32 streams
FEDMOM_BYTES_PER_ELEMENT = 20
