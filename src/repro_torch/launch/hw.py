"""Hardware constants of the roofline terms: one NVIDIA H100 SXM5 80 GB at
its full 700 W power limit.

Source: NVIDIA H100 Tensor Core GPU data sheet, SXM5 column, dense rates
(without sparsity).  A card set below 700 W (``nvidia-smi
--query-gpu=power.limit``) runs slower under load, so a time predicted
from these constants is a bound for a card at its full limit.  The
reference's constants (``repro/launch/hw.py``) are the TPU v5e's and are
not carried over.

``NVLINK_BW`` is the bandwidth of the collective term
(``launch/roofline.py``): 18 fourth-generation NVLink links, 900 GB/s
both directions summed, so 450 GB/s each way.  The collective term
divides a rank's collective bytes (the result bytes of each collective,
as the reference counts them) by the one-way 450 GB/s, the rate at which
a rank can send its share.  NVLink spans one host's eight cards (or one
NVLink switch system); between hosts the fabric is slower, so on a mesh
of many hosts the term is a lower bound.
"""
import torch

PEAK_FLOPS_BF16 = 989e12       # FLOP/s, tensor cores, dense bf16 / fp16
PEAK_FLOPS_FP32 = 67e12        # FLOP/s, float32 outside the tensor cores
HBM_BW = 3.35e12               # B/s
HBM_BYTES = 80e9               # B of device memory
NVLINK_BW_BIDIR = 900e9        # B/s, both directions summed
NVLINK_BW = NVLINK_BW_BIDIR / 2  # B/s each way: what the collective term uses

BYTES = {
    torch.float64: 8, torch.float32: 4, torch.float16: 2,
    torch.bfloat16: 2, torch.int64: 8, torch.int32: 4, torch.int16: 2,
    torch.int8: 1, torch.uint8: 1, torch.bool: 1,
    torch.float8_e4m3fn: 1, torch.float8_e5m2: 1,
}
