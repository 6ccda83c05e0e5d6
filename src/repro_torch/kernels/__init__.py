"""Hand-written Hopper kernels of the port, one subpackage each:

  kernel.py — binding and launch of the CUDA source in ``csrc/``
  ops.py    — public wrapper: CUDA tensors to the kernel, CPU tensors to ref
  ref.py    — the same function in plain PyTorch

Kernels build from source at first use (``_build.py``), never at import.
"""
from repro_torch.kernels.client_step import ops as client_step_ops  # noqa: F401,E501
from repro_torch.kernels.fedmom_update import ops as fedmom_ops  # noqa: F401
from repro_torch.kernels.flash_attention import ops as flash_attention_ops  # noqa: F401,E501
from repro_torch.kernels.moe_route import ops as moe_route_ops  # noqa: F401
from repro_torch.kernels.rglru_scan import ops as rglru_scan_ops  # noqa: F401
from repro_torch.kernels.rwkv6_scan import ops as rwkv6_scan_ops  # noqa: F401
