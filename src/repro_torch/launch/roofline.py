"""Roofline terms of a step from its counted flops and bytes, on the
H100's constants (``launch/hw.py``).

The port's counterpart of the reference's ``launch/hlo_analysis.py``.
The reference's HLO-text parser (``parse_collectives``) has no
counterpart: the port has no HLO, and ``launch/cost.py`` counts the
collectives from the mesh's own calls.
"""
from __future__ import annotations

from repro_torch.launch import hw


def roofline_terms(flops: float, hbm_bytes: float,
                   coll_bytes: float) -> dict:
    """One rank's three lower bounds in seconds: its flops at the dense
    bf16 peak (the zoo's compute dtype), its bytes at the HBM rate, its
    collective bytes at NVLink's one-way rate; the largest is the
    ``dominant`` term and the step's ``bound_s``."""
    compute_s = flops / hw.PEAK_FLOPS_BF16
    memory_s = hbm_bytes / hw.HBM_BW
    collective_s = coll_bytes / hw.NVLINK_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dom = max(terms, key=terms.get)
    terms["dominant"] = dom.removesuffix("_s")
    bound = max(compute_s, memory_s, collective_s)
    terms["bound_s"] = bound
    terms["compute_fraction"] = compute_s / bound if bound else 0.0
    return terms


def model_flops(n_params_active: int, tokens: int, *,
                backward: bool) -> float:
    """6*N*D (training) or 2*N*D (inference) useful model FLOPs."""
    per_tok = 6 * n_params_active if backward else 2 * n_params_active
    return float(per_tok) * float(tokens)
