"""Input stand-ins and their mesh-axis specs for every (architecture x
input shape x mesh) combination of the dry run.

Nothing here allocates: batches are int32 and fp32 tensors on the meta
device with the reference's shapes (``repro/launch/specs.py``), and a
spec is a tuple of mesh-axis entries, one a dimension (``None``, an axis
name, or a tuple of names), where the reference has a ``PartitionSpec``.
A mesh is its axis sizes (``launch/mesh.py`` ``make_production_mesh``).
The modality frontends are stubbed as in the reference: audio supplies
[*, ENC_LEN, d_frontend] frame embeddings, the VLM [*, VLM_PATCHES,
d_frontend] patch embeddings.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import ENC_LEN, VLM_PATCHES

_DP = ("pod", "data")  # filtered against the mesh
META = torch.device("meta")


@dataclass(frozen=True)
class InputShape:
    name: str
    kind: str            # train | prefill | decode
    seq: int
    global_batch: int


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", "train", 4_096, 256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": InputShape("decode_32k", "decode", 32_768, 128),
    "long_500k": InputShape("long_500k", "decode", 524_288, 1),
}

# architectures whose replica cannot fit one 'model' mesh slice -> the round
# engine runs in scan (virtual-client, FSDP) placement
SCAN_PLACEMENT = {"qwen2-vl-72b", "grok-1-314b"}

# long_500k applicability (the reference's DESIGN.md §4): run only for
# architectures with no unbounded-context attention cache or a bounded
# sliding-window / few-global-layer design.
LONG_OK = {"rwkv6-7b", "recurrentgemma-9b", "gemma3-1b"}


def placement_for(arch: str) -> str:
    return "scan" if arch in SCAN_PLACEMENT else "mesh"


def shape_applicable(arch: str, cfg: ModelConfig, shape: InputShape
                     ) -> tuple:
    """(ok, reason)."""
    if shape.name == "long_500k" and arch not in LONG_OK:
        return False, ("full-attention arch: 500k decode cache is unbounded-"
                       "context; skipped per assignment rule (DESIGN.md §4)")
    return True, ""


def dp_axes(mesh: Mapping[str, int]) -> tuple:
    """The mesh's data-parallel axes, ('pod', 'data') where it has them."""
    return tuple(a for a in _DP if a in mesh)


def dp_size(mesh: Mapping[str, int]) -> int:
    n = 1
    for a in dp_axes(mesh):
        n *= mesh[a]
    return n


def round_geometry(shape: InputShape, placement: str,
                   mesh: Mapping[str, int]) -> tuple:
    """(C clients, H local steps, b per-step client batch)."""
    H = 4
    dp = dp_size(mesh)
    # mesh: one client a data shard; scan: few, large virtual clients
    # whose per-step batch shards the dp axes (4 on 256 cards, 2 on 512)
    C = dp if placement == "mesh" else max(1, 64 // dp)
    b = shape.global_batch // (C * H)
    if b < 1 or C * H * b != shape.global_batch:
        raise ValueError(f"{shape.name}: a global batch of "
                         f"{shape.global_batch} does not split into C={C} "
                         f"clients x H={H} steps")
    return C, H, b


def _i32(shape):
    return torch.empty(shape, dtype=torch.int32, device=META)


def _f32(shape):
    return torch.empty(shape, dtype=torch.float32, device=META)


def train_batch_specs(arch: str, cfg: ModelConfig, shape: InputShape,
                      placement: str, mesh: Mapping[str, int]):
    """Returns (batches, batches_spec, weights, weights_spec).

    Batch leaves have leading [C, H]; the per-step batch is what
    ``transformer.loss_fn`` consumes."""
    C, H, b = round_geometry(shape, placement, mesh)
    S = shape.seq
    dp = dp_axes(mesh)

    def leaf_spec(extra_rank):
        if placement == "mesh":
            # the clients axis sharded
            return (dp, None) + (None,) * extra_rank
        # [C, H, b, ...]: the per-client batch dim sharded over data
        return (None, None, dp) + (None,) * (extra_rank - 1)

    batches = {"tokens": _i32((C, H, b, S)), "labels": _i32((C, H, b, S))}
    spec = {"tokens": leaf_spec(2), "labels": leaf_spec(2)}
    if cfg.family == "vlm":
        batches["patches"] = _f32((C, H, b, VLM_PATCHES, cfg.d_frontend))
        spec["patches"] = leaf_spec(3)
        batches["mrope_positions"] = _i32((C, H, 3, b, S))
        spec["mrope_positions"] = ((dp, None, None, None, None)
                                   if placement == "mesh"
                                   else (None, None, None, dp, None))
        batches["loss_mask"] = _f32((C, H, b, S))
        spec["loss_mask"] = leaf_spec(2)
    if cfg.enc_dec:
        batches["frames"] = _f32((C, H, b, ENC_LEN, cfg.d_frontend))
        spec["frames"] = leaf_spec(3)
    weights = _f32((C,))
    weights_spec = (dp,) if placement == "mesh" else ()
    return batches, spec, weights, weights_spec


def serve_batch_specs(arch: str, cfg: ModelConfig, shape: InputShape,
                      mesh: Mapping[str, int], rows: Optional[int] = None):
    """Prefill / decode request batches of ``rows`` rows (default: the
    shape's global batch): (batch, spec) trees, with the decode position
    ``pos`` (an int32 scalar, as the reference's) when kind == decode."""
    B = shape.global_batch if rows is None else rows
    S = shape.seq
    dp = dp_axes(mesh)
    # batch=1 (long_500k) cannot shard batch
    bax = dp if shape.global_batch > 1 else None
    if shape.kind == "prefill":
        batch = {"tokens": _i32((B, S))}
        spec = {"tokens": (bax, None)}
        if cfg.family == "vlm":
            batch["patches"] = _f32((B, VLM_PATCHES, cfg.d_frontend))
            spec["patches"] = (bax, None, None)
            batch["mrope_positions"] = _i32((3, B, S))
            spec["mrope_positions"] = (None, bax, None)
        if cfg.enc_dec:
            batch["frames"] = _f32((B, ENC_LEN, cfg.d_frontend))
            spec["frames"] = (bax, None, None)
        return batch, spec
    # decode: one token per sequence
    batch = {"tokens": _i32((B, 1)), "pos": _i32(())}
    spec = {"tokens": (bax, None), "pos": ()}
    return batch, spec
