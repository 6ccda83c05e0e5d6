"""Multi-pod dry run of the port, on the meta device.

For every (architecture x input shape x mesh) combination this builds the
real step, the federated round (the paper's workload) for train shapes and
prefill / decode for serving shapes, on meta tensors (shapes and dtypes,
no memory), runs it once and counts it (``launch/cost.py``): nothing is
allocated, and no card is needed.  grok-1-314b and qwen2-vl-72b run at
full depth.

Each record keeps two halves apart:

  * **the plan**, which the JAX package computes too: ``placement``,
    ``kind``, C/H/b (``launch/specs.py``) and ``arg_bytes_per_dev``, what
    one device of the production mesh holds of the step's arguments under
    the rule tables (``sharding/rules.py`` ``tree_shardings``, with
    ``_server_axes``' ZeRO rule and divisibility-aware shard shapes);
  * **the port's count.**  The port executes no 'model' axis: its mesh is
    the data mesh (``launch/mesh.py``), dp = pod x data ranks, each
    holding a whole replica.  So a record counts the step as one rank of
    that mesh runs it, where the reference's figures are GSPMD's
    per-device program over the whole mesh (the two are not the same
    program and are not compared).  A train shape runs ``round_step`` on
    the zoo's ``loss_fn`` as rank 0 of a ``cost.RecordingMesh`` of the dp
    axes: under mesh placement its block of the cohort (C/dp clients),
    under scan placement the whole round, which the port runs on every
    rank (``busy_ranks`` 1: the others repeat it).  A serving shape runs
    ``prefill`` or ``decode_step`` on a rank's share of the request batch
    (ceil(B/dp) rows; independent requests need no collective).  The
    fields: ``flops_per_rank``, ``hbm_bytes_per_rank`` (the eager
    traffic model, not XLA's fused figure), ``peak_bytes_per_rank``,
    ``collectives``, ``roofline`` (on ``launch/hw.py``'s H100 constants),
    ``model_flops_total``, ``model_flops_ratio`` (model flops over
    ``flops_per_rank`` x ``busy_ranks``) and ``fits_one_card`` (peak <=
    ``hw.HBM_BYTES``).

The configurations count at their defaults: ``attention_impl="xla"``,
``rwkv_impl="xla"`` and the plain server step, as the reference's dry run
does.  A kernel asked for on meta tensors raises rather than count its
plain version as the kernel.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b \
        --shape train_4k [--multi-pod] [--variant zero|replicated]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] \
        --json out.jsonl
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
import traceback

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import RoundConfig, round_step
from repro_torch.core import server_opt as so
from repro_torch.launch import cost, hw, roofline
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import (
    INPUT_SHAPES,
    dp_axes,
    dp_size,
    placement_for,
    round_geometry,
    serve_batch_specs,
    shape_applicable,
    train_batch_specs,
)
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import (
    FED_MESH_RULES,
    FSDP_RULES,
    MeshSharding,
    axis_rules,
    tree_shardings,
)
from repro_torch.tree import leaves, tree_map

META = torch.device("meta")

# named rule overrides of the reference's hillclimbs (its EXPERIMENTS.md):
#   zero        - default: ZeRO-sharded server state (beyond-paper)
#   replicated  - paper-faithful replicated server state (baseline)
#   bf16delta   - aggregate the biased gradient in bf16
#   mp_serve    - serving: weights model-parallel only (no FSDP all-gather
#                 per token) for scan-placement archs
#   expert_dp   - serving MoE: experts sharded over the data axes
#                 (expert parallelism) + model-parallel FFN slices
#   seq_cache   - decode: shard the KV cache on the sequence axis (for
#                 batch=1 long-context decode, e.g. long_500k)
VARIANT_OVERRIDES = {
    "zero": {},
    "replicated": {"opt_embed": None},
    "bf16delta": {},
    # train: shard attention on head_dim when the head count does not divide
    # the model axis (qwen* 40-head class)
    "headdim": {"head_dim": "model"},
    "headdim_bf16": {"head_dim": "model"},
    "mp_serve": {"embed": None},
    "expert_dp": {"embed": None, "expert": ("pod", "data")},
    "seq_cache": {"seq": ("pod", "data")},
    # decode: shard the KV cache along sequence over 'model'
    "seq_model": {"seq": "model"},
    # MoE: shard the per-expert FFN dim instead of the expert dim
    "moe_ffshard": {"expert": None, "expert_mlp": "model"},
    # rwkv: halve the chunk of the chunked scan
    "rwkv_chunk16": {},
    # moe: vmap group dispatch
    "moe_vmap": {},
    # rg-lru: run the associative scan in bf16 (gates stay fp32)
    "rglru_bf16": {},
    # remat: save matmul outputs instead of full recompute
    "remat_dots": {},
    # rg-lru: bf16-gather u for the gate matmuls instead of fp32 psums
    "rglru_gather": {},
    # combined: vmap dispatch + bf16 delta aggregation
    "moe_vmap_bf16": {},
    # decode: 2D weight-stationary serving, weights sharded over data too
    "w2d": {"embed": ("pod", "data")},
}

# the config each variant changes, as the reference's ``dry_run`` does
_CONFIG_VARIANTS = {
    "rwkv_chunk16": {"rwkv_chunk": 16},
    "moe_vmap": {"moe_dispatch": "vmap"},
    "rglru_bf16": {"rglru_dtype": "bfloat16"},
    "remat_dots": {"remat_policy": "dots"},
    "rglru_gather": {"rglru_gate_gather": True},
    "moe_vmap_bf16": {"moe_dispatch": "vmap"},
}
_BF16_DELTA = ("bf16delta", "headdim_bf16", "moe_vmap_bf16")


def rules_for(placement: str, variant: str, kind: str = "serve"):
    base = FSDP_RULES if placement == "scan" else FED_MESH_RULES
    rules = dict(base)
    if kind == "train" and placement == "mesh":
        # inside the client vmap the batch dim is per-client: the 'clients'
        # logical axis already consumes ('pod','data')
        rules["batch"] = None
    rules.update(VARIANT_OVERRIDES.get(variant, {}))
    return rules


def _f32_state_of(params):
    return tree_map(lambda x: torch.empty(x.shape, dtype=torch.float32,
                                          device=META), params)


def _server_axes(axes):
    """ZeRO rule: the server master/momentum shards its 'embed'-like dims
    over the data axes via the 'opt_embed' logical axis."""
    if isinstance(axes, dict):
        return {k: _server_axes(v) for k, v in axes.items()}
    return tuple("opt_embed" if a == "embed" else a for a in axes)


def _specs(spec_tree, mesh):
    items = tuple(mesh.items())
    return {k: MeshSharding(v, items) for k, v in spec_tree.items()}


def _arg_bytes_per_device(args, shardings) -> int:
    """What one device holds of ``args`` under ``shardings``: every leaf's
    shard shape times its item size, summed."""
    total = 0
    for x, sh in zip(leaves(args), leaves(shardings)):
        total += math.prod(sh.shard_shape(x.shape)) * x.element_size()
    return total


def _block(x, n: int):
    """A meta tensor of ``x``'s first ``n`` rows: what rank 0 holds."""
    return torch.empty((n,) + tuple(x.shape[1:]), dtype=x.dtype, device=META)


# ---------------------------------------------------------------------------
# step builders: (rank step, its meta arguments, geometry and plan)
# ---------------------------------------------------------------------------
def build_train(arch: str, cfg: ModelConfig, shape, mesh: dict,
                variant: str, rules: dict):
    placement = placement_for(arch)
    C, H, b = round_geometry(shape, placement, mesh)
    params, axes = T.abstract_params(cfg)
    state = so.ServerState(
        w=_f32_state_of(params), extra={"v": _f32_state_of(params)},
        t=torch.empty((), dtype=torch.int32, device=META))
    srv_axes = _server_axes(axes)
    state_sh = so.ServerState(
        w=tree_shardings(srv_axes, rules, mesh, state.w),
        extra={"v": tree_shardings(srv_axes, rules, mesh,
                                   state.extra["v"])},
        t=MeshSharding((), tuple(mesh.items())))
    batches, b_spec, weights, w_spec = train_batch_specs(
        arch, cfg, shape, placement, mesh)
    plan = (state, batches, weights)
    geo = dict(C=C, H=H, b=b, arg_bytes_per_dev=_arg_bytes_per_device(
        plan, (state_sh, _specs(b_spec, mesh),
               MeshSharding(w_spec, tuple(mesh.items())))))

    rcfg = RoundConfig(clients_per_round=C, local_steps=H, lr=0.01,
                       placement=placement,
                       delta_dtype=("bfloat16" if variant in _BF16_DELTA
                                    else "float32"),
                       compute_dtype=cfg.dtype)
    opt = so.fedmom(eta=1.0, beta=0.9)
    cohort_block = placement == "mesh"
    if cohort_block:
        # rank 0's block of ceil(C / dp) clients, as the device plane
        # hands a rank its block
        n = -(-C // dp_size(mesh))
        batches = tree_map(lambda x: _block(x, n), batches)
        geo["busy_ranks"] = -(-C // n)
    else:
        geo["busy_ranks"] = 1

    def loss_fn(p, batch):
        return T.loss_fn(p, cfg, batch)

    def step(state, batches, weights):
        return round_step(loss_fn, opt, state, batches, weights, rcfg,
                          param_axes=axes, device=META,
                          cohort_block=cohort_block)

    return step, (state, batches, weights), geo


def build_serve(arch: str, cfg: ModelConfig, shape, mesh: dict,
                variant: str, rules: dict):
    params, axes = T.abstract_params(cfg)
    params_sh = tree_shardings(axes, rules, mesh, params)
    cache, cache_axes = T.init_cache(cfg, shape.global_batch, shape.seq,
                                     abstract=True)
    cache_sh = tree_shardings(cache_axes, rules, mesh, cache)
    batch, spec = serve_batch_specs(arch, cfg, shape, mesh)
    b_sh = _specs(spec, mesh)
    if shape.kind == "prefill":
        plan = ((params, batch, cache), (params_sh, b_sh, cache_sh))
    else:
        plan = ((params, cache, batch["tokens"], batch["pos"]),
                (params_sh, cache_sh, b_sh["tokens"], b_sh["pos"]))
    rows = -(-shape.global_batch // dp_size(mesh))
    geo = {"arg_bytes_per_dev": _arg_bytes_per_device(*plan),
           "rank_batch": rows,
           "busy_ranks": -(-shape.global_batch // rows)}

    # the count: one rank's share of the requests
    rcache, _ = T.init_cache(cfg, rows, shape.seq, abstract=True)
    rbatch, _ = serve_batch_specs(arch, cfg, shape, mesh, rows=rows)
    if shape.kind == "prefill":
        def step(params, batch, cache):
            with torch.no_grad():
                return T.prefill(params, cfg, batch, cache)
        args = (params, rbatch, rcache)
    else:
        pos = shape.seq - 1          # the last slot of the cache

        def step(params, cache, tokens):
            with torch.no_grad():
                return T.decode_step(params, cfg, cache, tokens, pos)
        args = (params, rcache, rbatch["tokens"])
    return step, args, geo


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------
def dry_run(arch: str, shape_name: str, *, multi_pod: bool = False,
            variant: str = "zero", verbose: bool = True,
            cfg: ModelConfig = None) -> dict:
    """One combination's record.  ``cfg`` replaces the registry's config
    of ``arch`` (a cut in depth, say); the variant still applies to it."""
    cfg = get_config(arch) if cfg is None else cfg
    if variant in _CONFIG_VARIANTS:
        cfg = cfg.replace(**_CONFIG_VARIANTS[variant])
    shape = INPUT_SHAPES[shape_name]
    ok, reason = shape_applicable(arch, cfg, shape)
    rec = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "variant": variant, "placement": placement_for(arch),
        "kind": shape.kind,
    }
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = reason
        if verbose:
            _print_rec(rec)
        return rec
    mesh = make_production_mesh(multi_pod=multi_pod)
    t0 = time.time()
    try:
        rules = rules_for(placement_for(arch), variant, shape.kind)
        build = build_train if shape.kind == "train" else build_serve
        fn, args, geo = build(arch, cfg, shape, mesh, variant, rules)
        ranks = cost.RecordingMesh({a: mesh[a] for a in dp_axes(mesh)})
        with axis_rules(ranks, rules):
            la = cost.analyze(fn, *args)
        rec.update(geo)
        rec["status"] = "ok"
        rec["count_s"] = round(time.time() - t0, 1)
        rec["ranks"] = ranks.size
        rec["flops_per_rank"] = la["flops"]
        rec["hbm_bytes_per_rank"] = la["bytes"]
        rec["peak_bytes_per_rank"] = la["peak_bytes"]
        rec["collectives"] = la["collectives"]
        rec["collective_bytes_per_rank"] = la["collective_bytes"]
        rec["collective_count"] = la["collective_count"]
        rec["roofline"] = roofline.roofline_terms(
            la["flops"], la["bytes"], la["collective_bytes"])
        tokens = shape.global_batch * (shape.seq if shape.kind != "decode"
                                       else 1)
        mf = roofline.model_flops(cfg.n_active_params(), tokens,
                                  backward=(shape.kind == "train"))
        rec["model_flops_total"] = mf
        busy = la["flops"] * rec["busy_ranks"]
        rec["model_flops_ratio"] = (mf / busy) if busy else None
        rec["fits_one_card"] = la["peak_bytes"] <= hw.HBM_BYTES
    except Exception as e:  # noqa: BLE001 — report and continue the sweep
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc(limit=25)
    if verbose:
        _print_rec(rec)
    return rec


def _print_rec(rec: dict):
    if rec["status"] == "ok":
        r = rec["roofline"]
        print(f"[OK]   {rec['arch']:22s} {rec['shape']:12s} {rec['mesh']:8s} "
              f"{rec['variant']:10s} count={rec['count_s']:6.1f}s "
              f"flops/rank={rec['flops_per_rank']:.3e} "
              f"coll/rank={rec['collective_bytes_per_rank']:.3e}B "
              f"peak/rank={rec['peak_bytes_per_rank']:.3e}B "
              f"fits={rec['fits_one_card']} dominant={r['dominant']}")
    elif rec["status"] == "skipped":
        print(f"[SKIP] {rec['arch']:22s} {rec['shape']:12s} {rec['mesh']:8s} "
              f"— {rec['reason'][:80]}")
    else:
        print(f"[ERR]  {rec['arch']:22s} {rec['shape']:12s} {rec['mesh']:8s} "
              f"{rec['error'][:160]}")
    sys.stdout.flush()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS))
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--variant", default="zero",
                    choices=list(VARIANT_OVERRIDES))
    ap.add_argument("--json", default=None, help="append records to file")
    args = ap.parse_args(argv)

    arches = list(ARCH_IDS) if args.all or not args.arch else [args.arch]
    shapes = list(INPUT_SHAPES) if args.all or not args.shape \
        else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    combos = [(a, s, m) for a in arches for s in shapes for m in meshes]

    t0 = time.time()
    records = [dry_run(a, s, multi_pod=m, variant=args.variant)
               for a, s, m in combos]
    if args.json:
        with open(args.json, "a") as f:
            for r in records:
                r.pop("traceback", None)
                f.write(json.dumps(r) + "\n")
    n_err = sum(r["status"] == "error" for r in records)
    print(f"\n{len(records)} combos: "
          f"{sum(r['status'] == 'ok' for r in records)} ok, "
          f"{sum(r['status'] == 'skipped' for r in records)} skipped, "
          f"{n_err} errors ({time.time() - t0:.1f} s)")
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
