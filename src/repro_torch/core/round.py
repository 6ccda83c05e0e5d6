"""The federated round engine — Algorithm 1/3 steps 1-9 as one function.

A round:
  1. (host) the scheduler samples S_t, |S_t| = M clients and their weights
     n_k/n (repro_torch.core.sampling);
  2. broadcast w_t to the M clients;
  3. every client runs H local optimizer steps (Algorithm 2);
  4. aggregate the *biased gradient* delta_t = sum_k (n_k/n)(w_t - w^k);
  5. the server optimizer (FedAvg / FedMom / ...) consumes delta_t.

Two placements with identical algorithm semantics (tests assert equality):

  * ``mesh``: step 3 is a ``torch.func.vmap`` over the clients, step 4 one
    fp32 weighted reduction of the per-client differences, rounded once to
    ``delta_dtype``.  Under a live data mesh (``sharding.axis_rules`` with
    a ``launch.mesh.Mesh``, as ``ExecutionPlan(mesh=...)`` sets up) the
    cohort splits over the ranks: rank r vmaps the r-th contiguous block
    of ceil(C/n) clients (blocks may be uneven, a rank may hold none),
    reduces its fp32 weighted-delta partial, and one ``all_reduce(SUM)``
    makes the delta replicated, so the server update runs identically on
    every rank; the per-client losses come back in cohort order through
    one all-gather.  The reassociated sum is tolerance-equal to one
    device's, as the reference's ``psum`` is;
  * ``scan``: clients run one after another into an fp32 accumulator —
    one client replica alive at a time.

``bucketed_round_step`` runs one round as per-size-tier launches (the
bucketed streaming plane).  Under secure aggregation (``RoundConfig.secure``,
a ``core.secure_agg.SecureAggSpec``) step 4 runs through the uint32-ring
masking layer instead of the fp32 reduction: the masked aggregate is
bit-equal to the open ring's, on every plane.  Under a mesh each rank
encodes and masks its own block's rows (it draws only the pair masks that
touch them, keyed as everywhere) and one integer ``all_reduce`` of the ring
words follows: the ring sum is exact in any order, so a masked round under
a mesh is bit-equal to one device's, and no rank sees another's plain
client updates.  (The reference keeps secure rounds on one GSPMD program
instead.)  Logical-axis sharding (``param_axes``, the twin tree of
logical-axis tuples that a model's ``init`` returns) constrains the
per-client replicas and the scan accumulator where the reference does,
through ``sharding.shard_tree``; those constraints place nothing the split
has not already placed, so a round with ``param_axes`` is bit-equal to one
without.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch
from torch.func import vmap

from repro_torch import random as prng
from repro_torch import spans
from repro_torch.core import client as client_lib
from repro_torch.core import secure_agg
from repro_torch.core.secure_agg import SecureAggSpec
from repro_torch.core.server_opt import ServerOpt, ServerState
from repro_torch.device import resolve_device
from repro_torch.optim import local as local_opt_lib
from repro_torch.sharding import current_mesh, shard_tree, spmd_client_axes
from repro_torch.tree import leaves, tree_map, unflatten_like

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


@dataclass(frozen=True)
class RoundConfig:
    clients_per_round: int          # M (= C, the client extent)
    local_steps: int                # H
    lr: float                       # gamma_t (client stepsize)
    placement: str = "mesh"         # mesh | scan
    local_opt: str = "sgd"
    local_opt_kwargs: tuple = ()
    delta_dtype: str = "float32"    # bfloat16 variant = memory hillclimb
    compute_dtype: str = "bfloat16"
    # secure aggregation: step 4's reduction runs through the uint32-ring
    # masking layer (core/secure_agg.py).  Frozen and hashable, so it keys
    # the chunk graphs like every other field.  mesh placement only: the
    # pairwise-mask grid needs the whole [C, ...] cohort stack
    secure: Optional[SecureAggSpec] = None

    def __post_init__(self):
        for name in ("delta_dtype", "compute_dtype"):
            if getattr(self, name) not in DTYPES:
                raise ValueError(f"{name} must be one of {sorted(DTYPES)}, "
                                 f"got {getattr(self, name)!r}")


def _f32(x):
    return x.to(torch.float32)


def _weighted_delta_stack(w_c, final, weights):
    """[C, ...] per-client weighted deltas ``(n_k/n)(w_t - w^k)`` in fp32:
    the difference in the compute dtype, cast, then weighted, as the
    reference forms them; what a client would transmit under masking."""
    C = weights.shape[0]
    return tree_map(
        lambda w0, wk: weights.reshape((C,) + (1,) * w0.dim())
        * _f32(w0[None] - wk), w_c, final)


def _survivors(step_mask):
    """A client with zero unmasked local steps never reported its update
    (dropout): its masked message is absent and its pairwise terms need
    recovery."""
    return None if step_mask is None else torch.sum(step_mask, dim=1) > 0


def _secure_delta(spec, w_c, final, weights, step_mask, t, ddt):
    """Step 4 under secure aggregation: per-client weighted deltas in
    fp32, the masked ring transport with dropout recovery, decoded and
    cast to the delta dtype."""
    y = _weighted_delta_stack(w_c, final, weights)
    return tree_map(
        lambda d: d.to(ddt),
        secure_agg.secure_weighted_sum(y, _survivors(step_mask), spec, t))


def _client_mesh_axes() -> tuple:
    """The live mesh axes the cohort tiles, as a tuple (() outside a mesh)."""
    entry = spmd_client_axes()
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _client_mesh():
    """The live ``Mesh`` when the rules map the cohort onto it, else None
    (no mesh, or 'clients' mapped to no live axis: every rank then runs
    the whole cohort, as the reference's replicated GSPMD fallback)."""
    return current_mesh() if _client_mesh_axes() else None


def _block(tree, lo: int, hi: int):
    return tree_map(lambda x: x[lo:hi], tree)


def _all_reduce_tree(mesh, tree):
    """One ``all_reduce(SUM)`` of every leaf of ``tree`` (one dtype),
    flattened into one buffer."""
    flat = [x.reshape(-1) for x in leaves(tree)]
    buf = mesh.all_reduce_(torch.cat(flat))
    out, start = [], 0
    for x, f in zip(leaves(tree), flat):
        out.append(buf[start:start + f.numel()].reshape(x.shape))
        start += f.numel()
    return unflatten_like(tree, out)


def _block_partial(w_c, final, weights_b, dev):
    """This rank's fp32 weighted-delta partial over its block (zeros for
    an empty block)."""
    if final is None:
        return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                              device=dev), w_c)
    return tree_map(lambda w0, wk: torch.einsum("c,c...->...", weights_b,
                                                _f32(w0[None] - wk)),
                    w_c, final)


def _secure_block_ring(spec, w_c, final, weights_b, survivors, key, C,
                       lo, dev):
    """This rank's share of the cohort's ring total: its block's rows
    encoded, masked and summed, less its share of the dropout recovery
    (``secure_agg.block_ring_sum``)."""
    if final is None:
        return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.int64,
                                              device=dev), w_c)
    return secure_agg.block_ring_sum(
        _weighted_delta_stack(w_c, final, weights_b), survivors, spec, key,
        C, lo)


def _mesh_round(mesh, one_client, rcfg, w_c, batches, weights, mask, t,
                param_axes, ddt, dev, cohort_block):
    """Step 3+4 over the mesh: this rank's block of the cohort, vmapped;
    its fp32 partial (or, under secure aggregation, its ring words) summed
    over the ranks by one ``all_reduce``; the losses all-gathered back to
    cohort order.  ``batches`` holds the whole cohort, or with
    ``cohort_block`` this rank's block already (the device planes'
    gathers)."""
    C = weights.shape[0]
    lo, hi = mesh.block(C)
    if not cohort_block:
        batches = _block(batches, lo, hi)
    batches = tree_map(lambda x: torch.as_tensor(x, device=dev), batches)
    w_b = weights[lo:hi]
    m_b = None if mask is None else mask[lo:hi]
    final, losses_b = None, torch.zeros((0,), dtype=torch.float32, device=dev)
    if hi > lo:
        with spans.device_span("local_update"):
            final, losses_b = (vmap(one_client)(batches) if m_b is None
                               else vmap(one_client)(batches, m_b))
            if param_axes is not None:
                final = shard_tree(final, param_axes, prefix=("clients",))
    with spans.device_span("aggregate"):
        if rcfg.secure is not None:
            spec = rcfg.secure
            key = secure_agg.round_mask_key(spec, t, dev) if spec.masked \
                else None
            ring = _secure_block_ring(spec, w_c, final, w_b,
                                      _survivors(mask), key, C, lo, dev)
            ring = tree_map(lambda r: r & secure_agg.RING_MASK,
                            _all_reduce_tree(mesh, ring))
            delta = tree_map(lambda d: d.to(ddt),
                             secure_agg.decode(ring, spec))
        else:
            delta = tree_map(lambda d: d.to(ddt), _all_reduce_tree(
                mesh, _block_partial(w_c, final, w_b, dev)))
    return delta, mesh.all_gather_blocks([(losses_b.to(torch.float32),
                                            C)])[0]


def _check_state_device(state: ServerState, dev: torch.device):
    for x in leaves((state.w, state.extra)):
        if x.device != dev:
            raise ValueError(
                f"server state lies on {x.device} but the round runs on "
                f"{dev}: move it there first (interop.server_state_from_"
                f"numpy / tree_map(lambda x: x.to(device), ...))")


def round_step(loss_fn, server_opt: ServerOpt, state: ServerState,
               batches: Any, weights, rcfg: RoundConfig,
               param_axes: Optional[Any] = None,
               lr=None, step_mask=None, device=None,
               cohort_block: bool = False) -> tuple:
    """One federated round.

    ``batches``: tree with leading axes [C, H, ...] (C clients x H local
    minibatches).  ``weights``: [C] fp32, the n_k/n of the sampled clients.
    ``lr``: per-round client stepsize gamma_t (overrides rcfg.lr).
    ``step_mask``: optional [C, H] {0,1} — heterogeneous local work H_k per
    client.  Aggregation keeps the raw n_k/n weights: a fully-masked client
    returns w^k = w_t and contributes zero to delta_t.  Only the *metrics*
    reweight (over clients that did any work).
    ``device``: where the round runs (``None`` = ``cuda``); batches, weights
    and mask may be numpy arrays or tensors and are moved there, the server
    state must already lie there.
    Under a live data mesh (placement ``"mesh"``) this rank trains its
    block of the cohort; ``cohort_block=True`` says ``batches`` holds that
    block only (weights and mask always cover the whole cohort).
    Returns (new_state, metrics).
    """
    if rcfg.secure is not None and rcfg.placement != "mesh":
        raise ValueError(
            "secure aggregation needs placement='mesh' (got "
            f"{rcfg.placement!r}): the pairwise-mask grid is [C, C, ...] "
            "per leaf, and scan placement exists for FSDP replicas that "
            "cannot even hold the [C, ...] cohort stack")
    dev = resolve_device(device)
    _check_state_device(state, dev)
    mesh = _client_mesh() if rcfg.placement == "mesh" else None
    if mesh is None:
        batches = tree_map(lambda x: torch.as_tensor(x, device=dev), batches)
    weights = torch.as_tensor(weights, dtype=torch.float32, device=dev)
    mask = (None if step_mask is None else
            torch.as_tensor(step_mask, dtype=torch.float32, device=dev))
    C = weights.shape[0]
    opt = local_opt_lib.get(rcfg.local_opt, **dict(rcfg.local_opt_kwargs))
    lr = torch.as_tensor(rcfg.lr if lr is None else lr, dtype=torch.float32,
                         device=dev)
    w_c = tree_map(lambda x: x.to(DTYPES[rcfg.compute_dtype]), state.w)
    ddt = DTYPES[rcfg.delta_dtype]

    def one_client(b, m=None):
        return client_lib.local_update(loss_fn, w_c, b, lr, opt, step_mask=m)

    if mesh is not None:
        delta, losses = _mesh_round(mesh, one_client, rcfg, w_c, batches,
                                    weights, mask, state.t, param_axes, ddt,
                                    dev, cohort_block)
    elif rcfg.placement == "mesh":
        with spans.device_span("local_update"):
            if mask is None:
                final, losses = vmap(one_client)(batches)
            else:
                final, losses = vmap(one_client)(batches, mask)
            if param_axes is not None:
                final = shard_tree(final, param_axes, prefix=("clients",))
        # products and accumulation stay fp32 whatever delta_dtype is; only
        # the reduced result is rounded to ddt
        with spans.device_span("aggregate"):
            if rcfg.secure is not None:
                delta = _secure_delta(rcfg.secure, w_c, final, weights,
                                      mask, state.t, ddt)
            else:
                delta = tree_map(
                    lambda w0, wk: torch.einsum("c,c...->...", weights,
                                                _f32(w0[None] - wk)).to(ddt),
                    w_c, final)
    elif rcfg.placement == "scan":
        if param_axes is not None:
            # scan placement keeps FSDP-sharded params: the broadcast model
            # once, the accumulator every client
            w_c = shard_tree(w_c, param_axes)
        acc = tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                             device=dev), w_c)
        loss_list = []
        for c in range(C):
            b_k = tree_map(lambda x: x[c], batches)
            wk, loss = one_client(b_k, None if mask is None else mask[c])
            acc = tree_map(lambda d, w0, wkl: d + weights[c] * _f32(w0 - wkl),
                           acc, w_c, wk)
            if param_axes is not None:
                acc = shard_tree(acc, param_axes)
            loss_list.append(loss)
        losses = torch.stack(loss_list)
        delta = tree_map(lambda d: d.to(ddt), acc)
    else:
        raise ValueError(rcfg.placement)

    with spans.device_span("server_step"):
        new_state = server_opt.update(state, delta)
    eff_w = weights
    if mask is not None:
        eff_w = weights * (torch.sum(mask, dim=1) > 0).to(torch.float32)
    wsum = torch.clamp(torch.sum(eff_w), min=1e-12)
    metrics = {
        "loss": torch.sum(eff_w * losses) / wsum,
        "losses": losses,
        "delta_norm": _global_norm(delta),
        "completed": torch.sum(eff_w > 0).to(torch.int32),
        "round": state.t,
    }
    return new_state, metrics


def bucketed_round_step(loss_fn, server_opt: ServerOpt, state: ServerState,
                        tier_data: tuple, tier_weights: tuple,
                        rcfg: RoundConfig, param_axes: Optional[Any] = None,
                        lr=None, tier_masks: Optional[tuple] = None,
                        tier_update_fn=None, device=None) -> tuple:
    """One federated round dispatched as per-size-tier launches.

    The cohort arrives grouped by the shard cache's n_k size tiers
    (``data/stream.py`` ``tier_layout``) and each tier runs on its own
    extent: a 4-sample client never rides in the same vmap as a 4096-sample
    one.  ``tier_data`` / ``tier_weights`` / ``tier_masks`` are tuples over
    the occupied tiers: ``tier_weights[i]`` [C_i] fp32 n_k/n (zero-weight
    padding contributes no delta and no loss), ``tier_data[i]`` the tier's
    [C_i, H, b, ...] batch stack (or an opaque payload for
    ``tier_update_fn``), ``tier_masks[i]`` optional [C_i, H] H_k masks.

    ``tier_update_fn(w_c, i, data, mask) -> (final_params [C_i, ...],
    losses [C_i])`` replaces the per-tier vmap (the fused
    ``kernels/client_step`` hook plugs in here).

    The delta accumulates tier by tier, one fp32 einsum each, so a
    multi-tier round equals the padded ``round_step`` within fp32
    reassociation and a single occupied tier equals it bit for bit.
    Under ``rcfg.secure`` that caveat disappears: tier i is masked as a
    sub-cohort under ``fold_in(round_key, i)`` (i its position in
    ``tier_data``, with or without ``tier_update_fn``), and the tiers'
    ring totals add exactly and decode once, bit-equal to the padded
    secure round.  Under a live data mesh each tier splits over the ranks
    as ``round_step``'s cohort does: one ``all_reduce`` a round sums the
    partials (fp32, or the ring words), and one all-gather brings every
    tier's losses back.
    Returns ``(new_state, metrics)`` with ``round_step``'s keys minus the
    per-client ``losses``.
    """
    if rcfg.placement != "mesh":
        raise ValueError(
            "bucketed dispatch is a per-tier vmap — placement='mesh' only "
            f"(got {rcfg.placement!r}); use the padded round_step for scan")
    dev = resolve_device(device)
    _check_state_device(state, dev)
    opt = local_opt_lib.get(rcfg.local_opt, **dict(rcfg.local_opt_kwargs))
    lr_t = torch.as_tensor(rcfg.lr if lr is None else lr,
                           dtype=torch.float32, device=dev)
    w_c = tree_map(lambda x: x.to(DTYPES[rcfg.compute_dtype]), state.w)
    ddt = DTYPES[rcfg.delta_dtype]

    def run_tier(w_c, i, batches, mask):
        batches = tree_map(lambda x: torch.as_tensor(x, device=dev), batches)

        def one_client(b, m=None):
            return client_lib.local_update(loss_fn, w_c, b, lr_t, opt,
                                           step_mask=m)
        final, losses = (vmap(one_client)(batches) if mask is None
                         else vmap(one_client)(batches, mask))
        if param_axes is not None:
            final = shard_tree(final, param_axes, prefix=("clients",))
        return final, losses

    update = tier_update_fn or run_tier
    secure = rcfg.secure
    mesh = _client_mesh()
    round_key = grids = None
    if secure is not None:
        acc = tree_map(lambda x: torch.zeros(x.shape, dtype=torch.int64,
                                             device=dev), w_c)
        if secure.masked:
            round_key = secure_agg.round_mask_key(secure, state.t, dev)
        if secure.masked and mesh is None:
            # every tier's pair draw in one pass, tier i's under
            # fold_in(round_key, i)
            grids = secure_agg.sub_cohort_grids(
                round_key, [len(w) for w in tier_weights],
                max(x.numel() for x in leaves(w_c)))
    else:
        acc = tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                             device=dev), w_c)
    loss_num = torch.zeros((), dtype=torch.float32, device=dev)
    loss_den = torch.zeros((), dtype=torch.float32, device=dev)
    completed = torch.zeros((), dtype=torch.int32, device=dev)
    mesh_losses = []                    # (block losses, C_i, eff_w) a tier
    for i, (data, weights) in enumerate(zip(tier_data, tier_weights)):
        weights = torch.as_tensor(weights, dtype=torch.float32, device=dev)
        mask = (None if tier_masks is None else torch.as_tensor(
            tier_masks[i], dtype=torch.float32, device=dev))
        eff_w = weights
        if mask is not None:
            eff_w = weights * (torch.sum(mask, dim=1) > 0).to(torch.float32)
        if mesh is None:
            final, losses = update(w_c, i, data, mask)
            if secure is not None:
                ring = secure_agg.masked_ring_sum(
                    _weighted_delta_stack(w_c, final, weights),
                    _survivors(mask), secure, None,
                    grid=None if grids is None else grids[i])
                acc = secure_agg.ring_add(acc, ring)
            else:
                acc = tree_map(
                    lambda d, w0, wk: d + torch.einsum(
                        "c,c...->...", weights, _f32(w0[None] - wk)),
                    acc, w_c, final)
            loss_num = loss_num + torch.sum(eff_w * losses)
        else:
            # this rank's block of the tier, as round_step splits a cohort
            C_i = weights.shape[0]
            lo, hi = mesh.block(C_i)
            final = None
            losses = torch.zeros((0,), dtype=torch.float32, device=dev)
            if hi > lo:
                final, losses = update(
                    w_c, i, _block(data, lo, hi),
                    None if mask is None else mask[lo:hi])
            mesh_losses.append((losses.to(torch.float32), C_i, eff_w))
            if secure is not None:
                key = (None if round_key is None
                       else prng.fold_in(round_key, i))
                acc = secure_agg.ring_add(acc, _secure_block_ring(
                    secure, w_c, final, weights[lo:hi], _survivors(mask),
                    key, C_i, lo, dev))
            else:
                acc = tree_map(torch.add, acc, _block_partial(
                    w_c, final, weights[lo:hi], dev))
        loss_den = loss_den + torch.sum(eff_w)
        completed = completed + torch.sum(eff_w > 0).to(torch.int32)
    if mesh is not None:
        # one all_reduce of the partials (an integer one for ring words),
        # and one all-gather of every tier's losses, summed in tier order
        # as one device sums them
        acc = _all_reduce_tree(mesh, acc)
        if secure is not None:
            acc = tree_map(lambda r: r & secure_agg.RING_MASK, acc)
        wholes = mesh.all_gather_blocks([(x, c) for x, c, _ in mesh_losses])
        for losses, (_, _, eff_w) in zip(wholes, mesh_losses):
            loss_num = loss_num + torch.sum(eff_w * losses)
    if secure is not None:
        acc = secure_agg.decode(acc, secure)
    delta = tree_map(lambda d: d.to(ddt), acc)
    new_state = server_opt.update(state, delta)
    metrics = {
        "loss": loss_num / torch.clamp(loss_den, min=1e-12),
        "delta_norm": _global_norm(delta),
        "completed": completed,
        "round": state.t,
    }
    return new_state, metrics


def _global_norm(tree):
    return torch.sqrt(sum(torch.sum(torch.square(_f32(x)))
                          for x in leaves(tree)))


# ---------------------------------------------------------------------------
# eq. (2) reference implementation — used by tests to certify that the
# biased-gradient form (eq. 3, used above) is *identical* to model averaging
# ---------------------------------------------------------------------------
def model_averaging_reference(w_t, local_models, weights):
    """eq. (2): w_{t+1} = sum_{k in S_t} (n_k/n) w^k + (1 - sum n_k/n) w_t."""
    weights = torch.as_tensor(weights, dtype=torch.float32)
    active_mass = torch.sum(weights)
    return tree_map(
        lambda w0, wk: torch.einsum("c,c...->...", weights.to(wk.device),
                                    _f32(wk))
        + (1.0 - active_mass.to(w0.device)) * _f32(w0),
        w_t, local_models)
