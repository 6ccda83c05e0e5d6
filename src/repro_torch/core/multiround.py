"""Chunks of federated rounds run back to back on the device.

The JAX package traces a chunk of rounds into one jitted ``lax.scan``.
Here the body of one round is written once per plane, as a function of
the round's device inputs (the round index ``t``, the stepsize ``lr`` and
the optional [C, H] step mask), and a chunk is a Python loop over it that
enqueues every round's work without reading anything back: the per-round
metrics stay device tensors, stacked over the chunk.  On the CPU that loop
runs eagerly.  On the card the scanned and device planes capture it as one
CUDA graph per chunk shape and replay it for every chunk
(``launch/graph.py`` ``ChunkGraph``), with ``t0``, the ``lrs`` and the
masks (and the scanned plane's batches) in static device tensors: ``t``
is then ``t0 + r``, an int64 device tensor, so each replay draws the
clients and minibatches of its own rounds, and folds its own rounds'
secure-aggregation mask keys and DP noise keys (``round_step`` reads the
round from the server state's ``t``, which the chunk carries as that
tensor).

* ``scan_rounds``: host-staged ``[R, C, H, ...]`` batches and ``[R, C]``
  weights (the scanned plane; the trainer's producer thread assembles
  them ahead);
* ``scan_rounds_sampled``: the same host-staged batches, with each round's
  weights drawn by ``sampler.sample_device(key, t)`` on the device;
* ``scan_rounds_ondevice``: each round samples S_t with the keyed draw on
  the device, gathers its ``[C, H, b, ...]`` minibatches from a dataset
  honouring the ``gather_round_batch`` contract (the packed
  ``DeviceFederatedDataset`` of the device plane, or a streaming
  ``CacheView``) and runs ``round_step``.  Draws are keyed by
  ``(seed, t, client_id)``, so the trajectory is the per-round plane's.
* ``scan_rounds_bucketed``: the cohort is staged on the host grouped by
  cache size tier, with the keyed minibatch draws staged too (or drawn
  here, tier by tier, when they are not); either every tier's rows are
  gathered and concatenated into one ``round_step`` (fused-concat form),
  or each tier goes through a ``client_step_fn`` hook
  (``bucketed_round_step``), such as the fused ``kernels/client_step``.

Every function takes the reference's arguments in its order, with
``device`` last; ``lrs`` / ``step_masks`` may be host values or device
tensors, ``t0`` an int or an int64 device tensor.  The returned metrics
are [R] ``loss`` / ``delta_norm`` / ``completed`` device tensors and
``round``: host ints while the server state's ``t`` is a host int, an [R]
device tensor when it is a device tensor (inside a captured chunk).
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch import spans
from repro_torch.core.round import (RoundConfig, _client_mesh,
                                    bucketed_round_step, round_step)
from repro_torch.core.server_opt import ServerOpt, ServerState
from repro_torch.data.federated import minibatch_indices
from repro_torch.device import resolve_device, to_device
from repro_torch.tree import leaves, tree_map

_STACKED = ("loss", "delta_norm", "completed")


def _stack(per_round: list) -> dict:
    """[R] device tensors per metric; ``round`` as host ints (or one [R]
    tensor when the rounds carried a device counter); a ``clients``
    stream, when the rounds carry one, as [R, C]."""
    out = {k: torch.stack([m[k] for m in per_round]) for k in _STACKED}
    rounds = [m["round"] for m in per_round]
    out["round"] = (torch.stack(rounds)
                    if isinstance(rounds[0], torch.Tensor)
                    else [int(t) for t in rounds])
    if "clients" in per_round[0]:
        out["clients"] = torch.stack([m["clients"] for m in per_round])
    return out


def _lr(lrs, r: int, rcfg: RoundConfig):
    """Round r's stepsize: ``rcfg.lr``, a host float, or a 0-d view of a
    device tensor (no copy)."""
    if lrs is None:
        return rcfg.lr
    return lrs[r] if isinstance(lrs, torch.Tensor) else float(lrs[r])


def _round_of(t0, r: int):
    return t0 + r if isinstance(t0, torch.Tensor) else int(t0) + r


def _rounds(state: ServerState, n_rounds: int, rcfg: RoundConfig, lrs,
            step_masks, one_round: Callable, device) -> tuple:
    """The chunk loop every plane shares: ``one_round(state, r, lr, mask)
    -> (state, metrics)`` for r in [0, n_rounds), nothing read back.  With
    the recorder's device stamps on, round r stamps row r of the chunk's
    ``stamps`` metric."""
    per_round = []
    buf = spans.stamps(n_rounds, device)
    for r in range(n_rounds):
        with spans.frame(buf, r):
            state, metrics = one_round(
                state, r, _lr(lrs, r, rcfg),
                None if step_masks is None else step_masks[r])
        metrics.pop("losses", None)
        per_round.append(metrics)
    out = _stack(per_round)
    if buf is not None:
        out["stamps"] = buf
    return state, out


def scan_rounds(loss_fn: Callable, server_opt: ServerOpt, state: ServerState,
                batches: Any, weights, rcfg: RoundConfig,
                param_axes: Optional[Any] = None, lrs=None,
                step_masks=None, device=None) -> tuple:
    """Run ``R = weights.shape[0]`` rounds on host-staged inputs.

    ``batches`` leaves: [R, C, H, ...]; ``weights``: [R, C]; ``lrs``:
    optional [R] gamma_t; ``step_masks``: optional [R, C, H].  Host arrays
    or device tensors; round r's slices go to ``round_step`` as they are
    (host arrays are moved to ``device`` there).  Returns ``(state,
    metrics)`` with [R] ``loss`` / ``delta_norm`` / ``completed``; the
    per-client ``losses`` are dropped, as in the reference.
    """
    dev = resolve_device(device)

    def one_round(st, r, lr, mask):
        return round_step(loss_fn, server_opt, st,
                          tree_map(lambda x: x[r], batches), weights[r],
                          rcfg, param_axes=param_axes, lr=lr,
                          step_mask=mask, device=dev)

    return _rounds(state, int(weights.shape[0]), rcfg, lrs, step_masks,
                   one_round, dev)


def scan_rounds_sampled(loss_fn: Callable, server_opt: ServerOpt,
                        state: ServerState, batches: Any, sampler,
                        key: torch.Tensor, t0, rcfg: RoundConfig,
                        param_axes: Optional[Any] = None, lrs=None,
                        step_masks=None, device=None) -> tuple:
    """Like ``scan_rounds`` but round ``t0 + r`` takes the weights that
    ``sampler.sample_device(key, t0 + r)`` draws on the device.

    ``batches`` must have been assembled on the host for the same client
    ids the keyed draw picks: ``DeviceUniformSampler.sample`` is the replay
    that guarantees it.
    """
    dev = resolve_device(device)
    key = key.to(dev)

    def one_round(st, r, lr, mask):
        _, w = sampler.sample_device(key, _round_of(t0, r))
        return round_step(loss_fn, server_opt, st,
                          tree_map(lambda x: x[r], batches), w, rcfg,
                          param_axes=param_axes, lr=lr, step_mask=mask,
                          device=dev)

    n_rounds = int(leaves(batches)[0].shape[0])
    return _rounds(state, n_rounds, rcfg, lrs, step_masks, one_round, dev)


def scan_rounds_ondevice(loss_fn: Callable, server_opt: ServerOpt,
                         state: ServerState, dataset, sampler,
                         data_key: torch.Tensor, sample_key: torch.Tensor,
                         t0, n_rounds: int, rcfg: RoundConfig,
                         local_batch_size: int,
                         param_axes: Optional[Any] = None, lrs=None,
                         step_masks=None, device=None) -> tuple:
    """Run rounds ``t0 .. t0 + n_rounds - 1`` with sampling and data gather
    on the device.

    Round ``t``: ``sampler.sample_device(sample_key, t)`` draws S_t, the
    dataset gathers its ``[C, H, b, ...]`` minibatches keyed by
    ``(data_key, t, client_id)`` and ``round_step`` consumes them.  ``lrs``:
    optional [n_rounds]; ``step_masks``: optional [n_rounds, C, H].
    Returns ``(state, metrics)`` with [n_rounds] ``loss`` / ``delta_norm``
    / ``completed``, ``round``, and ``clients`` [n_rounds, C]: the ids the
    device draw picked, which the streaming plane holds against its host
    replay.  Under a live data mesh every rank draws the whole cohort and
    gathers its own block of it (``gather_round_block``).
    """
    dev = resolve_device(device)

    mesh = _client_mesh() if rcfg.placement == "mesh" else None

    def one_round(st, r, lr, mask):
        t = _round_of(t0, r)
        with spans.device_span("sample"):
            idx, w = sampler.sample_device(sample_key, t)
        with spans.device_span("gather"):
            if mesh is None:
                batches = dataset.gather_round_batch(
                    data_key, t, idx, rcfg.local_steps, local_batch_size)
            else:
                batches = dataset.gather_round_block(
                    data_key, t, idx, rcfg.local_steps, local_batch_size,
                    mesh)
        st, metrics = round_step(loss_fn, server_opt, st, batches, w, rcfg,
                                 param_axes=param_axes, lr=lr,
                                 step_mask=mask, device=dev,
                                 cohort_block=mesh is not None)
        metrics["clients"] = idx
        return st, metrics

    return _rounds(state, n_rounds, rcfg, lrs, step_masks, one_round, dev)


def _tier_draws(data_key: torch.Tensor, view, t0: int, tier_cids: tuple,
                need: int) -> tuple:
    """Each tier's keyed minibatch draws, [R, C_i, need]: lane (r, c) is
    ``minibatch_indices(data_key, t0 + r, cids[r, c], n_k, need)``, the
    draw the reference makes inside its scan (one batched draw a tier on
    the host; threefry is counter-based, so it is the per-lane draw)."""
    counts = view.counts.cpu()
    key = data_key.cpu()
    out = []
    for c in tier_cids:
        c = torch.as_tensor(np.asarray(c), dtype=torch.int64)
        R, C = c.shape
        t = (int(t0) + torch.arange(R, dtype=torch.int64)).repeat_interleave(C)
        flat = c.reshape(-1)
        out.append(minibatch_indices(key, t, flat, counts[flat].long(),
                                     need).reshape(R, C, need))
    return tuple(out)


def scan_rounds_bucketed(loss_fn: Callable, server_opt: ServerOpt,
                         state: ServerState, view, tiers_present: tuple,
                         tier_cids: tuple, tier_weights: tuple,
                         data_key: torch.Tensor, t0: int, n_rounds: int,
                         rcfg: RoundConfig, local_batch_size: int,
                         param_axes: Optional[Any] = None,
                         lrs: Optional[Sequence[float]] = None,
                         tier_masks: Optional[tuple] = None,
                         tier_idx: Optional[tuple] = None,
                         client_step_fn: Optional[Callable] = None,
                         device=None) -> tuple:
    """Run ``n_rounds`` rounds with host-staged, tier-bucketed cohorts.

    The reference's argument order, ``device`` last.
    ``tiers_present``: the tier indices with any participant in the chunk.
    ``tier_cids`` / ``tier_weights`` / ``tier_masks`` / ``tier_idx``:
    tuples aligned with it of [R, C_i] client ids, [R, C_i] weights,
    optional [R, C_i, H] H_k masks and optional [R, C_i, H*b] staged
    minibatch draws, each round's per-tier cohort right-padded with a
    resident client of the same tier at weight 0 (padding rows carry
    all-ones masks).  They move to the device once per chunk.  Without
    ``tier_idx`` each tier draws its own: ``minibatch_indices(data_key, t,
    cid, n_k, H*b)`` for round t = t0 + r, bit-equal to the reference's
    draws; with it, ``data_key`` is not read (the trainer stages the same
    draws on the host, ``launch/train.py`` ``_staged_indices``).

    Without ``client_step_fn`` (fused-concat form) each round gathers every
    tier's rows (``CacheView.gather_tier_rows``), concatenates them along
    the cohort axis and runs one ``round_step``.  With it, each tier's
    update goes through the hook inside ``bucketed_round_step``:
    ``client_step_fn(view, tier, cids [C_i], idx [C_i, H*b], w_c, lr,
    mask, local_steps, batch_size) -> (final_params [C_i, ...],
    losses [C_i])``, ``lr`` a host float.  The hook takes the round's draws
    ``idx`` where the reference's takes ``(key, t)`` and draws them itself:
    eagerly, one batched draw a chunk replaces hundreds of small device
    launches a round.

    Same trajectory as ``scan_rounds_ondevice`` within fp32 reduction order
    (bit-equal with one occupied tier).  Returns ``(state, metrics)`` as
    ``scan_rounds_ondevice`` does, without ``clients``.
    """
    dev = resolve_device(device)
    H = rcfg.local_steps
    if tier_idx is None:
        tier_idx = _tier_draws(data_key, view, t0, tier_cids,
                               H * local_batch_size)

    def put(arrays, dtype):            # never blocking the host on a card
        return tuple(to_device(np.asarray(a), dev, dtype) for a in arrays)

    cids = put(tier_cids, torch.int64)
    ws = put(tier_weights, torch.float32)
    idxs = put(tier_idx, torch.int32)
    ms = None if tier_masks is None else put(tier_masks, torch.float32)
    # the engines take each round's stepsize from the device (a host float
    # would be copied, and waited for, once a round); a hook gets it as a
    # host float
    lrs_dev = (None if lrs is None or isinstance(lrs, torch.Tensor)
               else put([np.asarray(lrs, np.float32)], torch.float32)[0])
    per_round = []
    for r in range(n_rounds):
        lr = _lr(lrs, r, rcfg)
        lr_t = lr if lrs_dev is None else lrs_dev[r]
        if client_step_fn is None:
            parts = [view.gather_tier_rows(tier, cids[i][r], idxs[i][r], H,
                                           local_batch_size)
                     for i, tier in enumerate(tiers_present)]
            batch = tree_map(lambda *ls: torch.cat(ls, dim=0), *parts)
            state, metrics = round_step(
                loss_fn, server_opt, state, batch,
                torch.cat([w[r] for w in ws]), rcfg, param_axes=param_axes,
                lr=lr_t,
                step_mask=None if ms is None else torch.cat(
                    [m[r] for m in ms]),
                device=dev)
            del metrics["losses"]
        else:
            def update(w_c, i, data, mask, lr=lr):
                return client_step_fn(view, tiers_present[i], data[0],
                                      data[1], w_c, lr, mask, H,
                                      local_batch_size)
            state, metrics = bucketed_round_step(
                loss_fn, server_opt, state,
                tuple((c[r], ix[r]) for c, ix in zip(cids, idxs)),
                tuple(w[r] for w in ws), rcfg, param_axes=param_axes,
                lr=lr_t, tier_masks=None if ms is None else tuple(
                    m[r] for m in ms),
                tier_update_fn=update, device=dev)
        per_round.append(metrics)
    return state, _stack(per_round)
