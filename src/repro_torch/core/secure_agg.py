"""Secure aggregation: fixed-point pairwise masking that cancels
bit-exactly (Bonawitz et al. 2017, simulation), the counterpart of the JAX
package's ``core/secure_agg.py``.

Clients i < j agree on a mask m_ij; client i sends y_i + m_ij, client j
sends y_j - m_ij, and the server's sum is unchanged while every message
is uniformly random.  The masking runs in the ring Z_{2^32}:

1. *Encode*: each weighted per-client delta leaf is quantized to fixed
   point, ``q = round(y * 2^frac_bits)``, saturated to int32 (NaN -> 0,
   as the reference's float-to-int32 cast does) and taken mod 2^32.
2. *Mask*: the pair key is ``k_ij = fold_in(fold_in(fold_in(PRNGKey(seed),
   t), min(i,j)), max(i,j))`` and ``m_ij = random_bits(k_ij, shape)``.
   Client i adds ``+m_ij`` for every j > i and ``-m_ij`` for every j < i.
3. *Aggregate*: the server ring-sums the masked rows; every ``+m_ij /
   -m_ij`` pair cancels exactly, so the decoded sum equals the decoded sum
   of the open encodings bit for bit.

Dropout recovery: with survivor set S the masked sum over S carries
``sum_{i in S, j not in S} sign(i,j) m_ij``, which the server (owner of the
PRG root in this simulation) recomputes and subtracts.

Torch has no ``add`` for ``uint32``, so ring words are ``int64`` tensors
holding values in [0, 2^32), reduced with ``& 0xFFFFFFFF`` after every
addition (sums of up to 2^31 words fit in int64 before the reduction).

The mask grid.  The reference draws ``bits(k_ij, leaf.shape)`` for every
ordered pair (i, j) and every leaf under the same pair key.  Threefry is
counter-based over the row-major iota, so ``bits(k, shape)`` is the first
``prod(shape)`` words of ``bits(k, (N,))``, and (i, j) and (j, i) share a
key.  Here each unordered pair i < j is drawn once, at the largest leaf's
size, and every leaf's masks are prefixes of that draw: the same words as
the reference's per-leaf grid (``tests/test_torch_secure_agg.py`` holds
them bit for bit), for C(C-1)/2 pairs instead of C^2, and one draw a
cohort instead of one a leaf.  Masking and recovery share the draw.

Every function runs on the device of its inputs; the round index ``t`` may
be a device tensor and ``scale`` stays a Python float, so a round under
masking copies nothing from the host and can be captured in a CUDA graph.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, List, Optional

import torch

from repro_torch import random as prng
from repro_torch.tree import leaves, tree_map, unflatten_like

_M32 = 0xFFFFFFFF
RING_MASK = _M32             # a sum of ring words, reduced into the ring
_I32_MIN, _I32_MAX = -2 ** 31, 2 ** 31 - 1


class EmptyCohortError(ValueError):
    """Aggregation over zero reporting clients.

    Raised (naming the round when known) instead of an IndexError: a
    fully-dropped round under scenario dropout models is a legitimate
    runtime state the caller must be able to catch, or avoid by passing
    ``like=`` for a zeros-like delta (eq. (3)'s "nobody moved").
    """

    def __init__(self, round: Optional[int] = None):
        self.round = round
        where = f" in round {round}" if round is not None else ""
        super().__init__(
            f"secure aggregation received an empty cohort{where}: no "
            f"client reported an update (e.g. every sampled client "
            f"dropped).  Pass like=<param tree> to aggregate_masked for "
            f"a zeros-like delta instead of this error.")


@dataclass(frozen=True)
class SecureAggSpec:
    """Declarative secure-aggregation config (hashable: it rides on
    ``RoundConfig`` / ``ExecutionPlan`` and keys the chunk graphs).

    ``masked=True`` is the protocol (pairwise PRG masks + dropout
    recovery); ``masked=False`` is the *open ring*: the same fixed-point
    encode / aggregate / decode without masks, which the masked run is
    bit-equal to.  ``seed`` roots the mask PRG (folded with the round
    index); ``frac_bits`` sets the fixed-point precision: values are
    multiples of ``2^-frac_bits`` and the aggregate must stay below
    ``2^(31 - frac_bits)`` in magnitude or the ring wraps."""
    masked: bool = True
    seed: int = 0
    frac_bits: int = 20

    def __post_init__(self):
        if not isinstance(self.masked, bool):
            raise ValueError(f"masked must be a bool, got {self.masked!r}")
        if not isinstance(self.frac_bits, int) \
                or not 1 <= self.frac_bits <= 30:
            raise ValueError(
                f"frac_bits must be an int in [1, 30] (uint32 ring), got "
                f"{self.frac_bits!r}")

    @property
    def scale(self) -> float:
        return float(2 ** self.frac_bits)


_DEFAULT_SPEC = SecureAggSpec()


# ---------------------------------------------------------------------------
# fixed-point ring codec
# ---------------------------------------------------------------------------
def _encode_leaf(x: torch.Tensor, spec: SecureAggSpec) -> torch.Tensor:
    r = torch.round(x.to(torch.float32) * spec.scale)
    # the reference's float -> int32 cast saturates and maps NaN to 0; a
    # torch cast does neither (and the CPU and the card differ), so clamp
    # in float to [-2^31, 2^31] (both exact in float32; 2^31 - 1 is not),
    # convert, then clamp the integers
    r = torch.where(torch.isnan(r), torch.zeros_like(r), r)
    r = torch.clamp(r, float(_I32_MIN), float(-_I32_MIN))
    q = torch.clamp(r.to(torch.int64), _I32_MIN, _I32_MAX)
    return q & _M32


def _decode_leaf(q: torch.Tensor, spec: SecureAggSpec) -> torch.Tensor:
    signed = q - ((q >> 31) << 32)           # the word read as int32
    return signed.to(torch.float32) / spec.scale


def encode(tree: Any, spec: SecureAggSpec = _DEFAULT_SPEC) -> Any:
    """fp tree -> ring tree: round-half-even fixed point, saturated to
    int32, two's-complement words in [0, 2^32) held as int64."""
    return tree_map(lambda x: _encode_leaf(x, spec), tree)


def ring_add(a: Any, b: Any) -> Any:
    """Elementwise ring addition of two ring trees."""
    return tree_map(lambda x, y: (x + y) & _M32, a, b)


def decode(tree: Any, spec: SecureAggSpec = _DEFAULT_SPEC) -> Any:
    """ring tree -> fp32 tree (inverse of ``encode`` on the fixed-point
    grid)."""
    return tree_map(lambda q: _decode_leaf(q, spec), tree)


# ---------------------------------------------------------------------------
# the pairwise mask grid
# ---------------------------------------------------------------------------
def _round_key(spec: SecureAggSpec, t, device=None) -> torch.Tensor:
    """Per-round mask root ``fold_in(PRNGKey(seed), t)``, made on
    ``device`` (``t``'s device when ``t`` is a tensor)."""
    if device is None and isinstance(t, torch.Tensor):
        device = t.device
    if not isinstance(t, torch.Tensor):
        t = int(t)
    return prng.fold_in(prng.PRNGKey(spec.seed, device=device), t)


# index tensors per (cohort size, device) and per (tier sizes, device)
_PAIRS: dict = {}


def _pairs(C: int, device: torch.device) -> tuple:
    """``(lo, hi)`` int64 [C(C-1)/2]: the unordered pairs lo < hi in
    row-major order, made once per (C, device) (the first use, a chunk
    graph's warm-up, fills it; a capture then only reads it)."""
    key = (C, str(device))
    if key not in _PAIRS:
        lo, hi = torch.triu_indices(C, C, 1, device=device)
        _PAIRS[key] = (lo, hi)
    return _PAIRS[key]


def _pair_bits(key: torch.Tensor, C: int, n: int) -> tuple:
    """``(lo, hi, bits)``: ``bits[p]`` is ``random_bits(k_p, (n,))`` under
    the canonical pair key of pair p = (lo[p], hi[p]); a leaf of
    ``prod(shape) <= n`` words takes its prefix."""
    lo, hi = _pairs(C, key.device)
    kij = prng.fold_in(prng.fold_in(key, lo), hi)            # [P, 2]
    return lo, hi, prng.random_bits(kij, (n,))               # [P, n]


def sub_cohort_grids(round_key: torch.Tensor, sizes, n: int) -> list:
    """The pair draws of several sub-cohorts in one threefry pass:
    sub-cohort i, of ``sizes[i]`` clients, is masked under
    ``fold_in(round_key, i)`` (the bucketed engine's tiers), and its draw
    is ``(lo, hi, bits [P_i, n])``, the words ``_pair_bits`` gives it
    alone.  One pass for a round's tiers instead of one a tier: the
    streaming lanes run eagerly, where every launch costs the host."""
    dev = round_key.device
    if not sizes:
        return []
    key = (tuple(int(c) for c in sizes), str(dev))
    if key not in _PAIRS:
        parts = [_pairs(C, dev) for C in key[0]]
        owner = torch.cat([torch.full((lo.numel(),), i, dtype=torch.int64,
                                      device=dev)
                           for i, (lo, _) in enumerate(parts)])
        _PAIRS[key] = (parts, owner, torch.cat([lo for lo, _ in parts]),
                       torch.cat([hi for _, hi in parts]))
    parts, owner, lo, hi = _PAIRS[key]
    sub_keys = prng.fold_in(round_key, torch.arange(len(parts), device=dev))
    kij = prng.fold_in(prng.fold_in(sub_keys[owner], lo), hi)
    bits = prng.random_bits(kij, (n,))
    out, start = [], 0
    for lo_i, hi_i in parts:
        stop = start + lo_i.numel()
        out.append((lo_i, hi_i, bits[start:stop]))
        start = stop
    return out


def _signed_masks(key: torch.Tensor, C: int,
                  leaf: torch.Tensor) -> torch.Tensor:
    """[C, C, *leaf.shape] ring words: entry [i, j] is ``sign(i,j) *
    m_ij`` with the canonical pair key (min, max), the term client i adds
    for partner j.  Antisymmetric in the ring, zero on the diagonal.  The
    reference's per-leaf grid, built from the pair draw."""
    n = leaf.numel()
    lo, hi, bits = _pair_bits(key, C, n)
    grid = torch.zeros((C, C, n), dtype=torch.int64, device=key.device)
    grid[lo, hi] = bits
    grid[hi, lo] = (-bits) & _M32
    return grid.reshape((C, C) + tuple(leaf.shape))


def _mask_rows(lo, hi, bits, C: int, leaf_shape) -> torch.Tensor:
    """[C, *leaf_shape]: row i is ``sum_j sign(i,j) m_ij`` over the prefix
    of the pair draw the leaf takes, in the ring."""
    n = math.prod(int(s) for s in leaf_shape)
    b = bits[:, :n]
    rows = torch.zeros((C, n), dtype=torch.int64, device=bits.device)
    rows.index_add_(0, lo, b)
    rows.index_add_(0, hi, -b)
    return (rows & _M32).reshape((C,) + tuple(leaf_shape))


def _max_numel(tree) -> int:
    return max([1] + [int(x[0].numel()) for x in leaves(tree)])


def _grid_for(key, C: int, tree) -> tuple:
    """The cohort's pair draw at the size of its largest leaf."""
    return _pair_bits(key, C, _max_numel(tree))


def _mask_with(grid, q: Any) -> Any:
    lo, hi, bits = grid
    C = leaves(q)[0].shape[0]
    return tree_map(
        lambda ql: (ql + _mask_rows(lo, hi, bits, C, ql.shape[1:])) & _M32,
        q)


def mask_cohort(key: torch.Tensor, y: Any,
                spec: SecureAggSpec = _DEFAULT_SPEC) -> Any:
    """Encode the ``[C, ...]`` cohort stack of weighted updates into the
    ring and (when ``spec.masked``) blind each row with its pairwise mask
    sum ``sum_j sign(i,j) m_ij``: what each client would transmit."""
    q = encode(y, spec)
    if not spec.masked:
        return q
    return _mask_with(_grid_for(key, leaves(q)[0].shape[0], q), q)


def _survivor_sum(grid, masked: Any, survivors, spec: SecureAggSpec) -> Any:
    """``ring_survivor_sum`` over a given pair draw (``None`` when it is
    not needed: open ring, or every row reported)."""
    if survivors is None:
        return tree_map(lambda ql: torch.sum(ql, dim=0) & _M32, masked)
    C = leaves(masked)[0].shape[0]
    s = survivors.to(device=leaves(masked)[0].device, dtype=torch.int64)

    def leaf_sum(ql):
        total = torch.sum(s.reshape((C,) + (1,) * (ql.dim() - 1)) * ql,
                          dim=0)
        if spec.masked:
            lo, hi, bits = grid
            n = ql[0].numel()
            # sum_{i in S, j not in S} sign(i,j) m_ij over the pairs
            # lo < hi: s_lo (1 - s_hi) m - s_hi (1 - s_lo) m = (s_lo - s_hi) m
            coef = (torch.take(s, lo) - torch.take(s, hi))[:, None]
            recover = torch.sum(coef * bits[:, :n], dim=0)
            total = total - recover.reshape(ql.shape[1:])
        return total & _M32

    return tree_map(leaf_sum, masked)


def ring_survivor_sum(key: Optional[torch.Tensor], masked: Any,
                      survivors: Optional[torch.Tensor] = None,
                      spec: SecureAggSpec = _DEFAULT_SPEC) -> Any:
    """Server-side ring reduction without the final decode: sum the
    reporting rows of the masked ``[C, ...]`` stack and recover the
    absent partners' pairwise terms, returning the ring total.

    The bucketed round engine adds per-tier ring totals and decodes once
    (decoding per tier and adding in fp32 would re-round each partial).

    ``survivors``: optional [C] bool / 0-1, the rows that reported
    (``None`` = everyone).  With masks and ``survivors``, ``key`` (the root
    the cohort was masked with) is required: the recovery subtracts
    ``sum_{i in S, j not in S} sign(i,j) m_ij``, so the result is bit-equal
    to the open ring sum over the survivors."""
    grid = None
    if survivors is not None and spec.masked:
        if key is None:
            raise ValueError(
                "ring_survivor_sum with dropouts needs the per-round "
                "mask key to recover the survivors' pairwise terms")
        grid = _grid_for(key, leaves(masked)[0].shape[0], masked)
    return _survivor_sum(grid, masked, survivors, spec)


def unmask_sum(key: Optional[torch.Tensor], masked: Any,
               survivors: Optional[torch.Tensor] = None,
               spec: SecureAggSpec = _DEFAULT_SPEC) -> Any:
    """``ring_survivor_sum`` + decode: the fp32 aggregate the server
    optimizer consumes."""
    return decode(ring_survivor_sum(key, masked, survivors, spec), spec)


def masked_ring_sum(y: Any, survivors: Optional[torch.Tensor],
                    spec: SecureAggSpec, key: Optional[torch.Tensor],
                    grid: Optional[tuple] = None) -> Any:
    """fp ``[C, ...]`` stack -> encode -> (mask) -> ring survivor sum,
    still in the ring.  One pair draw serves the masking and the
    recovery: the cohort's under ``key``, or ``grid`` when given (one of
    ``sub_cohort_grids``).  The bucketed engine calls this per tier (each
    tier a sub-cohort under its own fold of the round key) and ring-adds
    the totals."""
    q = encode(y, spec)
    if not spec.masked:
        return _survivor_sum(None, q, survivors, spec)
    if grid is None:
        grid = _grid_for(key, leaves(q)[0].shape[0], q)
    return _survivor_sum(grid, _mask_with(grid, q), survivors, spec)


def _block_pairs(C: int, lo: int, hi: int, device) -> tuple:
    """The pairs i < j of a C-cohort that touch rows [lo, hi), in the
    row-major order of ``_pairs``, as ``(i, j, pos_i, row_i, pos_j,
    row_j)``: ``pos_i`` the positions among them whose i lies in the block
    (the pairs the block owns), ``row_i`` that i's row in the block, and
    likewise for j.  Made once per (C, block, device)."""
    key = ("block", C, lo, hi, str(device))
    if key not in _PAIRS:
        i, j = torch.triu_indices(C, C, 1)
        in_i, in_j = (i >= lo) & (i < hi), (j >= lo) & (j < hi)
        touch = in_i | in_j
        i, j, in_i, in_j = i[touch], j[touch], in_i[touch], in_j[touch]
        pos_i = torch.nonzero(in_i).reshape(-1)
        pos_j = torch.nonzero(in_j).reshape(-1)
        _PAIRS[key] = tuple(x.to(device) for x in (
            i, j, pos_i, i[pos_i] - lo, pos_j, j[pos_j] - lo))
    return _PAIRS[key]


def block_ring_sum(y_block: Any, survivors: Optional[torch.Tensor],
                   spec: SecureAggSpec, key: Optional[torch.Tensor], C: int,
                   lo: int) -> Any:
    """One block's share of ``masked_ring_sum(y, survivors, spec, key)``
    over a ``[C, ...]`` cohort of which ``y_block`` holds rows ``[lo, lo +
    len)``: the block's rows encoded and blinded with their pairwise masks
    (only the pairs that touch the block are drawn, each under its
    canonical key, so the words are those of the whole cohort's draw),
    the reporting ones summed, less the dropout recovery of the pairs
    whose lower row the block holds.  ``survivors`` covers the whole
    cohort.  Ring-summed over blocks that partition the cohort, the shares
    are the cohort's total bit for bit: the data mesh's secure round, one
    block a rank."""
    q = encode(y_block, spec)
    first = leaves(q)[0]
    Cb, dev = first.shape[0], first.device
    s_all = None if survivors is None else survivors.to(device=dev,
                                                        dtype=torch.int64)
    if spec.masked:
        i, j, pos_i, row_i, pos_j, row_j = _block_pairs(C, lo, lo + Cb, dev)
        bits = prng.random_bits(prng.fold_in(prng.fold_in(key, i), j),
                                (_max_numel(q),))
        if s_all is not None:
            coef = (torch.take(s_all, i[pos_i])
                    - torch.take(s_all, j[pos_i]))[:, None]

    def leaf(ql):
        n = ql[0].numel()
        if spec.masked:
            rows = torch.zeros((Cb, n), dtype=torch.int64, device=dev)
            rows.index_add_(0, row_i, bits[pos_i, :n])
            rows.index_add_(0, row_j, -bits[pos_j, :n])
            ql = (ql + rows.reshape(ql.shape)) & _M32
        if s_all is None:
            return torch.sum(ql, dim=0) & _M32
        s_b = s_all[lo:lo + Cb].reshape((Cb,) + (1,) * (ql.dim() - 1))
        total = torch.sum(s_b * ql, dim=0)
        if spec.masked:
            total = total - torch.sum(coef * bits[pos_i, :n], dim=0
                                      ).reshape(ql.shape[1:])
        return total & _M32

    return tree_map(leaf, q)


def round_mask_key(spec: SecureAggSpec, t, device=None) -> torch.Tensor:
    """The per-round mask root ``fold_in(PRNGKey(seed), t)`` on ``device``
    (``t``'s device when ``t`` is a tensor, else the CPU by default); the
    round engine derives per-tier sub-cohort keys from it."""
    return _round_key(spec, t, device)


def secure_weighted_sum(y: Any, survivors: Optional[torch.Tensor],
                        spec: SecureAggSpec, t) -> Any:
    """The round engine's step 4 under secure aggregation: weighted
    per-client deltas ``y`` ([C, ...] fp stack) -> masked ring transport ->
    survivor sum + dropout recovery -> decoded fp32 aggregate.  The mask
    root is keyed by ``(spec.seed, t)`` on ``y``'s device, so every plane
    derives the same masks for round ``t``."""
    key = (_round_key(spec, t, leaves(y)[0].device) if spec.masked
           else None)
    return decode(masked_ring_sum(y, survivors, spec, key), spec)


# ---------------------------------------------------------------------------
# list-shaped protocol API (what a per-client transport would carry)
# ---------------------------------------------------------------------------
def mask_client_updates(root_key: torch.Tensor, updates: List[Any],
                        weights, spec: SecureAggSpec = _DEFAULT_SPEC
                        ) -> List[Any]:
    """Weight + encode + blind the per-client updates: the list of ring
    trees the clients would transmit (uniformly random per message when
    ``spec.masked``; the weighted, quantized update when not)."""
    if not updates:
        return []
    weights = torch.as_tensor(weights, dtype=torch.float32,
                              device=leaves(updates[0])[0].device)
    y = unflatten_like(updates[0], [
        torch.stack([weights[i] * x.to(torch.float32)
                     for i, x in enumerate(xs)])
        for xs in zip(*(leaves(u) for u in updates))])
    masked = mask_cohort(root_key, y, spec) if spec.masked \
        else encode(y, spec)
    return [tree_map(lambda ql, i=i: ql[i], masked)
            for i in range(len(updates))]


def aggregate_masked(masked: List[Any], *,
                     spec: SecureAggSpec = _DEFAULT_SPEC,
                     key: Optional[torch.Tensor] = None,
                     survivors: Optional[torch.Tensor] = None,
                     like: Optional[Any] = None,
                     round: Optional[int] = None) -> Any:
    """The only thing the server may compute: the ring sum, decoded.

    An empty cohort returns a zeros-like fp32 delta when ``like`` (any
    tree with the update structure) is given, and raises
    ``EmptyCohortError`` naming ``round`` otherwise.  A single-client
    cohort has no pairs and aggregates to that client's own weighted
    update.  ``survivors`` / ``key``: dropout recovery (``unmask_sum``)."""
    if not masked:
        if like is not None:
            return tree_map(lambda x: torch.zeros(
                tuple(torch.as_tensor(x).shape), dtype=torch.float32,
                device=torch.as_tensor(x).device), like)
        raise EmptyCohortError(round)
    stacked = unflatten_like(masked[0], [
        torch.stack(ls) for ls in zip(*(leaves(m) for m in masked))])
    return unmask_sum(key, stacked, survivors, spec)
