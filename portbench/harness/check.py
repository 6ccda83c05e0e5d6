"""The comparison that decides ``correct``.

Set-up drives the program through its first rounds by the window's own
call and graphs; the reference works the same rounds out again from the
same inputs.  The numbers compared:

* ``ids_mismatch``: client ids that the program's rounds drew and that
  differ from the reference's, over the checked rounds (exact: limit 0);
* ``loss_gap``: the largest relative gap of a round's loss;
* ``grad_gap``: the first round's biased gradient as the server optimizer
  got it, read back from the program's FedMom state after one round
  (``delta_0 = (w_0 - v_1) / eta``), by the worst leaf: the gap between
  the program's and the reference's norm of the leaf, over the larger of
  the reference's norm of that leaf and of the median leaf;
* ``change_gap``: the same for ``w_n - w_0`` after the checked rounds,
  over the leaves whose reference ``delta_0`` is at least a thousandth of
  the median leaf's (a leaf with no gradient moves by rounding alone);
* ``grad_row_median_gap`` and ``change_row_median_gap``: the median of
  the same gap taken row by row (a leaf's slices along its last axis, a
  vector's elements) over every counted row of the counted leaves.  A
  discrete choice that flips between two computations within rounding of
  each other (a max-pool's argmax, a MoE route near a top-k tie) moves a
  few rows by orders of magnitude and the median of thousands of rows
  not at all, while a lower precision moves every row.

A cell's limits file names the numbers it holds the program to.
"""
from __future__ import annotations

import math
import statistics

import torch

COUNTED = 1e-3


def leaf_gap(prog: dict, ref: dict, leaves=None) -> tuple:
    """(worst gap, its leaf) over ``leaves`` (default: all)."""
    med = statistics.median(ref.values())
    worst, where = 0.0, None
    for k in (leaves if leaves is not None else sorted(ref)):
        den = max(ref[k], med)
        if den == 0.0:
            gap = 0.0 if prog[k] == 0.0 else math.inf
        else:
            gap = abs(prog[k] - ref[k]) / den
        if not gap <= worst:           # NaN counts as the worst
            worst, where = gap, k
    return worst, where


def row_median_gap(prog: dict, ref: dict, leaves) -> float:
    """The median over the counted rows of ``leaves`` of each row's gap:
    the rows whose reference norm is at least a thousandth of the leaf's
    median nonzero row (an embedding's rows of tokens no batch holds get
    no gradient), each against the larger of its own norm and that
    median."""
    gaps = []
    for k in leaves:
        r, p = ref[k], prog[k]
        if r.shape != p.shape:
            return math.inf
        nonzero = r[r > 0]
        if not nonzero.numel():
            continue
        med = float(nonzero.median())
        keep = r >= COUNTED * med
        den = torch.clamp(r[keep], min=med)
        gaps.append((p[keep] - r[keep]).abs() / den)
    if not gaps:
        return math.inf
    g = torch.cat(gaps)
    return math.inf if bool(torch.isnan(g).any()) else float(g.median())


def counted_leaves(ref_delta0: dict) -> list:
    med = statistics.median(ref_delta0.values())
    return [k for k in sorted(ref_delta0) if ref_delta0[k] >= COUNTED * med]


def numbers(prog: dict, ref: dict) -> dict:
    """The compared numbers of a run: ``prog`` and ``ref`` each hold
    ``cohorts``, ``losses``, ``delta0`` and ``change`` (each leaf's norm)
    and ``delta0_rows`` and ``change_rows`` (each leaf's row norms)."""
    ids = sum(a != b for pa, ra in zip(prog["cohorts"], ref["cohorts"])
              for a, b in zip(pa, ra))
    ids += abs(sum(map(len, prog["cohorts"]))
               - sum(map(len, ref["cohorts"])))
    loss_gaps = [abs(p - r) / abs(r) if r else math.inf
                 for p, r in zip(prog["losses"], ref["losses"])]
    loss = (max(loss_gaps) if len(prog["losses"]) == len(ref["losses"])
            else math.inf)
    counted = counted_leaves(ref["delta0"])
    grad, grad_leaf = leaf_gap(prog["delta0"], ref["delta0"])
    change, change_leaf = leaf_gap(prog["change"], ref["change"], counted)
    return {"ids_mismatch": float(ids), "loss_gap": loss,
            "grad_gap": grad, "change_gap": change,
            "grad_row_median_gap": row_median_gap(
                prog["delta0_rows"], ref["delta0_rows"],
                sorted(ref["delta0"])),
            "change_row_median_gap": row_median_gap(
                prog["change_rows"], ref["change_rows"], counted),
            "_grad_leaf": grad_leaf, "_change_leaf": change_leaf,
            "_loss_gaps": loss_gaps,
            "_grad_leaves": leaf_gaps(prog["delta0"], ref["delta0"]),
            "_change_leaves": leaf_gaps(prog["change"], ref["change"]),
            "_losses": [list(prog["losses"]), list(ref["losses"])]}


def leaf_gaps(prog: dict, ref: dict) -> dict:
    """Every leaf's gap, as ``leaf_gap`` measures the worst."""
    return {k: leaf_gap(prog, ref, [k])[0] for k in sorted(ref)}


def judge(nums: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) over the limited numbers."""
    out = {}
    ok = True
    for name, limit in limits.items():
        v = nums[name]
        out[name] = {"value": v, "limit": limit}
        ok = ok and (v <= limit)          # NaN and inf fail
    return ok, out
