"""What the per-layer metrics read from a traced run's record: one
function a quantity.  A metric's file under ``metrics/`` names the
function it reads with; a reader that finds nothing to read returns
``None``, and the metric is left out of the line.

``rec`` holds the cell's ``config`` and ``mix``, ``ranks`` (a profiled
slice's summary on each card: ``wall_s`` and ``busy_s`` profiled,
``plain_wall_s`` the same rounds unprofiled, ``rounds``, the
device seconds and launches by ``kernels`` name, and the layers'
CUDA-event ``timings``), ``round_flops``, ``tree_elements``,
``peak_flops``, ``hbm_bw``, ``fedmom_bytes`` and ``chips``.
"""


def _first(rec):
    ranks = rec.get("ranks") or []
    return ranks[0] if ranks else None


def _kernel_s(r0, match) -> float:
    return sum(s for name, (s, _) in r0.get("kernels", {}).items()
               if match(name))


def device_idle(rec):
    """The share of the profiled slice's wall time in which no kernel ran
    on the card (the union of the device events' intervals), the mean
    over the cell's cards."""
    ranks = [r for r in rec.get("ranks") or [] if r.get("wall_s")]
    if not ranks or not any(r.get("kernels") for r in ranks):
        return None
    return sum(100.0 * (1.0 - r["busy_s"] / r["wall_s"])
               for r in ranks) / len(ranks)


def mfu(rec):
    """The rounds' analytic model flops (``harness/flops.py``: what the
    model needs, not what the program ran) over the slice's wall time
    without the profiler, as a share of the data-sheet peak of the
    configuration's compute precision times the cell's cards."""
    r0 = _first(rec)
    if (r0 is None or not rec.get("round_flops")
            or not r0.get("plain_wall_s")):
        return None
    return (100.0 * rec["round_flops"] * r0["rounds"]
            / (r0["plain_wall_s"] * rec["peak_flops"] * rec["chips"]))


def fedmom_update_roofline(rec):
    """The fused FedMom server step's least time on the cell's tree (20
    bytes an element: w, v and delta read, w and v written, at the card's
    3.35 TB/s) over its profiled device time a round (kernels named
    ``tree_update_kernel``), on the first card."""
    r0 = _first(rec)
    if r0 is None:
        return None
    secs = _kernel_s(r0, lambda n: "tree_update_kernel" in n)
    if secs <= 0:
        return None
    bound = rec["fedmom_bytes"] * rec["tree_elements"] / rec["hbm_bw"]
    return 100.0 * bound / (secs / r0["rounds"])


def layer_ms(name: str):
    """A reader of one layer's CUDA-event time on the first card, its call
    timed alone at the cell's shapes (``Program.layer_timings``): on a
    graphed plane as graph replays (the device's time), on the per-round
    plane as eager calls."""
    def read(rec):
        r0 = _first(rec)
        return None if r0 is None else r0.get("timings", {}).get(name)
    return read
