"""Slices of rounds recorded by the program's own recorder
(``repro_torch/spans.py``), and what the span readers read from them.

After a traced run's plain and profiled slices, two more slices of the
same ``n`` rounds:

* ``stamped`` (slice c): the recorder on with device stamps, no
  profiler.  Its stamped chunk graphs are warmed first, as
  ``Program.warm_and_size`` warms the plain ones, so the slice captures
  and builds nothing.  The span metrics read it; its wall time against
  the plain slice's is the recorder's cost.
* ``profiled`` (slice d): host spans alone under the profiler: the plain
  slice's graphs, so nothing is captured again.  Each moment the card is
  idle is put under the innermost host span of the trainer's thread
  that covers it (``outside`` where none does); the idle split and the
  named gaps come from it.

A program without the recorder (one older than it) gives ``None`` for
both: its span metrics are left out of the line.
"""
from __future__ import annotations

import time
from collections import Counter

from . import timing

WAITS = ("chunk.wait", "round.wait")
OUTSIDE = "outside"


def recorder():
    """The program's recorder module, or None where the program has
    none."""
    try:
        from repro_torch import spans
    except ImportError:
        return None
    return spans


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def summary(rec, wall_s: float) -> dict:
    """A recording as plain numbers: host ns and count by span name,
    counters, device ns by span name over the stamped rounds."""
    ns, n, dev = Counter(), Counter(), Counter()
    for s in rec.spans:
        ns[s.name] += s.end_ns - s.start_ns
        n[s.name] += 1
    for row in rec.device.values():
        dev.update(row)
    return {"wall_s": wall_s, "rounds": int(rec.counters.get("rounds", 0)),
            "counters": dict(rec.counters), "span_ns": dict(ns),
            "span_n": dict(n), "device_ns": dict(dev),
            "device_rounds": len(rec.device)}


def stamped(prog, n: int):
    """Slice c; ``None`` without the recorder."""
    spans = recorder()
    if spans is None:
        return None
    with spans.recording(device=True):
        prog._run(1 + prog.chunk if prog.chunk else 1)   # warm its graphs
    _sync(prog.device)
    with spans.recording(device=True) as rec:
        t0 = time.perf_counter()
        prog._run(n)
        _sync(prog.device)
        wall = time.perf_counter() - t0
    return summary(rec, wall)


def profiled(prog, n: int, top: int = 10):
    """Slice d; ``None`` without the recorder."""
    spans = recorder()
    if spans is None:
        return None
    with spans.recording(device=False) as rec:
        wall, events = timing.device_events(lambda: prog._run(n))
    out = summary(rec, wall)
    out["idle"] = idle_split(rec.spans, events, top)
    return out


def innermost(host_spans) -> list:
    """[(start ns, end ns, name)] of the innermost span at each moment
    between the first span's start and the last span's end, on the
    thread of the first ``run`` span (``outside`` between spans)."""
    runs = [s for s in host_spans if s.name == "run"]
    if not runs:
        return []
    thread = runs[0].thread
    mine = [s for s in host_spans if s.thread == thread]
    marks = sorted([(s.start_ns, 1, s.seq, s) for s in mine]
                   + [(s.end_ns, 0, -s.seq, s) for s in mine],
                   key=lambda m: m[:3])
    out, stack, last = [], [], None
    for t, opens, _, s in marks:
        if last is not None and t > last:
            out.append((last, t, stack[-1].name if stack else OUTSIDE))
        last = t
        if opens:
            stack.append(s)
        elif s in stack:
            stack.remove(s)
    return out


def idle_split(host_spans, events, top: int = 10) -> dict:
    """The card's idle time over the slice (from the first ``run`` span's
    start to the later of the last span's and the last kernel's end) by
    the innermost host span that covers it, and the ``top`` longest gaps
    between device events, each named by the span covering most of it,
    then by the kernels around it."""
    segs = innermost(host_spans)
    if not segs or not events:
        return None
    lo = segs[0][0]
    hi = max(segs[-1][1], max(e for _, e, _ in events))
    gaps, end, last = [], lo, None
    for s, e, name in sorted(events):
        if e <= lo:
            continue
        if s > end:
            gaps.append((end, s, last, name))
        if e > end:
            end, last = e, name
    if hi > end:
        gaps.append((end, hi, last, None))
    by_span: Counter = Counter()
    named = []
    j = 0
    for g0, g1, before, after in gaps:
        while j < len(segs) and segs[j][1] <= g0:
            j += 1
        cover: Counter = Counter()
        k = j
        while k < len(segs) and segs[k][0] < g1:
            a, b = max(g0, segs[k][0]), min(g1, segs[k][1])
            if b > a:
                cover[segs[k][2]] += b - a
            k += 1
        inside = sum(cover.values())
        if g1 - g0 > inside:
            cover[OUTSIDE] += g1 - g0 - inside
        by_span.update(cover)
        label = cover.most_common(1)[0][0]
        around = (f"after {(before or 'start')[:50]} before "
                  f"{(after or 'end')[:50]}")
        named.append(((g1 - g0) / 1e9, f"{label}: {around}"))
    named.sort(key=lambda g: -g[0])
    idle = sum(by_span.values())
    return {"window_s": (hi - lo) / 1e9, "idle_s": idle / 1e9,
            "by_span_s": {k: v / 1e9 for k, v in by_span.most_common()},
            "on_host_s": sum(v for k, v in by_span.items()
                             if k not in WAITS + (OUTSIDE,)) / 1e9,
            "gaps": named[:top]}
