"""Timing on the card: CUDA events around the benchmark's own calls into a
layer, and the profiler's device events over a slice of rounds.

``cuda_ms``, ``graph_ms`` and ``device_events`` are the benchmark's copies
of the helpers of the same names in ``chip_smoke.py``.
"""
from __future__ import annotations

import statistics
import time

import torch


def _median_ms(run_once, reps: int, calls_per_rep: int) -> float:
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for e0, e1 in events:
        e0.record()
        run_once()
        e1.record()
    torch.cuda.synchronize()
    return statistics.median(e0.elapsed_time(e1)
                             for e0, e1 in events) / calls_per_rep


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median milliseconds of one eager call (the host's launches count
    where the host is the slower side, as they do in an eager round)."""
    for _ in range(warmup):
        fn()
    return _median_ms(fn, iters, 1)


def graph_ms(fn, iters: int = 20, replays: int = 10) -> float:
    """Median device milliseconds of one call with the host taken out:
    ``iters`` calls captured in one CUDA graph, as the graphed planes run
    them, each of ``replays`` replays timed between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    out = _median_ms(graph.replay, replays, iters)
    del graph
    return out


def device_events(fn) -> tuple:
    """Run ``fn`` under the profiler, the card's activity alone; returns
    (wall s of ``fn`` to its last kernel, [(start ns, end ns, name)] of
    every device event).  The profiler opens 0.1 s before ``fn`` and
    closes 0.1 s after: it drops events whose timestamps fall at a
    window's edges."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.1)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(0.1)
    events = [(e.start_ns(), e.end_ns(), e.name())
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    return wall, events


def summarize(wall: float, events: list, top: int = 10) -> dict:
    """The slice's device summary: busy seconds (the union of the events'
    intervals), seconds and launches by kernel name, and the ``top``
    longest idle gaps between events, each named by the kernels around
    it."""
    events = sorted(events)
    kernels: dict = {}
    busy = 0.0
    gaps = []
    end = None
    last = None
    for s, e, name in events:
        sec, cnt = kernels.get(name, (0.0, 0))
        kernels[name] = (sec + (e - s) / 1e9, cnt + 1)
        if end is None:
            busy += (e - s) / 1e9
            end, last = e, name
            continue
        if s > end:
            gaps.append(((s - end) / 1e9, f"after {last[:60]} before "
                                            f"{name[:60]}"))
            busy += (e - s) / 1e9
        elif e > end:
            busy += (e - end) / 1e9
        if e >= end:
            end, last = e, name
    gaps.sort(key=lambda g: -g[0])
    return {"wall_s": wall, "busy_s": busy, "kernels": kernels,
            "gaps": gaps[:top]}
