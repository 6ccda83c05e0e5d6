"""The program's own spans on one cell, on the card: what a traced run's
recorded slices would read, the recorder's cost, and whole windows with
the recorder on.

    python3 portbench/record.py --workload <cell> --seed <n> \
        [--mode traced|window] [--seconds <s>] [--out <file.jsonl>]

``traced`` (the default): set-up, the checked rounds, then the same rounds
from the same state with the recorder off, off again and on with device
stamps (the trajectory bit-equal; cuDNN deterministic and every graph
captured anew for the three), a traced run's plain and profiled
slices and layer timings (``Program.traced``; a stamped slice before
them too, in a process no profiler has touched yet), then the recorded
slices (``harness/recorded.py``), the plain, host-span and stamped slices again
three times in turns (the recorder's cost), the chunk graphs' node counts,
the profiled slice's kernel launches a round, and every per-layer metric
of the cell, the span metrics among them.  ``window``: a window of about
``--seconds`` with the recorder on and device stamps, each chunk's host
spans and each round's stamps written to ``--out``.  One JSON line on
standard output.  A program without the recorder runs what needs none of
it (the node counts, the launches, the layer metrics).
"""
import time

T_START = time.time()

import argparse   # noqa: E402
import contextlib  # noqa: E402
import ctypes     # noqa: E402
import json       # noqa: E402
import os         # noqa: E402
import sys        # noqa: E402
from collections import defaultdict  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every per-layer quantity of the two cells, the accepted and the span ones
QUANTITIES = (
    "device_idle_pct", "mfu", "fedmom_update_roofline_pct",
    "server_step_ms", "local_update_ms", "sample_ms", "gather_ms",
    "moe_layer_ms", "host_busy_ms", "idle_on_host_pct", "sample_span_ms",
    "gather_span_ms", "local_update_span_ms", "aggregate_span_ms",
    "server_step_span_ms", "moe_span_ms")


def _graph_nodes(graph) -> int:
    """Nodes of a ``torch.cuda.CUDAGraph`` captured with ``keep_graph``
    (``cuGraphGetNodes`` of ``libcuda``)."""
    lib = ctypes.CDLL("libcuda.so.1")
    n = ctypes.c_size_t(0)
    err = lib.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()), None,
                              ctypes.byref(n))
    if err:
        raise RuntimeError(f"cuGraphGetNodes failed: {err}")
    return int(n.value)


def graph_nodes(prog, spans) -> dict:
    """[rounds, nodes] of each of the cell's chunk graphs, captured anew
    with the recorder off and, where the program has one, with device
    stamps.  The graphs are captured with ``keep_graph`` (which only
    keeps the graph a replay instantiates), then dropped."""
    import functools
    import torch
    if not prog.chunk:
        return {}
    graphs = prog.trainer.session.graphs
    made = torch.cuda.CUDAGraph
    torch.cuda.CUDAGraph = functools.partial(made, keep_graph=True)
    out = {}
    try:
        for name, ctx in (("off", contextlib.nullcontext()),
                          ("stamped",
                           spans and spans.recording(device=True))):
            if not ctx:
                continue
            graphs.clear()
            with ctx:
                prog._run(1 + prog.chunk)
            out[name] = [[g.n_rounds, _graph_nodes(g.graph)]
                         for g in graphs.values()]
    finally:
        torch.cuda.CUDAGraph = made
        graphs.clear()
    return out


def _flat(state):
    import torch
    from repro_torch.tree import leaves
    return torch.cat([x.detach().reshape(-1).float().cpu()
                      for x in leaves((state.w, state.extra))])


def bit_check(prog, spans) -> dict:
    """The window's call over the checked rounds' count from one state:
    recorder off, off again, on with device stamps.  Losses and final
    state compared bit for bit."""
    import torch
    from repro_torch.tree import tree_map
    n = int(prog.cell.mix["check_rounds"])
    tr = prog.trainer
    s0 = tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x,
                  tr.state)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    tr.session.graphs.clear()     # the check's graphs captured under it
    runs = []
    try:
        for on in (False, False, True):
            tr.state = tree_map(lambda x: x.clone()
                                if isinstance(x, torch.Tensor) else x, s0)
            if on:
                with spans.recording(device=True) as rec:
                    hist = prog._run(n)
            else:
                hist = prog._run(n)
            torch.cuda.synchronize()
            runs.append(([r["loss"] for r in hist[-n:]], _flat(tr.state)))
    finally:
        torch.backends.cudnn.deterministic = det
        tr.session.graphs.clear()
    eq = [a[0] == b[0] and torch.equal(a[1], b[1])
          for a, b in ((runs[0], runs[1]), (runs[0], runs[2]))]
    return {"rounds": n, "off_off": eq[0], "off_on": eq[1],
            "stamped_rounds": len(rec.device),
            "losses": runs[0][0]}


def cost(prog, spans, n: int, turns: int = 3) -> dict:
    """Wall ms a round of ``n`` rounds: plain, host spans alone, host spans
    and device stamps, in turns."""
    import torch
    out = defaultdict(list)

    def timed(name, ctx):
        torch.cuda.synchronize()
        with ctx:
            t0 = time.perf_counter()
            prog._run(n)
            torch.cuda.synchronize()
            out[name].append((time.perf_counter() - t0) * 1e3 / n)
    for _ in range(turns):
        timed("plain", contextlib.nullcontext())
        timed("host_spans", spans.recording(device=False))
        timed("stamped", spans.recording(device=True))
    return dict(out)


def traced(cell, seed: int, device) -> dict:
    import torch
    from portbench.harness import cell as cell_lib
    from portbench.harness import recorded
    from portbench.harness.hw import (FEDMOM_BYTES_PER_ELEMENT, HBM_BW,
                                      PEAK_FLOPS)
    from portbench.harness import flops
    from portbench.harness.spec import reader
    spans = recorded.recorder()
    prog = cell_lib.Program(cell, seed, device)
    out = {"has_recorder": spans is not None}
    prog.checked_rounds()
    if spans is not None:
        out["bit_check"] = bit_check(prog, spans)
    n = prog.warm_and_size(cell_lib.TRACE_SLICE_S)
    n = max(n, 1 if prog.chunk else 2)
    if spans is not None:
        # the same slice before any profiler has run in the process
        out["stamped_before_profiler"] = recorded.stamped(prog, n)
    trace = prog.traced(n)
    out["launches_a_round"] = sum(c for _, c in trace["kernels"].values()) \
        / n
    if spans is not None:
        trace["recorded"] = {"stamped": recorded.stamped(prog, n),
                             "profiled": recorded.profiled(prog, n)}
        out["cost_ms_a_round"] = cost(prog, spans, n)
        for name, got in trace["recorded"].items():
            c = got["counters"]
            print(f"slice {name}: graph.captures "
                  f"{c.get('graph.captures', 0)} kernel.builds "
                  f"{c.get('kernel.builds', 0)}", file=sys.stderr)
    rec = {"config": cell.config, "mix": cell.mix, "ranks": [trace],
           "round_flops": prog.fam.round_flops(),
           "tree_elements": flops.tree_elements(prog.shapes),
           "peak_flops": PEAK_FLOPS[cell.config["precision"]["mfu_peak"]],
           "hbm_bw": HBM_BW, "fedmom_bytes": FEDMOM_BYTES_PER_ELEMENT,
           "chips": 1}
    out["metrics"] = {}
    for q in QUANTITIES:
        name = f"{q}.{'per_round' if prog.chunk == 0 else 'device_plane'}"
        v = reader(name)(rec)
        if v is not None:
            out["metrics"][name] = v
    out["rounds"] = n
    out["plain_ms_a_round"] = trace["plain_wall_s"] * 1e3 / n
    out["device_idle_pct"] = 100 * (1 - trace["busy_s"] / trace["wall_s"])
    out["recorded"] = trace.get("recorded")
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    out["graph_nodes"] = graph_nodes(prog, spans)
    prog.free()
    return out


def window(cell, seed: int, device, seconds: float, out_path: str) -> dict:
    """A window of about ``seconds`` with the recorder on: each chunk (or
    round) a line of its host spans' ms by name, its start, and its
    rounds' device span ms."""
    import torch
    from portbench.harness import cell as cell_lib
    from portbench.harness import recorded
    spans = recorded.recorder()
    prog = cell_lib.Program(cell, seed, device)
    prog.checked_rounds()
    n = prog.warm_and_size(seconds)
    with spans.recording(device=True):
        prog._run(1 + prog.chunk if prog.chunk else 1)
    torch.cuda.synchronize()
    with spans.recording(device=True) as rec:
        t0 = time.perf_counter()
        prog._run(n)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_id = defaultdict(lambda: defaultdict(int))
    starts = {}
    for s in rec.spans:
        if s.id is None:
            continue
        by_id[s.id][s.name] += s.end_ns - s.start_ns
        if s.name in ("chunk.dispatch", "round.inputs"):
            starts[s.id] = s.start_ns
    ids = sorted(starts)
    with open(out_path, "w") as f:
        for i, sid in enumerate(ids):
            nxt = ids[i + 1] if i + 1 < len(ids) else None
            rounds = [t for t in rec.device if sid <= t < (nxt or 1 << 62)]
            dev = defaultdict(int)
            for t in rounds:
                for k, v in rec.device[t].items():
                    dev[k] += v
            f.write(json.dumps({
                "id": sid, "start_ns": starts[sid], "rounds": len(rounds),
                "period_ms": ((starts[nxt] - starts[sid]) / 1e6
                              if nxt is not None else None),
                "host_ms": {k: v / 1e6 for k, v in by_id[sid].items()},
                "device_ms": {k: v / 1e6 for k, v in dev.items()}}) + "\n")
    res = {"rounds": n, "wall_s": wall, "ms_a_round": wall * 1e3 / n,
           "counters": dict(rec.counters), "lines": len(ids)}
    prog.free()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--mode", choices=("traced", "window"), default="traced")
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--out", default="build/record_window.jsonl")
    args = ap.parse_args(argv)
    for p in (ROOT, ROOT / "src"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    import torch
    from portbench.harness.spec import load_cell
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    dev = torch.device("cuda")
    if args.mode == "traced":
        out = traced(cell, args.seed, dev)
    else:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        out = window(cell, args.seed, dev, args.seconds, args.out)
    out.update(workload=args.workload, seed=args.seed, mode=args.mode,
               card=torch.cuda.get_device_name(dev),
               total_s=time.time() - T_START)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
