#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Runs from the root of a checkout, imports nothing of JAX, and drives the
port's main path — the per-round FedAvg / FedMom LeNet trainer at the
quickstart configuration — on the card.  Phases, each printed as it runs;
any failure exits non-zero:

  1. card and settings: ``nvidia-smi`` name and power limit; TF32 off;
  2. build: every CUDA kernel of the path compiled from ``src/repro_torch/
     csrc`` (one ``nvcc`` per source, all started together);
  3. kernel against plain: each kernel against its plain PyTorch version on
     the card, at the main path's shapes and at a large ragged size, with
     device times (CUDA graphs + events) beside the memory bound;
  4. main path: FedAvg then FedMom (fused kernel) on ``cuda``; losses finite
     and falling, kernel launches counted over exactly this phase; host
     ms/round;
  5. card against CPU: the same FedMom rounds on ``cpu`` and ``cuda``, the
     card's run under the profiler (device-busy share, top kernels);
  6. one JSON line of kernels, then the result line.

Without a card, or outside a checkout of the repo, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (data sheet)

# the quickstart configuration (examples/quickstart_torch.py defaults)
K, M, H, B, LR, BETA = 60, 2, 10, 10, 0.05, 0.9
ETA = K / M
ROUNDS = 30                        # per server optimizer on the main path
CMP_ROUNDS = 3                     # card-against-CPU rounds
CMP_ATOL = 1e-4                    # card vs CPU params after CMP_ROUNDS:
CMP_RTOL = 1e-4                    # cuDNN and the CPU sum the convolutions
                                   # in other orders (fp32, TF32 off); eta=30
                                   # amplifies those last-bit differences


def phase(name):
    print(f"\n== {name}", flush=True)


def _median_ms(run_once, reps, calls_per_rep):
    """Median over ``reps`` runs of ``run_once()`` of the CUDA-event
    milliseconds around it, per call (``calls_per_rep`` calls a run)."""
    import torch
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for e0, e1 in events:
        e0.record()
        run_once()
        e1.record()
    torch.cuda.synchronize()
    return statistics.median(e0.elapsed_time(e1)
                             for e0, e1 in events) / calls_per_rep


def cuda_ms(fn, iters, warmup=3):
    """Median milliseconds of one eager call (host launch cost included
    when the host is the slower side)."""
    for _ in range(warmup):
        fn()
    return _median_ms(fn, iters, 1)


def graph_ms(fn, iters=100, replays=20):
    """Median device milliseconds per call with the host taken out:
    ``iters`` calls captured in one CUDA graph, each of ``replays`` replays
    timed between CUDA events."""
    import torch
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
    return _median_ms(graph.replay, replays, iters)


def profile_device(fn):
    """Run ``fn`` under the profiler; returns (wall s, device-busy s,
    device ops per call of fn, top kernels [(name, s, count)])."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        s, c = by_name.get(evt.name, (0.0, 0))
        by_name[evt.name] = (s + evt.time_range.elapsed_us() / 1e6, c + 1)
    rows = sorted(((k, s, c) for k, (s, c) in by_name.items()),
                  key=lambda r: -r[1])
    return wall, sum(r[1] for r in rows), sum(r[2] for r in rows), rows[:8]


def check_kernel(kernel, ref, kind, n, gen, offset=0):
    """Kernel and plain version on the same card inputs; returns
    (max_abs_err over both outputs, bit-equal?, the inputs and plain fn)."""
    import torch
    dev = torch.device("cuda")
    w = torch.randn(n + offset, generator=gen, device=dev)[offset:]
    s = torch.randn(n + offset, generator=gen, device=dev)[offset:]
    d = 0.01 * torch.randn(n + offset, generator=gen, device=dev)[offset:]
    plain = ref.fedmom_flat if kind == "fedmom" else ref.fedavgm_flat
    wk, sk = kernel.fused_flat(w, s, d, kind, ETA, BETA)
    wr, sr = plain(w, s, d, ETA, BETA)
    torch.cuda.synchronize()
    err = max(float((wk - wr).abs().max()), float((sk - sr).abs().max()))
    bitwise = torch.equal(wk, wr) and torch.equal(sk, sr)
    return err, bitwise, (w, s, d, plain)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false — this "
              "script needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import random as prng
    from repro_torch.core import (RoundConfig, UniformSampler, fedavg,
                                  fedmom)
    from repro_torch.data import FederatedDataset, synthetic_femnist
    from repro_torch.kernels import _build
    from repro_torch.kernels.fedmom_update import kernel as fm_kernel
    from repro_torch.kernels.fedmom_update import ref as fm_ref
    from repro_torch.launch.train import FederatedTrainer
    from repro_torch.models import small
    from repro_torch.tree import leaves, tree_map

    # ------------------------------------------------------------------
    phase("1. card and settings")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip()
    print(card)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}")
    print(f"torch.backends.cudnn.allow_tf32 = "
          f"{torch.backends.cudnn.allow_tf32}")
    print(f"torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32}")

    # ------------------------------------------------------------------
    phase("2. build")
    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        libs = list(pool.map(_build.build, sources))
    build_s = time.perf_counter() - t0
    for lib in libs:
        log = lib.with_suffix(".log")
        print(f"built {lib.relative_to(ROOT)}")
        if log.is_file():
            print(log.read_text().strip())
    print(f"build time {build_s:.2f} s for {len(sources)} source(s)")

    # ------------------------------------------------------------------
    phase("3. kernel against plain (fedmom_update)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    n_main = sum(x.numel() for x in leaves(
        small.lenet_init(prng.PRNGKey(0))))
    sizes = (n_main, 2 ** 26 + 3)
    max_err = 0.0
    timing = {}
    for kind in ("fedmom", "fedavgm"):
        for n in sizes:
            err, bitwise, (w, s, d, plain) = check_kernel(
                fm_kernel, fm_ref, kind, n, gen)
            if not bitwise:
                raise AssertionError(
                    f"{kind} n={n}: kernel differs from the plain version "
                    f"(max abs {err}); both round every operation to "
                    f"nearest without FMA and must agree bit for bit")
            max_err = max(max_err, err)

            def call_kernel():
                return fm_kernel.fused_flat(w, s, d, kind, ETA, BETA)

            def call_plain():
                return plain(w, s, d, ETA, BETA)

            if n < 1 << 20:
                # device time: CUDA-graph replay takes the host out
                ms, plain_ms = graph_ms(call_kernel), graph_ms(call_plain)
                call_ms = cuda_ms(call_kernel, 500)
                plain_call_ms = cuda_ms(call_plain, 500)
            else:
                # at this size the host is hidden behind the device
                ms, plain_ms = cuda_ms(call_kernel, 30), cuda_ms(call_plain,
                                                                 30)
                call_ms, plain_call_ms = ms, plain_ms
            bound_ms = 20.0 * n / HBM_BYTES_PER_S * 1e3
            timing[(kind, n)] = (ms, plain_ms, bound_ms)
            print(f"{kind:8s} n={n:>9d}  max_abs_err={err:.3e} (bit-equal)"
                  f"  kernel {ms * 1e3:.2f} us (device)"
                  f"  plain {plain_ms * 1e3:.2f} us (device)"
                  f"  bound {bound_ms * 1e3:.2f} us (20 B/elem at 3.35 TB/s)"
                  f"  eager call: kernel {call_ms * 1e3:.2f} us, plain "
                  f"{plain_call_ms * 1e3:.2f} us")
            del w, s, d
        # the scalar path: streams not 16-byte aligned
        err, bitwise, _ = check_kernel(fm_kernel, fm_ref, kind, n_main - 1,
                                       gen, offset=1)
        if not bitwise:
            raise AssertionError(f"{kind} unaligned: kernel differs from "
                                 f"the plain version (max abs {err})")
        print(f"{kind:8s} n={n_main - 1:>9d}  unaligned (scalar path) "
              f"bit-equal")
    torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    phase("4. main path: per-round FedAvg then FedMom (fused) on cuda")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    clients, _ = synthetic_femnist(n_clients=K, seed=0)
    ds = FederatedDataset(clients, seed=1)
    pop = ds.population()
    print(f"synthetic FEMNIST: K={K} clients, {int(pop.counts.sum())} "
          f"samples ({time.perf_counter() - t0:.1f} s)")
    rcfg = RoundConfig(clients_per_round=M, local_steps=H, lr=LR,
                       placement="mesh", compute_dtype="float32")
    w0 = small.lenet_init(prng.PRNGKey(0), device=dev)
    n_params = sum(x.numel() for x in leaves(w0))
    print(f"LeNet {n_params} fp32 parameters; K={K} M={M} H={H} b={B} "
          f"lr={LR} eta=K/M={ETA} beta={BETA}; {ROUNDS} rounds each")

    def run(opt, n_rounds, device):
        stamps = []

        def stamp(_state):
            stamps.append(time.perf_counter())   # after the round synced
            return {}

        w_init = tree_map(lambda x: x.to(device), w0)
        tr = FederatedTrainer(
            loss_fn=small.lenet_loss, server_opt=opt, rcfg=rcfg, dataset=ds,
            sampler=UniformSampler(pop, M, seed=2), state=opt.init(w_init),
            local_batch=B, device=device)
        t_start = time.perf_counter()
        hist = tr.run(n_rounds, verbose=False, eval_fn=stamp, log_every=1)
        torch.cuda.synchronize()
        steps = [b - a for a, b in zip([t_start] + stamps[:-1], stamps)]
        return tr, hist, steps

    fm_kernel.launches = 0
    main_runs = {}
    for name, opt in (("fedavg", fedavg(eta=ETA)),
                      ("fedmom", fedmom(eta=ETA, beta=BETA,
                                        use_fused_kernel=True))):
        main_runs[name] = run(opt, ROUNDS, dev)
    main_launches = {"fedmom_update": fm_kernel.launches}
    ms_round = {}
    for name, (tr, hist, steps) in main_runs.items():
        losses = [r["loss"] for r in hist]
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{name}: non-finite loss {losses}")
        if not all(bool(torch.isfinite(x).all()) for x in leaves(tr.state.w)):
            raise AssertionError(f"{name}: non-finite parameters")
        first, last = (statistics.fmean(losses[:5]),
                       statistics.fmean(losses[-5:]))
        if not last < first:
            raise AssertionError(f"{name}: loss did not fall ({first:.4f} "
                                 f"-> {last:.4f})")
        steady = statistics.median(steps[1:]) * 1e3
        ms_round[name] = steady
        print(f"{name:7s} loss {losses[0]:.4f} -> {losses[-1]:.4f} (mean of "
              f"first 5 {first:.4f}, last 5 {last:.4f}); first round "
              f"{steps[0] * 1e3:.1f} ms, then median {steady:.2f} ms/round "
              f"(host clock, each round ends in a sync)")
    if main_launches["fedmom_update"] != ROUNDS:
        raise AssertionError(
            f"fedmom_update launched {main_launches['fedmom_update']} times "
            f"on the main path, want one per FedMom round ({ROUNDS})")
    print(f"fedmom_update launches on the main path: "
          f"{main_launches['fedmom_update']} (= {ROUNDS} FedMom rounds)")
    # the host's share of a round: sampling, keyed draws, numpy gather
    tr = main_runs["fedmom"][0]
    t0 = time.perf_counter()
    for t in range(ROUNDS):
        tr._round_inputs(t)
    print(f"host round assembly (sample + keyed draws + gather, no device "
          f"work): {(time.perf_counter() - t0) / ROUNDS * 1e3:.2f} ms/round")

    # ------------------------------------------------------------------
    phase(f"5. card against CPU: {CMP_ROUNDS} FedMom rounds")
    out = {}
    for device in ("cpu", "cuda"):
        def go():
            tr, hist, _ = run(fedmom(eta=ETA, beta=BETA,
                                     use_fused_kernel=True),
                              CMP_ROUNDS, torch.device(device))
            out[device] = (tr, [r["loss"] for r in hist])

        if device == "cpu":
            go()
            continue
        # the card's run doubles as the main path's time breakdown
        wall, busy, n_ops, top = profile_device(go)
        print(f"profiled {CMP_ROUNDS} FedMom rounds on cuda: wall "
              f"{wall * 1e3:.1f} ms, device busy {busy * 1e3:.2f} ms "
              f"({100 * busy / wall:.2f}%, idle {100 * (1 - busy / wall):.2f}"
              f"%), {n_ops / CMP_ROUNDS:.0f} device ops/round; top kernels:")
        for name, secs, count in top:
            print(f"  {secs * 1e3:8.3f} ms  {count:6d}x  {name[:100]}")
    worst = 0.0
    for a, b in zip(leaves(out["cpu"][0].state.w),
                    leaves(out["cuda"][0].state.w)):
        b = b.cpu()
        worst = max(worst, float((a - b).abs().max()))
        if not torch.allclose(a, b, atol=CMP_ATOL, rtol=CMP_RTOL):
            raise AssertionError(
                f"card and CPU params differ by {worst:.3e} "
                f"(atol {CMP_ATOL}, rtol {CMP_RTOL})")
    print(f"params agree: max abs diff {worst:.3e} (atol {CMP_ATOL}, rtol "
          f"{CMP_RTOL}); losses cpu {out['cpu'][1]} cuda {out['cuda'][1]}")

    # ------------------------------------------------------------------
    phase("6. kernels")
    ms, plain_ms, bound_ms = timing[("fedmom", n_main)]
    print(json.dumps({"card": card, "main_path_ms_per_round": ms_round}))
    line = {"kernels": [{
        "name": "fedmom_update",
        "route": "cuda",
        "source": "src/repro_torch/csrc/fedmom_update.cu",
        "replaces": "src/repro/kernels/fedmom_update/kernel.py:61",
        "launches": main_launches["fedmom_update"],
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
    }]}
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
