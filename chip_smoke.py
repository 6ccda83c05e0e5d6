#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Runs from the root of a checkout, imports nothing of JAX, and drives the
port's ported paths on the card: the per-round FedAvg / FedMom LeNet
trainer at the quickstart configuration, the same configuration on the
scanned, device and auto planes (each chunk of rounds one CUDA-graph
replay), the streaming shard-cache plane
(padded, bucketed, and bucketed through the fused ``client_step`` kernel)
at the Zipf linreg configuration of ``BENCH_6.json``
(``benchmarks/perf_compare.py`` ``_zipf_clients`` / ``bench_bucketed``,
rebuilt here) and, under dropout and straggler scenarios, at
``BENCH_7.json``'s million-client configuration, serving gemma3-1b at
full width (``serve.generate``, every
prefill attention layer through the ``flash_attention`` kernel), and
rwkv6-7b at full width: its forward loss with every layer's recurrence
through the ``rwkv6_scan`` kernel, and ``serve.generate`` over its
recurrent state caches; and recurrentgemma-9b at full width: the
``rglru_scan`` kernel's own path (its wrapper on the gates of a layer of
the model, as the reference drives it) and ``serve.generate`` over its
RG-LRU and ring caches (every LOCAL layer of prefill through
``flash_attention``).
Phases, each printed as it runs; any failure exits non-zero:

  1. card and settings: ``nvidia-smi`` name and power limit; TF32 off;
  2. build: every CUDA kernel compiled from ``src/repro_torch/csrc`` (one
     ``nvcc`` per source, all started together);
  3. ``fedmom_update`` against its plain version on the card (bit-equal):
     the flat streams at both paths' sizes and at a large ragged size, and
     the path's tree call (``ops.fused_update_tree`` / ``fused_avgm_tree``,
     one launch a table) on LeNet's tree, the streaming lanes' linreg tree,
     a mixed tree (ragged, bf16, fp16, a scalar, a zero-size leaf, offset
     views, a non-contiguous leaf) and 1,000 small ragged leaves (several
     tables), with ``fuse_tree=False`` bit-equal to it; device times (CUDA
     graphs + events) in turns at LeNet's tree: the tree call against the
     packed design (pack, one flat launch, split) and against the launch
     floor (a one-element ``add_``), FedAvgM's tree call against
     ``torch._fused_sgd_`` (the same update over the leaf lists, timed
     only, never used by the port; first held to the plain version within
     2 ulps an operation); the eager calls' times, host included; the flat
     stream at 2^26+3 elements beside its bytes bound and beside PyTorch's
     ``copy_``, ``add`` and ``addcmul`` (1, 2 and 3 reads a write; timed
     only) against theirs;
  4. ``client_step`` against its plain version on the card (atol/rtol
     1e-5) at every tier shape of the streaming lanes, with and without
     H_k masks, plus a ragged shape and a wide shape (C=512, H=4, b=16,
     D=1024; on no path, bytes-bound, the ring holding fewer steps than
     H); device times beside the bound and its share, the path's (staged)
     design timed in turns with the first design (v1) at each tier's C=8
     and at the wide shape, the staging plan's ring depth K; the launch
     floor (a graph-replayed one-element ``add_``) in turns with
     ``fedmom_update`` at the per-round path's size;
  5. per-round path: FedAvg then FedMom (fused kernel) on ``cuda``; losses
     finite and falling, kernel launches counted over exactly this phase;
  6. per-round card against CPU: the same FedMom rounds on ``cpu`` and
     ``cuda``, the card's run under the profiler;
  7. the scanned, device and auto planes: the quickstart configuration
     (FedMom through ``fedmom_update``, a keyed sampler) for 30 rounds in
     chunks of 10 on ``plan="scanned"``, ``"device"``, ``"auto"`` (must
     resolve to the device plane under the card's memory) and ``"auto"``
     at a 1-byte budget (must resolve to the scanned plane), each chunk
     one CUDA-graph replay; for each: warm ms/round beside the per-round
     plane's (a warm-up run, then a timed run synced at the end), the
     first call's s with its captures, the device-busy share and device
     ops a round of one profiled chunk, ``fedmom_update`` launches counted
     from the profiler's kernel names over a profiled 30-round run (the
     Python counter counts no replay); with
     ``torch.backends.cudnn.deterministic`` (cuDNN's default algorithms
     are not run-to-run deterministic, so even two per-round runs differ)
     losses and final parameters bit-equal to the per-round plane; one
     captured chunk replayed at two round indices bit-equal to the eager
     loop at those rounds, drawing the host replay's clients;
  8. streaming path: the padded, bucketed and hook lanes, each a warm-up
     run then a timed run with the launch counts set to 0 just before it
     and read just after; losses finite (they rise at this configuration,
     on the JAX package too), launch counts, cache
     hit rate, the padded lane's device draw against its host replay, the
     three lanes' final parameters against each other; the hook lane
     profiled over two chunks; then the same fleet on the device plane
     (its 1.09 GB corpus packed on the card, chunks as CUDA graphs):
     ms/round beside the lanes, the device-busy share and
     ``fedmom_update`` launches (profiler) of two profiled chunks, final
     parameters against the hook lane's; and ``plan="auto"`` at a budget
     of the padded lane's cache bytes, which must resolve to the
     streaming plane with the reason the reference's rule gives
     (recomputed here from the corpus), its parameters against the device
     plane's after as many rounds;
  9. streaming card against CPU: the hook lane on ``cpu`` and ``cuda``;
 10. ``flash_attention`` against its plain version on the card (fp32 atol
     2e-5, bf16 atol 2e-2, the reference's tolerances) at the serving
     paths' shapes (gemma3-1b: B=8, S=1024, 4 query heads over 1 KV head,
     d=256, bf16, window 512 and 0; recurrentgemma-9b: B=8, S=4096, 16
     query heads over 1 KV head, d=256, bf16, window 2048) and at d=64 /
     d=128 in fp32 and bf16, the bf16 cases also through the tensor-core
     design that carries P in one bf16 part; device times (CUDA graphs +
     events) at the paths' shapes of the kernel, the plain version and
     ``scaled_dot_product_attention`` with the same boolean mask (timed
     only, never used by the port) beside the bound of the (query, key)
     pairs the masks keep, the kernel's achieved TFLOP/s, its share of the
     bound, the share of its tile work the masks throw away, and the three
     bf16 designs (CUDA cores, P in bf16 hi + lo parts, P in one bf16
     part) timed in turns;
 11. serving path: reduced gemma3-1b's bf16 prefill logits through the
     kernel against ``attention_impl="xla"`` and against a planted fault
     (the first LOCAL layer's window one short), then gemma3-1b at full
     width (keyed random weights from the port's ``init``), ``generate``
     of B=8 prompts of 1024 tokens, 32 new
     tokens, greedy, bf16, ``attention_impl="pallas"``; prefill ms, decode
     ms/token, tokens/s, peak memory, kernel launches over exactly one
     ``generate`` call (26: one per layer), the device-busy share of one
     call under the profiler; logprobs finite;
 12. serving card against CPU: gemma3-1b at full width cut to one pattern
     period (6 layers), fp32, B=1, S0=256, 4 new tokens: prefill and
     decode logits within atol/rtol 1e-3, greedy tokens equal wherever the
     top-2 logit margin exceeds that tolerance;
 13. ``rwkv6_scan`` against its plain version on the card (fp32 atol 2e-3,
     bf16 atol 5e-2, rtol 1e-2, the reference's tolerances) at the
     reference's sweep shapes, at extreme decay (log w = -50 and the
     clip's floor -exp(8); atol 1e-3, in bf16 with rtol 1e-2) and at the
     loss path's shape (B=8, S=1024, 64 heads of 64), in fp32 and bf16,
     and in bf16 at the path's shape with the model's own slow decays
     (w0 at init: S sums hundreds of tokens); every bf16 case also through
     the CUDA-core design (the yardstick); device times (CUDA graphs +
     events) of the kernel and the plain version at the path's shape
     beside the bound, and the two bf16 designs (CUDA cores, tensor cores)
     timed in turns, each with its GB/s and share of the bound;
 14. RWKV6 path: rwkv6-7b at full width (keyed random weights, 32 stacked
     layers, bf16): ``loss_fn`` of B=8 x 1024 tokens with
     ``rwkv_impl="pallas"`` (32 kernel launches over exactly one call) and
     with ``"xla"``, the loss finite; ``generate`` of B=8 prompts of 1024
     tokens, 32 new, greedy (prefill ms, decode ms/token, tokens/s, peak
     memory; no kernel launch: the reference's kernel returns no state, so
     prefill and decode keep the plain recurrence); the device-busy share
     of one profiled ``loss_fn`` and one ``generate`` call;
 15. RWKV6 card against CPU: rwkv6-7b at full width cut to 2 layers, fp32,
     B=1, S=128 (4 chunks): the forward's logits through the kernel on the
     card against the plain path on the CPU, prefill + 3 decode logits on
     each, within atol/rtol 1e-3; greedy tokens equal as in phase 12;
 16. ``rglru_scan`` against its plain version on the card, bit for bit, at
     the reference's sweep, at ragged S past the kernel's 16-step tiles
     (S=100, a prime S, S=7), at a = 1 - 1e-7 over 4,096 steps and at the
     path's B and R;
 17. RG-LRU path: recurrentgemma-9b at full width (keyed random weights,
     12 stacked groups of (RGLRU, RGLRU, LOCAL) + 2 RGLRU, bf16,
     ``attention_impl="pallas"``): (b) ``ops.rglru_scan`` on the gates of
     layer 0 at B=8 x 4096 (u as the block makes it), one launch, bit-equal
     to the plain version and within atol/rtol 1e-4 of the layer's
     log-depth scan, with device times of the kernel, the plain version
     and the log-depth scan beside the bound; (a) ``generate`` of B=8
     prompts of 4096 tokens, 32 new, greedy (prefill ms, decode ms/token,
     tokens/s, peak memory; 12 ``flash_attention`` and no ``rglru_scan``
     launch over exactly one call: the reference's model runs its
     log-depth scan), the device-busy share of one profiled call;
 18. RG-LRU card against CPU: recurrentgemma-9b at full width cut to 8
     layers (2 stacked groups + the 2-layer remainder), fp32, B=1, S0=256,
     4 new tokens, weights drawn on the card and carried to the host
     through ``interop``: prefill and decode logits within atol/rtol 1e-3;
     greedy tokens equal as in phase 12;
 19. scenarios and traces (no JAX on the card; every run here under
     ``cudnn.deterministic``): (a) the quickstart configuration under
     ``UniformDropout(0.3)`` + ``LatencyStragglers(deadline_s=8)``
     (scenario seed 0) on the per-round, scanned, device and auto planes,
     each beside itself without the scenario (a warm-up run of each, then
     30-round runs timed in turns), losses, ``completed`` counts and final
     parameters bit-equal across the planes, ``fedmom_update`` 30 launches
     in 30 rounds (its counter per-round, the profiler on the graphed
     planes), and what staging the masks costs the host a round; (b)
     ``AdaptiveCohort(goal=2)`` on the scanned plane and its resume at
     round 20 from a checkpoint, bit-equal to the uninterrupted run and to
     the per-round plane; (c) the scenario recorded as a ``FleetTrace``,
     saved, loaded and replayed on the device plane, bit-equal to the
     recording run; (d) BENCH_7's configuration at full size
     (``benchmarks/fig6_robustness.py`` ``scenario_lane``: a 1,000,000-
     client ``zipf_linreg_provider`` fleet, the padded streaming lane,
     ``CacheSpec(clients=64)``, M=8, H=10, b=4, 60 rounds, FedAvg and
     FedMom at eta = K/M under dropout rates 0, 0.2, 0.4, 0.6 plus
     stragglers): ``completed_mean`` equal to the JAX package's CPU run's
     and ``final_loss`` within rtol 1e-3 of it at all 8 runs, ms/round and
     the cache's bytes; the FedMom rate-0.4 cell on the hook lane (its
     ``client_step`` launches counted) within atol/rtol 1e-4 of the padded
     lane, and 16 rounds of it on the card against the CPU (1e-4); (e)
     BENCH_9's 50,000-client fleet written as an ``npy-packed`` disk corpus
     and read through ``DiskShardProvider``: FedMom's rate-0.3 scenario
     recorded for 48 rounds, saved, loaded and replayed bit-equal to the
     synthetic run (parameter bits and losses), ``completed_mean`` equal
     to the JAX package's;
 20. one JSON line of kernels, then the result line.

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

# the streaming path: BENCH_6.json's configuration (non-smoke
# benchmarks/perf_compare.py bench_bucketed over _zipf_clients)
Z_K, Z_D, Z_NTOP = 512, 64, 8192   # clients, features, largest n_k
Z_M, Z_H, Z_B, Z_LR = 8, 4, 8, 0.05
Z_ETA, Z_BETA = 2.0, 0.9           # FedMom, through fedmom_update
Z_CR, Z_ROUNDS = 8, 100            # chunk_rounds; timed rounds per lane
Z_BYTES = Z_M * Z_CR * Z_NTOP * (Z_D * 4 + 4)   # one chunk's padded set
Z_PROFILE_CHUNKS = 2
G_CR = 10                          # chunk_rounds of the graphed planes
FM_KERNEL_NAME = "tree_update_kernel"   # fedmom_update.cu's kernel, as the
                                        # profiler names its launches
Z_CMP_ROUNDS = 16                  # streaming card-against-CPU rounds
CS_ATOL = CS_RTOL = 1e-5           # client_step kernel vs plain: gradient
                                   # sums in another order (fp32)
# client_step's wide shape, timed on no path: bytes, not latency, bound it,
# and the staged design's ring holds fewer steps than H
CS_WIDE_C, CS_WIDE_H, CS_WIDE_B = 512, 4, 16
CS_WIDE_D, CS_WIDE_S, CS_WIDE_N = 1024, 512, 256
CS_WIDE_LR = 1e-3                  # lr 0.05 on 1,024 unit-normal features
                                   # diverges (w ~100x in four steps), where
                                   # fp32 itself is off by more than CS_ATOL
LANE_ATOL = LANE_RTOL = 1e-4       # final params, lane vs lane and card vs
                                   # CPU after Z_ROUNDS / Z_CMP_ROUNDS: the
                                   # tiers sum the delta in another order,
                                   # the kernel its gradients

# the serving path: gemma3-1b at its published widths (configs/gemma3_1b.py)
G_ARCH = "gemma3-1b"
G_B, G_S0, G_NEW = 8, 1024, 32     # prompts, prompt length, new tokens
G_CMP_LAYERS, G_CMP_S0, G_CMP_NEW = 6, 256, 4   # card-vs-CPU cut
G_CMP_TOL = 1e-3                   # card vs CPU logits (fp32, TF32 off):
                                   # cuBLAS and the CPU sum 1152- and
                                   # 6912-long products in other orders
FA_ATOL = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_kernels.py:143
G_XLA_ATOL = 0.2                   # reduced gemma3-1b bf16 prefill logits,
                                   # kernel vs xla: tests/test_torch_gpu.py
                                   # XLA_BF16_ATOL
# the RWKV6 path: rwkv6-7b at its published widths (configs/rwkv6_7b.py)
R_ARCH = "rwkv6-7b"
R_B, R_S = 8, 1024                 # loss_fn batch; generate prompts
R_NEW = 32                         # generated tokens
R_CMP_LAYERS, R_CMP_S, R_CMP_NEW = 2, 128, 4   # card-vs-CPU cut
R_CMP_TOL = 1e-3                   # card vs CPU logits (fp32, TF32 off):
                                   # 4096- and 14336-long products summed
                                   # in other orders
RW_ATOL = {"float32": 2e-3, "bfloat16": 5e-2}   # tests/test_kernels.py:179
RW_RTOL = 1e-2
# the RG-LRU path: recurrentgemma-9b at its published widths
# (configs/recurrentgemma_9b.py)
RG_ARCH = "recurrentgemma-9b"
RG_B, RG_S0, RG_NEW = 8, 4096, 32  # prompts, prompt length, new tokens
RG_CMP_LAYERS, RG_CMP_S0, RG_CMP_NEW = 8, 256, 4   # card-vs-CPU cut
RG_CMP_TOL = 1e-3                  # card vs CPU logits (fp32, TF32 off):
                                   # 4096- and 12288-long products summed
                                   # in other orders
RG_LAYER_TOL = 1e-4                # kernel vs the model layer's log-depth
                                   # scan: tests/test_kernels.py:247
# the scenario path (phase 19): the quickstart configuration under
# UniformDropout + LatencyStragglers, on every graphed plane
SC_DROPOUT, SC_DEADLINE, SC_SEED = 0.3, 8.0, 0
SC_GOAL, SC_RESUME_AT = 2, 20      # adaptive cohort; resume round
# BENCH_7.json's configuration (benchmarks/fig6_robustness.py
# scenario_lane): a million-client Zipf linreg fleet on the streaming plane
B7_K, B7_DIM, B7_NMIN, B7_NMAX = 1_000_000, 16, 4, 64
B7_M, B7_H, B7_B, B7_LR = 8, 10, 4, 0.05
B7_CR, B7_ROUNDS, B7_CACHE = 8, 60, 64     # chunk_rounds, rounds, clients
B7_DATA_SEED, B7_SAMPLER_SEED, B7_SCEN_SEED = 13, 6, 17
B7_DEADLINE, B7_BETA = 11.0, 0.9
B7_RATES = (0.0, 0.2, 0.4, 0.6)
B7_HOOK_RATE = 0.4                 # the cell run on the hook lane too
B7_LOSS_RTOL = 1e-3                # final_loss against the reference's
B7_CMP_ROUNDS = 16                 # card-against-CPU rounds of that cell
# (completed_mean, final_loss) of the JAX package's scenario_lane() on the
# CPU (jax 0.9.0; BENCH_7.json was made under a 0.4.37 pin whose keyed
# draws differ), from
#   JAX_PLATFORMS=cpu PYTHONPATH=src:. python -c "from
#   benchmarks.fig6_robustness import scenario_lane; scenario_lane()"
B7_REF = {
    ("fedavg", 0.0): (8.0, 0.5213099658489228),
    ("fedavg", 0.2): (7.9, 0.5636218160390853),
    ("fedavg", 0.4): (7.716666666666667, 0.5773849308490753),
    ("fedavg", 0.6): (7.583333333333333, 0.6091857314109802),
    ("fedmom", 0.0): (8.0, 0.7914963841438294),
    ("fedmom", 0.2): (7.9, 0.8494546949863434),
    ("fedmom", 0.4): (7.716666666666667, 0.8259428262710571),
    ("fedmom", 0.6): (7.583333333333333, 0.9124979138374328),
}
# BENCH_9.json's fleet and run (benchmarks/fig6_robustness.py trace_lane)
# over a disk corpus, FedMom's rate-0.3 trace recorded, saved and replayed
B9_K, B9_ROUNDS, B9_RATE = 50_000, 48, 0.3
# completed_mean of FedMom's rate-0.3 replay in trace_lane() on the CPU
# (the same command with trace_lane; BENCH_9.json has 7.7708333)
B9_REF_COMPLETED = 7.791666666666667
BF16_FLOPS = 989e12                # H100 SXM dense bf16 tensor-core peak
FP32_FLOPS = 67e12                 # H100 SXM fp32 (CUDA cores) peak


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


def sm_clock_under(fn, seconds=1.5, iters=100):
    """Median SM clock (MHz, as ``nvidia-smi`` samples it every 100 ms)
    while CUDA-graph replays of ``iters`` calls of ``fn`` keep the card
    busy for ``seconds``; and the number of samples."""
    import torch
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(20):
                graph.replay()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        out = proc.communicate(timeout=30)[0]
    mhz = [int(v) for v in out.split() if v.strip().isdigit()]
    return (statistics.median(mhz) if mhz else float("nan")), len(mhz)


def profile_rows(fn):
    """Run ``fn`` under the profiler; returns (wall s, every device kernel
    as (name, s, count), most time first).  The window opens 0.1 s before
    ``fn`` and closes 0.1 s after its work ends: the profiler drops device
    events whose converted timestamps fall outside it, and a window that
    opens just as the first kernels run lost some of them on the card."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.1)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(0.1)
    by_name = {}
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        s, c = by_name.get(evt.name, (0.0, 0))
        by_name[evt.name] = (s + evt.time_range.elapsed_us() / 1e6, c + 1)
    return wall, sorted(((k, s, c) for k, (s, c) in by_name.items()),
                        key=lambda r: -r[1])


def profile_device(fn):
    """Run ``fn`` under the profiler; returns (wall s, device-busy s,
    device ops per call of fn, top kernels [(name, s, count)])."""
    wall, rows = profile_rows(fn)
    return wall, sum(r[1] for r in rows), sum(r[2] for r in rows), rows[:8]


def kernel_launches(rows, name):
    """Launches of the kernels whose profiler name holds ``name``: a
    CUDA-graph replay's launches are counted here, where no Python
    counter sees them."""
    return sum(c for k, _, c in rows if name in k)


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


def fedmom_tree_cases(dev, lenet):
    """Phase 3's trees, each (w, state, delta) on the card: LeNet's real
    tree (``lenet``, the per-round path's), the streaming lanes' linreg
    tree (w [64], b []), a mixed tree and 1,000 small ragged leaves."""
    import numpy as np
    import torch
    rng = np.random.default_rng(0)

    def t(shape, dtype=torch.float32, offset=0):
        n = int(np.prod(shape))
        x = torch.as_tensor(rng.normal(size=n + offset).astype(np.float32),
                            device=dev).to(dtype)
        return x[offset:].reshape(shape)

    def trio(w):
        return (w, {k: (v + 1).to(v.dtype) for k, v in w.items()},
                {k: (0.01 * v).float() for k, v in w.items()})

    return {
        "lenet": trio({k: v.clone() for k, v in lenet.items()}),
        "linreg": trio({"w": t((Z_D,)), "b": t(())}),
        "mixed": trio({
            "ragged": t((513, 9)), "bf16": t((37, 5), torch.bfloat16),
            "f16": t((11, 3), torch.float16), "scalar": t(()),
            "zero": t((0, 4)), "offset": t((1029,), offset=1),
            "bf16_offset": t((77,), torch.bfloat16, offset=1),
            "strided": t((17, 33)).T}),
        "1000 leaves": trio({f"l{i:04d}": t((int(n),)) for i, n in
                             enumerate(rng.integers(1, 200, size=1000))}),
    }


def within_ulps(got, want, scale, ulps=2):
    """|got - want| within ``ulps`` float32 ulps of ``scale`` (the largest
    magnitude among an operation's operands and result), elementwise."""
    import torch
    scale = scale.abs()
    ulp = torch.nextafter(scale, torch.full_like(scale, math.inf)) - scale
    return bool(((got - want).abs() <= ulps * ulp).all())


def fedmom_tree_phase(dev, fm_kernel, fm_ops, fm_ref, lenet):
    """Phase 3's tree half: every tree of ``fedmom_tree_cases`` through the
    path's call for both kinds, bit-equal to the plain version, one launch
    a table, ``fuse_tree=False`` bit-equal; then the timings at LeNet's
    tree.  Returns the readings."""
    import torch
    from repro_torch.tree import leaves
    cases = fedmom_tree_cases(dev, lenet)
    for name, (w, s, d) in cases.items():
        sizes = [x.numel() for x in leaves(w)]
        tables = len(fm_kernel.tree_plan(sizes, [True] * len(sizes)))
        for kind in ("fedmom", "fedavgm"):
            fn = (fm_ops.fused_update_tree if kind == "fedmom"
                  else fm_ops.fused_avgm_tree)
            plain = (fm_ref.fedmom_update if kind == "fedmom"
                     else fm_ref.fedavgm_update)
            before = fm_kernel.launches
            got = fn(w, s, d, eta=ETA, beta=BETA)
            launched = fm_kernel.launches - before
            per_leaf = fm_kernel.fused_update_tree(
                w, s, d, eta=ETA, beta=BETA, kind=kind, fuse_tree=False)
            want = plain(w, s, d, ETA, BETA)
            torch.cuda.synchronize()
            for g, p, r, like in zip(got, per_leaf, want, (w, s)):
                for k in like:
                    if (g[k].dtype != like[k].dtype
                            or g[k].shape != like[k].shape
                            or not torch.equal(g[k], r[k].to(like[k].dtype))
                            or not torch.equal(p[k], g[k])):
                        raise AssertionError(
                            f"{name} {kind}: leaf {k} differs from the "
                            f"plain version or fuse_tree=False")
            if launched != tables:
                raise AssertionError(f"{name} {kind}: {launched} launches, "
                                     f"want one a table ({tables})")
        print(f"tree {name}: {len(sizes)} leaves, {sum(sizes)} elements, "
              f"{tables} table(s): both kinds bit-equal to the plain version "
              f"on every leaf (fuse_tree=False too), {tables} launch(es) a "
              f"call")

    w, s, d = cases["lenet"]

    def tree():
        return fm_ops.fused_update_tree(w, s, d, eta=ETA, beta=BETA)

    def packed():
        return fm_kernel.fused_update_tree_design(w, s, d, eta=ETA,
                                                  beta=BETA, design="packed")

    def avgm():
        return fm_ops.fused_avgm_tree(w, s, d, eta=ETA, beta=BETA)

    one = torch.zeros(1, device=dev)
    out = {}
    out["ms"], out["packed_ms"], turns = in_turns(tree, packed)
    print(f"LeNet tree FedMom: one launch {out['ms'] * 1e3:.3f} us, packed "
          f"design {out['packed_ms'] * 1e3:.3f} us (turns tree, packed, "
          f"packed, tree: {', '.join(f'{x * 1e3:.3f}' for x in turns)} us)")
    out["launch_floor_ms"], floor_tree_ms, turns = in_turns(
        lambda: one.add_(1.0), tree)
    print(f"launch floor (one-element add_, graph-replayed) "
          f"{out['launch_floor_ms'] * 1e3:.3f} us; tree call "
          f"{floor_tree_ms * 1e3:.3f} us, "
          f"{(floor_tree_ms - out['launch_floor_ms']) * 1e3:.3f} us above "
          f"it (turns floor, tree, tree, floor: "
          f"{', '.join(f'{x * 1e3:.3f}' for x in turns)} us)")
    out["plain_ms"] = graph_ms(lambda: fm_ops.fused_update_tree(
        w, s, d, eta=ETA, beta=BETA, use_kernel=False))
    if hasattr(torch, "_fused_sgd_"):
        lw, lm, ld = ([x.clone() for x in leaves(t)] for t in (w, s, d))

        def library():
            torch._fused_sgd_(lw, ld, lm, weight_decay=0.0, momentum=BETA,
                              lr=ETA, dampening=0.0, nesterov=False,
                              maximize=False, is_first_step=False)

        library()
        torch.cuda.synchronize()
        # it may contract an operation pair into an FMA: each operation
        # (m' = beta m + d, then w' = w - eta m' on its own m') is held to
        # the plain one within 2 ulps of its largest operand or result
        for m0, d0, w0, m1, w1 in zip(leaves(s), leaves(d), leaves(w), lm,
                                      lw):
            m_plain = BETA * m0 + d0
            w_plain = w0 - ETA * m1
            if not (within_ulps(m1, m_plain, torch.maximum(
                    (BETA * m0).abs(), torch.maximum(d0.abs(),
                                                     m_plain.abs())))
                    and within_ulps(w1, w_plain, torch.maximum(
                        w0.abs(), torch.maximum((ETA * m1).abs(),
                                                w_plain.abs())))):
                raise AssertionError("torch._fused_sgd_ is not FedAvgM's "
                                     "update within 2 ulps")
        out["fedavgm_ms"], out["fedavgm_library_ms"], turns = in_turns(
            avgm, library)
        print(f"LeNet tree FedAvgM: one launch {out['fedavgm_ms'] * 1e3:.3f}"
              f" us, torch._fused_sgd_ {out['fedavgm_library_ms'] * 1e3:.3f}"
              f" us, within 2 ulps an operation (turns tree, library, "
              f"library, tree: {', '.join(f'{x * 1e3:.3f}' for x in turns)}"
              f" us)")
    else:
        out["fedavgm_ms"] = graph_ms(avgm)
        out["fedavgm_library_ms"] = (f"not available in torch "
                                     f"{torch.__version__}")
        print(f"LeNet tree FedAvgM: one launch {out['fedavgm_ms'] * 1e3:.3f}"
              f" us; torch._fused_sgd_ {out['fedavgm_library_ms']}")
    out["eager_ms"] = cuda_ms(tree, 500)
    out["packed_eager_ms"] = cuda_ms(packed, 500)
    print(f"LeNet tree FedMom eager call (host included): one launch "
          f"{out['eager_ms'] * 1e3:.2f} us, packed design "
          f"{out['packed_eager_ms'] * 1e3:.2f} us; plain version "
          f"{out['plain_ms'] * 1e3:.2f} us (device)")
    w, s, d = cases["1000 leaves"]
    out["thousand_leaves_ms"] = graph_ms(
        lambda: fm_ops.fused_update_tree(w, s, d, eta=ETA, beta=BETA),
        iters=10)
    print(f"1000-leaf tree: {out['thousand_leaves_ms'] * 1e3:.2f} us a call "
          f"(one launch a table)")
    return out


def zipf_clients():
    """``_zipf_clients`` of benchmarks/perf_compare.py at BENCH_6's sizes:
    n_k = max(2, floor(8192 / (r + 1)^1.2)), x ~ N(0, 1), y = x @ w_k."""
    import numpy as np
    rng = np.random.default_rng(0)
    clients = []
    for r in range(Z_K):
        n = max(2, int(Z_NTOP / (r + 1) ** 1.2))
        x = rng.normal(size=(n, Z_D)).astype(np.float32)
        clients.append({"x": x,
                        "y": (x @ rng.normal(size=Z_D)).astype(np.float32)})
    return clients


def linreg_loss(params, batch):
    import torch
    pred = batch["x"] @ params["w"] + params["b"]
    return torch.mean(torch.square(pred - batch["y"])), {}


def zipf_trainer(clients, device, hook):
    """BENCH_6's ``_zipf_trainer``: FedMom (eta 2, beta 0.9) through the
    fused update kernel; with ``hook`` the fused client_step hook."""
    import torch
    from repro_torch.core import (DeviceUniformSampler, RoundConfig,
                                  fedmom)
    from repro_torch.data import FederatedDataset
    from repro_torch.kernels.client_step.ops import linreg_tier_step
    from repro_torch.launch.train import FederatedTrainer
    ds = FederatedDataset([dict(c) for c in clients], seed=1)
    opt = fedmom(eta=Z_ETA, beta=Z_BETA, use_fused_kernel=True)
    w0 = {"w": torch.zeros(Z_D), "b": torch.zeros(())}
    return FederatedTrainer(
        loss_fn=linreg_loss, server_opt=opt,
        rcfg=RoundConfig(clients_per_round=Z_M, local_steps=Z_H, lr=Z_LR,
                         placement="mesh", compute_dtype="float32"),
        dataset=ds, sampler=DeviceUniformSampler(ds.population(), Z_M,
                                                 seed=2),
        state=opt.init(w0),
        client_step_fn=linreg_tier_step() if hook else None,
        local_batch=Z_B, device=device)


def tier_launches(sampler, tier_of, n_rounds, chunk_rounds):
    """client_step launches a bucketed run makes: one per occupied tier
    and round, the tiers occupied anywhere in the round's chunk."""
    total = 0
    for s in range(0, n_rounds, chunk_rounds):
        e = min(s + chunk_rounds, n_rounds)
        tiers = {int(tier_of[c]) for t in range(s, e)
                 for c in sampler.sample(t)[0]}
        total += (e - s) * len(tiers)
    return total


def client_step_bound_ms(C, H, B, D, masked):
    """Least time on the card for one client_step launch: each input byte
    read once (the H*B gathered rows of D+1 floats, their row ids, the
    slots, the start weights, the masks), each output written once, over
    the memory rate.  The flops (about 4*B*D a client and step) at the
    fp32 rate take a thousandth of that, so bytes bound it."""
    read = C * H * B * (D + 1) * 4 + C * H * B * 4 + C * 4 + (D + 1) * 4
    read += C * H * 4 if masked else 0
    write = C * (D + 2) * 4
    return (read + write) / HBM_BYTES_PER_S * 1e3


def check_client_step(cs_kernel, cs_ref, xs, ys, slots, idx, w, b, mask,
                      lr=Z_LR, H=Z_H, B=Z_B):
    """Kernel and plain version on the same card inputs: max abs error
    over the three outputs; raises past CS_ATOL / CS_RTOL."""
    import torch
    got = cs_kernel.client_step(xs, ys, slots, idx, w, b, lr, H, B,
                                step_mask=mask)
    want = cs_ref.client_step(xs, ys, slots, idx, w, b, lr, H, B,
                              step_mask=mask)
    sync(xs.device)
    err = 0.0
    for name, g, r in zip(("w", "b", "loss"), got, want):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"client_step {name}: non-finite output")
        err = max(err, float((g - r).abs().max()))
        if not torch.allclose(g, r, atol=CS_ATOL, rtol=CS_RTOL):
            raise AssertionError(
                f"client_step {name} (C={slots.shape[0]}, N={xs.shape[1]}, "
                f"D={xs.shape[2]}): kernel differs from the plain version "
                f"by {float((g - r).abs().max()):.3e} (atol {CS_ATOL}, rtol "
                f"{CS_RTOL})")
    if mask is not None:
        off = mask.sum(dim=1) == 0
        if off.any() and not (torch.equal(got[0][off],
                                          w.expand_as(got[0])[off])
                              and torch.equal(got[1][off],
                                              b.expand_as(got[1])[off])
                              and bool((got[2][off] == 0).all())):
            raise AssertionError("client_step: an all-masked client moved "
                                 "its weights or reported a loss")
    return err


def sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def in_turns(a, b, **kw):
    """graph_ms of ``a`` and ``b`` in turns a, b, b, a: both means."""
    a0, b0, b1, a1 = (graph_ms(f, **kw) for f in (a, b, b, a))
    return (a0 + a1) / 2, (b0 + b1) / 2, (a0, b0, b1, a1)


def client_step_phase(dev, z_clients, cs_kernel, cs_ref, fm_kernel, n_fm):
    """Phase 4: the kernel against its plain version at every tier shape
    of the hook lane's cache (its own tier tensors, real slots and keyed
    draws; C = 1, 2, 4, 8; with and without H_k masks, one client all
    masked), at a ragged shape and at the wide shape; device times at
    C = M per tier and at the wide shape, the staged design in turns with
    the first (v1) and, at the path's shape, with itself without helper
    warps; the launch floor beside ``fedmom_update`` at ``n_fm``.
    Returns (max abs err, {tier rows: (ms, plain ms, bound ms, v1 ms, K)},
    the largest tier's rows, {wide shape and floor readings})."""
    import numpy as np
    import torch
    from repro_torch.data.federated import minibatch_indices
    from repro_torch.data.stream import ShardCache, StreamingFederatedDataset
    sds = StreamingFederatedDataset(z_clients, seed=1)
    # the hook lane's cache: its tier tensors are the kernel's inputs
    cache = ShardCache(sds, capacity_bytes=Z_BYTES, device=dev)
    layout = cache.layout
    key = sds.base_key(dev)
    rng = np.random.default_rng(0)
    w = torch.as_tensor(rng.normal(size=Z_D).astype(np.float32), device=dev)
    bias = torch.as_tensor(np.float32(rng.normal()), device=dev)
    lr_dev = torch.tensor(Z_LR, device=dev)     # no host copy in a graph
    cs_err = 0.0
    cs_timing = {}
    print(f"{layout.n_tiers} tiers of {layout.sizes} rows, clients per tier "
          f"{layout.tier_counts}, slots {cache.tier_slots}")
    for tier, n_rows in enumerate(layout.sizes):
        members = np.flatnonzero(layout.tier_of == tier)
        cache.ensure(members[:Z_M])
        view = cache.view()
        xs, ys = view.tier_arrays[tier]["x"], view.tier_arrays[tier]["y"]
        for C in (1, 2, 4, 8):
            cids = torch.as_tensor(members[np.arange(C) % min(len(members),
                                                             Z_M)],
                                   device=dev)
            slots = view.client_slots[cids].to(torch.int32)
            idx = minibatch_indices(key, tier, cids, view.counts[cids],
                                    Z_H * Z_B)
            h_k = rng.integers(0, Z_H + 1, size=C)
            h_k[0] = 0                                # an all-masked client
            mask = torch.as_tensor(
                (np.arange(Z_H)[None] < h_k[:, None]).astype(np.float32),
                device=dev)
            for m in (None, mask):
                cs_err = max(cs_err, check_client_step(
                    cs_kernel, cs_ref, xs, ys, slots, idx, w, bias, m))
        # device time at the tier's widest launch (C = M), host taken out;
        # the path's (staged) design in turns with the first
        ms, v1_ms, turns = in_turns(
            lambda: cs_kernel.client_step(xs, ys, slots, idx, w, bias, Z_LR,
                                          Z_H, Z_B),
            lambda: cs_kernel.client_step_design(
                xs, ys, slots, idx, w, bias, Z_LR, Z_H, Z_B, design="v1"))
        plain_ms = graph_ms(lambda: cs_ref.client_step(
            xs, ys, slots, idx, w, bias, lr_dev, Z_H, Z_B))
        bound_ms = client_step_bound_ms(Z_M, Z_H, Z_B, Z_D, False)
        K = cs_kernel.plan_for(xs, Z_M, Z_H, Z_B)[0]
        cs_timing[n_rows] = (ms, plain_ms, bound_ms, v1_ms, K)
        print(f"client_step N={n_rows:>5d} S={xs.shape[0]:>3d} C=1,2,4,8 "
              f"+/- masks within atol/rtol {CS_ATOL}; C={Z_M}, K={K}: "
              f"staged {ms * 1e3:.3f} us, v1 {v1_ms * 1e3:.3f} us (turns "
              f"staged, v1, v1, staged: "
              f"{', '.join(f'{t * 1e3:.3f}' for t in turns)} us), plain "
              f"{plain_ms * 1e3:.2f} us (device), bound "
              f"{bound_ms * 1e3:.4f} us (bytes at 3.35 TB/s; staged "
              f"{bound_ms / ms:.2%} of it)")
    # a step's cost: the widest tier's launch at H = 1 against H = Z_H
    idx1 = idx[:, :Z_B].contiguous()
    h1_ms = graph_ms(lambda: cs_kernel.client_step(
        xs, ys, slots, idx1, w, bias, Z_LR, 1, Z_B))
    step_ms = (cs_timing[n_rows][0] - h1_ms) / (Z_H - 1)
    print(f"client_step C={Z_M} at H=1: {h1_ms * 1e3:.3f} us; a step costs "
          f"{step_ms * 1e3:.3f} us ((H={Z_H} - H=1) / {Z_H - 1})")
    # the helper warps: the path's launch in turns with the same kernel
    # whose one warp a client issues the burst alone
    _, solo_ms, s_turns = in_turns(
        lambda: cs_kernel.client_step(xs, ys, slots, idx, w, bias, Z_LR,
                                      Z_H, Z_B),
        lambda: cs_kernel.client_step_design(
            xs, ys, slots, idx, w, bias, Z_LR, Z_H, Z_B,
            design="staged_solo"))
    print(f"client_step C={Z_M} without helper warps {solo_ms * 1e3:.3f} us "
          f"(turns staged, solo, solo, staged: "
          f"{', '.join(f'{t * 1e3:.3f}' for t in s_turns)} us)")
    mhz, n_mhz = sm_clock_under(lambda: cs_kernel.client_step(
        xs, ys, slots, idx, w, bias, Z_LR, Z_H, Z_B))
    print(f"SM clock while client_step C={Z_M} replays: {mhz} MHz (median "
          f"of {n_mhz} nvidia-smi samples)")
    call_ms = cuda_ms(lambda: cs_kernel.client_step(
        xs, ys, slots, idx, w, bias, Z_LR, Z_H, Z_B), 200)
    plain_call_ms = cuda_ms(lambda: cs_ref.client_step(
        xs, ys, slots, idx, w, bias, Z_LR, Z_H, Z_B), 200)
    print(f"client_step eager call at N={layout.sizes[-1]}, C={Z_M}: kernel "
          f"{call_ms * 1e3:.2f} us, plain {plain_call_ms * 1e3:.2f} us")
    # the launch floor: a one-element in-place add under the same timing,
    # in turns with fedmom_update at the per-round path's size
    one = torch.zeros(1, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    fw, fs, fd = (torch.randn(n_fm, generator=gen, device=dev)
                  for _ in range(3))
    floor_ms, fm_ms, f_turns = in_turns(
        lambda: one.add_(1.0),
        lambda: fm_kernel.fused_flat(fw, fs, fd, "fedmom", ETA, BETA))
    top_ms = cs_timing[layout.sizes[-1]][0]
    print(f"launch floor (one-element add_, graph-replayed) "
          f"{floor_ms * 1e3:.3f} us; fedmom_update FedMom n={n_fm} "
          f"{fm_ms * 1e3:.3f} us ({fm_ms / floor_ms:.2f}x the floor; turns "
          f"{', '.join(f'{t * 1e3:.3f}' for t in f_turns)} us); client_step "
          f"C={Z_M} {top_ms * 1e3:.3f} us ({top_ms / floor_ms:.2f}x)")
    # a ragged shape: D past a warp multiple, N not a power of two
    for C in (1, 3):
        xs = torch.as_tensor(rng.normal(size=(3, 9, 65)).astype(np.float32),
                             device=dev)
        ys = torch.as_tensor(rng.normal(size=(3, 9)).astype(np.float32),
                             device=dev)
        slots = torch.as_tensor(rng.permutation(3)[:C].astype(np.int32),
                                device=dev)
        idx = torch.as_tensor(rng.integers(0, 9, size=(C, Z_H * Z_B))
                              .astype(np.int32), device=dev)
        w65 = torch.as_tensor(rng.normal(size=65).astype(np.float32),
                              device=dev)
        mask = torch.as_tensor([[0.0] * Z_H] + [[1.0] * Z_H] * (C - 1),
                               device=dev)
        for m in (None, mask):
            cs_err = max(cs_err, check_client_step(
                cs_kernel, cs_ref, xs, ys, slots, idx, w65, bias, m))
    print(f"client_step ragged D=65, N=9, C=1,3 +/- masks within atol/rtol "
          f"{CS_ATOL}")
    del xs, ys, fw, fs, fd
    wide = client_step_wide(dev, cs_kernel, cs_ref, gen)
    cs_err = max(cs_err, wide.pop("max_abs_err"))
    wide["launch_floor_ms"] = floor_ms
    wide["path_h1_ms"] = h1_ms
    wide["sm_clock_mhz"] = mhz
    wide["fedmom_update_ms"] = fm_ms
    print(f"client_step max abs err over every shape {cs_err:.3e}")
    return cs_err, cs_timing, layout.sizes[-1], wide


def client_step_wide(dev, cs_kernel, cs_ref, gen):
    """client_step at the wide shape (on no path): checked against the
    plain version with and without masks, timed in turns with v1 and with
    groups of 8 rows, at the ring depth of one block an SM beside the
    plan's; and groups of 32, 16 and 8 rows in turns at b = 32."""
    import torch
    C, H, B = CS_WIDE_C, CS_WIDE_H, CS_WIDE_B
    D, S, N = CS_WIDE_D, CS_WIDE_S, CS_WIDE_N
    xs = torch.randn((S, N, D), generator=gen, device=dev)
    ys = torch.randn((S, N), generator=gen, device=dev)
    slots = torch.randperm(S, generator=gen, device=dev)[:C].to(torch.int32)
    idx = torch.randint(0, N, (C, H * B), generator=gen, device=dev,
                        dtype=torch.int32)
    w = torch.randn(D, generator=gen, device=dev)
    bias = torch.randn((), generator=gen, device=dev)
    h_k = torch.randint(0, H + 1, (C,), generator=gen, device=dev)
    h_k[0] = 0
    mask = (torch.arange(H, device=dev)[None] < h_k[:, None]).float()
    err = 0.0
    for m in (None, mask):
        err = max(err, check_client_step(cs_kernel, cs_ref, xs, ys, slots,
                                         idx, w, bias, m, lr=CS_WIDE_LR,
                                         H=H, B=B))
    K = cs_kernel.plan_for(xs, C, H, B)[0]
    K1 = cs_kernel.plan_for(xs, C, H, B, blocks_per_sm=1)[0]
    args = (xs, ys, slots, idx, w, bias, CS_WIDE_LR, H, B)
    ms, v1_ms, turns = in_turns(
        lambda: cs_kernel.client_step(*args),
        lambda: cs_kernel.client_step_design(*args, design="v1"),
        iters=20, replays=10)
    G = cs_kernel.plan_for(xs, C, H, B)[1]
    _, g8_ms, g_turns = in_turns(
        lambda: cs_kernel.client_step(*args),
        lambda: cs_kernel.client_step_design(*args, design="staged",
                                             group=8),
        iters=20, replays=10)
    print(f"client_step wide, groups of {G} rows (the plan's) against 8: "
          f"{g8_ms * 1e3:.3f} us at 8 (turns {G}, 8, 8, {G}: "
          f"{', '.join(f'{t * 1e3:.3f}' for t in g_turns)} us)")
    # groups of 32, 16 and 8 rows at b = 32, in turns 32, 16, 8, 8, 16, 32
    idx32 = torch.randint(0, N, (C, H * 32), generator=gen, device=dev,
                          dtype=torch.int32)
    a32 = (xs, ys, slots, idx32, w, bias, CS_WIDE_LR, H, 32)
    order = (32, 16, 8, 8, 16, 32)
    t32 = [graph_ms(lambda g=g: cs_kernel.client_step_design(
        *a32, design="staged", group=g), iters=20, replays=10)
        for g in order]
    g32 = {g: sum(t for o, t in zip(order, t32) if o == g) / 2
           for g in (32, 16, 8)}
    print(f"client_step C={C}, H={H}, b=32, D={D}, K="
          f"{cs_kernel.plan_for(xs, C, H, 32)[0]}: groups of 32, 16, 8 rows "
          f"{g32[32] * 1e3:.3f}, {g32[16] * 1e3:.3f}, {g32[8] * 1e3:.3f} us "
          f"(turns {', '.join(f'{t * 1e3:.3f}' for t in t32)} us)")
    k1_ms = graph_ms(lambda: cs_kernel.client_step_design(
        *args, design="staged", ring=K1), iters=20, replays=10)
    bound_ms = client_step_bound_ms(C, H, B, D, False)
    print(f"client_step wide C={C}, H={H}, b={B}, D={D}, S={S}, N={N} "
          f"(tier tensors {(xs.numel() + ys.numel()) * 4 / 1e6:.1f} MB) "
          f"+/- masks within atol/rtol {CS_ATOL} at lr {CS_WIDE_LR}; staged "
          f"K={K} (two blocks an SM) {ms * 1e3:.3f} us, "
          f"{bound_ms / ms:.2%} of the bound; v1 {v1_ms * 1e3:.3f} us "
          f"({bound_ms / v1_ms:.2%}); turns "
          f"{', '.join(f'{t * 1e3:.3f}' for t in turns)} us; staged K={K1} "
          f"(one block an SM) {k1_ms * 1e3:.3f} us; bound "
          f"{bound_ms * 1e3:.3f} us (bytes at 3.35 TB/s)")
    return {"ms": ms, "v1_ms": v1_ms, "bound_ms": bound_ms, "ring": K,
            "one_block_ring": K1, "one_block_ms": k1_ms,
            "max_abs_err": err}


def streaming_lanes(dev, z_clients, fm_kernel, cs_kernel):
    """Phase 7: the padded, bucketed and hook lanes on ``dev``, each a
    warm-up run and then a timed run with the launch counts set to 0 just
    before it and read just after; returns {lane: measurements}."""
    import numpy as np
    import torch
    from repro_torch.launch.plan import CacheSpec, ExecutionPlan
    from repro_torch.tree import leaves
    counts = [len(c["y"]) for c in z_clients]
    print(f"Zipf linreg corpus: K={Z_K} clients, {sum(counts)} rows of D="
          f"{Z_D}, n_k {min(counts)}..{max(counts)}, "
          f"{sum(counts) * (Z_D + 1) * 4 / 1e6:.1f} MB; M={Z_M} H={Z_H} "
          f"b={Z_B} lr={Z_LR} FedMom eta={Z_ETA} beta={Z_BETA}; chunk_rounds="
          f"{Z_CR}, cache {Z_BYTES} B; {Z_ROUNDS} rounds timed after a "
          f"warm-up run of as many")

    def fresh(tr):
        return tr.server_opt.init({"w": torch.zeros(Z_D, device=tr.device),
                                   "b": torch.zeros((), device=tr.device)})

    lanes = {}
    for name, spec, hook in (
            ("padded", CacheSpec(bytes=Z_BYTES, tiers=1), False),
            ("bucketed", CacheSpec(bytes=Z_BYTES, bucketed=True), False),
            ("hook", CacheSpec(bytes=Z_BYTES, bucketed=True), True)):
        plan = ExecutionPlan(plane="streaming", chunk_rounds=Z_CR, cache=spec)
        tr = zipf_trainer(z_clients, dev, hook)
        tr.run(Z_ROUNDS, plan=plan, verbose=False)          # warm-up
        sync(dev)
        tr.state, tr.history = fresh(tr), []
        cache = tr.stream_cache
        hits0, misses0 = cache.hits, cache.misses
        fm_kernel.launches = cs_kernel.launches = 0
        t0 = time.perf_counter()
        hist = tr.run(Z_ROUNDS, plan=plan, verbose=False)
        sync(dev)
        secs = time.perf_counter() - t0
        launched = {"fedmom_update": fm_kernel.launches,
                    "client_step": cs_kernel.launches}
        losses = [r["loss"] for r in hist]
        if len(losses) != Z_ROUNDS or not all(math.isfinite(x)
                                              for x in losses):
            raise AssertionError(f"{name}: losses {losses}")
        if not all(bool(torch.isfinite(x).all()) for x in leaves(tr.state.w)):
            raise AssertionError(f"{name}: non-finite parameters")
        # no falling-loss check here: at this configuration every client's
        # labels come from its own random linear map and FedMom at eta=2,
        # beta=0.9 drifts, so the loss rises on the JAX package as well;
        # the lanes are held to each other and to the CPU instead
        first, last = (statistics.fmean(losses[:5]),
                       statistics.fmean(losses[-5:]))
        want_cs = (tier_launches(tr.sampler, cache.layout.tier_of, Z_ROUNDS,
                                 Z_CR) if hook else 0)
        if launched != {"fedmom_update": Z_ROUNDS, "client_step": want_cs}:
            raise AssertionError(
                f"{name}: launches {launched}, want fedmom_update {Z_ROUNDS} "
                f"(one per round) and client_step {want_cs} (one per "
                f"occupied tier and round)")
        hits, misses = cache.hits - hits0, cache.misses - misses0
        hit_rate = hits / max(hits + misses, 1)
        ms = secs / Z_ROUNDS * 1e3
        lanes[name] = {"trainer": tr, "plan": plan, "ms_per_round": ms,
                       "final_w": [x.clone() for x in leaves(tr.state.w)],
                       "hit_rate": hit_rate,
                       "misses_per_round": misses / Z_ROUNDS,
                       "launches": launched}
        print(f"{name:8s} loss {losses[0]:.4f} -> {losses[-1]:.4f} (mean of "
              f"first 5 {first:.4f}, last 5 {last:.4f}); {ms:.3f} ms/round "
              f"(host clock, synced at the end); cache {cache.nbytes} B, "
              f"{cache.layout.n_tiers} tier(s), capacity {cache.capacity}, "
              f"hit rate {hit_rate:.4f}, misses {misses / Z_ROUNDS:.2f}/round;"
              f" launches {launched}")
        if name == "padded":
            # the shards uploaded were the ones the host replay named: the
            # device draw must pick the same clients in every round
            key = tr.sampler.base_key().to(dev)
            for t in range(Z_ROUNDS):
                on_card = tr.sampler.sample_device(key, t)[0].cpu().numpy()
                if not np.array_equal(on_card, tr.sampler.sample(t)[0]):
                    raise AssertionError(
                        f"round {t}: the device draw {on_card} differs from "
                        f"the host replay {tr.sampler.sample(t)[0]}")
            print(f"padded   device draw equals the host replay in all "
                  f"{Z_ROUNDS} rounds")
    ref = lanes["padded"]["trainer"].state.w
    for name in ("bucketed", "hook"):
        worst = 0.0
        for a, b in zip(leaves(ref), leaves(lanes[name]["trainer"].state.w)):
            worst = max(worst, float((a - b).abs().max()))
            if not torch.allclose(a, b, atol=LANE_ATOL, rtol=LANE_RTOL):
                raise AssertionError(
                    f"{name} and padded final params differ by {worst:.3e} "
                    f"(atol {LANE_ATOL}, rtol {LANE_RTOL})")
        print(f"{name:8s} final params agree with padded: max abs diff "
              f"{worst:.3e} (atol {LANE_ATOL}, rtol {LANE_RTOL})")
    n_prof = Z_PROFILE_CHUNKS * Z_CR
    for name, lane in lanes.items():
        tr = lane["trainer"]
        tr.state, tr.history = fresh(tr), []
        wall, busy, n_ops, top = profile_device(
            lambda: tr.run(n_prof, plan=lane["plan"], verbose=False))
        lane["busy_share"] = busy / wall
        print(f"profiled {n_prof} rounds ({Z_PROFILE_CHUNKS} chunks) of "
              f"{name}: wall {wall * 1e3:.1f} ms, device busy "
              f"{busy * 1e3:.2f} ms ({100 * busy / wall:.2f}%, idle "
              f"{100 * (1 - busy / wall):.2f}%), {n_ops / n_prof:.0f} device "
              f"ops/round; top kernels:")
        for kname, secs, count in top:
            print(f"  {secs * 1e3:8.3f} ms  {count:6d}x  {kname[:100]}")
    return lanes


def streaming_card_vs_cpu(z_clients, cs_kernel, plan, devices):
    """Phase 8: the hook lane on ``devices`` = (the CPU, the card): the
    plain version there, the kernel here; final parameters held to
    LANE_ATOL / LANE_RTOL."""
    import torch
    from repro_torch.tree import leaves
    runs = []
    for device in devices:
        tr = zipf_trainer(z_clients, device, True)
        cs_kernel.launches = 0
        hist = tr.run(Z_CMP_ROUNDS, plan=plan, verbose=False)
        runs.append((tr, [r["loss"] for r in hist], cs_kernel.launches))
    (cpu, cpu_losses, cpu_launches), (card, card_losses, card_launches) = runs
    if cpu_launches != 0 or card_launches == 0:
        raise AssertionError(
            f"client_step launches cpu {cpu_launches}, card {card_launches}: "
            f"want none on the CPU (plain version) and some on the card")
    worst = 0.0
    for a, b in zip(leaves(cpu.state.w), leaves(card.state.w)):
        b = b.cpu()
        worst = max(worst, float((a - b).abs().max()))
        if not torch.allclose(a, b, atol=LANE_ATOL, rtol=LANE_RTOL):
            raise AssertionError(
                f"card and CPU params differ by {worst:.3e} "
                f"(atol {LANE_ATOL}, rtol {LANE_RTOL})")
    loss_diff = max(abs(a - b) for a, b in zip(cpu_losses, card_losses))
    print(f"params agree: max abs diff {worst:.3e} (atol {LANE_ATOL}, rtol "
          f"{LANE_RTOL}); losses differ by at most {loss_diff:.3e}; "
          f"client_step launches on the card {card_launches}")


def graph_planes_phase(dev, clients, w0):
    """Phase 7: the quickstart configuration on the per-round, scanned,
    device and auto planes; returns {run: measurements}."""
    import torch
    from repro_torch.core import DeviceUniformSampler, RoundConfig, fedmom
    from repro_torch.core.multiround import scan_rounds_ondevice
    from repro_torch.data import FederatedDataset
    from repro_torch.launch.plan import ExecutionPlan
    from repro_torch.launch.train import FederatedTrainer
    from repro_torch.models import small
    from repro_torch.tree import leaves, tree_map
    ds = FederatedDataset(clients, seed=1)
    pop = ds.population()
    rcfg = RoundConfig(clients_per_round=M, local_steps=H, lr=LR,
                       placement="mesh", compute_dtype="float32")
    opt = fedmom(eta=ETA, beta=BETA, use_fused_kernel=True)

    def trainer():
        return FederatedTrainer(
            loss_fn=small.lenet_loss, server_opt=opt, rcfg=rcfg, dataset=ds,
            sampler=DeviceUniformSampler(pop, M, seed=2),
            state=opt.init(w0), local_batch=B, device=dev)

    plans = {
        "per_round": "per_round",
        "scanned": ExecutionPlan(plane="scanned", chunk_rounds=G_CR),
        "device": ExecutionPlan(plane="device", chunk_rounds=G_CR),
        "auto": ExecutionPlan(plane="auto", chunk_rounds=G_CR),
        "auto_1B": ExecutionPlan(plane="auto", chunk_rounds=G_CR,
                                 memory_budget_bytes=1)}
    resolves_to = {"per_round": "per_round", "scanned": "scanned",
                   "device": "device", "auto": "device",
                   "auto_1B": "scanned"}
    print(f"LeNet, K={K} M={M} H={H} b={B} FedMom eta={ETA} beta={BETA} "
          f"through fedmom_update, DeviceUniformSampler; {ROUNDS} rounds in "
          f"chunks of {G_CR}; warm-up run, then a timed run")
    out = {}
    for name, plan in plans.items():
        tr = trainer()
        t0 = time.perf_counter()
        tr.run(ROUNDS, plan=plan, verbose=False)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        capture_s = sum(g.capture_s for g in tr.session.graphs.values())
        rec = tr.session.plan_log[-1]
        if rec["plane"] != resolves_to[name]:
            raise AssertionError(f"{name}: resolved to {rec['plane']}, want "
                                 f"{resolves_to[name]} ({rec['reason']})")
        if name == "auto_1B" and not rec["reason"].startswith(
                "host prefetch-queue fallback: even one chunk's participant "
                "working set ("):
            raise AssertionError(f"auto_1B: reason {rec['reason']!r}")
        tr.state, tr.history = opt.init(w0), []
        t0 = time.perf_counter()
        hist = [r for r in tr.run(ROUNDS, plan=plan, verbose=False)
                if "event" not in r]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / ROUNDS * 1e3
        losses = [r["loss"] for r in hist]
        if len(losses) != ROUNDS or not all(math.isfinite(x)
                                            for x in losses):
            raise AssertionError(f"{name}: losses {losses}")
        tr.state, tr.history = opt.init(w0), []
        wall, rows = profile_rows(
            lambda: tr.run(G_CR, plan=plan, verbose=False))
        busy = sum(r[1] for r in rows)
        n_ops = sum(r[2] for r in rows)
        # the profiler slows the host; the device's share of an unprofiled
        # round is its device time a round over the timed ms/round
        busy_ms = busy / G_CR * 1e3
        tr.state, tr.history = opt.init(w0), []
        _, rows30 = profile_rows(
            lambda: tr.run(ROUNDS, plan=plan, verbose=False))
        fm = kernel_launches(rows30, FM_KERNEL_NAME)
        if fm != ROUNDS:
            raise AssertionError(
                f"{name}: the profiler counts {fm} fedmom_update launches "
                f"in {ROUNDS} rounds, want one a round")
        out[name] = {"plane": rec["plane"], "ms_per_round": ms,
                     "first_call_s": first_s, "capture_s": capture_s,
                     "busy_share": busy / wall,
                     "device_ms_per_round": busy_ms,
                     "ops_per_round": n_ops / G_CR,
                     "fedmom_update_launches": fm,
                     "reason": rec["reason"]}
        print(f"{name:9s} -> {rec['plane']:9s} {ms:8.3f} ms/round (host "
              f"clock, synced at the end); first call {first_s:.3f} s, "
              f"captures {capture_s:.3f} s; one profiled chunk: wall "
              f"{wall * 1e3:.2f} ms, device busy {busy * 1e3:.2f} ms "
              f"({100 * busy / wall:.2f}%), {n_ops / G_CR:.0f} device "
              f"ops/round, {busy_ms:.3f} ms of device time a round "
              f"({100 * busy_ms / ms:.1f}% of the unprofiled ms/round); "
              f"fedmom_update launches (profiler) {fm} in {ROUNDS} rounds")
        print(f"          reason: {rec['reason']}")
        del tr
    for name in ("scanned", "device", "auto"):
        print(f"{name:9s} {out['per_round']['ms_per_round'] / out[name]['ms_per_round']:.2f}x "
              f"the per-round plane's ms/round")

    # the trajectory, with cuDNN's deterministic algorithms: by default
    # cuDNN's convolutions are not run-to-run deterministic on the card, so
    # even two per-round runs differ in the last bits (within CMP_ATOL)
    torch.backends.cudnn.deterministic = True
    try:
        runs = {}
        for name in ("per_round", "per_round_again", "scanned", "device",
                     "auto", "auto_1B"):
            tr = trainer()
            hist = tr.run(ROUNDS, plan=plans.get(name, "per_round"),
                          verbose=False)
            runs[name] = ([r["loss"] for r in hist if "event" not in r],
                          tr.state)
        ref_losses, ref_state = runs["per_round"]
        for name, (losses, state) in runs.items():
            same = losses == ref_losses and all(
                torch.equal(a, b) for a, b in zip(leaves(state.w),
                                                  leaves(ref_state.w)))
            if not same:
                worst = max(float((a - b).abs().max()) for a, b in zip(
                    leaves(state.w), leaves(ref_state.w)))
                raise AssertionError(
                    f"{name}: not bit-equal to the per-round plane (max "
                    f"param diff {worst:.3e})")
        print(f"with cudnn.deterministic: scanned, device, auto and auto_1B "
              f"losses and final parameters bit-equal to the per-round "
              f"plane over {ROUNDS} rounds")

        # one captured chunk replayed at two round indices against the
        # eager loop at those rounds (a round index baked in at capture
        # would replay round t0's draws)
        tr = trainer()
        dds = tr.device_dataset()
        graph = tr._device_chunk_graph(G_CR, False, dds)
        skey, dkey = tr.sampler.base_key().to(dev), dds.base_key()
        lrs = torch.full((G_CR,), LR, dtype=torch.float32, device=dev)
        state = tr.state
        for t0 in (0, 2 * G_CR):
            start = tree_map(lambda x: x.clone()
                             if isinstance(x, torch.Tensor) else x,
                             state._replace(t=t0))
            state, got = graph.run(state, t0, {"lrs": lrs.cpu().numpy()})
            want_state, want = scan_rounds_ondevice(
                small.lenet_loss, opt, start, dds, tr.sampler, dkey, skey,
                t0, G_CR, rcfg, B, lrs=lrs, device=dev)
            drawn = got["clients"].cpu().numpy().tolist()
            replay = [tr.sampler.sample(t)[0].tolist()
                      for t in range(t0, t0 + G_CR)]
            if drawn != replay or not torch.equal(got["clients"],
                                                  want["clients"]):
                raise AssertionError(
                    f"t0={t0}: the replay drew {drawn}, the host replay "
                    f"names {replay}")
            if not (torch.equal(got["loss"], want["loss"]) and all(
                    torch.equal(a, b) for a, b in zip(
                        leaves(state.w), leaves(want_state.w)))):
                raise AssertionError(
                    f"t0={t0}: the replayed chunk differs from the eager "
                    f"loop at the same rounds")
        print(f"one captured chunk replayed at t0 = 0 and {2 * G_CR}: "
              f"clients, losses and parameters bit-equal to the eager loop "
              f"at those rounds")
    finally:
        torch.backends.cudnn.deterministic = False
    return out


def zipf_device_plane(dev, z_clients, lanes):
    """Phase 8's device plane and auto plan on BENCH_6's fleet."""
    import torch
    from repro_torch.launch.plan import ExecutionPlan
    from repro_torch.tree import leaves
    tr = zipf_trainer(z_clients, dev, False)
    t0 = time.perf_counter()
    dds = tr.device_dataset()
    sync(dev)
    pack_s = time.perf_counter() - t0
    plan = ExecutionPlan(plane="device", chunk_rounds=Z_CR)

    def fresh():
        return tr.server_opt.init({"w": torch.zeros(Z_D, device=dev),
                                   "b": torch.zeros((), device=dev)})

    tr.run(Z_ROUNDS, plan=plan, verbose=False)               # warm-up
    sync(dev)
    tr.state, tr.history = fresh(), []
    t0 = time.perf_counter()
    hist = tr.run(Z_ROUNDS, plan=plan, verbose=False)
    sync(dev)
    ms = (time.perf_counter() - t0) / Z_ROUNDS * 1e3
    losses = [r["loss"] for r in hist]
    if len(losses) != Z_ROUNDS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"device plane: losses {losses}")
    worst = 0.0
    for a, b in zip(lanes["hook"]["final_w"], leaves(tr.state.w)):
        worst = max(worst, float((a - b).abs().max()))
        if not torch.allclose(a, b, atol=LANE_ATOL, rtol=LANE_RTOL):
            raise AssertionError(
                f"device plane and hook lane final params differ by "
                f"{worst:.3e} (atol {LANE_ATOL}, rtol {LANE_RTOL})")
    n_prof = Z_PROFILE_CHUNKS * Z_CR
    tr.state, tr.history = fresh(), []
    wall, rows = profile_rows(
        lambda: tr.run(n_prof, plan=plan, verbose=False))
    busy = sum(r[1] for r in rows)
    fm = kernel_launches(rows, FM_KERNEL_NAME)
    if fm != n_prof:
        raise AssertionError(f"device plane: {fm} fedmom_update launches "
                             f"in {n_prof} rounds (profiler), want {n_prof}")
    print(f"device   packed corpus {dds.nbytes} B in {pack_s:.2f} s; "
          f"{ms:.3f} ms/round (host clock, synced at the end; padded "
          f"{lanes['padded']['ms_per_round']:.3f}, bucketed "
          f"{lanes['bucketed']['ms_per_round']:.3f}, hook "
          f"{lanes['hook']['ms_per_round']:.3f}); {n_prof} profiled rounds: "
          f"device busy {100 * busy / wall:.2f}%, "
          f"{sum(r[2] for r in rows) / n_prof:.0f} device ops/round, "
          f"fedmom_update launches (profiler) {fm}; final params agree "
          f"with the hook lane: max abs diff {worst:.3e}")
    device = {"ms_per_round": ms, "pack_s": pack_s, "nbytes": dds.nbytes,
              "busy_share": busy / wall, "fedmom_update_launches": fm}

    # the auto rule at the padded lane's cache bytes, recomputed here:
    # one chunk's working set of Z_M * Z_CR clients in power-of-two tiers
    counts = [len(c["y"]) for c in z_clients]
    n_max, row = max(counts), (Z_D + 1) * 4
    packed = len(counts) * n_max * row
    tier_counts = {}
    for n in counts:
        size = min(1 << (n - 1).bit_length(), n_max)
        tier_counts[size] = tier_counts.get(size, 0) + 1
    cap = min(Z_M * Z_CR, len(counts))
    ws = sum(min(k, cap) * size * row for size, k in tier_counts.items())
    want = (f"packed corpus ({packed} B) exceeds the budget ({Z_BYTES} B) "
            f"but one chunk's participant working set ({cap} clients over "
            f"{len(tier_counts)} size tier(s), {ws} B tiered) fits the "
            f"budget ({Z_BYTES} B)")
    if not ws <= Z_BYTES < packed:
        raise AssertionError(f"working set {ws}, budget {Z_BYTES}, packed "
                             f"{packed}: the case does not test the rule")
    auto = zipf_trainer(z_clients, dev, False)
    auto_plan = ExecutionPlan(plane="auto", chunk_rounds=Z_CR,
                              memory_budget_bytes=Z_BYTES)
    t0 = time.perf_counter()
    auto.run(Z_CMP_ROUNDS, plan=auto_plan, verbose=False)
    sync(dev)
    auto_ms = (time.perf_counter() - t0) / Z_CMP_ROUNDS * 1e3
    rec = auto.session.plan_log[-1]
    if rec["plane"] != "streaming" or rec["reason"] != want:
        raise AssertionError(f"auto at {Z_BYTES} B: {rec}, want the "
                             f"streaming plane because {want!r}")
    tr.state, tr.history = fresh(), []
    tr.run(Z_CMP_ROUNDS, plan=plan, verbose=False)
    worst = 0.0
    for a, b in zip(leaves(tr.state.w), leaves(auto.state.w)):
        worst = max(worst, float((a - b).abs().max()))
        if not torch.allclose(a, b, atol=LANE_ATOL, rtol=LANE_RTOL):
            raise AssertionError(
                f"auto (streaming) and device final params differ by "
                f"{worst:.3e} after {Z_CMP_ROUNDS} rounds")
    print(f"auto     at {Z_BYTES} B -> {rec['plane']} ({rec['reason']}); "
          f"{auto_ms:.3f} ms/round over {Z_CMP_ROUNDS} rounds (first run); "
          f"final params within {worst:.3e} of the device plane's")
    device["auto_plane"] = rec["plane"]
    device["auto_ms_per_round"] = auto_ms
    del tr, auto, dds
    torch.cuda.empty_cache()
    return device


def flash_kept_pairs(S, window, causal):
    """(query, key) pairs that the masks keep for one (batch, head), summed
    per row in closed form: query i keeps keys max(0, i - window + 1)
    through i when causal (S - 1 when not); the kernel's tiles play no
    part."""
    pairs = 0
    for i in range(S):
        hi = i if causal else S - 1
        lo = max(0, i - window + 1) if window > 0 else 0
        pairs += max(0, hi - lo + 1)
    return pairs


def flash_tile_pairs(S, Hq, Hkv, window, causal, rows=128, keys=64):
    """(query, key) pairs per query head that the bf16 kernel computes: its
    128-row tiles pack 128/Gp positions x Gp heads (Gp = gcd(Hq/Hkv, 64)),
    and each runs the 64-key tiles between the window's first key and the
    diagonal of its positions (``csrc/flash_attention.cu``), every row of
    the tile, past S too."""
    P = rows // math.gcd(Hq // Hkv, 64)
    pairs = 0
    for p0 in range(0, S, P):
        p_last = min(p0 + P, S) - 1
        hi = min(S // keys, p_last // keys + 1) if causal else S // keys
        lo = (p0 - window + 1) // keys if window > 0 and p0 - window + 1 > 0 \
            else 0
        pairs += max(0, hi - lo) * keys * P
    return pairs


def flash_bound_ms(B, S, Hq, Hkv, d, window, causal, itemsize):
    """Least time on the card for one flash_attention call: the larger of
    its bytes (q, k, v read once -- K/V at their Hkv heads -- and out
    written once) over the memory rate, and its flops (4 d per kept
    (query, key) pair: QK^T and PV) over the peak rate of the input type.
    Returns (ms of the bytes, ms of the operations)."""
    nbytes = (2 * B * S * Hq * d + 2 * B * S * Hkv * d) * itemsize
    flops = 4 * d * B * Hq * flash_kept_pairs(S, window, causal)
    rate = BF16_FLOPS if itemsize == 2 else FP32_FLOPS
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / rate * 1e3


def sdpa_call(q, k, v, causal, window):
    """``scaled_dot_product_attention`` over the same boolean mask (the
    library yardstick; the port never calls it)."""
    import torch
    import torch.nn.functional as F
    S = q.shape[1]
    i = torch.arange(S, device=q.device)
    keep = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        keep &= i[None, :] <= i[:, None]
    if window > 0:
        keep &= i[None, :] > i[:, None] - window
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def call():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep,
                                              enable_gqa=True)
    return call


def flash_phase(fa_ops, fa_kernel, card):
    """Phase 9: the kernel against its plain version at the serving paths'
    shapes and the reference's d=64 / d=128 sweep; device times at the
    paths' shapes.  The plain version runs on slices of the batch so that
    its fp32 score matrix stays under 4 GiB (two slices of 4 rows at
    recurrentgemma-9b's shape).  At every bf16 case the other tensor-core
    design (P in one bf16 part) is checked too, and at the bf16 path shapes
    the three designs are timed in turns (CUDA cores, P hi + lo, P bf16,
    P bf16, P hi + lo, CUDA cores), with the kernel's achieved TFLOP/s (4 d
    per kept pair), its share of the bound and the share of its tile work
    that the masks throw away.  Returns (max abs err, {window: timings}):
    the path's kernel at gemma3-1b's windows, and at recurrentgemma-9b's
    shape under "long"."""
    import numpy as np
    import torch
    dev = torch.device("cuda")
    path_cases = [(G_B, G_S0, 4, 1, 256, "bfloat16", True, 512),
                  (G_B, G_S0, 4, 1, 256, "bfloat16", True, 0),
                  (RG_B, RG_S0, 16, 1, 256, "bfloat16", True, 2048)]
    cases = list(path_cases)
    for d, S, Hq, Hkv in ((64, 512, 4, 2), (128, 256, 2, 1)):
        for dtype in ("float32", "bfloat16"):
            for causal, window in ((True, 0), (True, 64), (False, 0)):
                cases.append((2, S, Hq, Hkv, d, dtype, causal, window))
    rng = np.random.default_rng(0)
    max_err = 0.0
    timing = {}
    for B, S, Hq, Hkv, d, dtype, causal, window in cases:
        dt = getattr(torch, dtype)
        q, k, v = (torch.as_tensor(rng.normal(size=(B, S, h, d)).astype(
            np.float32), device=dev).to(dt) for h in (Hq, Hkv, Hkv))
        rows = max(1, 2 ** 32 // (Hq * S * S * 4))

        def call_p():
            parts = [fa_ops.flash_attention(
                q[i:i + rows], k[i:i + rows], v[i:i + rows], causal=causal,
                window=window, use_kernel=False) for i in range(0, B, rows)]
            return parts[0] if len(parts) == 1 else torch.cat(parts)
        out = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
        ref = call_p()
        sync(dev)
        err = float((out.float() - ref.float()).abs().max())
        tag = (f"B={B} S={S} Hq={Hq} Hkv={Hkv} d={d} {dtype} causal="
               f"{causal} window={window}")
        if not (err <= FA_ATOL[dtype] and bool(torch.isfinite(out).all())):
            raise AssertionError(f"flash_attention {tag}: kernel differs "
                                 f"from the plain version by {err:.3e} "
                                 f"(atol {FA_ATOL[dtype]})")
        max_err = max(max_err, err)
        line = f"flash_attention {tag}: max abs err {err:.3e}"
        if dtype == "bfloat16":
            one = fa_kernel.flash_attention_design(
                q, k, v, causal=causal, window=window, design="p_bf16")
            line += (f" (P in one bf16 part: "
                     f"{float((one.float() - ref.float()).abs().max()):.3e})")
            del one
        if (B, S, Hq, Hkv, d, dtype, causal, window) in path_cases:
            def design(name):
                return lambda: fa_kernel.flash_attention_design(
                    q, k, v, causal=causal, window=window, design=name)
            call_k = lambda: fa_ops.flash_attention(  # noqa: E731
                q, k, v, causal=causal, window=window)
            call_l = sdpa_call(q, k, v, causal, window)
            lib_err = float((call_l().transpose(1, 2).float()
                             - ref.float()).abs().max())
            n = 10 if S == G_S0 else 3        # 2-30 ms a call at S=4096
            turns = {"cuda_cores": [], "p_hi_lo": [], "p_bf16": []}
            for name in ("cuda_cores", "p_hi_lo", "p_bf16", "p_bf16",
                         "p_hi_lo", "cuda_cores"):
                turns[name].append(graph_ms(design(name), iters=n,
                                            replays=n))
            n_k = 30 if S == G_S0 else 10
            ms = graph_ms(call_k, iters=n_k, replays=n_k)
            plain_ms = graph_ms(call_p, iters=n, replays=n)
            lib_ms = graph_ms(call_l, iters=n, replays=n)
            bytes_ms, ops_ms = flash_bound_ms(B, S, Hq, Hkv, d, window,
                                              causal, 2)
            bound_ms = max(bytes_ms, ops_ms)
            bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
            kept = flash_kept_pairs(S, window, causal)
            tflops = 4 * d * B * Hq * kept / (ms * 1e-3) / 1e12
            waste = 1 - kept / flash_tile_pairs(S, Hq, Hkv, window, causal)
            timing[window if S == G_S0 else "long"] = (
                ms, plain_ms, bound_ms, bound_by, lib_ms, bytes_ms, ops_ms)
            line += (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                     f"sdpa {lib_ms:.4f} ms (device; sdpa vs plain "
                     f"{lib_err:.2e}), bound {bound_ms:.4f} ms ({bound_by}: "
                     f"{kept} kept pairs per head); {tflops:.1f} TFLOP/s "
                     f"achieved, {100 * bound_ms / ms:.1f}% of the bound, "
                     f"{100 * waste:.2f}% of the tile work masked away; "
                     f"in turns: " + ", ".join(
                         f"{name} " + " / ".join(f"{t:.4f}" for t in ts)
                         + " ms" for name, ts in turns.items())
                     + f" [{card}]")
        print(line)
        del q, k, v, out, ref
    torch.cuda.empty_cache()
    return max_err, timing


def xla_pair(dev, fa_ops, fa_kernel):
    """Reduced gemma3-1b (window 64), bf16, B=2 prompts of 256 tokens:
    prefill logits through the kernel against ``attention_impl="xla"``
    (sound), and with the first LOCAL layer's window one short (the
    planted fault).  Returns (sound, fault)."""
    import numpy as np
    import torch
    from repro_torch import random as prng
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = get_config(G_ARCH + "-reduced").replace(dtype="bfloat16",
                                                  attention_impl="pallas")
    params, _ = T.init(cfg, prng.PRNGKey(0), device=dev)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 256)), device=dev)
    kernel_attention = fa_ops.flash_attention
    seen = []

    def off_by_one(q, k, v, *, causal, window):
        seen.append(window)
        return kernel_attention(q, k, v, causal=causal,
                                window=window - (len(seen) == 1))

    def prefill(c, attention=kernel_attention):
        fa_ops.flash_attention = attention
        try:
            cache, _ = T.init_cache(c, 2, 256, device=dev)
            before = fa_kernel.launches
            logits, _ = T.prefill(params, c, {"tokens": tokens}, cache)
            return logits.float().cpu(), fa_kernel.launches - before
        finally:
            fa_ops.flash_attention = kernel_attention

    got, launches = prefill(cfg)
    want, xla_launches = prefill(cfg.replace(attention_impl="xla"))
    faulty, _ = prefill(cfg, off_by_one)
    if launches != cfg.n_layers or xla_launches != 0 or seen[0] != \
            cfg.window:
        raise AssertionError(f"reduced {G_ARCH}: launches {launches} / "
                             f"{xla_launches}, first window {seen[:1]}")
    return (float((got - want).abs().max()),
            float((faulty - want).abs().max()))


def serving_phase(dev, fa_kernel, fa_ops, card):
    """Phase 10: generate at gemma3-1b's full width on the card, after the
    bf16 kernel is held to the xla path at model level (reduced)."""
    sound, fault = xla_pair(dev, fa_ops, fa_kernel)
    if not sound <= G_XLA_ATOL < fault:
        raise AssertionError(f"reduced {G_ARCH} bf16 prefill logits, kernel "
                             f"against xla: sound {sound:.3e}, planted "
                             f"fault {fault:.3e}, atol {G_XLA_ATOL}")
    print(f"reduced {G_ARCH} bf16 prefill logits, kernel against "
          f"attention_impl='xla': sound {sound:.3e}, planted fault (first "
          f"LOCAL window one short) {fault:.3e}, atol {G_XLA_ATOL} "
          f"[{card}]")
    import numpy as np
    import torch
    from repro_torch import random as prng
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serve import generate
    cfg = get_config(G_ARCH).replace(attention_impl="pallas")
    print(f"{cfg.name}: {cfg.n_layers} layers ({cfg.n_groups} stacked groups "
          f"of {cfg.pattern_period} + {cfg.n_remainder} rem), d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} KV head, "
          f"d_head {cfg.d_head}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, window "
          f"{cfg.window}, {cfg.dtype}; {cfg.n_params() / 1e9:.4f} G params")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, _ = T.init(cfg, prng.PRNGKey(0), device=dev)
    sync(dev)
    init_s = time.perf_counter() - t0
    from repro_torch.tree import leaves
    n = sum(x.numel() for x in leaves(params))
    nbytes = sum(x.numel() * x.element_size() for x in leaves(params))
    print(f"keyed init: {n} params, {nbytes / 1e9:.3f} GB, {init_s:.2f} s, "
          f"peak {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (G_B, G_S0))
    generate(params, cfg, prompts, 2)                  # warm-up
    sync(dev)
    pre = []
    for _ in range(3):
        t0 = time.perf_counter()
        cache, _ = T.init_cache(cfg, G_B, G_S0 + G_NEW, device=dev)
        logits, cache = T.prefill(params, cfg, {"tokens": torch.as_tensor(
            prompts, device=dev)}, cache)
        sync(dev)
        pre.append(time.perf_counter() - t0)
        del cache, logits
    prefill_ms = statistics.median(pre) * 1e3
    torch.cuda.reset_peak_memory_stats()
    fa_kernel.launches = 0
    t0 = time.perf_counter()
    res = generate(params, cfg, prompts, G_NEW)
    sync(dev)
    total_s = time.perf_counter() - t0
    launches = fa_kernel.launches
    peak = torch.cuda.max_memory_allocated()
    if launches != cfg.n_layers:
        raise AssertionError(f"flash_attention launched {launches} times in "
                             f"one generate call, want {cfg.n_layers} (one "
                             f"per prefill attention layer)")
    if res.tokens.shape != (G_B, G_S0 + G_NEW) or not np.isfinite(
            res.logprobs).all() or not (res.logprobs[:, :-1] <= 0).all():
        raise AssertionError(f"generate: tokens {res.tokens.shape}, "
                             f"logprobs {res.logprobs}")
    if not ((res.tokens >= 0) & (res.tokens < cfg.vocab)).all():
        raise AssertionError("generate: token ids out of the vocabulary")
    decode_ms = (total_s * 1e3 - prefill_ms) / (G_NEW - 1)
    tok_s = G_B * G_NEW / total_s
    print(f"generate B={G_B} S0={G_S0} max_new={G_NEW} greedy: "
          f"{total_s * 1e3:.2f} ms (host clock, synced); prefill "
          f"{prefill_ms:.2f} ms (median of 3, cache allocation included); "
          f"decode {decode_ms:.3f} ms/token; {tok_s:.2f} generated tokens/s; "
          f"peak memory {peak / 1e9:.3f} GB; flash_attention launches "
          f"{launches}; mean logprob {float(res.logprobs[:, :-1].mean()):.4f}")
    wall, busy, n_ops, top = profile_device(
        lambda: generate(params, cfg, prompts, G_NEW))
    print(f"profiled one generate call: wall {wall * 1e3:.1f} ms, device "
          f"busy {busy * 1e3:.2f} ms ({100 * busy / wall:.2f}%, idle "
          f"{100 * (1 - busy / wall):.2f}%), {n_ops} device ops; top "
          f"kernels:")
    for kname, secs, count in top:
        print(f"  {secs * 1e3:8.3f} ms  {count:6d}x  {kname[:100]}")
    out = {"prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms,
           "tokens_per_s": tok_s, "generate_ms": total_s * 1e3,
           "peak_memory_gb": peak / 1e9, "init_s": init_s,
           "device_busy_share": busy / wall, "launches": launches,
           "xla_pair": {"sound": sound, "fault": fault}}
    del params
    torch.cuda.empty_cache()
    return out


def teacher_forced_logits(params, cfg, seq, s0, n_new, device):
    """Prefill of ``seq[:, :s0]`` and decode along ``seq``: the logits of
    each of the ``n_new`` positions, [n_new, V] on the host."""
    import torch
    from repro_torch.models import transformer as T
    cache, _ = T.init_cache(cfg, 1, s0 + n_new, device=device)
    t = torch.as_tensor(seq, device=device)
    steps = [T.prefill(params, cfg, {"tokens": t[:, :s0]}, cache)[0]]
    for i in range(s0, s0 + n_new - 1):
        steps.append(T.decode_step(params, cfg, cache, t[:, i:i + 1], i)[0])
    return torch.stack(steps)[:, 0].cpu()


def held_greedy_tokens(gen, logits_cpu, s0, n_new, tol):
    """The greedy tokens of the CPU and the card must be equal wherever the
    CPU's top-2 logit margin exceeds ``tol``, up to the first near-tie that
    went either way.  Returns (cpu tokens, card tokens, count held)."""
    import numpy as np
    import torch
    new_cpu = gen["cpu"].tokens[0, s0:]
    new_card = gen["cuda"].tokens[0, s0:]
    checked = 0
    for i in range(n_new):
        if not np.array_equal(new_cpu[:i], new_card[:i]):
            break                 # an earlier near-tie diverged: stop there
        top2 = torch.topk(logits_cpu[i], 2).values
        if float(top2[0] - top2[1]) <= tol:
            continue              # a near-tie may go either way
        if new_cpu[i] != new_card[i]:
            raise AssertionError(f"greedy token {i}: cpu {new_cpu[i]}, card "
                                 f"{new_card[i]} (top-2 margin "
                                 f"{float(top2[0] - top2[1]):.3e})")
        checked += 1
    return new_cpu, new_card, checked


def serving_card_vs_cpu(dev, fa_kernel):
    """Phase 11: gemma3-1b at full width cut to one pattern period, fp32,
    on the CPU and on the card from the same weights (drawn on the card,
    copied to the host): greedy ``generate`` on both, then the prefill and
    decode logits of both along the CPU's generated tokens."""
    import numpy as np
    import torch
    from repro_torch import random as prng
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serve import generate
    from repro_torch.tree import tree_map
    cfg = get_config(G_ARCH).replace(n_layers=G_CMP_LAYERS, dtype="float32",
                                     attention_impl="pallas")
    params = {"cuda": T.init(cfg, prng.PRNGKey(1), device=dev)[0]}
    params["cpu"] = tree_map(lambda x: x.cpu(), params["cuda"])
    devices = {"cpu": torch.device("cpu"), "cuda": dev}
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, (1, G_CMP_S0))
    gen = {}
    for name, device in devices.items():
        fa_kernel.launches = 0
        gen[name] = generate(params[name], cfg, prompt, G_CMP_NEW)
        want = G_CMP_LAYERS if name == "cuda" else 0
        if fa_kernel.launches != want:
            raise AssertionError(f"{name}: flash_attention launches "
                                 f"{fa_kernel.launches}, want {want}")
    logits = {name: teacher_forced_logits(params[name], cfg,
                                          gen["cpu"].tokens, G_CMP_S0,
                                          G_CMP_NEW, device)
              for name, device in devices.items()}
    diff = float((logits["cuda"] - logits["cpu"]).abs().max())
    if not torch.allclose(logits["cuda"], logits["cpu"], atol=G_CMP_TOL,
                          rtol=G_CMP_TOL):
        raise AssertionError(f"card and CPU logits differ by {diff:.3e} "
                             f"(atol/rtol {G_CMP_TOL})")
    new_cpu, new_card, checked = held_greedy_tokens(
        gen, logits["cpu"], G_CMP_S0, G_CMP_NEW, G_CMP_TOL)
    print(f"{cfg.name} cut to {G_CMP_LAYERS} layers, fp32, B=1 S0={G_CMP_S0}"
          f": prefill + {G_CMP_NEW - 1} decode logits agree, max abs diff "
          f"{diff:.3e} (atol/rtol {G_CMP_TOL}); greedy tokens cpu "
          f"{new_cpu.tolist()}, card {new_card.tolist()} ({checked} of "
          f"{G_CMP_NEW} held equal, the rest near-ties)")
    del params
    torch.cuda.empty_cache()
    return diff


def rwkv6_bound_ms(B, S, H, Dk, Dv, itemsize):
    """Least time on the card for one rwkv6_scan call: the larger of its
    bytes (r, k, v read once in the input type, log_w and u once in fp32,
    o written once) over the memory rate, and its flops (a (token, head)
    needs r.S, 2 Dk Dv; the state's decay and update, 3 Dk Dv; the bonus,
    3 Dk + 2 Dv) over the peak rate of the input type.  Returns (ms of the
    bytes, ms of the operations)."""
    tokens = B * S * H
    nbytes = (tokens * (2 * Dk + 2 * Dv) * itemsize + tokens * Dk * 4
              + H * Dk * 4)
    flops = tokens * (5 * Dk * Dv + 3 * Dk + 2 * Dv)
    rate = BF16_FLOPS if itemsize == 2 else FP32_FLOPS
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / rate * 1e3


def rwkv6_inputs(B, S, H, Dk, Dv, dtype, rng, lw=None):
    """r, k, v (normal, in ``dtype``), log_w = -exp(normal) (or the constant
    ``lw``, or with ``lw="model"`` -exp(w0) with w0 as the model initialises
    it, linspace(-6, -0.3) over the H * Dk channels, the same in every
    token) and u = 0.1 normal, both fp32: the reference's test draws."""
    import numpy as np
    import torch
    dev = torch.device("cuda")
    dt = getattr(torch, dtype)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=dev)
    r, k = (t(rng.normal(size=(B, S, H, Dk))).to(dt) for _ in range(2))
    v = t(rng.normal(size=(B, S, H, Dv))).to(dt)
    if lw is None:
        log_w = -np.exp(rng.normal(size=(B, S, H, Dk)))
    elif lw == "model":
        log_w = np.broadcast_to(-np.exp(np.linspace(-6.0, -0.3, H * Dk)
                                        ).reshape(H, Dk), (B, S, H, Dk))
    else:
        log_w = np.full((B, S, H, Dk), lw)
    return r, k, v, t(log_w), t(0.1 * rng.normal(size=(H, Dk)))


def rwkv6_phase(rw_ops, rw_kernel, card):
    """Phase 12: the kernel against its plain version at the reference's
    sweep, at extreme decay and at the loss path's shape, with the
    reference's draws of log w and with the model's own slow decays; in
    bf16 the CUDA-core design (the yardstick) too.  At the path's shape
    the two bf16 designs are timed in turns (CUDA cores, tensor cores,
    tensor cores, CUDA cores), each with its achieved GB/s and share of
    the bound.  Returns (max abs err of the path's kernel, timings)."""
    import numpy as np
    import torch
    dev = torch.device("cuda")
    cases = []
    for dtype in ("float32", "bfloat16"):
        for S, H, Dk, Dv, chunk in ((64, 2, 64, 64, 32), (128, 4, 64, 64, 32),
                                    (96, 1, 32, 32, 32),
                                    (256, 2, 64, 128, 64)):
            cases.append((2, S, H, Dk, Dv, chunk, dtype, None))
        cases.append((R_B, R_S, 64, 64, 64, 32, dtype, None))
        for lw in (-50.0, -math.exp(8.0)):
            cases.append((1, 64, 1, 32, 32, 32, dtype, lw))
    cases.append((R_B, R_S, 64, 64, 64, 32, "bfloat16", "model"))
    rng = np.random.default_rng(0)
    max_err = 0.0
    timing = None
    for B, S, H, Dk, Dv, chunk, dtype, lw in cases:
        r, k, v, log_w, u = rwkv6_inputs(B, S, H, Dk, Dv, dtype, rng, lw)
        extreme = isinstance(lw, float)
        if extreme:
            u = torch.zeros_like(u)
        out = rw_ops.rwkv6(r, k, v, log_w, u, chunk=chunk)
        ref = rw_ops.rwkv6(r, k, v, log_w, u, chunk=chunk, use_kernel=False)
        sync(dev)
        err = float((out.float() - ref.float()).abs().max())
        # extreme decay: the reference's atol 1e-3; in bf16 with the bf16
        # rtol beside it, as both sides round o to bf16
        atol = 1e-3 if extreme else RW_ATOL[dtype]
        rtol = (0.0 if dtype == "float32" else RW_RTOL) if extreme else RW_RTOL
        tag = f"B={B} S={S} H={H} Dk={Dk} Dv={Dv} chunk={chunk} {dtype}"
        if lw is not None:
            tag += f" log_w={lw if lw == 'model' else format(lw, '.6g')}"

        def held(x, name):
            if not (bool(torch.isfinite(x).all()) and torch.allclose(
                    x.float(), ref.float(), atol=atol, rtol=rtol)):
                diff = float((x.float() - ref.float()).abs().max())
                raise AssertionError(
                    f"rwkv6_scan {tag} ({name}): differs from the plain "
                    f"version by {diff:.3e} (atol {atol}, rtol {rtol})")
        held(out, "path")
        max_err = max(max_err, err)
        line = (f"rwkv6_scan {tag}: max abs err {err:.3e} (largest |o| "
                f"{float(ref.float().abs().max()):.3e}; atol {atol}, rtol "
                f"{rtol})")
        if dtype == "bfloat16":
            other = rw_kernel.rwkv6_design(r, k, v, log_w, u, chunk=chunk,
                                           design="cuda_cores")
            held(other, "cuda_cores")
            line += (f"; cuda_cores design "
                     f"{float((other.float() - ref.float()).abs().max()):.3e}")
            del other
        if S == R_S and dtype == "bfloat16" and lw is None:
            def design(name):
                return lambda: rw_kernel.rwkv6_design(
                    r, k, v, log_w, u, chunk=chunk, design=name)
            turns = {"cuda_cores": [], "tensor_cores": []}
            for name in ("cuda_cores", "tensor_cores", "tensor_cores",
                         "cuda_cores"):
                turns[name].append(graph_ms(design(name), iters=10,
                                            replays=10))
            ms = graph_ms(lambda: rw_ops.rwkv6(r, k, v, log_w, u,
                                               chunk=chunk),
                          iters=10, replays=10)
            plain_ms = graph_ms(lambda: rw_ops.rwkv6(
                r, k, v, log_w, u, chunk=chunk, use_kernel=False),
                iters=1, replays=3)
            bytes_ms, ops_ms = rwkv6_bound_ms(B, S, H, Dk, Dv, 2)
            bound_ms = max(bytes_ms, ops_ms)
            bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
            nbytes = bytes_ms * 1e-3 * HBM_BYTES_PER_S
            timing = (ms, plain_ms, bound_ms, bound_by, bytes_ms, ops_ms,
                      {n: statistics.median(t) for n, t in turns.items()})
            def rate(t_ms):
                return (f"{nbytes / (t_ms * 1e-3) / 1e9:.1f} GB/s, "
                        f"{100 * bound_ms / t_ms:.1f}% of the bound")
            line += (f"; kernel {ms:.4f} ms ({rate(ms)}), plain "
                     f"{plain_ms:.4f} ms (device), bound {bound_ms:.4f} ms "
                     f"({bound_by}; bytes {bytes_ms:.4f} ms, operations "
                     f"{ops_ms:.4f} ms); library: none computes this "
                     f"recurrence; in turns: " + ", ".join(
                         f"{name} " + " / ".join(f"{t:.4f}" for t in ts)
                         + f" ms ({rate(statistics.median(ts))})"
                         for name, ts in turns.items()) + f" [{card}]")
        print(line)
        del r, k, v, log_w, u, out, ref
    torch.cuda.empty_cache()
    return max_err, timing


def rwkv_path_phase(dev, rw_kernel):
    """Phase 13: rwkv6-7b at full width on the card: loss_fn through the
    kernel and through the plain path, then generate."""
    import numpy as np
    import torch
    from repro_torch import random as prng
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serve import generate
    from repro_torch.tree import leaves
    cfg = get_config(R_ARCH).replace(rwkv_impl="pallas")
    print(f"{cfg.name}: {cfg.n_layers} layers ({cfg.n_groups} stacked groups "
          f"of {cfg.pattern_period} + {cfg.n_remainder} rem), d_model "
          f"{cfg.d_model}, {cfg.d_model // cfg.rwkv_head_dim} heads of "
          f"{cfg.rwkv_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, decay "
          f"LoRA {cfg.rwkv_decay_lora}, {cfg.dtype}; "
          f"{cfg.n_params() / 1e9:.4f} G params")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, _ = T.init(cfg, prng.PRNGKey(0), device=dev)
    sync(dev)
    init_s = time.perf_counter() - t0
    n = sum(x.numel() for x in leaves(params))
    nbytes = sum(x.numel() * x.element_size() for x in leaves(params))
    init_peak = torch.cuda.max_memory_allocated()
    print(f"keyed init: {n} params, {nbytes / 1e9:.3f} GB, {init_s:.2f} s, "
          f"peak {init_peak / 1e9:.3f} GB")
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (R_B, R_S)),
                             device=dev)
    labels = torch.as_tensor(rng.integers(0, cfg.vocab, (R_B, R_S)),
                             device=dev)
    batch = {"tokens": tokens, "labels": labels}

    def timed_loss(c, want_launches):
        """Median host ms of 3 synced loss_fn calls, the last loss, and the
        kernel's launches in each call (counted from 0 just before it)."""
        times = []
        for _ in range(3):
            rw_kernel.launches = 0
            t0 = time.perf_counter()
            loss, _ = T.loss_fn(params, c, batch)
            sync(dev)
            times.append(time.perf_counter() - t0)
            if rw_kernel.launches != want_launches:
                raise AssertionError(
                    f"rwkv6_scan launched {rw_kernel.launches} times in one "
                    f"loss_fn call with rwkv_impl={c.rwkv_impl!r}, want "
                    f"{want_launches}")
        return statistics.median(times) * 1e3, float(loss)

    T.loss_fn(params, cfg, batch)                      # warm-up
    sync(dev)
    torch.cuda.reset_peak_memory_stats()
    launches = cfg.n_layers                            # one per layer
    loss_ms, loss = timed_loss(cfg, launches)
    loss_peak = torch.cuda.max_memory_allocated()
    if not math.isfinite(loss):
        raise AssertionError(f"loss_fn: non-finite loss {loss}")
    xla_ms, xla_loss = timed_loss(cfg.replace(rwkv_impl="xla"), 0)
    print(f"loss_fn B={R_B} S={R_S} (host clock, synced, median of 3): "
          f"pallas {loss_ms:.2f} ms, loss {loss:.6f}, rwkv6_scan launches in "
          f"each call {launches}; xla {xla_ms:.2f} ms, loss {xla_loss:.6f} "
          f"(ln vocab = {math.log(cfg.vocab):.4f}); peak memory "
          f"{loss_peak / 1e9:.3f} GB")
    wall, busy, n_ops, top = profile_device(
        lambda: T.loss_fn(params, cfg, batch))
    print(f"profiled one loss_fn call (pallas): wall {wall * 1e3:.1f} ms, "
          f"device busy {busy * 1e3:.2f} ms ({100 * busy / wall:.2f}%, idle "
          f"{100 * (1 - busy / wall):.2f}%), {n_ops} device ops; top kernels:")
    for kname, secs, count in top:
        print(f"  {secs * 1e3:8.3f} ms  {count:6d}x  {kname[:100]}")
    loss_busy = busy / wall

    prompts = rng.integers(0, cfg.vocab, (R_B, R_S))
    generate(params, cfg, prompts, 2)                  # warm-up
    sync(dev)
    pre = []
    for _ in range(3):
        t0 = time.perf_counter()
        cache, _ = T.init_cache(cfg, R_B, R_S + R_NEW, device=dev)
        logits, cache = T.prefill(params, cfg, {"tokens": torch.as_tensor(
            prompts, device=dev)}, cache)
        sync(dev)
        pre.append(time.perf_counter() - t0)
        del cache, logits
    prefill_ms = statistics.median(pre) * 1e3
    torch.cuda.reset_peak_memory_stats()
    rw_kernel.launches = 0
    t0 = time.perf_counter()
    res = generate(params, cfg, prompts, R_NEW)
    sync(dev)
    total_s = time.perf_counter() - t0
    gen_launches = rw_kernel.launches
    peak = torch.cuda.max_memory_allocated()
    if gen_launches:
        raise AssertionError(f"rwkv6_scan launched {gen_launches} times in "
                             f"generate; the reference's rule keeps prefill "
                             f"and decode on the plain recurrence")
    if res.tokens.shape != (R_B, R_S + R_NEW) or not np.isfinite(
            res.logprobs).all() or not (res.logprobs[:, :-1] <= 0).all():
        raise AssertionError(f"generate: tokens {res.tokens.shape}, "
                             f"logprobs {res.logprobs}")
    if not ((res.tokens >= 0) & (res.tokens < cfg.vocab)).all():
        raise AssertionError("generate: token ids out of the vocabulary")
    decode_ms = (total_s * 1e3 - prefill_ms) / (R_NEW - 1)
    tok_s = R_B * R_NEW / total_s
    print(f"generate B={R_B} S0={R_S} max_new={R_NEW} greedy: "
          f"{total_s * 1e3:.2f} ms (host clock, synced); prefill "
          f"{prefill_ms:.2f} ms (median of 3, cache allocation included); "
          f"decode {decode_ms:.3f} ms/token; {tok_s:.2f} generated tokens/s; "
          f"peak memory {peak / 1e9:.3f} GB; rwkv6_scan launches "
          f"{gen_launches}; mean logprob "
          f"{float(res.logprobs[:, :-1].mean()):.4f}")
    wall, busy, n_ops, top = profile_device(
        lambda: generate(params, cfg, prompts, R_NEW))
    print(f"profiled one generate call: wall {wall * 1e3:.1f} ms, device "
          f"busy {busy * 1e3:.2f} ms ({100 * busy / wall:.2f}%, idle "
          f"{100 * (1 - busy / wall):.2f}%), {n_ops} device ops; top "
          f"kernels:")
    for kname, secs, count in top:
        print(f"  {secs * 1e3:8.3f} ms  {count:6d}x  {kname[:100]}")
    out = {"init_s": init_s, "init_peak_gb": init_peak / 1e9,
           "loss_ms_pallas": loss_ms, "loss_ms_xla": xla_ms, "loss": loss,
           "loss_xla": xla_loss, "loss_peak_gb": loss_peak / 1e9,
           "loss_device_busy_share": loss_busy, "launches": launches,
           "prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms,
           "tokens_per_s": tok_s, "generate_ms": total_s * 1e3,
           "generate_peak_gb": peak / 1e9, "generate_launches": gen_launches,
           "generate_device_busy_share": busy / wall}
    del params
    torch.cuda.empty_cache()
    return out


def rwkv_card_vs_cpu(dev, rw_kernel):
    """Phase 14: rwkv6-7b at full width cut to 2 layers, fp32, on the CPU and
    on the card from the same weights (drawn on the card, copied to the
    host): the forward's logits (kernel on the card, the plain path on the
    CPU), greedy generate on both, then prefill and decode logits of both
    along the CPU's generated tokens."""
    import numpy as np
    import torch
    from repro_torch import random as prng
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serve import generate
    from repro_torch.tree import tree_map
    cfg = get_config(R_ARCH).replace(n_layers=R_CMP_LAYERS, dtype="float32",
                                     rwkv_impl="pallas")
    params = {"cuda": T.init(cfg, prng.PRNGKey(1), device=dev)[0]}
    params["cpu"] = tree_map(lambda x: x.cpu(), params["cuda"])
    devices = {"cpu": torch.device("cpu"), "cuda": dev}
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, (1, R_CMP_S))
    fwd = {}
    for name, device in devices.items():
        c = cfg if name == "cuda" else cfg.replace(rwkv_impl="xla")
        rw_kernel.launches = 0
        fwd[name] = T.apply(params[name], c, {"tokens": torch.as_tensor(
            prompt, device=device)})[0].cpu()
        want = R_CMP_LAYERS if name == "cuda" else 0
        if rw_kernel.launches != want:
            raise AssertionError(f"{name}: rwkv6_scan launches "
                                 f"{rw_kernel.launches}, want {want}")
    fwd_diff = float((fwd["cuda"] - fwd["cpu"]).abs().max())
    if not torch.allclose(fwd["cuda"], fwd["cpu"], atol=R_CMP_TOL,
                          rtol=R_CMP_TOL):
        raise AssertionError(f"forward logits: card (kernel) and CPU (plain) "
                             f"differ by {fwd_diff:.3e} (atol/rtol "
                             f"{R_CMP_TOL})")
    gen = {name: generate(params[name], cfg, prompt, R_CMP_NEW)
           for name in devices}
    logits = {name: teacher_forced_logits(params[name], cfg,
                                          gen["cpu"].tokens, R_CMP_S,
                                          R_CMP_NEW, device)
              for name, device in devices.items()}
    diff = float((logits["cuda"] - logits["cpu"]).abs().max())
    if not torch.allclose(logits["cuda"], logits["cpu"], atol=R_CMP_TOL,
                          rtol=R_CMP_TOL):
        raise AssertionError(f"card and CPU prefill/decode logits differ by "
                             f"{diff:.3e} (atol/rtol {R_CMP_TOL})")
    new_cpu, new_card, checked = held_greedy_tokens(
        gen, logits["cpu"], R_CMP_S, R_CMP_NEW, R_CMP_TOL)
    print(f"{cfg.name} cut to {R_CMP_LAYERS} layers, fp32, B=1 S={R_CMP_S}: "
          f"forward logits (kernel on the card, plain on the CPU) max abs "
          f"diff {fwd_diff:.3e}; prefill + {R_CMP_NEW - 1} decode logits max "
          f"abs diff {diff:.3e} (atol/rtol {R_CMP_TOL}); greedy tokens cpu "
          f"{new_cpu.tolist()}, card {new_card.tolist()} ({checked} of "
          f"{R_CMP_NEW} held equal, the rest near-ties)")
    del params
    torch.cuda.empty_cache()
    return max(fwd_diff, diff)


def rglru_bound_ms(B, S, R):
    """Least time on the card for one rglru_scan call: the larger of its
    bytes (a and b read once, h written once, fp32) over the memory rate
    and its flops (a product and a sum an element) over the fp32 rate.
    Returns (ms of the bytes, ms of the operations)."""
    n = B * S * R
    return 12 * n / HBM_BYTES_PER_S * 1e3, 2 * n / FP32_FLOPS * 1e3


def rglru_inputs(B, S, R, rng, a_value=None):
    """a = sigmoid(normal + 2) in (0, 1) (or the constant ``a_value``) and
    b = 0.5 normal, fp32 on the card: the reference's test draws."""
    import numpy as np
    import torch
    dev = torch.device("cuda")
    a = (1.0 / (1.0 + np.exp(-(rng.normal(size=(B, S, R)) + 2.0)))
         if a_value is None else np.full((B, S, R), a_value))
    b = 0.5 * rng.normal(size=(B, S, R))
    return (torch.as_tensor(a.astype(np.float32), device=dev),
            torch.as_tensor(b.astype(np.float32), device=dev))


def rglru_phase(rg_ops):
    """Phase 15: the kernel against its plain version, bit for bit, at the
    reference's sweep, at ragged S, at a = 1 - 1e-7 over 4,096 steps
    and at the RG-LRU path's width.  Returns the max abs error (0)."""
    import numpy as np
    import torch
    # (B, S, R, chunk, a): the reference's sweep; S=100 at chunk 64 (halved
    # to 4); ragged tails past the kernel's 16-step tiles (S=100, a prime S
    # with R off the block, S under one tile); slow decay; the path's B and
    # R over 512 steps
    cases = [(2, 64, 128, 32, None), (2, 100, 128, 128, None),
             (2, 256, 256, 64, None), (2, 100, 128, 64, None),
             (3, 97, 200, 128, None), (2, 7, 128, 128, None),
             (2, 4096, 256, 128, 1.0 - 1e-7), (RG_B, 512, 4096, 128, None)]
    rng = np.random.default_rng(0)
    for B, S, R, chunk, a_value in cases:
        a, b = rglru_inputs(B, S, R, rng, a_value)
        out = rg_ops.rglru_scan(a, b, chunk=chunk)
        ref = rg_ops.rglru_scan(a, b, use_kernel=False)
        sync(a.device)
        tag = (f"B={B} S={S} R={R} chunk={chunk}"
               + (f" a={float(a.max()):.9g}" if a_value else ""))
        if not (bool(torch.isfinite(out).all()) and torch.equal(out, ref)):
            raise AssertionError(
                f"rglru_scan {tag}: kernel differs from the plain version "
                f"by {float((out - ref).abs().max()):.3e}; both round the "
                f"product and the sum once each and must agree bit for bit")
        print(f"rglru_scan {tag}: bit-equal to the plain version (largest "
              f"|h| {float(ref.abs().max()):.4g})")
        del a, b, out, ref
    torch.cuda.empty_cache()
    return 0.0


def rglru_path_phase(dev, fa_kernel, rg_kernel, rg_ops):
    """Phase 16: recurrentgemma-9b at full width on the card.  (b) the
    kernel's own path: ``ops.rglru_scan`` on the gates of layer 0 at
    B x S0, held bit for bit to the plain version and to the layer's
    log-depth scan within atol/rtol 1e-4, with device times; (a) serving
    through ``generate``."""
    import numpy as np
    import torch
    from repro_torch import random as prng
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.serve import generate
    from repro_torch.tree import leaves, tree_map
    cfg = get_config(RG_ARCH).replace(attention_impl="pallas")
    print(f"{cfg.name}: {cfg.n_layers} layers ({cfg.n_groups} stacked groups "
          f"of {cfg.layer_pattern} + {cfg.n_remainder} rem), d_model "
          f"{cfg.d_model}, rnn {cfg.rnn_d}, conv {cfg.conv_width}, "
          f"{cfg.n_heads} heads / {cfg.n_kv_heads} KV head, d_head "
          f"{cfg.d_head}, window {cfg.window}, d_ff {cfg.d_ff} {cfg.act}, "
          f"vocab {cfg.vocab}, {cfg.dtype}; n_params() "
          f"{cfg.n_params() / 1e9:.4f} G (it leaves out w_a and w_i)")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, _ = T.init(cfg, prng.PRNGKey(0), device=dev)
    sync(dev)
    init_s = time.perf_counter() - t0
    n = sum(x.numel() for x in leaves(params))
    nbytes = sum(x.numel() * x.element_size() for x in leaves(params))
    init_peak = torch.cuda.max_memory_allocated()
    print(f"keyed init: {n} params counted, {nbytes / 1e9:.3f} GB, "
          f"{init_s:.2f} s, peak {init_peak / 1e9:.3f} GB")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (RG_B, RG_S0))
    tokens = torch.as_tensor(prompts, device=dev)

    # (b) the kernel's path on the gates of layer 0, as the block makes them
    with torch.no_grad():
        p = tree_map(lambda x: x[0], params["groups"]["b0"])
        x = L.rms_norm(params["embed"][tokens].to(p["w_x"].dtype), p["ln1"],
                       cfg.norm_eps)
        u, _ = L.causal_conv1d(p["conv_w"], p["conv_b"], x @ p["w_x"])
        log_a, x_in = L._rglru_gates(p, u)
        a = torch.exp(log_a)
        del x, u, log_a
        rg_kernel.launches = 0
        h = rg_ops.rglru_scan(a, x_in)
        sync(dev)
        launches = rg_kernel.launches
        if launches != 1:
            raise AssertionError(f"rglru_scan launched {launches} times on "
                                 f"its path, want 1")
        plain = rg_ops.rglru_scan(a, x_in, use_kernel=False)
        model = L._linear_scan(a, x_in)         # the layer's fp32 h
        sync(dev)
        err = float((h - plain).abs().max())
        model_err = float((h - model).abs().max())
        if not torch.equal(h, plain):
            raise AssertionError(f"rglru_scan on layer 0's gates differs "
                                 f"from the plain version by {err:.3e}")
        if not torch.allclose(h, model, atol=RG_LAYER_TOL, rtol=RG_LAYER_TOL):
            raise AssertionError(f"rglru_scan differs from the layer's "
                                 f"log-depth scan by {model_err:.3e} "
                                 f"(atol/rtol {RG_LAYER_TOL})")
        del plain, model
        ms = graph_ms(lambda: rg_ops.rglru_scan(a, x_in), iters=10,
                      replays=10)
        plain_ms = graph_ms(lambda: rg_ops.rglru_scan(a, x_in,
                                                      use_kernel=False),
                            iters=1, replays=3)
        scan_ms = graph_ms(lambda: L._linear_scan(a, x_in), iters=2,
                           replays=5)
        bytes_ms, ops_ms = rglru_bound_ms(*a.shape)
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        print(f"rglru_scan on layer 0's gates B={RG_B} S={RG_S0} R="
              f"{cfg.rnn_d} (a in [{float(a.min()):.6f}, "
              f"{float(a.max()):.6f}]): {launches} launch; bit-equal to the "
              f"plain version; the layer's log-depth scan within "
              f"{model_err:.3e} (atol/rtol {RG_LAYER_TOL}); kernel {ms:.4f} "
              f"ms, plain {plain_ms:.4f} ms, the layer's log-depth scan "
              f"{scan_ms:.4f} ms (device), bound {bound_ms:.4f} ms "
              f"({bound_by}; bytes {bytes_ms:.4f} ms, operations "
              f"{ops_ms:.4f} ms); library: none computes this recurrence")
        del a, x_in, h
    torch.cuda.empty_cache()
    kernel = {"launches": launches, "max_abs_err": err, "ms": ms,
              "plain_ms": plain_ms, "bound_ms": bound_ms,
              "bound_by": bound_by, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
              "log_depth_scan_ms": scan_ms, "model_layer_err": model_err}

    # (a) serving
    n_local = sum(1 for i in range(cfg.n_layers) if cfg.layer_pattern[
        i % cfg.pattern_period] == "local")
    generate(params, cfg, prompts, 2)                  # warm-up
    sync(dev)
    pre = []
    for _ in range(3):
        t0 = time.perf_counter()
        cache, _ = T.init_cache(cfg, RG_B, RG_S0 + RG_NEW, device=dev)
        logits, cache = T.prefill(params, cfg, {"tokens": tokens}, cache)
        sync(dev)
        pre.append(time.perf_counter() - t0)
        del cache, logits
    prefill_ms = statistics.median(pre) * 1e3
    torch.cuda.reset_peak_memory_stats()
    fa_kernel.launches = rg_kernel.launches = 0
    t0 = time.perf_counter()
    res = generate(params, cfg, prompts, RG_NEW)
    sync(dev)
    total_s = time.perf_counter() - t0
    fa_launches, rg_launches = fa_kernel.launches, rg_kernel.launches
    peak = torch.cuda.max_memory_allocated()
    if fa_launches != n_local or rg_launches:
        raise AssertionError(
            f"generate launched flash_attention {fa_launches} times (want "
            f"{n_local}, one per LOCAL layer of prefill) and rglru_scan "
            f"{rg_launches} times (want 0: the reference's model runs its "
            f"log-depth scan)")
    if res.tokens.shape != (RG_B, RG_S0 + RG_NEW) or not np.isfinite(
            res.logprobs).all() or not (res.logprobs[:, :-1] <= 0).all():
        raise AssertionError(f"generate: tokens {res.tokens.shape}, "
                             f"logprobs {res.logprobs}")
    if not ((res.tokens >= 0) & (res.tokens < cfg.vocab)).all():
        raise AssertionError("generate: token ids out of the vocabulary")
    decode_ms = (total_s * 1e3 - prefill_ms) / (RG_NEW - 1)
    tok_s = RG_B * RG_NEW / total_s
    print(f"generate B={RG_B} S0={RG_S0} max_new={RG_NEW} greedy: "
          f"{total_s * 1e3:.2f} ms (host clock, synced); prefill "
          f"{prefill_ms:.2f} ms (median of 3, cache allocation included); "
          f"decode {decode_ms:.3f} ms/token; {tok_s:.2f} generated tokens/s; "
          f"peak memory {peak / 1e9:.3f} GB; launches: flash_attention "
          f"{fa_launches}, rglru_scan {rg_launches}; mean logprob "
          f"{float(res.logprobs[:, :-1].mean()):.4f}")
    wall, busy, n_ops, top = profile_device(
        lambda: generate(params, cfg, prompts, RG_NEW))
    print(f"profiled one generate call: wall {wall * 1e3:.1f} ms, device "
          f"busy {busy * 1e3:.2f} ms ({100 * busy / wall:.2f}%, idle "
          f"{100 * (1 - busy / wall):.2f}%), {n_ops} device ops "
          f"({n_ops / RG_NEW:.0f} a generated token); top kernels:")
    for kname, secs, count in top:
        print(f"  {secs * 1e3:8.3f} ms  {count:6d}x  {kname[:100]}")
    out = {"init_s": init_s, "init_peak_gb": init_peak / 1e9,
           "params_counted": n, "n_params": cfg.n_params(),
           "prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms,
           "tokens_per_s": tok_s, "generate_ms": total_s * 1e3,
           "peak_memory_gb": peak / 1e9, "flash_launches": fa_launches,
           "rglru_launches": rg_launches, "device_busy_share": busy / wall,
           "device_ops": n_ops, "rglru_scan": kernel}
    del params
    torch.cuda.empty_cache()
    return out


def rglru_card_vs_cpu(dev, fa_kernel):
    """Phase 17: recurrentgemma-9b at full width cut to 8 layers (2 stacked
    groups and the 2-layer remainder, the full model's layout), fp32, on
    the CPU and on the card from the same weights (drawn on the card,
    carried to the host through ``interop``): greedy ``generate`` on both,
    then prefill and decode logits of both along the CPU's tokens."""
    import numpy as np
    import torch
    from repro_torch import random as prng
    from repro_torch.configs import get_config
    from repro_torch.interop import tree_from_numpy, tree_to_numpy
    from repro_torch.models import transformer as T
    from repro_torch.serve import generate
    cfg = get_config(RG_ARCH).replace(n_layers=RG_CMP_LAYERS,
                                      dtype="float32",
                                      attention_impl="pallas")
    params = {"cuda": T.init(cfg, prng.PRNGKey(1), device=dev)[0]}
    params["cpu"] = tree_from_numpy(tree_to_numpy(params["cuda"]), "cpu")
    devices = {"cpu": torch.device("cpu"), "cuda": dev}
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, (1, RG_CMP_S0))
    n_local = sum(1 for i in range(cfg.n_layers) if cfg.layer_pattern[
        i % cfg.pattern_period] == "local")
    gen = {}
    for name, device in devices.items():
        fa_kernel.launches = 0
        gen[name] = generate(params[name], cfg, prompt, RG_CMP_NEW)
        want = n_local if name == "cuda" else 0
        if fa_kernel.launches != want:
            raise AssertionError(f"{name}: flash_attention launches "
                                 f"{fa_kernel.launches}, want {want}")
    logits = {name: teacher_forced_logits(params[name], cfg,
                                          gen["cpu"].tokens, RG_CMP_S0,
                                          RG_CMP_NEW, device)
              for name, device in devices.items()}
    diff = float((logits["cuda"] - logits["cpu"]).abs().max())
    if not torch.allclose(logits["cuda"], logits["cpu"], atol=RG_CMP_TOL,
                          rtol=RG_CMP_TOL):
        raise AssertionError(f"card and CPU logits differ by {diff:.3e} "
                             f"(atol/rtol {RG_CMP_TOL})")
    new_cpu, new_card, checked = held_greedy_tokens(
        gen, logits["cpu"], RG_CMP_S0, RG_CMP_NEW, RG_CMP_TOL)
    print(f"{cfg.name} cut to {RG_CMP_LAYERS} layers ({cfg.n_groups} stacked "
          f"groups + {cfg.n_remainder} rem), fp32, B=1 S0={RG_CMP_S0}: "
          f"prefill + {RG_CMP_NEW - 1} decode logits agree, max abs diff "
          f"{diff:.3e} (atol/rtol {RG_CMP_TOL}); greedy tokens cpu "
          f"{new_cpu.tolist()}, card {new_card.tolist()} ({checked} of "
          f"{RG_CMP_NEW} held equal, the rest near-ties)")
    del params
    torch.cuda.empty_cache()
    return diff


def scenario_spec(rate, deadline, seed, **kw):
    """UniformDropout(rate) (none at rate 0) + LatencyStragglers."""
    from repro_torch.scenario import (LatencyStragglers, ScenarioSpec,
                                      UniformDropout)
    return ScenarioSpec(
        dropout=UniformDropout(rate=rate) if rate > 0 else None,
        stragglers=LatencyStragglers(deadline_s=deadline, mean_step_s=1.0),
        seed=seed, **kw)


def same_run(a, b):
    """(losses, completed, state) of two runs: bit-equal?"""
    from repro_torch.tree import leaves
    return a[0] == b[0] and a[1] == b[1] and all(
        torch_equal(x, y) for x, y in zip(leaves(a[2].w), leaves(b[2].w)))


def torch_equal(a, b):
    import torch
    return torch.equal(a.cpu(), b.cpu())


def run_record(tr, n_rounds, plan, **kw):
    """(losses, completed, state) of ``tr.run``."""
    hist = [r for r in tr.run(n_rounds, plan=plan, verbose=False, **kw)
            if "event" not in r]
    return ([r["loss"] for r in hist], [r.get("completed") for r in hist],
            tr.state)


def scenario_planes_phase(dev, clients, w0, fm_kernel):
    """Phase 19 (a-c): the quickstart configuration under a scenario on the
    per-round, scanned, device and auto planes, against the same planes
    without it; an adaptive cohort and its resume; a trace recorded and
    replayed on the device plane.  Every run here is under
    ``cudnn.deterministic``, so the planes' trajectories can be held bit
    for bit, and shares one sampler and one session, so a chunk shape is
    captured once."""
    import os
    import tempfile

    import numpy as np
    import torch
    from repro_torch.core import DeviceUniformSampler, RoundConfig, fedmom
    from repro_torch.core.sampling import replay_span
    from repro_torch.data import FederatedDataset
    from repro_torch.launch.plan import ExecutionPlan, TrainSession
    from repro_torch.launch.train import FederatedTrainer
    from repro_torch.models import small
    from repro_torch.scenario import AdaptiveCohort, ScenarioSpec
    from repro_torch.scenario.spec import ScenarioRuntime
    from repro_torch.traces import FleetTrace, TraceSpec, record_trace
    ds = FederatedDataset(clients, seed=1)
    pop = ds.population()
    rcfg = RoundConfig(clients_per_round=M, local_steps=H, lr=LR,
                       placement="mesh", compute_dtype="float32")
    opt = fedmom(eta=ETA, beta=BETA, use_fused_kernel=True)
    spec = scenario_spec(SC_DROPOUT, SC_DEADLINE, SC_SEED)
    sampler, session = DeviceUniformSampler(pop, M, seed=2), TrainSession()

    def trainer(**kw):
        return FederatedTrainer(
            loss_fn=small.lenet_loss, server_opt=opt, rcfg=rcfg, dataset=ds,
            sampler=sampler, state=opt.init(w0), local_batch=B, device=dev,
            session=session, **kw)

    def plan(name, scenario):
        if name == "per_round":
            return ExecutionPlan(plane="per_round", scenario=scenario)
        return ExecutionPlan(plane=name, chunk_rounds=G_CR,
                             scenario=scenario)

    names = ("per_round", "scanned", "device", "auto")
    print(f"LeNet, K={K} M={M} H={H} b={B} FedMom eta={ETA} beta={BETA} "
          f"through fedmom_update, DeviceUniformSampler; {ROUNDS} rounds, "
          f"chunks of {G_CR}; scenario UniformDropout({SC_DROPOUT}) + "
          f"LatencyStragglers(deadline_s={SC_DEADLINE}), seed {SC_SEED}; "
          f"cudnn.deterministic; a warm-up run of each, then timed runs in "
          f"turns (none, scenario, scenario, none)")
    out = {"planes": {}}
    runs = {}
    torch.backends.cudnn.deterministic = True
    try:
        for name in names:
            for scen in (None, spec):                       # warm-ups
                trainer().run(ROUNDS, plan=plan(name, scen), verbose=False)
            torch.cuda.synchronize()
            times = {"off": [], "on": []}
            for label in ("off", "on", "on", "off"):
                tr = trainer()
                t0 = time.perf_counter()
                got = run_record(tr, ROUNDS, plan(
                    name, spec if label == "on" else None))
                torch.cuda.synchronize()
                times[label].append((time.perf_counter() - t0) / ROUNDS
                                    * 1e3)
                runs[(name, label)] = got
            rec = tr.session.plan_log[-2]           # the last "on" run's
            if rec["plane"] != ("device" if name == "auto" else name) \
                    or not rec.get("scenario"):
                raise AssertionError(f"{name}: plan record {rec}")
            tr = trainer()
            if name == "per_round":
                fm_kernel.launches = 0
                tr.run(ROUNDS, plan=plan(name, spec), verbose=False)
                fm, how = fm_kernel.launches, "its counter"
            else:
                _, rows = profile_rows(lambda: tr.run(
                    ROUNDS, plan=plan(name, spec), verbose=False))
                fm, how = kernel_launches(rows, FM_KERNEL_NAME), "profiler"
            if fm != ROUNDS:
                raise AssertionError(
                    f"{name} under the scenario: {fm} fedmom_update "
                    f"launches in {ROUNDS} rounds ({how}), want one a "
                    f"round")
            ms_off, ms_on = (statistics.fmean(times["off"]),
                             statistics.fmean(times["on"]))
            completed = runs[(name, "on")][1]
            out["planes"][name] = {"ms_per_round": ms_on,
                                   "ms_per_round_no_scenario": ms_off,
                                   "ms_per_round_runs": times,
                                   "fedmom_update_launches": fm,
                                   "completed_mean": statistics.fmean(
                                       completed)}
            print(f"{name:9s} -> {rec['plane']:9s} scenario {ms_on:8.3f} "
                  f"ms/round, none {ms_off:8.3f} ms/round (host clock, "
                  f"synced at the end; runs {times}); completed mean "
                  f"{statistics.fmean(completed):.3f} of {M}; fedmom_update "
                  f"launches ({how}) {fm} in {ROUNDS} rounds")
        torch.cuda.synchronize()
        print(f"chunk graphs captured: {len(session.graphs)} (one a chunk "
              f"shape and masking, shared by the trainers)")

        ref = runs[("per_round", "on")]
        for name in names:
            for label in ("on", "off"):
                if not same_run(runs[(name, label)],
                                runs[("per_round", label)]):
                    raise AssertionError(
                        f"{name} ({label} scenario): losses, completed "
                        f"counts or final parameters differ from the "
                        f"per-round plane's")
        runtime, cut = ScenarioRuntime(spec, H), 0
        for t in range(ROUNDS):
            cut += int((runtime.steps_for(t, sampler.sample(t)[0]) < H).sum())
        if not cut or runs[("per_round", "off")][0] == ref[0]:
            raise AssertionError("the scenario changed nothing")
        print(f"scanned, device and auto losses, completed counts "
              f"({sum(ref[1])} of {M * ROUNDS} client rounds did some work, "
              f"{cut} stopped "
              f"short of H={H}) and final parameters bit-equal to the "
              f"per-round plane, with the scenario and without it")

        # what staging the scenario costs the host a round: the cohorts'
        # replay (one batched draw a chunk, on the CPU as the trainer does
        # at this population, and on the card) and the masks from it
        replay_span(sampler, 0, G_CR, dev)
        stage = {}
        for where in ("cpu", "cuda"):
            rt = ScenarioRuntime(spec, H)
            t0 = time.perf_counter()
            for s in range(0, ROUNDS, G_CR):
                ids = replay_span(sampler, s, s + G_CR,
                                  dev if where == "cuda" else None)[0]
                for r in range(G_CR):
                    rt.masks_for(s + r, ids[r])
            stage[where] = (time.perf_counter() - t0) / ROUNDS * 1e3
        t0 = time.perf_counter()
        for t in range(ROUNDS):
            sampler.sample(t)
        stage["cpu_per_round_replay"] = ((time.perf_counter() - t0) / ROUNDS
                                         * 1e3)
        out["host_stage_ms_per_round"] = stage
        print(f"scenario staging on the host (replay + masks): "
              f"{stage['cpu']:.3f} ms/round with a chunk's replay batched "
              f"on the CPU (the device plane's at K={K}), {stage['cuda']:.3f}"
              f" ms/round batched on the card; one round's replay alone on "
              f"the CPU {stage['cpu_per_round_replay']:.3f} ms")

        # an adaptive cohort on the scanned plane, and a resume at round
        # SC_RESUME_AT from a checkpoint
        adaptive = ScenarioSpec(dropout=spec.dropout,
                                stragglers=spec.stragglers,
                                cohort=AdaptiveCohort(goal=SC_GOAL),
                                seed=SC_SEED)
        a_plan = plan("scanned", adaptive)
        full = run_record(trainer(), ROUNDS, a_plan)
        with tempfile.TemporaryDirectory() as tmp:
            ck = os.path.join(tmp, "adaptive.npz")
            first = run_record(trainer(ckpt_path=ck, ckpt_every=G_CR),
                               SC_RESUME_AT, a_plan)
            second = run_record(trainer(ckpt_path=ck, ckpt_every=G_CR),
                                ROUNDS, a_plan, resume=True)
        stitched = (first[0] + second[0], first[1] + second[1], second[2])
        if len(second[0]) != ROUNDS - SC_RESUME_AT \
                or not same_run(stitched, full):
            raise AssertionError(
                f"adaptive cohort: the run resumed at round {SC_RESUME_AT} "
                f"differs from the uninterrupted one")
        if not same_run(run_record(trainer(), ROUNDS,
                                   plan("per_round", adaptive)), full):
            raise AssertionError("adaptive cohort: scanned plane differs "
                                 "from the per-round plane")
        print(f"AdaptiveCohort(goal={SC_GOAL}) on the scanned plane: "
              f"completed {full[1]}; a resume at round {SC_RESUME_AT} from "
              f"a checkpoint and the per-round plane bit-equal to the "
              f"uninterrupted run")

        # a trace of the scenario, recorded, saved, loaded and replayed on
        # the device plane against the recording run
        with tempfile.TemporaryDirectory() as tmp:
            trace = record_trace(spec, sampler, ROUNDS, H)
            path = trace.save(os.path.join(tmp, "lenet_trace"))
            loaded = FleetTrace.load(path)
            if not (np.array_equal(loaded.ev_steps, trace.ev_steps)
                    and np.array_equal(loaded.m, trace.m)):
                raise AssertionError("the trace changed through save/load")
            replay = run_record(
                trainer(), ROUNDS,
                plan("device", ScenarioSpec(trace=TraceSpec(path=path))))
        if not same_run(replay, runs[("device", "on")]):
            raise AssertionError(
                "the trace replayed on the device plane differs from the "
                "recording run")
        print(f"trace of {trace.n_events} events over {trace.n_rounds} "
              f"rounds saved, loaded and replayed on the device plane: "
              f"losses, completed counts and parameters bit-equal to the "
              f"recording run (replay_drift_bits 0)")
        out["adaptive_completed"] = full[1]
        out["trace_events"] = trace.n_events
        out["graphs_captured"] = len(session.graphs)
    finally:
        torch.backends.cudnn.deterministic = False
    return out


def b7_provider():
    from repro_torch.scenario import zipf_linreg_provider
    return zipf_linreg_provider(B7_K, dim=B7_DIM, n_min=B7_NMIN,
                                n_max=B7_NMAX, seed=0)


def b7_trainer(provider, opt_name, n_clients, device, hook=False):
    """``_scenario_run`` / ``_trace_run``'s trainer of
    benchmarks/fig6_robustness.py: FedAvg or FedMom (through
    ``fedmom_update``) at eta = K/M, beta 0.9."""
    import torch
    from repro_torch.core import (DeviceUniformSampler, RoundConfig, fedavg,
                                  fedmom)
    from repro_torch.data import StreamingFederatedDataset
    from repro_torch.kernels.client_step.ops import linreg_tier_step
    from repro_torch.launch.train import FederatedTrainer
    ds = StreamingFederatedDataset.from_provider(provider, seed=B7_DATA_SEED)
    eta = n_clients / B7_M
    opt = (fedmom(eta=eta, beta=B7_BETA, use_fused_kernel=True)
           if opt_name == "fedmom" else fedavg(eta=eta))
    return FederatedTrainer(
        loss_fn=linreg_loss, server_opt=opt,
        rcfg=RoundConfig(clients_per_round=B7_M, local_steps=B7_H, lr=B7_LR,
                         placement="mesh", compute_dtype="float32"),
        dataset=ds, sampler=DeviceUniformSampler(ds.population(), B7_M,
                                                 seed=B7_SAMPLER_SEED),
        state=opt.init({"w": torch.zeros(B7_DIM), "b": torch.zeros(())}),
        client_step_fn=linreg_tier_step() if hook else None,
        local_batch=B7_B, device=device)


def b7_plan(scenario, bucketed=False):
    from repro_torch.launch.plan import CacheSpec, ExecutionPlan
    return ExecutionPlan(plane="streaming", chunk_rounds=B7_CR,
                         cache=CacheSpec(clients=B7_CACHE,
                                         bucketed=bucketed),
                         scenario=scenario)


def bench7_phase(dev, fm_kernel, cs_kernel):
    """Phase 19 (d): BENCH_7's dropout sweep at full size on the card, the
    hook lane's cell, and that cell for B7_CMP_ROUNDS rounds on the CPU."""
    import torch
    from repro_torch.tree import leaves
    t0 = time.perf_counter()
    provider = b7_provider()
    row = (B7_DIM + 1) * 4
    declared_mb = provider.counts.nbytes / 2 ** 20
    materialized_mb = float(provider.counts.sum()) * row / 2 ** 20
    print(f"zipf_linreg_provider({B7_K}, dim={B7_DIM}, n_min={B7_NMIN}, "
          f"n_max={B7_NMAX}, seed=0) in {time.perf_counter() - t0:.2f} s: "
          f"the corpus declares {declared_mb:.4f} MB ([K] int64 counts) and "
          f"would materialise {materialized_mb:.2f} MB")
    print(f"M={B7_M} H={B7_H} b={B7_B} lr={B7_LR} chunk_rounds={B7_CR} "
          f"CacheSpec(clients={B7_CACHE}) {B7_ROUNDS} rounds, data seed "
          f"{B7_DATA_SEED}, sampler seed {B7_SAMPLER_SEED}, scenario seed "
          f"{B7_SCEN_SEED}: UniformDropout(rate) + LatencyStragglers("
          f"deadline_s={B7_DEADLINE}); eta=K/M={B7_K / B7_M}")
    cells, finals = {}, {}
    for opt_name in ("fedavg", "fedmom"):
        for rate in B7_RATES:
            tr = b7_trainer(provider, opt_name, B7_K, dev)
            fm_kernel.launches = 0
            t0 = time.perf_counter()
            losses, completed, state = run_record(
                tr, B7_ROUNDS,
                b7_plan(scenario_spec(rate, B7_DEADLINE, B7_SCEN_SEED)))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / B7_ROUNDS * 1e3
            fm = fm_kernel.launches
            want_fm = B7_ROUNDS if opt_name == "fedmom" else 0
            if fm != want_fm:
                raise AssertionError(f"{opt_name} rate {rate}: {fm} "
                                     f"fedmom_update launches, want "
                                     f"{want_fm}")
            if not all(math.isfinite(x) for x in losses):
                raise AssertionError(f"{opt_name} rate {rate}: {losses}")
            cell = {"final_loss": statistics.fmean(losses[-10:]),
                    "completed_mean": statistics.fmean(completed),
                    "ms_per_round": ms,
                    "cache_nbytes": tr.stream_cache.nbytes,
                    "hit_rate": tr.stream_cache.hit_rate,
                    "fedmom_update_launches": fm}
            cells[(opt_name, rate)] = cell
            finals[(opt_name, rate)] = [x.clone() for x in leaves(state.w)]
            ref = B7_REF[(opt_name, rate)]
            if cell["completed_mean"] != ref[0]:
                raise AssertionError(
                    f"{opt_name} rate {rate}: completed_mean "
                    f"{cell['completed_mean']!r}, the reference's "
                    f"{ref[0]!r}")
            if not math.isclose(cell["final_loss"], ref[1],
                                rel_tol=B7_LOSS_RTOL):
                raise AssertionError(
                    f"{opt_name} rate {rate}: final_loss "
                    f"{cell['final_loss']!r}, the reference's {ref[1]!r} "
                    f"(rtol {B7_LOSS_RTOL})")
            cell["final_loss_rel_diff"] = abs(cell["final_loss"] / ref[1]
                                              - 1)
            print(f"{opt_name} rate={rate}: final_loss "
                  f"{cell['final_loss']:.6f} (reference {ref[1]:.6f}, rel "
                  f"diff {cell['final_loss_rel_diff']:.2e}), completed_mean "
                  f"{cell['completed_mean']:.6f} of {B7_M}; {ms:.3f} "
                  f"ms/round (host clock, synced at the end); cache "
                  f"{cell['cache_nbytes']} B, hit rate "
                  f"{cell['hit_rate']:.4f}; fedmom_update launches {fm}")
            del tr
    spread = {o: max(cells[(o, r)]["final_loss"] for r in B7_RATES)
              - min(cells[(o, r)]["final_loss"] for r in B7_RATES)
              for o in ("fedavg", "fedmom")}
    print(f"final-loss spread across the dropout grid: fedavg "
          f"{spread['fedavg']:.6f}, fedmom {spread['fedmom']:.6f}")
    # where a padded round's time goes: two chunks of the hook lane's cell
    tr = b7_trainer(provider, "fedmom", B7_K, dev)
    n_prof = 2 * B7_CR
    wall, busy, n_ops, top = profile_device(lambda: tr.run(
        n_prof, plan=b7_plan(scenario_spec(B7_HOOK_RATE, B7_DEADLINE,
                                           B7_SCEN_SEED)), verbose=False))
    print(f"profiled {n_prof} rounds (2 chunks) of fedmom rate="
          f"{B7_HOOK_RATE}, padded: wall {wall * 1e3:.1f} ms, device busy "
          f"{busy * 1e3:.2f} ms ({100 * busy / wall:.2f}%), "
          f"{n_ops / n_prof:.0f} device ops/round; top kernels:")
    for name, secs, count in top:
        print(f"  {secs * 1e3:8.3f} ms  {count:6d}x  {name[:100]}")
    del tr

    # the hook lane: the same cell bucketed, each tier through client_step
    hook = b7_trainer(provider, "fedmom", B7_K, dev, hook=True)
    spec = scenario_spec(B7_HOOK_RATE, B7_DEADLINE, B7_SCEN_SEED)
    cs_kernel.launches = fm_kernel.launches = 0
    t0 = time.perf_counter()
    losses, completed, state = run_record(hook, B7_ROUNDS,
                                          b7_plan(spec, bucketed=True))
    torch.cuda.synchronize()
    hook_ms = (time.perf_counter() - t0) / B7_ROUNDS * 1e3
    cs, fm = cs_kernel.launches, fm_kernel.launches
    padded = cells[("fedmom", B7_HOOK_RATE)]
    if statistics.fmean(completed) != padded["completed_mean"]:
        raise AssertionError(f"hook lane completed {completed}")
    if cs < B7_ROUNDS or fm != B7_ROUNDS:
        raise AssertionError(f"hook lane: {cs} client_step and {fm} "
                             f"fedmom_update launches in {B7_ROUNDS} rounds")
    worst = 0.0
    for a, b in zip(finals[("fedmom", B7_HOOK_RATE)], leaves(state.w)):
        worst = max(worst, float((a - b).abs().max()))
        if not torch.allclose(a, b, atol=LANE_ATOL, rtol=LANE_RTOL):
            raise AssertionError(
                f"hook lane and padded lane final params differ by "
                f"{worst:.3e} (atol {LANE_ATOL}, rtol {LANE_RTOL})")
    print(f"hook lane (bucketed, client_step) fedmom rate={B7_HOOK_RATE}: "
          f"{hook_ms:.3f} ms/round; client_step launches {cs}, "
          f"fedmom_update launches {fm} in {B7_ROUNDS} rounds; completed "
          f"counts equal to the padded lane's, final params within "
          f"{worst:.3e} of them")
    del hook

    # card against CPU: the same cell, B7_CMP_ROUNDS rounds
    spec = scenario_spec(B7_HOOK_RATE, B7_DEADLINE, B7_SCEN_SEED)
    got = {}
    for device in (torch.device("cpu"), dev):
        tr = b7_trainer(provider, "fedmom", B7_K, device)
        t0 = time.perf_counter()
        got[device.type] = run_record(tr, B7_CMP_ROUNDS, b7_plan(spec))
        got[device.type + "_s"] = time.perf_counter() - t0
        del tr
    if got["cpu"][1] != got["cuda"][1]:
        raise AssertionError(f"completed counts: cpu {got['cpu'][1]}, "
                             f"cuda {got['cuda'][1]}")
    cmp_worst = 0.0
    for a, b in zip(leaves(got["cpu"][2].w), leaves(got["cuda"][2].w)):
        b = b.cpu()
        cmp_worst = max(cmp_worst, float((a - b).abs().max()))
        if not torch.allclose(a, b, atol=LANE_ATOL, rtol=LANE_RTOL):
            raise AssertionError(
                f"card and CPU params differ by {cmp_worst:.3e} (atol "
                f"{LANE_ATOL}, rtol {LANE_RTOL})")
    print(f"card against CPU, fedmom rate={B7_HOOK_RATE}, {B7_CMP_ROUNDS} "
          f"rounds: completed counts equal, final params within "
          f"{cmp_worst:.3e} (atol/rtol {LANE_ATOL}); cpu "
          f"{got['cpu_s']:.2f} s, cuda {got['cuda_s']:.2f} s")
    return {"cells": {f"{o}@{r}": c for (o, r), c in cells.items()},
            "padded_busy_share": busy / wall,
            "padded_ops_per_round": n_ops / n_prof,
            "spread": spread, "declared_mb": declared_mb,
            "materialized_mb": materialized_mb, "hook_ms_per_round": hook_ms,
            "hook_client_step_launches": cs,
            "hook_vs_padded_max_abs_diff": worst,
            "card_vs_cpu_max_abs_diff": cmp_worst,
            "cpu_s": got["cpu_s"], "cuda_s": got["cuda_s"]}


def disk_trace_phase(dev):
    """Phase 19 (e): BENCH_9's fleet written as a disk corpus and read
    through DiskShardProvider; FedMom's rate-0.3 scenario recorded, saved,
    loaded and replayed, bit-equal to the synthetic run."""
    import os
    import tempfile

    import numpy as np
    import torch
    from repro_torch.core import DeviceUniformSampler
    from repro_torch.data import (DiskShardProvider, StreamingFederatedDataset,
                                  write_disk_corpus)
    from repro_torch.scenario import ScenarioSpec, zipf_linreg_provider
    from repro_torch.traces import FleetTrace, TraceRecorder, TraceSpec
    from repro_torch.tree import leaves
    src = zipf_linreg_provider(B9_K, dim=B7_DIM, n_min=B7_NMIN,
                               n_max=B7_NMAX, seed=0)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        corpus = write_disk_corpus(os.path.join(tmp, "corpus"), src,
                                   layout="npy-packed")
        write_s = time.perf_counter() - t0
        disk_mb = sum(os.path.getsize(os.path.join(corpus, f))
                      for f in os.listdir(corpus)) / 2 ** 20
        provider = DiskShardProvider(corpus)
        for cid in (0, B9_K // 2, B9_K - 1):
            a, b = provider.shard(cid), src.shard(cid)
            if not all(np.array_equal(a[k], b[k]) for k in b):
                raise AssertionError(f"disk shard {cid} differs")
        spec = scenario_spec(B9_RATE, B7_DEADLINE, B7_SCEN_SEED)
        pop = StreamingFederatedDataset.from_provider(
            provider, seed=B7_DATA_SEED).population()
        t0 = time.perf_counter()
        trace = TraceRecorder(spec, B7_H).record(
            DeviceUniformSampler(pop, B7_M, seed=B7_SAMPLER_SEED), B9_ROUNDS)
        record_s = time.perf_counter() - t0
        loaded = FleetTrace.load(trace.save(os.path.join(tmp, "trace")))
        runs = {}
        for name, scen in (("replay", ScenarioSpec(
                trace=TraceSpec(trace=loaded))), ("synthetic", spec)):
            tr = b7_trainer(provider, "fedmom", B9_K, dev)
            t0 = time.perf_counter()
            runs[name] = run_record(tr, B9_ROUNDS, b7_plan(scen))
            torch.cuda.synchronize()
            runs[name + "_ms"] = (time.perf_counter() - t0) / B9_ROUNDS * 1e3
            del tr
    rep, syn = runs["replay"], runs["synthetic"]
    bits = sum(int((a.cpu().numpy().view(np.uint32)
                    != b.cpu().numpy().view(np.uint32)).sum())
               for a, b in zip(leaves(rep[2].w), leaves(syn[2].w)))
    bits += sum(a != b for a, b in zip(rep[0], syn[0]))
    if bits or rep[1] != syn[1]:
        raise AssertionError(f"trace replay drifts from the synthetic run "
                             f"by {bits} (parameter bits + losses)")
    completed_mean = statistics.fmean(rep[1])
    if completed_mean != B9_REF_COMPLETED:
        raise AssertionError(f"completed_mean {completed_mean!r}, the "
                             f"reference's {B9_REF_COMPLETED!r}")
    print(f"disk corpus of {B9_K} clients (npy-packed, {disk_mb:.2f} MB) "
          f"written in {write_s:.2f} s; trace of {trace.n_events} events "
          f"recorded in {record_s:.2f} s; FedMom rate={B9_RATE} replay "
          f"{runs['replay_ms']:.3f} ms/round, synthetic "
          f"{runs['synthetic_ms']:.3f} ms/round; replay_drift_bits {bits}; "
          f"completed_mean {completed_mean!r} (the reference's "
          f"{B9_REF_COMPLETED!r}), final_loss "
          f"{statistics.fmean(rep[0][-10:]):.6f}")
    return {"disk_mb": disk_mb, "write_s": write_s,
            "replay_ms_per_round": runs["replay_ms"],
            "synthetic_ms_per_round": runs["synthetic_ms"],
            "replay_drift_bits": bits, "completed_mean": completed_mean,
            "final_loss": statistics.fmean(rep[0][-10:])}


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
    from repro_torch.kernels.client_step import kernel as cs_kernel
    from repro_torch.kernels.client_step import ref as cs_ref
    from repro_torch.kernels.fedmom_update import kernel as fm_kernel
    from repro_torch.kernels.fedmom_update import ops as fm_ops
    from repro_torch.kernels.fedmom_update import ref as fm_ref
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rglru_scan import kernel as rg_kernel
    from repro_torch.kernels.rglru_scan import ops as rg_ops
    from repro_torch.kernels.rwkv6_scan import kernel as rw_kernel
    from repro_torch.kernels.rwkv6_scan import ops as rw_ops
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
    # the per-round path's LeNet, the streaming path's linreg (D + 1), and
    # a large ragged size
    sizes = (n_main, Z_D + 1, 2 ** 26 + 3)
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
            if n >= 1 << 20 and kind == "fedmom":
                # the card's own streaming rate by read:write mix (the
                # kernel's is 3:2), from PyTorch's kernels: timed only
                out = torch.empty_like(w)
                for name, nbytes, fn in (
                        ("copy_ (1:1)", 8, lambda: out.copy_(w)),
                        ("add (2:1)", 12, lambda: torch.add(w, s, out=out)),
                        ("addcmul (3:1)", 16,
                         lambda: torch.addcmul(w, s, d, out=out))):
                    t_ms = cuda_ms(fn, 30)
                    t_bound = nbytes * n / HBM_BYTES_PER_S * 1e3
                    timing[("stream", name)] = (t_ms, t_bound)
                    print(f"  torch {name} n={n}: {t_ms * 1e3:.1f} us, "
                          f"{t_bound / t_ms:.1%} of its bytes bound")
                del out
            del w, s, d
        # the scalar path: streams not 16-byte aligned
        err, bitwise, _ = check_kernel(fm_kernel, fm_ref, kind, n_main - 1,
                                       gen, offset=1)
        if not bitwise:
            raise AssertionError(f"{kind} unaligned: kernel differs from "
                                 f"the plain version (max abs {err})")
        print(f"{kind:8s} n={n_main - 1:>9d}  unaligned (scalar path) "
              f"bit-equal")
    fm_tree = fedmom_tree_phase(
        torch.device("cuda"), fm_kernel, fm_ops, fm_ref,
        small.lenet_init(prng.PRNGKey(0), device=torch.device("cuda")))
    torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    phase("4. kernel against plain (client_step)")
    dev = torch.device("cuda")
    z_clients = zipf_clients()
    cs_err, cs_timing, cs_top, cs_wide = client_step_phase(
        dev, z_clients, cs_kernel, cs_ref, fm_kernel, n_main)
    torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    phase("5. per-round path: FedAvg then FedMom (fused) on cuda")
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
    phase(f"6. per-round card against CPU: {CMP_ROUNDS} FedMom rounds")
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
    phase("7. scanned, device and auto planes: chunks as CUDA graphs")
    graph_planes = graph_planes_phase(dev, clients, w0)
    torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    phase("8. streaming path: padded, bucketed and hook lanes, and the "
          "device plane, on cuda")
    lanes = streaming_lanes(dev, z_clients, fm_kernel, cs_kernel)
    zipf_device = zipf_device_plane(dev, z_clients, lanes)

    # ------------------------------------------------------------------
    phase(f"9. streaming card against CPU: {Z_CMP_ROUNDS} rounds of the "
          f"hook lane")
    streaming_card_vs_cpu(z_clients, cs_kernel, lanes["hook"]["plan"],
                          (torch.device("cpu"), dev))

    # ------------------------------------------------------------------
    phase("10. kernel against plain (flash_attention)")
    fa_err, fa_timing = flash_phase(fa_ops, fa_kernel, card)

    # ------------------------------------------------------------------
    phase(f"11. serving path: {G_ARCH} at full width on cuda")
    serving = serving_phase(dev, fa_kernel, fa_ops, card)

    # ------------------------------------------------------------------
    phase(f"12. serving card against CPU: {G_ARCH} cut to {G_CMP_LAYERS} "
          f"layers, fp32")
    serving["card_vs_cpu_max_abs_diff"] = serving_card_vs_cpu(dev, fa_kernel)

    # ------------------------------------------------------------------
    phase("13. kernel against plain (rwkv6_scan)")
    rw_err, rw_timing = rwkv6_phase(rw_ops, rw_kernel, card)

    # ------------------------------------------------------------------
    phase(f"14. RWKV6 path: {R_ARCH} at full width on cuda")
    rwkv = rwkv_path_phase(dev, rw_kernel)

    # ------------------------------------------------------------------
    phase(f"15. RWKV6 card against CPU: {R_ARCH} cut to {R_CMP_LAYERS} "
          f"layers, fp32")
    rwkv["card_vs_cpu_max_abs_diff"] = rwkv_card_vs_cpu(dev, rw_kernel)

    # ------------------------------------------------------------------
    phase("16. kernel against plain (rglru_scan)")
    rg_err = rglru_phase(rg_ops)

    # ------------------------------------------------------------------
    phase(f"17. RG-LRU path: {RG_ARCH} at full width on cuda")
    rglru = rglru_path_phase(dev, fa_kernel, rg_kernel, rg_ops)
    rg_err = max(rg_err, rglru["rglru_scan"]["max_abs_err"])

    # ------------------------------------------------------------------
    phase(f"18. RG-LRU card against CPU: {RG_ARCH} cut to {RG_CMP_LAYERS} "
          f"layers, fp32")
    rglru["card_vs_cpu_max_abs_diff"] = rglru_card_vs_cpu(dev, fa_kernel)

    # ------------------------------------------------------------------
    phase("19. scenarios and traces: every plane under a scenario, "
          "BENCH_7's million-client sweep, a disk corpus")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    scenarios = scenario_planes_phase(dev, clients, w0, fm_kernel)
    scenarios["bench7"] = bench7_phase(dev, fm_kernel, cs_kernel)
    scenarios["disk_trace"] = disk_trace_phase(dev)
    scenarios["phase_s"] = time.perf_counter() - t0
    print(f"phase 19 took {scenarios['phase_s']:.1f} s")

    # ------------------------------------------------------------------
    phase("20. kernels")
    bound_ms = timing[("fedmom", n_main)][2]
    large_ms, _, large_bound_ms = timing[("fedmom", 2 ** 26 + 3)]
    cs_ms, cs_plain_ms, cs_bound_ms, cs_v1_ms, cs_ring = cs_timing[cs_top]
    # flash_attention per launch at the serving path's mix: 22 LOCAL
    # (window 512) and 4 ATTN (window 0) layers in every prefill
    from repro_torch.configs import get_config
    g_cfg = get_config(G_ARCH)
    n_local = sum(1 for i in range(g_cfg.n_layers) if g_cfg.layer_pattern[
        i % g_cfg.pattern_period] == "local")
    mix = {g_cfg.window: n_local, 0: g_cfg.n_layers - n_local}

    def per_launch(j):
        return sum(fa_timing[w][j] * c for w, c in mix.items()) / sum(
            mix.values())

    fa_bound_by = ("bytes" if per_launch(5) >= per_launch(6)
                   else "operations")
    print(json.dumps({
        "card": card, "main_path_ms_per_round": ms_round,
        "fedmom_update_tree": fm_tree,
        "torch_streaming_ms_and_bound_ms": {
            name: t for (k, name), t in timing.items() if k == "stream"},
        "streaming_ms_per_round": {k: v["ms_per_round"]
                                   for k, v in lanes.items()},
        "streaming_hit_rate": {k: v["hit_rate"] for k, v in lanes.items()},
        "streaming_misses_per_round": {k: v["misses_per_round"]
                                       for k, v in lanes.items()},
        "streaming_device_busy_share": {k: v["busy_share"]
                                        for k, v in lanes.items()},
        "streaming_launches": {k: v["launches"] for k, v in lanes.items()},
        "graph_planes": graph_planes,
        "scenarios": scenarios,
        "zipf_device_plane": zipf_device,
        "serving": serving,
        "rwkv6_7b": rwkv,
        "recurrentgemma_9b": rglru,
        "rwkv6_scan_bound": dict(zip(("bytes_ms", "ops_ms"),
                                     rw_timing[4:6])),
        "rwkv6_scan_designs_ms": rw_timing[6],
        "flash_attention_by_window": {
            str(w): dict(zip(("ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms", "bytes_ms", "ops_ms"), t))
            for w, t in fa_timing.items() if w != "long"},
        "flash_attention_long": dict(zip(
            ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "bytes_ms", "ops_ms"), fa_timing["long"]))}))
    line = {"kernels": [{
        "name": "fedmom_update",
        "route": "cuda",
        "source": "src/repro_torch/csrc/fedmom_update.cu",
        "replaces": "src/repro/kernels/fedmom_update/kernel.py:61",
        "launches": main_launches["fedmom_update"],
        "scenario_launches": {
            name: v["fedmom_update_launches"]
            for name, v in scenarios["planes"].items()},
        "max_abs_err": max_err,
        "ms": fm_tree["ms"],
        "plain_ms": fm_tree["plain_ms"],
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
        "flat_ms": timing[("fedmom", n_main)][0],
        "packed_ms": fm_tree["packed_ms"],
        "launch_floor_ms": fm_tree["launch_floor_ms"],
        "fedavgm_ms": fm_tree["fedavgm_ms"],
        "fedavgm_library_ms": fm_tree["fedavgm_library_ms"],
        "eager_ms": fm_tree["eager_ms"],
        "packed_eager_ms": fm_tree["packed_eager_ms"],
        "large_ms": large_ms,
        "large_bound_ms": large_bound_ms,
    }, {
        "name": "client_step",
        "route": "cuda",
        "source": "src/repro_torch/csrc/client_step.cu",
        "replaces": "src/repro/kernels/client_step/kernel.py:75",
        "launches": lanes["hook"]["launches"]["client_step"],
        "scenario_launches": scenarios["bench7"][
            "hook_client_step_launches"],
        "max_abs_err": cs_err,
        "ms": cs_ms,
        "plain_ms": cs_plain_ms,
        "bound_ms": cs_bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
        "v1_ms": cs_v1_ms,
        "staging_ring": cs_ring,
        "launch_floor_ms": cs_wide["launch_floor_ms"],
        "wide_ms": cs_wide["ms"],
        "wide_bound_ms": cs_wide["bound_ms"],
        "wide_v1_ms": cs_wide["v1_ms"],
        "wide_ring": cs_wide["ring"],
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:94",
        "launches": serving["launches"],
        "max_abs_err": fa_err,
        "ms": per_launch(0),
        "plain_ms": per_launch(1),
        "bound_ms": per_launch(2),
        "bound_by": fa_bound_by,
        "library_ms": per_launch(4),
    }, {
        "name": "rwkv6_scan",
        "route": "cuda",
        "source": "src/repro_torch/csrc/rwkv6_scan.cu",
        "replaces": "src/repro/kernels/rwkv6_scan/kernel.py:81",
        "launches": rwkv["launches"],
        "max_abs_err": rw_err,
        "ms": rw_timing[0],
        "plain_ms": rw_timing[1],
        "bound_ms": rw_timing[2],
        "bound_by": rw_timing[3],
        "library_ms": None,
    }, {
        "name": "rglru_scan",
        "route": "cuda",
        "source": "src/repro_torch/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan/kernel.py:50",
        "launches": rglru["rglru_scan"]["launches"],
        "max_abs_err": rg_err,
        "ms": rglru["rglru_scan"]["ms"],
        "plain_ms": rglru["rglru_scan"]["plain_ms"],
        "bound_ms": rglru["rglru_scan"]["bound_ms"],
        "bound_by": rglru["rglru_scan"]["bound_by"],
        "library_ms": None,
    }]}
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
