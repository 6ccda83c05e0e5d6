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
``flash_attention``); federated training of language models:
fed-llm-100m at full size, gemma3-1b at full width through ``round_step``
and the paper's Shakespeare LSTM, the server step through
``fedmom_update``; and the rest of the zoo: MoE (granite-moe-1b-a400m at
full width, grok-1-314b cut in depth), the encoder-decoder whisper-medium
and the VLM qwen2-vl-72b (cut in depth), served, scored and trained.
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
     ops a round of one profiled chunk, and ``fedmom_update`` launches
     counted from the profiler's kernel names over that chunk (the
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
     plane's after as many rounds; each lane's prefetch split
     (``stream_split`` on its warm trainer: ``prefetch`` 2 and 0 timed in
     turns, ms/round, the upload's host ms, misses, H2D bytes, device ms
     of the kernels and of the H2D copies, the copies' kinds and streams,
     the share of H2D time under a kernel, the device staging bytes; the
     arms bit-equal), and the same split of the linreg fleet widened until
     the card lags the host (D = 2^19, b = 2048, H = 1: 16 GB a round);
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
     in 30 rounds on the per-round plane (its counter, over a timed run),
     10 in one profiled chunk of 10 on each graphed plane, and what
     staging the masks costs the host a round; (b)
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
     to the JAX package's; BENCH_7's padded lane and BENCH_9's disk
     corpus split as phase 8's lanes are, each run on a new trainer's
     cold cache;
 20. secure aggregation (every LeNet run on the card but (e)'s under
     ``cudnn.deterministic``): (a) BENCH_8's configuration
     (``benchmarks/perf_compare.py`` ``bench_secure`` over
     ``_driver_setup``: LeNet on synthetic FEMNIST K=20, M=8, H=4, b=10,
     FedMom eta=2, beta=0.9 through ``fedmom_update``, 60 rounds, chunks of
     25, frac_bits 20) in three lanes, plain, open ring and masked, on the
     scanned, device and per-round planes: warm ms/round of each (a warm-up
     run, then a timed run synced at the end), masked-over-open and
     ring-over-plain, masked-vs-open drift 0 bits, plain-vs-open final-loss
     drift < 1e-3 (BENCH_8's assertion), ``fedmom_update`` 60 launches in
     60 rounds on the per-round plane, 25 in one profiled chunk of 25 on
     the graphed planes (which gives a lane's device time and ops a
     round), the masked and plain
     lanes bit-equal across the planes; (b) the device plane under
     ``UniformDropout(0.3)``: masked bit-equal to open (dropout recovery
     keyed by the graph's device round index); (c) one trainer run plain,
     masked, open and plain: each bit-equal to a fresh trainer's run; (d)
     BENCH_6's fleet on the hook lane, masked bit-equal to open,
     ``client_step`` launches counted, within atol/rtol 1e-4 of phase 8's
     plain hook lane; (e) 3 masked per-round rounds on the card against the
     CPU (1e-4), and ``secure_weighted_sum`` / ``mask_cohort`` on one
     numpy-made cohort stack (saturating and NaN values in it) bit-equal
     between the card and the CPU; (f) ``secure_weighted_sum``'s device
     time on LeNet's stack at M=8 and M=32, and the quickstart corpus
     (K=60) at M=32 on the device plane, masked and open: ms/round and
     peak memory;
 21. federated language models: (a) fed-llm-100m at full size
     (``examples/federated_llm_torch.py``'s defaults: 84,231,296 fp32
     parameters, 12 stacked layers, 16 clients x 20,000 tokens, M=4, H=2,
     b=4, seq 128, FedMom eta=K/M through ``fedmom_update``) for 30 rounds
     on the per-round plane with the fused server and with the plain one
     (params within atol/rtol 1e-5), then 30 on ``plane="auto"`` (chunks
     of 10 as CUDA graphs; what auto resolves to and why): ms/round,
     device-busy share and device ops of profiled rounds, peak memory,
     ``fedmom_update`` launches (counter, and profiler on the graphed
     plane), the loss falling on both planes; then ``fedmom_update`` on
     one server step of its tree, bit-equal to the plain version, its
     time beside the bound, the plain version's, and FedAvgM's tree call
     in turns with ``torch._fused_sgd_``; (b) its 2-layer cut at full
     width, card against CPU after 3 rounds (atol/rtol 1e-4, the card's
     keyed weights carried to the host); (c) gemma3-1b at full width in
     fp32 (1.30 G keyed random parameters, its config's ``scan_layers``)
     through ``round_step``, M=2, H=2, b=2, seq 256, 3 rounds with remat
     and 3 without: ms/round, peak memory, the loss finite, the server
     moved, ``fedmom_update`` launches (counter, and the profiler over one
     round), then ``fedmom_update`` on its tree as in (a); (d) the paper's
     Shakespeare task (``examples/paper_shakespeare_torch.py``: the
     char-LSTM, 40 clients, M=2, b=10, lr 0.8, eta=K/M): FedSGD (H=1),
     FedAvg and FedMom (H=10) 30 rounds each on ``plane="auto"`` in chunks
     of 3 (a first run with its captures, then a timed run): ms/round,
     final losses, one profiled FedMom chunk's ``fedmom_update`` launches;
     3 FedMom rounds on the card against the CPU (atol/rtol 1e-4);
 22. the data mesh at BENCH_10's configuration (``benchmarks/
     perf_compare.py`` ``bench_mesh``: the BENCH_8 trainer, LeNet, M=8,
     60 rounds, chunks of 25), under ``cudnn.deterministic``: (a)
     ``mesh=None`` against ``MeshSpec(devices=1)`` on NCCL on the graphed
     device plane and the padded and bucketed streaming lanes, a warm-up
     run then runs in turns (none, mesh, mesh, none; 60 rounds on the
     device plane, one chunk of 25 on a streaming lane): ms/round beside
     each other, the mesh run's drift against none's (0 bits: a sum over
     one rank), one profiled chunk of the device plane and 5 profiled
     rounds of each streaming lane (device time a round, busy share, NCCL
     ops, ``fedmom_update`` launches from the profiler), the counter's
     launches on the streaming lanes, each streaming lane's prefetch
     split without and with the mesh (as phase 8's, 16 rounds in chunks
     of 8 on the cache the chunks of 25 warmed), and the round's two
     collectives captured alone (graph replays); (b) 2 and 4 gloo ranks sharing the
     card (``launch.mesh.spawn``, both meshes at once), 12 rounds of each
     lane (per-round, padded, bucketed, device with its chunks eager,
     masked and open-ring per-round) on BENCH_10's LeNet and on the
     reference's mesh-test linreg fleet (``tests/test_mesh_shard.py``: 8
     clients, M=4) against one device: linreg within 1e-6 and masked
     bit-equal, LeNet's final loss within ``bench_mesh``'s 1e-4 (a 1e-8
     change of LeNet's state flips a ReLU / max-pool choice from round
     3), masked bit-equal to the open ring, the ranks' parameters equal,
     each rank's corpus bytes equal to ``per_device_nbytes``; (c) NCCL at
     2 and 4 ranks on the device plane where as many cards are visible
     (the linreg fleet within 1e-6 of one card, BENCH_10's LeNet timed
     after a warm-up run and within 1e-4 in final loss), else why not;
 23. the rest of the zoo (keyed random weights at the published widths,
     bf16, ``attention_impl="pallas"``): (a) granite-moe-1b-a400m, nothing
     cut (24 layers, 32 experts top-8): ``generate`` of B=8 prompts of
     1024 tokens, 32 new (2 MoE groups of 4,096 tokens a prefill layer;
     24 ``flash_attention`` launches over exactly one call), prefill ms,
     decode ms/token, tokens/s, peak memory, the busy share of a profiled
     call; ``loss_fn`` at B=8 x 1024 in ms with its top kernels; one MoE
     group's stages at the training group (2 x 1024 fp32 tokens): the
     ``moe_route`` kernels bit-equal to their plain version and timed
     beside their bytes bounds and the plain version, the routing, the
     tables, the experts, the group, and the dense one-hot dispatch and
     combine as the yardstick; 3 FedMom rounds of ``round_step`` in fp32
     at full size (M=2, H=2, b=2, seq 256, remat with the aux as an
     output of the remat node): the loss finite, the server (router
     included) moved, ``fedmom_update`` launches one a table a round,
     ``moe_route`` launches 7 a layer and local step, both clients in
     each launch (the kernels line's ``moe_route`` entry); reduced
     granite through
     ``FederatedTrainer`` on ``plane="auto"`` (-> device, chunks
     captured) against the per-round plane, the drift printed; (b)
     whisper-medium, nothing cut: ``generate`` over stubbed frames [8,
     1536, 1024], prompt 1024, 32 new, 48 launches (24 non-causal encoder,
     24 causal decoder prefill), and the kernel at the encoder's shape
     (B=8, S=1536, 16/16 heads, d=64, non-causal) against its plain
     version, timed beside its bound and SDPA; (c) qwen2-vl-72b at full
     width cut to 8 of 80 layers: ``generate`` of B=8 x 1024 with 256
     stubbed patches and their t/h/w M-RoPE grid, 8 launches; (d)
     grok-1-314b at full width cut to 2 of 64 layers: a prefill of B=8 x
     1024 (2 MoE groups), 8 decode tokens, 2 launches, and the kernel at
     its 48/8 head layout (6 query heads a KV head, d=128, causal) against
     its plain version, timed; (e) card against CPU in fp32 (granite cut
     to 2 layers, whisper to 2 + 2, qwen2-vl to 1, at full width): the
     forward's logits within atol/rtol 1e-3 on the rows whose MoE routes
     agree everywhere (the flipped (token, slot) routes counted and
     reported, with the smallest top-k margin among them), then greedy
     ``generate`` and prefill + 3 decode logits along the CPU's tokens,
     greedy tokens equal past near-ties;
 24. the dry run on the meta device (``repro_torch.launch.dryrun``, no
     kernel of its own): (a) gemma3-1b at full width, a ``prefill`` of
     B=8 x 1024 in bf16 with ``attention_impl="xla"`` on the card under
     ``FlopCounterMode``, its count equal to the same step's count on
     the meta device (``launch/cost.py``), its CUDA-event time and
     counted flops / (time x ``hw.PEAK_FLOPS_BF16``) beside the card's
     name and power limit; (b) ``dry_run`` of grok-1-314b and
     qwen2-vl-72b at ``train_4k`` at full depth and of gemma3-1b at
     ``decode_32k``, each a CPU process started with the script (meta
     tensors, no card): ``peak_bytes_per_rank`` and ``fits_one_card``;
 25. the reference scripts: ``scripts/dev_smoke_torch.py`` over the ten
     reduced architectures on the card (forward, loss, gradient norm,
     prefill and decode; an ``OK <arch>`` line each), and
     ``scripts/profile_combo_torch.py`` on gemma3-1b ``decode_32k``, a CPU
     process with no card visible started with the dry runs, its flops
     equal to phase 24's record;
 26. one JSON line of kernels, then the result line.

Each phase's wall seconds print on a line of their own when it ends.
``python3 chip_smoke.py --only-lm`` runs phases 1, 2 and 21 alone,
``--only-mesh`` phases 1, 2 and 22, ``--only-mesh-nccl`` phases 1, 2
and 22(c), for a machine with several cards, ``--only-zoo`` phases 1, 2
and 23, ``--only-dryrun`` phases 1, 2 and 24, and ``--only-stream``
phases 1, 2 and the prefetch splits of phases 8, 19 and 22, with where
each run waits for the card (``torch.cuda.set_sync_debug_mode``),
written to ``chiprun_out/stream_split.json`` (development runs; they
print no result line).

Without a card, or outside a checkout of the repo, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import atexit
import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
try:
    # the H100 SXM5's data-sheet constants (src/repro_torch/launch/hw.py)
    from repro_torch.launch import hw
except ImportError as e:
    sys.exit(f"chip_smoke: run it from the root of a checkout of the repo "
             f"({e})")
HBM_BYTES_PER_S = hw.HBM_BW

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
Z_SPLIT_ROUNDS = 3 * Z_CR          # a lane's prefetch 2-against-0 runs
# the linreg fleet widened until the card lags the host (phase 8's last
# split; tests/test_torch_gpu.py's overlap test): 2 MB rows, 16 GB a round
W_D, W_ROWS, W_K, W_C, W_B, W_LR = 1 << 19, 2, 16, 4, 2048, 1e-9
W_CR, W_CAP = 3, 12
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
B7_SPLIT_ROUNDS = 2 * B7_CR        # the prefetch 2-against-0 runs
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
# the secure-aggregation path (phase 20): BENCH_8.json's configuration
# (benchmarks/perf_compare.py bench_secure over _driver_setup, LeNet):
# the plain, open-ring and masked lanes at equal trajectory
S_K, S_M, S_H, S_B, S_LR = 20, 8, 4, 10, 0.05
S_ETA, S_BETA = 2.0, 0.9           # FedMom, through fedmom_update
S_ROUNDS, S_CR, S_FRAC = 60, 25, 20   # rounds, chunk_rounds, frac_bits
S_WARM_PER_ROUND = 5               # warm-up rounds of the per-round plane
S_QUANT_DRIFT = 1e-3               # plain vs open final loss (bench_secure)
S_DROPOUT, S_DROP_ROUNDS = 0.3, 25
S_CMP_ROUNDS = 3                   # masked card-against-CPU rounds
# the data mesh (phase 22): BENCH_10.json's configuration
# (benchmarks/perf_compare.py bench_mesh over _driver_setup: the BENCH_8
# trainer above, LeNet, M=8, H=4, b=10, FedMom eta=2 through
# fedmom_update, 60 rounds in chunks of 25 on the device plane)
MS_ROUNDS, MS_CR = 60, 25
MS_PROFILE_ROUNDS = 5              # an eager streaming lane's profiled run
MS_SPLIT_CR, MS_SPLIT_ROUNDS = 8, 16    # its prefetch split (two chunks)
MS_SIZES = (2, 4)                  # spawned ranks: gloo sharing the card,
                                   # NCCL where there are as many cards
MS_RANK_ROUNDS, MS_RANK_CR = 12, 4   # the spawned meshes' runs: the length
                                     # of tests/test_mesh_shard.py's
MESH_ATOL = 1e-6                   # sharded vs single device: the
                                   # reference's tests/test_mesh_shard.py,
                                   # on its linreg fleet (8 clients, M=4)
MS_LENET_LOSS_TOL = 1e-4           # LeNet's final-loss drift: bench_mesh's
                                   # own bound.  From round 3 a 1e-8 change
                                   # of LeNet's state flips a ReLU / max-pool
                                   # choice and moves 23 parameters by
                                   # 1.7e-5, so its parameters hold no 1e-6
                                   # tolerance under any change of order
MS_LINREG_M = 4
S_BIG_M, S_BIG_ROUNDS = 32, 20     # the sizing point: K=60 at M=32
# the federated LM path (phase 21): examples/federated_llm_torch.py's
# defaults at full size (fed-llm-100m), gemma3-1b at full width through
# round_step, and examples/paper_shakespeare_torch.py's configuration
L_ROUNDS, L_CR = 30, 10            # rounds a lane; auto's chunk_rounds
L_FUSED_TOL = 1e-5                 # fused vs unfused server params after
                                   # L_ROUNDS: the embedding's backward
                                   # scatters with atomics
L_CMP_LAYERS, L_CMP_ROUNDS = 2, 3  # card-vs-CPU cut of fed-llm-100m
L_CMP_TOL = 1e-4                   # card vs CPU params (fp32, TF32 off)
GT_M, GT_H, GT_B, GT_S = 2, 2, 2, 256   # gemma3-1b: clients, steps, b, seq
GT_ROUNDS, GT_LR = 3, 0.05
SH_K, SH_ROUNDS, SH_CR = 40, 30, 3      # Shakespeare clients, rounds, chunk
SH_CMP_ROUNDS, SH_CMP_TOL = 3, 1e-4     # its card-vs-CPU FedMom rounds
# the rest of the zoo (phase 23) at its published widths
# (configs/granite_moe_1b_a400m.py, whisper_medium.py, qwen2_vl_72b.py,
# grok_1_314b.py), keyed random weights, bf16 and attention_impl="pallas"
ZOO_MOE, ZOO_ENCDEC = "granite-moe-1b-a400m", "whisper-medium"
ZOO_VLM, ZOO_GROK = "qwen2-vl-72b", "grok-1-314b"
ZOO_B, ZOO_S0, ZOO_NEW = 8, 1024, 32      # prompts, prompt length, new
ZOO_VLM_LAYERS = 8                        # of 80: 21.6 GB of weights
ZOO_GROK_LAYERS, ZOO_GROK_NEW = 2, 8      # of 64: 24.5 GB; decode tokens
ZOO_ROUNDS, ZOO_M, ZOO_H = 3, 2, 2        # granite fp32 round_step
ZOO_RB, ZOO_RS = 2, 256                   # its local batch and seq
ZOO_TR_ROUNDS, ZOO_CR = 4, 2              # reduced granite, auto vs
                                          # per-round
ZOO_CMP_TOL = 1e-3                        # card vs CPU logits, fp32
ZOO_CMP_S0, ZOO_CMP_VLM_S0, ZOO_CMP_NEW = 256, 128, 4
BF16_FLOPS = hw.PEAK_FLOPS_BF16    # dense bf16 tensor-core peak
FP32_FLOPS = hw.PEAK_FLOPS_FP32    # fp32 (CUDA cores) peak
# the dry run (phase 24): gemma3-1b's prefill counted on the card and on
# the meta device; the full-depth dry runs of the two models no card
# holds, and a decode, each a CPU process started with the script
DRY_ARCH, DRY_B, DRY_S = "gemma3-1b", 8, 1024
DRY_RUNS = (("grok-1-314b", "train_4k"), ("qwen2-vl-72b", "train_4k"),
            ("gemma3-1b", "decode_32k"))
DRY_TIMEOUT_S = 900.0              # from the script's start
# phase 25: scripts/profile_combo_torch.py on one of DRY_RUNS
PC_COMBO = ("gemma3-1b", "decode_32k")


_PHASE = {"name": None, "t0": 0.0, "seconds": {}}


def phase(name):
    """Start phase ``name``, first printing the wall seconds of the one
    before it on a line of its own (``name=None`` closes the last)."""
    now = time.perf_counter()
    if _PHASE["name"] is not None:
        secs = now - _PHASE["t0"]
        _PHASE["seconds"][_PHASE["name"].split(".")[0]] = round(secs, 2)
        print(f"phase {_PHASE['name'].split('.')[0]} took {secs:.1f} s",
              flush=True)
    _PHASE.update(name=name, t0=now)
    if name is not None:
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


def device_events(fn):
    """Run ``fn`` under the profiler; returns (wall s, every device event
    as (start ns, end ns, stream, name)).  The window opens 0.1 s before
    ``fn`` and closes 0.1 s after its work ends: the profiler drops device
    events whose converted timestamps fall outside it, and a window that
    opens just as the first kernels run lost some of them on the card.
    Only the card's activity is traced, and its raw events are read:
    tracing the host's operators too slowed the profiled call, and
    building ``FunctionEvent``s of a ``generate``'s ~90,000 kernels and
    their host operators took several times as long as the call."""
    import torch
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
    return wall, [(evt.start_ns(), evt.end_ns(), evt.device_resource_id(),
                   evt.name())
                  for evt in prof.profiler.kineto_results.events()
                  if evt.device_type() == DeviceType.CUDA]


def profile_rows(fn):
    """Run ``fn`` under the profiler (``device_events``); returns (wall s,
    every device kernel as (name, s, count), most time first)."""
    wall, events = device_events(fn)
    by_name = {}
    for start, end, _, name in events:
        s, c = by_name.get(name, (0.0, 0))
        by_name[name] = (s + (end - start) / 1e9, c + 1)
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
                       "final_loss": losses[-1],
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
    for name, split in zipf_splits(dev, lanes).items():
        lanes[name]["split"] = split
    lanes["padded"]["wide_split"] = wide_split(dev)
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
        fm = kernel_launches(rows, FM_KERNEL_NAME)
        if fm != G_CR:
            raise AssertionError(
                f"{name}: the profiler counts {fm} fedmom_update launches "
                f"in {G_CR} rounds, want one a round")
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
              f"fedmom_update launches (profiler) {fm} in {G_CR} rounds")
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
    """``scaled_dot_product_attention`` over the same mask (the library
    yardstick; the port never calls it): no mask, or ``is_causal``, where
    there is no window, so that the library may take its flash backend;
    an explicit boolean mask for a window."""
    import torch
    import torch.nn.functional as F
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if window <= 0:
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True)
    S = q.shape[1]
    i = torch.arange(S, device=q.device)
    keep = i[None, :] > i[:, None] - window
    if causal:
        keep &= i[None, :] <= i[:, None]

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


def teacher_forced_logits(params, cfg, seq, s0, n_new, device, extras=None,
                          routes=None):
    """Prefill of ``seq[:, :s0]`` (with a family's ``extras``: frames,
    patches, M-RoPE positions) and decode along ``seq``: the logits of
    each of the ``n_new`` positions, [n_new, V] on the host.  Given a list
    as ``routes``, each step's MoE routings (``RouteRecorder.routes``) are
    appended to it."""
    import contextlib
    import torch
    from repro_torch.models import transformer as T
    cache, _ = T.init_cache(cfg, 1, s0 + n_new, device=device)
    t = torch.as_tensor(seq, device=device)
    batch = {"tokens": t[:, :s0]}
    batch.update({k: torch.as_tensor(v, device=device)
                  for k, v in (extras or {}).items()})

    def step(fn):
        with (RouteRecorder() if routes is not None
              else contextlib.nullcontext()) as rec, torch.no_grad():
            out = fn()
        if routes is not None:
            routes.append(rec.routes)
        return out
    steps = [step(lambda: T.prefill(params, cfg, batch, cache)[0])]
    for i in range(s0, s0 + n_new - 1):
        steps.append(step(lambda: T.decode_step(params, cfg, cache,
                                                t[:, i:i + 1], i)[0]))
    return torch.stack(steps)[:, 0].cpu()


def held_greedy_tokens(gen, logits_cpu, s0, n_new, tol):
    """The greedy tokens of the CPU and the card must be equal wherever the
    CPU's top-2 logit margin exceeds ``tol``, up to the first near-tie that
    went either way, over the first ``n_new`` new tokens.  Returns (cpu
    tokens, card tokens, count held)."""
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
                trainer().run(S_WARM_PER_ROUND if name == "per_round"
                              else ROUNDS, plan=plan(name, scen),
                              verbose=False)
            torch.cuda.synchronize()
            times = {"off": [], "on": []}
            fm_kernel.launches = 0
            for label in ("off", "on", "on", "off"):
                tr = trainer()
                if label == "on":
                    fm_on = fm_kernel.launches
                t0 = time.perf_counter()
                got = run_record(tr, ROUNDS, plan(
                    name, spec if label == "on" else None))
                torch.cuda.synchronize()
                times[label].append((time.perf_counter() - t0) / ROUNDS
                                    * 1e3)
                if label == "on":
                    fm_on = fm_kernel.launches - fm_on
                runs[(name, label)] = got
            rec = tr.session.plan_log[-2]           # the last "on" run's
            if rec["plane"] != ("device" if name == "auto" else name) \
                    or not rec.get("scenario"):
                raise AssertionError(f"{name}: plan record {rec}")
            if name == "per_round":
                # the counter over the last timed run under the scenario
                fm, how, n_fm = fm_on, "its counter", ROUNDS
            else:
                tr = trainer()
                _, rows = profile_rows(lambda: tr.run(
                    G_CR, plan=plan(name, spec), verbose=False))
                fm, how = kernel_launches(rows, FM_KERNEL_NAME), "profiler"
                n_fm = G_CR
            if fm != n_fm:
                raise AssertionError(
                    f"{name} under the scenario: {fm} fedmom_update "
                    f"launches in {n_fm} rounds ({how}), want one a "
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
                  f"launches ({how}) {fm} in {n_fm} rounds")
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
    split = bench7_split(dev, "BENCH_7 padded (fedmom, dropout "
                         f"{B7_HOOK_RATE})", provider, B7_K, B7_HOOK_RATE)
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
            "split": split,
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
        split = bench7_split(dev, f"BENCH_9 disk corpus (fedmom, dropout "
                             f"{B9_RATE})", provider, B9_K, B9_RATE)
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
            "final_loss": statistics.fmean(rep[0][-10:]), "split": split}

def secure_trainer(clients, dev, m=S_M, session=None):
    """``_driver_setup``'s trainer of benchmarks/perf_compare.py at
    BENCH_8's configuration: LeNet, dataset seed 1, the keyed
    ``DeviceUniformSampler`` (seed 2), FedMom through ``fedmom_update``."""
    from repro_torch import random as prng
    from repro_torch.core import DeviceUniformSampler, RoundConfig, fedmom
    from repro_torch.data import FederatedDataset
    from repro_torch.launch.train import FederatedTrainer
    from repro_torch.models import small
    ds = FederatedDataset(clients, seed=1)
    opt = fedmom(eta=S_ETA, beta=S_BETA, use_fused_kernel=True)
    return FederatedTrainer(
        loss_fn=small.lenet_loss, server_opt=opt,
        rcfg=RoundConfig(clients_per_round=m, local_steps=S_H, lr=S_LR,
                         placement="mesh", compute_dtype="float32"),
        dataset=ds, sampler=DeviceUniformSampler(ds.population(), m, seed=2),
        state=opt.init(small.lenet_init(prng.PRNGKey(0), device=dev)),
        local_batch=S_B, device=dev, session=session)


def secure_plan(plane, spec, chunk_rounds=S_CR, scenario=None):
    from repro_torch.launch.plan import ExecutionPlan
    if plane == "per_round":
        return ExecutionPlan(plane="per_round", secure=spec,
                             scenario=scenario)
    return ExecutionPlan(plane=plane, chunk_rounds=chunk_rounds,
                         secure=spec, scenario=scenario)


def drift_bits(a, b):
    """Parameters of two states that differ in any bit."""
    import torch
    from repro_torch.tree import leaves
    return sum(int((x.cpu().view(torch.int32)
                    != y.cpu().view(torch.int32)).sum())
               for x, y in zip(leaves(a.w), leaves(b.w)))


def ring_card_vs_cpu(dev, specs):
    """The same fp32 cohort stack (numpy, LeNet's tree at M=S_M, with
    +-3e9, +-inf and NaN in one leaf) through ``secure_weighted_sum`` on
    the card and on the CPU, masked and open, with and without a dropout,
    the round index a host int and a card tensor: bit-equal."""
    import numpy as np
    import torch
    from repro_torch import random as prng
    from repro_torch.core.secure_agg import mask_cohort, secure_weighted_sum
    from repro_torch.models import small
    from repro_torch.tree import leaves, tree_map
    rng = np.random.default_rng(0)
    y = tree_map(lambda x: (1e-3 * rng.normal(size=(S_M,) + tuple(
        x.shape))).astype(np.float32), small.lenet_init(prng.PRNGKey(0)))
    first = max(leaves(y), key=lambda a: a.size).reshape(S_M, -1)
    first[0, :5] = [3e9, -3e9, np.inf, -np.inf, np.nan]
    first[3, 7] = np.nan
    first[5, 1] = 5000.0                     # wraps the aggregate's ring
    checked = 0
    for name, spec in specs.items():
        if spec is None:
            continue
        for surv in (None, np.array([1, 1, 0, 1, 1, 0, 1, 1], bool)):
            for t in (7, "card"):
                out = []
                for d in (torch.device("cpu"), dev):
                    yt = tree_map(lambda a, d=d: torch.from_numpy(a).to(d),
                                  y)
                    tt = (torch.tensor(7, device=d) if t == "card" else t)
                    st = None if surv is None else torch.from_numpy(
                        surv).to(d)
                    agg = secure_weighted_sum(yt, st, spec, tt)
                    words = mask_cohort(prng.fold_in(prng.PRNGKey(3, d), 7),
                                        yt, spec)
                    out.append([x.cpu() for x in leaves(agg)]
                               + [x.cpu() for x in leaves(words)])
                for a, b in zip(*out):
                    if not torch.equal(a.view(torch.int32)
                                       if a.dtype == torch.float32 else a,
                                       b.view(torch.int32)
                                       if b.dtype == torch.float32 else b):
                        raise AssertionError(
                            f"{name}, survivors {surv}, t {t}: the card's "
                            f"ring transport differs from the CPU's")
                checked += 1
    print(f"secure_weighted_sum and mask_cohort on LeNet's tree at M={S_M} "
          f"(saturating +-3e9, +-inf, NaN and a wrapping sum included): "
          f"card bit-equal to the CPU in {checked} cases (masked and open, "
          f"with and without a dropout, t a host int and a card tensor)")
    return checked


def secure_phase(dev, clients, z_clients, hook_lane, fm_kernel, cs_kernel):
    """Phase 20: BENCH_8's configuration on the scanned, device and
    per-round planes in three lanes (plain, open ring, masked), the device
    plane under dropout, one trainer across specs, BENCH_6's fleet on the
    hook lane, card against CPU, and the grid at M=32."""
    import torch
    from repro_torch import random as prng
    from repro_torch.core import SecureAggSpec
    from repro_torch.core.secure_agg import secure_weighted_sum
    from repro_torch.models import small
    from repro_torch.data import synthetic_femnist
    from repro_torch.scenario import ScenarioSpec, UniformDropout
    from repro_torch.tree import leaves, tree_map
    specs = {"plain": None,
             "open": SecureAggSpec(masked=False, seed=0, frac_bits=S_FRAC),
             "masked": SecureAggSpec(masked=True, seed=0, frac_bits=S_FRAC)}
    b8_clients, _ = synthetic_femnist(n_clients=S_K, seed=0)
    print(f"BENCH_8: LeNet on synthetic FEMNIST K={S_K}, M={S_M} H={S_H} "
          f"b={S_B} lr={S_LR} FedMom eta={S_ETA} beta={S_BETA} through "
          f"fedmom_update, DeviceUniformSampler; {S_ROUNDS} rounds, chunks "
          f"of {S_CR}, frac_bits {S_FRAC}; cudnn.deterministic; each lane a "
          f"warm-up run (the per-round plane {S_WARM_PER_ROUND} rounds), "
          f"then a timed run synced at the end")
    out = {"planes": {}, "part_s": {}}
    runs = {}
    t_part = time.perf_counter()

    def part(name):
        nonlocal t_part
        now = time.perf_counter()
        out["part_s"][name] = now - t_part
        print(f"  ({name}: {now - t_part:.1f} s)")
        t_part = now

    torch.backends.cudnn.deterministic = True
    try:
        for plane in ("scanned", "device", "per_round"):
            res = {}
            for lane, spec in specs.items():
                tr = secure_trainer(b8_clients, dev)
                init, plan = tr.state, secure_plan(plane, spec)
                tr.run(S_WARM_PER_ROUND if plane == "per_round"
                       else S_ROUNDS, plan=plan, verbose=False)
                torch.cuda.synchronize()
                tr.state, tr.history = init, []
                fm_kernel.launches = 0
                t0 = time.perf_counter()
                hist = [r for r in tr.run(S_ROUNDS, plan=plan, verbose=False)
                        if "event" not in r]
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) / S_ROUNDS * 1e3
                final = tr.state          # before a shorter profiled run
                losses = [r["loss"] for r in hist]
                if len(losses) != S_ROUNDS or not all(
                        math.isfinite(x) for x in losses):
                    raise AssertionError(f"{plane} {lane}: losses {losses}")
                rec = tr.session.plan_log[-1]
                if bool(rec.get("secure")) != (spec is not None):
                    raise AssertionError(f"{plane} {lane}: record {rec}")
                row = {"ms_per_round": ms, "final_loss": losses[-1]}
                if plane == "per_round":
                    fm = fm_kernel.launches
                else:
                    tr.state, tr.history = init, []
                    wall, rows = profile_rows(lambda: tr.run(
                        S_CR, plan=plan, verbose=False))
                    fm = kernel_launches(rows, FM_KERNEL_NAME)
                    busy = sum(r[1] for r in rows)
                    row.update(device_ms_per_round=busy / S_CR * 1e3,
                               ops_per_round=sum(r[2] for r in rows)
                               / S_CR, busy_share=busy / wall,
                               top=[(k[:80], round(sec * 1e3, 3), c)
                                    for k, sec, c in rows[:6]])
                n_fm = S_ROUNDS if plane == "per_round" else S_CR
                if fm != n_fm:
                    raise AssertionError(
                        f"{plane} {lane}: {fm} fedmom_update launches in "
                        f"{n_fm} rounds, want one a round")
                row["fedmom_update_launches"] = fm
                runs[(plane, lane)] = (losses, final)
                res[lane] = row
                extra = ("" if plane == "per_round" else
                         f"; profiled: {row['device_ms_per_round']:.3f} ms "
                         f"of device time and {row['ops_per_round']:.0f} "
                         f"device ops a round, busy "
                         f"{100 * row['busy_share']:.1f}%")
                print(f"{plane:9s} {lane:6s} {ms:8.3f} ms/round (host "
                      f"clock); final loss {losses[-1]:.6f}; fedmom_update "
                      f"{fm} in {n_fm} rounds{extra}")
                del tr
            bits = drift_bits(runs[(plane, "masked")][1],
                              runs[(plane, "open")][1])
            if bits or runs[(plane, "masked")][0] != runs[(plane, "open")][0]:
                raise AssertionError(
                    f"{plane}: masked differs from open in {bits} params "
                    f"(or in its losses)")
            quant = abs(res["plain"]["final_loss"] - res["open"]["final_loss"])
            if not quant < S_QUANT_DRIFT:
                raise AssertionError(f"{plane}: plain vs open final loss "
                                     f"drift {quant}")
            res["masked_over_open"] = (res["masked"]["ms_per_round"]
                                       / res["open"]["ms_per_round"])
            res["open_over_plain"] = (res["open"]["ms_per_round"]
                                      / res["plain"]["ms_per_round"])
            res["masked_open_drift_bits"] = bits
            res["quantization_drift"] = quant
            if plane != "per_round":
                res["grid_device_ms_per_round"] = (
                    res["masked"]["device_ms_per_round"]
                    - res["open"]["device_ms_per_round"])
                res["ring_device_ms_per_round"] = (
                    res["open"]["device_ms_per_round"]
                    - res["plain"]["device_ms_per_round"])
                print(f"{plane:9s} masked top kernels: "
                      f"{res['masked']['top']}")
            out["planes"][plane] = res
            print(f"{plane:9s} masked/open {res['masked_over_open']:.3f}x, "
                  f"ring/plain {res['open_over_plain']:.3f}x; masked vs open "
                  f"drift {bits} bits; plain vs open final-loss drift "
                  f"{quant:.3e} (< {S_QUANT_DRIFT})"
                  + ("" if plane == "per_round" else
                     f"; device time a round: grid "
                     f"{res['grid_device_ms_per_round']:.3f} ms, ring "
                     f"{res['ring_device_ms_per_round']:.3f} ms"))
        for lane in ("masked", "plain"):
            ref = runs[("per_round", lane)]
            for plane in ("scanned", "device"):
                got = runs[(plane, lane)]
                if got[0] != ref[0] or drift_bits(got[1], ref[1]):
                    raise AssertionError(
                        f"{lane}: {plane} differs from the per-round plane")
        print("masked and plain: scanned and device planes bit-equal to the "
              "per-round plane (losses and parameters)")
        part("BENCH_8 lanes")

        # dropout recovery inside a graph: with a scenario, survivors'
        # pairwise terms with the dropped are recomputed from the round key
        # folded from the graph's device round index
        scen = ScenarioSpec(dropout=UniformDropout(rate=S_DROPOUT), seed=0)
        drop = {}
        for lane in ("open", "masked"):
            tr = secure_trainer(b8_clients, dev)
            hist = [r for r in tr.run(S_DROP_ROUNDS, plan=secure_plan(
                "device", specs[lane], scenario=scen), verbose=False)
                if "event" not in r]
            drop[lane] = ([r["loss"] for r in hist],
                          [r["completed"] for r in hist], tr.state)
        bits = drift_bits(drop["masked"][2], drop["open"][2])
        if bits or drop["masked"][:2] != drop["open"][:2] \
                or min(drop["masked"][1]) == S_M:
            raise AssertionError(
                f"device plane under UniformDropout({S_DROPOUT}): masked "
                f"differs from open in {bits} params, or nobody dropped "
                f"(completed {drop['masked'][1]})")
        out["dropout_completed_mean"] = statistics.fmean(drop["masked"][1])
        print(f"device plane under UniformDropout({S_DROPOUT}), "
              f"{S_DROP_ROUNDS} rounds: completed mean "
              f"{out['dropout_completed_mean']:.3f} of {S_M}; masked "
              f"bit-equal to open (dropout recovery inside the graph)")
        part("dropout")

        # one trainer across specs on the device plane: each run equals the
        # fresh trainer's run of its lane above (the chunk graphs are keyed
        # on the spec; none is replayed for another)
        tr = secure_trainer(b8_clients, dev)
        init = tr.state
        for lane in ("plain", "masked", "open", "plain"):
            tr.state, tr.history = init, []
            hist = [r for r in tr.run(S_ROUNDS, plan=secure_plan(
                "device", specs[lane]), verbose=False) if "event" not in r]
            want = runs[("device", lane)]
            if [r["loss"] for r in hist] != want[0] \
                    or drift_bits(tr.state, want[1]):
                raise AssertionError(
                    f"one trainer, {lane} after other specs: differs from a "
                    f"fresh trainer's run")
            if tr.rcfg.secure is not None:
                raise AssertionError("the spec outlived its run")
        keyed = sorted({str(k[-2].secure) for k in tr.session.graphs})
        out["graphs_one_trainer"] = len(tr.session.graphs)
        print(f"one trainer run plain, masked, open, plain on the device "
              f"plane: each bit-equal to a fresh trainer's; "
              f"{len(tr.session.graphs)} chunk graphs keyed on {keyed}")
        del tr
        part("one trainer")
    finally:
        torch.backends.cudnn.deterministic = False

    # BENCH_6's Zipf fleet on the hook lane (client_step), masked and open
    tr_cs = {}
    for lane in ("open", "masked"):
        tr = zipf_trainer(z_clients, dev, hook=True)
        init = tr.state
        plan = dataclasses.replace(hook_lane["plan"], secure=specs[lane])
        tr.run(Z_CR, plan=plan, verbose=False)                  # warm-up
        torch.cuda.synchronize()
        tr.state, tr.history = init, []
        fm_kernel.launches = cs_kernel.launches = 0
        t0 = time.perf_counter()
        hist = tr.run(Z_ROUNDS, plan=plan, verbose=False)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / Z_ROUNDS * 1e3
        want_cs = tier_launches(tr.sampler, tr.stream_cache.layout.tier_of,
                                Z_ROUNDS, Z_CR)
        launched = {"fedmom_update": fm_kernel.launches,
                    "client_step": cs_kernel.launches}
        if launched != {"fedmom_update": Z_ROUNDS, "client_step": want_cs}:
            raise AssertionError(
                f"hook lane {lane}: launches {launched}, want fedmom_update "
                f"{Z_ROUNDS} and client_step {want_cs}")
        tr_cs[lane] = (tr.state, ms, launched, hist[-1]["loss"])
        print(f"hook lane (BENCH_6's fleet) {lane:6s} {ms:.3f} ms/round "
              f"(plain {hook_lane['ms_per_round']:.3f} in phase 8); "
              f"launches {launched}")
    bits = drift_bits(tr_cs["masked"][0], tr_cs["open"][0])
    if bits:
        raise AssertionError(f"hook lane: masked differs from open in "
                             f"{bits} params")
    # the fixed-point grid against plain fp32: at this configuration the
    # loss rises and momentum amplifies the 2^-21 rounding of every round;
    # the same drift on the CPU, where the plain version runs, says how
    # much of it is the ring's (BENCH_8 holds the final loss to 1e-3)
    cpu = torch.device("cpu")
    cpu_w, cpu_loss = {}, {}
    for lane in ("plain", "open"):
        tr = zipf_trainer(z_clients, cpu, hook=True)
        hist = tr.run(Z_ROUNDS, plan=dataclasses.replace(
            hook_lane["plan"], secure=specs[lane]), verbose=False)
        cpu_w[lane], cpu_loss[lane] = leaves(tr.state.w), hist[-1]["loss"]
    drift = {
        "card": max(float((a.cpu() - b.cpu()).abs().max()) for a, b in zip(
            leaves(tr_cs["masked"][0].w), hook_lane["final_w"])),
        "cpu": max(float((a - b).abs().max())
                   for a, b in zip(cpu_w["open"], cpu_w["plain"]))}
    loss_drift = abs(tr_cs["masked"][3] - hook_lane["final_loss"])
    if not loss_drift < S_QUANT_DRIFT:
        raise AssertionError(f"hook lane: masked vs plain final loss drift "
                             f"{loss_drift}")
    # the card's masked lane against the CPU's, over phase 9's rounds
    got = []
    for d in (cpu, dev):
        tr = zipf_trainer(z_clients, d, hook=True)
        tr.run(Z_CMP_ROUNDS, plan=dataclasses.replace(
            hook_lane["plan"], secure=specs["masked"]), verbose=False)
        got.append(leaves(tr.state.w))
    cmp = max(float((a - b.cpu()).abs().max()) for a, b in zip(*got))
    if not all(torch.allclose(a, b.cpu(), atol=LANE_ATOL, rtol=LANE_RTOL)
               for a, b in zip(*got)):
        raise AssertionError(f"hook lane masked: card vs CPU {cmp:.3e}")
    out["hook"] = {lane: {"ms_per_round": v[1], "launches": v[2]}
                   for lane, v in tr_cs.items()}
    out["hook"].update(masked_vs_plain_max_abs=drift["card"],
                       cpu_open_vs_plain_max_abs=drift["cpu"],
                       masked_vs_plain_final_loss=loss_drift,
                       card_vs_cpu_max_abs=cmp)
    print(f"hook lane: masked bit-equal to open over {Z_ROUNDS} rounds; "
          f"masked vs plain: params max abs {drift['card']:.3e} (the CPU's "
          f"open vs plain {drift['cpu']:.3e}, final loss "
          f"{cpu_loss['plain']:.6f} vs {cpu_loss['open']:.6f}), final loss "
          f"drift {loss_drift:.3e} "
          f"(< {S_QUANT_DRIFT}); masked card vs CPU after {Z_CMP_ROUNDS} "
          f"rounds {cmp:.3e} (atol/rtol {LANE_ATOL})")
    part("hook lane")

    # card against CPU: per-round rounds, plain and masked.  The ring
    # rounds every weighted delta to 2^-20 (~1e-3 of a LeNet delta here),
    # so an ulp's difference upstream flips whole quanta: the masked run is
    # held to the CPU's own spread under a one-ulp nudge of the initial
    # weights, measured here, and the plain run to CMP_ATOL
    w_init = small.lenet_init(prng.PRNGKey(0))
    nudged = tree_map(lambda x: torch.nextafter(
        x, torch.full_like(x, math.inf)), w_init)
    cmp = {}
    for lane, d, w in (("plain", cpu, w_init), ("plain", dev, w_init),
                       ("masked", cpu, w_init), ("masked", dev, w_init),
                       ("nudged", cpu, nudged)):
        tr = secure_trainer(b8_clients, d)
        tr.state = tr.server_opt.init(tree_map(lambda x, d=d: x.to(d), w))
        tr.run(S_CMP_ROUNDS, plan=secure_plan(
            "per_round", specs["plain" if lane == "plain" else "masked"]),
            verbose=False)
        cmp[(lane, d.type)] = [x.cpu() for x in leaves(tr.state.w)]

    def max_abs(a, b):
        return max(float((x - y).abs().max()) for x, y in zip(a, b))

    plain = max_abs(cmp[("plain", "cpu")], cmp[("plain", dev.type)])
    masked = max_abs(cmp[("masked", "cpu")], cmp[("masked", dev.type)])
    spread = max_abs(cmp[("masked", "cpu")], cmp[("nudged", "cpu")])
    if not all(torch.allclose(a, b, atol=CMP_ATOL, rtol=CMP_RTOL) for a, b
               in zip(cmp[("plain", "cpu")], cmp[("plain", dev.type)])):
        raise AssertionError(f"plain rounds: card vs CPU {plain:.3e}")
    if not masked <= max(CMP_ATOL, 2 * spread):
        raise AssertionError(
            f"masked rounds: card vs CPU {masked:.3e}, the CPU's one-ulp "
            f"spread {spread:.3e}")
    out["card_vs_cpu_max_abs"] = {"plain": plain, "masked": masked,
                                  "cpu_masked_one_ulp_spread": spread}
    print(f"{S_CMP_ROUNDS} per-round rounds, card vs CPU params max abs: "
          f"plain {plain:.3e} (atol/rtol {CMP_ATOL}), masked {masked:.3e} "
          f"(held to twice the CPU's own masked spread under a one-ulp "
          f"nudge of the initial weights, {spread:.3e})")
    out["ring_cases_bit_equal"] = ring_card_vs_cpu(dev, specs)
    part("card vs CPU")

    # what the grid costs on its own: secure_weighted_sum on LeNet's
    # stack, device time of graph replays, masked against open
    grid = {}
    for m in (S_M, S_BIG_M):
        w = small.lenet_init(prng.PRNGKey(0), device=dev)
        y = tree_map(lambda x, m=m: 1e-3 * torch.randn(
            (m,) + tuple(x.shape), device=dev), w)
        t_dev = torch.tensor(5, device=dev)
        surv = torch.ones(m, dtype=torch.bool, device=dev)
        surv[1] = False
        for lane in ("open", "masked"):
            for label, s in (("all", None), ("dropout", surv)):
                grid[(m, lane, label)] = graph_ms(
                    lambda y=y, s=s, lane=lane: secure_weighted_sum(
                        y, s, specs[lane], t_dev), iters=20, replays=10)
        print(f"secure_weighted_sum on LeNet's stack at M={m}: open "
              f"{grid[(m, 'open', 'all')]:.4f} ms, masked "
              f"{grid[(m, 'masked', 'all')]:.4f} ms, masked with a dropout "
              f"{grid[(m, 'masked', 'dropout')]:.4f} ms (device, graph "
              f"replays); {m * (m - 1) // 2} pairs x 30,720 words hashed")
    out["grid_ms"] = {f"M{m}_{lane}_{label}": v
                      for (m, lane, label), v in grid.items()}
    part("grid")

    # a bigger cohort: the quickstart corpus (K=60) at M=32, device plane
    # (under cudnn.deterministic, so that masked and open are comparable
    # bit for bit)
    big = {}
    torch.backends.cudnn.deterministic = True
    try:
        for lane in ("open", "masked"):
            tr = secure_trainer(clients, dev, m=S_BIG_M)
            init, plan = tr.state, secure_plan("device", specs[lane],
                                               chunk_rounds=G_CR)
            tr.run(S_BIG_ROUNDS, plan=plan, verbose=False)
            torch.cuda.synchronize()
            tr.state, tr.history = init, []
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            hist = tr.run(S_BIG_ROUNDS, plan=plan, verbose=False)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / S_BIG_ROUNDS * 1e3
            peak = torch.cuda.max_memory_allocated()
            if not all(math.isfinite(r["loss"]) for r in hist
                       if "event" not in r):
                raise AssertionError(f"M={S_BIG_M} {lane}: non-finite loss")
            big[lane] = {"ms_per_round": ms, "peak_bytes": peak,
                         "state": tr.state}
            print(f"K={K} M={S_BIG_M} device plane {lane:6s} {ms:8.3f} "
                  f"ms/round, peak memory {peak / 2**20:.1f} MiB")
            del tr
    finally:
        torch.backends.cudnn.deterministic = False
    if drift_bits(big["masked"]["state"], big["open"]["state"]):
        raise AssertionError(f"M={S_BIG_M}: masked differs from open")
    out["big_cohort"] = {lane: {k: v for k, v in r.items() if k != "state"}
                         for lane, r in big.items()}
    part(f"M={S_BIG_M}")
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 21: federated language models
# ---------------------------------------------------------------------------
def lm_examples():
    """The two LM examples as modules (``examples/`` is not a package)."""
    sys.path.insert(0, str(ROOT / "examples"))
    import federated_llm_torch
    import paper_shakespeare_torch
    return federated_llm_torch, paper_shakespeare_torch


def clone_tree(tree):
    import torch
    from repro_torch.tree import tree_map
    return tree_map(torch.clone, tree)


def tree_max_abs(a, b):
    """(max abs difference, allclose at L_TOL's pair) of two trees, b may
    lie on another device."""
    from repro_torch.tree import leaves
    return max(float((x - y.to(x.device)).abs().max())
               for x, y in zip(leaves(a), leaves(b)))


def trees_close(a, b, atol, rtol):
    import torch
    from repro_torch.tree import leaves
    return all(torch.allclose(x, y.to(x.device), atol=atol, rtol=rtol)
               for x, y in zip(leaves(a), leaves(b)))


def per_round_run(tr, n_rounds):
    """``n_rounds`` on the per-round plane with a stamp after each round
    (each round ends in a read of its loss): (history, seconds a round)."""
    import torch
    stamps = []

    def stamp(_state):
        stamps.append(time.perf_counter())
        return {}

    t0 = time.perf_counter()
    hist = tr.run(n_rounds, verbose=False, eval_fn=stamp, log_every=1)
    torch.cuda.synchronize()
    return hist, [b - a for a, b in zip([t0] + stamps[:-1], stamps)]


def loss_falls(name, losses, k=5):
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{name}: non-finite loss {losses}")
    first, last = statistics.fmean(losses[:k]), statistics.fmean(losses[-k:])
    if not last < first:
        raise AssertionError(f"{name}: loss did not fall ({first:.4f} -> "
                             f"{last:.4f})")
    return first, last


def lm_tree_check(name, w, v, fm_kernel, fm_ops, fm_ref, eta, iters):
    """``fedmom_update`` on one server step of an LM's tree: the path's
    tree call bit-equal to the plain version on every leaf, its launches
    (one a table), device times of the kernel, the plain version and
    FedAvgM's tree call in turns with ``torch._fused_sgd_`` on the same
    leaf lists, beside the bytes bound."""
    import torch
    from repro_torch.tree import leaves, tree_map
    gen = torch.Generator(device="cuda").manual_seed(1)
    d = tree_map(lambda x: 1e-3 * torch.randn(x.shape, device=x.device,
                                              generator=gen), w)
    n = sum(x.numel() for x in leaves(w))
    sizes = [x.numel() for x in leaves(w)]
    tables = len(fm_kernel.tree_plan(sizes, [True] * len(sizes)))
    before = fm_kernel.launches
    got = fm_ops.fused_update_tree(w, v, d, eta=eta, beta=BETA)
    launched = fm_kernel.launches - before
    want = fm_ref.fedmom_update(w, v, d, eta, BETA)
    torch.cuda.synchronize()
    for g, r in zip(leaves(got), leaves(want)):
        if not torch.equal(g, r):
            raise AssertionError(f"{name}: fedmom_update differs from the "
                                 f"plain version")
    if launched != tables:
        raise AssertionError(f"{name}: {launched} launches, want one a "
                             f"table ({tables})")
    del got, want
    torch.cuda.empty_cache()
    out = {"elements": n, "leaves": len(sizes), "tables": tables,
           "bound_ms": 20.0 * n / HBM_BYTES_PER_S * 1e3}
    out["ms"] = cuda_ms(lambda: fm_ops.fused_update_tree(
        w, v, d, eta=eta, beta=BETA), iters)
    out["plain_ms"] = cuda_ms(lambda: fm_ref.fedmom_update(
        w, v, d, eta, BETA), max(iters // 4, 2))
    lw, lm, ld = ([x.clone() for x in leaves(t)] for t in (w, v, d))

    def avgm():
        return fm_ops.fused_avgm_tree(w, v, d, eta=eta, beta=BETA)

    def library():
        torch._fused_sgd_(lw, ld, lm, weight_decay=0.0, momentum=BETA,
                          lr=eta, dampening=0.0, nesterov=False,
                          maximize=False, is_first_step=False)

    def turns(a, b):
        ta, tb, tb2, ta2 = (cuda_ms(f, iters) for f in (a, b, b, a))
        return (ta + ta2) / 2, (tb + tb2) / 2

    out["fedavgm_ms"], out["fedavgm_library_ms"] = turns(avgm, library)
    del lw, lm, ld, d
    torch.cuda.empty_cache()
    print(f"fedmom_update on {name}'s tree ({n} fp32 elements, "
          f"{len(sizes)} leaves, {tables} table(s)): bit-equal to the plain "
          f"version, {launched} launch(es); kernel {out['ms']:.4f} ms, "
          f"bound {out['bound_ms']:.4f} ms (20 B/elem at 3.35 TB/s, "
          f"{out['bound_ms'] / out['ms']:.1%}), plain {out['plain_ms']:.4f} "
          f"ms; FedAvgM tree call {out['fedavgm_ms']:.4f} ms, "
          f"torch._fused_sgd_ {out['fedavgm_library_ms']:.4f} ms (in turns)")
    return out


def fed_llm_lanes(dev, fl, fm_kernel):
    """(a): fed-llm-100m at the example's defaults on the per-round plane
    (fused and unfused server) and on ``plane="auto"``."""
    import torch
    from repro_torch.launch.plan import ExecutionPlan
    from repro_torch.tree import leaves
    out = {}

    def args(*extra):
        return fl.parser().parse_args(list(extra))

    tr, _, cfg = fl.build(args("--fused-server"), device=dev)
    w0 = clone_tree(tr.state.w)
    out["n_params"] = sum(x.numel() for x in leaves(w0))
    a = args()
    print(f"{cfg.name}: {out['n_params']} fp32 parameters ({cfg.n_layers} "
          f"stacked layers, d_model {cfg.d_model}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads of {cfg.d_head}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab}); {a.clients} clients x 20,000 tokens, M={a.m} "
          f"H={a.local_steps} b={a.batch} seq {a.seq} lr {a.lr}, FedMom "
          f"eta=K/M beta 0.9; {L_ROUNDS} rounds a lane")
    for lane, trainer in (("fused", tr), ("unfused", None)):
        if trainer is None:
            trainer, _, _ = fl.build(args(), device=dev,
                                     init=(clone_tree(w0), None))
        torch.cuda.reset_peak_memory_stats()
        fm_kernel.launches = 0
        hist, steps = per_round_run(trainer, L_ROUNDS)
        launches = fm_kernel.launches
        losses = [r["loss"] for r in hist]
        first, last = loss_falls(f"fed-llm {lane}", losses)
        row = {"ms_per_round": statistics.median(steps[1:]) * 1e3,
               "first_round_ms": steps[0] * 1e3,
               "peak_bytes": torch.cuda.max_memory_allocated(),
               "loss_first": losses[0], "loss_last": losses[-1],
               "fedmom_update_launches": launches}
        if lane == "fused" and launches != L_ROUNDS:
            raise AssertionError(f"fed-llm fused: {launches} fedmom_update "
                                 f"launches in {L_ROUNDS} rounds")
        if lane == "unfused" and launches:
            raise AssertionError("fed-llm unfused launched fedmom_update")
        row["w"] = clone_tree(trainer.state.w)
        if lane == "fused":
            # the time breakdown: 3 more rounds under the profiler
            wall, rows = profile_rows(lambda: trainer.run(3, verbose=False))
            busy = sum(r[1] for r in rows)
            row.update(busy_share=busy / wall,
                       device_ms_per_round=busy / 3 * 1e3,
                       ops_per_round=sum(r[2] for r in rows) / 3,
                       profiled_fedmom_update=kernel_launches(
                           rows, FM_KERNEL_NAME),
                       top=[(k[:90], round(s * 1e3, 3), c)
                            for k, s, c in rows[:8]])
            if row["profiled_fedmom_update"] != 3:
                raise AssertionError(
                    f"fed-llm: profiler counts {row['profiled_fedmom_update']}"
                    f" fedmom_update launches in 3 rounds")
        out[lane] = row
        print(f"per-round {lane:7s} {row['ms_per_round']:9.2f} ms/round "
              f"(median, host clock, each round synced; first "
              f"{row['first_round_ms']:.1f} ms); loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f} (first 5 {first:.4f}, last 5 {last:.4f}); "
              f"peak {row['peak_bytes'] / 2**30:.2f} GiB; fedmom_update "
              f"{launches} in {L_ROUNDS} rounds"
              + (f"; profiled 3 rounds: device "
                 f"{row['device_ms_per_round']:.2f} ms a round, busy "
                 f"{100 * row['busy_share']:.2f}%, "
                 f"{row['ops_per_round']:.0f} device ops a round, "
                 f"fedmom_update {row['profiled_fedmom_update']}; top: "
                 f"{row['top']}" if lane == "fused" else ""))
        del trainer
        torch.cuda.empty_cache()
    diff = tree_max_abs(out["fused"]["w"], out["unfused"]["w"])
    if not trees_close(out["fused"]["w"], out["unfused"]["w"], L_FUSED_TOL,
                       L_FUSED_TOL):
        raise AssertionError(f"fed-llm: fused and unfused params differ by "
                             f"{diff:.3e} (atol/rtol {L_FUSED_TOL})")
    out["fused_vs_unfused_max_abs"] = diff
    print(f"fused vs unfused server after {L_ROUNDS} rounds: max abs "
          f"{diff:.3e} (atol/rtol {L_FUSED_TOL}; the embedding's backward "
          f"scatters with atomics, so two runs are not bit-equal)")
    for lane in ("fused", "unfused"):
        del out[lane]["w"]

    # plane="auto": the keyed sampler, chunks of 10 rounds as CUDA graphs
    tr, _, _ = fl.build(args("--fused-server", "--plan", "auto"), device=dev,
                        init=(clone_tree(w0), None))
    plan = ExecutionPlan(plane="auto", chunk_rounds=L_CR)
    opt = tr.server_opt
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr.run(L_ROUNDS, plan=plan, verbose=False)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    decision = tr.session.plan_log[-1]
    captures = sum(g.capture_s or 0.0 for g in tr.session.graphs.values())
    tr.state, tr.history = opt.init(clone_tree(w0)), []
    t0 = time.perf_counter()
    hist = [r for r in tr.run(L_ROUNDS, plan=plan, verbose=False)
            if "loss" in r]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / L_ROUNDS * 1e3
    losses = [r["loss"] for r in hist]
    first, last = loss_falls("fed-llm auto", losses)
    peak = torch.cuda.max_memory_allocated()
    tr.state, tr.history = opt.init(clone_tree(w0)), []
    wall, rows = profile_rows(lambda: tr.run(L_CR, plan=plan, verbose=False))
    busy = sum(r[1] for r in rows)
    fm = kernel_launches(rows, FM_KERNEL_NAME)
    if fm != L_CR:
        raise AssertionError(f"fed-llm auto: {fm} fedmom_update launches in "
                             f"{L_CR} rounds (profiler)")
    out["auto"] = {"resolved": decision["plane"],
                   "reason": decision["reason"], "ms_per_round": ms,
                   "first_run_s": first_s, "captures_s": captures,
                   "peak_bytes": peak, "loss_first": losses[0],
                   "loss_last": losses[-1], "busy_share": busy / wall,
                   "device_ms_per_round": busy / L_CR * 1e3,
                   "ops_per_round": sum(r[2] for r in rows) / L_CR,
                   "fedmom_update_launches": fm}
    print(f"auto -> {decision['plane']} ({decision['reason']}): "
          f"{ms:.2f} ms/round (host clock, synced at the end); first run "
          f"{first_s:.2f} s with {captures:.2f} s of captures; loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} (first 5 {first:.4f}, last "
          f"5 {last:.4f}); peak {peak / 2**30:.2f} GiB (the graph's pool "
          f"included); one profiled chunk: device {busy / L_CR * 1e3:.2f} ms "
          f"a round, busy {100 * busy / wall:.2f}%, fedmom_update {fm} in "
          f"{L_CR} rounds")
    out["tree_w"], out["tree_v"] = tr.state.w, tr.state.extra["v"]
    return out


def fed_llm_card_vs_cpu(dev, fl):
    """(b): fed-llm-100m cut to L_CMP_LAYERS layers at full width, the
    card's keyed weights carried to the CPU, L_CMP_ROUNDS FedMom rounds on
    each (the fused server: the kernel on the card, its plain version on
    the CPU)."""
    import dataclasses as dc
    import torch
    from repro_torch.interop import tree_from_numpy, tree_to_numpy
    cfg = dc.replace(fl.model_100m(), n_layers=L_CMP_LAYERS)
    args = fl.parser().parse_args(["--fused-server"])
    card, _, _ = fl.build(args, cfg=cfg, device=dev)
    w_host = tree_from_numpy(tree_to_numpy(card.state.w), "cpu")
    host, _, _ = fl.build(args, cfg=cfg, device="cpu", init=(w_host, None))
    t0 = time.perf_counter()
    h_host = host.run(L_CMP_ROUNDS, verbose=False)
    host_s = time.perf_counter() - t0
    h_card = card.run(L_CMP_ROUNDS, verbose=False)
    diff = tree_max_abs(host.state.w, card.state.w)
    if not trees_close(host.state.w, card.state.w, L_CMP_TOL, L_CMP_TOL):
        raise AssertionError(f"fed-llm {L_CMP_LAYERS} layers: card and CPU "
                             f"params differ by {diff:.3e}")
    print(f"{cfg.name} cut to {L_CMP_LAYERS} layers, {L_CMP_ROUNDS} FedMom "
          f"rounds: card vs CPU params max abs {diff:.3e} (atol/rtol "
          f"{L_CMP_TOL}, TF32 off); losses cpu "
          f"{[round(r['loss'], 6) for r in h_host]} cuda "
          f"{[round(r['loss'], 6) for r in h_card]} (CPU {host_s:.1f} s)")
    del card, host
    torch.cuda.empty_cache()
    return diff


def gemma_train_phase(dev, fm_kernel):
    """(c): gemma3-1b at full width in fp32 (keyed random weights from the
    port's ``init``, the config's ``scan_layers`` and ``remat``), M=2 H=2
    b=2 seq 256 through ``round_step`` with the fused server, remat on and
    off."""
    import dataclasses as dc
    import numpy as np
    import torch
    from repro_torch import random as prng
    from repro_torch.configs import get_config
    from repro_torch.core import RoundConfig, fedmom, round_step
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves
    cfg = dc.replace(get_config(G_ARCH), dtype="float32")
    t0 = time.perf_counter()
    params, axes = T.init(cfg, prng.PRNGKey(0), device=dev)
    torch.cuda.synchronize()
    n = sum(x.numel() for x in leaves(params))
    init_s = time.perf_counter() - t0
    M_, H_, b_, S_ = GT_M, GT_H, GT_B, GT_S
    print(f"{G_ARCH}: {n} fp32 parameters (init {init_s:.1f} s); "
          f"scan_layers={cfg.scan_layers}, remat={cfg.remat} "
          f"({cfg.remat_policy}); M={M_} H={H_} b={b_} seq {S_}, "
          f"{GT_ROUNDS} rounds of round_step, FedMom eta=1 beta 0.9 fused, "
          f"lr {GT_LR}")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (GT_ROUNDS, M_, H_, b_, S_ + 1))
    batches = [{"tokens": torch.as_tensor(t[..., :-1], dtype=torch.int32,
                                          device=dev),
                "labels": torch.as_tensor(t[..., 1:], dtype=torch.int32,
                                          device=dev)} for t in toks]
    weights = torch.full((M_,), 1.0 / M_, device=dev)
    opt = fedmom(eta=1.0, beta=BETA, use_fused_kernel=True)
    rcfg = RoundConfig(clients_per_round=M_, local_steps=H_, lr=GT_LR,
                       placement="mesh", compute_dtype="float32")
    out = {"n_params": n, "init_s": init_s}
    # every token passes the final norm: its scale moves in every round
    norm0 = params["final_norm"].clone()
    state = None
    for remat in (True, False):
        c = dc.replace(cfg, remat=remat)

        def loss_fn(p, batch, c=c):
            return T.loss_fn(p, c, batch)

        state = opt.init(params)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fm_kernel.launches = 0
        times, metrics = [], []
        for r in range(GT_ROUNDS):
            t0 = time.perf_counter()
            state, m = round_step(loss_fn, opt, state, batches[r], weights,
                                  rcfg, param_axes=axes, device=dev)
            metrics.append((float(m["loss"]), float(m["delta_norm"])))
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        if not all(math.isfinite(x) for pair in metrics for x in pair):
            raise AssertionError(f"{G_ARCH} remat={remat}: {metrics}")
        if torch.equal(state.w["final_norm"], norm0):
            raise AssertionError(f"{G_ARCH} remat={remat}: server did not "
                                 f"move")
        row = {"ms_per_round": statistics.median(times[1:]) * 1e3,
               "first_round_ms": times[0] * 1e3, "peak_bytes": peak,
               "losses": [x[0] for x in metrics],
               "fedmom_update_launches_per_round":
                   fm_kernel.launches / GT_ROUNDS}
        out["remat" if remat else "no_remat"] = row
        print(f"remat={remat!s:5s} {row['ms_per_round']:9.1f} ms/round "
              f"(median of rounds 2-{GT_ROUNDS}, host clock, synced; first "
              f"{row['first_round_ms']:.1f} ms); peak "
              f"{peak / 2**30:.2f} GiB; losses {row['losses']}; "
              f"delta_norm {[round(x[1], 4) for x in metrics]}; "
              f"fedmom_update {fm_kernel.launches} launches in {GT_ROUNDS} "
              f"rounds")
        if remat:
            def one_round(state=state, c=c):
                return round_step(lambda p, b: T.loss_fn(p, c, b), opt,
                                  state, batches[0], weights, rcfg,
                                  param_axes=axes, device=dev)
            wall, rows = profile_rows(one_round)
            busy = sum(r[1] for r in rows)
            row.update(busy_share=busy / wall,
                       profiled_fedmom_update=kernel_launches(
                           rows, FM_KERNEL_NAME),
                       top=[(k[:90], round(s * 1e3, 3), cnt)
                            for k, s, cnt in rows[:8]])
            del one_round
            print(f"  one profiled round: wall {wall * 1e3:.1f} ms, device "
                  f"busy {100 * busy / wall:.2f}%, fedmom_update "
                  f"{row['profiled_fedmom_update']} launch(es) (profiler); "
                  f"top {row['top']}")
        if not remat:
            break
        state = None
        torch.cuda.empty_cache()
    del params, batches
    torch.cuda.empty_cache()
    out["tree_w"], out["tree_v"] = state.w, state.extra["v"]
    return out


def shakespeare_phase(dev, sh, fm_kernel):
    """(d): the paper's task 2 at the example's configuration on
    ``plane="auto"``, and 3 FedMom rounds on the card against the CPU."""
    import torch
    from repro_torch import random as prng
    from repro_torch.interop import tree_from_numpy, tree_to_numpy
    from repro_torch.launch.plan import ExecutionPlan
    from repro_torch.models import small
    ds = sh.dataset(SH_K)
    K_ = ds.population().n_clients
    w0 = small.lstm_init(prng.PRNGKey(0), device=dev)
    plan = ExecutionPlan(plane="auto", chunk_rounds=SH_CR)
    out = {}
    print(f"char-LSTM 1x128 on synthetic Shakespeare: K={K_} M=2 b=10 lr "
          f"0.8, eta=K/M; {SH_ROUNDS} rounds a run on plane='auto' in chunks "
          f"of {SH_CR} (a first run with the captures, then a timed run)")
    for name, opt, H_ in sh.runs(K_, 2, fused=True):
        tr = sh.make_trainer(ds, opt, H_, 0.8, "auto", dev, 2)
        tr.state = opt.init(clone_tree(w0))
        t0 = time.perf_counter()
        tr.run(SH_ROUNDS, plan=plan, verbose=False)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        decision = tr.session.plan_log[-1]
        tr.state, tr.history = opt.init(clone_tree(w0)), []
        t0 = time.perf_counter()
        hist = [r for r in tr.run(SH_ROUNDS, plan=plan, verbose=False)
                if "loss" in r]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / SH_ROUNDS * 1e3
        losses = [r["loss"] for r in hist]
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"shakespeare {name}: {losses}")
        row = {"resolved": decision["plane"], "ms_per_round": ms,
               "first_run_s": first_s, "loss_first": losses[0],
               "final_loss": losses[-1]}
        if name == "FedMom":
            tr.state, tr.history = opt.init(clone_tree(w0)), []
            wall, rows = profile_rows(lambda: tr.run(SH_CR, plan=plan,
                                                     verbose=False))
            busy = sum(r[1] for r in rows)
            row.update(busy_share=busy / wall,
                       device_ms_per_round=busy / SH_CR * 1e3,
                       fedmom_update_launches=kernel_launches(
                           rows, FM_KERNEL_NAME))
            if row["fedmom_update_launches"] != SH_CR:
                raise AssertionError(
                    f"shakespeare FedMom: {row['fedmom_update_launches']} "
                    f"fedmom_update launches in {SH_CR} rounds")
        out[name] = row
        print(f"{name:6s} (H={H_:2d}) auto -> {decision['plane']}: "
              f"{ms:8.2f} ms/round; first run {first_s:.1f} s; loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f}"
              + (f"; one profiled chunk: device "
                 f"{row['device_ms_per_round']:.2f} ms a round, busy "
                 f"{100 * row['busy_share']:.1f}%, "
                 f"fedmom_update {row['fedmom_update_launches']} in {SH_CR} "
                 f"rounds" if name == "FedMom" else ""))
        del tr
    print("rounds-to-loss summary (lower = faster):",
          {k: round(v["final_loss"], 4) for k, v in out.items()})
    # card against CPU: 3 FedMom rounds, per-round plane, carried weights
    _, opt, H_ = sh.runs(K_, 2, fused=True)[2]
    runs = {}
    for device in ("cpu", dev):
        tr = sh.make_trainer(ds, opt, H_, 0.8, "per_round", device, 2)
        tr.state = opt.init(tree_from_numpy(tree_to_numpy(w0), device))
        tr.run(SH_CMP_ROUNDS, verbose=False)
        runs[str(device)] = tr
    diff = tree_max_abs(runs["cpu"].state.w, runs[str(dev)].state.w)
    if not trees_close(runs["cpu"].state.w, runs[str(dev)].state.w,
                       SH_CMP_TOL, SH_CMP_TOL):
        raise AssertionError(f"shakespeare: card and CPU params differ by "
                             f"{diff:.3e}")
    out["card_vs_cpu_max_abs_diff"] = diff
    print(f"FedMom {SH_CMP_ROUNDS} rounds card vs CPU: params max abs "
          f"{diff:.3e} (atol/rtol {SH_CMP_TOL})")
    return out


def lm_phase(dev, fm_kernel, fm_ops, fm_ref):
    """Phase 21: (a) fed-llm-100m at full size on the per-round and auto
    planes, (b) its 2-layer cut on the card against the CPU, (c)
    gemma3-1b at full width with and without remat, (d) the paper's
    Shakespeare task; ``fedmom_update`` on both LM trees."""
    import torch
    fl, sh = lm_examples()
    out = {"part_s": {}}
    t_part = time.perf_counter()

    def part(name):
        nonlocal t_part
        now = time.perf_counter()
        out["part_s"][name] = now - t_part
        print(f"  ({name}: {now - t_part:.1f} s)", flush=True)
        t_part = now

    print("(a) fed-llm-100m at full size")
    a = fed_llm_lanes(dev, fl, fm_kernel)
    out["fed_llm_tree"] = lm_tree_check(
        "fed-llm-100m", a.pop("tree_w"), a.pop("tree_v"), fm_kernel, fm_ops,
        fm_ref, 4.0, 20)
    out["fed_llm"] = a
    torch.cuda.empty_cache()
    part("a")
    print(f"(b) fed-llm-100m cut to {L_CMP_LAYERS} layers: card against CPU")
    out["fed_llm_card_vs_cpu_max_abs_diff"] = fed_llm_card_vs_cpu(dev, fl)
    part("b")
    print(f"(c) {G_ARCH} at full width, fp32, through round_step")
    c = gemma_train_phase(dev, fm_kernel)
    out["gemma_tree"] = lm_tree_check(
        G_ARCH, c.pop("tree_w"), c.pop("tree_v"), fm_kernel, fm_ops, fm_ref,
        1.0, 5)
    out["gemma3_1b"] = c
    torch.cuda.empty_cache()
    part("c")
    print("(d) the paper's Shakespeare task")
    out["shakespeare"] = shakespeare_phase(dev, sh, fm_kernel)
    part("d")
    return out


# ---------------------------------------------------------------------------
# phase 22: the data mesh
# ---------------------------------------------------------------------------
def mesh_plan(lane, mesh, chunk_rounds, secure=None):
    """The plan of a mesh lane: ``per_round``, ``device`` or a streaming
    lane (``padded``, ``bucketed``; the hook lane runs ``bucketed``)."""
    from repro_torch.launch.plan import CacheSpec, ExecutionPlan
    if lane == "per_round":
        return ExecutionPlan(plane="per_round", mesh=mesh, secure=secure)
    return ExecutionPlan(
        plane="device" if lane == "device" else "streaming",
        chunk_rounds=chunk_rounds, mesh=mesh, secure=secure,
        cache=CacheSpec(bucketed=lane == "bucketed"))


def flat_params(state):
    import numpy as np
    from repro_torch.tree import leaves
    return np.concatenate([x.detach().cpu().reshape(-1).numpy()
                           for x in leaves(state.w)])


# (name, lane, secure aggregation) of the spawned meshes' runs; "hook" is
# the bucketed lane through client_step (linreg_tier_step), linreg only
MESH_RANK_LANES = (("per_round", "per_round", None),
                   ("padded", "padded", None),
                   ("bucketed", "bucketed", None),
                   ("hook", "bucketed", None),
                   ("device", "device", None),
                   ("masked", "per_round", "masked"),
                   ("open", "per_round", "open"))


def mesh_linreg_trainer(dev, hook=False):
    """tests/test_mesh_shard.py's fixture: ``tests/_trajectory.py``
    ``make_clients(n=8)`` (n_k ~ U[20, 40), d=5, seed 0), dataset seed 1,
    the keyed sampler (seed 2) at M=4, H=4, b=4, lr 0.05, FedMom eta 1,
    beta 0.9 through fedmom_update; ``hook``: each tier's local steps
    through client_step."""
    import numpy as np
    import torch
    from repro_torch.kernels.client_step.ops import linreg_tier_step
    from repro_torch.core import DeviceUniformSampler, RoundConfig, fedmom
    from repro_torch.data import FederatedDataset
    from repro_torch.launch.train import FederatedTrainer
    rng = np.random.default_rng(0)
    clients = []
    for _ in range(8):
        m = int(rng.integers(20, 40))
        x = rng.normal(size=(m, 5)).astype(np.float32)
        y = (x @ np.arange(1, 6) / 5
             + 0.1 * rng.normal(size=m)).astype(np.float32)
        clients.append({"x": x, "y": y})
    ds = FederatedDataset(clients, seed=1)
    opt = fedmom(eta=1.0, beta=0.9, use_fused_kernel=True)
    return FederatedTrainer(
        loss_fn=linreg_loss, server_opt=opt,
        rcfg=RoundConfig(MS_LINREG_M, 4, 0.05, compute_dtype="float32"),
        dataset=ds, sampler=DeviceUniformSampler(ds.population(),
                                                 MS_LINREG_M, seed=2),
        state=opt.init({"w": torch.zeros(5, device=dev),
                        "b": torch.zeros((), device=dev)}),
        local_batch=4, device=dev,
        client_step_fn=linreg_tier_step() if hook else None)


def mesh_lane_runs(dev, lanes, n_rounds, chunk_rounds, n=None,
                   fleet="lenet", warm=False):
    """Each lane's run under ``cudnn.deterministic`` over a mesh of ``n``
    ranks (``None``: no mesh), of BENCH_10's trainer (``fleet="lenet"``)
    or of the reference's mesh-test fixture (``"linreg"``): its losses,
    final parameters, host ms/round, ``fedmom_update`` and ``client_step``
    launches (the eager lanes' counters), plan record and packed corpus
    bytes.  The hook lane runs on the linreg fleet alone.  ``warm``: time
    a second run of the trainer, after one that captures its graphs."""
    import torch
    from repro_torch.core import SecureAggSpec
    from repro_torch.data import synthetic_femnist
    from repro_torch.kernels.client_step import kernel as cs_kernel
    from repro_torch.kernels.fedmom_update import kernel as fm_kernel
    from repro_torch.launch.mesh import MeshSpec
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    clients = (synthetic_femnist(n_clients=S_K, seed=0)[0]
               if fleet == "lenet" else None)
    mesh = None if n is None else MeshSpec(devices=n)
    out = {}
    for name, lane, kind in lanes:
        if name == "hook" and fleet != "linreg":
            continue
        spec = None if kind is None else SecureAggSpec(
            masked=kind == "masked", seed=0, frac_bits=S_FRAC)
        tr = (secure_trainer(clients, dev) if fleet == "lenet"
              else mesh_linreg_trainer(dev, hook=name == "hook"))
        plan = mesh_plan(lane, mesh, chunk_rounds, spec)
        if warm:
            init = tr.state
            tr.run(n_rounds, plan=plan, verbose=False)
            tr.state, tr.history = init, []
        fm_kernel.launches = cs_kernel.launches = 0
        t0 = time.perf_counter()
        hist = [r for r in tr.run(n_rounds, plan=plan, verbose=False)
                if "event" not in r]
        sync(dev)
        out[name] = {
            "ms": (time.perf_counter() - t0) / n_rounds * 1e3,
            "losses": [r["loss"] for r in hist],
            "w": flat_params(tr.state), "launches": fm_kernel.launches,
            "client_step_launches": cs_kernel.launches,
            "plan": tr.session.plan_log[-1],
            "nbytes": (None if tr.session.device_ds is None
                       else tr.session.device_ds.nbytes)}
    return out


def mesh_rank(rank, n, dev, lanes, n_rounds, chunk_rounds,
              fleets=("lenet",), warm=False):
    """One spawned rank of phase 22: ``mesh_lane_runs`` of each fleet."""
    return {fleet: mesh_lane_runs(dev, lanes, n_rounds, chunk_rounds, n,
                                  fleet, warm) for fleet in fleets}


def mesh_drift(a, b):
    """(max abs difference of final parameters and losses, parameters
    that differ in any bit) of two lane runs."""
    import numpy as np
    w = float(np.abs(a["w"] - b["w"]).max())
    loss = max(abs(x - y) for x, y in zip(a["losses"], b["losses"]))
    bits = int((a["w"].view(np.int32) != b["w"].view(np.int32)).sum())
    return max(w, loss), bits


def mesh_phase(dev, fm_kernel, parts="abc"):
    """Phase 22: (a) mesh=None against a 1-rank NCCL mesh on the graphed
    device plane and the streaming lanes at BENCH_10's configuration, in
    turns; (b) 2 and 4 gloo ranks sharing the card against one device; (c)
    NCCL at 2 and 4 ranks where the cards allow.  ``parts`` picks them."""
    out = {"part_s": {}, "a": {}, "b": {}, "c": {}, "ran": []}
    t_part = time.perf_counter()

    def part(name):
        nonlocal t_part
        now = time.perf_counter()
        out["part_s"][name] = now - t_part
        print(f"  ({name}: {now - t_part:.1f} s)", flush=True)
        t_part = now

    print(f"BENCH_10: LeNet on synthetic FEMNIST K={S_K}, M={S_M} H={S_H} "
          f"b={S_B} lr={S_LR} FedMom eta={S_ETA} beta={S_BETA} through "
          f"fedmom_update, DeviceUniformSampler; {MS_ROUNDS} rounds in "
          f"chunks of {MS_CR}")
    failures = []
    if "a" in parts:
        mesh_one_rank(dev, fm_kernel, out, part)
    if "b" in parts:
        mesh_gloo(dev, out, part, failures)
    if "c" in parts:
        mesh_nccl(dev, out, part, failures)
    print(f"mesh sizes and backends run: {out['ran']}")
    if failures:
        raise AssertionError("; ".join(failures))
    return out


def mesh_one_rank(dev, fm_kernel, out, part):
    """Phase 22(a): mesh=None against a 1-rank NCCL mesh."""
    import math as _math

    import torch
    import torch.distributed as dist
    from repro_torch.data import synthetic_femnist
    from repro_torch.launch.mesh import MeshSpec
    clients, _ = synthetic_femnist(n_clients=S_K, seed=0)
    one = MeshSpec(devices=1)
    print(f"(a) mesh=None against MeshSpec(devices=1) on NCCL, "
          f"cudnn.deterministic: a warm-up run of each (the device plane "
          f"{MS_ROUNDS} rounds, its two chunk shapes captured; a streaming "
          f"lane {MS_CR}), then runs in turns (none, mesh, mesh, none: the "
          f"device plane {MS_ROUNDS} rounds, a streaming lane {MS_CR}), the "
          f"last of each held against the other; one "
          f"profiled chunk of the device plane, {MS_PROFILE_ROUNDS} "
          f"profiled rounds of a streaming lane")
    torch.backends.cudnn.deterministic = True
    for lane in ("device", "padded", "bucketed"):
        trs = {}
        for tag, mesh in (("none", None), ("mesh1", one)):
            tr = secure_trainer(clients, dev)
            init, plan = tr.state, mesh_plan(lane, mesh, MS_CR)
            t0 = time.perf_counter()
            tr.run(MS_ROUNDS if lane == "device" else MS_CR, plan=plan,
                   verbose=False)
            sync(dev)
            trs[tag] = (tr, init, plan, time.perf_counter() - t0)
        times = {"none": [], "mesh1": []}
        launches, last = {}, {}
        # BENCH_10's 60 rounds on the device plane; one chunk of an eager
        # streaming lane (25 of its rounds take what 60 take the graphs)
        n_timed = MS_ROUNDS if lane == "device" else MS_CR
        for tag in ("none", "mesh1", "mesh1", "none"):
            tr, init, plan, _ = trs[tag]
            tr.state, tr.history = init, []
            fm_kernel.launches = 0
            t0 = time.perf_counter()
            hist = [r for r in tr.run(n_timed, plan=plan, verbose=False)
                    if "event" not in r]
            sync(dev)
            times[tag].append((time.perf_counter() - t0) / n_timed * 1e3)
            launches[tag] = fm_kernel.launches
            losses = [r["loss"] for r in hist]
            if len(losses) != n_timed or not all(_math.isfinite(x)
                                                  for x in losses):
                raise AssertionError(f"{lane} {tag}: losses {losses}")
            last[tag] = {"losses": losses, "w": flat_params(tr.state)}
        drift, bits = mesh_drift(last["mesh1"], last["none"])
        row = {"ms_per_round": {k: statistics.fmean(v)
                                for k, v in times.items()},
               "ms_runs": times, "drift": drift, "drift_bits": bits,
               "first_call_s": {k: v[3] for k, v in trs.items()}}
        # one chunk of the graphed plane; a few rounds of an eager lane
        # (the profiler's cost grows with the host's ops)
        n_prof = MS_CR if lane == "device" else MS_PROFILE_ROUNDS
        for tag in ("none", "mesh1"):
            tr, init, plan, _ = trs[tag]
            tr.state, tr.history = init, []
            wall, rows = profile_rows(
                lambda: tr.run(n_prof, plan=plan, verbose=False))
            busy = sum(r[1] for r in rows)
            nccl = [(k, sec, c) for k, sec, c in rows if "nccl" in k.lower()]
            fm = kernel_launches(rows, FM_KERNEL_NAME)
            if fm != n_prof:
                raise AssertionError(
                    f"{lane} {tag}: the profiler counts {fm} fedmom_update "
                    f"launches in {n_prof} rounds, want one a round")
            row[tag] = {"device_ms_per_round": busy / n_prof * 1e3,
                        "busy_share": busy / wall,
                        "ops_per_round": sum(r[2] for r in rows) / n_prof,
                        "fedmom_update_launches": fm,
                        "profiled_rounds": n_prof,
                        "nccl_ms_per_round": sum(r[1] for r in nccl)
                        / n_prof * 1e3,
                        "nccl_ops_per_round": sum(r[2] for r in nccl)
                        / n_prof,
                        "nccl_names": sorted({k[:60] for k, _, _ in nccl})}
        tr = trs["mesh1"][0]
        rec = tr.session.plan_log[-1]
        if rec.get("mesh_shape") != [1] or rec.get("eager_chunks"):
            raise AssertionError(f"{lane}: mesh record {rec}")
        if lane == "device" and dev.type == "cuda" and not all(
                g.graph is not None for g in tr.session.graphs.values()):
            raise AssertionError("device plane under the NCCL mesh: a "
                                 "chunk was not captured")
        row["mesh_launches"] = (row["mesh1"]["fedmom_update_launches"]
                                if lane == "device" else launches["mesh1"])
        if lane != "device" and launches["mesh1"] != n_timed:
            raise AssertionError(f"{lane}: {launches['mesh1']} "
                                 f"fedmom_update launches in {n_timed} "
                                 f"rounds under the mesh")
        if drift > MESH_ATOL:
            raise AssertionError(f"{lane}: 1-rank mesh drift {drift}")
        if lane != "device":
            row["host_delta"] = mesh_host_delta(lane, trs, one)
            row["split"] = {
                tag: mesh_split(f"BENCH_10 {lane} {tag}", lane, mesh, tr,
                                init)
                for tag, (tr, init, plan, _), mesh in (
                    ("none", trs["none"], None),
                    ("mesh1", trs["mesh1"], one))}
        out["a"][lane] = row
        m = row["ms_per_round"]
        print(f"{lane:9s} none {m['none']:8.3f} ms/round, 1-rank NCCL mesh "
              f"{m['mesh1']:8.3f} ms/round (host clock, runs in turns "
              f"{times}); drift of the mesh run {drift:.3e} ({bits} "
              f"parameters differ in a bit); one profiled chunk of "
              f"{MS_CR}: device {row['none']['device_ms_per_round']:.3f} -> "
              f"{row['mesh1']['device_ms_per_round']:.3f} ms/round, busy "
              f"{100 * row['none']['busy_share']:.1f}% -> "
              f"{100 * row['mesh1']['busy_share']:.1f}%, NCCL ops "
              f"{row['mesh1']['nccl_names']} "
              f"{row['mesh1']['nccl_ms_per_round']:.4f} ms a round; "
              f"fedmom_update {fm} launches (profiler) in {n_prof} rounds, "
              f"{launches['mesh1']} (counter) in {n_timed}")
        part(f"a {lane}")
        del trs, tr
    # the round's collectives alone, captured: a graph of 100 calls, each
    # of 20 replays timed between CUDA events
    mesh = one.build(dev)
    delta = torch.zeros(sum(x.numel() for x in secure_trainer(
        clients, dev).state.w.values()), device=dev)
    losses = torch.zeros(S_M, device=dev)
    out["a"]["captured_all_reduce_ms"] = graph_ms(
        lambda: mesh.all_reduce_(delta))
    out["a"]["captured_all_gather_ms"] = graph_ms(
        lambda: mesh.all_gather_blocks([(losses, S_M)]))
    print(f"captured on the 1-rank NCCL mesh: all_reduce of the "
          f"{delta.numel()}-float delta "
          f"{out['a']['captured_all_reduce_ms'] * 1e3:.3f} us, all-gather of "
          f"the {S_M} losses {out['a']['captured_all_gather_ms'] * 1e3:.3f} "
          f"us (device time a call)")
    torch.backends.cudnn.deterministic = False
    dist.destroy_process_group()         # the 1-rank group build() began
    out["ran"].append("1 rank on NCCL (in this process)")
    torch.cuda.empty_cache()
    part("a collectives")


def mesh_gloo(dev, out, part, failures):
    """Phase 22(b): 2 and 4 gloo ranks sharing the card."""
    from repro_torch.launch.mesh import spawn
    print(f"(b) {MS_SIZES} gloo ranks sharing the card (spawned, both "
          f"meshes at once), "
          f"{MS_RANK_ROUNDS} rounds in chunks of {MS_RANK_CR} a lane, "
          f"against one device (cudnn.deterministic on both sides): "
          f"BENCH_10's LeNet (the streaming and device lanes' final-loss "
          f"drift within {MS_LENET_LOSS_TOL}, bench_mesh's bound; the "
          f"secure per-round lanes flip ring quanta: masked held to the "
          f"open ring) and the reference's mesh-test linreg fleet "
          f"(M={MS_LINREG_M}; parameters and losses within {MESH_ATOL}, "
          f"masked parameters bit-equal to one device's); ms/round of a "
          f"rank's first runs include its process's CUDA set-up")
    fleets = ("lenet", "linreg")
    single = {fleet: mesh_lane_runs(dev, MESH_RANK_LANES, MS_RANK_ROUNDS,
                                    MS_RANK_CR, fleet=fleet)
              for fleet in fleets}
    part("b single device")

    def spawned(n):
        t0 = time.perf_counter()
        ranks = spawn(mesh_rank, n, dev.type, backend="gloo", timeout=600,
                      args=(MESH_RANK_LANES, MS_RANK_ROUNDS, MS_RANK_CR,
                            fleets))
        return ranks, time.perf_counter() - t0

    # both meshes at once (independent groups, 6 processes on the card)
    with ThreadPoolExecutor(max_workers=len(MS_SIZES)) as pool:
        meshes = dict(zip(MS_SIZES, pool.map(spawned, MS_SIZES)))
    part("b gloo ranks")
    for n in MS_SIZES:
        ranks, spawn_s = meshes[n]
        res = {"spawn_s": spawn_s}
        for fleet in fleets:
            for name, lane, kind in MESH_RANK_LANES:
                if name not in single[fleet]:
                    continue
                r0 = ranks[0][fleet][name]
                want = single[fleet][name]
                drift, bits = mesh_drift(r0, want)
                row = {"ms_per_round": r0["ms"], "drift": drift,
                       "drift_bits": bits,
                       "final_loss_drift": abs(r0["losses"][-1]
                                               - want["losses"][-1]),
                       "replicated": all(
                           (r[fleet][name]["w"] == r0["w"]).all()
                           for r in ranks[1:]),
                       "launches": r0["launches"],
                       "eager_chunks": bool(r0["plan"].get("eager_chunks"))}
                tag = f"gloo {n} {fleet} {name}"
                if name == "hook":
                    # each rank trains its block of every tier through
                    # client_step, one launch a non-empty block; rank 0's
                    # block is never empty, so it launches as often as one
                    # device does
                    row["client_step_launches"] = [
                        r[fleet][name]["client_step_launches"]
                        for r in ranks]
                    row["client_step_single"] = want["client_step_launches"]
                    if dev.type == "cuda" and (
                            not want["client_step_launches"]
                            or row["client_step_launches"][0]
                            != want["client_step_launches"]):
                        failures.append(
                            f"{tag}: client_step launches "
                            f"{row['client_step_launches']} a rank, "
                            f"{want['client_step_launches']} on one device")
                if lane == "device":
                    row["nbytes"] = [r[fleet][name]["nbytes"] for r in ranks]
                    row["per_device_nbytes"] = r0["plan"][
                        "per_device_nbytes"]
                    if any(b != row["per_device_nbytes"]
                           for b in row["nbytes"]):
                        failures.append(
                            f"{tag}: corpus bytes {row['nbytes']} vs "
                            f"per_device_nbytes {row['per_device_nbytes']}")
                    if dev.type == "cuda" and not row["eager_chunks"]:
                        failures.append(f"{tag}: chunks not eager in the "
                                        f"record {r0['plan']}")
                if not row["replicated"]:
                    failures.append(f"{tag}: the ranks' params differ")
                if r0["launches"] != MS_RANK_ROUNDS:
                    failures.append(f"{tag}: {r0['launches']} "
                                    f"fedmom_update launches")
                if fleet == "linreg" and drift > MESH_ATOL:
                    failures.append(f"{tag}: drift {drift}")
                if fleet == "lenet" and kind is None and (
                        row["final_loss_drift"] > MS_LENET_LOSS_TOL):
                    failures.append(f"{tag}: final-loss drift "
                                    f"{row['final_loss_drift']}")
                if fleet == "linreg" and name == "masked" and bits:
                    failures.append(f"{tag}: masked differs from one "
                                    f"device's in {bits} parameters")
                res[f"{fleet}_{name}"] = row
            bits = mesh_drift(ranks[0][fleet]["masked"],
                              ranks[0][fleet]["open"])[1]
            res[f"{fleet}_masked_vs_open_drift_bits"] = bits
            if bits:
                failures.append(f"gloo {n} {fleet}: masked differs from "
                                f"the open ring in {bits} parameters")
        out["b"][str(n)] = res
        out["ran"].append(f"{n} ranks on gloo, sharing one card")
        print(f"gloo x{n} (spawned and run in {res['spawn_s']:.1f} s):")
        for k, v in res.items():
            if isinstance(v, dict):
                fl = v["final_loss_drift"]
                print(f"  {k:16s} {v['ms_per_round']:8.2f} ms/round, drift "
                      f"{v['drift']:.3e} (final loss {fl:.3e}; "
                      f"{v['drift_bits']} params differ in a bit)"
                      + (f", bytes/rank {v['nbytes']} = per_device_nbytes "
                         f"{v['per_device_nbytes']}" if "nbytes" in v
                         else ""))
        print(f"  masked vs open ring: lenet "
              f"{res['lenet_masked_vs_open_drift_bits']}, linreg "
              f"{res['linreg_masked_vs_open_drift_bits']} drift bits")


def mesh_nccl(dev, out, part, failures):
    """Phase 22(c): NCCL at 2 and 4 ranks, one card a rank, where the
    cards allow, on the device plane (chunks captured with their
    collectives and the batch exchange): the reference's linreg mesh-test
    fleet against one device (1e-6), and BENCH_10's LeNet timed after a
    warm-up run (final loss within ``bench_mesh``'s 1e-4)."""
    import torch
    from repro_torch.launch.mesh import spawn
    n_cards = torch.cuda.device_count()
    print(f"(c) NCCL at {MS_SIZES} ranks on the device plane, one card a "
          f"rank: {n_cards} card(s) visible")
    lanes = (("device", "device", None),)
    for n in MS_SIZES:
        if n > n_cards:
            why = (f"not run: {n} NCCL ranks need {n} cards and "
                   f"{n_cards} are visible (NCCL runs one rank a card)")
            out["c"][str(n)] = why
            print(f"NCCL x{n}: {why}")
            continue
        t0 = time.perf_counter()
        ranks = spawn(mesh_rank, n, "cuda", timeout=600,
                      args=(lanes, MS_RANK_ROUNDS, MS_RANK_CR, ("linreg",)))
        lin = ranks[0]["linreg"]["device"]
        lin_drift, lin_bits = mesh_drift(lin, mesh_lane_runs(
            dev, lanes, MS_RANK_ROUNDS, MS_RANK_CR, fleet="linreg")["device"])
        ranks = spawn(mesh_rank, n, "cuda", timeout=600,
                      args=(lanes, MS_ROUNDS, MS_CR, ("lenet",), True))
        lenet = ranks[0]["lenet"]["device"]
        want = mesh_lane_runs(dev, lanes, MS_ROUNDS, MS_CR, warm=True)[
            "device"]
        loss_drift = abs(lenet["losses"][-1] - want["losses"][-1])
        row = {"linreg_drift": lin_drift, "linreg_drift_bits": lin_bits,
               "lenet_ms_per_round": lenet["ms"],
               "single_ms_per_round": want["ms"],
               "lenet_final_loss_drift": loss_drift,
               "lenet_launches": lenet["launches"],
               "nbytes": [r["lenet"]["device"]["nbytes"] for r in ranks],
               "per_device_nbytes": lenet["plan"]["per_device_nbytes"],
               "replicated": all((r["lenet"]["device"]["w"]
                                  == lenet["w"]).all() for r in ranks[1:]),
               "eager_chunks": bool(lenet["plan"].get("eager_chunks")),
               "wall_s": time.perf_counter() - t0}
        out["c"][str(n)] = row
        out["ran"].append(f"{n} ranks on NCCL")
        print(f"NCCL x{n}: linreg drift {lin_drift:.3e} ({lin_bits} params "
              f"differ in a bit); BENCH_10 LeNet device plane "
              f"{lenet['ms']:.3f} ms/round against {want['ms']:.3f} on one "
              f"card (a second run each, host clock), final-loss drift "
              f"{loss_drift:.3e}, bytes/rank {row['nbytes']} = "
              f"per_device_nbytes {row['per_device_nbytes']}; "
              f"{row['wall_s']:.1f} s")
        if lin_drift > MESH_ATOL:
            failures.append(f"NCCL {n}: linreg drift {lin_drift}")
        if loss_drift > MS_LENET_LOSS_TOL:
            failures.append(f"NCCL {n}: LeNet final-loss drift {loss_drift}")
        if row["eager_chunks"] or not row["replicated"] or any(
                b != row["per_device_nbytes"] for b in row["nbytes"]):
            failures.append(f"NCCL {n}: record, replication or bytes {row}")
    part("c")

# ---------------------------------------------------------------------------
# phase 23: the rest of the zoo (MoE, encoder-decoder, VLM)
# ---------------------------------------------------------------------------
class RouteRecorder:
    """Records every MoE routing (``layers.moe_routes``) of the calls made
    inside it, in call order: (expert ids [G,k], slots [G,k], keep [G,k],
    the top-k margin [G]) on the host, a call's groups (the MoE node
    routes all of a layer's groups at once) flattened in token order."""

    def __init__(self):
        from repro_torch.models import layers
        self.layers, self.routes = layers, []

    def __enter__(self):
        import torch
        inner = self.original = self.layers.moe_routes

        def recording(xf, router, **kw):
            out = inner(xf, router, **kw)
            probs, idx, _, pos, keep = (t.reshape(-1, t.shape[-1])
                                        for t in out[:5])
            k = idx.shape[-1]
            top = torch.sort(probs, dim=-1, descending=True).values
            margin = (top[:, k - 1] - top[:, k]) if top.shape[-1] > k \
                else torch.full_like(top[:, 0], float("inf"))
            self.routes.append(tuple(t.cpu() for t in (idx, pos, keep,
                                                       margin)))
            return out
        self.layers.moe_routes = recording
        return self

    def __exit__(self, *exc):
        self.layers.moe_routes = self.original


def route_flips(a, b, batch):
    """Routes of two runs (``RouteRecorder.routes``) compared call by call:
    (the (token, slot) routes whose expert, slot or keep differ, the batch
    rows holding none of them, the smallest top-k margin among flipped
    tokens).  A call's G tokens are ``batch`` rows of G / batch."""
    import torch
    flips, bad, margin = 0, set(), float("inf")
    if len(a) != len(b):
        raise AssertionError(f"{len(a)} against {len(b)} MoE routings")
    for (ia, pa, ka, ma), (ib, pb, kb, _) in zip(a, b):
        diff = (ia != ib) | (pa != pb) | (ka != kb)          # [G, k]
        flips += int(diff.sum())
        tok = diff.any(-1)
        per_row = tok.shape[0] // batch
        bad |= {int(i) // per_row for i in torch.nonzero(tok).flatten()}
        if bool(tok.any()):
            margin = min(margin, float(ma[tok].min()))
    return flips, sorted(set(range(batch)) - bad), margin


def zoo_init(name, cfg, dev):
    """Keyed random weights on the card; (params, seconds, bytes)."""
    import torch
    from repro_torch import random as prng
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, _ = T.init(cfg, prng.PRNGKey(0), device=dev)
    sync(dev)
    init_s = time.perf_counter() - t0
    n = sum(x.numel() for x in leaves(params))
    nbytes = sum(x.numel() * x.element_size() for x in leaves(params))
    print(f"{name}: {cfg.n_layers} layers (+{cfg.n_enc_layers} encoder), "
          f"d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, "
          f"d_head {cfg.d_head}, d_ff {cfg.d_ff}"
          + (f", {cfg.moe.n_experts} experts top-{cfg.moe.top_k}"
             if cfg.moe else "")
          + f", vocab {cfg.vocab}, {cfg.dtype}; keyed init {n} params, "
          f"{nbytes / 1e9:.3f} GB, {init_s:.2f} s")
    return params, init_s, n


def flash_calls(fa_ops):
    """A recorder of ``flash_attention``'s calls through the model (the
    blocks look it up on ``ops`` at each call): (S, causal) a call."""
    seen = []
    inner = fa_ops.flash_attention

    def recording(q, k, v, *, causal, window):
        seen.append((q.shape[1], causal))
        return inner(q, k, v, causal=causal, window=window)

    class Ctx:
        def __enter__(self):
            fa_ops.flash_attention = recording
            return seen

        def __exit__(self, *exc):
            fa_ops.flash_attention = inner
    return Ctx()


def zoo_serve(name, params, cfg, prompts, extras, n_new, fa_kernel, fa_ops,
              want_calls, profile=False):
    """Warm-up, then one timed ``generate`` with the kernel's launches
    counted over exactly that call: (record, result)."""
    import numpy as np
    import torch
    from repro_torch.serve import generate
    dev = params["embed"].device
    generate(params, cfg, prompts, 2, extras=extras)           # warm-up
    sync(dev)
    torch.cuda.reset_peak_memory_stats()
    fa_kernel.launches = 0
    with flash_calls(fa_ops) as calls:
        t0 = time.perf_counter()
        res = generate(params, cfg, prompts, n_new, extras=extras)
        sync(dev)
        total_s = time.perf_counter() - t0
    launches = fa_kernel.launches
    peak = torch.cuda.max_memory_allocated()
    if launches != len(want_calls) or sorted(calls) != sorted(want_calls):
        raise AssertionError(f"{name}: flash_attention launched {launches} "
                             f"times ({calls}), want {want_calls}")
    B, S0 = prompts.shape
    if res.tokens.shape != (B, S0 + n_new) or not np.isfinite(
            res.logprobs).all() or not (res.logprobs[:, :-1] <= 0).all():
        raise AssertionError(f"{name} generate: tokens {res.tokens.shape}, "
                             f"logprobs {res.logprobs}")
    if not ((res.tokens >= 0) & (res.tokens < cfg.vocab)).all():
        raise AssertionError(f"{name} generate: token ids out of range")
    # the prefill alone (cache allocation included) for time to first token
    from repro_torch.models import transformer as T
    t0 = time.perf_counter()
    cache, _ = T.init_cache(cfg, B, S0 + n_new, device=dev)
    batch = {"tokens": torch.as_tensor(prompts, device=dev)}
    batch.update({k: torch.as_tensor(v, device=dev)
                  for k, v in extras.items()})
    with torch.no_grad():
        T.prefill(params, cfg, batch, cache)
    sync(dev)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    del cache
    decode_ms = (total_s * 1e3 - prefill_ms) / max(n_new - 1, 1)
    row = {"generate_ms": total_s * 1e3, "prefill_ms": prefill_ms,
           "decode_ms_per_token": decode_ms,
           "tokens_per_s": B * n_new / total_s, "peak_memory_gb": peak / 1e9,
           "launches": launches,
           "launches_causal": sum(1 for _, c in calls if c),
           "launches_noncausal": sum(1 for _, c in calls if not c)}
    line = (f"{name} generate B={B} S0={S0} new={n_new} greedy: "
            f"{row['generate_ms']:.1f} ms (host clock, synced); prefill "
            f"{prefill_ms:.1f} ms; decode {decode_ms:.2f} ms/token; "
            f"{row['tokens_per_s']:.1f} tokens/s; peak {peak / 1e9:.2f} GB; "
            f"flash_attention {launches} launches ({row['launches_causal']} "
            f"causal, {row['launches_noncausal']} non-causal)")
    if profile:
        wall, busy, n_ops, top = profile_device(
            lambda: generate(params, cfg, prompts, n_new, extras=extras))
        row.update(device_busy_share=busy / wall, device_ops=n_ops,
                   top=[(k[:90], round(s * 1e3, 3), c) for k, s, c in top])
        line += (f"; profiled call: busy {100 * busy / wall:.1f}%, {n_ops} "
                 f"device ops; top {row['top'][:4]}")
    print(line)
    return row, res


def flash_at(fa_ops, fa_kernel, card, tag, B, S, Hq, Hkv, d, causal):
    """The kernel against its plain version at one of this phase's shapes
    (bf16, no window), SDPA held to the plain version too, then device
    times of the kernel, the plain version and SDPA (graph replays) beside
    the bound."""
    import numpy as np
    import torch
    dev = torch.device("cuda")
    rng = np.random.default_rng(S + Hq)
    q, k, v = (torch.as_tensor(rng.normal(size=(B, S, h, d)).astype(
        np.float32), device=dev).to(torch.bfloat16) for h in (Hq, Hkv, Hkv))
    call_k = lambda: fa_ops.flash_attention(  # noqa: E731
        q, k, v, causal=causal, window=0)
    call_p = lambda: fa_ops.flash_attention(  # noqa: E731
        q, k, v, causal=causal, window=0, use_kernel=False)
    out, ref = call_k(), call_p()
    sync(dev)
    err = float((out.float() - ref.float()).abs().max())
    if not (err <= FA_ATOL["bfloat16"] and bool(torch.isfinite(out).all())):
        raise AssertionError(f"flash_attention at {tag}: kernel differs from "
                             f"the plain version by {err:.3e}")
    call_l = sdpa_call(q, k, v, causal, 0)
    lib_err = float((call_l().transpose(1, 2).float()
                     - ref.float()).abs().max())
    if not lib_err <= FA_ATOL["bfloat16"]:
        raise AssertionError(f"sdpa at {tag} differs from the plain version "
                             f"by {lib_err:.3e}: not the same function")
    ms = graph_ms(call_k, iters=10, replays=10)
    plain_ms = graph_ms(call_p, iters=3, replays=3)
    lib_ms = graph_ms(call_l, iters=10, replays=10)
    bytes_ms, ops_ms = flash_bound_ms(B, S, Hq, Hkv, d, 0, causal, 2)
    bound_ms = max(bytes_ms, ops_ms)
    row = {"shape": [B, S, Hq, Hkv, d], "causal": causal,
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "library_ms": lib_ms, "bound_ms": bound_ms,
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    print(f"flash_attention at {tag} (B={B} S={S} Hq={Hq} Hkv={Hkv} d={d} "
          f"bf16 causal={causal}): max abs err {err:.3e} (atol "
          f"{FA_ATOL['bfloat16']}); kernel {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, sdpa {lib_ms:.4f} ms (device; sdpa vs plain {lib_err:.2e}), "
          f"bound {bound_ms:.4f} ms "
          f"({row['bound_by']}), {100 * bound_ms / ms:.1f}% of it [{card}]")
    del q, k, v, out, ref
    torch.cuda.empty_cache()
    return row


def moe_breakdown(p, cfg, card):
    """Device times (graph replays) of one MoE group's stages at granite's
    training group (2 x 1,024 fp32 tokens, the benchmark's cell),
    unit-normal tokens and layer 0's weights: the routing (fp32 router, softmax, top-k, slot counts), the
    index tables, the ``moe_route`` kernels of the forward and the backward
    (dispatch, combine; the combine's dy into the slots and gate dots, the
    dispatch's dx) each beside its bytes bound and its plain version, the
    experts, the whole ``layers._moe_group``, and the dense one-hot
    dispatch and combine that the kernels replace (the tensors and the two
    products) as the yardstick, beside the stages' flops."""
    import torch
    from repro_torch.kernels.moe_route import kernel as mr_kernel
    from repro_torch.kernels.moe_route import ops as mr_ops
    from repro_torch.kernels.moe_route import ref as mr_ref
    from repro_torch.models import layers as L
    dev = p["router"].device
    E, k, D = cfg.moe.n_experts, cfg.moe.top_k, cfg.d_model
    kw = dict(n_experts=E, top_k_=k, capacity_factor=cfg.moe.capacity_factor)
    out = {}
    for tag, G, dt in (("train_fp32", 2 * 1024, torch.float32),):
        pw = {n: v if n == "router" else v.to(dt) for n, v in p.items()}
        gen = torch.Generator(device=dev).manual_seed(0)
        xf = torch.randn((G, D), generator=gen, device=dev).to(dt)
        dy = torch.randn((G, D), generator=gen, device=dev).to(dt)
        _, idx, gv, pos, keep, cap, onehot = L.moe_routes(xf, pw["router"],
                                                          **kw)
        slot, owner = mr_ops.route_tables(idx, pos, keep, cap, E)
        S, kept = E * cap, int(keep.sum())
        xe = mr_ops.gather_rows(xf[None], owner[None], None, k)[0]
        ye = L.moe_experts(pw, xe.reshape(E, cap, D), cfg.act).reshape(S, D)
        w = gv.to(dt)
        one = [t[None] for t in (xf, dy, ye, slot, owner, w)]
        x1, dy1, ye1, s1, o1, w1 = one
        es = xf.element_size()
        # each kernel's least traffic: rows read once, tables, the output
        kernels = {
            "dispatch": (lambda: mr_kernel.gather_rows(x1, o1, None, k),
                         lambda: mr_ref.gather_rows(x1, o1, None, k),
                         (S + G) * D * es + 4 * S),
            "combine": (lambda: mr_kernel.sum_rows(ye1, s1, w1),
                        lambda: mr_ref.sum_rows(ye1, s1, w1),
                        (kept + G) * D * es + (4 + es) * G * k),
            "combine_dye": (lambda: mr_kernel.gather_rows(dy1, o1, w1, k),
                            lambda: mr_ref.gather_rows(dy1, o1, w1, k),
                            (S + G) * D * es + 4 * S + es * G * k),
            "gate_dots": (lambda: mr_kernel.route_dots(dy1, ye1, s1),
                          lambda: mr_ref.route_dots(dy1, ye1, s1),
                          (kept + G) * D * es + (4 + es) * G * k),
            "dispatch_dx": (lambda: mr_kernel.sum_rows(ye1, s1, None),
                            lambda: mr_ref.sum_rows(ye1, s1, None),
                            (kept + G) * D * es + 4 * G * k)}
        row = {"G": G, "capacity": cap, "kept_routes": kept, "kernels": {}}
        for name, (kern, plain, nbytes) in kernels.items():
            if not torch.equal(kern(), plain()):
                raise AssertionError(f"moe_route {name} at {tag} differs "
                                     f"from its plain version")
            row["kernels"][name] = {
                "ms": graph_ms(kern, iters=20, replays=10),
                "plain_ms": graph_ms(plain, iters=2, replays=3),
                "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
                "bytes": nbytes}
        dispatch, combine = L.moe_dispatch(onehot, gv, pos, keep, cap)
        dd, cc = dispatch.to(dt), combine.to(dt)
        ye3 = ye.reshape(E, cap, D)
        stages = {
            "routing": lambda: L.moe_routes(xf, pw["router"], **kw),
            "tables": lambda: mr_ops.route_tables(idx, pos, keep, cap, E),
            "experts": lambda: L.moe_experts(pw, xe.reshape(E, cap, D),
                                             cfg.act),
            "group": lambda: L._moe_group(pw, xf, act=cfg.act, **kw),
            "dense_tensors": lambda: [t.to(dt) for t in L.moe_dispatch(
                onehot, gv, pos, keep, cap)],
            "dense_dispatch_product": lambda: torch.einsum(
                "gec,gd->ecd", dd, xf),
            "dense_combine_product": lambda: torch.einsum(
                "gec,ecd->gd", cc, ye3)}
        row.update({name: graph_ms(fn, iters=5, replays=5)
                    for name, fn in stages.items()})
        n_w = 3 if cfg.act in ("swiglu", "geglu") else 2
        row["flops"] = {"dense_product": 2 * G * E * cap * D,
                        "experts": 2 * n_w * E * cap * D * cfg.d_ff}
        ks = row["kernels"]
        print(f"MoE group at {tag}: G={G}, E={E}, top-{k}, C={cap}, D={D}, "
              f"F={cfg.d_ff} ({kept} of {G * k} routes kept; device ms, "
              f"graph replays): "
              + ", ".join(f"{n} {v['ms']:.4f} (bound {v['bound_ms']:.4f}, "
                          f"{100 * v['bound_ms'] / v['ms']:.0f}%; plain "
                          f"{v['plain_ms']:.3f})" for n, v in ks.items())
              + "; " + ", ".join(f"{n} {row[n]:.3f}" for n in stages)
              + f"; the dense products {row['flops']['dense_product']:.3e} "
              f"flops each, the experts {row['flops']['experts']:.3e} "
              f"[{card}]")
        out[tag] = row
        del xf, dy, xe, ye, one, dispatch, combine, dd, cc, ye3
        torch.cuda.empty_cache()
    return out


def moe_route_entry(granite):
    """The kernels line's ``moe_route`` entry: the launches in the zoo's
    full-size granite rounds (the main path) and phase 23's times at the
    training group, each kernel beside its bytes bound and plain
    version."""
    ks = granite["moe_stages_ms"]["train_fp32"]["kernels"]
    return {
        "name": "moe_route",
        "route": "cuda",
        "source": "src/repro_torch/csrc/moe_route.cu",
        "replaces": "src/repro/models/layers.py moe_apply (the dense "
                    "gec,gd->ecd and gec,ecd->gd einsums; no TPU kernel)",
        "launches": granite["rounds"]["moe_route_launches"],
        "max_abs_err": 0.0,
        "ms": {n: v["ms"] for n, v in ks.items()},
        "plain_ms": {n: v["plain_ms"] for n, v in ks.items()},
        "bound_ms": {n: v["bound_ms"] for n, v in ks.items()},
        "bound_by": "bytes",
        "library_ms": None,
    }


def zoo_extras(cfg, B, S0, rng):
    sys.path.insert(0, str(ROOT / "examples"))
    import serve_demo_torch
    return serve_demo_torch.extras_for(cfg, B, S0, rng)


def granite_phase(dev, fa_kernel, fa_ops, fm_kernel, fm_ops, fm_ref, card):
    """(a): granite-moe-1b-a400m, nothing cut: ``generate``, ``loss_fn``,
    the kernel at its 16/8 head layout against its plain version, 3 FedMom
    rounds of ``round_step`` in fp32 with ``fedmom_update`` on the rounds'
    expert-stack tree held bit-equal to the plain server step, and reduced
    granite through ``FederatedTrainer`` on ``auto`` (captured chunks)
    against the per-round plane."""
    import dataclasses as dc
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import (DeviceUniformSampler, RoundConfig, fedmom,
                                  round_step)
    from repro_torch import random as prng
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves
    cfg = get_config(ZOO_MOE).replace(attention_impl="pallas")
    params, init_s, n = zoo_init(ZOO_MOE, cfg, dev)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (ZOO_B, ZOO_S0))
    out = {"n_params": n, "init_s": init_s}
    out["generate"], _ = zoo_serve(
        ZOO_MOE, params, cfg, prompts, {}, ZOO_NEW, fa_kernel, fa_ops,
        [(ZOO_S0, True)] * cfg.n_layers, profile=True)
    tokens = torch.as_tensor(prompts, device=dev)
    batch = {"tokens": tokens, "labels": tokens}
    with torch.no_grad():
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            loss, m = T.loss_fn(params, cfg, batch)
            sync(dev)
            times.append(time.perf_counter() - t0)
    if not math.isfinite(float(loss)):
        raise AssertionError(f"{ZOO_MOE} loss_fn: {float(loss)}")
    out["loss_ms"] = statistics.median(times) * 1e3
    out["loss"], out["aux"] = float(loss), float(m["aux"])
    with torch.no_grad():
        wall, rows = profile_rows(lambda: T.loss_fn(params, cfg, batch))
    busy = sum(r[1] for r in rows)
    out["loss_busy_share"] = busy / wall
    from repro_torch.models.layers import MOE_GROUP
    print(f"{ZOO_MOE} loss_fn B={ZOO_B} x {ZOO_S0} (MoE groups of "
          f"{MOE_GROUP} tokens): {out['loss_ms']:.1f} ms (median of 3, "
          f"synced), "
          f"loss {out['loss']:.4f}, aux {out['aux']:.4f}; profiled: busy "
          f"{100 * busy / wall:.1f}%; top kernels:")
    for kname, secs, count in rows[:8]:
        print(f"  {secs * 1e3:8.3f} ms  {count:6d}x  {kname[:100]}")
    out["loss_top"] = [(k[:90], round(s * 1e3, 3), c) for k, s, c in rows[:8]]
    out["moe_stages_ms"] = moe_breakdown(
        {k: v[0] for k, v in params["groups"]["b0"]["mlp"].items()}, cfg,
        card)
    del params, batch, tokens
    torch.cuda.empty_cache()
    out["flash_heads"] = flash_at(
        fa_ops, fa_kernel, card, f"{ZOO_MOE}'s head layout", ZOO_B, ZOO_S0,
        cfg.n_heads, cfg.n_kv_heads, cfg.d_head, True)

    # 3 FedMom rounds at full size in fp32
    fcfg = dc.replace(cfg, dtype="float32", attention_impl="xla")
    params, axes = T.init(fcfg, prng.PRNGKey(0), device=dev)
    toks = rng.integers(0, cfg.vocab,
                        (ZOO_ROUNDS, ZOO_M, ZOO_H, ZOO_RB, ZOO_RS + 1))
    batches = [{"tokens": torch.as_tensor(t[..., :-1], dtype=torch.int32,
                                          device=dev),
                "labels": torch.as_tensor(t[..., 1:], dtype=torch.int32,
                                          device=dev)} for t in toks]
    weights = torch.full((ZOO_M,), 1.0 / ZOO_M, device=dev)
    opt = fedmom(eta=1.0, beta=BETA, use_fused_kernel=True)
    rcfg = RoundConfig(clients_per_round=ZOO_M, local_steps=ZOO_H, lr=GT_LR,
                       placement="mesh", compute_dtype="float32")
    state = opt.init(params)
    router0 = params["groups"]["b0"]["mlp"]["router"].clone()
    torch.cuda.reset_peak_memory_stats()
    from repro_torch.kernels.moe_route import kernel as mr_kernel
    fm_kernel.launches = mr_kernel.launches = 0
    times, losses = [], []
    for r in range(ZOO_ROUNDS):
        t0 = time.perf_counter()
        state, m = round_step(lambda p, b: T.loss_fn(p, fcfg, b), opt, state,
                              batches[r], weights, rcfg, param_axes=axes,
                              device=dev)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
    launches, mr_launches = fm_kernel.launches, mr_kernel.launches
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{ZOO_MOE} rounds: losses {losses}")
    if torch.equal(state.w["groups"]["b0"]["mlp"]["router"], router0):
        raise AssertionError(f"{ZOO_MOE} rounds: the router did not move")
    sizes = [x.numel() for x in leaves(state.w)]
    tables = len(fm_kernel.tree_plan(sizes, [True] * len(sizes)))
    if launches != ZOO_ROUNDS * tables:
        raise AssertionError(f"{ZOO_MOE} rounds: fedmom_update {launches} "
                             f"launches, want {tables} a round")
    # a layer's step: the forward's dispatch and combine, the remat
    # recompute's again, the backward's combine dy, gate dots and dispatch
    # dx; both clients folded into each launch
    mr_want = ZOO_ROUNDS * ZOO_H * cfg.n_layers * 7
    if mr_launches != mr_want:
        raise AssertionError(f"{ZOO_MOE} rounds: moe_route {mr_launches} "
                             f"launches, want {mr_want}")
    out["rounds"] = {"ms_per_round": statistics.median(times[1:]) * 1e3,
                     "first_round_ms": times[0] * 1e3, "losses": losses,
                     "peak_gb": peak / 1e9, "fedmom_update_launches":
                         launches, "moe_route_launches": mr_launches,
                     "tree_leaves": len(sizes),
                     "tree_elements": sum(sizes)}
    print(f"{ZOO_MOE} fp32, {ZOO_ROUNDS} FedMom rounds of round_step "
          f"(M={ZOO_M} "
          f"H={ZOO_H} b={ZOO_RB} seq {ZOO_RS}, fused server): "
          f"{out['rounds']['ms_per_round']:.1f} ms/round (median of rounds "
          f"2-{ZOO_ROUNDS}; first {times[0] * 1e3:.1f} ms), peak "
          f"{peak / 1e9:.2f} GB, losses {losses}, the server moved (router "
          f"included); fedmom_update {launches} launches ({tables} a round "
          f"over {len(sizes)} leaves, {sum(sizes)} elements); moe_route "
          f"{mr_launches} launches")
    del params, batches
    torch.cuda.empty_cache()
    out["tree"] = lm_tree_check(ZOO_MOE, state.w, state.extra["v"],
                                fm_kernel, fm_ops, fm_ref, 1.0, 5)
    del state
    torch.cuda.empty_cache()

    # reduced granite on auto (captured chunks) against the per-round plane
    from repro_torch.data import lm_clients_to_dataset, synthetic_token_clients
    from repro_torch.launch.plan import ExecutionPlan
    from repro_torch.launch.train import FederatedTrainer
    rcfg_ = get_config(ZOO_MOE).reduced().replace(dtype="float32")
    w0, axes = T.init(rcfg_, prng.PRNGKey(0), device=dev)
    ds = lm_clients_to_dataset(synthetic_token_clients(
        16, rcfg_.vocab, tokens_per_client=20_000, seed=0), 128, seed=1)
    pop = ds.population()
    runs = {}
    for plane in ("per_round", "auto"):
        o = fedmom(eta=pop.n_clients / 4, beta=BETA, use_fused_kernel=True)
        tr = FederatedTrainer(
            loss_fn=lambda p, b: T.loss_fn(p, rcfg_, b), server_opt=o,
            rcfg=RoundConfig(clients_per_round=4, local_steps=2, lr=0.05,
                             placement="mesh", compute_dtype="float32"),
            dataset=ds, sampler=DeviceUniformSampler(pop, 4, seed=2),
            state=o.init(clone_tree(w0)), param_axes=axes, local_batch=4,
            device=dev)
        plan = (None if plane == "per_round"
                else ExecutionPlan(plane="auto", chunk_rounds=ZOO_CR))
        t0 = time.perf_counter()
        tr.run(ZOO_TR_ROUNDS, plan=plan, verbose=False)
        sync(dev)
        runs[plane] = (tr, time.perf_counter() - t0)
    tr = runs["auto"][0]
    resolved = tr.session.plan_log[-1]["plane"]
    graphs = sum(1 for g in tr.session.graphs.values()
                 if g.graph is not None)
    if resolved != "device" or graphs < 1:
        raise AssertionError(f"reduced {ZOO_MOE} auto: {resolved}, {graphs} "
                             f"captured chunk shapes")
    la = [r["loss"] for r in tr.history if "loss" in r]
    lp = [r["loss"] for r in runs["per_round"][0].history if "loss" in r]
    drift = tree_max_abs(tr.state.w, runs["per_round"][0].state.w)
    if not (all(math.isfinite(x) for x in la) and len(la) == len(lp)):
        raise AssertionError(f"reduced {ZOO_MOE}: losses {la} / {lp}")
    out["trainer"] = {"resolved": resolved, "captured": graphs,
                      "drift": drift, "loss_drift": max(
                          abs(a - b) for a, b in zip(la, lp)),
                      "auto_s": runs["auto"][1],
                      "per_round_s": runs["per_round"][1]}
    print(f"reduced {ZOO_MOE} through FederatedTrainer, {ZOO_TR_ROUNDS} "
          f"rounds "
          f"(M=4 H=2 b=4 seq 128, chunks of {ZOO_CR}): auto -> {resolved}, "
          f"{graphs} chunk shape(s) captured, {runs['auto'][1]:.2f} s; "
          f"per-round {runs['per_round'][1]:.2f} s; final params drift "
          f"{drift:.3e}, losses drift {out['trainer']['loss_drift']:.3e} "
          f"(the embedding's backward scatters with atomics)")
    del runs, tr, w0
    torch.cuda.empty_cache()
    return out


def whisper_phase(dev, fa_kernel, fa_ops, card):
    """(b): whisper-medium, nothing cut: ``generate`` over stubbed frames
    (24 non-causal encoder and 24 causal decoder prefill launches), and
    the kernel alone at the encoder's shape."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = get_config(ZOO_ENCDEC).replace(attention_impl="pallas")
    params, init_s, n = zoo_init(ZOO_ENCDEC, cfg, dev)
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, cfg.vocab, (ZOO_B, ZOO_S0))
    extras = zoo_extras(cfg, ZOO_B, ZOO_S0, rng)
    want = ([(T.ENC_LEN, False)] * cfg.n_enc_layers
            + [(ZOO_S0, True)] * cfg.n_layers)
    out = {"n_params": n, "init_s": init_s}
    out["generate"], _ = zoo_serve(ZOO_ENCDEC, params, cfg, prompts, extras,
                                   ZOO_NEW, fa_kernel, fa_ops, want)
    del params
    torch.cuda.empty_cache()
    out["flash_encoder"] = flash_at(
        fa_ops, fa_kernel, card, f"{ZOO_ENCDEC}'s encoder", ZOO_B, T.ENC_LEN,
        cfg.n_heads, cfg.n_kv_heads, cfg.d_head, False)
    return out


def qwen2_vl_phase(dev, fa_kernel, fa_ops, card):
    """(c): qwen2-vl-72b at full width cut to ZOO_VLM_LAYERS layers:
    ``generate`` with 256 stubbed patches and their M-RoPE grid, and the
    kernel at its 64/8 head layout against its plain version."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    cfg = get_config(ZOO_VLM).replace(attention_impl="pallas",
                                    n_layers=ZOO_VLM_LAYERS)
    params, init_s, n = zoo_init(f"{ZOO_VLM} cut to {ZOO_VLM_LAYERS} layers",
                                 cfg, dev)
    rng = np.random.default_rng(2)
    prompts = rng.integers(0, cfg.vocab, (ZOO_B, ZOO_S0))
    extras = zoo_extras(cfg, ZOO_B, ZOO_S0, rng)
    out = {"n_params": n, "init_s": init_s,
           "patches": int(extras["patches"].shape[1])}
    out["generate"], _ = zoo_serve(ZOO_VLM, params, cfg, prompts, extras,
                                   ZOO_NEW, fa_kernel, fa_ops,
                                   [(ZOO_S0, True)] * cfg.n_layers)
    del params
    torch.cuda.empty_cache()
    out["flash_heads"] = flash_at(
        fa_ops, fa_kernel, card, f"{ZOO_VLM}'s head layout", ZOO_B, ZOO_S0,
        cfg.n_heads, cfg.n_kv_heads, cfg.d_head, True)
    return out


def grok_phase(dev, fa_kernel, fa_ops, card):
    """(d): grok-1-314b at full width cut to ZOO_GROK_LAYERS layers: a
    prefill of B=8 x 1024 (2 MoE groups), 8 decode tokens; and the kernel
    at its 48/8 head layout against its plain version."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = get_config(ZOO_GROK).replace(attention_impl="pallas",
                                     n_layers=ZOO_GROK_LAYERS)
    params, init_s, n = zoo_init(f"{ZOO_GROK} cut to {ZOO_GROK_LAYERS} layers",
                                 cfg, dev)
    tokens = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (ZOO_B, ZOO_S0 + ZOO_GROK_NEW)), device=dev)
    out = {"n_params": n, "init_s": init_s}
    with torch.no_grad():
        for timed in (False, True):
            cache, _ = T.init_cache(cfg, ZOO_B, ZOO_S0 + ZOO_GROK_NEW,
                                    device=dev)
            fa_kernel.launches = 0
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            logits, cache = T.prefill(params, cfg,
                                      {"tokens": tokens[:, :ZOO_S0]}, cache)
            sync(dev)
            t1 = time.perf_counter()
            for i in range(ZOO_S0, ZOO_S0 + ZOO_GROK_NEW):
                logits, cache = T.decode_step(params, cfg, cache,
                                              tokens[:, i:i + 1], i)
            sync(dev)
            t2 = time.perf_counter()
            del cache
    finite = bool(torch.isfinite(logits).all())
    if fa_kernel.launches != cfg.n_layers or not finite:
        raise AssertionError(f"{ZOO_GROK}: {fa_kernel.launches} launches, "
                             f"finite logits {finite}")
    out.update(prefill_ms=(t1 - t0) * 1e3,
               decode_ms_per_token=(t2 - t1) * 1e3 / ZOO_GROK_NEW,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=fa_kernel.launches)
    print(f"{ZOO_GROK} cut to {ZOO_GROK_LAYERS} layers: prefill B={ZOO_B} x "
          f"{ZOO_S0} {out['prefill_ms']:.1f} ms, {ZOO_GROK_NEW} decode tokens "
          f"{out['decode_ms_per_token']:.2f} ms/token (host clock, synced), "
          f"peak {out['peak_memory_gb']:.2f} GB, flash_attention "
          f"{fa_kernel.launches} launches")
    del params, logits
    torch.cuda.empty_cache()
    out["flash_heads"] = flash_at(
        fa_ops, fa_kernel, card, f"{ZOO_GROK}'s head layout", ZOO_B, ZOO_S0,
        cfg.n_heads, cfg.n_kv_heads, cfg.d_head, True)
    return out


def zoo_card_vs_cpu(dev, name, cfg, batch_rows, s0, n_new, rng):
    """(e): one cut of a zoo model at full width in fp32, weights drawn on
    the card and copied to the host: the forward's logits of
    ``batch_rows`` rows on both, held within ZOO_CMP_TOL on the rows whose
    MoE routes agree everywhere (the flipped routes counted); then greedy
    ``generate`` of one row and the prefill + decode logits along the
    CPU's tokens, held likewise up to the first step with a flipped route
    (at least the prefill must be held), greedy tokens equal past
    near-ties over those steps."""
    import numpy as np
    import torch
    from repro_torch import random as prng
    from repro_torch.models import transformer as T
    from repro_torch.serve import generate
    from repro_torch.tree import tree_map
    params = {"cuda": T.init(cfg, prng.PRNGKey(1), device=dev)[0]}
    params["cpu"] = tree_map(lambda x: x.cpu(), params["cuda"])
    devices = {"cpu": torch.device("cpu"), "cuda": dev}
    toks = rng.integers(0, cfg.vocab, (batch_rows, s0))
    extras = zoo_extras(cfg, batch_rows, s0, rng)
    logits, routes = {}, {}
    for d, device in devices.items():
        b = {"tokens": torch.as_tensor(toks, device=device)}
        b.update({k: torch.as_tensor(v, device=device)
                  for k, v in extras.items()})
        with RouteRecorder() as rec, torch.no_grad():
            logits[d] = T.apply(params[d], cfg, b)[0].cpu()
        routes[d] = rec.routes
    flips, rows, margin = route_flips(routes["cpu"], routes["cuda"],
                                      batch_rows)
    if not rows:
        raise AssertionError(f"{name}: every row has a flipped route "
                             f"({flips} routes)")
    a, b = logits["cuda"][rows], logits["cpu"][rows]
    diff = float((a - b).abs().max())
    if not torch.allclose(a, b, atol=ZOO_CMP_TOL, rtol=ZOO_CMP_TOL):
        raise AssertionError(f"{name}: card and CPU forward logits differ "
                             f"by {diff:.3e} (atol/rtol {ZOO_CMP_TOL})")
    out = {"forward_max_abs_diff": diff, "route_flips": flips,
           "rows_held": len(rows), "rows": batch_rows}
    line = (f"{name} fp32 card vs CPU: forward B={batch_rows} x {s0} logits "
            f"within {diff:.3e} on {len(rows)} of {batch_rows} rows "
            f"(atol/rtol {ZOO_CMP_TOL})")
    if cfg.moe:
        line += (f"; {flips} (token, slot) MoE routes flipped"
                 + (f" (smallest top-k margin among them {margin:.2e})"
                    if flips else ""))
    # greedy generate of the first row, teacher-forced logits along it
    ex1 = {k: v[:, :1] if k == "mrope_positions" else v[:1]
           for k, v in extras.items()}
    gen, tf, steps = {}, {}, {}
    for d, device in devices.items():
        with torch.no_grad():
            gen[d] = generate(params[d], cfg, toks[:1], n_new, extras=ex1)
    for d, device in devices.items():
        steps[d] = []
        tf[d] = teacher_forced_logits(params[d], cfg, gen["cpu"].tokens, s0,
                                      n_new, device, extras=ex1,
                                      routes=steps[d])
    # the steps held: those before the first with a flipped route
    held, gflips = n_new, 0
    for i, (a, b) in enumerate(zip(steps["cpu"], steps["cuda"])):
        gflips = route_flips(a, b, 1)[0]
        if gflips:
            held = i
            break
    if held == 0:
        raise AssertionError(f"{name}: the prefill's MoE routes flipped "
                             f"({gflips}); no step of the decode held")
    gdiff = float((tf["cuda"][:held] - tf["cpu"][:held]).abs().max())
    if not torch.allclose(tf["cuda"][:held], tf["cpu"][:held],
                          atol=ZOO_CMP_TOL, rtol=ZOO_CMP_TOL):
        raise AssertionError(f"{name}: prefill/decode logits differ by "
                             f"{gdiff:.3e} over the {held} steps held")
    new_cpu, new_card, checked = held_greedy_tokens(
        gen, tf["cpu"], s0, held, ZOO_CMP_TOL)
    out.update(decode_max_abs_diff=gdiff, decode_steps_held=held,
               decode_route_flips=gflips, greedy_held=checked)
    line += (f"; prefill + decode logits within {gdiff:.3e} over {held} of "
             f"{n_new} steps"
             + (f" (step {held} has {gflips} flipped routes)"
                if held < n_new else "")
             + f", greedy tokens cpu {new_cpu.tolist()} card "
             f"{new_card.tolist()} ({checked} of {held} held, the rest "
             f"near-ties)")
    print(line)
    del params
    torch.cuda.empty_cache()
    return out


def zoo_phase(dev, fa_kernel, fa_ops, fm_kernel, fm_ops, fm_ref, card):
    """Phase 23: the MoE, encoder-decoder and VLM families on the card."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    out = {"part_s": {}}
    t0 = time.perf_counter()

    def part(key, fn, *args):
        t = time.perf_counter()
        out[key] = fn(*args)
        out["part_s"][key] = time.perf_counter() - t
        print(f"  ({key}: {out['part_s'][key]:.1f} s)")

    part("granite", granite_phase, dev, fa_kernel, fa_ops, fm_kernel, fm_ops,
         fm_ref, card)
    part("whisper", whisper_phase, dev, fa_kernel, fa_ops, card)
    part("qwen2_vl", qwen2_vl_phase, dev, fa_kernel, fa_ops, card)
    part("grok", grok_phase, dev, fa_kernel, fa_ops, card)
    rng = np.random.default_rng(5)
    cmp = {}
    for key, arch, kw, rows, s0 in (
            ("granite", ZOO_MOE, dict(n_layers=2), 4, ZOO_CMP_S0),
            ("whisper", ZOO_ENCDEC, dict(n_layers=2, n_enc_layers=2), 2,
             ZOO_CMP_S0),
            ("qwen2_vl", ZOO_VLM, dict(n_layers=1), 2, ZOO_CMP_VLM_S0)):
        cfg = get_config(arch).replace(dtype="float32",
                                       attention_impl="pallas", **kw)
        t = time.perf_counter()
        cmp[key] = zoo_card_vs_cpu(dev, f"{arch} cut to {kw}", cfg, rows,
                                   s0, ZOO_CMP_NEW, rng)
        out["part_s"][f"cmp_{key}"] = time.perf_counter() - t
        print(f"  (card vs CPU, {key}: {out['part_s'][f'cmp_{key}']:.1f} s)")
    out["card_vs_cpu"] = cmp
    out["phase_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the streaming uploads: prefetch 2 against 0 (phases 8, 19 and 22)
# ---------------------------------------------------------------------------
def _merged(spans):
    """The union of (start, end) intervals, as sorted disjoint ones."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _covered(lo, hi, merged):
    """Nanoseconds of [lo, hi) inside the disjoint sorted ``merged``."""
    from bisect import bisect_right
    i = max(bisect_right([s for s, _ in merged], lo) - 1, 0)
    got = 0
    for s, e in merged[i:]:
        if s >= hi:
            break
        got += max(0, min(e, hi) - max(s, lo))
    return got


def h2d_profile(fn):
    """Run ``fn`` under the profiler (``device_events``) and set its
    host-to-device copies against its kernels: wall s, kernel s, the
    copies' count, seconds and source kind (pageable or pinned), their
    seconds off the stream that runs the most kernel time (the compute
    stream), the share of copy time during which a kernel runs on another
    stream, and how many copies off the compute stream start while a
    compute kernel runs."""
    wall, events = device_events(fn)
    copies = [e for e in events if e[3].startswith("Memcpy HtoD")]
    kernels = [e for e in events
               if not e[3].startswith(("Memcpy", "Memset"))]
    by_stream = {}
    for s, e, st, _ in kernels:
        by_stream[st] = by_stream.get(st, 0) + e - s
    compute = max(by_stream, key=by_stream.get) if by_stream else None
    on_compute = _merged([(s, e) for s, e, st, _ in kernels
                          if st == compute])
    others = {c: _merged([(s, e) for s, e, st, _ in kernels if st != c])
              for c in {st for _, _, st, _ in copies}}
    side = [c for c in copies if c[2] != compute]
    h2d_ns = sum(e - s for s, e, _, _ in copies)
    return {
        "wall_s": wall, "kernels": len(kernels),
        "kernel_s": sum(e - s for s, e, _, _ in kernels) / 1e9,
        "h2d": len(copies), "h2d_s": h2d_ns / 1e9,
        "h2d_pageable": sum("Pageable" in c[3] for c in copies),
        "h2d_pinned": sum("Pinned" in c[3] for c in copies),
        "h2d_side": len(side),
        "h2d_side_s": sum(e - s for s, e, _, _ in side) / 1e9,
        "h2d_side_streams": len({c[2] for c in side}),
        "h2d_side_started_under_kernel": sum(
            1 for s, _, _, _ in side if _covered(s, s + 1, on_compute)),
        "h2d_overlap_share": (sum(_covered(s, e, others[st])
                                  for s, e, st, _ in copies) / h2d_ns
                              if h2d_ns else None)}


def sync_sites(fn, top=12):
    """Where the host waits for the card while ``fn`` runs
    (``torch.cuda.set_sync_debug_mode("warn")``): [(file:line, count)],
    most first."""
    import warnings
    from collections import Counter

    import torch
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return Counter(f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
                   for w in caught
                   if "synchroniz" in str(w.message)).most_common(top)


class _UploadClock:
    """Host seconds spent in the shard caches' ``ensure`` and ``view`` (the
    upload's host half) while it is entered; a nested call (a mesh cache's
    shards) counts once."""

    def __enter__(self):
        from repro_torch.data import stream as st
        self.seconds, self._depth, self._saved = 0.0, 0, []
        for cls in (st.ShardCache, st.MeshShardedCache):
            for name in ("ensure", "view"):
                f = cls.__dict__[name]
                self._saved.append((cls, name, f))
                setattr(cls, name, self._timed(f))
        return self

    def _timed(self, f):
        def g(*a, **k):
            self._depth += 1
            t0 = time.perf_counter()
            try:
                return f(*a, **k)
            finally:
                self._depth -= 1
                if self._depth == 0:
                    self.seconds += time.perf_counter() - t0
        return g

    def __exit__(self, *exc):
        for cls, name, f in self._saved:
            setattr(cls, name, f)


def stream_split(tag, plan, n_rounds, make=None, trainer=None, fresh=None,
                 sites=False):
    """A streaming lane ``plan`` with ``prefetch`` 2 and 0: timed runs in
    turns (2, 0, 0, 2), each synced at its end, then one profiled run of
    each arm (``h2d_profile``).  With ``make``, every run is a new trainer
    with a cold cache (a fleet whose clients are new to the run); with
    ``trainer``, a trainer whose cache a run has warmed, its state reset to
    ``fresh()`` before each run.  For each arm: ms/round, the host ms/round
    spent in the cache's ``ensure`` and ``view`` (the upload's host half),
    misses and H2D bytes a round (the cache's ``upload_bytes``), the
    largest device staging of one upload (``staging_bytes``), the profiled
    kernel and H2D device ms a round, the H2D copies' kinds and streams,
    and the share of H2D time under a kernel.  The arms must agree bit for
    bit (losses and parameters).  ``sites``: also list where one run of
    each arm waits for the card."""
    import numpy as np
    arms = {p: dataclasses.replace(plan, prefetch=p) for p in (2, 0)}

    def run(p):
        tr = trainer or make()
        if trainer is not None:
            tr.state, tr.history = fresh(), []
        cache = tr.stream_cache
        m0, b0 = ((cache.misses, getattr(cache, "upload_bytes", None))
                  if cache is not None else (0, 0))
        hist = [r for r in tr.run(n_rounds, plan=arms[p], verbose=False)
                if "event" not in r]
        sync(tr.device)
        cache = tr.stream_cache
        nbytes = getattr(cache, "upload_bytes", None)
        return ([r["loss"] for r in hist], flat_params(tr.state),
                cache.misses - m0, None if nbytes is None else nbytes - b0,
                cache)

    runs = {p: [] for p in (2, 0)}
    last = {}
    for p in (2, 0, 0, 2):
        with _UploadClock() as clock:
            t0 = time.perf_counter()
            last[p] = run(p)
            secs = time.perf_counter() - t0
        runs[p].append((secs, clock.seconds) + last[p][2:4])
    out = {}
    for p in (2, 0):
        prof = h2d_profile(lambda: run(p))
        secs, host, misses, nbytes = zip(*runs[p])
        cache = last[p][4]
        out[p] = {
            "ms": statistics.fmean(secs) / n_rounds * 1e3,
            "ms_runs": [x / n_rounds * 1e3 for x in secs],
            "upload_host_ms": statistics.fmean(host) / n_rounds * 1e3,
            "misses_per_round": statistics.fmean(misses) / n_rounds,
            "upload_bytes_per_round": (None if nbytes[0] is None else
                                       statistics.fmean(nbytes) / n_rounds),
            "device_ms": prof["kernel_s"] / n_rounds * 1e3,
            "h2d_ms": prof["h2d_s"] / n_rounds * 1e3,
            "h2d_per_round": prof["h2d"] / n_rounds,
            "busy_share": prof["kernel_s"] / prof["wall_s"],
            "profiled": prof,
            "staging_bytes": getattr(cache, "staging_bytes", None),
            "cache_nbytes": cache.nbytes}
        if sites:
            out[p]["sync_sites"] = sync_sites(lambda: run(p))
    (la, wa), (lb, wb) = last[2][:2], last[0][:2]
    out["drift_bits"] = int((wa.view(np.int32) != wb.view(np.int32)).sum()
                            + sum(a != b for a, b in zip(la, lb)))
    a, b = out[2], out[0]
    print(f"{tag}: prefetch 2 {a['ms']:.3f} ms/round, 0 {b['ms']:.3f} "
          f"(host clock, {n_rounds} rounds a run in turns 2, 0, 0, 2: "
          f"{[round(x, 3) for x in a['ms_runs']]} / "
          f"{[round(x, 3) for x in b['ms_runs']]}; "
          f"{'cold' if trainer is None else 'warm'} cache); upload host "
          f"{a['upload_host_ms']:.3f} / {b['upload_host_ms']:.3f} ms/round; "
          f"misses {a['misses_per_round']:.2f}/round; H2D bytes/round "
          f"{a['upload_bytes_per_round']}; kernels {a['device_ms']:.3f} / "
          f"{b['device_ms']:.3f} ms/round, busy {a['busy_share']:.3f} / "
          f"{b['busy_share']:.3f}; H2D {a['h2d_per_round']:.2f} copies, "
          f"{a['h2d_ms']:.4f} / {b['h2d_ms']:.4f} ms/round, pageable "
          f"{a['profiled']['h2d_pageable']} / "
          f"{b['profiled']['h2d_pageable']}, off the compute stream "
          f"{a['profiled']['h2d_side']} / {b['profiled']['h2d_side']} "
          f"({a['profiled']['h2d_side_started_under_kernel']} / "
          f"{b['profiled']['h2d_side_started_under_kernel']} of them "
          f"started under a compute kernel), share under a kernel "
          f"{a['profiled']['h2d_overlap_share']} / "
          f"{b['profiled']['h2d_overlap_share']}; staging "
          f"{a['staging_bytes']} B beside the cache's {a['cache_nbytes']} "
          f"B; the arms differ in {out['drift_bits']} bits", flush=True)
    if sites:
        for p in (2, 0):
            print(f"  host waits, prefetch {p}: {out[p]['sync_sites']}",
                  flush=True)
    if out["drift_bits"]:
        raise AssertionError(f"{tag}: prefetch 2 and 0 differ in "
                             f"{out['drift_bits']} bits")
    return out


def zipf_state(dev):
    """BENCH_6's start: the linreg parameters at zero, FedMom's state."""
    import torch
    from repro_torch.core import fedmom
    return fedmom(eta=Z_ETA, beta=Z_BETA, use_fused_kernel=True).init(
        {"w": torch.zeros(Z_D, device=dev), "b": torch.zeros((), device=dev)})


def wide_split(dev):
    """Phase 8's split of the linreg fleet widened until the card lags the
    host (``tests/test_torch_gpu.py``'s overlap configuration: W_K clients
    of W_ROWS rows, D = W_D, M = W_C, H = 1, b = W_B, chunks of W_CR over
    a cache of W_CAP uniform slots), where an overlapped upload can hide
    under a chunk: a warm-up run, then ``stream_split``."""
    import numpy as np
    import torch
    from repro_torch.core import DeviceUniformSampler, RoundConfig, fedmom
    from repro_torch.data import FederatedDataset
    from repro_torch.launch.plan import CacheSpec, ExecutionPlan
    from repro_torch.launch.train import FederatedTrainer
    rng = np.random.default_rng(9)
    ds = FederatedDataset(
        [{"x": rng.standard_normal((W_ROWS, W_D), np.float32) * 1e-3,
          "y": rng.standard_normal(W_ROWS).astype(np.float32)}
         for _ in range(W_K)], seed=1)
    opt = fedmom(eta=1.0, beta=0.9, use_fused_kernel=True)
    tr = FederatedTrainer(
        loss_fn=linreg_loss, server_opt=opt,
        rcfg=RoundConfig(W_C, 1, W_LR, compute_dtype="float32"),
        dataset=ds, sampler=DeviceUniformSampler(ds.population(), W_C,
                                                 seed=2),
        state=opt.init({"w": torch.zeros(W_D), "b": torch.zeros(())}),
        local_batch=W_B, device=dev)
    init = tr.state
    plan = ExecutionPlan(plane="streaming", chunk_rounds=W_CR,
                         cache=CacheSpec(clients=W_CAP, tiers=1))
    tr.run(2 * W_CR, plan=plan, verbose=False)
    try:
        return stream_split(
            f"linreg widened (D={W_D}, b={W_B}, H=1, M={W_C}, K={W_K}, "
            f"chunks of {W_CR}, {W_CAP} slots)", plan, 4 * W_CR, trainer=tr,
            fresh=lambda: init)
    finally:
        del tr, init
        torch.cuda.empty_cache()


def zipf_splits(dev, lanes, sites=False):
    """Phase 8's split of BENCH_6's padded, bucketed and hook lanes on
    their warm trainers (``lanes[name]["trainer"]`` and ``["plan"]``)."""
    return {name: stream_split(f"BENCH_6 {name}", lane["plan"],
                               Z_SPLIT_ROUNDS, trainer=lane["trainer"],
                               fresh=lambda: zipf_state(dev), sites=sites)
            for name, lane in lanes.items()}


def bench7_split(dev, tag, provider, n_clients, rate, sites=False):
    """Phase 19's split of BENCH_7's padded lane (FedMom) over
    ``provider``, each run on a new trainer's cold cache, as phase 19 runs
    each cell."""
    return stream_split(
        tag, b7_plan(scenario_spec(rate, B7_DEADLINE, B7_SCEN_SEED)),
        B7_SPLIT_ROUNDS, sites=sites,
        make=lambda: b7_trainer(provider, "fedmom", n_clients, dev))


def mesh_split(tag, lane, mesh, trainer, init, sites=False):
    """Phase 22's split of a BENCH_10 streaming lane on its warm trainer:
    MS_SPLIT_ROUNDS rounds in chunks of MS_SPLIT_CR over the cache that
    chunks of MS_CR warmed (the default capacity of M x MS_CR clients)."""
    plan = mesh_plan(lane, mesh, MS_SPLIT_CR)
    plan = dataclasses.replace(plan, cache=dataclasses.replace(
        plan.cache, clients=S_M * MS_CR))
    return stream_split(tag, plan, MS_SPLIT_ROUNDS, trainer=trainer,
                        fresh=lambda: init, sites=sites)


def host_functions(tr, plan, n_rounds, init):
    """Host seconds a round by function (``cProfile``'s own time, each
    function as ``file:line(name)``) of one run of ``plan`` from ``init``:
    where the host's time goes, beside the device's."""
    import cProfile
    import pstats
    tr.state, tr.history = init, []
    prof = cProfile.Profile()
    prof.enable()
    tr.run(n_rounds, plan=plan, verbose=False)
    sync(tr.device)
    prof.disable()
    out = {}
    for (path, line, name), (_, _, own, _, _) in pstats.Stats(
            prof).stats.items():
        key = f"{Path(path).name}:{line}({name})"
        out[key] = out.get(key, 0.0) + own / n_rounds
    return out


def mesh_host_delta(lane, trs, one, top=10):
    """Phase 22: where the host time a 1-rank mesh adds to a streaming lane
    goes: ``host_functions`` of one run without and one with the mesh,
    the functions whose own time grows most, in ms/round."""
    plans = {"none": mesh_plan(lane, None, MS_CR),
             "mesh1": mesh_plan(lane, one, MS_CR)}
    got = {tag: host_functions(trs[tag][0], plans[tag], MS_CR, trs[tag][1])
           for tag in plans}
    total = {tag: sum(v.values()) * 1e3 for tag, v in got.items()}
    grew = sorted(((k, (got["mesh1"].get(k, 0.0) - got["none"].get(k, 0.0))
                    * 1e3) for k in set(got["none"]) | set(got["mesh1"])),
                  key=lambda kv: -kv[1])[:top]
    print(f"BENCH_10 {lane}: host ms/round under cProfile, none "
          f"{total['none']:.3f}, 1-rank mesh {total['mesh1']:.3f}; own time "
          f"that grew most (ms/round): "
          + "; ".join(f"{k} +{v:.3f}" for k, v in grew), flush=True)
    return {"host_ms": total, "grew_ms": grew}


def stream_only(dev, sites=True):
    """``--only-stream``: the splits of phases 8, 19 and 22 alone, each
    lane's trainer warmed by a run of its own first."""
    import tempfile

    import torch
    import torch.distributed as dist
    from repro_torch.data import (DiskShardProvider, synthetic_femnist,
                                  write_disk_corpus)
    from repro_torch.launch.mesh import MeshSpec
    from repro_torch.launch.plan import CacheSpec, ExecutionPlan
    from repro_torch.scenario import zipf_linreg_provider
    z_clients = zipf_clients()
    lanes = {}
    for name, spec, hook in (
            ("padded", CacheSpec(bytes=Z_BYTES, tiers=1), False),
            ("bucketed", CacheSpec(bytes=Z_BYTES, bucketed=True), False),
            ("hook", CacheSpec(bytes=Z_BYTES, bucketed=True), True)):
        tr = zipf_trainer(z_clients, dev, hook)
        plan = ExecutionPlan(plane="streaming", chunk_rounds=Z_CR, cache=spec)
        tr.run(Z_SPLIT_ROUNDS, plan=plan, verbose=False)
        lanes[name] = {"trainer": tr, "plan": plan}
    out = {"bench6": zipf_splits(dev, lanes, sites),
           "widened": wide_split(dev)}
    out["bench7"] = bench7_split(dev, "BENCH_7 padded", b7_provider(), B7_K,
                                 B7_HOOK_RATE, sites)
    with tempfile.TemporaryDirectory() as tmp:
        corpus = write_disk_corpus(
            os.path.join(tmp, "corpus"), zipf_linreg_provider(
                B9_K, dim=B7_DIM, n_min=B7_NMIN, n_max=B7_NMAX, seed=0),
            layout="npy-packed")
        out["bench9_disk"] = bench7_split(
            dev, "BENCH_9 disk corpus", DiskShardProvider(corpus), B9_K,
            B9_RATE, sites)
    clients, _ = synthetic_femnist(n_clients=S_K, seed=0)
    torch.backends.cudnn.deterministic = True
    one = MeshSpec(devices=1)
    try:
        for lane in ("padded", "bucketed"):
            trs = {}
            for tag, mesh in (("none", None), ("mesh1", one)):
                tr = secure_trainer(clients, dev)
                init = tr.state
                tr.run(MS_CR, plan=mesh_plan(lane, mesh, MS_CR),
                       verbose=False)
                trs[tag] = (tr, init)
                out[f"bench10_{lane}_{tag}"] = mesh_split(
                    f"BENCH_10 {lane} {tag}", lane, mesh, tr, init, sites)
            out[f"bench10_{lane}_host"] = mesh_host_delta(lane, trs, one)
    finally:
        torch.backends.cudnn.deterministic = False
        if dist.is_initialized():
            dist.destroy_process_group()
    return out


def scripts_phase(dr, dry):
    """Phase 25: ``scripts/dev_smoke_torch.py`` (its ``main``, loaded by
    path) over the ten reduced architectures on the card, an ``OK`` line
    each; ``scripts/profile_combo_torch.py`` on PC_COMBO, a CPU process
    with no card visible that ``start_dry_runs`` started, its flops equal
    to phase 24's dry-run record of the same combination."""
    import contextlib
    import importlib.util
    import io
    from repro_torch.configs import ARCH_IDS
    spec = importlib.util.spec_from_file_location(
        "dev_smoke_torch", ROOT / "scripts" / "dev_smoke_torch.py")
    ds = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ds)
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = ds.main([])
    smoke_s = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    print("\n".join(lines))
    oks = [ln.split()[1] for ln in lines if ln.startswith("OK ")]
    if rc != 0 or oks != list(ARCH_IDS):
        raise AssertionError(f"dev_smoke_torch: rc {rc}, OK lines for "
                             f"{oks}, want {list(ARCH_IDS)}")
    proc, log = dry["combo"]
    left = DRY_TIMEOUT_S - (time.perf_counter() - dry["t0"])
    try:
        proc.wait(timeout=max(left, 1.0))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"profile_combo_torch ran past "
                             f"{DRY_TIMEOUT_S:.0f} s") from None
    log.flush()
    text = (dry["dir"] / "profile_combo.log").read_text()
    print(text.rstrip())
    if proc.returncode != 0:
        raise AssertionError(f"profile_combo_torch exited "
                             f"{proc.returncode}:\n{text[-3000:]}")
    head = next(ln for ln in text.splitlines() if ln.startswith("== "))
    flops = float(head.split("flops=")[1].split()[0])
    want = dr["_".join(PC_COMBO)]["flops_per_rank"]
    if f"{flops:.3e}" != f"{want:.3e}":
        raise AssertionError(f"profile_combo_torch counts {flops:.3e} "
                             f"flops, the dry run {want:.3e}")
    print(f"dev_smoke_torch: {len(oks)} architectures in {smoke_s:.1f} s; "
          f"profile_combo_torch {' '.join(PC_COMBO)} (no card visible) "
          f"flops {flops:.3e} = the dry run's")
    return {"dev_smoke_archs": oks, "dev_smoke_s": smoke_s,
            "profile_combo_flops": flops}


def start_dry_runs():
    """Start ``DRY_RUNS``' dry runs, one CPU process each at a lower
    priority (meta tensors: no card, no memory), so that they run beside
    the card's phases; phase 24 reads their records.  Every process is
    stopped when the script exits."""
    out = Path(tempfile.mkdtemp(prefix="chip-smoke-dryrun-"))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    runs = []
    for arch, shape in DRY_RUNS:
        log = open(out / f"{arch}_{shape}.log", "w")
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--json",
             str(out / f"{arch}_{shape}.jsonl")],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT,
            preexec_fn=lambda: os.nice(10))
        runs.append((arch, shape, proc, log))
    # phase 25's profile_combo_torch.py, a CPU process like them
    combo_log = open(out / "profile_combo.log", "w")
    combo = subprocess.Popen(
        [sys.executable, str(ROOT / "scripts" / "profile_combo_torch.py"),
         *PC_COMBO], cwd=ROOT, env=env, stdout=combo_log,
        stderr=subprocess.STDOUT, preexec_fn=lambda: os.nice(10))

    def stop():
        for _, _, proc, log in runs + [(None, None, combo, combo_log)]:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            log.close()
        shutil.rmtree(out, ignore_errors=True)

    atexit.register(stop)
    return {"dir": out, "runs": runs, "combo": (combo, combo_log),
            "t0": time.perf_counter()}


def dryrun_phase(dev, card, dry):
    """(a) gemma3-1b's prefill counted on the card and on the meta device,
    and timed; (b) the records of the dry runs ``start_dry_runs``
    started."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.launch import cost
    from repro_torch.models import transformer as T
    cfg = get_config(DRY_ARCH)
    if cfg.attention_impl != "xla" or cfg.dtype != "bfloat16":
        raise AssertionError(f"{DRY_ARCH}: the dry run counts the plain "
                             f"attention in bf16, got {cfg.attention_impl} "
                             f"/ {cfg.dtype}")
    params, _, _ = zoo_init(DRY_ARCH, cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (DRY_B, DRY_S), generator=gen,
                           device=dev, dtype=torch.int32)
    cache, _ = T.init_cache(cfg, DRY_B, DRY_S, device=dev)

    def step():
        with torch.no_grad():
            return T.prefill(params, cfg, {"tokens": tokens}, cache)

    with FlopCounterMode(display=False) as fc:
        logits, _ = step()
    sync(dev)
    card_flops = fc.get_total_flops()
    if tuple(logits.shape) != (DRY_B, cfg.vocab) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"prefill logits {tuple(logits.shape)}, "
                             f"finite {bool(torch.isfinite(logits).all())}")
    mp, _ = T.abstract_params(cfg)
    mcache, _ = T.init_cache(cfg, DRY_B, DRY_S, abstract=True)
    mtok = torch.empty((DRY_B, DRY_S), dtype=torch.int32, device="meta")
    t0 = time.perf_counter()
    meta = cost.analyze(lambda p, b, c: T.prefill(p, cfg, b, c), mp,
                        {"tokens": mtok}, mcache)
    meta_s = time.perf_counter() - t0
    if card_flops != meta["flops"]:
        raise AssertionError(
            f"{DRY_ARCH} prefill: {card_flops} flops counted on the card, "
            f"{meta['flops']:.0f} on the meta device")
    ms = cuda_ms(step, 5, warmup=2)
    share = card_flops / (ms * 1e-3 * hw.PEAK_FLOPS_BF16)
    print(f"(a) {DRY_ARCH} prefill B={DRY_B} x {DRY_S}, bf16, "
          f"attention_impl=xla: {card_flops} flops counted on the card = "
          f"{meta['flops']:.0f} on the meta device ({meta_s:.1f} s); "
          f"{ms:.3f} ms (CUDA events, median of 5), "
          f"{card_flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s = {share:.1%} of "
          f"the {hw.PEAK_FLOPS_BF16 / 1e12:.0f} TFLOP/s dense bf16 peak on "
          f"{torch.cuda.get_device_name(0)} ({card}); meta bytes model "
          f"{meta['bytes']:.4e} B, meta peak {meta['peak_bytes']:.4e} B, "
          f"card peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    out = {"prefill": {"flops": card_flops, "meta_flops": meta["flops"],
                       "ms": ms, "peak_share": share,
                       "meta_bytes": meta["bytes"],
                       "meta_peak_bytes": meta["peak_bytes"],
                       "meta_count_s": meta_s}}
    del params, cache, logits
    torch.cuda.empty_cache()
    for arch, shape, proc, log in dry["runs"]:
        left = DRY_TIMEOUT_S - (time.perf_counter() - dry["t0"])
        try:
            proc.wait(timeout=max(left, 1.0))
        except subprocess.TimeoutExpired:
            raise AssertionError(f"dry run {arch} {shape} ran past "
                                 f"{DRY_TIMEOUT_S:.0f} s") from None
        log.flush()
        text = (dry["dir"] / f"{arch}_{shape}.log").read_text()
        if proc.returncode != 0:
            raise AssertionError(f"dry run {arch} {shape} exited "
                                 f"{proc.returncode}:\n{text[-3000:]}")
        rec = json.loads((dry["dir"] / f"{arch}_{shape}.jsonl").read_text()
                         .splitlines()[-1])
        if rec["status"] != "ok":
            raise AssertionError(f"dry run {arch} {shape}: {rec}")
        r = rec["roofline"]
        print(f"(b) {arch} {shape} {rec['mesh']} ({rec['placement']}, "
              f"C/H/b {rec.get('C')}/{rec.get('H')}/{rec.get('b')}): "
              f"peak_bytes_per_rank {rec['peak_bytes_per_rank']} "
              f"({rec['peak_bytes_per_rank'] / 1e9:.1f} GB), fits_one_card "
              f"{rec['fits_one_card']}; flops/rank "
              f"{rec['flops_per_rank']:.4e}, dominant {r['dominant']} "
              f"({r['bound_s']:.4g} s on the data sheet's constants), "
              f"counted in {rec['count_s']} s on the CPU")
        out[f"{arch}_{shape}"] = {k: rec[k] for k in (
            "peak_bytes_per_rank", "fits_one_card", "flops_per_rank",
            "hbm_bytes_per_rank", "collective_bytes_per_rank",
            "model_flops_ratio", "count_s")} | {"dominant": r["dominant"]}
    return out


def main(argv=None) -> int:
    import torch
    argv = sys.argv[1:] if argv is None else argv
    only_lm = "--only-lm" in argv
    only_mesh = "--only-mesh" in argv
    only_nccl = "--only-mesh-nccl" in argv
    only_zoo = "--only-zoo" in argv
    only_dryrun = "--only-dryrun" in argv
    only_stream = "--only-stream" in argv
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false — this "
              "script needs a CUDA card", file=sys.stderr)
        return 1
    dry = (start_dry_runs()
           if not (only_lm or only_zoo or only_mesh or only_nccl
                   or only_stream) else None)
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
    if only_lm:
        # a development run of the newest phase alone: no result line
        phase("21. federated language models (alone)")
        lm = lm_phase(torch.device("cuda"), fm_kernel, fm_ops, fm_ref)
        phase(None)
        print(json.dumps({"card": card, "lm": lm}, default=str))
        print("--only-lm: phases 1, 2 and 21 only; no result line")
        return 0
    if only_zoo:
        # a development run of the zoo's phase alone: no result line
        phase("23. the rest of the zoo (alone)")
        zoo = zoo_phase(torch.device("cuda"), fa_kernel, fa_ops, fm_kernel,
                        fm_ops, fm_ref, card)
        phase(None)
        print(json.dumps({"card": card, "zoo": zoo}, default=str))
        print("--only-zoo: phases 1, 2 and 23 only; no result line")
        return 0
    if only_dryrun:
        # a development run of the dry run's phase alone: no result line
        phase("24. the dry run on the meta device (alone)")
        dr = dryrun_phase(torch.device("cuda"), card, dry)
        phase(None)
        print(json.dumps({"card": card, "dryrun": dr}, default=str))
        print("--only-dryrun: phases 1, 2 and 24 only; no result line")
        return 0
    if only_stream:
        # a development run of the streaming lanes' prefetch split alone,
        # with where each run waits for the card: no result line
        phase("8, 19, 22. streaming prefetch 2 against 0 (alone)")
        split = stream_only(torch.device("cuda"))
        phase(None)
        os.makedirs(ROOT / "chiprun_out", exist_ok=True)
        (ROOT / "chiprun_out" / "stream_split.json").write_text(
            json.dumps({"card": card, "split": split}, default=str,
                       indent=1))
        print("--only-stream: phases 1, 2 and the streaming split only; no "
              "result line")
        return 0
    if only_mesh or only_nccl:
        # a development run of the mesh phase (or of its NCCL ranks) alone:
        # no result line
        phase("22. data mesh (alone)")
        mesh = mesh_phase(torch.device("cuda"), fm_kernel,
                          "c" if only_nccl else "abc")
        phase(None)
        print(json.dumps({"card": card, "mesh": mesh}, default=str))
        print("--only-mesh / --only-mesh-nccl: phases 1, 2 and 22 (or 22(c)) "
              "only; no result line")
        return 0

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

    # ------------------------------------------------------------------
    phase("20. secure aggregation: BENCH_8's lanes on the scanned, device "
          "and per-round planes, dropout recovery, the hook lane")
    t0 = time.perf_counter()
    secure = secure_phase(dev, clients, z_clients, lanes["hook"], fm_kernel,
                          cs_kernel)
    secure["phase_s"] = time.perf_counter() - t0

    # ------------------------------------------------------------------
    phase("21. federated language models: fed-llm-100m at full size, "
          "gemma3-1b at full width, the paper's Shakespeare task")
    lm = lm_phase(dev, fm_kernel, fm_ops, fm_ref)

    # ------------------------------------------------------------------
    phase("22. data mesh: BENCH_10's configuration without a mesh and on a "
          "1-rank NCCL mesh, 2 and 4 gloo ranks sharing the card, NCCL "
          "ranks where the cards allow")
    mesh = mesh_phase(dev, fm_kernel)

    # ------------------------------------------------------------------
    phase("23. the rest of the zoo: granite-moe-1b-a400m and whisper-medium "
          "at full width, qwen2-vl-72b and grok-1-314b cut in depth, card "
          "against CPU")
    zoo = zoo_phase(dev, fa_kernel, fa_ops, fm_kernel, fm_ops, fm_ref, card)

    # ------------------------------------------------------------------
    phase("24. the dry run on the meta device: gemma3-1b's prefill counted "
          "on the card and on meta, grok-1-314b and qwen2-vl-72b at full "
          "depth")
    torch.cuda.empty_cache()
    dr = dryrun_phase(dev, card, dry)

    # ------------------------------------------------------------------
    phase("25. the reference scripts: dev_smoke_torch.py over every "
          "reduced architecture on cuda, profile_combo_torch.py on the CPU")
    scripts = scripts_phase(dr, dry)

    # ------------------------------------------------------------------
    phase("26. kernels")
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
    phase(None)
    print(json.dumps({
        "card": card, "phase_seconds": _PHASE["seconds"],
        "main_path_ms_per_round": ms_round,
        "lm": lm,
        "zoo": zoo,
        "dryrun": dr,
        "scripts": scripts,
        "streaming_prefetch": {
            "bench6": {k: v["split"] for k, v in lanes.items()},
            "widened": lanes["padded"]["wide_split"],
            "bench7": scenarios["bench7"]["split"],
            "bench9_disk": scenarios["disk_trace"]["split"],
            "bench10": {lane: mesh["a"][lane]["split"]
                        for lane in ("padded", "bucketed")}},
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
        "secure": {k: v for k, v in secure.items() if k != "planes"},
        "secure_planes": {
            plane: {k: v for k, v in res.items()
                    if k not in ("plain", "masked", "open")}
            | {lane: {k: v for k, v in res[lane].items() if k != "top"}
               for lane in ("plain", "open", "masked")}
            for plane, res in secure["planes"].items()},
        "zipf_device_plane": zipf_device,
        "mesh": mesh,
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
        "secure_launches": {
            f"{plane}_{lane}": secure["planes"][plane][lane][
                "fedmom_update_launches"]
            for plane in secure["planes"]
            for lane in ("plain", "open", "masked")},
        "lm_launches": {
            "fed_llm_per_round": lm["fed_llm"]["fused"][
                "fedmom_update_launches"],
            "fed_llm_auto_profiled": lm["fed_llm"]["auto"][
                "fedmom_update_launches"],
            "gemma3_1b_per_round": lm["gemma3_1b"]["remat"][
                "fedmom_update_launches_per_round"],
            "shakespeare_fedmom_profiled": lm["shakespeare"]["FedMom"][
                "fedmom_update_launches"]},
        "lm_trees": {"fed_llm_100m": lm["fed_llm_tree"],
                     "gemma3_1b": lm["gemma_tree"],
                     "granite_moe_1b_a400m": zoo["granite"]["tree"]},
        "zoo_launches": {
            "granite_moe_rounds": zoo["granite"]["rounds"][
                "fedmom_update_launches"]},
        "mesh_launches": dict(
            {f"nccl1_{lane}": mesh["a"][lane]["mesh_launches"]
             for lane in ("device", "padded", "bucketed")},
            **{f"gloo{n}_{key}": mesh["b"][str(n)][key]["launches"]
               for n in MS_SIZES for key in mesh["b"][str(n)]
               if isinstance(mesh["b"][str(n)][key], dict)}),
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
        "secure_launches": {
            lane: secure["hook"][lane]["launches"]["client_step"]
            for lane in ("open", "masked")},
        "mesh_launches": {
            f"gloo{n}_hook": mesh["b"][str(n)]["linreg_hook"][
                "client_step_launches"]
            for n in MS_SIZES if str(n) in mesh["b"]},
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
        "zoo_launches": {
            "granite_moe_generate": zoo["granite"]["generate"]["launches"],
            "whisper_generate": zoo["whisper"]["generate"]["launches"],
            "qwen2_vl_generate": zoo["qwen2_vl"]["generate"]["launches"],
            "grok_prefill": zoo["grok"]["launches"]},
        "zoo_shapes": {"whisper_encoder": zoo["whisper"]["flash_encoder"],
                       "granite_heads": zoo["granite"]["flash_heads"],
                       "qwen2_vl_heads": zoo["qwen2_vl"]["flash_heads"],
                       "grok_heads": zoo["grok"]["flash_heads"]},
        "max_abs_err": max(fa_err, zoo["whisper"]["flash_encoder"][
            "max_abs_err"], *(zoo[k]["flash_heads"]["max_abs_err"]
                              for k in ("granite", "qwen2_vl", "grok"))),
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
    }, moe_route_entry(zoo["granite"])]}
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
