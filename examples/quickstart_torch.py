"""Quickstart on the PyTorch port: the paper's setting in miniature.

Trains LeNet on synthetic non-IID FEMNIST with M=2 active clients per round
out of K=60 (§5.1's configuration) and compares the FedAvg and FedMom server
optimizers on an execution plane of ``repro_torch``.  Runs on the card by
default:

    PYTHONPATH=src python examples/quickstart_torch.py --fused-server
    PYTHONPATH=src python examples/quickstart_torch.py --plan auto
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu \
        --rounds 30 --plan device

``--plan`` picks the plane (per-round by default): ``scanned`` and
``device`` run chunks of ``--chunk-rounds`` rounds (on the card each chunk
is one CUDA-graph replay), ``auto`` resolves the plane from the memory
budget (``--memory-budget-mb``; the card's memory by default, unbounded on
the CPU) and prints its decision.  ``--fused-server`` routes the FedMom
server update through the hand-written CUDA kernel
(``kernels/fedmom_update``; its plain PyTorch version on the CPU).
``--hetero`` gives each client a random H_k <= H of local work per round
(the straggler / partial-work scenario).

Scenarios (``--dropout``, ``--deadline``, ``--adaptive-cohort``,
``--scenario-seed``) declare a ``ScenarioSpec`` on the plan; ``--record-
trace PATH`` records its per-round cohorts and caps into a ``FleetTrace``
before training and ``--replay-trace PATH`` replays one.  ``--provider K``
trains a lazily synthesized Zipf linreg fleet of K clients and
``--leaf-dir PATH`` an on-disk corpus (``DiskShardProvider``), both on the
streaming plane (``--cache-clients``, ``--cache-tiers``, ``--bucketed``):

    PYTHONPATH=src python examples/quickstart_torch.py --device cpu \
        --rounds 20 --plan device --dropout 0.3 --deadline 8
    PYTHONPATH=src python examples/quickstart_torch.py --provider 100000 \
        --rounds 48 --chunk-rounds 8 --dropout 0.3 --deadline 11
"""
import argparse

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch.core import (DeviceUniformSampler, RoundConfig,
                              UniformSampler, fedavg, fedmom)
from repro_torch.data import (DiskShardProvider, FederatedDataset,
                              StreamingFederatedDataset, synthetic_femnist)
from repro_torch.device import resolve_device
from repro_torch.launch.plan import CacheSpec, ExecutionPlan
from repro_torch.launch.train import FederatedTrainer
from repro_torch.models import small
from repro_torch.scenario import (AdaptiveCohort, LatencyStragglers,
                                  ScenarioSpec, UniformDropout,
                                  zipf_linreg_provider)
from repro_torch.traces import TraceSpec, record_trace


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=150)
    ap.add_argument("--clients", type=int, default=60)
    ap.add_argument("--m", type=int, default=2, help="active clients/round")
    ap.add_argument("--local-steps", type=int, default=10)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--plan", default=None,
                    choices=("auto", "per-round", "scanned", "device",
                             "streaming"),
                    help="execution plan; default: per-round, or whatever a "
                         "legacy flag selects")
    ap.add_argument("--memory-budget-mb", type=float, default=None,
                    help="device memory budget for --plan auto (default: "
                         "what the backend reports; unbounded on CPU)")
    ap.add_argument("--scanned", action="store_true",
                    help="legacy alias for --plan scanned")
    ap.add_argument("--device-data", action="store_true",
                    help="legacy alias for --plan device")
    ap.add_argument("--stream-data", action="store_true",
                    help="legacy alias for --plan streaming")
    ap.add_argument("--cache-clients", type=int, default=None,
                    help="shard-cache capacity in clients (default: one "
                         "chunk's worst case, m * chunk_rounds)")
    ap.add_argument("--cache-tiers", type=int, default=None,
                    help="max n_k slot-size tiers for the shard cache "
                         "(default: every natural power-of-two bucket; "
                         "1 = uniform n_max slots)")
    ap.add_argument("--bucketed", action="store_true",
                    help="n_k-bucketed compute: one sized launch per "
                         "occupied cache tier (streaming plane only)")
    ap.add_argument("--chunk-rounds", default=25,
                    type=lambda s: s if s == "auto" else int(s),
                    help="rounds per chunk (one CUDA graph on the card), or "
                         "'auto' to size from the measured dispatch "
                         "overhead")
    ap.add_argument("--fused-server", action="store_true",
                    help="route FedMom through the fused CUDA server update")
    ap.add_argument("--hetero", action="store_true",
                    help="random per-client local work H_k <= H per round")
    ap.add_argument("--dropout", type=float, default=None, metavar="RATE",
                    help="scenario: i.i.d. mid-round dropout rate in [0,1]")
    ap.add_argument("--deadline", type=float, default=None, metavar="S",
                    help="scenario: round deadline in seconds (lognormal "
                         "per-device step latency around 1s/step)")
    ap.add_argument("--adaptive-cohort", type=int, default=None,
                    metavar="GOAL",
                    help="scenario: grow/shrink the active cohort toward "
                         "GOAL completed clients per round")
    ap.add_argument("--scenario-seed", type=int, default=0,
                    help="seed keying every scenario fate draw")
    ap.add_argument("--provider", type=int, default=None, metavar="K",
                    help="train a lazily-synthesized Zipf linreg fleet of "
                         "K clients via a ShardProvider (streaming plane) "
                         "instead of materialized FEMNIST")
    ap.add_argument("--record-trace", default=None, metavar="PATH",
                    help="record the declared scenario's per-round "
                         "cohorts/caps into a versioned FleetTrace at "
                         "PATH (.npz + .json) before training")
    ap.add_argument("--replay-trace", default=None, metavar="PATH",
                    help="replay a recorded FleetTrace through the eq. "
                         "(3) step masks (bit-equal to the originating "
                         "run on every plane)")
    ap.add_argument("--leaf-dir", default=None, metavar="PATH",
                    help="train from an on-disk corpus / LEAF json "
                         "directory via DiskShardProvider (mmap-backed; "
                         "streaming plane)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run on the "
                         "CPU)")
    args = ap.parse_args()
    plane = args.plan or ("streaming" if args.stream_data or args.provider
                          or args.leaf_dir
                          else "device" if args.device_data
                          else "scanned" if args.scanned else "per-round")
    budget = (int(args.memory_budget_mb * 2**20)
              if args.memory_budget_mb is not None else None)
    scenario = None
    if (args.dropout is not None or args.deadline is not None
            or args.adaptive_cohort is not None
            or args.replay_trace is not None):
        scenario = ScenarioSpec(
            dropout=(UniformDropout(rate=args.dropout)
                     if args.dropout is not None else None),
            stragglers=(LatencyStragglers(deadline_s=args.deadline)
                        if args.deadline is not None else None),
            cohort=(AdaptiveCohort(goal=args.adaptive_cohort)
                    if args.adaptive_cohort is not None else None),
            trace=(TraceSpec(path=args.replay_trace)
                   if args.replay_trace is not None else None),
            seed=args.scenario_seed)
    plan = ExecutionPlan(plane=plane, chunk_rounds=args.chunk_rounds,
                         cache=CacheSpec(clients=args.cache_clients,
                                         tiers=args.cache_tiers,
                                         bucketed=args.bucketed),
                         memory_budget_bytes=budget, scenario=scenario)
    device = resolve_device(args.device)
    if device.type == "cuda":
        # fp32 convolutions in full fp32, as the reference computes them
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    if args.provider or args.leaf_dir:
        provider = (DiskShardProvider(args.leaf_dir) if args.leaf_dir
                    else zipf_linreg_provider(args.provider, dim=16,
                                              n_min=4, n_max=64, seed=0))
        ds = StreamingFederatedDataset.from_provider(provider, seed=1)
        pop = ds.population()
        K, M = pop.n_clients, args.m
        d = provider.fields["x"][0][0]

        def loss_fn(params, b):
            pred = b["x"] @ params["w"] + params["b"]
            return torch.mean(torch.square(pred - b["y"])), {}

        # held-out eval: a handful of synthesized shards (never cached)
        ev = [provider.shard(cid) for cid in range(min(K, 8))]
        ex = torch.as_tensor(np.concatenate([s["x"] for s in ev]),
                             device=device)
        ey = torch.as_tensor(np.concatenate([s["y"] for s in ev]),
                             device=device)

        def eval_fn(state):
            with torch.no_grad():
                mse = torch.mean(torch.square(
                    ex @ state.w["w"] + state.w["b"] - ey))
            return {"eval_mse": float(mse)}

        w0 = {"w": torch.zeros(d, device=device),
              "b": torch.zeros((), device=device)}
    else:
        clients, _ = synthetic_femnist(n_clients=args.clients, seed=0)
        ds = FederatedDataset(clients, seed=1)
        pop = ds.population()
        K, M = pop.n_clients, args.m
        loss_fn = small.lenet_loss

        # held-out eval set: a slice of every client's data
        ex = torch.as_tensor(np.concatenate([c["x"][:5] for c in clients]),
                             device=device)
        ey = torch.as_tensor(np.concatenate([c["y"][:5] for c in clients]),
                             device=device)

        def eval_fn(state):
            with torch.no_grad():
                logits = small.lenet_apply(state.w, ex)
            acc = float(torch.mean((torch.argmax(logits, -1) == ey)
                                   .float()))
            return {"eval_acc": acc}

        w0 = small.lenet_init(prng.PRNGKey(0), device=device)
    rcfg = RoundConfig(clients_per_round=M, local_steps=args.local_steps,
                       lr=args.lr, placement="mesh", compute_dtype="float32")

    if args.record_trace:
        # record what the declared scenario does to the exact cohorts the
        # run below will sample (same keyed sampler: pop, M, seed=2)
        rec = record_trace(scenario if scenario is not None
                           else ScenarioSpec(seed=args.scenario_seed),
                           DeviceUniformSampler(pop, M, seed=2),
                           args.rounds, args.local_steps)
        out = rec.save(args.record_trace)
        print(f"recorded fleet trace: {rec.n_rounds} rounds x m={M} "
              f"({rec.n_events} events, peak m={rec.peak_m}) -> {out}")

    hetero_fn = None
    if args.hetero:
        def hetero_fn(t):
            return np.random.default_rng(1000 + t).integers(
                1, args.local_steps + 1, size=M)

    scen_tag = ""
    if scenario is not None:
        parts = [f"dropout={args.dropout}" if args.dropout is not None
                 else None,
                 f"deadline={args.deadline}s" if args.deadline is not None
                 else None,
                 f"cohort->{args.adaptive_cohort}"
                 if args.adaptive_cohort is not None else None,
                 f"replay={args.replay_trace}"
                 if args.replay_trace is not None else None]
        scen_tag = f" [scenario: {', '.join(p for p in parts if p)}]"

    for name, opt in [("FedAvg (eta=K/M)", fedavg(eta=K / M)),
                      ("FedMom (eta=K/M, beta=0.9)",
                       fedmom(eta=K / M, beta=0.9,
                              use_fused_kernel=args.fused_server))]:
        print(f"\n=== {name} [plan={plan.plane}] [device={device}]"
              f"{' [hetero H_k]' if args.hetero else ''}{scen_tag} ===")
        # the per-round plane works with the paper's stateful sampler; the
        # chunked planes (and auto, which may resolve to one) take the
        # keyed sampler, whose draws are pure functions of (seed, t), as
        # do trace record/replay runs, whose cohorts must be replayable
        sampler = (UniformSampler(pop, M, seed=2)
                   if plan.plane == "per_round"
                   and not (args.record_trace or args.replay_trace)
                   else DeviceUniformSampler(pop, M, seed=2))
        trainer = FederatedTrainer(
            loss_fn=loss_fn, server_opt=opt, rcfg=rcfg,
            dataset=ds, sampler=sampler, hetero_steps_fn=hetero_fn,
            state=opt.init(w0), local_batch=4 if args.provider else 10,
            device=device)
        hist = trainer.run(args.rounds, plan=plan, log_every=25,
                           eval_fn=eval_fn)
        cache = trainer.stream_cache
        if cache is not None:
            sds = trainer.streaming_dataset()
            print(f"shard cache: {len(cache.resident())}/{K} clients "
                  f"resident in {cache.slots} slots over "
                  f"{len(cache.tier_sizes)} size tier(s) "
                  f"{list(cache.tier_sizes)} "
                  f"({cache.nbytes / 2**20:.2f} MiB of "
                  f"{sds.packed_nbytes / 2**20:.2f} MiB packed), "
                  f"hit-rate {cache.hit_rate:.1%}, "
                  f"{cache.evictions} evictions")
        final = hist[-1]
        quality = (f"mse={final['eval_mse']:.4f}" if "eval_mse" in final
                   else f"acc={final['eval_acc']:.3f}")
        done = (f" completed={final['completed']}/{M}"
                if "completed" in final else "")
        print(f"final: loss={final['loss']:.4f} {quality}{done}")


if __name__ == "__main__":
    main()
