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
"""
import argparse

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch.core import (DeviceUniformSampler, RoundConfig,
                              UniformSampler, fedavg, fedmom)
from repro_torch.data import FederatedDataset, synthetic_femnist
from repro_torch.device import resolve_device
from repro_torch.launch.plan import ExecutionPlan
from repro_torch.launch.train import FederatedTrainer
from repro_torch.models import small


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
    ap.add_argument("--chunk-rounds", default=25,
                    type=lambda s: s if s == "auto" else int(s),
                    help="rounds per chunk (one CUDA graph on the card), or "
                         "'auto' to size from the measured dispatch "
                         "overhead")
    ap.add_argument("--fused-server", action="store_true",
                    help="route FedMom through the fused CUDA server update")
    ap.add_argument("--hetero", action="store_true",
                    help="random per-client local work H_k <= H per round")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run on the "
                         "CPU)")
    args = ap.parse_args()
    plane = args.plan or ("device" if args.device_data
                          else "scanned" if args.scanned else "per-round")
    budget = (int(args.memory_budget_mb * 2**20)
              if args.memory_budget_mb is not None else None)
    plan = ExecutionPlan(plane=plane, chunk_rounds=args.chunk_rounds,
                         memory_budget_bytes=budget)
    device = resolve_device(args.device)
    if device.type == "cuda":
        # fp32 convolutions in full fp32, as the reference computes them
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    clients, _ = synthetic_femnist(n_clients=args.clients, seed=0)
    ds = FederatedDataset(clients, seed=1)
    pop = ds.population()
    K, M = pop.n_clients, args.m

    # held-out eval set: a slice of every client's data
    ex = torch.as_tensor(np.concatenate([c["x"][:5] for c in clients]),
                         device=device)
    ey = torch.as_tensor(np.concatenate([c["y"][:5] for c in clients]),
                         device=device)

    def eval_fn(state):
        with torch.no_grad():
            logits = small.lenet_apply(state.w, ex)
        acc = float(torch.mean((torch.argmax(logits, -1) == ey).float()))
        return {"eval_acc": acc}

    w0 = small.lenet_init(prng.PRNGKey(0), device=device)
    rcfg = RoundConfig(clients_per_round=M, local_steps=args.local_steps,
                       lr=args.lr, placement="mesh", compute_dtype="float32")

    hetero_fn = None
    if args.hetero:
        def hetero_fn(t):
            return np.random.default_rng(1000 + t).integers(
                1, args.local_steps + 1, size=M)

    for name, opt in [("FedAvg (eta=K/M)", fedavg(eta=K / M)),
                      ("FedMom (eta=K/M, beta=0.9)",
                       fedmom(eta=K / M, beta=0.9,
                              use_fused_kernel=args.fused_server))]:
        print(f"\n=== {name} [plan={plan.plane}] [device={device}]"
              f"{' [hetero H_k]' if args.hetero else ''} ===")
        # the per-round plane works with the paper's stateful sampler; the
        # chunked planes (and auto, which may resolve to one) take the
        # keyed sampler, whose draws are pure functions of (seed, t)
        sampler = (UniformSampler(pop, M, seed=2)
                   if plan.plane == "per_round"
                   else DeviceUniformSampler(pop, M, seed=2))
        trainer = FederatedTrainer(
            loss_fn=small.lenet_loss, server_opt=opt, rcfg=rcfg,
            dataset=ds, sampler=sampler, hetero_steps_fn=hetero_fn,
            state=opt.init(w0), local_batch=10, device=device)
        hist = trainer.run(args.rounds, plan=plan, log_every=25,
                           eval_fn=eval_fn)
        final = hist[-1]
        print(f"final: loss={final['loss']:.4f} "
              f"acc={final['eval_acc']:.3f}")


if __name__ == "__main__":
    main()
