"""Paper task 2 on the PyTorch port: the character-level LSTM (1x128, Kim
et al. 2016) on synthetic Shakespeare with M=2 active clients (§5.1/§5.4 of
the paper).  Compares FedSGD (H=1), FedAvg (H=10) and FedMom (H=10, beta
0.9), each with eta = K/M, in rounds-to-loss.

The port's counterpart of ``examples/paper_shakespeare.py``, with its flags
and defaults (40 clients, b=10, lr 0.8, 120 rounds).  Runs on the card by
default; ``--device cpu`` runs on the CPU:

    PYTHONPATH=src python examples/paper_shakespeare_torch.py --rounds 120
    PYTHONPATH=src python examples/paper_shakespeare_torch.py --device cpu \
        --rounds 10 --plan auto

``--plan`` picks the execution plane (per-round by default, as the
reference runs; ``scanned``, ``device`` and ``auto`` run chunks of
``--chunk-rounds`` rounds, each one CUDA-graph replay on the card).
"""
import argparse

import torch

from repro_torch import random as prng
from repro_torch.core import (DeviceUniformSampler, RoundConfig,
                              UniformSampler, fedavg, fedmom)
from repro_torch.data import lm_clients_to_dataset, synthetic_shakespeare
from repro_torch.data.synthetic import SHAKESPEARE_SEQ
from repro_torch.device import resolve_device
from repro_torch.launch.plan import ExecutionPlan
from repro_torch.launch.train import FederatedTrainer
from repro_torch.models import small


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=120)
    ap.add_argument("--clients", type=int, default=40)
    ap.add_argument("--lr", type=float, default=0.8)
    ap.add_argument("--plan", default="per-round",
                    choices=("per-round", "scanned", "device", "auto"))
    ap.add_argument("--chunk-rounds", type=int, default=10)
    ap.add_argument("--fused-server", action="store_true",
                    help="FedMom through the fused CUDA server update")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run on the "
                         "CPU)")
    return ap


def runs(K: int, M: int, fused: bool = False) -> list:
    """(name, server optimizer, H) of the three runs, eta = K/M."""
    return [("FedSGD", fedavg(eta=K / M), 1),
            ("FedAvg", fedavg(eta=K / M), 10),
            ("FedMom", fedmom(eta=K / M, beta=0.9, use_fused_kernel=fused),
             10)]


def dataset(n_clients: int):
    streams, _ = synthetic_shakespeare(n_clients=n_clients, seed=0)
    return lm_clients_to_dataset([c["text"] for c in streams],
                                 SHAKESPEARE_SEQ, seed=1)


def make_trainer(ds, opt, H: int, lr: float, plane: str, device,
                 M: int = 2) -> FederatedTrainer:
    """One run's trainer: the reference's settings (b=10, fp32)."""
    pop = ds.population()
    rcfg = RoundConfig(clients_per_round=M, local_steps=H, lr=lr,
                       placement="mesh", compute_dtype="float32")
    sampler = (UniformSampler(pop, M, seed=2) if plane == "per_round"
               else DeviceUniformSampler(pop, M, seed=2))
    w0 = small.lstm_init(prng.PRNGKey(0), device=device)
    return FederatedTrainer(
        loss_fn=small.lstm_loss, server_opt=opt, rcfg=rcfg, dataset=ds,
        sampler=sampler, state=opt.init(w0), local_batch=10, device=device)


def main(argv=None):
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    ds = dataset(args.clients)
    K, M = ds.population().n_clients, 2
    plane = args.plan.replace("-", "_")
    plan = ExecutionPlan(plane=plane, chunk_rounds=args.chunk_rounds)
    final, trainers = {}, {}
    for name, opt, H in runs(K, M, args.fused_server):
        print(f"\n=== {name} (H={H}) [plan={plane}] [device={device}] ===")
        trainer = make_trainer(ds, opt, H, args.lr, plane, device, M)
        hist = trainer.run(args.rounds, plan=plan, log_every=30)
        final[name] = [r for r in hist if "loss" in r][-1]["loss"]
        trainers[name] = trainer
    print("\nrounds-to-loss summary (lower = faster):",
          {k: round(v, 4) for k, v in final.items()})
    return trainers, final


if __name__ == "__main__":
    main()
