"""Federated pre-training of a ~100M-parameter dense transformer on the
PyTorch port: qwen3-family blocks on synthetic non-IID token streams, FedMom
on the server (eta = K/M, beta 0.9) and SGD on the clients.

The port's counterpart of ``examples/federated_llm.py``, with its flags and
defaults (16 clients x 20,000 tokens, M=4, H=2, b=4, seq 128, lr 0.05, 30
rounds).  ``--arch`` trains a reduced zoo architecture in fp32 instead
(a text family: dense, MoE, RG-LRU or RWKV6; the token corpora carry no
frames or patches for the encoder-decoder or the VLM).
Runs on the card by default; ``--device cpu`` runs on the CPU:

    PYTHONPATH=src python examples/federated_llm_torch.py --rounds 30
    PYTHONPATH=src python examples/federated_llm_torch.py --plan auto \
        --fused-server
    PYTHONPATH=src python examples/federated_llm_torch.py --device cpu \
        --arch gemma3-1b --rounds 5 --seq 32
    PYTHONPATH=src python examples/federated_llm_torch.py --device cpu \
        --arch granite-moe-1b-a400m --rounds 5 --seq 32 --plan auto

``--plan`` picks the execution plane (per-round by default; ``scanned``,
``device`` and ``auto`` run chunks of ``--chunk-rounds`` rounds, each one
CUDA-graph replay on the card).  ``--fused-server`` routes the FedMom
server step through the hand-written ``fedmom_update`` kernel.  The server
state is checkpointed through ``checkpoint/io`` every 100 rounds, as the
reference does (to ``results/fed_llm_torch_ckpt.npz``, its own name).  On
the card matmuls run in full fp32 (TF32 off), as the reference computes
them.
"""
import argparse
import time

import torch

from repro_torch import random as prng
from repro_torch.configs import get_config
from repro_torch.core import (DeviceUniformSampler, RoundConfig,
                              UniformSampler, fedmom)
from repro_torch.data import lm_clients_to_dataset, synthetic_token_clients
from repro_torch.device import resolve_device
from repro_torch.launch.plan import ExecutionPlan
from repro_torch.launch.train import FederatedTrainer
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.tree import leaves


def model_100m() -> ModelConfig:
    return ModelConfig(
        name="fed-llm-100m", family="dense",
        n_layers=12, d_model=640, n_heads=10, n_kv_heads=5, d_head=64,
        d_ff=2560, vocab=8192, qk_norm=True, act="swiglu",
        dtype="float32", remat=False, scan_layers=True,
        source="qwen3-family block structure, scaled to ~100M")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--m", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--arch", default=None,
                    help="train a reduced assigned arch instead")
    ap.add_argument("--plan", default="per-round",
                    choices=("per-round", "scanned", "device", "auto"))
    ap.add_argument("--chunk-rounds", type=int, default=10)
    ap.add_argument("--fused-server", action="store_true",
                    help="FedMom through the fused CUDA server update")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run on the "
                         "CPU)")
    return ap


def model_config(args) -> ModelConfig:
    return (get_config(args.arch).reduced().replace(dtype="float32")
            if args.arch else model_100m())


def build(args, cfg: ModelConfig = None, device=None, init=None):
    """The example's trainer: ``(trainer, plan, cfg)`` for parsed ``args``
    (``cfg`` overrides the model, e.g. a depth cut; ``init`` = (params,
    param_axes) replaces the keyed init, e.g. weights carried from
    another device)."""
    cfg = cfg or model_config(args)
    device = resolve_device(device if device is not None else args.device)
    params, axes = init or T.init(cfg, prng.PRNGKey(0), device=device)
    streams = synthetic_token_clients(args.clients, cfg.vocab,
                                      tokens_per_client=20_000, seed=0)
    ds = lm_clients_to_dataset(streams, args.seq, seed=1)
    pop = ds.population()
    opt = fedmom(eta=pop.n_clients / args.m, beta=0.9,
                 use_fused_kernel=args.fused_server)
    rcfg = RoundConfig(clients_per_round=args.m,
                       local_steps=args.local_steps, lr=args.lr,
                       placement="mesh", compute_dtype="float32")
    plane = args.plan.replace("-", "_")
    # the per-round plane takes the paper's stateful sampler, as the
    # reference does; the chunked planes the keyed one
    sampler = (UniformSampler(pop, args.m, seed=2) if plane == "per_round"
               else DeviceUniformSampler(pop, args.m, seed=2))

    def loss_fn(p, batch):
        return T.loss_fn(p, cfg, batch)

    trainer = FederatedTrainer(
        loss_fn=loss_fn, server_opt=opt, rcfg=rcfg, dataset=ds,
        sampler=sampler, state=opt.init(params), param_axes=axes,
        ckpt_path="results/fed_llm_torch_ckpt.npz", ckpt_every=100,
        local_batch=args.batch, device=device)
    plan = ExecutionPlan(plane=plane, chunk_rounds=args.chunk_rounds)
    return trainer, plan, cfg


def main(argv=None):
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    trainer, plan, cfg = build(args, device=device)
    n_params = sum(x.numel() for x in leaves(trainer.state.w))
    print(f"model {cfg.name}: {n_params / 1e6:.1f}M params ({n_params}) "
          f"[plan={plan.plane}] [device={device}]")
    t0 = time.time()
    hist = trainer.run(args.rounds, plan=plan,
                       log_every=max(args.rounds // 10, 1))
    rounds = [r for r in hist if "loss" in r]
    print(f"done: {args.rounds} rounds in {time.time() - t0:.0f}s; "
          f"loss {rounds[0]['loss']:.4f} -> {rounds[-1]['loss']:.4f}")
    return trainer, hist


if __name__ == "__main__":
    main()
