"""Batched serving on the PyTorch port: prefill + cache decode of a zoo
model.  A dense model keeps KV / ring-buffer caches, and every prefill
attention layer of a prompt whose length is a multiple of 128 runs through
the hand-written CUDA flash-attention kernel; recurrentgemma-9b keeps
RG-LRU state and conv caches beside the ring buffers of its LOCAL layers
(prefill runs the log-depth ``layers.rglru_scan``, decode one step a
token, as in the reference, which wires its ``rglru_scan`` kernel into no
model); rwkv6-7b keeps recurrent state caches, prefill runs the plain
chunked recurrence and decode one step a token (the ``rwkv6_scan`` kernel
returns no state, so it serves the forward loss only).  Defaults to
gemma3-1b at its published widths (keyed random weights: the repo holds
no real ones) on the card:

    PYTHONPATH=src python examples/serve_demo_torch.py
    PYTHONPATH=src python examples/serve_demo_torch.py --arch rwkv6-7b
    PYTHONPATH=src python examples/serve_demo_torch.py --device cpu --reduced
    PYTHONPATH=src python examples/serve_demo_torch.py --arch rwkv6-7b \
        --reduced --device cpu
    PYTHONPATH=src python examples/serve_demo_torch.py \
        --arch recurrentgemma-9b --reduced --device cpu

``--reduced`` serves the 2-period, d_model<=256 smoke variant of the
config; on the CPU the kernels' plain PyTorch versions run in their place.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.rwkv6_scan import kernel as rw_kernel
from repro_torch.models import transformer as T
from repro_torch.serve import generate


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gemma3-1b",
                    help="a dense arch id (gemma3-1b, qwen3-1.7b, ...), "
                    "recurrentgemma-9b or rwkv6-7b")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the reduced smoke variant of the config")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; raises without a card)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=16)
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = get_config(args.arch + ("-reduced" if args.reduced else ""))
    cfg = cfg.replace(attention_impl="pallas", rwkv_impl="pallas")
    t0 = time.time()
    params, _ = T.init(cfg, prng.PRNGKey(0), device=dev)
    print(f"{cfg.name}: {cfg.n_params() / 1e6:.1f} M params on {dev} "
          f"({time.time() - t0:.1f} s keyed init)")
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab, (args.batch, args.prompt_len))
    fa_kernel.launches = rw_kernel.launches = 0
    t0 = time.time()
    out = generate(params, cfg, prompts, args.max_new,
                   temperature=0.7, key=prng.PRNGKey(2))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    print(f"served batch={args.batch} prompt={args.prompt_len} "
          f"new={args.max_new} in {dt:.2f}s -> tokens {out.tokens.shape}, "
          f"mean logprob {out.logprobs[:, :-1].mean():.3f}; kernel launches: "
          f"flash_attention {fa_kernel.launches}, rwkv6_scan "
          f"{rw_kernel.launches}")
    print("first sequence's new tokens:",
          out.tokens[0, args.prompt_len:].tolist())


if __name__ == "__main__":
    main()
