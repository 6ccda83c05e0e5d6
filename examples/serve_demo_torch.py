"""Batched serving on the PyTorch port: prefill + cache decode of zoo models
across the families: dense (KV / ring-buffer caches), MoE
(granite-moe-1b-a400m, grok-1-314b: the MLP through the capacity-based
token-choice dispatch), the RG-LRU hybrid recurrentgemma-9b (RG-LRU state
and conv caches beside the ring buffers of its LOCAL layers; prefill runs
the log-depth ``layers.rglru_scan`` and decode one step a token, as in
the reference, which wires its ``rglru_scan`` kernel into no model),
rwkv6-7b (recurrent state caches; prefill runs the plain chunked
recurrence: the ``rwkv6_scan`` kernel returns no state, so it serves the
forward loss only), the encoder-decoder whisper-medium (stubbed frame
embeddings through its encoder, cross-attention K/V cached at prefill) and
the VLM qwen2-vl-72b (stubbed patch embeddings over the first positions,
M-RoPE ids of a patch grid, then text).  Every prefill self-attention
layer of a prompt whose length is a multiple of 128 (and whisper's
encoder over its 1536 frames) runs through the hand-written CUDA
flash-attention kernel.  Without ``--arch`` it serves a family sample,
gemma3-1b, granite-moe-1b-a400m, recurrentgemma-9b and rwkv6-7b, at their
published widths (keyed random weights: the repo holds no real ones) on
the card:

    PYTHONPATH=src python examples/serve_demo_torch.py
    PYTHONPATH=src python examples/serve_demo_torch.py --arch whisper-medium
    PYTHONPATH=src python examples/serve_demo_torch.py --device cpu --reduced
    PYTHONPATH=src python examples/serve_demo_torch.py --arch qwen2-vl-72b \
        --reduced --device cpu

``--reduced`` serves the 2-period, d_model<=256 smoke variant of each
config; on the CPU the kernels' plain PyTorch versions run in their
place.  grok-1-314b and qwen2-vl-72b do not fit one card at full width:
serve them ``--reduced`` (``chip_smoke.py`` drives them cut in depth).
"""
import argparse
import math
import time

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.rwkv6_scan import kernel as rw_kernel
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.serve import generate

FAMILY_SAMPLE = ("gemma3-1b", "granite-moe-1b-a400m", "recurrentgemma-9b",
                 "rwkv6-7b")


def mrope_grid(batch: int, seq: int, n_patches: int) -> np.ndarray:
    """[3, batch, seq] int32 t/h/w ids: the patches on a square grid (t 0,
    h the row, w the column), then each text position's index on all three
    streams, as ``decode_step`` numbers the tokens it generates."""
    side = max(1, math.ceil(math.sqrt(n_patches)))
    i = np.arange(n_patches)
    text = np.arange(n_patches, seq)
    ids = np.stack([np.concatenate([a, text])
                    for a in (np.zeros(n_patches), i // side, i % side)])
    return np.broadcast_to(ids[:, None], (3, batch, seq)).astype(
        np.int32).copy()


def extras_for(cfg: ModelConfig, batch: int, prompt_len: int,
               rng: np.random.Generator) -> dict:
    """The prefill's stubbed modality inputs, as numpy arrays: an
    encoder-decoder's frame embeddings [batch, ENC_LEN, d_frontend]; a
    VLM's patch embeddings [batch, min(VLM_PATCHES, prompt_len // 2),
    d_frontend] with their M-RoPE ids; nothing for a text model."""
    if cfg.enc_dec:
        return {"frames": rng.standard_normal(
            (batch, T.ENC_LEN, cfg.d_frontend), dtype=np.float32)}
    if cfg.family == "vlm":
        P = min(T.VLM_PATCHES, prompt_len // 2)
        return {"patches": rng.standard_normal(
                    (batch, P, cfg.d_frontend), dtype=np.float32),
                "mrope_positions": mrope_grid(batch, prompt_len, P)}
    return {}


def serve(arch: str, args, dev: torch.device):
    cfg = get_config(arch + ("-reduced" if args.reduced else ""))
    cfg = cfg.replace(attention_impl="pallas", rwkv_impl="pallas")
    t0 = time.time()
    params, _ = T.init(cfg, prng.PRNGKey(0), device=dev)
    print(f"{cfg.name}: {cfg.n_params() / 1e6:.1f} M params on {dev} "
          f"({time.time() - t0:.1f} s keyed init)")
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))
    extras = extras_for(cfg, args.batch, args.prompt_len, rng)
    fa_kernel.launches = rw_kernel.launches = 0
    t0 = time.time()
    out = generate(params, cfg, prompts, args.max_new, temperature=0.7,
                   key=prng.PRNGKey(2), extras=extras)
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
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, choices=ARCH_IDS,
                    help="one arch id (default: a family sample, "
                    + ", ".join(FAMILY_SAMPLE) + ")")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the reduced smoke variant of the config")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; raises without a card)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=16)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    arches = [args.arch] if args.arch else list(FAMILY_SAMPLE)
    outs = {}
    for arch in arches:
        outs[arch] = serve(arch, args, dev)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return outs


if __name__ == "__main__":
    main()
