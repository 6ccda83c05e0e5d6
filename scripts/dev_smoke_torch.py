"""Dev smoke of the PyTorch port: forward, loss, gradient norm, prefill and
decode for every reduced architecture (the port's ``scripts/dev_smoke.py``).

    PYTHONPATH=src python scripts/dev_smoke_torch.py [arch ...] [--device cpu]

Each architecture's ``get_config(arch).reduced()`` gets keyed random
weights (``init(cfg, PRNGKey(1))``) and the batch of the JAX package's
script, drawn with the port's keyed ``random`` (``PRNGKey(0)`` split in
four: token and label ids, patches for a VLM, frames for an
encoder-decoder); the loss and its gradient (autograd) must be finite, and
so must the logits of ``prefill`` into a cache of 2 x 128 and of one
``decode_step`` at position 64.  One ``OK <arch> params=... loss=...
gnorm=...`` line an architecture.  It runs on ``cuda`` unless ``--device
cpu`` is given; ``--dtype float32`` computes in fp32 in place of the
reduced configs' bf16.
"""
import argparse
import math
import sys

import torch

from repro_torch import random as prng
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.transformer import VLM_PATCHES
from repro_torch.tree import leaves


def make_batch(cfg, B=2, S=64, key=None, device=None):
    """The reference script's ``make_batch``, draw for draw."""
    key = prng.PRNGKey(0, device=device) if key is None else key
    ks = prng.split(key, 4)
    batch = {"tokens": prng.randint(ks[0], (B, S), 0, cfg.vocab),
             "labels": prng.randint(ks[1], (B, S), 0, cfg.vocab)}
    if cfg.family == "vlm":
        batch["patches"] = prng.normal(
            ks[2], (B, min(VLM_PATCHES, S // 2), cfg.d_frontend))
        pos = torch.arange(S, device=key.device)[None].expand(B, S)
        batch["mrope_positions"] = torch.stack([pos, pos, pos])
        mask = torch.ones((B, S), device=key.device)
        mask[:, : S // 2] = 0.0
        batch["loss_mask"] = mask
    if cfg.enc_dec:
        batch["frames"] = prng.normal(ks[3], (B, 64, cfg.d_frontend))
    return batch


def smoke(arch: str, device=None, dtype=None) -> tuple:
    """One reduced architecture's (n_params, loss, gnorm), after checking
    that the loss, its gradient and the prefill and decode logits are
    finite; ``dtype`` replaces the config's compute dtype."""
    device = resolve_device(device)
    cfg = get_config(arch).reduced()
    if dtype is not None:
        cfg = cfg.replace(dtype=dtype)
    params, _ = T.init(cfg, prng.PRNGKey(1), device=device)
    n = sum(x.numel() for x in leaves(params))
    batch = make_batch(cfg, device=device)
    ps = [x.requires_grad_() for x in leaves(params)]
    loss, _ = T.loss_fn(params, cfg, batch)
    if not bool(torch.isfinite(loss)):
        raise AssertionError(f"{arch}: loss {float(loss)}")
    grads = torch.autograd.grad(loss, ps, allow_unused=True)
    gn = math.sqrt(sum(float(torch.sum(torch.square(g.float())))
                       for g in grads if g is not None))
    if not math.isfinite(gn):
        raise AssertionError(f"{arch}: gradient norm {gn}")
    for x in ps:
        x.requires_grad_(False)
    with torch.no_grad():
        cache, _ = T.init_cache(cfg, 2, 128, device=device)
        logits, cache = T.prefill(params, cfg, batch, cache)
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{arch}: prefill logits not finite")
        lg2, cache = T.decode_step(params, cfg, cache,
                                   batch["tokens"][:, :1], 64)
        if not bool(torch.isfinite(lg2).all()):
            raise AssertionError(f"{arch}: decode logits not finite")
    return n, float(loss.detach()), gn


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("arch", nargs="*", help="architectures (default: all)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--dtype", default=None,
                    help="compute dtype in place of the config's "
                         "(bfloat16), e.g. float32")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    for arch in args.arch or list(ARCH_IDS):
        n, loss, gn = smoke(arch, device, args.dtype)
        print(f"OK {arch:25s} params={n / 1e6:8.2f}M loss={loss:8.4f} "
              f"gnorm={gn:9.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
