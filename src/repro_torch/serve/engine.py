"""Batched serving engine: prefill, then token-by-token decode over the
zoo's KV / ring-buffer caches, with greedy or temperature sampling.

The port's counterpart of the JAX package's ``serve/engine.py``, with its
key schedule: one ``split`` before the first sampled token and one per
decode step, each step's token drawn with ``categorical`` on the subkey
(bit-equal to ``jax.random.categorical`` up to the ulps of ``log``).
Greedy decoding draws nothing, so it skips the splits; the tokens are the
same.  The caches are allocated once and written in place; the generated
tokens stay on the device until the end, so decoding never waits on the
host.  Runs where ``params`` lie: the prompts and the prefill's
``extras`` (an encoder-decoder's ``frames``, a VLM's ``patches`` and
``mrope_positions``) are placed there.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


@dataclass
class GenerateResult:
    tokens: np.ndarray          # [B, prompt + generated]
    logprobs: np.ndarray        # [B, generated]


def _sample(logits: torch.Tensor, temperature: float, key) -> torch.Tensor:
    if temperature and temperature > 0.0:
        return prng.categorical(key, logits / temperature, axis=-1)
    return torch.argmax(logits, dim=-1)


def _placed(name: str, value, dev: torch.device) -> torch.Tensor:
    """An extra input as a tensor on ``dev``, dtype kept: a tensor (moved)
    or a numpy array; anything else raises."""
    if isinstance(value, np.ndarray):
        value = torch.as_tensor(value)
    if not isinstance(value, torch.Tensor):
        raise TypeError(f"extras[{name!r}] must be a tensor or a numpy "
                        f"array, got {type(value).__name__}")
    return value.to(dev)


def _decode_one(params, cfg: ModelConfig, cache, tokens, pos: int, key,
                temperature: float):
    logits, cache = T.decode_step(params, cfg, cache, tokens, pos)
    nxt = _sample(logits, temperature, key)
    lp = torch.log_softmax(logits, dim=-1)
    lp = torch.gather(lp, -1, nxt[:, None])[:, 0]
    return nxt[:, None].to(torch.int32), cache, lp


@torch.no_grad()
def generate(params, cfg: ModelConfig, prompts, max_new: int,
             *, temperature: float = 0.0,
             key: Optional[torch.Tensor] = None,
             extras: Optional[dict] = None) -> GenerateResult:
    """prompts [B, S0] int (a tensor or array).  ``extras`` go into the
    prefill's batch beside the tokens, on the params' device.  Returns
    prompt + generated tokens and, per generated token after the first,
    its logprob (the last column is zero, as in the reference)."""
    dev = params["embed"].device
    if not isinstance(prompts, torch.Tensor):
        prompts = torch.as_tensor(np.asarray(prompts))
    prompts = prompts.to(device=dev, dtype=torch.int32)
    B, S0 = prompts.shape
    sampling = bool(temperature and temperature > 0.0)
    if sampling:
        key = (key if key is not None else prng.PRNGKey(0)).to(dev)
    cache, _ = T.init_cache(cfg, B, S0 + max_new, device=dev)
    batch = {"tokens": prompts, **{k: _placed(k, v, dev)
                                   for k, v in (extras or {}).items()}}
    logits, cache = T.prefill(params, cfg, batch, cache)
    k0 = None
    if sampling:
        pair = prng.split(key)
        key, k0 = pair[0], pair[1]
    cur = _sample(logits, temperature, k0)[:, None].to(torch.int32)

    toks = [prompts, cur]
    lps = []
    for i in range(max_new - 1):
        k = None
        if sampling:
            pair = prng.split(key)
            key, k = pair[0], pair[1]
        cur, cache, lp = _decode_one(params, cfg, cache, cur, S0 + i, k,
                                     temperature)
        toks.append(cur)
        lps.append(lp)
    lps.append(torch.zeros((B,), dtype=torch.float32, device=dev))
    return GenerateResult(tokens=torch.cat(toks, dim=1).cpu().numpy(),
                          logprobs=torch.stack(lps, dim=1).cpu().numpy())
