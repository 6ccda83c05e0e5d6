"""Architecture registry: the JAX package's ``configs`` as data.

Every architecture is a module here exporting ``CONFIG`` (a
``repro_torch.models.config.ModelConfig`` with the same numbers as its
counterpart in the JAX package, source cited).  Arch ids use the
assignment spelling; module names are the sanitized versions; an id with
the suffix ``-reduced`` names ``get_config(id).reduced()``.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "qwen2.5-14b": "qwen2_5_14b",
    "qwen3-1.7b": "qwen3_1_7b",
    "qwen3-14b": "qwen3_14b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "rwkv6-7b": "rwkv6_7b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "whisper-medium": "whisper_medium",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "grok-1-314b": "grok_1_314b",
    "gemma3-1b": "gemma3_1b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch.endswith("-reduced"):
        return get_config(arch[: -len("-reduced")]).reduced()
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
