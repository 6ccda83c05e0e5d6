"""Residual blocks of the dense zoo path (ATTN / LOCAL) with the reference's
``init_block`` / ``apply_block`` / ``init_block_cache`` interface.

The port's counterpart of the JAX package's ``models/blocks.py`` for global
and sliding-window attention blocks.  ``apply_block(p, cfg, kind, x, ctx)``
returns ``(x, cache, aux)`` where ``ctx`` carries mode ('train' |
'prefill' | 'decode'), rope tables, the per-block cache and the decode
position.  Caches are updated in place (slice assignment into the tensors
``init_block_cache`` allocated) and returned, where the reference returns
new arrays from ``dynamic_update_slice`` on a donated cache.

The other block kinds, cross-attention, MoE and learned positions raise
``NotImplementedError`` naming the ROADMAP item that brings them; nothing
falls back.  Abstract mode (``KeyGen(None)``) belongs with the dry-run
tools (ROADMAP Queue 1 #14).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch import random as prng
from repro_torch.models import layers as L
from repro_torch.models.config import ATTN, LOCAL, RGLRU, RWKV, ModelConfig

_LATER = {
    RGLRU: "RG-LRU blocks come with the RG-LRU slice (ROADMAP Queue 1 #13c)",
    RWKV: "RWKV6 blocks come with the RWKV slice (ROADMAP Queue 1 #13d)",
}


# ---------------------------------------------------------------------------
# declarative parameter construction: every init returns (params, axes) trees
# with identical structure; axes leaves are tuples of logical axis names.
# ---------------------------------------------------------------------------
class KeyGen:
    """Splits keys for materialized init: each call returns a fresh subkey,
    ``key, sub = split(key)`` as the reference's ``KeyGen`` does.  Draws
    land on the key's device."""

    def __init__(self, key: torch.Tensor):
        if key is None:
            raise NotImplementedError(
                "abstract mode (KeyGen(None)) belongs with the dry-run tools "
                "(ROADMAP Queue 1 #14)")
        self._key = key

    @property
    def device(self) -> torch.device:
        return self._key.device

    def __call__(self) -> torch.Tensor:
        pair = prng.split(self._key)
        self._key = pair[0]
        return pair[1]


def _dense(kg: KeyGen, shape, axes, dtype, scale: Optional[float] = None):
    fan_in = shape[0] if len(shape) == 1 else math.prod(shape[:-1])
    if scale is None:
        scale = 1.0 / math.sqrt(max(fan_in, 1))
    arr = prng.normal(kg(), shape).mul_(scale)
    return arr.to(dtype), axes


def _normal(kg: KeyGen, shape, axes, dtype, stddev: float):
    arr = prng.normal(kg(), shape).mul_(stddev)
    return arr.to(dtype), axes


def _zeros(shape, axes, dtype, *, kg: Optional[KeyGen] = None, device=None):
    """Zeros on ``device`` (default: the key generator's device)."""
    device = kg.device if device is None else device
    return torch.zeros(shape, dtype=dtype, device=device), axes


def _const(val_fn, shape, axes, dtype, *, kg: Optional[KeyGen] = None,
           device=None):
    """val_fn: () -> array-like, on ``device`` (default: the key
    generator's device)."""
    device = kg.device if device is None else device
    v = val_fn() if callable(val_fn) else val_fn
    return torch.as_tensor(v, dtype=dtype, device=device).reshape(shape), axes


def split_pt(pairs: dict):
    """{'name': (param, axes)} -> (params, axes) twin trees."""
    params, axes = {}, {}
    for name, v in pairs.items():
        if isinstance(v, tuple) and len(v) == 2 and isinstance(v[1], (tuple, dict)):
            params[name], axes[name] = v
        elif isinstance(v, dict):
            params[name], axes[name] = split_pt(v)
        else:
            raise TypeError(f"{name}: {type(v)}")
    return params, axes


# ---------------------------------------------------------------------------
# MLP params
# ---------------------------------------------------------------------------
def init_mlp(kg: KeyGen, cfg: ModelConfig, dtype):
    if cfg.moe:
        raise NotImplementedError(
            "MoE MLPs come with the MoE slice (ROADMAP Queue 1 #13b)")
    D, F = cfg.d_model, cfg.d_ff
    pairs = {
        "wi_up": _dense(kg, (D, F), ("embed", "mlp"), dtype),
        "wo": _dense(kg, (F, D), ("mlp", "embed"), dtype),
    }
    if cfg.act in ("swiglu", "geglu"):
        pairs["wi_gate"] = _dense(kg, (D, F), ("embed", "mlp"), dtype)
    return split_pt(pairs)


def apply_mlp(p: dict, cfg: ModelConfig, x: torch.Tensor):
    if cfg.moe:
        raise NotImplementedError(
            "MoE MLPs come with the MoE slice (ROADMAP Queue 1 #13b)")
    return L.mlp_apply(p, x, cfg.act), 0.0


# ---------------------------------------------------------------------------
# attention blocks (global + sliding window)
# ---------------------------------------------------------------------------
def init_attn_params(kg: KeyGen, cfg: ModelConfig, dtype, *, kv_heads=None):
    D, Hq, Dh = cfg.d_model, cfg.n_heads, cfg.d_head
    Hkv = kv_heads if kv_heads is not None else cfg.n_kv_heads
    pairs = {
        "wq": _dense(kg, (D, Hq, Dh), ("embed", "heads", "head_dim"), dtype),
        "wk": _dense(kg, (D, Hkv, Dh), ("embed", "kv_heads", "head_dim"), dtype),
        "wv": _dense(kg, (D, Hkv, Dh), ("embed", "kv_heads", "head_dim"), dtype),
        "wo": _dense(kg, (Hq, Dh, D), ("heads", "head_dim", "embed"), dtype),
    }
    if cfg.qkv_bias:
        pairs["bq"] = _zeros((Hq, Dh), ("heads", "head_dim"), dtype, kg=kg)
        pairs["bk"] = _zeros((Hkv, Dh), ("kv_heads", "head_dim"), dtype, kg=kg)
        pairs["bv"] = _zeros((Hkv, Dh), ("kv_heads", "head_dim"), dtype, kg=kg)
    if cfg.qk_norm:
        pairs["q_norm"] = _zeros((Dh,), ("head_dim",), torch.float32, kg=kg)
        pairs["k_norm"] = _zeros((Dh,), ("head_dim",), torch.float32, kg=kg)
    return split_pt(pairs)


def init_block(kg: KeyGen, cfg: ModelConfig, kind: str, dtype, *,
               cross: bool = False):
    if kind in _LATER:
        raise NotImplementedError(_LATER[kind])
    if kind not in (ATTN, LOCAL):
        raise ValueError(kind)
    if cross:
        raise NotImplementedError(
            "cross-attention (encoder-decoder) comes with the enc-dec slice "
            "(ROADMAP Queue 1 #13e)")
    D = cfg.d_model
    sub = {
        "ln1": _zeros((D,), ("embed",), torch.float32, kg=kg),
        "attn": init_attn_params(kg, cfg, dtype),
        "ln2": _zeros((D,), ("embed",), torch.float32, kg=kg),
        "mlp": init_mlp(kg, cfg, dtype),
    }
    return split_pt(sub)


def _project_qkv(p: dict, cfg: ModelConfig, x: torch.Tensor, rope):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.qk_norm:
        q = L.head_rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = L.head_rms_norm(k, p["k_norm"], cfg.norm_eps)
    if rope is not None:
        sin, cos = rope
        q = L.apply_rope(q, sin, cos)
        k = L.apply_rope(k, sin, cos)
    return q, k, v


def _attn_mix(p: dict, cfg: ModelConfig, kind: str, x: torch.Tensor,
              ctx: dict):
    """Self-attention mixing with cache handling.  Returns (out, cache): the
    block's cache written in place, or None in train mode."""
    mode = ctx["mode"]
    rope = ctx.get("rope")
    cache = ctx.get("cache")
    window = cfg.window if kind == LOCAL else 0
    q, k, v = _project_qkv(p, cfg, x, rope)
    S = x.shape[1]

    def self_attn(q, k, v, causal):
        # the reference's dispatch rule: the kernel takes self-attention
        # with equal query and key lengths, a multiple of 128
        if (cfg.attention_impl == "pallas"
                and q.shape[1] == k.shape[1]
                and q.shape[1] % 128 == 0):
            from repro_torch.kernels.flash_attention import ops as flash_ops
            return flash_ops.flash_attention(q, k, v, causal=causal,
                                             window=window)
        return L.attention(q, k, v, causal=causal, window=window,
                           q_chunk=ctx.get("q_chunk", 1024))

    if mode == "train":
        return self_attn(q, k, v, ctx.get("causal", True)), None

    if mode == "prefill":
        out = self_attn(q, k, v, True)
        if kind == ATTN:
            cache["k"][:, :S] = k.to(cache["k"].dtype)
            cache["v"][:, :S] = v.to(cache["v"].dtype)
            return out, cache
        # local: keep the last min(S, window) positions in a ring buffer
        W = cache["k"].shape[1]
        keep = min(S, W)
        pos = torch.arange(S - keep, S, device=x.device)
        slots = pos % W
        cache["k"][:, slots] = k[:, S - keep:].to(cache["k"].dtype)
        cache["v"][:, slots] = v[:, S - keep:].to(cache["v"].dtype)
        cache["pos"][slots] = pos.to(cache["pos"].dtype)
        return out, cache

    # decode: S == 1, pos a host int
    pos = ctx["pos"]
    ck, cv = cache["k"], cache["v"]
    if kind == ATTN:
        ck[:, pos] = k[:, 0].to(ck.dtype)
        cv[:, pos] = v[:, 0].to(cv.dtype)
        out = L.attention(q, ck.to(q.dtype), cv.to(q.dtype), causal=True,
                          q_offset=pos, kv_len=pos + 1)
        return out, cache
    slot = pos % ck.shape[1]
    ck[:, slot] = k[:, 0].to(ck.dtype)
    cv[:, slot] = v[:, 0].to(cv.dtype)
    cache["pos"][slot] = pos
    out = L.attention(q, ck.to(q.dtype), cv.to(q.dtype), causal=True,
                      q_offset=pos, window=window, k_positions=cache["pos"])
    return out, cache


# ---------------------------------------------------------------------------
# unified block apply
# ---------------------------------------------------------------------------
def apply_block(p: dict, cfg: ModelConfig, kind: str, x: torch.Tensor,
                ctx: dict):
    """Returns (x, cache, moe_aux_loss)."""
    if kind in _LATER:
        raise NotImplementedError(_LATER[kind])
    if kind not in (ATTN, LOCAL):
        raise ValueError(kind)
    cache = ctx.get("cache") or {}
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    sub_ctx = dict(ctx, cache=cache.get("self"))
    mix, self_cache = _attn_mix(p["attn"], cfg, kind, h, sub_ctx)
    x = x + torch.einsum("bshk,hkd->bsd", mix, p["attn"]["wo"])
    new_cache = {}
    if self_cache is not None:
        new_cache["self"] = self_cache
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    y, aux = apply_mlp(p["mlp"], cfg, h)
    x = x + y
    return x, (new_cache or None), aux


# ---------------------------------------------------------------------------
# per-block cache construction (zeros; the ring buffer's positions -1)
# ---------------------------------------------------------------------------
def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     dtype, *, cross_len: int = 0, device=None):
    """Returns (cache, axes) twin trees for one block, on ``device``."""
    if kind in _LATER:
        raise NotImplementedError(_LATER[kind])
    if cross_len:
        raise NotImplementedError(
            "cross-attention caches come with the enc-dec slice "
            "(ROADMAP Queue 1 #13e)")
    Hkv, Dh = cfg.n_kv_heads, cfg.d_head
    kv_axes = ("batch", "seq", "kv_heads", "head_dim")
    if kind == ATTN:
        c = {
            "self": {
                "k": _zeros((batch, max_len, Hkv, Dh), kv_axes, dtype,
                            device=device),
                "v": _zeros((batch, max_len, Hkv, Dh), kv_axes, dtype,
                            device=device),
            }
        }
    elif kind == LOCAL:
        W = min(cfg.window, max_len) if cfg.window else max_len
        c = {
            "self": {
                "k": _zeros((batch, W, Hkv, Dh), kv_axes, dtype,
                            device=device),
                "v": _zeros((batch, W, Hkv, Dh), kv_axes, dtype,
                            device=device),
                "pos": _const(lambda: torch.full((W,), -1), (W,), ("seq",),
                              torch.int32, device=device),
            }
        }
    else:
        raise ValueError(kind)
    return split_pt(c)
