"""Residual blocks of the zoo (ATTN / LOCAL / RGLRU / RWKV) with the
reference's ``init_block`` / ``apply_block`` / ``init_block_cache``
interface.

The port's counterpart of the JAX package's ``models/blocks.py`` for global
and sliding-window attention blocks (with a dense or MoE MLP, and with
cross-attention in an encoder-decoder's decoder), the RG-LRU recurrent
block (conv1d + RG-LRU mixing) and the RWKV6 block (time mix + channel
mix).  ``apply_block(p, cfg, kind, x, ctx)`` returns ``(x, cache, aux)``
where ``ctx`` carries mode ('train' | 'prefill' | 'decode'), rope tables,
the per-block cache, the decode position and (enc-dec) the encoder output
(``enc_vk``, see ``_cross_mix``); aux is the MoE load-balance loss (a
tensor) or 0.0.  Caches are updated in place (slice assignment or
``copy_`` into the tensors ``init_block_cache`` allocated, which may be
views of a stacked cache) and returned, where the reference returns new
arrays from ``dynamic_update_slice`` on a donated cache.

``KeyGen(None)`` puts the builders in *abstract* mode, as in the
reference: every leaf is an empty tensor on the meta device with its real
shape and dtype (no memory, no draw), so the logical-axis trees and the
dry run's inputs exist for models that fit no host or card
(``transformer.abstract_params``, ``launch/dryrun.py``).  A cache built on
the meta device (``init_block_cache(..., abstract=True)`` or
``device="meta"``) is abstract the same way.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch import random as prng
from repro_torch.models import layers as L
from repro_torch.models.config import ATTN, LOCAL, RGLRU, RWKV, ModelConfig

# ---------------------------------------------------------------------------
# declarative parameter construction: every init returns (params, axes) trees
# with identical structure; axes leaves are tuples of logical axis names.
# ---------------------------------------------------------------------------
META = torch.device("meta")


class KeyGen:
    """Splits keys for materialized init: each call returns a fresh subkey,
    ``key, sub = split(key)`` as the reference's ``KeyGen`` does.  Draws
    land on the key's device.  ``KeyGen(None)`` is abstract: its device
    is the meta device and it hands out no keys."""

    def __init__(self, key: Optional[torch.Tensor]):
        self._key = key

    @property
    def abstract(self) -> bool:
        return self._key is None

    @property
    def device(self) -> torch.device:
        return META if self._key is None else self._key.device

    def __call__(self) -> Optional[torch.Tensor]:
        if self._key is None:
            return None
        pair = prng.split(self._key)
        self._key = pair[0]
        return pair[1]


def _abstract(shape, axes, dtype):
    return torch.empty(shape, dtype=dtype, device=META), axes


def _dense(kg: KeyGen, shape, axes, dtype, scale: Optional[float] = None):
    if kg.abstract:
        return _abstract(shape, axes, dtype)
    fan_in = shape[0] if len(shape) == 1 else math.prod(shape[:-1])
    if scale is None:
        scale = 1.0 / math.sqrt(max(fan_in, 1))
    arr = prng.normal(kg(), shape).mul_(scale)
    return arr.to(dtype), axes


def _normal(kg: KeyGen, shape, axes, dtype, stddev: float):
    if kg.abstract:
        return _abstract(shape, axes, dtype)
    arr = prng.normal(kg(), shape).mul_(stddev)
    return arr.to(dtype), axes


def _zeros(shape, axes, dtype, *, kg: Optional[KeyGen] = None, device=None):
    """Zeros on ``device`` (default: the key generator's device); on the
    meta device an empty tensor."""
    device = torch.device(kg.device if device is None else device)
    if device.type == "meta":
        return _abstract(shape, axes, dtype)
    return torch.zeros(shape, dtype=dtype, device=device), axes


def _const(val_fn, shape, axes, dtype, *, kg: Optional[KeyGen] = None,
           device=None):
    """val_fn: () -> array-like, on ``device`` (default: the key
    generator's device); evaluated only off the meta device."""
    device = torch.device(kg.device if device is None else device)
    if device.type == "meta":
        return _abstract(shape, axes, dtype)
    v = val_fn() if callable(val_fn) else val_fn
    return torch.as_tensor(v, dtype=dtype, device=device).reshape(shape), axes


def linspace_f32(start: float, stop: float, num: int) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)`` in float32 by its own formula:
    ``start * (1 - step) + stop * step`` with ``step = iota * (1 / div)``
    (XLA's division by a constant), then ``stop`` appended; on the CPU.
    ``torch.linspace`` rounds otherwise (2,739 of 4,096 values differ at
    rwkv6-7b's width).  XLA's CPU code contracts some of these
    multiply-adds into FMAs, so the reference's values may still differ by
    a float32 ulp or so (ROADMAP Queue 3)."""
    f32 = torch.float32
    lo, hi = torch.tensor(start, dtype=f32), torch.tensor(stop, dtype=f32)
    recip = torch.tensor(1.0, dtype=f32) / torch.tensor(num - 1.0, dtype=f32)
    step = torch.arange(num - 1, dtype=f32) * recip
    return torch.cat([lo * (1 - step) + hi * step, hi.reshape(1)])


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
# MLP / MoE params
# ---------------------------------------------------------------------------
def init_mlp(kg: KeyGen, cfg: ModelConfig, dtype):
    D, F = cfg.d_model, cfg.d_ff
    if cfg.moe:
        E = cfg.moe.n_experts
        ed, ef = ("expert", "embed", "expert_mlp"), ("expert", "expert_mlp",
                                                     "embed")
        pairs = {
            "router": _dense(kg, (D, E), ("embed", "expert"), torch.float32),
            "wi_up": _dense(kg, (E, D, F), ed, dtype),
            "wo": _dense(kg, (E, F, D), ef, dtype),
        }
        if cfg.act in ("swiglu", "geglu"):
            pairs["wi_gate"] = _dense(kg, (E, D, F), ed, dtype)
        return split_pt(pairs)
    pairs = {
        "wi_up": _dense(kg, (D, F), ("embed", "mlp"), dtype),
        "wo": _dense(kg, (F, D), ("mlp", "embed"), dtype),
    }
    if cfg.act in ("swiglu", "geglu"):
        pairs["wi_gate"] = _dense(kg, (D, F), ("embed", "mlp"), dtype)
    return split_pt(pairs)


def apply_mlp(p: dict, cfg: ModelConfig, x: torch.Tensor):
    if cfg.moe:
        return L.moe_apply(p, x, n_experts=cfg.moe.n_experts,
                           top_k=cfg.moe.top_k,
                           capacity_factor=cfg.moe.capacity_factor,
                           act=cfg.act, dispatch=cfg.moe_dispatch)
    return L.mlp_apply(p, x, cfg.act), 0.0


# ---------------------------------------------------------------------------
# attention blocks (global + sliding window, optional cross-attention)
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


def init_rwkv_block(kg: KeyGen, cfg: ModelConfig, dtype):
    """The RWKV6 block's parameters, drawn in the reference's order."""
    D, F = cfg.d_model, cfg.d_ff
    H, Dh = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    Lo = cfg.rwkv_decay_lora
    f32 = torch.float32
    hk = ("embed", "heads", "head_dim")
    sub = {
        "ln1": _zeros((D,), ("embed",), f32, kg=kg),
        "tm": split_pt({
            "mu": _const(lambda: torch.full((5, D), 0.5), (5, D),
                         (None, "embed"), f32, kg=kg),
            "w_r": _dense(kg, (D, H, Dh), hk, dtype),
            "w_k": _dense(kg, (D, H, Dh), hk, dtype),
            "w_v": _dense(kg, (D, H, Dh), hk, dtype),
            "w_g": _dense(kg, (D, H, Dh), hk, dtype),
            # decay base: per-channel ramp in log-decay space
            "w0": _const(lambda: linspace_f32(-6.0, -0.3, D), (H, Dh),
                         ("heads", "head_dim"), f32, kg=kg),
            "lora_a": _dense(kg, (D, Lo), ("embed", "lora"), dtype),
            "lora_b": _dense(kg, (Lo, H, Dh), ("lora", "heads", "head_dim"),
                             dtype, scale=1e-2),
            "u": _zeros((H, Dh), ("heads", "head_dim"), f32, kg=kg),
            "ln_x": _zeros((H, Dh), ("heads", "head_dim"), f32, kg=kg),
            "w_o": _dense(kg, (H, Dh, D), ("heads", "head_dim", "embed"),
                          dtype),
        }),
        "ln2": _zeros((D,), ("embed",), f32, kg=kg),
        "cm": split_pt({
            "mu": _const(lambda: torch.full((2, D), 0.5), (2, D),
                         (None, "embed"), f32, kg=kg),
            "w_r": _dense(kg, (D, D), (None, "embed"), dtype),
            "w_k": _dense(kg, (D, F), ("embed", "mlp"), dtype),
            "w_v": _dense(kg, (F, D), ("mlp", "embed"), dtype),
        }),
    }
    return split_pt(sub)


def init_rglru_block(kg: KeyGen, cfg: ModelConfig, dtype):
    """The RG-LRU block's parameters, drawn in the reference's order: ``lam``
    takes its key where the dict is built, between ``conv_w`` and
    ``w_a``."""
    D, R, W = cfg.d_model, cfg.rnn_d, cfg.conv_width
    f32 = torch.float32

    def lam_init():
        # softplus^-1 of -log(a)/c with a ~ U(0.9, 0.999)
        a = prng.uniform(kg(), (R,), 0.9, 0.999)
        return torch.log(torch.expm1(-torch.log(a) / L._RGLRU_C))

    sub = {
        "ln1": _zeros((D,), ("embed",), f32, kg=kg),
        "w_x": _dense(kg, (D, R), ("embed", "rnn"), dtype),
        "w_y": _dense(kg, (D, R), ("embed", "rnn"), dtype),
        "conv_w": _dense(kg, (W, R), ("conv", "rnn"), dtype,
                         scale=1.0 / math.sqrt(W)),
        "conv_b": _zeros((R,), ("rnn",), dtype, kg=kg),
        "lam": _const(lam_init, (R,), ("rnn",), f32, kg=kg),
        "w_a": _dense(kg, (R, R), (None, "rnn"), dtype),
        "w_i": _dense(kg, (R, R), (None, "rnn"), dtype),
        "w_o": _dense(kg, (R, D), ("rnn", "embed"), dtype),
        "ln2": _zeros((D,), ("embed",), f32, kg=kg),
        "mlp": init_mlp(kg, cfg, dtype),
    }
    return split_pt(sub)


def init_block(kg: KeyGen, cfg: ModelConfig, kind: str, dtype, *,
               cross: bool = False):
    """One block's parameters, drawn in the reference's order; ``cross``
    adds an ATTN / LOCAL block's cross-attention (``lnx``, then ``xattn``
    with as many KV heads as query heads) after its MLP."""
    if kind not in (ATTN, LOCAL, RGLRU, RWKV):
        raise ValueError(kind)
    if kind == RWKV:
        return init_rwkv_block(kg, cfg, dtype)
    if kind == RGLRU:
        return init_rglru_block(kg, cfg, dtype)
    D = cfg.d_model
    sub = {
        "ln1": _zeros((D,), ("embed",), torch.float32, kg=kg),
        "attn": init_attn_params(kg, cfg, dtype),
        "ln2": _zeros((D,), ("embed",), torch.float32, kg=kg),
        "mlp": init_mlp(kg, cfg, dtype),
    }
    if cross:
        sub["lnx"] = _zeros((D,), ("embed",), torch.float32, kg=kg)
        sub["xattn"] = init_attn_params(kg, cfg, dtype, kv_heads=cfg.n_heads)
    return split_pt(sub)


def _project_qkv(p: dict, cfg: ModelConfig, x: torch.Tensor, rope):
    q = L.proj(x, p["wq"])
    k = L.proj(x, p["wk"])
    v = L.proj(x, p["wv"])
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


def _cross_mix(p: dict, cfg: ModelConfig, x: torch.Tensor, ctx: dict):
    """Encoder-decoder cross-attention (full heads, no rope, non-causal),
    on the plain attention path as in the reference.  Train and prefill
    project the encoder's output, ``ctx['enc_vk']``: the same tensor
    once for the V and once for the K projection.  A remat node takes
    them as two inputs, in that order, so their grads reach the encoder
    one at a time in the order they do without remat (V's first: it was
    projected last), and fp32 sums them alike.  Prefill writes those K/V
    into the cache (sized to the encoder's length by
    ``transformer.prefill``), decode reads them.  Returns (out, cache),
    the cache None in train mode."""
    mode = ctx["mode"]
    cache = ctx.get("cache")
    q = L.proj(x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]
    if mode == "decode":
        out = L.attention(q, cache["xk"].to(q.dtype), cache["xv"].to(q.dtype),
                          causal=False)
        return out, cache
    enc_v, enc_k = ctx["enc_vk"]
    k = L.proj(enc_k, p["wk"])
    v = L.proj(enc_v, p["wv"])
    if cfg.qkv_bias:
        k = k + p["bk"]
        v = v + p["bv"]
    out = L.attention(q, k, v, causal=False)
    if mode == "train":
        return out, None
    cache["xk"].copy_(k)
    cache["xv"].copy_(v)
    return out, cache


# ---------------------------------------------------------------------------
# RG-LRU block
# ---------------------------------------------------------------------------
def _rglru_mix(p: dict, cfg: ModelConfig, x: torch.Tensor, ctx: dict):
    """Returns (out, cache): in prefill and decode the block's ``h`` and
    ``conv`` written in place, in train mode None.  Train and prefill start
    from a zero conv state and h = 0 and never read the cache; decode reads
    both from it."""
    mode = ctx["mode"]
    cache = ctx.get("cache")
    y_gate = torch.nn.functional.gelu(L.proj(x, p["w_y"]),
                                      approximate="tanh")
    u = L.proj(x, p["w_x"])
    conv_state = cache["conv"] if mode == "decode" else None
    u, conv_state = L.causal_conv1d(p["conv_w"], p["conv_b"], u, conv_state)
    if mode == "decode":
        h, h_last = L.rglru_step(p, u, cache["h"])
    else:
        h, h_last = L.rglru_scan(p, u,
                                 scan_dtype=getattr(torch, cfg.rglru_dtype),
                                 gate_gather=cfg.rglru_gate_gather)
        h_last = h_last.to(torch.float32)
    out = L.proj(h * y_gate, p["w_o"])
    if mode == "train":
        return out, None
    cache["h"].copy_(h_last)
    cache["conv"].copy_(conv_state)
    return out, cache


def _apply_rglru_block(p: dict, cfg: ModelConfig, x: torch.Tensor,
                       ctx: dict):
    cache = ctx.get("cache") or {}
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    mix, rnn_cache = _rglru_mix(p, cfg, h, dict(ctx, cache=cache.get("rnn")))
    x = x + mix
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    y, aux = apply_mlp(p["mlp"], cfg, h)
    x = x + y
    return x, (None if rnn_cache is None else {"rnn": rnn_cache}), aux


# ---------------------------------------------------------------------------
# RWKV6 block (time mix + channel mix)
# ---------------------------------------------------------------------------
def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]):
    """x [B,S,D] -> x shifted right by one token; position 0 gets ``prev``
    (decode carry) or zeros."""
    first = (torch.zeros_like(x[:, :1]) if prev is None
             else prev[:, None].to(x.dtype))
    return torch.cat([first, x[:, :-1]], dim=1)


def _rwkv_time_mix(p: dict, cfg: ModelConfig, x: torch.Tensor, ctx: dict):
    """Returns (out, cache): in prefill and decode the block's ``s`` and
    ``tm_prev`` written in place, in train mode None."""
    mode = ctx["mode"]
    cache = ctx.get("cache")
    chunk = ctx.get("rwkv_chunk", cfg.rwkv_chunk)
    prev = cache["tm_prev"] if mode == "decode" else None
    xs = _token_shift(x, prev)
    mu = p["mu"].to(x.dtype)
    # static per-component token-shift interpolation (Finch's ddlerp LoRA is
    # applied to the decay only, as in the reference)
    xr, xk, xv, xw, xg = (x + mu[i] * (xs - x) for i in range(5))
    r = L.proj(xr, p["w_r"])
    k = L.proj(xk, p["w_k"])
    v = L.proj(xv, p["w_v"])
    g = L.proj(xg, p["w_g"])
    # data-dependent decay (the Finch hallmark): log w = -exp(w0 + lora(xw))
    lora = L.proj(torch.tanh(L.proj(xw, p["lora_a"])), p["lora_b"])
    # jnp.clip's gradient: half at either bound (minimum of maximum)
    z = p["w0"].to(torch.float32) + lora.to(torch.float32)
    log_w = -torch.exp(torch.minimum(torch.maximum(z, L._scalar(-20.0, z)),
                                     L._scalar(8.0, z)))
    if mode == "decode":
        o, state = L.rwkv6_step(r, k, v, log_w, p["u"], cache["s"])
    elif cfg.rwkv_impl == "pallas" and mode == "train":
        # the reference's dispatch rule: the kernel returns no state, so it
        # takes the forward only
        from repro_torch.kernels.rwkv6_scan import ops as rwkv6_ops
        o = rwkv6_ops.rwkv6(r, k, v, log_w, p["u"], chunk=chunk)
        state = None
    else:
        o, state = L.rwkv6_chunked(r, k, v, log_w, p["u"], chunk=chunk)
    o = L.head_rms_norm(o, p["ln_x"], cfg.norm_eps)
    o = o * torch.nn.functional.silu(g)
    out = L.proj(o, p["w_o"], 2)
    if mode == "train":
        return out, None
    cache["s"].copy_(state)
    cache["tm_prev"].copy_(x[:, -1])
    return out, cache


def _rwkv_channel_mix(p: dict, cfg: ModelConfig, x: torch.Tensor, ctx: dict):
    """Returns (out, cache): ``cm_prev`` written in place outside train
    mode."""
    mode = ctx["mode"]
    cache = ctx.get("cache")
    prev = cache["cm_prev"] if mode == "decode" else None
    xs = _token_shift(x, prev)
    mu = p["mu"].to(x.dtype)
    xr = x + mu[0] * (xs - x)
    xk = x + mu[1] * (xs - x)
    rgate = torch.sigmoid(L.proj(xr, p["w_r"]))
    kk = torch.square(torch.relu(L.proj(xk, p["w_k"])))
    out = rgate * L.proj(kk, p["w_v"])
    if mode == "train":
        return out, None
    cache["cm_prev"].copy_(x[:, -1])
    return out, cache


def _apply_rwkv_block(p: dict, cfg: ModelConfig, x: torch.Tensor, ctx: dict):
    cache = ctx.get("cache") or {}
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    mix, tm_cache = _rwkv_time_mix(p["tm"], cfg, h,
                                   dict(ctx, cache=cache.get("tm")))
    x = x + mix
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    y, cm_cache = _rwkv_channel_mix(p["cm"], cfg, h,
                                    dict(ctx, cache=cache.get("cm")))
    x = x + y
    new_cache = None if tm_cache is None else {"tm": tm_cache, "cm": cm_cache}
    return x, new_cache, 0.0


# ---------------------------------------------------------------------------
# unified block apply
# ---------------------------------------------------------------------------
def apply_block(p: dict, cfg: ModelConfig, kind: str, x: torch.Tensor,
                ctx: dict):
    """Returns (x, cache, moe_aux_loss)."""
    if kind == RWKV:
        return _apply_rwkv_block(p, cfg, x, ctx)
    if kind == RGLRU:
        return _apply_rglru_block(p, cfg, x, ctx)
    if kind not in (ATTN, LOCAL):
        raise ValueError(kind)
    cache = ctx.get("cache") or {}
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    sub_ctx = dict(ctx, cache=cache.get("self"))
    mix, self_cache = _attn_mix(p["attn"], cfg, kind, h, sub_ctx)
    x = x + L.proj(mix, p["attn"]["wo"], 2)
    new_cache = {}
    if self_cache is not None:
        new_cache["self"] = self_cache
    if "xattn" in p:
        h = L.rms_norm(x, p["lnx"], cfg.norm_eps)
        sub_ctx = dict(ctx, cache=cache.get("cross"))
        mix, cross_cache = _cross_mix(p["xattn"], cfg, h, sub_ctx)
        x = x + L.proj(mix, p["xattn"]["wo"], 2)
        if cross_cache is not None:
            new_cache["cross"] = cross_cache
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    y, aux = apply_mlp(p["mlp"], cfg, h)
    x = x + y
    return x, (new_cache or None), aux


# ---------------------------------------------------------------------------
# per-block cache construction (zeros; the ring buffer's positions -1)
# ---------------------------------------------------------------------------
def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     dtype, *, cross_len: int = 0, device=None,
                     abstract: bool = False):
    """Returns (cache, axes) twin trees for one block, on ``device`` (the
    meta device when ``abstract``); ``cross_len`` adds the cross-attention
    K/V [batch, cross_len, n_heads, d_head]."""
    if abstract:
        device = META
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
    elif kind == RGLRU:
        R, W = cfg.rnn_d, cfg.conv_width
        c = {
            "rnn": {
                "h": _zeros((batch, R), ("batch", "rnn"), torch.float32,
                            device=device),
                "conv": _zeros((batch, W - 1, R), ("batch", None, "rnn"),
                               dtype, device=device),
            }
        }
    elif kind == RWKV:
        H, Dh6 = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
        f32 = torch.float32
        c = {
            "tm": {
                "s": _zeros((batch, H, Dh6, Dh6),
                            ("batch", "heads", "head_dim", None), f32,
                            device=device),
                "tm_prev": _zeros((batch, cfg.d_model), ("batch", "embed"),
                                  f32, device=device),
            },
            "cm": {
                "cm_prev": _zeros((batch, cfg.d_model), ("batch", "embed"),
                                  f32, device=device),
            },
        }
    else:
        raise ValueError(kind)
    if cross_len:
        shape = (batch, cross_len, cfg.n_heads, Dh)
        axes = ("batch", "seq", "heads", "head_dim")
        c["cross"] = {"xk": _zeros(shape, axes, dtype, device=device),
                      "xv": _zeros(shape, axes, dtype, device=device)}
    return split_pt(c)
