"""Primitive layers of the zoo's families, over explicit tensors.

The port's counterpart of the JAX package's ``models/layers.py``: the
norms, 1-D rotary embeddings and M-RoPE (``mrope_tables``), the q-chunked
masked attention (the plain path that ``attention_impl="xla"`` selects,
and decode and cross-attention at any setting), the dense MLP, the
capacity-based token-choice MoE (``moe_apply``), the RG-LRU layer (gates,
the log-depth ``rglru_scan`` for forward and prefill, ``rglru_step`` for
decode, the depthwise ``causal_conv1d``) and the RWKV6 recurrence
(``rwkv6_chunked`` for forward and prefill, the plain path that
``rwkv_impl="xla"`` selects; ``rwkv6_step`` for decode).  Every product of
an activation with a dense weight goes through ``proj``, which
``remat_policy="dots"`` records in the forward and reads back in the
recompute (``models/transformer.py``); ``moe_apply``'s products are
recomputed (its groups may run under ``torch.func.vmap``, whose batched
values cannot be kept past it).  The reference's ``shard`` layout hints
are identities on one card and are left out.
"""
from __future__ import annotations

import math
import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import spans


# ---------------------------------------------------------------------------
# weight products (the "dots" that remat_policy="dots" keeps)
# ---------------------------------------------------------------------------
class _Products(threading.local):
    record: Optional[list] = None     # the forward appends each product
    replay: Optional[list] = None     # the recompute pops them in order


_products = _Products()


def _fold(x: torch.Tensor, w: torch.Tensor, n_in: int):
    K = math.prod(w.shape[:n_in])
    return x.reshape(-1, K), w.reshape(K, -1)


class _SavedProduct(torch.autograd.Function):
    """``proj`` whose value was kept by the forward: returns it without the
    product, and differentiates as the product does (``mm``'s own backward
    formulas on the same folded operands, so the grads are bit-equal to
    the plain path's)."""
    generate_vmap_rule = True

    @staticmethod
    def forward(x, w, n_in, y):
        return y.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, n_in, _ = inputs
        ctx.n_in = n_in
        ctx.save_for_backward(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        x2, w2 = _fold(x, w, ctx.n_in)
        g2 = g.reshape(-1, w2.shape[1])
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = g2.mm(w2.t()).reshape(x.shape)
        if ctx.needs_input_grad[1]:
            gw = x2.t().mm(g2).reshape(w.shape)
        return gx, gw, None, None


def proj(x: torch.Tensor, w: torch.Tensor, n_in: int = 1) -> torch.Tensor:
    """The last ``n_in`` axes of ``x`` contracted with the first ``n_in``
    of the weight ``w`` as one folded ``mm`` ([..., K] @ [K, N]): x
    [..., D] @ w [D, F], ``bsd,dhk->bshk`` and, with ``n_in=2``,
    ``bshk,hkd->bsd``.  Inside a group that ``remat_policy="dots"``
    rematerializes, the forward records the value and the recompute reads
    it back instead of multiplying again."""
    lead = x.shape[:x.dim() - n_in]
    if _products.replay is not None:
        return _SavedProduct.apply(x, w, n_in, _products.replay.pop(0))
    x2, w2 = _fold(x, w, n_in)
    y = (x2 @ w2).reshape(lead + w.shape[n_in:])
    if _products.record is not None:
        _products.record.append(y)
    return y


class recorded_products:
    """``with recorded_products() as ys:`` collects every ``proj`` value
    computed inside, in call order."""

    def __enter__(self) -> list:
        _products.record = []
        return _products.record

    def __exit__(self, *exc):
        _products.record = None


class replayed_products:
    """``with replayed_products(ys):`` makes every ``proj`` inside return
    the next of ``ys`` (as ``_SavedProduct``) instead of computing it; all
    of them must be used."""

    def __init__(self, ys):
        self.ys = list(ys)

    def __enter__(self):
        _products.replay = self.ys

    def __exit__(self, exc_type, *exc):
        left = len(self.ys)
        _products.replay = None
        if exc_type is None and left:
            raise RuntimeError(f"the recompute used {left} fewer weight "
                               f"products than the forward recorded")


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis in fp32, scaled by ``1 + scale``."""
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.to(torch.float32))).to(dtype)


def head_rms_norm(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """qk-norm: RMSNorm over the head_dim of [..., H, Dh]."""
    return rms_norm(x, scale, eps)


# ---------------------------------------------------------------------------
# rotary embeddings (1-D and M-RoPE)
# ---------------------------------------------------------------------------
def _rope_freqs(half: int, theta: float, device) -> torch.Tensor:
    exps = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    return torch.pow(torch.full((), theta, dtype=torch.float32,
                                device=device), exps)


def rope_tables(positions: torch.Tensor, d_head: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [B, S] -> (sin, cos) each [B, S, d_head//2], fp32."""
    freqs = _rope_freqs(d_head // 2, theta, positions.device)
    ang = positions.to(torch.float32)[..., None] * freqs   # [B,S,half]
    return torch.sin(ang), torch.cos(ang)


def mrope_tables(positions: torch.Tensor, d_head: int, theta: float,
                 sections: Tuple[int, ...]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """M-RoPE (Qwen2-VL): positions [3, B, S] (t/h/w ids); the d_head//2
    frequency slots are partitioned into ``sections`` (must sum to
    d_head//2), each driven by its own position stream.  Returns (sin,
    cos) each [B, S, d_head//2], fp32."""
    half = d_head // 2
    assert sum(sections) == half, (sections, half)
    freqs = _rope_freqs(half, theta, positions.device)
    ang_all = positions.to(torch.float32)[..., None] * freqs  # [3,B,S,half]
    pieces = []
    start = 0
    for i, sec in enumerate(sections):
        pieces.append(ang_all[i, ..., start:start + sec])
        start += sec
    ang = torch.cat(pieces, dim=-1)                           # [B,S,half]
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, Dh]; sin/cos [B, S, Dh//2].  Neox-style half rotation,
    in fp32."""
    dtype = x.dtype
    x = x.to(torch.float32)
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    sin = sin[:, :, None, :]
    cos = cos[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dtype)


# ---------------------------------------------------------------------------
# attention (the plain path: q-chunked, so score memory is O(chunk * T) per
# head; the CUDA flash kernel is the fast path for prefill)
# ---------------------------------------------------------------------------
NEG_INF = -1e30


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    if groups == 1:
        return k
    return torch.repeat_interleave(k, groups, dim=2)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True,
              window: int = 0,
              q_offset=0,
              k_positions: Optional[torch.Tensor] = None,
              kv_len=None,
              q_chunk: int = 1024,
              grouped: Optional[bool] = None) -> torch.Tensor:
    """q [B,S,Hq,Dh], k/v [B,T,Hkv,Dh] -> [B,S,Hq,Dh].

    ``q_offset``: absolute position of q[0] (decode / chunked prefill).
    ``k_positions``: absolute position of each cache slot ([T], -1 = empty)
    for ring-buffer (sliding window) caches.
    ``kv_len``: number of valid cache entries (decode; an int, or a [B]
    tensor).
    ``window`` > 0 masks keys older than ``window`` positions.
    ``grouped``: compute GQA without expanding K/V (default: decode only,
    ``S == 1``, as in the reference).
    Scores are fp32 (bf16 products are exact in fp32, so upcasting before
    the product is the reference's ``preferred_element_type``); the
    probabilities are cast to ``v.dtype`` before the PV product, as the
    reference does.
    """
    B, S, Hq, Dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    groups = Hq // Hkv
    if grouped is None:
        grouped = (S == 1)          # decode
    if not grouped and groups > 1:
        k = _repeat_kv(k, groups)
        v = _repeat_kv(v, groups)
        Hkv = Hq
        groups = 1
    scale = 1.0 / math.sqrt(Dh)
    dev = q.device

    if k_positions is not None:
        kpos = k_positions[None, :].to(torch.int64)          # [1,T]
        kv_valid = kpos >= 0
    else:
        kpos = torch.arange(T, device=dev)[None, :]          # [1,T]
        kv_valid = torch.ones((1, T), dtype=torch.bool, device=dev)
    if isinstance(kv_len, int):
        kv_valid = kv_valid & (kpos < kv_len)
    elif kv_len is not None:
        kv_valid = kv_valid & (kpos < kv_len.reshape(-1, 1))
    kf = k.to(torch.float32)

    def block(qb: torch.Tensor, qpos: torch.Tensor) -> torch.Tensor:
        # qb [B,sc,Hq,Dh], qpos [sc]; grouped GQA: q viewed as
        # [B,sc,Hkv,G,Dh] against unexpanded K/V
        sc = qb.shape[1]
        qg = qb.reshape(B, sc, Hkv, groups, Dh).to(torch.float32)
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf) * scale
        qp = qpos[None, :, None] + 0 * kpos[:, None, :]    # [1,sc,T]
        kp = kpos[:, None, :]
        mask = kv_valid[:, None, :]
        if causal:
            mask = mask & (kp <= qp)
        if window and window > 0:
            mask = mask & (kp > qp - window)
        logits = logits.masked_fill(~mask[:, None, None, :, :], NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
        return out.reshape(B, sc, Hq, Dh)

    qpos_all = q_offset + torch.arange(S, device=dev)
    if S <= q_chunk:
        return block(q, qpos_all)

    while S % q_chunk:        # largest power-of-two-ish divisor fallback
        q_chunk //= 2
    outs = [block(q[:, i:i + q_chunk], qpos_all[i:i + q_chunk])
            for i in range(0, S, q_chunk)]
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------
def mlp_apply(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    """Gated (swiglu/geglu, 3 matrices) or plain (gelu, 2 matrices) MLP.
    GELU is the tanh approximation, ``jax.nn.gelu``'s default."""
    if act in ("swiglu", "geglu"):
        g = proj(x, p["wi_gate"])
        u = proj(x, p["wi_up"])
        g = F.silu(g) if act == "swiglu" else F.gelu(g, approximate="tanh")
        h = g * u
    elif act == "gelu":
        h = F.gelu(proj(x, p["wi_up"]), approximate="tanh")
    else:
        raise ValueError(act)
    return proj(h, p["wo"])


# ---------------------------------------------------------------------------
# Mixture of Experts: capacity-based token-choice dispatch in the
# reference's einsum form (dense [G, E, C] dispatch and combine tensors)
# ---------------------------------------------------------------------------
MOE_GROUP = 4096


def one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: exact 0/1 rows, all zero for an id outside
    [0, n).  Made by comparison with an ``arange``: ``F.one_hot`` checks
    its ids' range on the host, which ``torch.func.vmap`` and a CUDA-graph
    capture refuse."""
    ids = torch.arange(n, device=idx.device, dtype=idx.dtype)
    return (idx[..., None] == ids).to(dtype)


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest values, equal
    values by lower index first (a stable descending sort; ``torch.topk``
    promises no order among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_routes(xf: torch.Tensor, router: torch.Tensor, *, n_experts: int,
               top_k_: int, capacity_factor: float):
    """One group's routing, x [G, D] -> (probs [G,E] fp32, gate_idx [G,k],
    gate_vals [G,k] renormalised and zeroed where dropped, pos [G,k] the
    slot within the expert (fp32), keep [G,k], the capacity C, the
    routes' one-hots [G,k,E] fp32).  The router is
    fp32 whatever x's dtype; the capacity is ``ceil(k G cf / E)``; a
    (token, slot) keeps its place while fewer than C earlier ones (in
    token-major, slot-minor order) chose the same expert."""
    G = xf.shape[0]
    f32 = torch.float32
    probs = torch.softmax(xf.to(f32) @ router.to(f32), dim=-1)     # [G,E]
    gate_vals, gate_idx = top_k(probs, top_k_)                      # [G,k]
    gate_vals = gate_vals / (torch.sum(gate_vals, -1, keepdim=True) + 1e-9)
    cap = int(max(1, math.ceil(top_k_ * G * capacity_factor / n_experts)))
    onehot = one_hot(gate_idx, n_experts, f32)                      # [G,k,E]
    # the running count of each expert's (token, slot) routes, in
    # token-major, slot-minor order: a cumsum of 0/1 values, exact in fp32
    # in any order, taken along the last axis of the [E, G*k] transpose
    # (CUDA's scan along a long leading axis of E columns runs E threads)
    counts = torch.cumsum(onehot.reshape(G * top_k_, n_experts).t(), dim=1)
    pos_in_expert = counts.t().reshape(G, top_k_, n_experts) - onehot
    pos = torch.sum(pos_in_expert * onehot, dim=-1)                 # [G,k]
    keep = pos < cap
    return probs, gate_idx, gate_vals * keep, pos, keep, cap, onehot


def moe_dispatch(onehot: torch.Tensor, gate_vals: torch.Tensor,
                 pos: torch.Tensor, keep: torch.Tensor, cap: int):
    """The dense dispatch and combine tensors [G, E, C] fp32 of one
    group's routes (``moe_routes``): 1 (dispatch) or the gate (combine)
    where token g holds slot c of expert e.  Each (g, e, c) has at most
    one (token, slot) term, so both are exact whatever the summation
    order."""
    pos_oh = one_hot(pos, cap, torch.float32) * keep[..., None]
    dispatch = torch.einsum("gke,gkc->gec", onehot, pos_oh)
    combine = torch.einsum("gke,gkc->gec", onehot * gate_vals[..., None],
                           pos_oh)
    return dispatch, combine


def moe_experts(p: dict, xe: torch.Tensor, act: str) -> torch.Tensor:
    """Every expert's MLP on its C slots: xe [E, C, D] -> [E, C, D]."""
    if act in ("swiglu", "geglu"):
        g = torch.bmm(xe, p["wi_gate"])
        u = torch.bmm(xe, p["wi_up"])
        g = F.silu(g) if act == "swiglu" else F.gelu(g, approximate="tanh")
        h = g * u
    else:
        h = F.gelu(torch.bmm(xe, p["wi_up"]), approximate="tanh")
    return torch.bmm(h, p["wo"])


def _moe_group(p: dict, xf: torch.Tensor, *, n_experts: int, top_k_: int,
               capacity_factor: float, act: str):
    """One group of tokens, x [G, D] -> (y [G, D], aux fp32 scalar)."""
    probs, _, gate_vals, pos, keep, cap, onehot = moe_routes(
        xf, p["router"], n_experts=n_experts, top_k_=top_k_,
        capacity_factor=capacity_factor)
    dispatch, combine = moe_dispatch(onehot, gate_vals, pos, keep, cap)
    xe = torch.einsum("gec,gd->ecd", dispatch.to(xf.dtype), xf)     # [E,C,D]
    ye = moe_experts(p, xe, act)
    y = torch.einsum("gec,ecd->gd", combine.to(xf.dtype), ye)

    # Shazeer load-balance aux loss: E * sum_e fraction_e * router_prob_e
    frac = torch.mean(onehot.sum(1), dim=0)                          # [E]
    prob = torch.mean(probs, dim=0)                                  # [E]
    return y, n_experts * torch.sum(frac * prob)


def moe_apply(p: dict, x: torch.Tensor, *, n_experts: int, top_k: int,
              capacity_factor: float, act: str,
              group_size: int = MOE_GROUP, dispatch: str = "map"):
    """x [B,S,D] -> (y [B,S,D], aux_loss fp32 scalar).

    Tokens are routed in groups of ``group_size`` (capacity applies per
    group): with more tokens than that, the group is halved until it
    divides B*S.  ``dispatch="vmap"`` runs the groups batched
    (``torch.func.vmap``), any other value one after another; the aux is
    the groups' mean.  Experts are [E, D, F] / [E, F, D] weights, the
    router [D, E] fp32.  With the recorder's device stamps on, the
    forward and the backward are stamped as the ``moe`` span."""
    marked = spans.backward_span(x, "moe", True)
    with spans.device_span("moe"):
        y, aux = _moe_apply(p, marked, n_experts=n_experts, top_k=top_k,
                            capacity_factor=capacity_factor, act=act,
                            group_size=group_size, dispatch=dispatch)
    if marked is not x:
        y = spans.backward_span(y, "moe", False)
    return y, aux


def _moe_apply(p: dict, x: torch.Tensor, *, n_experts: int, top_k: int,
               capacity_factor: float, act: str, group_size: int,
               dispatch: str):
    B, S, D = x.shape
    kw = dict(n_experts=n_experts, top_k_=top_k,
              capacity_factor=capacity_factor, act=act)
    G_all = B * S
    if G_all <= group_size:
        y, aux = _moe_group(p, x.reshape(G_all, D), **kw)
        return y.reshape(B, S, D), aux
    g = group_size
    while G_all % g:
        g //= 2
    xg = x.reshape(G_all // g, g, D)
    if dispatch == "vmap":
        y, aux = torch.func.vmap(lambda xi: _moe_group(p, xi, **kw))(xg)
    else:
        outs = [_moe_group(p, xi, **kw) for xi in torch.unbind(xg)]
        y = torch.stack([o[0] for o in outs])
        aux = torch.stack([o[1] for o in outs])
    return y.reshape(B, S, D), torch.mean(aux)


# ---------------------------------------------------------------------------
# RG-LRU (Griffin / RecurrentGemma recurrent block mixing)
# ---------------------------------------------------------------------------
_RGLRU_C = 8.0


def _rglru_gates(p: dict, u: torch.Tensor, gate_gather: bool = False):
    """u [B,S,R] -> (log_a [B,S,R] fp32, gated_input [B,S,R] fp32).

    ``gate_gather`` is the reference's sharding hint (gather u before the
    gate matmuls); on one card it changes nothing."""
    f32 = torch.float32
    r_gate = torch.sigmoid(proj(u, p["w_a"]).to(f32))   # recurrence
    i_gate = torch.sigmoid(proj(u, p["w_i"]).to(f32))   # input
    # a = sigmoid(Lambda); a_t = a ** (c * r_t)  -> log a_t
    log_a = -_RGLRU_C * r_gate * F.softplus(p["lam"].to(f32))
    # torch.maximum, not clamp: at a tie it splits the gradient in half,
    # as jnp.maximum does
    b = torch.sqrt(torch.maximum(1.0 - torch.exp(2.0 * log_a),
                                 _scalar(1e-12, log_a)))
    x_in = b * i_gate * u.to(f32)
    return log_a, x_in


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d tensor on ``like``'s device made by a fill, not copied from
    the host (a host copy is refused inside a CUDA-graph capture)."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along axis 1, from h_{-1} = 0, in log depth.

    ``lax.associative_scan``'s odd/even recursion with the reference's
    combine ``(a_l a_r, a_r b_l + b_r)``: adjacent pairs are combined, the
    pairs scanned, and each even position filled from the odd one before
    it, so every h is rounded as the reference's.  Only h is formed; the
    scanned products of a, which no h needs, are not.  a/b [B,S,R] -> h
    [B,S,R] in their dtype."""
    n = a.shape[1]
    if n < 2:
        return b
    odd = _linear_scan(a[:, 0:-1:2] * a[:, 1::2],
                       a[:, 1::2] * b[:, 0:-1:2] + b[:, 1::2])
    h = torch.empty_like(b)
    h[:, 0] = b[:, 0]
    h[:, 1::2] = odd
    h[:, 2::2] = a[:, 2::2] * odd[:, :(n - 1) // 2] + b[:, 2::2]
    return h


def rglru_scan(p: dict, u: torch.Tensor, h0: Optional[torch.Tensor] = None,
               scan_dtype: torch.dtype = torch.float32,
               gate_gather: bool = False):
    """Full-sequence RG-LRU by a log-depth scan (``_linear_scan``).
    u [B,S,R] -> (y [B,S,R] in u's dtype, h_last [B,R] in ``scan_dtype``).

    The gates are fp32 either way; ``scan_dtype=torch.bfloat16`` runs the
    scan in bf16 as the reference's option does.  ``h0`` is folded into the
    first step's input, as in the reference."""
    log_a, x_in = _rglru_gates(p, u, gate_gather)
    a = torch.exp(log_a).to(scan_dtype)
    x_in = x_in.to(scan_dtype)
    if h0 is not None:
        x_in[:, 0] = x_in[:, 0] + a[:, 0] * h0.to(scan_dtype)
    h = _linear_scan(a, x_in)
    return h.to(u.dtype), h[:, -1]


def rglru_step(p: dict, u: torch.Tensor, h: torch.Tensor):
    """Single decode step: u [B,1,R], h [B,R] -> (y [B,1,R], h' fp32)."""
    log_a, x_in = _rglru_gates(p, u)
    h_new = torch.exp(log_a[:, 0]) * h + x_in[:, 0]
    return h_new[:, None].to(u.dtype), h_new


def causal_conv1d(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                  state: Optional[torch.Tensor] = None):
    """Depthwise causal conv.  w [W, R], x [B,S,R]; state [B, W-1, R]
    carries the tail for streaming decode.  Returns (y [B,S,R],
    new_state [B, W-1, R]).  The taps are summed in the reference's order,
    term 0 first, then the bias."""
    W = w.shape[0]
    S = x.shape[1]
    if state is None:
        state = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)                   # [B, S+W-1, R]
    y = xp[:, 0:S] * w[0]
    for i in range(1, W):
        y = y + xp[:, i:i + S] * w[i]
    y = y + b
    return y.to(x.dtype), (xp[:, -(W - 1):] if W > 1 else state)


# ---------------------------------------------------------------------------
# RWKV6 (Finch): chunked linear recurrence with data-dependent decay, the
# plain path (the CUDA rwkv6_scan kernel computes the same chunked form in
# the forward when rwkv_impl="pallas")
# ---------------------------------------------------------------------------
def rwkv6_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  log_w: torch.Tensor, u: torch.Tensor,
                  state: Optional[torch.Tensor] = None,
                  chunk: int = 32) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-head RWKV6 recurrence.

    r/k [B,S,H,Dk], v [B,S,H,Dv], log_w [B,S,H,Dk] (<= 0), u [H,Dk],
    state [B,H,Dk,Dv].  Returns (o [B,S,H,Dv] in v's dtype, state' fp32).

      S_t = diag(w_t) S_{t-1} + k_t v_t^T
      o_t = r_t @ S_{t-1} + (r_t . u . k_t) v_t

    The intra-chunk scores contract r, exp(L_i - L_j) and k pairwise
    (torch's einsum), where XLA contracts the three operands at once: fp32
    sums in another order.
    """
    B, S, H, Dk = r.shape
    Dv = v.shape[-1]
    f32 = torch.float32
    s = (torch.zeros((B, H, Dk, Dv), dtype=f32, device=r.device)
         if state is None else state.to(f32))
    C = min(chunk, S)
    while S % C:          # largest power-of-two-ish divisor fallback
        C //= 2
    n = S // C

    rf = r.to(f32).reshape(B, n, C, H, Dk)
    kf = k.to(f32).reshape(B, n, C, H, Dk)
    vf = v.to(f32).reshape(B, n, C, H, Dv)
    lw = log_w.to(f32).reshape(B, n, C, H, Dk)
    uf = u.to(f32)

    # exclusive/inclusive cumulative log-decay within each chunk
    L_incl = torch.cumsum(lw, dim=2)              # sum_{t<=i}
    L_excl = L_incl - lw                          # sum_{t<i}
    L_end = L_incl[:, :, -1]                      # [B,n,H,Dk]

    idx = torch.arange(C, device=r.device)
    intra_mask = (idx[:, None] > idx[None, :]).to(f32)   # strict lower
    # ddiff is exactly 0 at j = i - 1: torch.minimum splits the gradient
    # there as jnp.minimum does (clamp would pass all of it)
    zero = torch.zeros((), dtype=f32, device=r.device)

    outs = []
    for c in range(n):
        rc, kc, vc = rf[:, c], kf[:, c], vf[:, c]
        le, li, lend = L_excl[:, c], L_incl[:, c], L_end[:, c]
        # inter-chunk: o_i += (r_i * exp(L_excl_i)) @ S
        r_dec = rc * torch.exp(le)                # [B,C,H,Dk], exp<=1
        o = torch.einsum("bchk,bhkv->bchv", r_dec, s)
        # intra-chunk: o_i += sum_{j<i} (r_i . exp(L_i - L_{j+1}) . k_j) v_j
        #            + u-bonus diagonal term
        ddiff = le[:, :, None] - li[:, None, :]   # [B,C(i),C(j),H,Dk]
        att = torch.einsum("bihk,bijhk,bjhk->bijh", rc,
                           torch.exp(torch.minimum(ddiff, zero)), kc)
        att = att * intra_mask[None, :, :, None]
        diag = torch.einsum("bchk,hk,bchk->bch", rc, uf, kc)
        o = o + torch.einsum("bijh,bjhv->bihv", att, vc)
        o = o + diag[..., None] * vc
        # state update: S' = diag(exp(L_end)) S + sum_j exp(L_end-L_incl_j)
        # k_j v_j^T
        k_dec = kc * torch.exp(lend[:, None] - li)   # exp<=1
        s = (torch.einsum("bhk,bhkv->bhkv", torch.exp(lend), s)
             + torch.einsum("bchk,bchv->bhkv", k_dec, vc))
        outs.append(o)
    o = torch.stack(outs, dim=1).reshape(B, S, H, Dv)
    return o.to(v.dtype), s


def rwkv6_step(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               log_w: torch.Tensor, u: torch.Tensor, state: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single decode step.  r/k/log_w [B,1,H,Dk], v [B,1,H,Dv],
    state [B,H,Dk,Dv] -> (o [B,1,H,Dv] in v's dtype, state' fp32)."""
    f32 = torch.float32
    rf = r.to(f32)[:, 0]
    kf = k.to(f32)[:, 0]
    vf = v.to(f32)[:, 0]
    w = torch.exp(log_w.to(f32))[:, 0]
    state = state.to(f32)
    o = (torch.einsum("bhk,bhkv->bhv", rf, state)
         + torch.einsum("bhk,hk,bhk->bh", rf, u.to(f32), kf)[..., None] * vf)
    state = w[..., None] * state + torch.einsum("bhk,bhv->bhkv", kf, vf)
    return o[:, None].to(v.dtype), state
