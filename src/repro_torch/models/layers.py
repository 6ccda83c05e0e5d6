"""Primitive layers of the zoo's families, over explicit tensors.

The port's counterpart of the JAX package's ``models/layers.py``: the
norms, 1-D rotary embeddings and M-RoPE (``mrope_tables``), the q-chunked
masked attention (the plain path that ``attention_impl="xla"`` selects,
and decode and cross-attention at any setting), the dense MLP, the
capacity-based token-choice MoE (``moe_apply``: the reference's routes,
tokens moved into the experts' slots and back by index, where the
reference multiplies by dense one-hot tensors), the RG-LRU layer (gates,
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
from repro_torch.kernels.moe_route import ops as moe_route


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
# Mixture of Experts: capacity-based token-choice routing, the reference's
# routes and [E, C, D] expert slots, with tokens moved into the slots and
# back by index (kernels/moe_route) where the reference multiplies by dense
# one-hot [G, E, C] dispatch and combine tensors
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
    routes' one-hots [G,k,E] fp32).  The router is fp32 whatever x's
    dtype; the capacity is ``ceil(k G cf / E)``; a (token, slot) keeps its
    place while fewer than C earlier ones (in token-major, slot-minor
    order) chose the same expert.  Leading dimensions of x (and a router
    [..., D, E] that broadcasts against them) are independent groups."""
    lead, G = xf.shape[:-2], xf.shape[-2]
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
    flat = onehot.reshape(*lead, G * top_k_, n_experts)
    counts = torch.cumsum(flat.transpose(-1, -2), dim=-1).transpose(-1, -2)
    pos_in_expert = counts.reshape(*lead, G, top_k_, n_experts) - onehot
    pos = torch.sum(pos_in_expert * onehot, dim=-1)                 # [G,k]
    keep = pos < cap
    return probs, gate_idx, gate_vals * keep, pos, keep, cap, onehot


def moe_dispatch(onehot: torch.Tensor, gate_vals: torch.Tensor,
                 pos: torch.Tensor, keep: torch.Tensor, cap: int):
    """The dense dispatch and combine tensors [G, E, C] fp32 of one
    group's routes (``moe_routes``): 1 (dispatch) or the gate (combine)
    where token g holds slot c of expert e.  Each (g, e, c) has at most
    one (token, slot) term, so both are exact whatever the summation
    order.  The reference's form, on no path of the port: the yardstick
    that the tests and ``chip_smoke.py`` hold the index form to."""
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


def _per_group(w: Optional[torch.Tensor], N: int):
    """A weight [Nw, ...] of N groups (Nw divides N, group n uses weight
    n // (N / Nw)) as [N, ...]: a copy where Nw < N."""
    if w is None or w.shape[0] == N:
        return w
    r = N // w.shape[0]
    return w[:, None].expand(w.shape[0], r, *w.shape[1:]).reshape(
        N, *w.shape[1:])


def _group_forward(x, router, wi_gate, wi_up, wo, E, k, cf, act):
    """N groups, x [N, G, D], router [Nr, D, E], experts [Nw, E, ...] (Nr,
    Nw dividing N) -> (y [N, G, D], aux [N], and what the backward reads:
    probs, gate_idx, gate, slot, owner, frac, xe, g, u, ye)."""
    N, G, D = x.shape
    probs, gate_idx, gate, pos, keep, cap, onehot = moe_routes(
        x, _per_group(router, N), n_experts=E, top_k_=k, capacity_factor=cf)
    slot, owner = moe_route.route_tables(gate_idx, pos, keep, cap, E)
    xe = moe_route.gather_rows(x, owner, None, k)              # [N,E*C,D]
    # moe_experts' products, with the pre-activations the backward reads:
    # g the gate product (u again for the ungated gelu), u the up product
    xe3 = xe.reshape(N * E, cap, D)
    wu = _per_group(wi_up, N).flatten(0, 1)
    if act in ("swiglu", "geglu"):
        g = torch.bmm(xe3, _per_group(wi_gate, N).flatten(0, 1))
        u = torch.bmm(xe3, wu)
        a = F.silu(g) if act == "swiglu" else F.gelu(g, approximate="tanh")
        h = a * u
    else:
        u = g = torch.bmm(xe3, wu)
        h = F.gelu(u, approximate="tanh")
    ye = torch.bmm(h, _per_group(wo, N).flatten(0, 1)).reshape(N, E * cap, D)
    y = moe_route.sum_rows(ye, slot, gate.to(x.dtype))
    # Shazeer load-balance aux loss: E * sum_e fraction_e * router_prob_e
    frac = torch.mean(onehot.sum(-2), dim=-2)                       # [N,E]
    prob = torch.mean(probs, dim=-2)                                # [N,E]
    aux = E * torch.sum(frac * prob, dim=-1)
    return y, aux, probs, gate_idx, gate, slot, owner, frac, xe, g, u, ye


def _group_backward(dy, daux, x, router, wi_gate, wi_up, wo, probs,
                    gate_idx, gate, slot, owner, frac, xe, g, u, ye, E, k,
                    act):
    """The gradients of ``_group_forward``'s (y, aux) with respect to x,
    the router and the experts, each per group ([N, ...]): the formulas
    autograd runs for the same operations (``silu_backward``,
    ``gelu_backward``, ``_softmax_backward_data``, each product's two
    transposed products), with the combine's and the dispatch's own
    gradients by index (d ye: dy into the slots, weighted by the gate;
    the gate's: <dy, ye[slot]>; dx: the sum of a token's slots)."""
    N, G, D = x.shape
    dt, f32 = x.dtype, probs.dtype
    cap = owner.shape[-1] // E
    if dy is None:
        dy = torch.zeros_like(x)
    dye = moe_route.gather_rows(dy, owner, gate.to(dt), k)
    dgate = moe_route.route_dots(dy, ye, slot).to(f32)
    # the experts, as autograd differentiates moe_experts
    router = _per_group(router, N)
    p = {n: None if w is None else _per_group(w, N).flatten(0, 1)
         for n, w in (("wi_gate", wi_gate), ("wi_up", wi_up), ("wo", wo))}
    xe3, dye3 = xe.reshape(N * E, cap, D), dye.reshape(N * E, cap, D)
    gated = act in ("swiglu", "geglu")
    if gated:
        a = F.silu(g) if act == "swiglu" else F.gelu(g, approximate="tanh")
        h = a * u
    else:
        h = F.gelu(u, approximate="tanh")
    dh = torch.bmm(dye3, p["wo"].transpose(1, 2))
    dwo = torch.bmm(h.transpose(1, 2), dye3)
    if gated:
        da, du = dh * u, dh * a
        dg = (torch.ops.aten.silu_backward(da, g) if act == "swiglu" else
              torch.ops.aten.gelu_backward(da, g, approximate="tanh"))
        dwg = torch.bmm(xe3.transpose(1, 2), dg)
        dxe = (torch.bmm(dg, p["wi_gate"].transpose(1, 2))
               + torch.bmm(du, p["wi_up"].transpose(1, 2)))
    else:
        du = torch.ops.aten.gelu_backward(dh, u, approximate="tanh")
        dwg = None
        dxe = torch.bmm(du, p["wi_up"].transpose(1, 2))
    dwu = torch.bmm(xe3.transpose(1, 2), du)
    dx = moe_route.sum_rows(dxe.reshape(N, E * cap, D), slot, None)
    # the routes: gate = top_k(probs) / (sum + 1e-9) * keep
    dgv = dgate * (slot >= 0)
    tv = torch.gather(probs, -1, gate_idx)
    den = torch.sum(tv, -1, keepdim=True) + 1e-9
    dtv = dgv / den + torch.sum(-dgv * (tv / den / den), -1, keepdim=True)
    dprobs = torch.zeros_like(probs).scatter(-1, gate_idx, dtv)
    if daux is not None:       # aux = E sum_e frac_e mean_g probs[g, e]
        dprobs = dprobs + ((daux * E)[:, None] * frac / G)[:, None, :]
    dlogits = torch.ops.aten._softmax_backward_data(dprobs, probs, -1, f32)
    dx = dx + (dlogits @ router.to(f32).transpose(-1, -2)).to(dt)
    drouter = (x.to(f32).transpose(-1, -2) @ dlogits).to(router.dtype)
    return (dx, drouter,
            None if dwg is None else dwg.reshape(N, E, D, -1),
            dwu.reshape(N, E, D, -1), dwo.reshape(N, E, -1, D))


def _fold_groups(batch: int, in_dims, args, rows):
    """Each tensor argument with its vmapped dimension first, folded into
    its group dimension ([B, N, ...] -> [B * N, ...]).  An unbatched one
    is kept where it is a weight of one group for all (``rows`` False:
    the groups share it) and expanded where every group needs its own
    row (``rows`` True)."""
    out = []
    for a, d, row in zip(args, in_dims, rows):
        if not isinstance(a, torch.Tensor):
            out.append(a)
            continue
        if d is None:
            if not row and a.shape[0] == 1:
                out.append(a)
                continue
            a, d = a.expand(batch, *a.shape), 0
        a = a.movedim(d, 0)
        out.append(a.reshape(batch * a.shape[1], *a.shape[2:]))
    return out


def _unfold_groups(batch: int, outs):
    return (tuple(None if o is None else
                  o.reshape(batch, o.shape[0] // batch, *o.shape[1:])
                  for o in outs),
            tuple(None if o is None else 0 for o in outs))


class _MoEGroup(torch.autograd.Function):
    """N groups of tokens through the MoE MLP as one autograd node:
    x [N, G, D], the router [Nr, D, E] and the experts [Nw, E, ...] (Nr
    and Nw dividing N: group n uses weight n // (N / Nw), as folding a
    batched level of clients over an unbatched one of groups lays them
    out) -> (y [N, G, D], aux [N] fp32).

    Forward and backward run the routes, the moves by index and the
    experts on plain tensors: the ``vmap`` rule folds every batched level
    (the round engine's clients, the grouped MoE's groups) into N, so the
    per-operation cost of ``torch.func``'s wrappers is paid once for the
    node, not for each of its operations.  The backward is another such
    node (``_MoEGroupBackward``), and returns each weight's gradient per
    group, summed here over the groups that share the weight.  Not
    differentiable twice: nothing in the port takes a second derivative."""

    @staticmethod
    def forward(x, router, wi_gate, wi_up, wo, E, k, cf, act):
        return _group_forward(x, router, wi_gate, wi_up, wo, E, k, cf, act)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.cfg = inputs[5:]
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(*output[2:])
        ctx.save_for_backward(*inputs[:5], *output[2:])

    @staticmethod
    def backward(ctx, dy, daux, *_):
        x, router, wi_gate, wi_up, wo, *saved = ctx.saved_tensors
        E, k, _, act = ctx.cfg
        grads = _MoEGroupBackward.apply(dy, daux, x, router, wi_gate, wi_up,
                                        wo, *saved, E, k, act)
        n = x.shape[0]
        out = [grads[0]]
        for gw, w in zip(grads[1:], (router, wi_gate, wi_up, wo)):
            if gw is not None and w.shape[0] < n:
                gw = gw.reshape(w.shape[0], n // w.shape[0],
                                *gw.shape[1:]).sum(1)
            out.append(gw)
        return (*out, None, None, None, None)

    @staticmethod
    def vmap(info, in_dims, *args):
        rows = (True, False, False, False, False) + (False,) * 4
        return _unfold_groups(info.batch_size, _MoEGroup.apply(
            *_fold_groups(info.batch_size, in_dims, args, rows)))


class _MoEGroupBackward(torch.autograd.Function):
    """``_group_backward`` as one node with a ``vmap`` rule."""

    @staticmethod
    def forward(*args):
        return _group_backward(*args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("the MoE group's backward is not differentiable")

    @staticmethod
    def vmap(info, in_dims, *args):
        # dy, daux, x: rows; router and experts: weights; the saved
        # routes and activations: rows; E, k, act
        rows = (True, True, True) + (False,) * 4 + (True,) * 10 + (False,) * 3
        return _unfold_groups(info.batch_size, _MoEGroupBackward.apply(
            *_fold_groups(info.batch_size, in_dims, args, rows)))


def _moe_group(p: dict, xf: torch.Tensor, *, n_experts: int, top_k_: int,
               capacity_factor: float, act: str):
    """One group of tokens, x [G, D] -> (y [G, D], aux fp32 scalar)."""
    w = [None if p.get(n) is None else p[n][None]
         for n in ("router", "wi_gate", "wi_up", "wo")]
    y, aux, *_ = _MoEGroup.apply(xf[None], *w, n_experts, top_k_,
                                 capacity_factor, act)
    return y[0], aux[0]


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
