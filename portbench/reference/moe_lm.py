"""Plain decoder-only language model with token-choice mixture-of-experts
MLPs (granite-moe-1b-a400m's shape), in fp32.

Every layer is pre-norm: ``x += attn(rms(x))``, then ``x += moe(rms(x))``.

* RMSNorm over the last axis, eps ``norm_eps``, scaled by ``1 + scale``.
* Attention: causal, ``n_heads`` query heads sharing ``n_kv_heads`` key and
  value heads, width ``d_head``; rotary embedding on q and k (the
  half-split rotation, frequencies ``theta ** (-i / (d_head / 2))``);
  scores scaled by ``1 / sqrt(d_head)``.
* MoE: router logits ``h @ router``, softmax over ``n_experts``; each
  token keeps its ``top_k`` largest probabilities (ties to the lower
  expert), renormalised to sum to one.  An expert takes at most
  ``capacity = ceil(top_k * G * capacity_factor / n_experts)`` routes of
  a group of G tokens, in token-major, slot-minor order; a route past it
  is dropped (weight 0).  Each expert is a SwiGLU MLP ``(silu(x @ wi_gate)
  * (x @ wi_up)) @ wo`` of width ``d_ff``, computed here for exactly the
  tokens routed to it and added back weighted by the gate.  Tokens are
  routed in groups of at most 4096 (halved until they divide the batch).
* Loss: mean next-token cross entropy over the untied ``lm_head``, plus
  ``aux_loss_weight * mean_l(aux_l)`` with the load-balance term ``aux_l =
  n_experts * sum_e (routes to e / G) * mean_g p_e``.

The parameters are a flat dict keyed by path, layer-stacked on the first
axis: ``embed`` [V, D], ``final_norm`` [D], ``lm_head`` [D, V] and, under
``groups/b0/``, ``ln1`` and ``ln2`` [L, D], ``attn/wq`` [L, D, Hq, Dh],
``attn/wk`` and ``attn/wv`` [L, D, Hkv, Dh], ``attn/wo`` [L, Hq, Dh, D],
``mlp/router`` [L, D, E], ``mlp/wi_gate`` and ``mlp/wi_up`` [L, E, D, F]
and ``mlp/wo`` [L, E, F, D].  ``prec`` rounds the operands of every product
but the router's (``precision.round_operand``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .precision import round_operand

GROUP = 4096
P = "groups/b0/"


def shapes(m: dict) -> dict:
    L, D, V = m["n_layers"], m["d_model"], m["vocab"]
    Hq, Hkv, Dh = m["n_heads"], m["n_kv_heads"], m["d_head"]
    E, Fw = m["n_experts"], m["d_ff"]
    return {"embed": (V, D), "final_norm": (D,), "lm_head": (D, V),
            P + "ln1": (L, D), P + "ln2": (L, D),
            P + "attn/wq": (L, D, Hq, Dh), P + "attn/wk": (L, D, Hkv, Dh),
            P + "attn/wv": (L, D, Hkv, Dh), P + "attn/wo": (L, Hq, Dh, D),
            P + "mlp/router": (L, D, E), P + "mlp/wi_gate": (L, E, D, Fw),
            P + "mlp/wi_up": (L, E, D, Fw), P + "mlp/wo": (L, E, Fw, D)}


def _mm(a, b, prec):
    return round_operand(a, prec) @ round_operand(b, prec)


def _rms(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) \
        * (1.0 + scale)


def _rope(x, sin, cos):
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(p, h, m, sin, cos, prec):
    B, S, D = h.shape
    Hq, Hkv, Dh = m["n_heads"], m["n_kv_heads"], m["d_head"]
    q = _mm(h, p["attn/wq"].reshape(D, Hq * Dh), prec)
    k = _mm(h, p["attn/wk"].reshape(D, Hkv * Dh), prec)
    v = _mm(h, p["attn/wv"].reshape(D, Hkv * Dh), prec)
    q = _rope(q.reshape(B, S, Hq, Dh), sin, cos).transpose(1, 2)
    k = _rope(k.reshape(B, S, Hkv, Dh), sin, cos).transpose(1, 2)
    v = v.reshape(B, S, Hkv, Dh).transpose(1, 2)
    rep = Hq // Hkv
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    s = _mm(q, k.transpose(-1, -2), prec) / math.sqrt(Dh)
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    o = _mm(torch.softmax(s, -1), v, prec)               # [B, Hq, S, Dh]
    o = o.transpose(1, 2).reshape(B, S, Hq * Dh)
    return _mm(o, p["attn/wo"].reshape(Hq * Dh, D), prec)


def _moe_group(p, h, m, prec):
    """One group's MoE output [G, D] and its load-balance term."""
    G, D = h.shape
    E, k = m["n_experts"], m["top_k"]
    probs = torch.softmax(h @ p["mlp/router"], -1)              # [G, E]
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    gates = top_p / (top_p.sum(-1, keepdim=True) + 1e-9)
    cap = max(1, math.ceil(k * G * m["capacity_factor"] / E))
    flat = top_e.reshape(-1)                        # token-major order
    onehot = F.one_hot(flat, E)
    place = (torch.cumsum(onehot, 0) - onehot).gather(1, flat[:, None])
    keep = (place[:, 0] < cap).reshape(G, k)
    y = torch.zeros_like(h)
    for e in range(E):
        g_idx, j_idx = torch.nonzero((top_e == e) & keep, as_tuple=True)
        if g_idx.numel() == 0:
            continue
        xe = h[g_idx]
        hid = F.silu(_mm(xe, p["mlp/wi_gate"][e], prec)) \
            * _mm(xe, p["mlp/wi_up"][e], prec)
        ye = _mm(hid, p["mlp/wo"][e], prec)
        y = y.index_add(0, g_idx, ye * gates[g_idx, j_idx][:, None])
    routes = onehot.reshape(G, k, E).sum(1).to(h.dtype)
    aux = E * torch.sum(routes.mean(0) * probs.mean(0))
    return y, aux


def _moe(p, h, m, prec):
    B, S, D = h.shape
    n = B * S
    g = min(GROUP, n)
    while n % g:
        g //= 2
    outs, auxes = [], []
    for xg in h.reshape(n // g, g, D):
        y, a = _moe_group(p, xg, m, prec)
        outs.append(y)
        auxes.append(a)
    return torch.stack(outs).reshape(B, S, D), torch.stack(auxes).mean()


def _layers(p: dict, n_layers: int) -> list:
    """Each layer's leaves, and each expert's weights of a layer, as views
    of the stacked leaves: one ``unbind`` a leaf, whose backward stacks
    the grads once, where an index a layer would add a full-size zero
    grad of the stack for every use."""
    cols = {k[len(P):]: torch.unbind(v) for k, v in p.items()
            if k.startswith(P)}
    out = []
    for l in range(n_layers):
        lp = {k: c[l] for k, c in cols.items()}
        for k in ("mlp/wi_gate", "mlp/wi_up", "mlp/wo"):
            lp[k] = torch.unbind(lp[k])
        out.append(lp)
    return out


def loss(p: dict, batch: dict, m: dict, prec: str = "fp32") -> torch.Tensor:
    tokens, labels = batch["tokens"].long(), batch["labels"].long()
    B, S = tokens.shape
    half = m["d_head"] // 2
    freqs = m["rope_theta"] ** (-torch.arange(half, dtype=torch.float32,
                                              device=tokens.device) / half)
    ang = torch.arange(S, dtype=torch.float32,
                       device=tokens.device)[:, None] * freqs
    sin, cos = torch.sin(ang)[None, :, None], torch.cos(ang)[None, :, None]
    eps = m["norm_eps"]
    x = p["embed"][tokens]
    aux = 0.0
    for lp in _layers(p, m["n_layers"]):
        x = x + _attention(lp, _rms(x, lp["ln1"], eps), m, sin, cos, prec)
        y, a = _moe(lp, _rms(x, lp["ln2"], eps), m, prec)
        x = x + y
        aux = aux + a
    z = _mm(_rms(x, p["final_norm"], eps), p["lm_head"], prec)
    nll = torch.logsumexp(z, -1) - torch.gather(z, -1, labels[..., None])[
        ..., 0]
    return nll.mean() + m["aux_loss_weight"] * aux / m["n_layers"]


def examples(stream, seq_len: int) -> dict:
    """A client's token stream cut into next-token examples: ``tokens``
    [n, S] and ``labels`` [n, S] shifted by one, ``n = (len - 1) // S``."""
    n = (len(stream) - 1) // seq_len
    return {"tokens": stream[: n * seq_len].reshape(n, seq_len),
            "labels": stream[1: n * seq_len + 1].reshape(n, seq_len)}


def batches(client: dict, rows, local_steps: int, b: int) -> list:
    rows = torch.as_tensor(rows, device=client["tokens"].device)
    return [{k: v[rows[h * b:(h + 1) * b]] for k, v in client.items()}
            for h in range(local_steps)]
