"""Server-side federated optimizers — the paper's contribution.

Model averaging is a gradient-based method with the *biased gradient*

    delta_t = sum_{k in S_t} (n_k / n) (w_t - w^k_{t+1})        (eq. 3)

Every server optimizer consumes ``delta_t`` (fp32, already aggregated across
clients) and produces the next server state.  FedAvg and FedMom are
paper-faithful; FedAvgM, FedAdam, FedYogi and FedLaMom are beyond-paper
members of the same family; ``dp`` wraps any of them in central
differential privacy.

Updates are functional: each step returns new tensors and never writes into
the state it was given.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple

import torch

from repro_torch import random as prng
from repro_torch.tree import leaves, tree_map, unflatten_like


class ServerState(NamedTuple):
    w: Any                 # master params, fp32
    extra: Any             # optimizer-specific state (tree or ())
    t: Any                 # round counter: a host int; inside a captured
                           # chunk of rounds a 0-d int64 device tensor


def _f32(x):
    return x.to(torch.float32)


def _zeros_like_f32(w):
    return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                          device=x.device), w)


@dataclass(frozen=True)
class ServerOpt:
    name: str
    init_extra: Callable[[Any], Any]
    apply: Callable[[Any, Any, Any, int], tuple]
    # (w, extra, delta, t) -> (w', extra')

    def init(self, w0) -> ServerState:
        # always copy: the state must never alias the caller's w0
        w0 = tree_map(lambda x: x.to(torch.float32, copy=True), w0)
        return ServerState(w=w0, extra=self.init_extra(w0), t=0)

    def update(self, state: ServerState, delta) -> ServerState:
        delta = tree_map(_f32, delta)
        w, extra = self.apply(state.w, state.extra, delta, state.t)
        t = (state.t + 1 if isinstance(state.t, torch.Tensor)
             else int(state.t) + 1)
        return ServerState(w=w, extra=extra, t=t)


# ---------------------------------------------------------------------------
# paper-faithful
# ---------------------------------------------------------------------------
def fedavg(eta: float = 1.0) -> ServerOpt:
    """Algorithm 1.  eta in [1, K/M]; eta=1 is exact model averaging
    (eq. 2 == eq. 3)."""
    def apply(w, extra, delta, t):
        return tree_map(lambda wi, di: wi - eta * di, w, delta), extra
    return ServerOpt("fedavg", lambda w: (), apply)


def fedmom(eta: float = 1.0, beta: float = 0.9, *,
           use_fused_kernel: bool = False) -> ServerOpt:
    """Algorithm 3 (FedMom): Nesterov's accelerated gradient on the server.

        v_{t+1} = w_t - eta * delta_t
        w_{t+1} = v_{t+1} + beta (v_{t+1} - v_t)

    beta=0.9 everywhere in the paper's experiments.  ``use_fused_kernel``
    routes the elementwise update through ``kernels/fedmom_update`` — on the
    card one hand-written CUDA launch over the whole tree, on the CPU its
    plain version.
    """
    def init_extra(w):
        return {"v": tree_map(torch.clone, w)}   # v_0 = w_0

    def apply(w, extra, delta, t):
        if use_fused_kernel:
            from repro_torch.kernels.fedmom_update import ops as fedmom_ops
            w_new, v_new = fedmom_ops.fused_update_tree(
                w, extra["v"], delta, eta=eta, beta=beta)
            return w_new, {"v": v_new}
        v_new = tree_map(lambda wi, di: wi - eta * di, w, delta)
        w_new = tree_map(lambda vn, vo: vn + beta * (vn - vo), v_new,
                         extra["v"])
        return w_new, {"v": v_new}

    return ServerOpt("fedmom", init_extra, apply)


# ---------------------------------------------------------------------------
# beyond-paper members of the biased-gradient family
# ---------------------------------------------------------------------------
def fedavgm(eta: float = 1.0, beta: float = 0.9, *,
            use_fused_kernel: bool = False) -> ServerOpt:
    """Heavy-ball (Polyak) server momentum on the biased gradient.

    ``use_fused_kernel`` routes the update through ``kernels/fedmom_update``
    (``kind='fedavgm'``), as for ``fedmom``.
    """
    def apply(w, extra, delta, t):
        if use_fused_kernel:
            from repro_torch.kernels.fedmom_update import ops as fedmom_ops
            w_new, m_new = fedmom_ops.fused_avgm_tree(
                w, extra["m"], delta, eta=eta, beta=beta)
            return w_new, {"m": m_new}
        m = tree_map(lambda mi, di: beta * mi + di, extra["m"], delta)
        return tree_map(lambda wi, mi: wi - eta * mi, w, m), {"m": m}
    return ServerOpt("fedavgm", lambda w: {"m": _zeros_like_f32(w)}, apply)


def fedadam(eta: float = 0.1, b1: float = 0.9, b2: float = 0.99,
            tau: float = 1e-3) -> ServerOpt:
    """Adaptive server optimizer (Reddi et al. 2021) on the biased gradient."""
    def apply(w, extra, delta, t):
        m = tree_map(lambda mi, di: b1 * mi + (1 - b1) * di, extra["m"],
                     delta)
        v = tree_map(lambda vi, di: b2 * vi + (1 - b2) * torch.square(di),
                     extra["v"], delta)
        w = tree_map(lambda wi, mi, vi: wi - eta * mi / (torch.sqrt(vi) + tau),
                     w, m, v)
        return w, {"m": m, "v": v}
    return ServerOpt(
        "fedadam",
        lambda w: {"m": _zeros_like_f32(w), "v": _zeros_like_f32(w)},
        apply)


def fedyogi(eta: float = 0.1, b1: float = 0.9, b2: float = 0.99,
            tau: float = 1e-3) -> ServerOpt:
    def apply(w, extra, delta, t):
        m = tree_map(lambda mi, di: b1 * mi + (1 - b1) * di, extra["m"],
                     delta)
        v = tree_map(
            lambda vi, di: vi - (1 - b2) * torch.square(di)
            * torch.sign(vi - torch.square(di)),
            extra["v"], delta)
        w = tree_map(lambda wi, mi, vi: wi - eta * mi
                     / (torch.sqrt(torch.clamp(vi, min=0.0)) + tau), w, m, v)
        return w, {"m": m, "v": v}
    return ServerOpt(
        "fedyogi",
        lambda w: {"m": _zeros_like_f32(w), "v": _zeros_like_f32(w)},
        apply)


def fedlamom(eta: float = 1.0, beta: float = 0.9) -> ServerOpt:
    """Layerwise-damped Nesterov variant: FedMom with a per-tensor trust
    ratio min(1, ||w|| / ||update||), which caps any layer's step at its own
    parameter norm (never amplifies)."""
    def init_extra(w):
        return {"v": tree_map(torch.clone, w)}

    def apply(w, extra, delta, t):
        def upd_w(wi, vi, di):
            v_new = wi - eta * di
            raw = v_new + beta * (v_new - vi) - wi
            wn = torch.linalg.vector_norm(wi.reshape(-1))
            un = torch.linalg.vector_norm(raw.reshape(-1))
            trust = torch.clamp(wn / (un + 1e-12), max=1.0)
            trust = torch.where(wn > 0, trust, torch.ones_like(trust))
            return wi + trust * raw

        v_new = tree_map(lambda wi, di: wi - eta * di, w, delta)
        w_new = tree_map(upd_w, w, extra["v"], delta)
        return w_new, {"v": v_new}

    return ServerOpt("fedlamom", init_extra, apply)


# ---------------------------------------------------------------------------
# central differential privacy: clip + seeded Gaussian noise on delta_t
# ---------------------------------------------------------------------------
def dp(inner: ServerOpt, clip: float = 1.0,
       noise_multiplier: float = 0.0, seed: int = 0) -> ServerOpt:
    """Central-DP wrapper: before ``inner`` consumes the aggregate, clip
    delta_t to global L2 norm ``clip`` and add per-coordinate Gaussian
    noise N(0, (clip * noise_multiplier)^2).

    The noise is a pure function of ``(seed, t)`` — key
    ``fold_in(PRNGKey(seed), t)``, folded once more per tree leaf — drawn
    with the port's threefry, so it is the JAX package's noise up to the
    ``erfinv`` tolerance of ``repro_torch.random.normal`` (a few float32
    ulps of each standard normal).  The key is made and folded on the
    aggregate's device, and ``t`` may be a device tensor: inside a captured
    chunk of rounds every replay draws the noise of its own rounds.
    """
    if clip <= 0:
        raise ValueError(f"dp clip must be > 0, got {clip!r}")
    if noise_multiplier < 0:
        raise ValueError(
            f"dp noise_multiplier must be >= 0, got {noise_multiplier!r}")

    def apply(w, extra, delta, t):
        norm = torch.sqrt(sum(torch.sum(torch.square(_f32(d)))
                              for d in leaves(delta)))
        factor = torch.clamp(clip / torch.clamp(norm, min=1e-12), max=1.0)
        clipped = tree_map(lambda d: factor * _f32(d), delta)
        if noise_multiplier > 0:
            flat = leaves(clipped)
            t = t if isinstance(t, torch.Tensor) else int(t)
            key_t = prng.fold_in(prng.PRNGKey(seed, device=flat[0].device),
                                 t)
            sigma = clip * noise_multiplier
            noisy = [l + sigma * prng.normal(prng.fold_in(key_t, i), l.shape)
                     for i, l in enumerate(flat)]
            clipped = unflatten_like(clipped, noisy)
        return inner.apply(w, extra, clipped, t)

    return ServerOpt(f"dp_{inner.name}", inner.init_extra, apply)


def dp_fedavg(clip: float = 1.0, noise_multiplier: float = 0.0,
              dp_seed: int = 0, **inner_kw) -> ServerOpt:
    """DP-FedAvg: central clip + seeded Gaussian noise around ``fedavg``."""
    return dp(fedavg(**inner_kw), clip, noise_multiplier, dp_seed)


def dp_fedmom(clip: float = 1.0, noise_multiplier: float = 0.0,
              dp_seed: int = 0, **inner_kw) -> ServerOpt:
    """DP-FedMom: central clip + seeded Gaussian noise around ``fedmom``."""
    return dp(fedmom(**inner_kw), clip, noise_multiplier, dp_seed)


REGISTRY: Dict[str, Callable[..., ServerOpt]] = {
    "fedavg": fedavg,
    "fedmom": fedmom,
    "fedavgm": fedavgm,
    "fedadam": fedadam,
    "fedyogi": fedyogi,
    "fedlamom": fedlamom,
    "dp_fedavg": dp_fedavg,
    "dp_fedmom": dp_fedmom,
}


def get(name: str, **kw) -> ServerOpt:
    return REGISTRY[name](**kw)
