"""Federated rounds of FedMom (the paper's Algorithms 1-3), written plainly.

Round t:

1. the cohort: M of the K clients, ``threefry.cohort`` under the sampling
   seed, each weighted n_k / n;
2. every client starts from the server model held in its storage dtype and
   runs H steps of SGD, ``p <- store(p - gamma * grad)``, on its own keyed
   minibatch rows (``threefry.minibatch_rows`` under the data seed); its
   loss is the mean of the H step losses;
3. the biased gradient ``delta = sum_k (n_k / n) (w_client0 - w_k)``, in
   fp32, and the round's loss ``sum_k (n_k / n) loss_k / sum_k (n_k / n)``;
4. FedMom: ``v' = w - eta * delta``, ``w' = v' + beta * (v' - v)``, with
   ``v`` starting at ``w_0``.

Clients run one after another.  ``run`` returns the cohorts, the round
losses, each leaf's norm of the first round's delta and each leaf's norm of
``w_n - w_0`` after the last round, and of both the norm of each row (a
leaf's slices along its last axis, a vector's elements).
"""
from __future__ import annotations

import numpy as np
import torch

from . import threefry
from .precision import exact_fp32

STORE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def row_norms(x: torch.Tensor) -> torch.Tensor:
    """The norm of each row of ``x`` (its slices along the last axis; a
    vector's elements), in fp32 on the host."""
    x = x.float()
    if x.dim() <= 1:
        return x.abs().reshape(-1).cpu()
    return torch.linalg.vector_norm(x.reshape(-1, x.shape[-1]), dim=-1).cpu()


def _client(loss, w, batches, lr: float, store, prec: str):
    p = {k: v.to(store).float() for k, v in w.items()}
    losses = []
    for batch in batches:
        q = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        value = loss(q, batch, prec)
        grads = torch.autograd.grad(value, list(q.values()))
        losses.append(float(value.detach()))
        p = {k: (v.detach() - lr * g).to(store).float()
             for (k, v), g in zip(q.items(), grads)}
        del q, grads, value
    return p, sum(losses) / len(losses)


def run(loss, batches_of, clients: list, counts, w0: dict, *, rounds: int,
        m: int, local_steps: int, b: int, lr: float, eta: float,
        beta: float, sample_seed: int, data_seed: int, store: str,
        prec: str = "fp32") -> dict:
    """``loss(params, batch, prec)``; ``batches_of(client, rows, H, b)``;
    ``clients`` the raw per-client data; ``counts`` their sizes; ``w0`` the
    server's fp32 start (a flat dict of leaves, left unchanged)."""
    counts = np.asarray(counts, dtype=np.int64)
    frac = (counts / counts.sum()).astype(np.float32)
    store = STORE[store]
    w = {k: v.float().clone() for k, v in w0.items()}
    v = {k: x.clone() for k, x in w.items()}
    out = {"cohorts": [], "losses": []}
    with exact_fp32():
        for t in range(rounds):
            ids = threefry.cohort(sample_seed, t, len(counts), m)
            wc = {k: x.to(store).float() for k, x in w.items()}
            delta = {k: torch.zeros_like(x) for k, x in w.items()}
            num = den = 0.0
            for cid in ids:
                rows = threefry.minibatch_rows(data_seed, t, int(cid),
                                               int(counts[cid]),
                                               local_steps * b)
                pk, lk = _client(loss, w, batches_of(clients[cid], rows,
                                                     local_steps, b),
                                 lr, store, prec)
                wt = float(frac[cid])
                for k in delta:
                    delta[k] += wt * (wc[k] - pk[k])
                num += wt * lk
                den += wt
                del pk
            v_new = {k: w[k] - eta * delta[k] for k in w}
            w = {k: v_new[k] + beta * (v_new[k] - v[k]) for k in w}
            v = v_new
            if t == 0:
                out["delta0"] = {k: float(torch.linalg.vector_norm(d))
                                 for k, d in delta.items()}
                out["delta0_rows"] = {k: row_norms(d)
                                      for k, d in delta.items()}
            out["cohorts"].append([int(c) for c in ids])
            out["losses"].append(num / den)
            del delta, wc
    change = {k: w[k] - w0[k].float() for k in w}
    out["change"] = {k: float(torch.linalg.vector_norm(d))
                     for k, d in change.items()}
    out["change_rows"] = {k: row_norms(d) for k, d in change.items()}
    return out
