"""Non-IID, unbalanced client partitioners.

The paper's LEAF datasets are naturally partitioned (FEMNIST by writer,
Shakespeare by role).  Offline we reproduce the two *statistical properties*
that matter for the optimizer — label skew (non-IID) and size imbalance —
with standard partitioners from the FL literature.
"""
from __future__ import annotations

from typing import List

import numpy as np


def dirichlet_partition(labels: np.ndarray, n_clients: int,
                        alpha: float = 0.3, seed: int = 0,
                        min_per_client: int = 2) -> List[np.ndarray]:
    """Label-Dirichlet partition (Hsu et al. 2019): client k draws its label
    distribution p_k ~ Dir(alpha); smaller alpha = more skew."""
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    idx_by_class = [np.flatnonzero(labels == c) for c in range(n_classes)]
    for idx in idx_by_class:
        rng.shuffle(idx)
    client_idx = [[] for _ in range(n_clients)]
    for c, idx in enumerate(idx_by_class):
        props = rng.dirichlet(np.full(n_clients, alpha))
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for k, part in enumerate(np.split(idx, cuts)):
            client_idx[k].extend(part.tolist())
    out = []
    for k in range(n_clients):
        idx = np.asarray(client_idx[k], dtype=np.int64)
        if len(idx) < min_per_client:   # give starved clients random samples
            extra = rng.choice(len(labels), min_per_client - len(idx),
                               replace=False)
            idx = np.concatenate([idx, extra])
        rng.shuffle(idx)
        out.append(idx)
    return out


def label_shard_partition(labels: np.ndarray, n_clients: int,
                          shards_per_client: int = 2,
                          seed: int = 0) -> List[np.ndarray]:
    """McMahan et al. (2016) pathological non-IID: sort by label, split into
    ``n_clients * shards_per_client`` shards, deal each client
    ``shards_per_client`` shards (most clients see only a few classes)."""
    rng = np.random.default_rng(seed)
    order = np.argsort(labels, kind="stable")
    shards = np.array_split(order, n_clients * shards_per_client)
    shard_ids = rng.permutation(len(shards))
    out = []
    for k in range(n_clients):
        take = shard_ids[k * shards_per_client:(k + 1) * shards_per_client]
        idx = np.concatenate([shards[s] for s in take])
        rng.shuffle(idx)
        out.append(idx)
    return out


def lognormal_sizes(n_clients: int, mean: float, std: float,
                    seed: int = 0) -> np.ndarray:
    """Client sample counts matching a target mean/std (Table 2 of the
    paper: FEMNIST 224.5±87.8, Shakespeare 4136.9±7226.2)."""
    rng = np.random.default_rng(seed)
    sigma2 = np.log(1.0 + (std / mean) ** 2)
    mu = np.log(mean) - sigma2 / 2.0
    sizes = rng.lognormal(mu, np.sqrt(sigma2), size=n_clients)
    return np.maximum(sizes.round().astype(int), 2)
