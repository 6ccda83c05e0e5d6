"""Synthetic datasets with the statistical shape of the paper's benchmarks.

No network access is available offline, so LEAF's FEMNIST / Shakespeare are
replaced by generators that reproduce (a) the task form (28x28 62-class
images; character-level next-char prediction), (b) the non-IID client
structure (writer style / role vocabulary), and (c) Table 2's unbalanced
size statistics.  DESIGN.md §7 records this adaptation.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from repro_torch.data.partition import lognormal_sizes

FEMNIST_CLASSES = 62
FEMNIST_SHAPE = (28, 28, 1)
SHAKESPEARE_VOCAB = 90          # printable chars used by LEAF
SHAKESPEARE_SEQ = 80            # LEAF's sequence length


def synthetic_femnist(n_clients: int = 200, seed: int = 0,
                      mean: float = 224.5, std: float = 87.8,
                      image_noise: float = 0.35,
                      writer_style: float = 0.6):
    """Per-client 28x28 images: class prototypes (fixed random blobs) +
    per-writer style offset + pixel noise.  Returns (client data list,
    counts).  Non-IID via per-client Dirichlet label prior; unbalanced via
    lognormal sizes."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(0.0, 1.0, size=(FEMNIST_CLASSES, 28, 28, 1))
    # smooth the prototypes a little so conv nets have structure to find
    k = np.ones((3, 3)) / 9.0
    for c in range(FEMNIST_CLASSES):
        img = protos[c, :, :, 0]
        img = np.pad(img, 1, mode="edge")
        sm = sum(img[i:i + 28, j:j + 28] * k[i, j]
                 for i in range(3) for j in range(3))
        protos[c, :, :, 0] = sm
    counts = lognormal_sizes(n_clients, mean, std, seed=seed + 1)
    clients = []
    for kcl in range(n_clients):
        n_k = counts[kcl]
        prior = rng.dirichlet(np.full(FEMNIST_CLASSES, 0.3))
        labels = rng.choice(FEMNIST_CLASSES, size=n_k, p=prior)
        style = rng.normal(0.0, writer_style, size=(28, 28, 1))
        imgs = (protos[labels] + style[None]
                + rng.normal(0.0, image_noise, size=(n_k, 28, 28, 1)))
        clients.append({"x": imgs.astype(np.float32),
                        "y": labels.astype(np.int32)})
    return clients, counts


def synthetic_shakespeare(n_clients: int = 40, seed: int = 0,
                          mean: float = 4136.85, std: float = 7226.20,
                          order: int = 1):
    """Per-client character streams from per-role Markov chains sharing a
    global backbone: client transition matrix = 0.5 * global + 0.5 * own.
    Returns (clients [{'text': int32 [n_k]}, ...], counts)."""
    rng = np.random.default_rng(seed)
    V = SHAKESPEARE_VOCAB
    global_T = rng.dirichlet(np.full(V, 0.15), size=V)
    counts = lognormal_sizes(n_clients, mean, std, seed=seed + 1)
    clients = []
    for kcl in range(n_clients):
        own = rng.dirichlet(np.full(V, 0.15), size=V)
        T = 0.5 * global_T + 0.5 * own
        n_k = int(counts[kcl])
        seq = np.empty(n_k, dtype=np.int32)
        s = rng.integers(V)
        for t in range(n_k):
            s = rng.choice(V, p=T[s])
            seq[t] = s
        clients.append({"text": seq})
    return clients, counts


def synthetic_token_clients(n_clients: int, vocab: int, tokens_per_client: int,
                            seed: int = 0, skew: float = 1.2):
    """LM token streams for transformer federated training: each client
    samples from a client-specific Zipf-reweighted unigram over a shared
    vocabulary (cheap but non-IID).  Returns list of int32 arrays."""
    rng = np.random.default_rng(seed)
    base = 1.0 / np.arange(1, vocab + 1) ** skew
    clients = []
    for kcl in range(n_clients):
        perm = rng.permutation(vocab)
        p = base[perm] / base.sum()
        clients.append(
            rng.choice(vocab, size=tokens_per_client, p=p).astype(np.int32))
    return clients
