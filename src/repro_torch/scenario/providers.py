"""Lazy corpus providers: millions of clients from [K] ints of host RAM.

The port of the JAX package's ``scenario/providers.py`` (host numpy: the
same seed gives the same counts and the same shards, bit for bit).

``ZipfLinregProvider`` is the reference ``ShardProvider`` (see
``data/stream.py``): a synthetic linear-regression fleet with Zipf-skewed
per-client sample counts — the canonical federated size distribution
(McMahan et al. 2016) and the shape the n_k-tiered ``ShardCache`` is built
for.  Construction touches only the [K] count vector (drawn vectorized
from the keyed scenario hash, so a 10M-client corpus declares itself in
~80 MB); a client's actual rows are synthesized on first cache miss, as a
pure function of ``(seed, client_id)``, so an evicted-and-refetched — or
resumed — shard is bit-identical.  Fields match the repo's linreg
convention (``x: [n_k, dim] float32``, ``y: [n_k] float32``), so the
provider drops into the same ``loss_fn`` the tests and benchmarks use.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.scenario.lifecycle import keyed_uniforms


def zipf_counts(n_clients: int, alpha: float = 1.5, n_min: int = 1,
                n_max: int = 64, seed: int = 0) -> np.ndarray:
    """[K] bounded-Zipf sample counts via inverse-CDF over keyed uniforms
    (P(n) ∝ n^-alpha on [n_min, n_max]); vectorized, no sequential RNG."""
    if not 1 <= n_min <= n_max:
        raise ValueError(f"need 1 <= n_min <= n_max, got "
                         f"({n_min}, {n_max})")
    support = np.arange(n_min, n_max + 1, dtype=np.float64)
    cdf = np.cumsum(support ** -float(alpha))
    cdf /= cdf[-1]
    u = keyed_uniforms(seed, "zipf/n_k", 0, np.arange(n_clients))
    return (n_min + np.searchsorted(cdf, u, side="right")).astype(np.int64)


class ZipfLinregProvider:
    """Synthesize-on-miss linreg clients (non-IID: each client's true
    weight is the global one plus a keyed per-client offset)."""

    def __init__(self, n_clients: int, dim: int = 5, alpha: float = 1.5,
                 n_min: int = 1, n_max: int = 64, seed: int = 0,
                 noise: float = 0.1, hetero: float = 0.25):
        if n_clients < 1:
            raise ValueError(f"n_clients must be >= 1, got {n_clients!r}")
        self._n_clients = int(n_clients)
        self.dim = int(dim)
        self.seed = int(seed)
        self.noise = float(noise)
        self.hetero = float(hetero)
        self._counts = zipf_counts(self._n_clients, alpha=alpha,
                                   n_min=n_min, n_max=n_max, seed=seed)
        # the global regression target, a pure function of the seed
        self._w = np.asarray(
            np.random.default_rng((self.seed, 0x5EED)).normal(size=self.dim),
            np.float64)

    @property
    def n_clients(self) -> int:
        return self._n_clients

    @property
    def counts(self) -> np.ndarray:
        return self._counts

    @property
    def fields(self) -> Dict[str, tuple]:
        return {"x": ((self.dim,), np.dtype(np.float32)),
                "y": ((), np.dtype(np.float32))}

    def shard(self, client_id: int) -> Dict[str, np.ndarray]:
        # pure function of (seed, client_id): SeedSequence on the tuple is
        # deterministic across processes, so eviction/resume refetches are
        # bit-identical
        rng = np.random.default_rng((self.seed, 0xC11E27, int(client_id)))
        n = int(self._counts[client_id])
        x = rng.normal(size=(n, self.dim))
        w_k = self._w + self.hetero * rng.normal(size=self.dim)
        y = x @ w_k + self.noise * rng.normal(size=n)
        return {"x": x.astype(np.float32), "y": y.astype(np.float32)}


def zipf_linreg_provider(n_clients: int, **kw) -> ZipfLinregProvider:
    """Convenience constructor (see ``ZipfLinregProvider``)."""
    return ZipfLinregProvider(n_clients, **kw)
