"""Federated dataset container + round-batch assembly.

``FederatedDataset`` owns per-client arrays and builds the [C, H, b, ...]
round batches the engine consumes (Algorithm 2 samples a fresh minibatch per
local step).

Minibatch draws are keyed by ``(seed, t, client_id)`` through the port's
threefry (``minibatch_indices``), never by a shared sequential RNG: round
t's batches are the same whether rounds are assembled in order, out of
order, or re-assembled after a checkpoint restore — and they are bit-equal
to the JAX package's draws for the same seed.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch.core.sampling import ClientPopulation


class CorpusSchemaError(ValueError):
    """A corpus whose per-client shards cannot feed the data planes.

    Raised for an empty corpus, a client whose field set differs from the
    declared schema, ragged field lengths inside one client, an empty client
    (n_k = 0 — the keyed minibatch draw is undefined on an empty span) and a
    client whose field tail shape or dtype disagrees with the schema.
    ``client`` carries the offending client id (``None`` for the
    empty-corpus case).
    """

    def __init__(self, message: str, client=None):
        super().__init__(message)
        self.client = client


def minibatch_indices(key: torch.Tensor, t, client_id, n_k,
                      need: int) -> torch.Tensor:
    """Alg. 2's with-replacement minibatch draw for one client and round.

    ``need = H * b`` uniform indices into [0, n_k), keyed by (key, t,
    client_id) only.  ``t`` / ``client_id`` / ``n_k`` may be ints or
    equal-length integer arrays (a vector ``t`` is the batched host replay
    of a whole chunk's ``(t, cid, n_k)`` lanes): the result is then
    ``[C, need]``, row c bit-equal to a call for lane c alone (threefry is
    counter-based, so the batched draw is the per-lane draw, as under the
    reference's ``vmap``).
    """
    kt = prng.fold_in(prng.fold_in(key, t), client_id)
    if isinstance(n_k, int):
        return prng.randint(kt, (need,), 0, n_k)
    n_k = torch.as_tensor(n_k, dtype=torch.int64, device=key.device)
    return prng.randint(kt, (need,), 0, n_k[..., None])


def shard_schema(shard: Dict[str, np.ndarray]) -> Dict[str, tuple]:
    """Declared-schema form of one client shard:
    ``{field: (tail_shape, dtype)}`` (sample axis stripped)."""
    return {name: (np.asarray(a).shape[1:], np.asarray(a).dtype)
            for name, a in shard.items()}


def check_shard(shard: Dict[str, np.ndarray], fields: Dict[str, tuple],
                client, n_k: Optional[int] = None,
                source: str = "client") -> int:
    """Validate one client shard against a declared schema; returns its
    sample count.  ``n_k``: when given, the declared count the shard must
    match."""
    got = sorted(shard)
    want = sorted(fields)
    if got != want:
        raise CorpusSchemaError(
            f"{source} {client}: fields {got} != declared schema {want}",
            client=client)
    lens = {name: len(np.asarray(a)) for name, a in shard.items()}
    if len(set(lens.values())) != 1:
        raise CorpusSchemaError(
            f"{source} {client}: ragged field lengths {lens}",
            client=client)
    count = next(iter(lens.values()))
    if count == 0:
        raise CorpusSchemaError(
            f"{source} {client} has no samples (n_k = 0): the keyed "
            f"minibatch draw is undefined on an empty span", client=client)
    if n_k is not None and count != int(n_k):
        raise CorpusSchemaError(
            f"{source} {client}: shard has {count} samples but the "
            f"declared counts say n_k = {int(n_k)}", client=client)
    for name, a in shard.items():
        a = np.asarray(a)
        tail, dtype = fields[name]
        if a.shape[1:] != tuple(tail) or a.dtype != np.dtype(dtype):
            raise CorpusSchemaError(
                f"{source} {client}: field {name!r} is "
                f"{a.shape[1:]}/{a.dtype} but the declared schema says "
                f"{tuple(tail)}/{np.dtype(dtype)}", client=client)
    return count


def validate_client_data(data: List[Dict[str, np.ndarray]]) -> np.ndarray:
    """Shared per-client validation; returns [K] n_k.

    Every client must carry the same fields with the same tail shapes and
    dtypes (client 0 declares the schema), each field the same length
    within a client, and n_k >= 1.  Raises the named ``CorpusSchemaError``
    (a ``ValueError``).
    """
    if not data:
        raise CorpusSchemaError(
            "empty corpus: need at least one client")
    fields = shard_schema(data[0])
    return np.array([check_shard(d, fields, k) for k, d in enumerate(data)],
                    np.int32)


class FederatedDataset:
    """data: list over clients of dicts of arrays (first axis = samples),
    e.g. {'x': [n_k,28,28,1], 'y': [n_k]} or {'tokens': [n_k, S]}.

    The corpus stays in host memory as numpy; ``round_batches`` returns
    numpy stacks that the trainer moves to its device.
    """

    def __init__(self, data: List[Dict[str, np.ndarray]], seed: int = 0):
        validate_client_data(data)
        self.data = data
        self.seed = seed

    @property
    def n_clients(self) -> int:
        return len(self.data)

    def counts(self) -> np.ndarray:
        return np.array([len(next(iter(d.values()))) for d in self.data])

    def population(self) -> ClientPopulation:
        return ClientPopulation(counts=self.counts())

    def base_key(self):
        return prng.PRNGKey(self.seed)

    def round_batches(self, client_ids: Sequence[int], local_steps: int,
                      batch_size: int, t: int) -> Dict[str, np.ndarray]:
        """Stack [C, H, b, ...] batches for round ``t`` (with-replacement
        draws per Alg. 2, keyed by ``(seed, t, client_id)`` — see
        ``minibatch_indices``).  ``t`` is required: a caller looping rounds
        without threading it would silently train on round-0 draws forever.
        """
        need = local_steps * batch_size
        ids = np.asarray(client_ids)
        n_ks = np.array([len(next(iter(self.data[k].values())))
                         for k in ids])
        idxs = minibatch_indices(self.base_key(), int(t),
                                 torch.as_tensor(ids, dtype=torch.int64),
                                 n_ks, need).numpy()
        out: Dict[str, List[np.ndarray]] = {}
        for k, idx in zip(ids, idxs):
            for name, arr in self.data[k].items():
                sel = arr[idx].reshape(
                    (local_steps, batch_size) + arr.shape[1:])
                out.setdefault(name, []).append(sel)
        return {k: np.stack(v) for k, v in out.items()}


def lm_clients_to_dataset(streams: List[np.ndarray], seq_len: int,
                          seed: int = 0) -> FederatedDataset:
    """Chop per-client token streams into (tokens, labels) LM examples."""
    data = []
    for s in streams:
        n = (len(s) - 1) // seq_len
        n = max(n, 1)
        if len(s) < n * seq_len + 1:
            reps = int(np.ceil((n * seq_len + 1) / len(s)))
            s = np.tile(s, reps)
        x = s[: n * seq_len].reshape(n, seq_len)
        y = s[1: n * seq_len + 1].reshape(n, seq_len)
        data.append({"tokens": x.astype(np.int32),
                     "labels": y.astype(np.int32)})
    return FederatedDataset(data, seed=seed)
