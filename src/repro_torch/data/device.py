"""The device-resident data plane: the whole corpus packed on the card.

For the corpora the paper benchmarks (LEAF-scale FEMNIST / Shakespeare) the
whole federated dataset fits in device memory, so round data never crosses
the host boundary: ``DeviceFederatedDataset`` packs the corpus once into
padded ``[K, n_max, ...]`` tensors (one per field, dtypes kept) and
``gather_round_batch`` gathers a round's ``[C, H, b, ...]`` batch stack on
the device, drawing its indices with the ``(seed, t, client_id)``-keyed
``minibatch_indices`` that the host ``FederatedDataset.round_batches``
uses, so the two gathers are bit-equal and every plane trains one
trajectory.

Memory ceiling: packing costs ``K * n_max * itemsize`` per field (the
largest client times the client count, not the corpus size).  ``nbytes``
reports it; ``plan="auto"`` compares it with the memory budget.  For
corpora past that, use the streaming or the scanned plane.

The JAX package places the client axis over a device mesh when one is
active (``shard_clients``); the port runs on one device, so
``shard_clients`` is taken and has nothing to split, and a mesh is refused
where plans are resolved (``TrainSession.device_dataset``).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch.core.sampling import ClientPopulation
from repro_torch.data.federated import (FederatedDataset, minibatch_indices,
                                        validate_client_data)
from repro_torch.device import resolve_device


class DeviceFederatedDataset:
    """The whole federated corpus as padded device tensors.

    ``arrays``: dict of ``[K, n_max, ...]`` tensors (client k's samples in
    rows [0, n_k), zero padding above); ``counts``: ``[K]`` int32 n_k on the
    same device; ``seed`` keys the minibatch draws as ``FederatedDataset``
    does.
    """

    def __init__(self, arrays: Dict[str, torch.Tensor], counts: torch.Tensor,
                 seed: int = 0):
        self.arrays = arrays
        self.counts = counts
        self.seed = seed

    # -- construction ---------------------------------------------------
    @classmethod
    def pack(cls, data: List[Dict[str, np.ndarray]], seed: int = 0,
             shard_clients: bool = True,
             device=None) -> "DeviceFederatedDataset":
        """Pack per-client dicts into padded tensors on ``device`` (``None``
        = ``cuda``).  Each field keeps its own dtype (int32 token streams
        next to float32 images).  ``shard_clients`` is the reference's
        mesh-placement switch: on one device there is nothing to split."""
        dev = resolve_device(device)
        counts = validate_client_data(data)
        n_max = int(counts.max())
        arrays = {}
        for name in data[0]:
            leaf0 = np.asarray(data[0][name])
            packed = np.zeros((len(data), n_max) + leaf0.shape[1:],
                              leaf0.dtype)
            for k, d in enumerate(data):
                packed[k, : counts[k]] = d[name]
            arrays[name] = torch.from_numpy(packed).to(dev)
        return cls(arrays, torch.from_numpy(counts).to(dev), seed)

    @classmethod
    def from_federated(cls, ds: FederatedDataset, shard_clients: bool = True,
                       device=None) -> "DeviceFederatedDataset":
        return cls.pack(ds.data, seed=ds.seed, shard_clients=shard_clients,
                        device=device)

    # -- inspection -----------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.counts.device

    @property
    def n_clients(self) -> int:
        return int(self.counts.shape[0])

    @property
    def n_max(self) -> int:
        return int(next(iter(self.arrays.values())).shape[1])

    @property
    def nbytes(self) -> int:
        """Packed device footprint (the K * n_max memory ceiling)."""
        return sum(a.numel() * a.element_size() for a in self.arrays.values())

    def population(self) -> ClientPopulation:
        return ClientPopulation(counts=self.counts.cpu().numpy())

    def base_key(self) -> torch.Tensor:
        return prng.PRNGKey(self.seed, device=self.device)

    # -- the on-device gather -------------------------------------------
    def gather_round_batch(self, key: torch.Tensor, t, client_ids,
                           local_steps: int, batch_size: int):
        """Round ``t``'s ``[C, H, b, ...]`` batch stack, on the device.

        ``client_ids``: [C] round participants; ``t``: an int or an int64
        device tensor (the form a captured chunk feeds it).  One batched
        ``minibatch_indices`` draw for every client (lane c is the draw of
        client c alone), then one advanced index a field.  Bit-equal to
        ``FederatedDataset.round_batches(client_ids, H, b, t)`` on the same
        ``seed``; padding rows are never selected because every index is
        drawn from [0, n_k).
        """
        need = local_steps * batch_size
        cids = torch.as_tensor(client_ids, device=self.device).long()
        idx = minibatch_indices(key, t, cids, self.counts[cids], need).long()
        return {name: a[cids[:, None], idx].reshape(
                    (cids.shape[0], local_steps, batch_size) + a.shape[2:])
                for name, a in self.arrays.items()}
