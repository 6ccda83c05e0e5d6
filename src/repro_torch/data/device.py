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

Under a live data mesh (``ExecutionPlan(mesh=...)``), ``shard_clients``
places the client axis over the ranks as the reference's does: rank r
holds the r-th contiguous block of ceil(K/n) clients of the packed corpus
(``sharding.put_logical``; the counts stay whole on every rank), and
``gather_round_block`` assembles the rank's block of a round's cohort from
the rows their owners hold through one all-to-all exchange of raw bytes,
bit-equal to the unsharded gather's block.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch.core.sampling import ClientPopulation
from repro_torch.data.federated import (FederatedDataset, minibatch_indices,
                                        validate_client_data)
from repro_torch.device import resolve_device
from repro_torch.sharding import current_mesh, put_logical


class DeviceFederatedDataset:
    """The whole federated corpus as padded device tensors.

    ``arrays``: dict of ``[K, n_max, ...]`` tensors (client k's samples in
    rows [0, n_k), zero padding above); ``counts``: ``[K]`` int32 n_k on the
    same device; ``seed`` keys the minibatch draws as ``FederatedDataset``
    does.  ``mesh``: the ``launch.mesh.Mesh`` the arrays are sharded over
    (they then hold this rank's ``mesh.block(K)`` rows), or ``None``.
    """

    def __init__(self, arrays: Dict[str, torch.Tensor], counts: torch.Tensor,
                 seed: int = 0, mesh=None):
        self.arrays = arrays
        self.counts = counts
        self.seed = seed
        self.mesh = mesh

    # -- construction ---------------------------------------------------
    @classmethod
    def pack(cls, data: List[Dict[str, np.ndarray]], seed: int = 0,
             shard_clients: bool = True,
             device=None) -> "DeviceFederatedDataset":
        """Pack per-client dicts into padded tensors on ``device`` (``None``
        = ``cuda``).  Each field keeps its own dtype (int32 token streams
        next to float32 images).  With ``shard_clients`` and a live mesh
        (``sharding.axis_rules``) the client axis is placed by the
        'clients' rule: this rank keeps its contiguous block of ceil(K/n)
        clients, paying that share of the packed ceiling (the per-device
        pricing the plan's auto rule uses); otherwise every rank holds the
        whole corpus."""
        dev = resolve_device(device)
        counts = validate_client_data(data)
        n_max = int(counts.max())
        mesh = current_mesh() if shard_clients else None
        arrays = {}
        for name in data[0]:
            leaf0 = np.asarray(data[0][name])
            packed = np.zeros((len(data), n_max) + leaf0.shape[1:],
                              leaf0.dtype)
            for k, d in enumerate(data):
                packed[k, : counts[k]] = d[name]
            if mesh is None:
                arrays[name] = torch.from_numpy(packed).to(dev)
            else:
                arrays[name] = put_logical(
                    packed, *(("clients",) + (None,) * (packed.ndim - 1)),
                    device=dev)
        if mesh is not None and next(iter(arrays.values())).shape[0] \
                == len(data):
            mesh = None          # the rules left the client axis whole
        return cls(arrays, torch.from_numpy(counts).to(dev), seed, mesh)

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
        """Packed device footprint (the K * n_max memory ceiling; this
        rank's block of it when the corpus is sharded)."""
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
        if self.mesh is not None:
            raise ValueError(
                "this corpus is sharded over a mesh: each rank holds its "
                "block of the clients, so gather with gather_round_block")
        need = local_steps * batch_size
        cids = torch.as_tensor(client_ids, device=self.device).long()
        idx = minibatch_indices(key, t, cids, self.counts[cids], need).long()
        return {name: a[cids[:, None], idx].reshape(
                    (cids.shape[0], local_steps, batch_size) + a.shape[2:])
                for name, a in self.arrays.items()}

    def gather_round_block(self, key: torch.Tensor, t, client_ids,
                           local_steps: int, batch_size: int, mesh):
        """This rank's ``mesh.block(C)`` rows of ``gather_round_batch``:
        the batch stack of its block of the cohort, bit-equal to the
        unsharded gather's rows.  An unsharded corpus gathers them
        directly.  A sharded one gathers, for every rank's block, the rows
        of the clients this rank holds (zero bytes elsewhere), sends them
        with one ``all_to_all`` of every field's bytes, and keeps, row by
        row, the bytes the client's owner sent: a selection, never a sum,
        so the rows are exact (signed zeros and NaNs included)."""
        cids = torch.as_tensor(client_ids, device=self.device).long()
        C = cids.shape[0]
        lo, hi = mesh.block(C)
        if self.mesh is None:
            return self.gather_round_batch(key, t, cids[lo:hi], local_steps,
                                           batch_size)
        n, b = mesh.size, -(-C // mesh.size)
        need = local_steps * batch_size
        pad = n * b - C
        cids_p = torch.cat([cids, cids.new_zeros(pad)]) if pad else cids
        idx = minibatch_indices(key, t, cids_p, self.counts[cids_p],
                                need).long()
        k_lo, k_hi = mesh.block(self.n_clients)
        owner = torch.div(cids_p, -(-self.n_clients // n),
                          rounding_mode="floor")
        mine = (owner == mesh.rank).reshape(-1, 1)
        local = (cids_p - k_lo).clamp(0, max(k_hi - k_lo - 1, 0))
        send, widths = [], []
        for a in self.arrays.values():
            if k_hi > k_lo:
                rows = a[local[:, None], idx].reshape(n * b, -1)
            else:
                rows = a.new_zeros((n * b, need * math.prod(a.shape[2:])))
            rows = rows.contiguous().view(torch.uint8)
            send.append(torch.where(mine, rows, torch.zeros_like(rows)))
            widths.append(rows.shape[1])
        recv = mesh.all_to_all(torch.cat(send, dim=1))
        own = owner[mesh.rank * b:(mesh.rank + 1) * b]
        got = recv.reshape(n, b, -1)[own, torch.arange(b, device=own.device)]
        got = got[:hi - lo]
        out, start = {}, 0
        for (name, a), w in zip(self.arrays.items(), widths):
            field = got[:, start:start + w].contiguous().view(a.dtype)
            out[name] = field.reshape((hi - lo, local_steps, batch_size)
                                      + tuple(a.shape[2:]))
            start += w
        return out
