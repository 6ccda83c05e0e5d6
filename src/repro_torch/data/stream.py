"""Streaming shard-cached federated data plane (tiered slots).

The port of the JAX package's ``data/stream.py``: the corpus stays on the
HOST as per-client shards, and a bounded device-side cache holds only the
shards of upcoming participants.  Federated corpora are heavily unbalanced,
so the cache buckets clients into power-of-two size tiers
(``n_tier = min(next_pow2(n_k), n_max)``) with one ``[slots_t, n_tier, ...]``
tensor per field and tier and a per-tier LRU: a 3-sample client costs a
4-row slot, not an ``n_max``-row one.  ``tiers=1`` is the uniform layout
(every slot ``n_max`` rows); ``tiers=m`` merges the smallest buckets upward.

* ``StreamingFederatedDataset`` — host shards (a materialized ``data`` list
  or a lazy ``ShardProvider``) plus the packing metadata (``tier_layout``).
  All numpy: the same corpus gives the reference's sizes, tier assignment
  and byte accounting.
* ``ShardCache`` — per-tier device tensors with per-tier LRU eviction;
  ``ensure(client_ids)`` uploads the missing shards, ``view()`` snapshots
  the client -> (tier, slot) tables as a ``CacheView``.
* ``MeshShardedCache`` — the data mesh's cache: one full-capacity
  ``ShardCache`` per shard, clients routed ``cid % n_shards``, one composed
  view (every rank of a mesh holds the same one).
* ``DiskShardProvider`` — a ``ShardProvider`` over an on-disk corpus
  (``write_disk_corpus`` in the ``npy-packed`` or ``npz-per-client``
  layout, ``leaf_to_corpus`` from a LEAF json directory), read through
  ``np.load(mmap_mode="r")``: the reference's format, so a corpus written
  by either package opens in the other;
* ``CacheView`` — the gather contract the chunk loops consume
  (``gather_round_batch``, ``gather_tier_batch``, ``gather_tier_rows``),
  keyed by the true client id and n_k, so its rows are bit-equal to every
  other plane's.

Cache writes are IN PLACE (``index_copy_``), where the reference writes
functionally (``.at[idx].set``) so that a captured view never changes.  On
a card the fresh rows are assembled straight into pinned host tensors,
copied without blocking on a copy stream the cache owns, and scattered into
the tier tensors on the current (compute) stream once that stream has
waited for the copy: the PCIe transfer runs under the chunk in flight, and
the scatter is queued behind that chunk's kernels, so a slot that the
chunk still reads is overwritten only after it has read it.  ``prefetch``
therefore overlaps the next chunk's uploads with the current chunk, with
no second buffer and the same LRU decisions.  The slot ids and a view's
``client_slots`` table take the same path.  On the CPU there is no stream
and no pinning: the same bookkeeping writes synchronously.  What a view
captures beside the tier tensors (``client_slots``) is copied per view, so
a later eviction never rewires an earlier view's clients.
"""
from __future__ import annotations

import glob as _glob
import json
import os
from bisect import bisect_left
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Protocol, Tuple, runtime_checkable

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch.core.sampling import ClientPopulation
from repro_torch.data.federated import (CorpusSchemaError, FederatedDataset,
                                        check_shard, minibatch_indices,
                                        shard_schema, validate_client_data)
from repro_torch.device import resolve_device, to_device


@runtime_checkable
class ShardProvider(Protocol):
    """Capability: a corpus whose client shards are synthesized or loaded
    on demand, never all materialized in host RAM.

    The provider declares the corpus shape up front (``counts``: [K] n_k,
    ``fields``: {name: (tail_shape, dtype)}) and produces one client's
    shard only when the ``ShardCache`` first misses on it.
    ``shard(client_id)`` must be a pure function of ``client_id``, so a
    re-fetch after an eviction or a resume returns the same rows.
    """

    @property
    def n_clients(self) -> int: ...

    @property
    def counts(self) -> np.ndarray: ...        # [K] n_k, int

    @property
    def fields(self) -> Dict[str, tuple]: ...  # {name: (tail_shape, dtype)}

    def shard(self, client_id: int) -> Dict[str, np.ndarray]: ...


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    return 1 << (int(n) - 1).bit_length()


@dataclass(frozen=True)
class TierLayout:
    """How a corpus buckets into slot-size tiers (host metadata only).

    ``sizes``: ascending tier row capacities; the last always covers n_max.
    ``tier_of``: [K] tier index per client.  ``tier_counts``: clients per
    tier.  ``row_nbytes``: device bytes of one sample row summed over
    fields — a tier-``t`` slot costs ``sizes[t] * row_nbytes``.
    """
    sizes: Tuple[int, ...]
    tier_of: np.ndarray
    tier_counts: Tuple[int, ...]
    row_nbytes: int

    @property
    def n_tiers(self) -> int:
        return len(self.sizes)

    def slot_nbytes(self, tier: int) -> int:
        return self.sizes[tier] * self.row_nbytes

    def bytes_for_capacity(self, capacity: int) -> int:
        """Tiered device footprint of a cache guaranteeing ``capacity``
        distinct clients per request: each tier holds
        ``min(K_t, capacity)`` slots of its own row size."""
        return sum(min(k_t, capacity) * self.slot_nbytes(t)
                   for t, k_t in enumerate(self.tier_counts))

    @property
    def min_viable_bytes(self) -> int:
        """One slot in every occupied tier — the smallest honest cache."""
        return self.bytes_for_capacity(1)

    def capacity_for_bytes(self, budget: int) -> Optional[int]:
        """Largest per-request client guarantee whose tiered footprint fits
        ``budget`` (bytes), or None when even one slot per occupied tier
        does not fit (``bytes_for_capacity`` is monotone in capacity)."""
        if self.bytes_for_capacity(1) > budget:
            return None
        cap = 1
        for c in range(2, max(self.tier_counts) + 1):
            if self.bytes_for_capacity(c) > budget:
                break
            cap = c
        return cap


class StreamingFederatedDataset:
    """Host shards (materialized or provider-backed) + packing metadata.

    * ``data``: list over clients of dicts of arrays (first axis =
      samples), the ``FederatedDataset`` layout; every client is validated
      against client 0's schema up front (``CorpusSchemaError`` naming the
      client).
    * ``provider``: a lazy ``ShardProvider``; ``counts``/``fields`` come
      from its declaration, and each fetched shard is checked against it.

    ``seed`` keys the minibatch draws like every other plane.  ``validate``
    (provider path) checks fetched shards ``"always"``, once per client
    (``"first"``, the default) or ``"never"``.
    """

    VALIDATE_MODES = ("always", "first", "never")

    def __init__(self, data: Optional[List[Dict[str, np.ndarray]]] = None,
                 seed: int = 0, provider: Optional[ShardProvider] = None,
                 validate: str = "first"):
        if validate not in self.VALIDATE_MODES:
            raise ValueError(
                f"validate must be one of {self.VALIDATE_MODES}, "
                f"got {validate!r}")
        if (data is None) == (provider is None):
            raise ValueError(
                "StreamingFederatedDataset takes exactly one of data= (a "
                "materialized per-client shard list) or provider= (a lazy "
                "ShardProvider)")
        if provider is not None:
            if not isinstance(provider, ShardProvider):
                raise TypeError(
                    f"provider must implement the ShardProvider protocol "
                    f"(n_clients, counts, fields, shard(client_id)); "
                    f"{type(provider).__name__} does not")
            counts = np.asarray(provider.counts, np.int64)
            if counts.ndim != 1 or len(counts) != provider.n_clients \
                    or len(counts) == 0:
                raise CorpusSchemaError(
                    f"provider declares n_clients={provider.n_clients} but "
                    f"counts has shape {counts.shape}: want a non-empty "
                    f"[K] vector")
            if (counts < 1).any():
                bad = int(np.argmin(counts))
                raise CorpusSchemaError(
                    f"provider declares n_k = {int(counts[bad])} for client "
                    f"{bad}: every client needs n_k >= 1 (the keyed "
                    f"minibatch draw is undefined on an empty span)",
                    client=bad)
            fields = {name: (tuple(tail), np.dtype(dt))
                      for name, (tail, dt) in sorted(provider.fields.items())}
            if not fields:
                raise CorpusSchemaError("provider declares no fields")
        else:
            counts = validate_client_data(data)
            fields = dict(sorted(shard_schema(data[0]).items()))
        self.data = data
        self.provider = provider
        self.counts = np.asarray(counts, np.int32)
        self.seed = seed
        self.n_max = int(self.counts.max())
        self.fields = fields
        self.validate = validate
        self._validated: set = set()   # clients passed under "first"

    @classmethod
    def from_federated(cls, ds: FederatedDataset
                       ) -> "StreamingFederatedDataset":
        return cls(ds.data, seed=ds.seed)

    @classmethod
    def from_provider(cls, provider: ShardProvider, seed: int = 0,
                      validate: str = "first"
                      ) -> "StreamingFederatedDataset":
        return cls(provider=provider, seed=seed, validate=validate)

    # -- inspection -----------------------------------------------------
    @property
    def n_clients(self) -> int:
        return len(self.counts)

    @property
    def row_nbytes(self) -> int:
        """Device bytes of one sample row, summed over fields."""
        return sum(int(np.prod(tail, dtype=np.int64))
                   * np.dtype(dtype).itemsize
                   for tail, dtype in self.fields.values())

    @property
    def slot_nbytes(self) -> int:
        """Device bytes one uniform cache slot costs (padded to n_max)."""
        return self.n_max * self.row_nbytes

    @property
    def packed_nbytes(self) -> int:
        """What a device-resident copy of the padded corpus would pay."""
        return self.n_clients * self.slot_nbytes

    def tier_layout(self, tiers: Optional[int] = None) -> TierLayout:
        """Bucket clients into power-of-two slot-size tiers: the distinct
        ``min(next_pow2(n_k), n_max)`` values of the corpus; ``tiers=m``
        keeps only the m largest (smaller clients pad up into the smallest
        kept tier), so ``tiers=1`` is the uniform n_max-slot layout."""
        # over the distinct n_k (a handful), then mapped back to [K]: a
        # million-client corpus costs no per-client Python loop
        uniq, inv = np.unique(self.counts, return_inverse=True)
        rows = [min(next_pow2(int(n)), self.n_max) for n in uniq]
        natural = sorted(set(rows))
        if tiers is not None:
            if int(tiers) < 1:
                raise ValueError(f"tiers must be >= 1, got {tiers!r}")
            natural = natural[-int(tiers):]
        sizes = tuple(natural)
        tier_of = np.asarray([bisect_left(sizes, r) for r in rows],
                             np.int32)[inv.reshape(-1)]
        tier_counts = tuple(int(c) for c in np.bincount(
            tier_of, minlength=len(sizes)))
        return TierLayout(sizes=sizes, tier_of=tier_of,
                          tier_counts=tier_counts,
                          row_nbytes=self.row_nbytes)

    def population(self) -> ClientPopulation:
        return ClientPopulation(counts=np.asarray(self.counts))

    def base_key(self, device=None):
        return prng.PRNGKey(self.seed, device=device)

    def shard(self, cid: int) -> Dict[str, np.ndarray]:
        """Client ``cid``'s raw shard: a list lookup, or one
        ``provider.shard(cid)`` call checked against the declared schema and
        ``counts[cid]`` (as ``validate`` says) before any upload sees it."""
        if self.provider is None:
            return self.data[cid]
        cid = int(cid)
        shard = self.provider.shard(cid)
        if self.validate == "always" or (self.validate == "first"
                                         and cid not in self._validated):
            check_shard(shard, self.fields, cid, n_k=int(self.counts[cid]),
                        source="provider shard for")
            if self.validate == "first":
                self._validated.add(cid)
        return shard

    def padded_client(self, cid: int,
                      rows: Optional[int] = None) -> Dict[str, np.ndarray]:
        """All of client ``cid``'s fields padded to [rows, ...] from one
        ``shard()`` fetch; ``rows`` defaults to n_max, a tier passes its
        own size."""
        shard = self.shard(cid)
        n_rows = self.n_max if rows is None else rows
        out = {}
        for name, (tail, dtype) in self.fields.items():
            arr = np.asarray(shard[name])
            padded = np.zeros((n_rows,) + tail, dtype)
            padded[: len(arr)] = arr
            out[name] = padded
        return out

    def padded_shard(self, cid: int, name: str,
                     rows: Optional[int] = None) -> np.ndarray:
        """Client ``cid``'s field ``name`` padded to [rows, ...] (re-fetches
        the shard per call; prefer ``padded_client`` for several fields)."""
        return self.padded_client(cid, rows)[name]


def _row_gather(a: torch.Tensor, slots: torch.Tensor, idx: torch.Tensor,
                local_steps: int, batch_size: int) -> torch.Tensor:
    """``a[slots[c], idx[c, j]]`` for every client c: [C, H, b, ...]."""
    rows = a[slots.long()[:, None], idx.long()]
    return rows.reshape((rows.shape[0], local_steps, batch_size)
                        + a.shape[2:])


class CacheView:
    """A snapshot of a ``ShardCache`` for one chunk: the per-tier
    ``[slots_t, n_tier, ...]`` tensors, the true ``counts`` [K] and the
    ``client_tiers`` / ``client_slots`` [K] int32 tables (slot -1 when a
    client is not resident), all on the cache's device.  Draws are keyed by
    the true client id and n_k, so the gathered rows are bit-equal to every
    other plane's."""

    def __init__(self, tier_arrays: Tuple[Dict[str, torch.Tensor], ...],
                 counts: torch.Tensor, client_tiers: torch.Tensor,
                 client_slots: torch.Tensor, seed: int = 0):
        self.tier_arrays = tuple(tier_arrays)
        self.counts = counts
        self.client_tiers = client_tiers
        self.client_slots = client_slots
        self.seed = seed

    @property
    def device(self) -> torch.device:
        return self.counts.device

    def base_key(self):
        return prng.PRNGKey(self.seed, device=self.device)

    def _draw(self, key, t, cids, need):
        return minibatch_indices(key, t, cids, self.counts[cids], need)

    def gather_round_batch(self, key: torch.Tensor, t, client_ids,
                           local_steps: int, batch_size: int):
        """Round ``t``'s ``[C, H, b, ...]`` batch stack for ``client_ids``.

        Every tier is gathered for every client and the client's own tier
        selected, as the reference's ``lax.switch`` under ``vmap`` does.
        In another tier a client's slot and row ids may be out of range (a
        slot of -1, a row past that tier's size), which XLA clamps
        silently; torch would raise (or wrap -1), so they are clamped per
        tier before indexing.  In the client's own tier nothing is clamped
        (``idx < n_k <= n_tier``), so the selected rows are the
        reference's bit for bit.
        """
        need = local_steps * batch_size
        cids = torch.as_tensor(client_ids, device=self.device).long()
        idx = self._draw(key, t, cids, need)
        slots = self.client_slots[cids]
        tiers = self.client_tiers[cids]
        out = None
        for tier, arrs in enumerate(self.tier_arrays):
            some = next(iter(arrs.values()))
            s = slots.clamp(0, some.shape[0] - 1)
            ix = idx.clamp(max=some.shape[1] - 1)
            rows = {name: _row_gather(a, s, ix, local_steps, batch_size)
                    for name, a in arrs.items()}
            if out is None:
                out = rows
                continue
            pick = tiers == tier
            out = {name: torch.where(
                pick.reshape((-1,) + (1,) * (r.dim() - 1)), r, out[name])
                for name, r in rows.items()}
        return out

    def gather_round_block(self, key: torch.Tensor, t, client_ids,
                           local_steps: int, batch_size: int, mesh):
        """This rank's ``mesh.block(C)`` rows of ``gather_round_batch``
        (every rank holds the whole view)."""
        lo, hi = mesh.block(len(client_ids))
        return self.gather_round_batch(key, t, client_ids[lo:hi],
                                       local_steps, batch_size)

    def gather_tier_batch(self, tier: int, key: torch.Tensor, t, client_ids,
                          local_steps: int, batch_size: int):
        """Gather for clients known to live in ``tier``: one direct row
        index into that tier's tensors.  The caller guarantees residency
        and tier membership (a client of another tier would read the wrong
        corpus), which is why zero-weight padding reuses a same-tier
        client."""
        need = local_steps * batch_size
        cids = torch.as_tensor(client_ids, device=self.device).long()
        idx = self._draw(key, t, cids, need)
        return self.gather_tier_rows(tier, cids, idx, local_steps,
                                     batch_size)

    def gather_tier_rows(self, tier: int, client_ids, idx,
                         local_steps: int, batch_size: int):
        """``gather_tier_batch`` with the index draw already staged
        (``idx``: [C_i, H*b], the host replay of ``minibatch_indices``)."""
        cids = torch.as_tensor(client_ids, device=self.device).long()
        idx = torch.as_tensor(idx, device=self.device)
        slots = self.client_slots[cids]
        return {name: _row_gather(a, slots, idx, local_steps, batch_size)
                for name, a in self.tier_arrays[tier].items()}


class ShardCache:
    """Bounded device-side LRU cache of client shards, tiered by n_k.

    ``capacity_clients`` is a per-request guarantee: any ``ensure`` of that
    many distinct clients fits however they spread over tiers (tier t gets
    ``min(K_t, capacity)`` slots of its own row size).  ``capacity_bytes``
    becomes the largest such guarantee whose tiered footprint fits (the
    tighter of the two wins); a budget below one slot per occupied tier
    raises.  ``ensure`` raises when one request needs more distinct clients
    than the guarantee.  The tensors live on ``device`` (``None`` = cuda).
    """

    def __init__(self, dataset: StreamingFederatedDataset,
                 capacity_clients: Optional[int] = None,
                 capacity_bytes: Optional[int] = None,
                 tiers: Optional[int] = None, device=None,
                 storage: Optional[list] = None,
                 uploads: Optional["_Uploads"] = None):
        layout, cap = _cache_capacity(dataset, capacity_clients,
                                      capacity_bytes, tiers)
        self.device = resolve_device(device)
        self._uploads = uploads or _Uploads(self.device)
        self.capacity = cap
        self.layout = layout
        self.tier_slots = tuple(min(k_t, cap) for k_t in layout.tier_counts)
        self.dataset = dataset
        # storage / uploads: per-tier dicts of [slots_t, n_tier, ...]
        # tensors to hold the slots in and the upload path (a
        # MeshShardedCache's views into one buffer, and its one path)
        self.tier_arrays = storage if storage is not None else [
            {name: torch.zeros((slots_t, size_t) + tail,
                               dtype=_torch_dtype(dtype), device=self.device)
             for name, (tail, dtype) in dataset.fields.items()}
            for slots_t, size_t in zip(self.tier_slots, layout.sizes)
        ]
        self._counts_dev = to_device(dataset.counts, self.device)
        self._tiers_dev = to_device(layout.tier_of, self.device)
        self._tier_of = layout.tier_of
        self._slot_of: List[Dict[int, int]] = [
            {} for _ in range(layout.n_tiers)]
        self._lru: List["OrderedDict[int, None]"] = [
            OrderedDict() for _ in range(layout.n_tiers)]
        self.hits = self.misses = self.evictions = 0
        # per-tier attribution (sums equal the cache-wide counters)
        self.tier_hits = [0] * layout.n_tiers
        self.tier_misses = [0] * layout.n_tiers
        self.tier_evictions = [0] * layout.n_tiers

    # -- inspection -----------------------------------------------------
    @property
    def slots(self) -> int:
        """Total allocated slots across tiers."""
        return sum(self.tier_slots)

    @property
    def tier_sizes(self) -> Tuple[int, ...]:
        return self.layout.sizes

    @property
    def nbytes(self) -> int:
        """Device footprint of the cache."""
        return sum(a.numel() * a.element_size() for arrs in self.tier_arrays
                   for a in arrs.values())

    @property
    def hit_rate(self) -> float:
        return self.hits / max(self.hits + self.misses, 1)

    def resident(self) -> set:
        return set().union(*(set(s) for s in self._slot_of))

    @property
    def upload_bytes(self) -> int:
        """Bytes sent to the device so far: rows, slot ids and view
        tables."""
        return self._uploads.bytes

    @property
    def staging_bytes(self) -> int:
        """The largest device staging (rows and slot ids) one ``ensure``
        took: at most one chunk's misses."""
        return self._uploads.staging

    # -- population -----------------------------------------------------
    def ensure(self, client_ids) -> None:
        """Make every client in ``client_ids`` resident (per-tier LRU
        eviction, one batched copy per tier per field for the missing
        shards).  ``client_ids`` may repeat — pass the chunk's raw
        per-round sequence, so recency lands in last-use order."""
        self._ensure(client_ids)
        self._uploads.settle()

    def _ensure(self, client_ids) -> None:
        seq = [int(c) for c in client_ids]
        need = list(OrderedDict((c, None) for c in seq))
        distinct = set(need)
        if len(distinct) > self.capacity:
            raise ValueError(
                f"chunk needs {len(distinct)} distinct clients but the "
                f"shard cache guarantees {self.capacity} slots; lower "
                f"chunk_rounds or raise the cache capacity")
        fresh_by_tier: Dict[int, List[int]] = {}
        n_fresh = 0
        for cid in need:
            tier = int(self._tier_of[cid])
            if cid not in self._slot_of[tier]:
                fresh_by_tier.setdefault(tier, []).append(cid)
                self.tier_misses[tier] += 1
                n_fresh += 1
            else:
                self.tier_hits[tier] += 1
        self.hits += len(need) - n_fresh
        self.misses += n_fresh
        for tier, fresh in fresh_by_tier.items():
            slot_of, lru = self._slot_of[tier], self._lru[tier]
            assigned = []
            for cid in fresh:
                if len(slot_of) < self.tier_slots[tier]:
                    slot = len(slot_of)
                else:
                    # exists: distinct-in-tier <= tier_slots[tier] once the
                    # capacity check above passed
                    victim = next(c for c in lru if c not in distinct)
                    slot = slot_of.pop(victim)
                    del lru[victim]
                    self.evictions += 1
                    self.tier_evictions[tier] += 1
                slot_of[cid] = slot
                assigned.append(slot)
            self._write(tier, fresh, assigned)
        for cid in seq:             # refresh recency in last-use order
            lru = self._lru[int(self._tier_of[cid])]
            lru[cid] = None
            lru.move_to_end(cid)

    def _write(self, tier: int, fresh: List[int], slots: List[int]) -> None:
        """Write the shards of ``fresh`` into tier ``tier``'s ``slots``: one
        shard fetch a client (a provider synthesizes each missing client
        once, not once per field), the rows assembled padded into one host
        tensor a field and sent with the slot ids (``_Uploads.send``), then
        one ``index_copy_`` a field on the current stream."""
        rows = self.layout.sizes[tier]
        up = self._uploads
        host = {name: up.host((len(fresh), rows) + tuple(arr.shape[2:]),
                              arr.dtype)
                for name, arr in self.tier_arrays[tier].items()}
        views = {name: h.numpy() for name, h in host.items()}
        for j, cid in enumerate(fresh):
            shard = self.dataset.shard(cid)
            for name, v in views.items():
                a = np.asarray(shard[name])
                v[j, :len(a)] = a
                v[j, len(a):] = 0
        idx = up.host((len(slots),), torch.int64)
        idx.numpy()[:] = slots
        sent = up.send([idx] + list(host.values()))
        up.staged += sum(t.numel() * t.element_size() for t in sent)
        for name, rows_dev in zip(host, sent[1:]):
            self.tier_arrays[tier][name].index_copy_(0, sent[0], rows_dev)

    def view(self) -> CacheView:
        """Snapshot the client -> slot table for one chunk."""
        return CacheView(tuple(dict(arrs) for arrs in self.tier_arrays),
                         self._counts_dev, self._tiers_dev,
                         self._uploads.slot_table(
                             self.dataset.n_clients,
                             ((cid, slot) for slot_of in self._slot_of
                              for cid, slot in slot_of.items())),
                         self.dataset.seed)


class _Uploads:
    """A cache's host-to-device path.  On a card, host tensors are pinned
    (PyTorch's caching host allocator keeps a block from reuse until its
    copy is done), and ``send`` copies them without blocking on the copy
    stream this object owns into device tensors allocated on that stream,
    makes the current stream wait for the copy (an event) and records the
    tensors for it.  Nothing falls back to pageable memory: a failure to
    pin, to make the stream or to copy raises.  On the CPU the host
    tensors are plain and ``send`` returns them as they are.

    ``bytes`` counts everything sent; ``staging`` is the largest device
    staging (rows and slot ids) one ``ensure`` took, ``staged`` the one in
    progress."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self.bytes = self.staging = self.staged = 0

    def host(self, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, pin_memory=self.cuda)

    def send(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        self.bytes += sum(t.numel() * t.element_size() for t in tensors)
        if not self.cuda:
            return tensors
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self.stream):
            out = [t.to(self.device, non_blocking=True) for t in tensors]
        compute.wait_stream(self.stream)
        for t in out:
            t.record_stream(compute)
        return out

    def slot_table(self, n_clients: int, entries) -> torch.Tensor:
        """The [K] int32 client -> slot table of ``entries`` ((cid, slot)
        pairs; -1 elsewhere), sent as the rows are."""
        table = self.host((n_clients,), torch.int32)
        t = table.numpy()
        t.fill(-1)
        for cid, slot in entries:
            t[cid] = slot
        return self.send([table])[0]

    def settle(self) -> None:
        """Close one ``ensure``: keep the largest staging seen."""
        self.staging = max(self.staging, self.staged)
        self.staged = 0


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros((), np.dtype(dtype))).dtype


def _cache_capacity(dataset: StreamingFederatedDataset,
                    capacity_clients: Optional[int],
                    capacity_bytes: Optional[int],
                    tiers: Optional[int]) -> Tuple[TierLayout, int]:
    """A cache declaration's tier layout and distinct-client guarantee
    (the tighter of ``capacity_clients`` and ``capacity_bytes`` wins)."""
    if capacity_clients is None and capacity_bytes is None:
        raise ValueError(
            "ShardCache needs capacity_clients or capacity_bytes")
    layout = dataset.tier_layout(tiers)
    cap = dataset.n_clients
    if capacity_clients is not None:
        cap = min(cap, max(1, int(capacity_clients)))
    if capacity_bytes is not None:
        by_bytes = layout.capacity_for_bytes(int(capacity_bytes))
        if by_bytes is None:
            raise ValueError(
                f"capacity_bytes={int(capacity_bytes)} is below the "
                f"minimum viable cache budget: one slot in each of the "
                f"{layout.n_tiers} occupied size tier(s) (rows "
                f"{layout.sizes}) needs {layout.min_viable_bytes} B — "
                f"raise capacity_bytes to at least that, or declare "
                f"capacity_clients instead")
        cap = min(cap, by_bytes)
    return layout, cap


class MeshShardedCache:
    """Per-shard ``ShardCache`` composition for the mesh-sharded planes.

    Clients are assigned to data shards by ``cid % n_shards`` (static, so
    the assignment never depends on LRU history), and each shard owns a
    full-capacity ``ShardCache`` over its own client subset: per-device
    capacity semantics, the declared ``capacity_clients`` /
    ``capacity_bytes`` budget is what one shard's cache may hold, matching
    the auto rule's per-device pricing (splitting one budget n ways would
    let an unlucky assignment evict mid-chunk).

    ``ensure`` routes each shard its own sub-sequence (order preserved, so
    per-shard LRU recency still lands in last-use order); ``view`` is ONE
    ``CacheView`` over the per-shard tiers laid end to end along the slot
    axis, each shard's client->slot entries offset by the slots of the
    shards before it, so the gathers consume it as they consume a single
    cache's and the trajectory is the single-cache plane's.  The shards'
    slots are views into one buffer a tier, so the composed view is that
    buffer and costs no copy (the reference concatenates a tier's shards
    for each view).  Every rank of a mesh holds the same composed cache,
    as the reference's replicated 'cache_slots' rule places it.  The shards
    share one upload path (``_Uploads``: on a card, one copy stream), so
    their writes into the buffer, and the composed view's slot table, are
    ordered behind the chunk in flight as a single cache's are.

    Counter properties aggregate across shards, so the trainer's
    ``cache_*`` chunk metrics read it like a plain ``ShardCache``.
    """

    def __init__(self, dataset: StreamingFederatedDataset, n_shards: int,
                 capacity_clients: Optional[int] = None,
                 capacity_bytes: Optional[int] = None,
                 tiers: Optional[int] = None, device=None):
        if int(n_shards) < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards!r}")
        self.dataset = dataset
        self.n_shards = n = int(n_shards)
        self.device = resolve_device(device)
        layout, cap = _cache_capacity(dataset, capacity_clients,
                                      capacity_bytes, tiers)
        self._uploads = _Uploads(self.device)
        slots = [min(k_t, cap) for k_t in layout.tier_counts]
        self.tier_arrays = [
            {name: torch.zeros((n * slots_t, size_t) + tail,
                               dtype=_torch_dtype(dtype), device=self.device)
             for name, (tail, dtype) in dataset.fields.items()}
            for slots_t, size_t in zip(slots, layout.sizes)]
        self.shards = tuple(
            ShardCache(dataset, capacity_clients=capacity_clients,
                       capacity_bytes=capacity_bytes, tiers=tiers,
                       device=self.device, uploads=self._uploads,
                       storage=[{name: a[s * slots_t:(s + 1) * slots_t]
                                 for name, a in arrs.items()}
                                for arrs, slots_t in zip(self.tier_arrays,
                                                         slots)])
            for s in range(n))
        self.layout = layout
        self._counts_dev = self.shards[0]._counts_dev
        self._tiers_dev = self.shards[0]._tiers_dev

    # -- aggregate inspection (ShardCache-compatible) -------------------
    @property
    def capacity(self) -> int:
        """Total distinct-client guarantee across shards: exact only for
        a shard-balanced request; the per-shard guarantee is what
        ``ensure`` enforces."""
        return sum(s.capacity for s in self.shards)

    @property
    def slots(self) -> int:
        return sum(s.slots for s in self.shards)

    @property
    def tier_slots(self) -> Tuple[int, ...]:
        return tuple(sum(s.tier_slots[t] for s in self.shards)
                     for t in range(self.layout.n_tiers))

    @property
    def tier_sizes(self) -> Tuple[int, ...]:
        return self.layout.sizes

    @property
    def nbytes(self) -> int:
        return sum(s.nbytes for s in self.shards)

    @property
    def hits(self) -> int:
        return sum(s.hits for s in self.shards)

    @property
    def misses(self) -> int:
        return sum(s.misses for s in self.shards)

    @property
    def evictions(self) -> int:
        return sum(s.evictions for s in self.shards)

    @property
    def tier_hits(self) -> List[int]:
        return [sum(s.tier_hits[t] for s in self.shards)
                for t in range(self.layout.n_tiers)]

    @property
    def tier_misses(self) -> List[int]:
        return [sum(s.tier_misses[t] for s in self.shards)
                for t in range(self.layout.n_tiers)]

    @property
    def tier_evictions(self) -> List[int]:
        return [sum(s.tier_evictions[t] for s in self.shards)
                for t in range(self.layout.n_tiers)]

    @property
    def hit_rate(self) -> float:
        return self.hits / max(self.hits + self.misses, 1)

    @property
    def upload_bytes(self) -> int:
        return self._uploads.bytes

    @property
    def staging_bytes(self) -> int:
        return self._uploads.staging

    def resident(self) -> set:
        return set().union(*(s.resident() for s in self.shards))

    # -- population -----------------------------------------------------
    def ensure(self, client_ids) -> None:
        """Route each client to its shard's cache (sub-sequences keep the
        chunk's raw order, so per-shard LRU recency refresh stays in
        last-use order)."""
        per_shard: List[list] = [[] for _ in range(self.n_shards)]
        for cid in client_ids:
            per_shard[int(cid) % self.n_shards].append(int(cid))
        for shard, seq in zip(self.shards, per_shard):
            if seq:
                shard._ensure(seq)
        self._uploads.settle()

    def view(self) -> CacheView:
        """The composed ``CacheView``: the per-tier buffers, and each
        shard's client->slot entries shifted by the slots of the shards
        before it in that tier."""
        entries = ((cid, slot + s * shard.tier_slots[t])
                   for s, shard in enumerate(self.shards)
                   for t, slot_of in enumerate(shard._slot_of)
                   for cid, slot in slot_of.items())
        return CacheView(tuple(dict(arrs) for arrs in self.tier_arrays),
                         self._counts_dev, self._tiers_dev,
                         self._uploads.slot_table(self.dataset.n_clients,
                                                  entries),
                         self.dataset.seed)


# ---------------------------------------------------------------------------
# on-disk corpora: DiskShardProvider + writer + LEAF ingestion
# ---------------------------------------------------------------------------
CORPUS_FORMAT = "repro-fleet-corpus"
CORPUS_VERSION = 1
CORPUS_LAYOUTS = ("npy-packed", "npz-per-client")


def _dtype_tag(dt) -> str:
    return np.dtype(dt).name


def _field_dtype(arr: np.ndarray) -> np.dtype:
    """LEAF json carries untyped numbers: floats land as float64, ints as
    int64 — narrow to the repo's float32/int32 corpus convention."""
    if np.issubdtype(arr.dtype, np.floating):
        return np.dtype(np.float32)
    if np.issubdtype(arr.dtype, np.integer):
        return np.dtype(np.int32)
    raise CorpusSchemaError(
        f"unsupported field dtype {arr.dtype} (want numeric)")


def parse_leaf_dir(leaf_dir: str):
    """Parse a LEAF-format directory (``*.json`` files with ``users`` /
    ``num_samples`` / ``user_data``, the layout the LEAF benchmark suite
    emits) into ``(counts, fields, shards, users)`` — host arrays, floats
    narrowed to float32 and ints to int32.  Files are visited in sorted
    name order and users in file order, so the client-id assignment is
    deterministic across runs and machines."""
    files = sorted(_glob.glob(os.path.join(leaf_dir, "*.json")))
    if not files:
        raise CorpusSchemaError(
            f"no LEAF json files in {leaf_dir!r} (want the LEAF layout: "
            f"*.json with users/num_samples/user_data)")
    users, shards = [], []
    for path in files:
        with open(path) as f:
            blob = json.load(f)
        for key in ("users", "user_data"):
            if key not in blob:
                raise CorpusSchemaError(
                    f"{path!r} is not LEAF-format: missing {key!r}")
        declared = dict(zip(blob["users"],
                            blob.get("num_samples", [])))
        for user in blob["users"]:
            ud = blob["user_data"][user]
            shard = {}
            for name, rows in sorted(ud.items()):
                arr = np.asarray(rows)
                shard[name] = arr.astype(_field_dtype(arr))
            n = len(next(iter(shard.values())))
            if user in declared and int(declared[user]) != n:
                raise CorpusSchemaError(
                    f"LEAF user {user!r} declares num_samples="
                    f"{declared[user]} but carries {n} rows",
                    client=len(users))
            users.append(user)
            shards.append(shard)
    fields = {name: schema
              for name, schema in sorted(shard_schema(shards[0]).items())}
    counts = np.array([check_shard(s, fields, k, source="LEAF user")
                       for k, s in enumerate(shards)], np.int64)
    return counts, fields, shards, users


def write_disk_corpus(root: str, provider: ShardProvider,
                      layout: str = "npy-packed") -> str:
    """Materialize any ``ShardProvider`` as an on-disk corpus directory
    readable by ``DiskShardProvider``; returns ``root``.

    ``npy-packed``: one row-concatenated ``<field>.npy`` per field (written
    via ``open_memmap``, so host RAM never holds the packed corpus) —
    the mmap-backed layout for big corpora.  ``npz-per-client``: one
    ``shards/<cid>.npz`` per client — the simple layout for small ones.
    Either way ``counts.npy`` + ``manifest.json`` declare the schema.
    """
    if layout not in CORPUS_LAYOUTS:
        raise ValueError(
            f"layout must be one of {CORPUS_LAYOUTS}, got {layout!r}")
    os.makedirs(root, exist_ok=True)
    counts = np.asarray(provider.counts, np.int64)
    fields = {name: (tuple(tail), np.dtype(dt))
              for name, (tail, dt) in sorted(provider.fields.items())}
    np.save(os.path.join(root, "counts.npy"), counts)
    if layout == "npy-packed":
        total = int(counts.sum())
        offsets = np.concatenate([[0], np.cumsum(counts)])
        mms = {name: np.lib.format.open_memmap(
                   os.path.join(root, f"{name}.npy"), mode="w+",
                   dtype=dtype, shape=(total,) + tail)
               for name, (tail, dtype) in fields.items()}
        for cid in range(len(counts)):
            shard = provider.shard(cid)
            lo, hi = int(offsets[cid]), int(offsets[cid + 1])
            for name, mm in mms.items():
                mm[lo:hi] = np.asarray(shard[name], mm.dtype)
        for mm in mms.values():
            mm.flush()
    else:
        sdir = os.path.join(root, "shards")
        os.makedirs(sdir, exist_ok=True)
        for cid in range(len(counts)):
            shard = provider.shard(cid)
            np.savez(os.path.join(sdir, f"{cid}.npz"),
                     **{name: np.asarray(shard[name], dtype)
                        for name, (_, dtype) in fields.items()})
    manifest = {
        "format": CORPUS_FORMAT,
        "version": CORPUS_VERSION,
        "layout": layout,
        "n_clients": int(len(counts)),
        "counts": "counts.npy",
        "fields": {name: {"shape": list(tail), "dtype": _dtype_tag(dtype)}
                   for name, (tail, dtype) in fields.items()},
    }
    with open(os.path.join(root, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
        f.write("\n")
    return root


def leaf_to_corpus(leaf_dir: str, out_dir: str,
                   layout: str = "npz-per-client") -> str:
    """Convert a LEAF-format directory into a ``DiskShardProvider`` corpus
    (see ``write_disk_corpus`` for the layouts); returns ``out_dir``."""
    parsed_counts, parsed_fields, parsed_shards, _ = parse_leaf_dir(leaf_dir)

    class _Parsed:
        n_clients = len(parsed_counts)
        counts = parsed_counts
        fields = parsed_fields

        def shard(self, cid):
            return parsed_shards[int(cid)]

    return write_disk_corpus(out_dir, _Parsed(), layout=layout)


class DiskShardProvider:
    """``ShardProvider`` over an on-disk corpus directory.

    Accepts either a manifest-declared corpus (``manifest.json`` +
    ``counts.npy`` + field files, as ``write_disk_corpus`` /
    ``leaf_to_corpus`` emit) or a raw LEAF-format directory of json files
    (parsed once at construction — json cannot be mmapped; convert big
    LEAF corpora with ``leaf_to_corpus`` to get the mmap-backed layout).

    ``npy-packed`` corpora are opened with ``np.load(mmap_mode="r")``:
    construction touches only the [K] count vector and the file headers,
    and ``shard(cid)`` copies the client's row span out of the mapping —
    host RAM never holds the corpus.  ``shard`` is a pure function of
    ``client_id`` over immutable files, so an eviction-refetch (or a
    resumed run) returns bit-identical rows — the property that keeps
    disk-backed trajectories bit-reproducible.
    """

    def __init__(self, root: str):
        self.root = str(root)
        manifest_path = os.path.join(self.root, "manifest.json")
        if os.path.exists(manifest_path):
            self._init_manifest(manifest_path)
        elif _glob.glob(os.path.join(self.root, "*.json")):
            self._init_leaf()
        else:
            raise CorpusSchemaError(
                f"{self.root!r} is neither a manifest-declared corpus "
                f"(manifest.json) nor a LEAF-format directory (*.json)")

    def _init_manifest(self, manifest_path: str):
        with open(manifest_path) as f:
            manifest = json.load(f)
        if manifest.get("format") != CORPUS_FORMAT:
            raise CorpusSchemaError(
                f"{manifest_path!r} is not a {CORPUS_FORMAT} manifest "
                f"(format={manifest.get('format')!r})")
        if manifest.get("version") != CORPUS_VERSION:
            raise CorpusSchemaError(
                f"corpus version {manifest.get('version')!r} unsupported "
                f"(this build reads version {CORPUS_VERSION})")
        layout = manifest.get("layout")
        if layout not in CORPUS_LAYOUTS:
            raise CorpusSchemaError(
                f"corpus layout {layout!r} unsupported (want one of "
                f"{CORPUS_LAYOUTS})")
        self.layout = layout
        counts = np.load(os.path.join(self.root, manifest["counts"]))
        counts = np.asarray(counts, np.int64)
        if counts.ndim != 1 or len(counts) != int(manifest["n_clients"]):
            raise CorpusSchemaError(
                f"counts file has shape {counts.shape} but the manifest "
                f"declares n_clients={manifest['n_clients']}")
        self._counts = counts
        self._fields = {
            name: (tuple(spec["shape"]), np.dtype(spec["dtype"]))
            for name, spec in sorted(manifest["fields"].items())}
        if not self._fields:
            raise CorpusSchemaError("corpus manifest declares no fields")
        self._shards_mem = None
        if layout == "npy-packed":
            self._offsets = np.concatenate([[0], np.cumsum(counts)])
            total = int(self._offsets[-1])
            self._mm = {}
            for name, (tail, dtype) in self._fields.items():
                mm = np.load(os.path.join(self.root, f"{name}.npy"),
                             mmap_mode="r")
                if mm.shape != (total,) + tail or mm.dtype != dtype:
                    raise CorpusSchemaError(
                        f"packed field {name!r} is {mm.shape}/{mm.dtype} "
                        f"but the manifest declares "
                        f"{(total,) + tail}/{dtype}")
                self._mm[name] = mm
        else:
            sdir = os.path.join(self.root, "shards")
            for probe in (0, len(counts) - 1):
                p = os.path.join(sdir, f"{probe}.npz")
                if not os.path.exists(p):
                    raise CorpusSchemaError(
                        f"npz-per-client corpus missing shard file {p!r}",
                        client=probe)
            self._sdir = sdir

    def _init_leaf(self):
        self.layout = "leaf-json"
        counts, fields, shards, users = parse_leaf_dir(self.root)
        self._counts = counts
        self._fields = fields
        self._shards_mem = shards
        self.users = users

    @classmethod
    def from_leaf(cls, leaf_dir: str) -> "DiskShardProvider":
        """Open a raw LEAF-format directory directly (parse-once path;
        equivalent to ``DiskShardProvider(leaf_dir)``)."""
        return cls(leaf_dir)

    # -- ShardProvider protocol ------------------------------------------
    @property
    def n_clients(self) -> int:
        return len(self._counts)

    @property
    def counts(self) -> np.ndarray:
        return self._counts

    @property
    def fields(self) -> Dict[str, tuple]:
        return self._fields

    def shard(self, client_id: int) -> Dict[str, np.ndarray]:
        cid = int(client_id)
        if not 0 <= cid < self.n_clients:
            raise IndexError(
                f"client {cid} outside corpus [0, {self.n_clients})")
        if self._shards_mem is not None:          # leaf-json
            return self._shards_mem[cid]
        if self.layout == "npy-packed":
            lo, hi = int(self._offsets[cid]), int(self._offsets[cid + 1])
            return {name: np.array(mm[lo:hi])
                    for name, mm in self._mm.items()}
        with np.load(os.path.join(self._sdir, f"{cid}.npz")) as z:
            return {name: z[name] for name in self._fields}
