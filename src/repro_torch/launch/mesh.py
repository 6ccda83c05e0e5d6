"""The data-parallel mesh: ``MeshSpec`` plans carry, and the ranks it runs
on.

The JAX package builds one controller over n devices.  The port runs n
processes, one ``torch.distributed`` rank per device, each running the
same ``FederatedTrainer``: every draw is keyed by ``(seed, t,
client_id)``, so every rank draws the same cohorts without talking, and
rank r trains the r-th contiguous block of each round's cohort
(``core/round.py``).  ``Mesh`` is a rank's view of the group: its size,
its rank, its device, and the collectives the round engine and the
device plane's gather need.

The backend follows the device: NCCL on the card (one card a rank: NCCL
refuses two ranks on one card), gloo on the CPU.  gloo ranks may also
share one card; their collectives run on the host, so a CUDA graph cannot
capture them (``launch/plan.py`` says when chunks then run eagerly).
``spawn`` starts n ranks, rendezvousing through a ``FileStore`` in a
temporary directory (no TCP port: the card's machine has no network, and
a fixed port collides between runs).

``make_production_mesh`` and ``make_host_mesh`` are the dry run's meshes
(``launch/dryrun.py``): mesh-axis sizes, as ``sharding.logical_spec``
takes them, where the reference builds ``jax`` meshes over devices.
"""
from __future__ import annotations

import os
import shutil
import tempfile
import time
from dataclasses import dataclass
from datetime import timedelta
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

_LAUNCH_HINT = (
    "launch one process per rank, e.g. repro_torch.launch.mesh.spawn(fn, "
    "n, device=...), or the quickstart's --mesh-devices n: NCCL needs one "
    "card a rank, gloo ranks may share a card or run on the CPU")


def _backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


@dataclass(frozen=True)
class MeshSpec:
    """Declarative data-parallel mesh for ``ExecutionPlan(mesh=...)``.

    ``devices=None`` takes every rank of the live process group (one rank
    when there is none); ``devices=n`` asks for n ranks, validated when the
    mesh is built, so a plan written for 4 ranks fails loudly in a
    1-rank process instead of training unsharded.  ``axis`` names the
    single mesh axis; the default ``"data"`` is what
    ``sharding.rules.FED_MESH_RULES`` maps the 'clients' logical axis onto,
    so the round engine's cohort splits across the ranks while params,
    server state and the aggregated delta stay replicated.

    Frozen and hashable: the spec keys the chunk graphs and the session's
    mesh and dataset caches.
    """
    devices: Optional[int] = None
    axis: str = "data"

    def __post_init__(self):
        if self.devices is not None and (
                not isinstance(self.devices, int) or self.devices < 1):
            raise ValueError(
                f"MeshSpec.devices must be a positive int or None (= all "
                f"local devices), got {self.devices!r}")
        if not self.axis or not isinstance(self.axis, str):
            raise ValueError(
                f"MeshSpec.axis must be a non-empty mesh-axis name, got "
                f"{self.axis!r}")

    def n_devices(self) -> int:
        """Concrete mesh size: ``devices``, or the live group's world size
        (1 without a group) for ``None``."""
        if self.devices is not None:
            return self.devices
        return dist.get_world_size() if dist.is_initialized() else 1

    def build(self, device=None) -> "Mesh":
        """This rank's ``Mesh`` on ``device`` (``None`` = ``cuda``).  A
        one-rank mesh in a process with no group starts a single-rank
        group itself (NCCL on a card, gloo on the CPU); a larger one needs
        the group its ranks were launched into, of exactly its size."""
        dev = resolve_device(device)
        n = self.n_devices()
        if not dist.is_initialized():
            if n > 1:
                raise ValueError(
                    f"MeshSpec wants {n} ranks but this process is in no "
                    f"process group (1 rank): {_LAUNCH_HINT}")
            _init_single_rank(dev)
        world = dist.get_world_size()
        if n != world:
            raise ValueError(
                f"MeshSpec wants {n} ranks but the live process group has "
                f"{world}: a mesh spans the whole group; {_LAUNCH_HINT}")
        backend = dist.get_backend()
        if backend == "nccl":
            if dev.type != "cuda":
                raise ValueError(
                    f"an NCCL process group needs the trainer on a card, "
                    f"got device {dev}")
            if n > torch.cuda.device_count():
                raise ValueError(
                    f"MeshSpec wants {n} NCCL ranks but "
                    f"{torch.cuda.device_count()} card(s) are visible: NCCL "
                    f"runs one rank a card; use gloo ranks to share one")
        return Mesh(self.axis, n, dist.get_rank(), dev, backend,
                    dist.group.WORLD)


def _init_single_rank(dev: torch.device) -> None:
    path = os.path.join(tempfile.mkdtemp(prefix="repro-mesh-"), "store")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(_backend_for(dev), store=dist.FileStore(path, 1),
                            rank=0, world_size=1)


class Mesh:
    """One rank's view of a 1-D data mesh: ``axis``, ``size`` (the world
    size), ``rank``, ``device``, and the process ``group`` with its
    ``backend`` (``None``: the default group), with the collectives the
    mesh planes run.  Every collective is synchronous on the current
    stream (NCCL) or on the host (gloo), and every rank must call it in
    the same order."""

    def __init__(self, axis: str, size: int, rank: int, device,
                 backend: str, group=None):
        self.axis, self.size, self.rank = axis, int(size), int(rank)
        self.device, self.backend = torch.device(device), backend
        self.group = group

    def __repr__(self):
        return (f"Mesh({self.axis!r}: {self.size}, rank {self.rank}, "
                f"{self.device}, {self.backend})")

    @property
    def shape(self) -> dict:
        return {self.axis: self.size}

    @property
    def axis_names(self) -> tuple:
        return (self.axis,)

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can capture this mesh's collectives: NCCL's
        run on the card's streams, gloo's on the host."""
        return self.backend == "nccl"

    def block(self, n: int) -> tuple:
        """``[lo, hi)``: this rank's contiguous block of ``n`` items, of
        ceil(n / size) (the last ranks' may be shorter or empty)."""
        b = -(-int(n) // self.size)
        return min(self.rank * b, n), min((self.rank + 1) * b, n)

    def _host(self, x: torch.Tensor) -> torch.Tensor:
        """What a collective takes: ``x`` itself under NCCL; under gloo,
        which runs on the host (and takes card tensors for few of its
        collectives), a host copy of a card tensor."""
        return x if self.capturable else x.cpu()

    def all_reduce_(self, x: torch.Tensor) -> torch.Tensor:
        """In-place SUM of ``x`` over the ranks."""
        h = self._host(x)
        dist.all_reduce(h, op=dist.ReduceOp.SUM, group=self.group)
        if h is not x:
            x.copy_(h)
        return x

    def all_gather_blocks(self, parts: list) -> list:
        """The wholes ``[n_i, ...]`` of several cohorts from each rank's
        ``block(n_i)`` rows ``x_i``, in order, for ``parts`` of ``(x_i,
        n_i)`` (one dtype and trailing shape): one all-gather of the
        blocks, each zero-padded to ceil(n_i / size)."""
        widths = [-(-int(n) // self.size) for _, n in parts]
        padded = [x if x.shape[0] == b else torch.cat(
            [x, x.new_zeros((b - x.shape[0],) + tuple(x.shape[1:]))])
            for (x, _), b in zip(parts, widths)]
        mine = self._host(torch.cat(padded).contiguous())
        out = mine.new_empty((self.size * mine.shape[0],)
                             + tuple(mine.shape[1:]))
        # torch 2.13 renames all_gather_into_tensor to all_gather_single
        # and deprecates the old name; older releases have only the old one
        gather = getattr(dist, "all_gather_single", None) \
            or dist.all_gather_into_tensor
        gather(out, mine, group=self.group)
        out = out.to(parts[0][0].device).reshape((self.size,)
                                                 + tuple(mine.shape))
        wholes, start = [], 0
        for (_, n), b in zip(parts, widths):
            wholes.append(out[:, start:start + b].reshape(
                (self.size * b,) + tuple(mine.shape[1:]))[:n])
            start += b
        return wholes

    def all_to_all(self, send: torch.Tensor) -> torch.Tensor:
        """Rows ``[size * m, ...]``: chunk q of ``send`` goes to rank q,
        and chunk p of the result came from rank p."""
        dev = send.device
        send = self._host(send.contiguous())
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.group)
        return recv.to(dev)

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier(group=self.group)


def _rank_main(rank: int, fn: Callable, n: int, device: str, backend: str,
               store: str, out_dir: str, args: tuple, timeout_s: float):
    dev = torch.device(device)
    if backend == "nccl":
        dev = torch.device("cuda", rank)
    elif dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        # CPU ranks share the host's cores: n ranks of all of them each
        # would oversubscribe it n times over
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    dist.init_process_group(backend, store=dist.FileStore(store, n),
                            rank=rank, world_size=n,
                            timeout=timedelta(seconds=timeout_s))
    try:
        out = fn(rank, n, dev, *args)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, n: int, device=None, args: tuple = (),
          backend: Optional[str] = None, timeout: float = 600.0) -> list:
    """Run ``fn(rank, n, device, *args)`` in ``n`` new processes, one rank
    each, and return their results in rank order.

    ``device``: ``None`` means ``cuda`` (``device="cpu"`` runs gloo ranks
    on the host).  ``fn`` must be importable by name (the processes start fresh, by the
    ``spawn`` method) and its result picklable.  ``backend``: ``"nccl"``
    or ``"gloo"``; by default NCCL on ``cuda`` (rank r on ``cuda:r``) and
    gloo on the CPU.  gloo ranks on ``cuda`` share its card.  A rank that
    raises or dies fails the call (the others are stopped), and so does a
    run longer than ``timeout`` seconds."""
    dev = torch.device("cuda" if device is None else device)
    backend = backend or _backend_for(dev)
    if backend == "nccl" and n > torch.cuda.device_count():
        raise ValueError(
            f"{n} NCCL ranks need {n} cards but "
            f"{torch.cuda.device_count()} are visible: NCCL runs one rank a "
            f"card; use backend='gloo' to share one")
    dev = resolve_device(dev)
    tmp = tempfile.mkdtemp(prefix="repro-mesh-")
    ctx = torch.multiprocessing.start_processes(
        _rank_main, args=(fn, n, str(dev), backend,
                          os.path.join(tmp, "store"), tmp, tuple(args),
                          timeout),
        nprocs=n, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"{n} ranks of {getattr(fn, '__name__', fn)} ran past "
                    f"{timeout:.0f} s")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(n)]
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=30)
        shutil.rmtree(tmp, ignore_errors=True)


def make_production_mesh(*, multi_pod: bool = False) -> dict:
    """The reference's production mesh as axis sizes: 16 x 16 = 256 cards
    a pod over ("data", "model"); 2 pods = 512 cards with "pod"."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def make_host_mesh(model: int = 1, device=None) -> dict:
    """A small mesh over the visible devices as axis sizes: the cards
    (``device=None`` means the card, and raises without one, as every
    entry point of the port does), or one host device for
    ``device="cpu"``."""
    dev = resolve_device(device)
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    if model < 1 or n % model:
        raise ValueError(f"model={model} does not divide the {n} visible "
                         f"device(s)")
    return {"data": n // model, "model": model}
