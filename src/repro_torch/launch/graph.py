"""One chunk of federated rounds captured as one CUDA graph.

This is the port's counterpart of the reference's jitted ``lax.scan`` over a
chunk (``launch/train.py`` ``_scan_chunk_fn`` / ``_device_chunk_fn`` there).
A ``ChunkGraph`` wraps ``body(state, inputs) -> (state, metrics)``: the eager
loop over a chunk's rounds (``core/multiround.py``), reading its per-chunk
inputs from static tensors.

* ``inputs``: a dict (one level may nest, e.g. the scanned plane's batch
  fields) of device tensors that ``run`` fills before each replay: an int
  by a fill kernel, a host array by an asynchronous copy from pinned
  memory, a device tensor by a device copy.  ``inputs["t0"]`` is the
  chunk's first round as int64: inside the body round r is ``t0 + r``, a
  device tensor, never a Python int (an int would become a kernel argument
  at capture, and every replay would draw round t0's clients).
* the server state: static tensors that the graph reads at its start and,
  as its last op, overwrites with the chunk's final state (the counterpart
  of ``donate_argnums=(0,)``).  ``run`` returns a ``ServerState`` over them
  with the host counter ``t0 + R``; a state that is not already those
  tensors is copied in first.
* the metrics: tensors of the graph's memory pool that the next replay
  overwrites; ``run`` returns clones enqueued right after the replay.

The first ``run`` warms the body up on a side stream over scratch copies of
the state, so the trajectory does not move (the warm-up loads the kernels,
fills the per-device caches such as the samplers' weight tables, and sizes
cuDNN's workspaces), then captures.  A capture that fails raises; nothing
falls back to the eager loop.  On the CPU the same inputs are filled and
the body runs eagerly on every call, and so it does on a card with
``capture=False``: the trainer's choice when the body's collectives run on
the host (gloo ranks of a data mesh), which a graph cannot capture.

Under an NCCL mesh the body's collectives (the delta's ``all_reduce``,
the losses' all-gather, the device plane's batch exchange) are captured
with the rest: NCCL enqueues them on the capturing stream, every rank
captures the same sequence, and the warm-up's first collective sets up the
communicator before the capture begins.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import spans
from repro_torch.core.server_opt import ServerState
from repro_torch.tree import leaves, tree_map, unflatten_like


def _host_tensor(value, cuda: bool) -> torch.Tensor:
    """A host array (or CPU tensor) as a CPU tensor, pinned for the card so
    that its copy is asynchronous."""
    x = value if isinstance(value, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(value))
    return x.pin_memory() if cuda and not x.is_pinned() else x


def pin_inputs(values: dict, device: torch.device) -> dict:
    """``values`` with every host array pinned when ``device`` is a card:
    a producer thread calls it so that ``ChunkGraph.run`` only enqueues."""
    cuda = device.type == "cuda"
    return unflatten_like(values, [
        v if isinstance(v, int) or (isinstance(v, torch.Tensor)
                                    and v.device.type != "cpu")
        else _host_tensor(v, cuda) for v in leaves(values)])


def _buffer(value, device) -> torch.Tensor:
    if isinstance(value, int):
        return torch.zeros((), dtype=torch.int64, device=device)
    x = value if isinstance(value, torch.Tensor) else np.asarray(value)
    dtype = x.dtype if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.zeros((), x.dtype)).dtype
    return torch.empty(tuple(x.shape), dtype=dtype, device=device)


class ChunkGraph:
    """``body`` over static inputs, captured on the card at its first
    ``run`` and replayed on every later one, or run eagerly over them
    (``capture=False``; see the module note)."""

    def __init__(self, body: Callable, n_rounds: int, device,
                 capture: bool = True):
        self.body = body
        self.n_rounds = int(n_rounds)
        self.device = torch.device(device)
        self.capture = capture
        self.inputs: Optional[dict] = None
        self.graph = None
        self.static = None        # (w, extra) the graph reads and updates
        self.metrics = None       # the graph's own metric outputs
        self.capture_s: Optional[float] = None

    def _fill(self, values: dict):
        vals = leaves(values)
        if self.inputs is None:
            self.inputs = unflatten_like(
                values, [_buffer(v, self.device) for v in vals])
        cuda = self.device.type == "cuda"
        for buf, v in zip(leaves(self.inputs), vals):
            if isinstance(v, int):
                buf.fill_(v)
                continue
            if not (isinstance(v, torch.Tensor) and v.device == buf.device):
                v = _host_tensor(v, cuda)
            if tuple(v.shape) != tuple(buf.shape):
                raise ValueError(
                    f"chunk input of shape {tuple(v.shape)} for a graph "
                    f"captured at {tuple(buf.shape)}")
            buf.copy_(v, non_blocking=cuda)

    def _capture(self, state: ServerState):
        spans.count("graph.captures")
        t_start = time.perf_counter()
        stream = torch.cuda.current_stream(self.device)
        self.static = tree_map(torch.clone, (state.w, state.extra))
        scratch = tree_map(torch.clone, (state.w, state.extra))
        side = torch.cuda.Stream(self.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            self.body(ServerState(*scratch, self.inputs["t0"]), self.inputs)
        stream.wait_stream(side)
        del scratch
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out, metrics = self.body(
                ServerState(*self.static, self.inputs["t0"]), self.inputs)
            for dst, src in zip(leaves(self.static),
                                leaves((out.w, out.extra))):
                dst.copy_(src)
        self.graph, self.metrics = graph, metrics
        self.capture_s = time.perf_counter() - t_start

    def run(self, state: ServerState, t0: int, values: dict) -> tuple:
        """Train rounds ``t0 .. t0 + R - 1`` from ``state``: fill the inputs
        (``values`` without ``t0``), replay (capture first on the card's
        first call) and return ``(state, metrics)``."""
        with spans.span("graph.fill"):
            self._fill({"t0": int(t0), **values})
        t_end = int(t0) + self.n_rounds
        if self.device.type != "cuda" or not self.capture:
            with spans.span("graph.replay"):
                out, metrics = self.body(
                    ServerState(state.w, state.extra, self.inputs["t0"]),
                    self.inputs)
            return ServerState(out.w, out.extra, t_end), metrics
        if self.graph is None:
            with spans.span("graph.capture"):
                self._capture(state)
        with spans.span("graph.replay"):
            for dst, src in zip(leaves(self.static),
                                leaves((state.w, state.extra))):
                if src is not dst:
                    dst.copy_(src)
            self.graph.replay()
            metrics = {k: v.clone() if isinstance(v, torch.Tensor) else v
                       for k, v in self.metrics.items()}
        return ServerState(*self.static, t_end), metrics


def detach_state(state: ServerState) -> ServerState:
    """``state`` with its tensors cloned: a trainer's state must not alias
    a graph's static tensors once its run returns (a later replay would
    overwrite them)."""
    return ServerState(*tree_map(torch.clone, (state.w, state.extra)),
                       state.t)
