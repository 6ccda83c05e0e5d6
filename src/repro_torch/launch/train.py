"""Federated trainer: ``FederatedTrainer.run(n, plan=...)``.

Couples the host-side scheduler (client sampling, round-batch assembly,
checkpointing, logging) with the round engine, on the trainer's ``device``
(``cuda`` unless the caller asks for another).  The JAX package's four
execution planes and its ``"auto"`` rule are ported; every plane trains the
reference's trajectory within fp32 tolerance, because sampling and
minibatch draws are the same keyed threefry draws:

* ``plan="per_round"`` (the default when ``plan`` is omitted): one
  ``round_step`` per round, host Python between rounds;
* ``plan="scanned"``: chunks of ``chunk_rounds`` rounds on host-staged
  ``[R, C, H, b, ...]`` batches (``core.multiround.scan_rounds``), which a
  producer thread assembles ``prefetch`` chunks ahead;
* ``plan="device"``: the corpus is packed once on the device
  (``DeviceFederatedDataset``) and each chunk samples S_t and gathers its
  minibatches there (``scan_rounds_ondevice``): nothing crosses from the
  host but the chunk's first round, its stepsizes and its H_k masks.
  Needs a ``DeviceSampleable`` sampler;
* ``plan=ExecutionPlan(plane="streaming", chunk_rounds=..., cache=
  CacheSpec(...))``: the corpus stays on the host as per-client shards, a
  bounded device-side ``ShardCache`` holds the shards of each chunk's
  participants in n_k-tiered slots, and each chunk runs back to back on
  the device (``scan_rounds_ondevice``).  ``CacheSpec(bucketed=True)``
  stages each chunk's cohort on the host grouped by size tier and runs
  sized per-tier work (``scan_rounds_bucketed``), optionally through the
  fused ``kernels/client_step`` kernel via ``client_step_fn``.  Needs a
  ``KeyedReplayable`` sampler;
* ``plan="auto"``: the plane is resolved from the memory budget against
  ``packed_nbytes`` and the chunk working set (``launch/plan.py``
  ``resolve``); the decision is logged into ``session.plan_log``, the
  history and the metrics jsonl, and the resolved run equals requesting
  that plane directly.

On the card each chunk of the scanned and device planes is one CUDA graph
replay (``launch/graph.py`` ``ChunkGraph``, cached on the session per chunk
shape; a ragged last chunk gets its own).  The streaming planes run their
chunks eagerly.

A ``TrainSession`` (created per trainer, shareable via ``session=``) owns
the packed and streaming datasets, the persistent ``ShardCache`` and the
chunk graphs across ``run()`` calls: a second run re-uploads nothing for
already-resident clients and captures nothing again.

Every run takes ``resume=True``: ``checkpoint.latest_round`` +
``restore_state`` pick the trajectory up at the round after the last
durable save (a checkpoint written by either package), and keyed draws make
the resumed run equal to an uninterrupted one.  Heterogeneous local work:
``hetero_steps_fn(t) -> [C] H_k`` runs each client's first H_k of the H
staged local steps.  Time-varying participation (``DeviceDiurnalSampler``)
works through the padded-C convention (``rcfg.clients_per_round`` must
equal ``sampler.lowered_clients``).  The deprecated ``run_scanned`` /
``run_device`` / ``run_streaming`` shims stay equal to the plan API.

Scenarios (``ExecutionPlan(scenario=ScenarioSpec(...))``): the active
``ScenarioRuntime`` turns each round's cohort into completed-step caps,
which enter every plane as the [C, H] prefix step masks the engine already
takes (eq. (3) partial work); records then carry ``"completed"``.  The
per-round and scanned planes stage them with their host-assembled rounds;
the device and streaming planes draw their cohorts inside the chunk, so
their masks are staged against the host replay of those draws
(``core.sampling.replay_span``, one batched draw a chunk; for a large
population on the card, on a side stream), which each chunk's device draw
is then held against.  An adaptive cohort is stateful: every plane stages
its rounds exactly once and in order, and a resume replays rounds [0, t0)
first.

Secure aggregation (``ExecutionPlan(secure=SecureAggSpec(...))``): step 4
of every round on every plane runs through the uint32-ring pairwise
masking of ``core/secure_agg.py``; the masked trajectory is bit-equal to
the open ring's, with scenario dropouts recovered.

``param_axes`` (the logical-axes twin of the parameter tree, from a model's
``init``) reaches the round engine on every plane, where it constrains the
per-client replicas as in the reference (``sharding.shard_tree``); a run
with it equals a run without.

The data mesh (``ExecutionPlan(mesh=MeshSpec(...))``): every rank of a
``torch.distributed`` group runs the same trainer (``launch/mesh.py``
``spawn``), and ``run`` makes the mesh and ``FED_MESH_RULES`` live around
the plane it dispatches, so every round's cohort splits over the ranks
(``core/round.py``), the device plane packs each rank's block of the
corpus, and the streaming plane's cache is a ``MeshShardedCache``.
``mesh=None`` makes nothing live: the single-device code path, bit for
bit.  Checkpoints and the metrics log are written by rank 0 alone; the
ranks meet at a barrier when a run's writes are done, and every rank
reads the checkpoint on resume.  Progress lines print on rank 0.
"""
from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Union

import numpy as np
import torch

from repro_torch.checkpoint import (AsyncCheckpointWriter, append_metrics,
                                    latest_round, prune_metrics,
                                    restore_state)
from repro_torch import random as prng
from repro_torch import spans as trace
from repro_torch.core.multiround import (scan_rounds, scan_rounds_bucketed,
                                         scan_rounds_ondevice)
from repro_torch.core.round import DTYPES, RoundConfig, round_step
from repro_torch.core.sampling import (KeyedReplayable, UniformSampler,
                                       replay_span)
from repro_torch.core.server_opt import ServerOpt, ServerState
from repro_torch.data.device import DeviceFederatedDataset
from repro_torch.data.federated import FederatedDataset, minibatch_indices
from repro_torch.data.stream import ShardCache, StreamingFederatedDataset
from repro_torch.device import resolve_device, to_device
from repro_torch.launch.graph import ChunkGraph, detach_state, pin_inputs
from repro_torch.launch.plan import (CacheSpec, ExecutionPlan, PlanError,
                                     TrainSession, _IdKey, as_plan, resolve)
from repro_torch.scenario.spec import ScenarioRuntime
from repro_torch.sharding import FED_MESH_RULES, axis_rules
from repro_torch.tree import tree_map


# the host replay of a chunk's cohort draws runs on the card from this
# population up: a million-client permutation takes the CPU ~0.65 s and the
# card a few ms; sixty clients' chunk takes the CPU 0.4-0.7 ms a round and
# the card's launches and read-back 1.1-1.2 ms (chip_smoke.py phase 19,
# NVIDIA H100 80GB HBM3, 700.00 W)
_REPLAY_ON_CARD_CLIENTS = 2048


def _cache_counters(cache: Optional[ShardCache]):
    return None if cache is None else (cache.hits, cache.misses,
                                       cache.evictions,
                                       tuple(cache.tier_hits),
                                       tuple(cache.tier_misses),
                                       tuple(cache.tier_evictions))


def _cache_stats(before, cache: Optional[ShardCache]):
    """Per-chunk delta of the cache counters (+ cumulative hit rate).
    Uploads made for chunk i+1 while chunk i is in flight land on chunk
    i's record; the per-run sums are exact.  ``cache_tier_*`` attribute the
    same deltas to the n_k size tiers (index = tier, smallest first).  The
    recorder's ``cache.*`` counters add up the same deltas."""
    if cache is None:
        return None
    out = {"cache_hits": cache.hits - before[0],
           "cache_misses": cache.misses - before[1],
           "cache_evictions": cache.evictions - before[2],
           "cache_hit_rate": round(cache.hit_rate, 6),
           "cache_tier_hits": [a - b for a, b
                               in zip(cache.tier_hits, before[3])],
           "cache_tier_misses": [a - b for a, b
                                 in zip(cache.tier_misses, before[4])],
           "cache_tier_evictions": [a - b for a, b
                                    in zip(cache.tier_evictions,
                                           before[5])]}
    for name in ("hits", "misses", "evictions"):
        trace.count(f"cache.{name}", out[f"cache_{name}"])
    return out


def _eval_spans(t0: int, n_rounds: int, chunk_rounds: int,
                eval_every: Optional[int] = None) -> list:
    """Chunk spans ``[s, e)`` of at most ``chunk_rounds`` rounds.  Chunked
    planes eval at chunk ends, so a cadence finer than the chunk size is
    honoured by ending a span early after every eval round (``(e - 1) %
    eval_every == 0``, the rounds the per-round plane evals).
    ``eval_every=None`` (no eval_fn) keeps the uniform chunking."""
    spans = []
    s = t0
    while s < n_rounds:
        e = min(s + chunk_rounds, n_rounds)
        if eval_every:
            t_ev = -(-s // eval_every) * eval_every
            if t_ev + 1 < e:
                e = t_ev + 1
        spans.append((s, e))
        s = e
    return spans


def _staged_indices(data_key: torch.Tensor, t, cids, n_k,
                    need: int) -> np.ndarray:
    """The host replay of a whole chunk's keyed minibatch draws at once:
    one batched draw over the flattened (t, cid, n_k) lanes, row l
    bit-equal to ``minibatch_indices(key, t[l], cids[l], n_k[l], need)``
    (threefry is counter-based)."""
    as64 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64)
    return minibatch_indices(data_key, as64(t), as64(cids), as64(n_k),
                             need).numpy()


def _warn_shim(old: str, plane: str):
    warnings.warn(
        f"FederatedTrainer.{old}(...) is deprecated: use "
        f"run(n_rounds, plan=ExecutionPlan(plane={plane!r}, ...)); the shim "
        f"trains the same trajectory until it is removed",
        DeprecationWarning, stacklevel=3)


@dataclass
class _Chunk:
    """A dispatched chunk on its way to the history: ``vals`` its [3, R]
    loss / delta_norm / completed, ``clients`` its device-drawn ids
    (where they are checked) and ``stamps`` its device stamps (with the
    recorder's on) on their way to the host, ``ready`` the event that says
    they are there (None on the CPU); ``sealed`` once its eval
    and checkpoint snapshot are taken, ``drawn`` the host replay's client
    ids its device draw must equal (padded streaming, and the device plane
    under a scenario)."""
    s: int
    e: int
    vals: torch.Tensor
    clients: Optional[torch.Tensor] = None
    ready: Any = None
    stamps: Optional[torch.Tensor] = None
    cstats: Optional[dict] = None
    drawn: Optional[list] = None
    ev: Optional[dict] = None
    snap: Any = None
    sealed: bool = False


@dataclass
class FederatedTrainer:
    loss_fn: Callable                  # (params, batch) -> (loss, metrics)
    server_opt: ServerOpt
    rcfg: RoundConfig
    dataset: FederatedDataset
    sampler: UniformSampler
    state: ServerState
    param_axes: Optional[Any] = None         # logical axes of state.w
    lr_schedule: Optional[Callable] = None   # round t -> gamma_t
    hetero_steps_fn: Optional[Callable] = None  # round t -> [C] ints H_k
    client_step_fn: Optional[Callable] = None   # fused gather+local-SGD
                                                # hook (kernels/client_step)
                                                # for the bucketed plane
    ckpt_path: Optional[str] = None
    ckpt_every: int = 0
    metrics_path: Optional[str] = None       # durable per-round jsonl log
    local_batch: int = 10                    # b, the client minibatch size
    session: Optional[TrainSession] = None   # warm resources across run()s
    history: list = field(default_factory=list)
    device: Any = None                       # None = cuda

    def __post_init__(self):
        if int(self.local_batch) < 1:
            raise PlanError(
                f"local_batch must be a positive int, got "
                f"{self.local_batch!r}")
        self.local_batch = int(self.local_batch)
        if self.session is None:
            self.session = TrainSession()
        # the active ScenarioRuntime, scoped to one run() call (set when the
        # resolved plan carries a non-null ScenarioSpec, cleared after)
        self._scenario: Optional[ScenarioRuntime] = None
        # the run's MeshSpec and this rank's Mesh, scoped like _scenario
        self._mesh_spec = None
        self._mesh = None
        self._replay_stream = None
        self.device = resolve_device(self.device)
        self.state = tree_map(
            lambda x: x.to(self.device) if isinstance(x, torch.Tensor)
            else x, self.state)

    # ------------------------------------------------------------------
    # host-side round assembly
    # ------------------------------------------------------------------
    def _check_client_extent(self):
        """The engine runs rcfg.clients_per_round slots; a sampler with a
        different extent would pair weights with the wrong batch rows."""
        ext = getattr(self.sampler, "lowered_clients", None)
        if ext is not None and ext != self.rcfg.clients_per_round:
            raise ValueError(
                f"sampler lowers {ext} client slots but "
                f"rcfg.clients_per_round={self.rcfg.clients_per_round}; for "
                f"time-varying M use clients_per_round = m_max (padded-C, "
                f"zero-weight tail)")

    def _round_knobs(self, t: int):
        """Per-round lr + optional [C, H] step mask (host values only)."""
        lr_t = (self.rcfg.lr if self.lr_schedule is None
                else float(self.lr_schedule(t)))
        mask = None
        if self.hetero_steps_fn is not None:
            h_k = np.asarray(self.hetero_steps_fn(t))
            mask = (np.arange(self.rcfg.local_steps)[None, :]
                    < h_k[:, None]).astype(np.float32)
        return lr_t, mask

    def _scenario_mask(self, t: int, client_ids, mask):
        """Fold the active scenario's completed-step caps for round ``t``'s
        cohort into the (possibly None) H_k mask: both are prefix masks,
        so the elementwise min composes them."""
        if self._scenario is None:
            return mask
        sm = self._scenario.masks_for(t, np.asarray(client_ids))
        return sm if mask is None else np.minimum(mask, sm)

    def _round_inputs(self, t: int):
        """Sample S_t and assemble its [C, H, b, ...] batches + knobs."""
        idx, weights = self.sampler.sample(t)
        batches = self.dataset.round_batches(
            idx, self.rcfg.local_steps, self.local_batch, t=t)
        lr_t, mask = self._round_knobs(t)
        mask = self._scenario_mask(t, idx, mask)
        return batches, np.asarray(weights, np.float32), lr_t, mask

    def _replay(self, t_lo: int, t_hi: int) -> tuple:
        """``replay_span`` of rounds [t_lo, t_hi): ([R, C] ids, [R, C]
        weights).  With a card and a population of at least
        ``_REPLAY_ON_CARD_CLIENTS`` it draws on the card, on a side stream,
        so it does not wait for the chunks in flight; the current stream
        then waits for it (the first draw fills the sampler's per-device
        tables).  A smaller population is drawn on the CPU, where a
        chunk's few hundred small int64 ops cost less than the card's
        launches and read-back."""
        pop = getattr(self.sampler, "population", None)
        if (self.device.type != "cuda" or pop is None
                or pop.n_clients < _REPLAY_ON_CARD_CLIENTS):
            return replay_span(self.sampler, t_lo, t_hi)
        if self._replay_stream is None:
            self._replay_stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._replay_stream):
            out = replay_span(self.sampler, t_lo, t_hi, self.device)
        torch.cuda.current_stream(self.device).wait_stream(
            self._replay_stream)
        return out

    def _chunk_knobs(self, t_lo: int, t_hi: int, cohorts=None):
        """[R] float32 lrs + optional [R, C, H] masks for a chunk of
        rounds.  With an active scenario the cohort ids matter (fates are
        keyed per client): ``cohorts`` [R, C] are the chunk's replayed ids,
        replayed here when not given."""
        if self._scenario is not None and cohorts is None:
            cohorts = self._replay(t_lo, t_hi)[0]
        lrs, masks = [], []
        for r, t in enumerate(range(t_lo, t_hi)):
            lr_t, mask = self._round_knobs(t)
            if self._scenario is not None:
                mask = self._scenario_mask(t, cohorts[r], mask)
            lrs.append(lr_t)
            masks.append(mask)
        return (np.asarray(lrs, np.float32),
                None if masks[0] is None else np.stack(masks))

    def _stage_span(self, staged: dict, t_lo: int, t_hi: int) -> list:
        """The device and padded streaming planes' lookahead for rounds
        [t_lo, t_hi): one replay of the chunk's draws, its lrs and masks
        kept in ``staged`` for the dispatch, and its raw id sequence
        returned (the cache's uploads and the draw check use it).  Called
        once a chunk, in round order, as an adaptive cohort needs."""
        ids = self._replay(t_lo, t_hi)[0]
        staged[t_lo] = self._chunk_knobs(t_lo, t_hi, ids)
        return [int(c) for c in ids.reshape(-1)]

    def _assemble_chunk(self, t_lo: int, t_hi: int) -> dict:
        """Rounds [t_lo, t_hi) stacked into the scanned plane's chunk
        inputs: ``batches`` [R, C, H, b, ...], ``weights`` [R, C], ``lrs``
        [R] and, with ``hetero_steps_fn``, ``masks`` [R, C, H]."""
        rounds = [self._round_inputs(t) for t in range(t_lo, t_hi)]
        first = rounds[0][0]
        out = {"batches": {k: np.stack([r[0][k] for r in rounds])
                           for k in first},
               "weights": np.stack([r[1] for r in rounds]),
               "lrs": np.asarray([r[2] for r in rounds], np.float32)}
        if rounds[0][3] is not None:
            out["masks"] = np.stack([r[3] for r in rounds])
        return out

    def _sig(self):
        return (_IdKey(self.loss_fn), _IdKey(self.server_opt),
                _IdKey(self.param_axes), self._mesh_spec, self.rcfg,
                str(self.device))

    @property
    def _writes(self) -> bool:
        """Whether this process writes the run's files: always without a
        mesh, rank 0 alone under one."""
        return self._mesh is None or self._mesh.rank == 0

    def _capture(self) -> bool:
        """Whether the chunk graphs capture: not under a mesh whose
        collectives run on the host."""
        return self._mesh is None or self._mesh.capturable

    def _resume_round(self, resume: bool) -> int:
        """First round this run should execute: 0 normally; with
        ``resume=True``, restore the latest durable checkpoint and continue
        at the round after it.  A sampler without the ``KeyedReplayable``
        capability is rejected (its RNG stream would restart at its seed).
        An absent or unreadable checkpoint means a fresh start.  The metrics
        jsonl is rewound to the restored round."""
        if not resume:
            return self._scenario_start(0)
        if not self.ckpt_path:
            raise ValueError("resume=True needs ckpt_path")
        if not isinstance(self.sampler, KeyedReplayable):
            raise PlanError(
                "resume=True needs the KeyedReplayable capability — a keyed "
                "Device* sampler (host replay of the (seed, t)-keyed draw): "
                "a stateful sampler's RNG stream restarts at its seed, so "
                "resumed rounds would silently replay round-0 client sets",
                missing="KeyedReplayable")
        t_ck = latest_round(self.ckpt_path)
        if t_ck < 0:
            return self._scenario_start(0)
        self.state, _ = restore_state(self.ckpt_path, self.state)
        if self.metrics_path and self._writes:
            prune_metrics(self.metrics_path, t_ck)
        return self._scenario_start(t_ck + 1)

    def _scenario_start(self, t0: int) -> int:
        """Prime the scenario runtime for a run starting at ``t0``: an
        adaptive cohort replays rounds [0, t0) on the host to rebuild its
        completion-rate EMA (t0 > 0 implies resume, whose gate guarantees
        the KeyedReplayable replay this needs).  Stateless scenarios need
        no history."""
        if self._scenario is not None:
            self._scenario.warmup(t0, self.sampler)
        return t0

    @contextlib.contextmanager
    def _writer(self):
        """Async checkpoint writer scoped to one run call: joined and
        flushed on normal exit; on an in-flight exception the writer is
        retired but its own failures never mask the primary error.  Under
        a mesh only rank 0 gets one, and on normal exit every rank waits
        at a barrier until rank 0's checkpoints and metrics are durable."""
        writer = (AsyncCheckpointWriter()
                  if self.ckpt_path and self._writes else None)
        try:
            yield writer
        except BaseException:
            if writer:
                writer.close(raise_failure=False)
            raise
        else:
            if writer:
                writer.close()
            if self._mesh is not None:
                self._mesh.barrier()

    # ------------------------------------------------------------------
    # the entry point
    # ------------------------------------------------------------------
    def run(self, n_rounds: int,
            plan: Union[None, str, ExecutionPlan] = None, *,
            log_every: Optional[int] = None,
            eval_fn: Optional[Callable] = None, verbose: bool = True,
            resume: bool = False):
        """Train ``n_rounds`` federated rounds under ``plan``.

        ``plan``: ``None`` (the per-round plane), a plane name (``"auto" |
        "per_round" | "scanned" | "device" | "streaming"``) or an
        ``ExecutionPlan``.  A plan's ``local_batch`` / ``ckpt`` overrides
        are scoped to this call.  ``log_every`` overrides
        ``plan.eval.cadence``; ``eval_fn(state) -> dict`` runs at every
        cadence round and the last (the chunked planes split their chunks
        there).  ``resume=True`` continues from the latest durable
        checkpoint.  Every resolution is appended to ``session.plan_log``;
        an auto resolution also to the history and the metrics jsonl as a
        ``{"event": "plan", ...}`` record.  Returns the history (one record
        per round, after any such record).  ``plan.secure`` is scoped the
        same way as ``local_batch`` / ``ckpt``: it lands on ``self.rcfg``
        for this call only (``rcfg`` keys the chunk graphs, so an open and
        a masked run never share a graph).  ``plan.mesh`` is scoped so too:
        this rank's mesh and ``FED_MESH_RULES`` are live for the plane's
        dispatch, and every rank of the group must make the same call.
        The call is the recorder's ``run`` span (``repro_torch/spans.py``).
        """
        with trace.span("run"):
            return self._run(n_rounds, as_plan(plan), log_every, eval_fn,
                             verbose, resume)

    def _run(self, n_rounds: int, plan: ExecutionPlan, log_every, eval_fn,
             verbose: bool, resume: bool):
        saved = (self.local_batch, self.ckpt_path, self.ckpt_every,
                 self.rcfg)
        if plan.local_batch is not None:
            self.local_batch = plan.local_batch
        if plan.ckpt is not None:
            if plan.ckpt.path is not None:
                self.ckpt_path = plan.ckpt.path
            if plan.ckpt.every is not None:
                self.ckpt_every = plan.ckpt.every
        if plan.secure is not None:
            self.rcfg = dataclasses.replace(self.rcfg, secure=plan.secure)
        self._mesh_spec = plan.mesh
        decision = None
        try:
            with trace.span("run.resolve"):
                self._check_client_extent()
                decision = resolve(plan, self, n_rounds)
                if plan.mesh is not None:
                    self._mesh = self.session.mesh_for(plan.mesh,
                                                       self.device)
                    verbose = verbose and self._writes
                self._scenario = (
                    ScenarioRuntime(plan.scenario, self.rcfg.local_steps)
                    if decision.scenario else None)
                self.session.plan_log.append(decision.record())
                if decision.auto:
                    rec = decision.record()
                    self.history.append(rec)
                    if self.metrics_path and self._writes:
                        append_metrics(self.metrics_path, [rec])
                    if verbose:
                        print(f"  plan: auto -> {decision.plane} "
                              f"({decision.reason})")
                cadence = (log_every if log_every is not None
                           else plan.eval.cadence)
            # a plan-carried mesh makes its rules live for the whole plane
            # dispatch: packing, cache uploads and every round see the same
            # mesh.  mesh=None makes nothing live: the single-device code
            # path, bit for bit
            mesh_ctx = (axis_rules(self._mesh, FED_MESH_RULES)
                        if self._mesh is not None
                        else contextlib.nullcontext())
            with mesh_ctx:
                return self._dispatch(decision, plan, n_rounds, cadence,
                                      eval_fn, verbose, resume)
        finally:
            with trace.span("run.finish"):
                if (decision is not None and self.device.type == "cuda"
                        and decision.plane in ("scanned", "device")):
                    # the state must not alias a graph's static tensors
                    # past this run: a later replay overwrites them
                    self.state = detach_state(self.state)
                (self.local_batch, self.ckpt_path, self.ckpt_every,
                 self.rcfg) = saved
                self._scenario = None
                self._mesh_spec = self._mesh = None

    def _dispatch(self, decision, plan: ExecutionPlan, n_rounds: int,
                  cadence: int, eval_fn, verbose: bool, resume: bool):
        """Run the resolved plane."""
        if decision.plane == "per_round":
            return self._run_per_round(n_rounds, cadence, eval_fn, verbose,
                                       resume)
        # chunked planes take the resolved chunk size
        chunk_rounds = decision.chunk_rounds
        eval_every = cadence if eval_fn is not None else None
        if decision.plane == "streaming":
            return self._run_streaming(
                n_rounds, chunk_rounds, plan.cache.clients, plan.cache.bytes,
                plan.cache.tiers, decision.bucketed, bool(plan.prefetch),
                eval_fn, eval_every, verbose, resume)
        if decision.plane == "scanned":
            return self._run_scanned(n_rounds, chunk_rounds,
                                     int(plan.prefetch), eval_fn,
                                     eval_every, verbose, resume)
        return self._run_device(n_rounds, chunk_rounds, eval_fn,
                                eval_every, verbose, resume)

    # ------------------------------------------------------------------
    # plane: per_round — one round per loop iteration
    # ------------------------------------------------------------------
    def _run_per_round(self, n_rounds: int, log_every: int, eval_fn,
                       verbose: bool, resume: bool):
        t0 = self._resume_round(resume)
        t_start = time.time()
        with self._writer() as writer:
            for t in range(t0, n_rounds):
                with trace.span("round.inputs", t):
                    batches, weights, lr_t, mask = self._round_inputs(t)
                buf = trace.stamps(1, self.device)
                with trace.span("round.step", t), trace.frame(buf, 0):
                    self.state, metrics = round_step(
                        self.loss_fn, self.server_opt, self.state, batches,
                        weights, self.rcfg, param_axes=self.param_axes,
                        lr=lr_t, step_mask=mask,
                        device=self.device)
                with trace.span("round.wait", t):
                    loss = float(metrics["loss"])
                    if buf is not None:
                        trace.device_rounds(t, buf.cpu())
                with trace.span("round.log", t):
                    rec = {"round": t, "loss": loss,
                           "delta_norm": float(metrics["delta_norm"])}
                    if self._scenario is not None:
                        rec["completed"] = int(metrics["completed"])
                    if eval_fn is not None and (t % log_every == 0
                                                or t == n_rounds - 1):
                        rec.update(eval_fn(self.state))
                    self.history.append(rec)
                    if self.metrics_path and self._writes:
                        append_metrics(self.metrics_path, [rec])
                    if verbose and (t % log_every == 0
                                    or t == n_rounds - 1):
                        extra = " ".join(f"{k}={v:.4f}"
                                         for k, v in rec.items()
                                         if k not in ("round",))
                        print(f"  round {t:5d}  {extra}  "
                              f"({time.time() - t_start:.1f}s)")
                    if (writer and self.ckpt_every
                            and t % self.ckpt_every == 0 and t > 0):
                        writer.submit(self.ckpt_path, self.state,
                                      {"round": t})
                trace.count("rounds")
        return self.history

    # ------------------------------------------------------------------
    # the chunk graphs (cached on the session, like the reference's jit
    # caches; a graph is fixed in shape, so R and the batch shapes key it)
    # ------------------------------------------------------------------
    def _scan_chunk_graph(self, n_rounds: int, masked: bool,
                          batch_sig: tuple) -> ChunkGraph:
        loss_fn, opt, rcfg, dev = (self.loss_fn, self.server_opt, self.rcfg,
                                   self.device)
        axes = self.param_axes

        def body(state, inp):
            return scan_rounds(loss_fn, opt, state, inp["batches"],
                               inp["weights"], rcfg, param_axes=axes,
                               lrs=inp["lrs"],
                               step_masks=inp.get("masks"), device=dev)

        key = (("scan_chunk", n_rounds, masked, batch_sig,
                trace.device_on()) + self._sig())
        return self.session.chunk_graph(
            key, lambda: ChunkGraph(body, n_rounds, dev, self._capture()))

    def _device_chunk_graph(self, n_rounds: int, masked: bool,
                            dds: DeviceFederatedDataset) -> ChunkGraph:
        """The device plane's chunk graph, cached per (R, masked, b,
        sampler, packed corpus): the graph reads the corpus and the two
        draw keys where they lie, so they key it too."""
        loss_fn, opt, rcfg, dev = (self.loss_fn, self.server_opt, self.rcfg,
                                   self.device)
        sampler, b, axes = self.sampler, self.local_batch, self.param_axes

        def build():
            sample_key, data_key = self._sample_key().to(dev), dds.base_key()

            def body(state, inp):
                return scan_rounds_ondevice(
                    loss_fn, opt, state, dds, sampler, data_key, sample_key,
                    inp["t0"], n_rounds, rcfg, b, param_axes=axes,
                    lrs=inp["lrs"],
                    step_masks=inp.get("masks"), device=dev)

            return ChunkGraph(body, n_rounds, dev, self._capture())

        key = (("ondevice_chunk", n_rounds, masked, b, _IdKey(sampler),
                _IdKey(dds), trace.device_on()) + self._sig())
        return self.session.chunk_graph(key, build)

    # ------------------------------------------------------------------
    # plane: scanned — host-staged chunks, a producer thread ahead
    # ------------------------------------------------------------------
    def _run_scanned(self, n_rounds: int, chunk_rounds: int, prefetch: int,
                     eval_fn, eval_every: Optional[int], verbose: bool,
                     resume: bool):
        """Chunks of host-assembled rounds: a producer thread keeps up to
        ``prefetch`` chunks assembled (and, for the card, pinned) ahead of
        the chunk loop, which copies each into its graph's inputs and
        replays it.  A producer failure surfaces in the loop; the producer
        is stopped and joined whatever happens."""
        t0 = self._resume_round(resume)
        spans = _eval_spans(t0, n_rounds, chunk_rounds, eval_every)
        q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
        failure: list = []
        stop = threading.Event()

        def produce():
            try:
                for s, e in spans:
                    with trace.span("producer.assemble", s):
                        item = pin_inputs(self._assemble_chunk(s, e),
                                          self.device)
                    while not stop.is_set():     # never block past a dead
                        try:                     # consumer
                            q.put(item, timeout=0.2)
                            break
                        except queue.Full:
                            pass
                    if stop.is_set():
                        return
            except BaseException as exc:   # surface in the consumer
                failure.append(exc)
                stop.set()

        def dispatch(s, e, view):
            while True:
                if failure:
                    raise failure[0]
                try:
                    item = q.get(timeout=0.2)
                    break
                except queue.Empty:
                    pass
            batch_sig = tuple((k, tuple(v.shape), str(v.dtype))
                              for k, v in sorted(item["batches"].items()))
            graph = self._scan_chunk_graph(e - s, "masks" in item, batch_sig)
            return graph.run(self.state, s, item)

        producer = threading.Thread(target=produce, daemon=True)
        producer.start()
        try:
            return self._run_fused_chunks(spans, n_rounds, None, None,
                                          dispatch, False, eval_fn, verbose)
        finally:
            stop.set()                   # unblock + retire the producer
            producer.join()

    # ------------------------------------------------------------------
    # plane: device — the corpus packed on the device
    # ------------------------------------------------------------------
    def device_dataset(self, shard_clients: bool = True
                       ) -> DeviceFederatedDataset:
        """The packed corpus on the trainer's device (built once, owned by
        the session; see data/device.py for the K * n_max ceiling).  Keyed
        by the run's mesh spec: under a mesh each rank packs its block of
        the clients."""
        return self.session.device_dataset(self.dataset,
                                           shard_clients=shard_clients,
                                           mesh=self._mesh_spec,
                                           device=self.device)

    def _sample_key(self) -> torch.Tensor:
        return (self.sampler.base_key()
                if isinstance(self.sampler, KeyedReplayable)
                else prng.PRNGKey(self.sampler.seed))

    def _run_device(self, n_rounds: int, chunk_rounds: int, eval_fn,
                    eval_every: Optional[int], verbose: bool, resume: bool):
        """Chunks drawn and gathered on the device.  Under a scenario each
        chunk's masks are staged against the host replay of its draws, one
        chunk ahead, and the chunk's device draw is held against that
        replay when its metrics are read."""
        t0 = self._resume_round(resume)
        dds = self.device_dataset()
        spans = _eval_spans(t0, n_rounds, chunk_rounds, eval_every)
        scenario = self._scenario is not None
        staged: dict = {}

        def prepare(i):
            return self._stage_span(staged, *spans[i])

        def dispatch(s, e, view):
            lrs, masks = (staged.pop(s) if scenario
                          else self._chunk_knobs(s, e))
            values = {"lrs": lrs}
            if masks is not None:
                values["masks"] = masks
            graph = self._device_chunk_graph(e - s, masks is not None, dds)
            return graph.run(self.state, s, values)

        return self._run_fused_chunks(
            spans, n_rounds, None, prepare if scenario else None, dispatch,
            True, eval_fn, verbose, check_draws=scenario)

    # ------------------------------------------------------------------
    # plane: streaming — shard-cached data (corpus larger than the card)
    # ------------------------------------------------------------------
    def streaming_dataset(self) -> StreamingFederatedDataset:
        """The host-resident shard set (built once, owned by the session)."""
        return self.session.streaming_dataset(self.dataset)

    @property
    def stream_cache(self) -> Optional[ShardCache]:
        """The session's persistent ``ShardCache`` (None before the first
        streaming run)."""
        return self.session.shard_cache

    def _run_streaming(self, n_rounds: int, chunk_rounds: int,
                       cache_clients: Optional[int],
                       cache_bytes: Optional[int],
                       cache_tiers: Optional[int], bucketed: bool,
                       prefetch: bool, eval_fn, eval_every: Optional[int],
                       verbose: bool, resume: bool):
        t0 = self._resume_round(resume)
        sds = self.streaming_dataset()
        if cache_clients is None and cache_bytes is None:
            cache_clients = self.rcfg.clients_per_round * chunk_rounds
        cache = self.session.shard_cache_for(sds, cache_clients, cache_bytes,
                                             cache_tiers, device=self.device,
                                             mesh=self._mesh_spec)
        spans = _eval_spans(t0, n_rounds, chunk_rounds, eval_every)
        if bucketed:
            return self._run_streaming_bucketed(spans, n_rounds, sds, cache,
                                                prefetch, eval_fn, verbose)
        data_key = sds.base_key(self.device)
        sample_key = to_device(self.sampler.base_key(), self.device)
        staged: dict = {}

        def prepare(i):
            # the raw per-round sequence: ensure() refreshes LRU recency
            # from it in last-use order, and the chunk's device draw is
            # held against it when its metrics are read
            return self._stage_span(staged, *spans[i])

        def dispatch(s, e, view):
            # the chunk's knobs go to the card once, without blocking (a
            # host float a round would make the host wait for the round
            # before it)
            lrs, masks = (None if x is None else to_device(x, self.device)
                          for x in staged.pop(s))
            return scan_rounds_ondevice(
                self.loss_fn, self.server_opt, self.state, view,
                self.sampler, data_key, sample_key, s, e - s, self.rcfg,
                self.local_batch, param_axes=self.param_axes, lrs=lrs,
                step_masks=masks,
                device=self.device)

        return self._run_fused_chunks(spans, n_rounds, cache, prepare,
                                      dispatch, prefetch, eval_fn, verbose,
                                      check_draws=True)

    # ------------------------------------------------------------------
    # plane: streaming + cache.bucketed — n_k-shaped per-tier compute
    # ------------------------------------------------------------------
    def _bucket_chunk(self, t_lo: int, t_hi: int, tier_of, counts,
                      data_key):
        """Host staging for one bucketed chunk: replay each round's cohort
        (the ``KeyedReplayable`` host sample, the draw the padded plane
        makes on the device), group its C slots by cache size tier, and
        right-pad every round's per-tier cohort to the chunk-wide tier
        width with a same-tier chunk participant at weight 0 (zero weight
        is zero delta and no loss; same tier because the tier's own corpus
        is indexed; a chunk participant because it is resident).  Padding
        rows carry all-ones H_k masks, so their effective weight stays 0.
        Tier widths are the chunk's per-round maximum rounded up to a power
        of two and capped at C, as in the reference, so the staged shapes
        match it.

        Every (t, cid) minibatch draw of the chunk is replayed here in one
        batched host draw (bit-equal to the device draw); padding rows get
        row 0 (any in-range row: their weight is 0).  The cohorts come from
        one ``replay_span`` of the chunk; an active scenario's masks are
        staged here, in round order.

        Returns ``(participants, tiers_present, tier_cids, tier_weights,
        lrs, tier_idx, tier_masks)``: the raw round-order id sequence
        ``ShardCache.ensure`` wants, the occupied tiers, then per occupied
        tier [R, C_i] ids and weights and [R, C_i, H*b] draws, the [R]
        lrs, and [R, C_i, H] masks (None without ``hetero_steps_fn``)."""
        R = t_hi - t_lo
        rounds, lrs, participants = [], [], []
        cohorts, cohort_ws = self._replay(t_lo, t_hi)
        for t, idx, weights in zip(range(t_lo, t_hi), cohorts, cohort_ws):
            participants.extend(int(c) for c in idx)
            lr_t, mask = self._round_knobs(t)
            mask = self._scenario_mask(t, idx, mask)
            lrs.append(lr_t)
            by_tier: dict = {}
            for j, cid in enumerate(idx):
                by_tier.setdefault(int(tier_of[cid]), []).append(j)
            rounds.append((idx, np.asarray(weights, np.float32), mask,
                           by_tier))
        tiers_present = tuple(sorted(
            {tier for (_, _, _, bt) in rounds for tier in bt}))
        C = self.rcfg.clients_per_round
        widths = {tier: min(C, 1 << (max(len(bt.get(tier, ()))
                                         for (_, _, _, bt) in rounds)
                                     - 1).bit_length())
                  for tier in tiers_present}
        pad_cid: dict = {}
        for (idx, _, _, bt) in rounds:
            for tier, js in bt.items():
                pad_cid.setdefault(tier, int(idx[js[0]]))
        H = self.rcfg.local_steps
        need = H * self.local_batch
        cid_flat = np.concatenate([idx for (idx, _, _, _) in rounds])
        t_flat = np.repeat(np.arange(t_lo, t_hi),
                           [len(idx) for (idx, _, _, _) in rounds])
        idx_all = _staged_indices(data_key, t_flat, cid_flat,
                                  np.asarray(counts)[cid_flat], need)
        idx_all = np.split(idx_all, np.cumsum(
            [len(idx) for (idx, _, _, _) in rounds])[:-1])
        tier_cids, tier_ws, tier_ms, tier_ix = [], [], [], []
        for tier in tiers_present:
            C_i = widths[tier]
            cids = np.full((R, C_i), pad_cid[tier], np.int64)
            ws = np.zeros((R, C_i), np.float32)
            ms = np.ones((R, C_i, H), np.float32)
            ix = np.zeros((R, C_i, need), np.int32)
            for r, (idx, weights, mask, bt) in enumerate(rounds):
                js = np.asarray(bt.get(tier, []), np.intp)
                k = len(js)
                if k == 0:
                    continue           # an all-padding round for this tier
                cids[r, :k] = idx[js]
                ws[r, :k] = weights[js]
                if mask is not None:
                    ms[r, :k] = mask[js]
                ix[r, :k] = idx_all[r][js]
            tier_cids.append(cids)
            tier_ws.append(ws)
            tier_ms.append(ms)
            tier_ix.append(ix)
        masked = (self.hetero_steps_fn is not None
                  or self._scenario is not None)
        return (participants, tiers_present, tuple(tier_cids),
                tuple(tier_ws), lrs, tuple(tier_ix),
                tuple(tier_ms) if masked else None)

    def _run_streaming_bucketed(self, spans, n_rounds: int, sds, cache,
                                prefetch: bool, eval_fn, verbose: bool):
        """The streaming chunk loop with n_k-shaped compute: ``prepare(i)``
        stages span i's tier-bucketed cohorts and draws alongside the
        residency lookahead, and each chunk runs ``scan_rounds_bucketed``.
        Same trajectory as the padded plane (bit-equal with one occupied
        tier, fp32-reduction-order tolerance across tiers)."""
        if self.client_step_fn is not None and (
                self.rcfg.local_opt != "sgd"
                or DTYPES[self.rcfg.compute_dtype] != torch.float32):
            raise PlanError(
                f"client_step_fn (the fused kernels/client_step hook) "
                f"covers plain-SGD fp32 local updates; got local_opt="
                f"{self.rcfg.local_opt!r}, compute_dtype="
                f"{self.rcfg.compute_dtype!r}", plane="streaming")
        tier_of = cache.layout.tier_of
        data_key = sds.base_key()          # the host replay's key
        staged: dict = {}

        def prepare(i):
            s, e = spans[i]
            parts, *rest = self._bucket_chunk(s, e, tier_of, sds.counts,
                                              data_key)
            staged[s] = tuple(rest)
            return parts

        def dispatch(s, e, view):
            tiers_present, cids, ws, lrs, ixs, ms = staged.pop(s)
            return scan_rounds_bucketed(
                self.loss_fn, self.server_opt, self.state, view,
                tiers_present, cids, ws, data_key, s, e - s, self.rcfg,
                self.local_batch, param_axes=self.param_axes, lrs=lrs,
                tier_masks=ms, tier_idx=ixs,
                client_step_fn=self.client_step_fn, device=self.device)

        return self._run_fused_chunks(spans, n_rounds, cache, prepare,
                                      dispatch, prefetch, eval_fn, verbose)

    # ------------------------------------------------------------------
    # the chunk loop shared by the chunked planes
    # ------------------------------------------------------------------
    def _run_fused_chunks(self, spans, n_rounds, cache, prepare, dispatch,
                          prefetch, eval_fn, verbose, check_draws=False):
        """Per-chunk staging, one dispatch, shared bookkeeping.

        ``dispatch(s, e, view) -> (state, metrics)`` enqueues the chunk's
        rounds.  The streaming planes pass their ``cache`` and ``prepare``:
        ``prepare(i)`` does the host lookahead for span i and returns its
        raw participant sequence; it runs before span i-1 is dispatched.
        ``cache.ensure`` makes span i's shards resident and ``cache.view()``
        snapshots them as the ``view`` of span i.  The scanned and device
        planes pass ``cache=None`` (their ``view`` is ``None``), and
        ``prepare=None`` unless the device plane stages a scenario's masks
        there.  With ``prefetch``, span i+1's uploads are issued right after
        chunk i is enqueued and, on a card, overlap it: the cache copies
        the rows from pinned memory on its own stream, and only the scatter
        into the cache waits, on the compute stream, behind chunk i's reads
        (``data/stream.py``).  Without it, chunk i is drained first and the
        upload never overlaps compute: the serialized arm.  Both train the
        same trajectory.

        Chunk i's metrics start their copy to the host right behind it
        (pinned, on a card), and are read (the one host wait per chunk)
        after chunk i+1 is enqueued: the wait is for chunk i's event alone,
        so the host stages span i+2 while chunk i+1 runs.  Eval and the
        checkpoint snapshot see chunk i's own state before that.
        ``check_draws``: hold each chunk's device-drawn client ids against
        the host replay that named its uploads (a mismatch would train on
        another client's rows)."""
        def stage(i):
            if not prepare or i >= len(spans):
                return None
            with trace.span("chunk.stage", spans[i][0]):
                return prepare(i)

        def upload(parts, i):
            if cache is None:
                return None
            with trace.span("chunk.upload", spans[i][0]):
                cache.ensure(parts)
                return cache.view()

        def seal(chunk):
            with trace.span("chunk.seal", chunk.s):
                self._seal_chunk(chunk, n_rounds, eval_fn, writer)

        t_start = time.time()
        stats0 = _cache_counters(cache)
        nxt = stage(0)
        view = upload(nxt, 0) if spans else None
        pending: Optional[_Chunk] = None
        with self._writer() as writer:
            try:
                for i, (s, e) in enumerate(spans):
                    drawn, nxt = nxt, stage(i + 1)
                    if pending is not None:
                        seal(pending)
                    with trace.span("chunk.dispatch", s):
                        self.state, metrics = dispatch(s, e, view)
                    with trace.span("chunk.read_back", s):
                        reads = self._read_back(metrics, check_draws)
                    if nxt is not None and prefetch:
                        view = upload(nxt, i + 1)
                    if pending is not None:
                        done, pending = pending, None
                        self._drain_chunk(done, verbose, t_start, writer)
                    pending = _Chunk(s, e, *reads,
                                     cstats=_cache_stats(stats0, cache),
                                     drawn=drawn if check_draws else None)
                    stats0 = _cache_counters(cache)
                    if nxt is not None and not prefetch:
                        seal(pending)
                        done, pending = pending, None
                        self._drain_chunk(done, verbose, t_start, writer)
                        view = upload(nxt, i + 1)
                if pending is not None:
                    seal(pending)
                    done, pending = pending, None
                    self._drain_chunk(done, verbose, t_start, writer)
            except BaseException:
                # retire the completed-but-unretired chunk before
                # propagating: its checkpoint may already be durable, so its
                # metrics are appended too (best effort, never masking the
                # primary error)
                if pending is not None:
                    try:
                        if not pending.sealed:
                            self._seal_chunk(pending, n_rounds, None, writer)
                        self._drain_chunk(pending, verbose, t_start, writer)
                    except BaseException:
                        pass
                raise
        return self.history

    def _seal_chunk(self, chunk: _Chunk, n_rounds: int, eval_fn,
                    writer: Optional[AsyncCheckpointWriter]):
        """What must see the chunk's own state before the next chunk
        updates it: the chunk-boundary eval and a device-side snapshot for
        a due checkpoint (saved when a round t > 0 with t % ckpt_every == 0
        falls inside the chunk, and after the last chunk).  The snapshot is
        submitted in ``_drain_chunk``, after the chunk's metrics are
        appended: the checkpoint never runs ahead of the metrics log."""
        chunk.ev = eval_fn(self.state) if eval_fn is not None else None
        due = self.ckpt_every and any(
            t > 0 and t % self.ckpt_every == 0
            for t in range(chunk.s, chunk.e))
        if writer and (due or chunk.e == n_rounds):
            chunk.snap = tree_map(
                lambda x: x.clone() if isinstance(x, torch.Tensor) else x,
                self.state)
        chunk.sealed = True

    def _read_back(self, metrics: dict, draws: bool) -> tuple:
        """``(vals, clients, ready, stamps)`` of a chunk just enqueued: its
        [3, R] loss / delta_norm / completed, with ``draws`` its drawn
        client ids, and its device stamps where the chunk carries them,
        copied to pinned host memory without blocking right behind the
        chunk on a card, with the event that marks them there; on the CPU
        the tensors themselves and no event."""
        vals = torch.stack([metrics["loss"].float(),
                            metrics["delta_norm"].float(),
                            metrics["completed"].float()])
        clients = metrics["clients"] if draws else None
        stamps = metrics.get("stamps")
        if self.device.type != "cuda":
            return vals, clients, None, stamps
        vals, clients, stamps = (
            None if x is None else torch.empty(
                x.shape, dtype=x.dtype, pin_memory=True).copy_(
                    x, non_blocking=True)
            for x in (vals, clients, stamps))
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.device))
        return vals, clients, ready, stamps

    def _drain_chunk(self, chunk: _Chunk, verbose: bool, t_start: float,
                     writer: Optional[AsyncCheckpointWriter]):
        """The host-blocking half: one wait per chunk, for its own metrics
        (with the ``completed`` counts a scenario records), the device-draw
        check, history + jsonl append, progress line, then the checkpoint
        submit."""
        with trace.span("chunk.wait", chunk.s):
            if chunk.ready is not None:
                chunk.ready.synchronize()
        with trace.span("chunk.drain", chunk.s):
            self._drain_records(chunk, verbose, t_start, writer)

    def _drain_records(self, chunk: _Chunk, verbose: bool, t_start: float,
                       writer: Optional[AsyncCheckpointWriter]):
        if chunk.stamps is not None:
            trace.device_rounds(chunk.s, chunk.stamps.numpy())
        trace.count("rounds", chunk.e - chunk.s)
        vals = chunk.vals.numpy()
        if chunk.drawn is not None:
            got = chunk.clients.numpy().reshape(-1).tolist()
            if got != chunk.drawn:
                raise RuntimeError(
                    f"rounds {chunk.s}..{chunk.e - 1}: the device draw "
                    f"picked clients {got} but the host replay that named "
                    f"the cache uploads picked {chunk.drawn}")
        recs = [{"round": t, "loss": float(vals[0, i]),
                 "delta_norm": float(vals[1, i])}
                for i, t in enumerate(range(chunk.s, chunk.e))]
        if self._scenario is not None:
            for i, rec in enumerate(recs):
                rec["completed"] = int(vals[2, i])
        if chunk.ev is not None:
            recs[-1].update(chunk.ev)
        if chunk.cstats is not None:
            recs[-1].update(chunk.cstats)
        self.history.extend(recs)
        if self.metrics_path and self._writes:
            append_metrics(self.metrics_path, recs)
        if verbose:
            print(f"  rounds {chunk.s:5d}..{chunk.e - 1:5d}  "
                  f"loss={recs[-1]['loss']:.4f} "
                  f"delta_norm={recs[-1]['delta_norm']:.4f}  "
                  f"({time.time() - t_start:.1f}s)")
        if writer and chunk.snap is not None:
            writer.submit(self.ckpt_path, chunk.snap, {"round": chunk.e - 1},
                          copy=False)

    # ------------------------------------------------------------------
    # deprecated shims over run(plan=...), equal to the plan API
    # ------------------------------------------------------------------
    def run_scanned(self, n_rounds: int, chunk_rounds: int = 25,
                    prefetch: int = 2, eval_fn: Optional[Callable] = None,
                    verbose: bool = True, resume: bool = False):
        """Deprecated: ``run(n, plan=ExecutionPlan(plane="scanned", ...))``."""
        _warn_shim("run_scanned", "scanned")
        return self.run(n_rounds,
                        plan=ExecutionPlan(plane="scanned",
                                           chunk_rounds=chunk_rounds,
                                           prefetch=prefetch),
                        eval_fn=eval_fn, verbose=verbose, resume=resume)

    def run_device(self, n_rounds: int, chunk_rounds: int = 25,
                   eval_fn: Optional[Callable] = None, verbose: bool = True,
                   resume: bool = False):
        """Deprecated: ``run(n, plan=ExecutionPlan(plane="device", ...))``."""
        _warn_shim("run_device", "device")
        return self.run(n_rounds,
                        plan=ExecutionPlan(plane="device",
                                           chunk_rounds=chunk_rounds),
                        eval_fn=eval_fn, verbose=verbose, resume=resume)

    def run_streaming(self, n_rounds: int, chunk_rounds: int = 25,
                      cache_clients: Optional[int] = None,
                      cache_bytes: Optional[int] = None,
                      prefetch: bool = True,
                      eval_fn: Optional[Callable] = None,
                      verbose: bool = True, resume: bool = False):
        """Deprecated: ``run(n, plan=ExecutionPlan(plane="streaming",
        cache=CacheSpec(...)))``."""
        _warn_shim("run_streaming", "streaming")
        return self.run(n_rounds,
                        plan=ExecutionPlan(plane="streaming",
                                           chunk_rounds=chunk_rounds,
                                           cache=CacheSpec(
                                               clients=cache_clients,
                                               bytes=cache_bytes),
                                           prefetch=int(bool(prefetch))),
                        eval_fn=eval_fn, verbose=verbose, resume=resume)

    def local_batch_size(self) -> int:
        """Deprecated accessor for the ``local_batch`` field."""
        warnings.warn(
            "local_batch_size() is deprecated: read the local_batch field",
            DeprecationWarning, stacklevel=2)
        return self.local_batch

    def set_local_batch(self, b: int):
        """Deprecated: pass ``local_batch=b`` to the constructor (or set it
        on an ``ExecutionPlan``)."""
        warnings.warn(
            "set_local_batch is deprecated: pass local_batch= to "
            "FederatedTrainer (or ExecutionPlan(local_batch=...))",
            DeprecationWarning, stacklevel=2)
        self.local_batch = int(b)
        return self
