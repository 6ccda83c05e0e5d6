"""Federated training driver: ``FederatedTrainer.run`` on the per-round plane.

Couples the host-side scheduler (client sampling, round-batch assembly,
checkpointing, logging) with the round engine
(``core.round.round_step``), one round per iteration of a Python loop, on
the trainer's ``device`` (``cuda`` unless the caller asks for another).
This is the JAX package's ``plan="per_round"`` plane; the trajectory is the
reference's within fp32 tolerance, because sampling and minibatch draws are
the same keyed threefry draws.

Every run takes ``resume=True``: ``checkpoint.latest_round`` +
``restore_state`` pick the trajectory up at the round after the last
durable save (a checkpoint written by either package), and keyed draws
make the resumed run equal to an uninterrupted one.  Heterogeneous local
work: ``hetero_steps_fn(t) -> [C] H_k`` runs each client's first H_k of the
H staged local steps.  Time-varying participation (``DeviceDiurnalSampler``)
works through the padded-C convention (``rcfg.clients_per_round`` must
equal ``sampler.lowered_clients``).

The chunked planes, ``client_step_fn``, ``param_axes`` and ``session`` belong
to later slices of the port and raise ``PlanError``.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Union

import numpy as np
import torch

from repro_torch.checkpoint import (AsyncCheckpointWriter, append_metrics,
                                    latest_round, prune_metrics,
                                    restore_state)
from repro_torch.core.round import RoundConfig, round_step
from repro_torch.core.sampling import KeyedReplayable, UniformSampler
from repro_torch.core.server_opt import ServerOpt, ServerState
from repro_torch.data.federated import FederatedDataset
from repro_torch.device import resolve_device
from repro_torch.launch.plan import ExecutionPlan, PlanError, as_plan
from repro_torch.tree import tree_map


@dataclass
class FederatedTrainer:
    loss_fn: Callable                  # (params, batch) -> (loss, metrics)
    server_opt: ServerOpt
    rcfg: RoundConfig
    dataset: FederatedDataset
    sampler: UniformSampler
    state: ServerState
    param_axes: Optional[Any] = None         # sharding: a later slice
    lr_schedule: Optional[Callable] = None   # round t -> gamma_t
    hetero_steps_fn: Optional[Callable] = None  # round t -> [C] ints H_k
    client_step_fn: Optional[Callable] = None   # bucketed plane: later slice
    ckpt_path: Optional[str] = None
    ckpt_every: int = 0
    metrics_path: Optional[str] = None       # durable per-round jsonl log
    local_batch: int = 10                    # b, the client minibatch size
    session: Optional[Any] = None            # chunked planes: later slice
    history: list = field(default_factory=list)
    device: Any = None                       # None = cuda

    def __post_init__(self):
        if int(self.local_batch) < 1:
            raise PlanError(
                f"local_batch must be a positive int, got "
                f"{self.local_batch!r}")
        self.local_batch = int(self.local_batch)
        for name, what in (("param_axes", "logical-axis sharding"),
                           ("client_step_fn", "the fused client_step hook "
                            "of the bucketed streaming plane"),
                           ("session", "TrainSession (warm resources of "
                            "the chunked planes)")):
            if getattr(self, name) is not None:
                raise PlanError(
                    f"FederatedTrainer.{name} ({what}) is not yet ported to "
                    f"repro_torch", nearest="per_round")
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

    def _round_inputs(self, t: int):
        """Sample S_t and assemble its [C, H, b, ...] batches + knobs."""
        idx, weights = self.sampler.sample(t)
        batches = self.dataset.round_batches(
            idx, self.rcfg.local_steps, self.local_batch, t=t)
        lr_t, mask = self._round_knobs(t)
        return batches, np.asarray(weights, np.float32), lr_t, mask

    def _resume_round(self, resume: bool) -> int:
        """First round this run should execute: 0 normally; with
        ``resume=True``, restore the latest durable checkpoint and continue
        at the round after it.  A sampler without the ``KeyedReplayable``
        capability is rejected (its RNG stream would restart at its seed).
        An absent or unreadable checkpoint means a fresh start.  The metrics
        jsonl is rewound to the restored round."""
        if not resume:
            return 0
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
            return 0
        self.state, _ = restore_state(self.ckpt_path, self.state)
        if self.metrics_path:
            prune_metrics(self.metrics_path, t_ck)
        return t_ck + 1

    @contextlib.contextmanager
    def _writer(self):
        """Async checkpoint writer scoped to one run call: joined and
        flushed on normal exit; on an in-flight exception the writer is
        retired but its own failures never mask the primary error."""
        writer = AsyncCheckpointWriter() if self.ckpt_path else None
        try:
            yield writer
        except BaseException:
            if writer:
                writer.close(raise_failure=False)
            raise
        else:
            if writer:
                writer.close()

    # ------------------------------------------------------------------
    # the entry point
    # ------------------------------------------------------------------
    def run(self, n_rounds: int,
            plan: Union[None, str, ExecutionPlan] = None, *,
            log_every: Optional[int] = None,
            eval_fn: Optional[Callable] = None, verbose: bool = True,
            resume: bool = False):
        """Train ``n_rounds`` federated rounds on the per-round plane.

        ``plan``: ``None``, ``"per_round"`` or an
        ``ExecutionPlan(plane="per_round")``; any other plane raises
        ``PlanError``.  A plan's ``local_batch`` / ``ckpt`` overrides are
        scoped to this call.  ``log_every`` overrides ``plan.eval.cadence``;
        ``eval_fn(state) -> dict`` runs at every cadence round and the last.
        ``resume=True`` continues from the latest durable checkpoint.
        Returns the history (one record per round).
        """
        plan = as_plan(plan)
        saved = (self.local_batch, self.ckpt_path, self.ckpt_every)
        if plan.local_batch is not None:
            self.local_batch = plan.local_batch
        if plan.ckpt is not None:
            if plan.ckpt.path is not None:
                self.ckpt_path = plan.ckpt.path
            if plan.ckpt.every is not None:
                self.ckpt_every = plan.ckpt.every
        try:
            self._check_client_extent()
            cadence = (log_every if log_every is not None
                       else plan.eval.cadence)
            return self._run_per_round(n_rounds, cadence, eval_fn, verbose,
                                       resume)
        finally:
            self.local_batch, self.ckpt_path, self.ckpt_every = saved

    def _run_per_round(self, n_rounds: int, log_every: int, eval_fn,
                       verbose: bool, resume: bool):
        t0 = self._resume_round(resume)
        t_start = time.time()
        with self._writer() as writer:
            for t in range(t0, n_rounds):
                batches, weights, lr_t, mask = self._round_inputs(t)
                self.state, metrics = round_step(
                    self.loss_fn, self.server_opt, self.state, batches,
                    weights, self.rcfg, lr=lr_t, step_mask=mask,
                    device=self.device)
                rec = {"round": t, "loss": float(metrics["loss"]),
                       "delta_norm": float(metrics["delta_norm"])}
                if eval_fn is not None and (t % log_every == 0
                                            or t == n_rounds - 1):
                    rec.update(eval_fn(self.state))
                self.history.append(rec)
                if self.metrics_path:
                    append_metrics(self.metrics_path, [rec])
                if verbose and (t % log_every == 0 or t == n_rounds - 1):
                    extra = " ".join(f"{k}={v:.4f}" for k, v in rec.items()
                                     if k not in ("round",))
                    print(f"  round {t:5d}  {extra}  "
                          f"({time.time() - t_start:.1f}s)")
                if (writer and self.ckpt_every
                        and t % self.ckpt_every == 0 and t > 0):
                    writer.submit(self.ckpt_path, self.state, {"round": t})
        return self.history
