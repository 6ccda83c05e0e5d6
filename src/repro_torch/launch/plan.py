"""Declarative execution plans for ``FederatedTrainer.run`` (the driver API).

The JAX package runs one algorithm on four execution planes
(``"per_round" | "scanned" | "device" | "streaming"``) plus ``"auto"``.
This port runs two of them:

* ``"per_round"``: one ``round_step`` per round, host Python between
  rounds;
* ``"streaming"``: the corpus stays on the host as per-client shards and a
  bounded device-side ``ShardCache`` (``cache=CacheSpec(...)``) holds the
  shards of upcoming participants in n_k-tiered slots; chunks of
  ``chunk_rounds`` rounds run back to back, and ``CacheSpec(bucketed=True)``
  makes the compute n_k-shaped too (one sized launch per occupied tier).

Explicit planes are capability-checked (``check_plane``: the streaming
plane needs a ``KeyedReplayable`` sampler).  The planes and fields that
belong to layers not yet ported (``"auto"``, ``"scanned"``, ``"device"``,
``chunk_rounds="auto"``, ``memory_budget_bytes``, ``scenario``, ``secure``,
``mesh``) raise a structured ``PlanError`` with ``nearest`` set — a plan is
never silently run as something else.

A ``TrainSession`` holds what outlives one ``run()`` call: the host
streaming dataset, the persistent ``ShardCache`` (a second run re-uploads
nothing for resident clients) and the ``plan_log`` of every resolution.

This module imports the rest of the package lazily: ``core.round`` imports
``PlanError`` from here.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Union

PLANES = ("per_round", "scanned", "device", "streaming")
PORTED_PLANES = ("per_round", "streaming")
_PLANE_ALIASES = {"per-round": "per_round", "python-loop": "per_round"}


class PlanError(ValueError):
    """A plan that cannot run as declared.

    ``plane`` is the requested plane, ``missing`` names an absent sampler
    capability (``"KeyedReplayable"``, or ``None`` for plain validation
    errors) and ``nearest`` names the closest plane that would run.
    """

    def __init__(self, message: str, plane: Optional[str] = None,
                 missing: Optional[str] = None,
                 nearest: Optional[str] = None):
        super().__init__(message)
        self.plane = plane
        self.missing = missing
        self.nearest = nearest


@dataclass(frozen=True)
class CacheSpec:
    """Shard-cache budget for the streaming plane: capacity in ``clients``
    (a per-chunk distinct-client guarantee) and/or ``bytes`` (tighter
    wins); both ``None`` means one chunk's worst-case working set,
    ``clients_per_round * chunk_rounds``.

    ``tiers``: ``None`` buckets clients into every natural power-of-two
    size tier, ``1`` is the uniform n_max-slot layout, ``m`` merges the
    smallest buckets upward into at most m tiers.  Tiering changes the
    cache footprint, never the trajectory.

    ``bucketed`` makes the compute n_k-shaped: each chunk's cohort is staged
    on the host grouped by size tier and each occupied tier runs sized
    launches (``core.multiround.scan_rounds_bucketed``).  Streaming plane
    and ``placement="mesh"`` only; trajectory-equal to the padded plane
    within fp32 reduction order (bit-equal with one occupied tier)."""
    clients: Optional[int] = None
    bytes: Optional[int] = None
    tiers: Optional[int] = None
    bucketed: bool = False


@dataclass(frozen=True)
class EvalSpec:
    """Eval cadence in rounds.  The streaming plane splits its chunks at
    eval rounds, so it evals at the same rounds as the per-round plane."""
    cadence: int = 50


@dataclass(frozen=True)
class CkptSpec:
    """Checkpoint sink: save every ``every`` rounds to ``path`` (async,
    tmp+rename atomic).  Unset fields keep the trainer's configured values
    (``path=None`` keeps ``ckpt_path``, ``every=None`` keeps
    ``ckpt_every``); an explicit ``every=0`` disables periodic saves."""
    every: Optional[int] = None
    path: Optional[str] = None


def _not_ported(what: str, plane: str) -> PlanError:
    nearest = plane if plane in PORTED_PLANES else "per_round"
    return PlanError(
        f"{what} is not yet ported to repro_torch (this port runs the "
        f"planes {PORTED_PLANES} with an int chunk_rounds); nearest viable "
        f"plane: {nearest!r}", plane=plane, nearest=nearest)


# read only by the auto rule and layers not yet ported
_UNPORTED_FIELDS = ("memory_budget_bytes", "scenario", "secure", "mesh")


@dataclass(frozen=True)
class ExecutionPlan:
    """What to run.  ``chunk_rounds``, ``prefetch`` and ``cache`` take the
    reference's defaults and checks; ``prefetch`` is truthiness on the
    streaming plane (upload chunk i+1 right after chunk i is enqueued, or
    only after chunk i's metrics are read).  ``local_batch`` overrides the
    trainer's ``local_batch`` field when set.  Unlike the reference, whose
    default plane is ``"auto"``, the port defaults to ``"per_round"``: the
    auto rule is not ported."""
    plane: str = "per_round"
    chunk_rounds: Union[int, str] = 25
    prefetch: int = 2
    cache: CacheSpec = CacheSpec()
    eval: EvalSpec = EvalSpec()
    ckpt: Optional[CkptSpec] = None
    memory_budget_bytes: Optional[Any] = None
    local_batch: Optional[int] = None
    scenario: Optional[Any] = None
    secure: Optional[Any] = None
    mesh: Optional[Any] = None

    def __post_init__(self):
        plane = _PLANE_ALIASES.get(self.plane, self.plane)
        object.__setattr__(self, "plane", plane)
        if plane not in PLANES + ("auto",):
            raise PlanError(
                f"unknown plane {self.plane!r}: want 'auto' or one of "
                f"{PLANES}", plane=self.plane)
        if self.chunk_rounds != "auto" and (
                not isinstance(self.chunk_rounds, int)
                or self.chunk_rounds < 1):
            raise PlanError(
                f"chunk_rounds must be an int >= 1 or the literal 'auto', "
                f"got {self.chunk_rounds!r}", plane=plane)
        if not isinstance(self.prefetch, int) or self.prefetch < 0:
            raise PlanError(
                f"prefetch must be an int >= 0, got {self.prefetch!r}",
                plane=plane)
        if not isinstance(self.cache, CacheSpec):
            raise PlanError(
                f"cache must be a CacheSpec, got "
                f"{type(self.cache).__name__}", plane=plane)
        for name, v in (("cache.clients", self.cache.clients),
                        ("cache.bytes", self.cache.bytes),
                        ("cache.tiers", self.cache.tiers),
                        ("local_batch", self.local_batch)):
            if v is not None and (not isinstance(v, int) or v < 1):
                raise PlanError(f"{name} must be a positive int, got {v!r}",
                                plane=plane)
        if not isinstance(self.cache.bucketed, bool):
            raise PlanError(
                f"cache.bucketed must be a bool, got "
                f"{self.cache.bucketed!r}", plane=plane)
        if self.cache.bucketed and plane not in ("auto", "streaming"):
            raise PlanError(
                f"cache.bucketed is a streaming-plane knob (tier-bucketed "
                f"dispatch over the shard cache) but the plan pins plane="
                f"{plane!r}", plane=plane, nearest="streaming")
        if not isinstance(self.eval.cadence, int) or self.eval.cadence < 1:
            raise PlanError(
                f"eval.cadence must be an int >= 1, got "
                f"{self.eval.cadence!r}", plane=plane)
        if (self.ckpt is not None and self.ckpt.every is not None
                and self.ckpt.every < 0):
            raise PlanError(
                f"ckpt.every must be >= 0, got {self.ckpt.every}",
                plane=plane)
        if plane not in PORTED_PLANES:
            raise _not_ported(f"plane {plane!r}", plane)
        if self.chunk_rounds == "auto":
            raise _not_ported("chunk_rounds='auto' (sizing chunks from the "
                              "measured dispatch overhead)", plane)
        for name in _UNPORTED_FIELDS:
            if getattr(self, name) is not None:
                raise _not_ported(f"ExecutionPlan.{name}", plane)


def as_plan(plan: Union[None, str, ExecutionPlan]) -> ExecutionPlan:
    """Normalize ``run(plan=...)`` input: ``None`` is the per-round plane,
    a string names a plane, an ``ExecutionPlan`` passes through (already
    validated)."""
    if plan is None:
        return ExecutionPlan(plane="per_round")
    if isinstance(plan, str):
        return ExecutionPlan(plane=plan)
    if isinstance(plan, ExecutionPlan):
        return plan
    if isinstance(plan, int):
        raise PlanError(
            f"plan must be None, a plane name or an ExecutionPlan, got "
            f"{plan!r} — if you meant the eval/log cadence, pass "
            f"log_every={plan!r} by keyword (or EvalSpec(cadence={plan!r}))")
    raise PlanError(
        f"plan must be None, a plane name or an ExecutionPlan, "
        f"got {type(plan).__name__}")


@dataclass
class PlanDecision:
    """The audited outcome of resolving a plan (``record()`` is the
    jsonl-able form logged to ``TrainSession.plan_log``; no ``"round"``
    key, so resume's ``prune_metrics`` never drops it)."""
    plane: str
    auto: bool
    reason: str
    chunk_rounds: Optional[int] = None        # the size run() uses
    bucketed: bool = False

    def record(self) -> dict:
        rec = {"event": "plan", "plane": self.plane, "auto": self.auto,
               "reason": self.reason}
        if self.chunk_rounds is not None:
            rec["chunk_rounds"] = int(self.chunk_rounds)
        if self.bucketed:
            rec["bucketed"] = True
        return rec


_CAP_DETAIL = ("a keyed sample_device(key, t) plus base_key(), with the host "
               "sample(t) a stateless replay of the (seed, t)-keyed draw")


def _dataset_supports(plane: str, dataset) -> bool:
    """Which planes a dataset can feed: a ``StreamingFederatedDataset`` pins
    the streaming plane; a host ``FederatedDataset`` (or a compatible
    custom dataset: keyed ``round_batches`` for the per-round plane,
    per-client ``data`` shards and the draw-keying ``seed`` for the
    streaming one) feeds either."""
    from repro_torch.data.stream import StreamingFederatedDataset
    if isinstance(dataset, StreamingFederatedDataset):
        return plane == "streaming"
    if plane == "per_round":
        return hasattr(dataset, "round_batches")
    return hasattr(dataset, "data") and hasattr(dataset, "seed")


def nearest_viable_plane(sampler, dataset) -> str:
    """Most capable ported plane this sampler/dataset pair can run."""
    from repro_torch.core.sampling import KeyedReplayable
    if isinstance(sampler, KeyedReplayable) \
            and _dataset_supports("streaming", dataset):
        return "streaming"
    return "per_round"


def check_plane(plane: str, sampler, dataset) -> None:
    """Raise a structured ``PlanError`` when ``plane`` cannot run with this
    sampler/dataset (missing capability or unsupported dataset)."""
    from repro_torch.core.sampling import KeyedReplayable
    if plane == "streaming" and not isinstance(sampler, KeyedReplayable):
        nearest = nearest_viable_plane(sampler, dataset)
        raise PlanError(
            f"plane 'streaming' needs sampler capability KeyedReplayable "
            f"({_CAP_DETAIL}) but {type(sampler).__name__} does not provide "
            f"it; nearest viable plane: {nearest!r}",
            plane=plane, missing="KeyedReplayable", nearest=nearest)
    if not _dataset_supports(plane, dataset):
        nearest = nearest_viable_plane(sampler, dataset)
        raise PlanError(
            f"plane {plane!r} cannot use a {type(dataset).__name__} "
            f"(per_round needs host round_batches; streaming needs "
            f"per-client host data or a StreamingFederatedDataset); nearest "
            f"viable plane: {nearest!r}", plane=plane, nearest=nearest)


def resolve(plan: ExecutionPlan, trainer, n_rounds: int) -> PlanDecision:
    """Resolve an explicit-plane ``plan`` for ``trainer``: capability-check
    the plane, take the plan's chunk size, and refuse a ``cache.bucketed``
    plan that could not run bucketed (wrong plane or ``placement``) rather
    than train it un-bucketed.  Builds nothing and uploads nothing."""
    check_plane(plan.plane, trainer.sampler, trainer.dataset)
    decision = PlanDecision(plan.plane, False,
                            f"explicit plane {plan.plane!r}",
                            chunk_rounds=int(plan.chunk_rounds))
    if plan.cache.bucketed:
        if decision.plane != "streaming":
            raise PlanError(
                f"cache.bucketed needs the streaming plane (the tier "
                f"bucketing is the shard cache's n_k layout) but the plan "
                f"resolved to {decision.plane!r} ({decision.reason})",
                plane=decision.plane, nearest="streaming")
        if trainer.rcfg.placement != "mesh":
            raise PlanError(
                f"cache.bucketed dispatches per-tier vmaps — "
                f"placement='mesh' only, got rcfg.placement="
                f"{trainer.rcfg.placement!r}", plane="streaming")
        decision.bucketed = True
        decision.reason += "; tier-bucketed dispatch"
    return decision


@dataclass
class TrainSession:
    """Warm execution resources that outlive a single ``run()`` call.

    Owns the host streaming dataset (built once) and the persistent
    ``ShardCache``: resident shards survive across ``run()`` calls, so a
    second run, an eval loop or a resumed run re-uploads nothing for
    already-cached clients.  ``plan_log`` is the in-memory audit trail of
    every plan resolution.  Pass one session to several trainers to share
    them."""
    stream_ds: Any = None
    shard_cache: Any = None
    plan_log: list = field(default_factory=list)
    _stream_src: Any = None
    _cache_key: Any = None

    def streaming_dataset(self, dataset):
        from repro_torch.data.stream import StreamingFederatedDataset
        if self.stream_ds is None or self._stream_src is not dataset:
            if isinstance(dataset, StreamingFederatedDataset):
                self.stream_ds = dataset
            else:
                self.stream_ds = StreamingFederatedDataset.from_federated(
                    dataset)
            self._stream_src = dataset
        return self.stream_ds

    def shard_cache_for(self, sds, capacity_clients: Optional[int],
                        capacity_bytes: Optional[int],
                        tiers: Optional[int] = None, device=None):
        """The persistent cache, rebuilt only when the dataset, the
        declared capacity/tiering or the device changes (same declaration
        => warm reuse).  The dataset is keyed by identity with a strong
        reference held in the key, so a rebuilt dataset can never inherit
        another corpus's resident shards through a recycled ``id``."""
        from repro_torch.data.stream import ShardCache
        key = (sds, capacity_clients, capacity_bytes, tiers, str(device))
        if self.shard_cache is None or not _same_key(self._cache_key, key):
            self.shard_cache = ShardCache(
                sds, capacity_clients=capacity_clients,
                capacity_bytes=capacity_bytes, tiers=tiers, device=device)
            self._cache_key = key
        return self.shard_cache


def _same_key(a, b) -> bool:
    return (a is not None and a[0] is b[0]
            and tuple(a[1:]) == tuple(b[1:]))
