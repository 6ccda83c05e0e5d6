"""Declarative execution plans for ``FederatedTrainer.run`` (the driver API).

One algorithm, one trajectory, four execution planes, as in the JAX
package:

* ``"per_round"``: one ``round_step`` per round, host Python between
  rounds;
* ``"scanned"``: chunks of ``chunk_rounds`` rounds on host-staged batches
  that a producer thread assembles ahead (``core.multiround.scan_rounds``);
* ``"device"``: the corpus packed once on the device
  (``DeviceFederatedDataset``) and each chunk sampling and gathering there
  (``scan_rounds_ondevice``);
* ``"streaming"``: the corpus stays on the host as per-client shards and a
  bounded device-side ``ShardCache`` (``cache=CacheSpec(...)``) holds the
  shards of upcoming participants in n_k-tiered slots;
  ``CacheSpec(bucketed=True)`` makes the compute n_k-shaped too.

On the card each chunk of the scanned and device planes is one CUDA graph
replay (``launch/graph.py``), the counterpart of the reference's jitted
``lax.scan``.

``plane="auto"`` (the default, as in the reference) resolves to a concrete
plane by the reference's rule: the packed corpus (``packed_nbytes``) fits
the memory budget -> **device**; otherwise one chunk's tiered participant
working set fits -> **streaming**; otherwise, or when the sampler lacks
the capability, -> **scanned**.  ``chunk_rounds="auto"`` sizes chunks from
the measured dispatch overhead.  Every resolution returns a
``PlanDecision`` that the trainer logs into ``TrainSession.plan_log`` (and,
for auto runs, into the history and the metrics jsonl).  Explicit planes
are capability-checked (``check_plane``): the device plane needs a
``DeviceSampleable`` sampler, the streaming plane a ``KeyedReplayable``
one.  ``scenario`` takes a ``repro_torch.scenario.ScenarioSpec`` (dropouts,
stragglers, availability, an adaptive cohort or a recorded trace) and runs
on every plane; on the device plane it needs a ``KeyedReplayable`` sampler,
since its masks are staged against the host replay of the in-chunk draw.
The fields that belong to layers not yet ported (``secure``, ``mesh``)
raise a structured ``PlanError`` with ``nearest`` set; a plan is never
silently run as something else.

A ``TrainSession`` holds what outlives one ``run()`` call: the packed and
the streaming datasets, the persistent ``ShardCache`` (a second run
re-uploads nothing for resident clients), the chunk graphs, the measured
dispatch overhead and the ``plan_log`` of every resolution.

This module imports the rest of the package lazily: ``core.round`` imports
``PlanError`` from here.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Optional, Union

PLANES = ("per_round", "scanned", "device", "streaming")
PORTED_PLANES = PLANES + ("auto",)
_PLANE_ALIASES = {"per-round": "per_round", "python-loop": "per_round"}


class PlanError(ValueError):
    """A plan that cannot run as declared.

    ``plane`` is the requested plane, ``missing`` names an absent sampler
    capability (``"DeviceSampleable"`` / ``"KeyedReplayable"``, or ``None``
    for plain validation errors) and ``nearest`` names the closest plane
    that would run.
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
    """Eval cadence in rounds.  The chunked planes split their chunks at
    eval rounds, so they eval at the same rounds as the per-round plane."""
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
    nearest = "per_round" if plane == "auto" else plane
    return PlanError(
        f"{what} is not yet ported to repro_torch (this port runs the "
        f"planes {PLANES} and 'auto', with scenarios, but without secure "
        f"aggregation or a mesh); nearest viable plane: {nearest!r}",
        plane=plane, nearest=nearest)


# the layers these fields drive (secure aggregation, the device mesh) are
# not ported yet
_UNPORTED_FIELDS = ("secure", "mesh")


@dataclass(frozen=True)
class ExecutionPlan:
    """What to run and under which budget; the engine picks the rest.

    ``plane="auto"`` resolves against ``memory_budget_bytes`` (default: the
    card's total memory, unbounded on the CPU; pass an explicit budget to
    constrain a CPU run).  ``prefetch`` is the depth of the host queue of
    assembled chunks on the scanned plane and a switch on the streaming
    plane (upload chunk i+1 right after chunk i is enqueued, or only after
    chunk i's metrics are read).  ``local_batch`` overrides the trainer's
    ``local_batch`` field when set.  ``chunk_rounds="auto"`` sizes chunks
    from the measured dispatch overhead (``auto_chunk_rounds``); the size
    chosen is audited on the ``PlanDecision``.  ``scenario``: a
    ``repro_torch.scenario.ScenarioSpec`` (``None`` or a null spec runs
    exactly as no scenario).  Defaults and checks are the reference's."""
    plane: str = "auto"
    chunk_rounds: Union[int, str] = 25
    prefetch: int = 2
    cache: CacheSpec = CacheSpec()
    eval: EvalSpec = EvalSpec()
    ckpt: Optional[CkptSpec] = None
    memory_budget_bytes: Optional[int] = None
    local_batch: Optional[int] = None
    scenario: Optional[Any] = None
    secure: Optional[Any] = None
    mesh: Optional[Any] = None

    def __post_init__(self):
        plane = _PLANE_ALIASES.get(self.plane, self.plane)
        object.__setattr__(self, "plane", plane)
        if plane not in PORTED_PLANES:
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
                        ("memory_budget_bytes", self.memory_budget_bytes),
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
        if self.scenario is not None:
            from repro_torch.scenario.spec import ScenarioSpec
            if not isinstance(self.scenario, ScenarioSpec):
                raise PlanError(
                    f"scenario must be a repro_torch.scenario.ScenarioSpec, "
                    f"got {type(self.scenario).__name__}", plane=plane)
        for name in _UNPORTED_FIELDS:
            if getattr(self, name) is not None:
                raise _not_ported(f"ExecutionPlan.{name}", plane)


def as_plan(plan: Union[None, str, ExecutionPlan]) -> ExecutionPlan:
    """Normalize ``run(plan=...)`` input: ``None`` keeps the per-round
    plane, a string names a plane (or ``"auto"``), an ``ExecutionPlan``
    passes through (already validated)."""
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
    jsonl-able form logged to ``TrainSession.plan_log`` and, for auto runs,
    to the history and the metrics log; no ``"round"`` key, so resume's
    ``prune_metrics`` never drops it)."""
    plane: str
    auto: bool
    reason: str
    packed_nbytes: Optional[int] = None
    budget_bytes: Optional[int] = None
    working_set_nbytes: Optional[int] = None
    chunk_rounds: Optional[int] = None        # the size run() uses
    dispatch_overhead_s: Optional[float] = None   # set when measured
    bucketed: bool = False
    scenario: bool = False

    def record(self) -> dict:
        rec = {"event": "plan", "plane": self.plane, "auto": self.auto,
               "reason": self.reason}
        for k in ("packed_nbytes", "budget_bytes", "working_set_nbytes",
                  "chunk_rounds"):
            v = getattr(self, k)
            if v is not None:
                rec[k] = int(v)
        if self.dispatch_overhead_s is not None:
            rec["dispatch_overhead_s"] = round(
                float(self.dispatch_overhead_s), 9)
        if self.bucketed:
            rec["bucketed"] = True
        if self.scenario:
            rec["scenario"] = True
        return rec


def device_memory_budget(device=None) -> Optional[int]:
    """The card's total memory in bytes (``torch.cuda.mem_get_info``) when
    ``device`` is a CUDA device; ``None`` on the CPU, where the auto rule
    treats memory as unbounded unless the plan carries an explicit
    ``memory_budget_bytes``."""
    import torch
    if device is None or torch.device(device).type != "cuda":
        return None
    return int(torch.cuda.mem_get_info(torch.device(device))[1])


# chunk_rounds="auto": amortize the measured per-chunk dispatch overhead
# down to ~25us/round, the reference's constants
_AUTO_CHUNK_TARGET_S = 25e-6
_AUTO_CHUNK_MIN = 8         # never chunk so small that captures multiply
_AUTO_CHUNK_MAX = 256       # bound staging memory + ragged-tail captures


def measure_dispatch_overhead(device=None, n: int = 50) -> float:
    """Seconds of the fixed host cost every chunk pays whatever its size:
    on a card one replay of an already-captured trivial CUDA graph (the
    form a chunk takes there), on the CPU one eager op.  Times ``n``
    dispatches in a row after one untimed, then waits for them."""
    import torch
    dev = torch.device("cpu" if device is None else device)
    x = torch.zeros(8, device=dev)
    if dev.type == "cuda":
        x.add_(1.0)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            x.add_(1.0)
        dispatch = graph.replay
    else:
        def dispatch():
            x.add_(1.0)
    dispatch()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(n):
        dispatch()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) / n


def auto_chunk_rounds(overhead_s: float, n_rounds: int) -> int:
    """Chunk size that amortizes ``overhead_s`` to ``_AUTO_CHUNK_TARGET_S``
    per round, clamped to [_AUTO_CHUNK_MIN, _AUTO_CHUNK_MAX] and to the run
    length (a chunk longer than the run just captures a ragged shape)."""
    want = -(-float(overhead_s) // _AUTO_CHUNK_TARGET_S)   # ceil
    chunk = int(max(_AUTO_CHUNK_MIN, min(_AUTO_CHUNK_MAX, want)))
    return max(1, min(chunk, int(n_rounds)))


def _caps():
    from repro_torch.core.sampling import DeviceSampleable, KeyedReplayable
    return {"per_round": None, "scanned": None,
            "device": ("DeviceSampleable", DeviceSampleable),
            "streaming": ("KeyedReplayable", KeyedReplayable)}


_CAP_DETAIL = {
    "DeviceSampleable": "a traceable sample_device(key, t) drawn inside the "
                        "compiled scan",
    "KeyedReplayable": "a traceable sample_device(key, t) plus base_key(), "
                       "with the host sample(t) a stateless replay of the "
                       "(seed, t)-keyed device draw",
}


def nearest_viable_plane(sampler, dataset) -> str:
    """Most capable plane this sampler/dataset pair can actually run."""
    caps = _caps()
    for plane in ("streaming", "device", "scanned", "per_round"):
        name_cap = caps[plane]
        if name_cap is not None and not isinstance(sampler, name_cap[1]):
            continue
        if _dataset_supports(plane, dataset):
            return plane
    return "per_round"


def _dataset_supports(plane: str, dataset) -> bool:
    """Which planes a dataset can feed.  A ``DeviceFederatedDataset`` pins
    the device plane and a ``StreamingFederatedDataset`` the streaming one;
    a host ``FederatedDataset`` (or a compatible custom dataset: keyed
    ``round_batches`` for the host-assembly planes, per-client ``data``
    shards and the draw-keying ``seed`` for the packable/streamable ones)
    feeds any plane."""
    from repro_torch.data.device import DeviceFederatedDataset
    from repro_torch.data.stream import StreamingFederatedDataset
    if isinstance(dataset, DeviceFederatedDataset):
        return plane == "device"
    if isinstance(dataset, StreamingFederatedDataset):
        return plane == "streaming"
    if plane in ("per_round", "scanned"):
        return hasattr(dataset, "round_batches")
    return hasattr(dataset, "data") and hasattr(dataset, "seed")


def check_plane(plane: str, sampler, dataset) -> None:
    """Raise a structured ``PlanError`` when ``plane`` cannot run with this
    sampler/dataset (missing capability Protocol or unsupported dataset)."""
    name_cap = _caps()[plane]
    if name_cap is not None and not isinstance(sampler, name_cap[1]):
        name, _ = name_cap
        nearest = nearest_viable_plane(sampler, dataset)
        raise PlanError(
            f"plane {plane!r} needs sampler capability {name} "
            f"({_CAP_DETAIL[name]}) but {type(sampler).__name__} does not "
            f"provide it; nearest viable plane: {nearest!r}",
            plane=plane, missing=name, nearest=nearest)
    if not _dataset_supports(plane, dataset):
        nearest = nearest_viable_plane(sampler, dataset)
        raise PlanError(
            f"plane {plane!r} cannot use a {type(dataset).__name__} "
            f"(per_round/scanned need host round_batches; device/streaming "
            f"need packable per-client host data or an already-matching "
            f"dataset); nearest viable plane: {nearest!r}",
            plane=plane, nearest=nearest)


def resolve(plan: ExecutionPlan, trainer, n_rounds: int) -> PlanDecision:
    """Resolve ``plan`` to a concrete plane + chunk size for ``trainer``
    (the reference's rule).  Explicit planes are capability-checked;
    ``"auto"`` compares the packed corpus and the chunk working set with
    the memory budget.  ``chunk_rounds="auto"`` is resolved from the
    measured dispatch overhead (cached on the session: one measurement per
    workload, not per run).  A ``cache.bucketed`` plan must land on the
    streaming plane with ``placement="mesh"``; anything else raises rather
    than training un-bucketed.  Builds at most the host-side streaming
    metadata, never uploads data.  A non-null scenario is recorded on the
    decision, and gated as the reference gates it."""
    if plan.chunk_rounds == "auto":
        overhead = trainer.session.dispatch_overhead(trainer.device)
        chunk = auto_chunk_rounds(overhead, n_rounds)
    else:
        overhead, chunk = None, int(plan.chunk_rounds)
    decision = _resolve_plane(plan, trainer, chunk)
    decision.chunk_rounds = chunk
    if overhead is not None:
        decision.dispatch_overhead_s = overhead
        decision.reason += (
            f"; chunk_rounds auto -> {chunk} (measured "
            f"dispatch overhead {overhead * 1e6:.0f}us/chunk amortized to "
            f"<={_AUTO_CHUNK_TARGET_S * 1e6:.0f}us/round)")
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
    if plan.scenario is not None and not plan.scenario.null:
        # scenario masks are staged on the host per round's cohort, so a
        # plane that draws its cohorts inside the chunk needs the host
        # replay of the keyed draw to know whom round t sampled.  The
        # streaming plane already demands KeyedReplayable; the device plane
        # only DeviceSampleable, so it is gated here.
        from repro_torch.core.sampling import KeyedReplayable
        if decision.plane == "device" \
                and not isinstance(trainer.sampler, KeyedReplayable):
            raise PlanError(
                f"a scenario on the device plane needs the sampler "
                f"capability KeyedReplayable (the host replay of the keyed "
                f"cohort draw is what the scenario masks are staged "
                f"against) but {type(trainer.sampler).__name__} does not "
                f"provide it; nearest viable plane: 'scanned'",
                plane="device", missing="KeyedReplayable",
                nearest="scanned")
        decision.scenario = True
        parts = [type(m).__name__ for m in plan.scenario.models]
        if plan.scenario.availability is not None:
            parts.append(type(plan.scenario.availability).__name__)
        if plan.scenario.cohort is not None:
            parts.append("AdaptiveCohort")
        decision.reason += f"; scenario active ({', '.join(parts)})"
    return decision


def _resolve_plane(plan: ExecutionPlan, trainer,
                   chunk_rounds: int) -> PlanDecision:
    """The plane half of ``resolve``: the reference's ``_resolve_plane``
    on one device (no mesh).  The streaming working set is priced at
    ``chunk_rounds``, the resolved size (the reference multiplies the
    literal ``"auto"`` there)."""
    from repro_torch.core.sampling import DeviceSampleable, KeyedReplayable
    from repro_torch.data.device import DeviceFederatedDataset
    from repro_torch.data.stream import StreamingFederatedDataset
    sampler, dataset = trainer.sampler, trainer.dataset
    if plan.plane != "auto":
        check_plane(plan.plane, sampler, dataset)
        return PlanDecision(plan.plane, False,
                            f"explicit plane {plan.plane!r}")
    if isinstance(dataset, StreamingFederatedDataset):
        check_plane("streaming", sampler, dataset)
        return PlanDecision(
            "streaming", True,
            "dataset is a host-resident StreamingFederatedDataset")
    if isinstance(dataset, DeviceFederatedDataset):
        check_plane("device", sampler, dataset)
        return PlanDecision(
            "device", True, "dataset is already device-resident")
    if not _dataset_supports("device", dataset):
        # a host-assembly-only dataset (keyed round_batches but no
        # per-client shards to pack or stream): the fused planes are out
        # before any budget math
        check_plane("scanned", sampler, dataset)
        return PlanDecision(
            "scanned", True,
            f"dataset {type(dataset).__name__} supports only host assembly "
            f"(no per-client data shards to pack or stream)")
    budget = (plan.memory_budget_bytes if plan.memory_budget_bytes is not None
              else device_memory_budget(trainer.device))
    sds = trainer.session.streaming_dataset(dataset)   # host metadata only
    packed = sds.packed_nbytes
    if isinstance(sampler, DeviceSampleable) and (budget is None
                                                  or packed <= budget):
        return PlanDecision(
            "device", True,
            f"packed corpus ({packed} B) fits the device memory "
            f"budget ({'unbounded' if budget is None else f'{budget} B'})",
            packed_nbytes=packed, budget_bytes=budget)
    # the streaming working set: the tiered cache footprint the declared
    # CacheSpec would allocate, not a uniform slot_nbytes multiple
    layout = sds.tier_layout(plan.cache.tiers)
    if plan.cache.clients is None and plan.cache.bytes is None:
        cap = min(trainer.rcfg.clients_per_round * chunk_rounds,
                  sds.n_clients)
    else:
        # mirror ShardCache exactly (tighter declaration wins); None when
        # the declared byte budget is below one slot per occupied tier
        cap = sds.n_clients
        if plan.cache.clients is not None:
            cap = min(cap, plan.cache.clients)
        if plan.cache.bytes is not None:
            by_bytes = layout.capacity_for_bytes(plan.cache.bytes)
            cap = None if by_bytes is None else min(cap, by_bytes)
    working_set = None if cap is None else layout.bytes_for_capacity(cap)
    if (cap is not None and isinstance(sampler, KeyedReplayable)
            and (budget is None or working_set <= budget)):
        # say what ruled the device plane out: the budget only when there
        # IS one and the corpus exceeds it, the missing capability otherwise
        if not isinstance(sampler, DeviceSampleable):
            blocked = (f"the device plane is out (sampler "
                       f"{type(sampler).__name__} lacks DeviceSampleable)")
        else:
            blocked = (f"packed corpus ({packed} B) exceeds the budget "
                       f"({budget} B)")
        fits = ("the unbounded budget" if budget is None
                else f"the budget ({budget} B)")
        return PlanDecision(
            "streaming", True,
            f"{blocked} but one chunk's participant working set ({cap} "
            f"clients over {layout.n_tiers} size tier(s), {working_set} B "
            f"tiered) fits {fits}",
            packed_nbytes=packed, budget_bytes=budget,
            working_set_nbytes=working_set)
    if not isinstance(sampler, DeviceSampleable):
        why = (f"sampler {type(sampler).__name__} lacks DeviceSampleable "
               f"(no traceable sample_device), so the fused on-device "
               f"planes are out")
    elif not isinstance(sampler, KeyedReplayable):
        why = (f"corpus exceeds the budget and sampler "
               f"{type(sampler).__name__} lacks KeyedReplayable (host "
               f"sample does not replay the keyed draw), so streaming is "
               f"out")
    elif cap is None:
        why = (f"the declared cache budget ({plan.cache.bytes} B) is below "
               f"the minimum viable tiered cache ({layout.min_viable_bytes} "
               f"B: one slot in each of {layout.n_tiers} occupied size "
               f"tier(s)), so streaming is out")
    else:
        why = (f"even one chunk's participant working set ({working_set} B "
               f"tiered) exceeds the budget ({budget} B)")
    check_plane("scanned", sampler, dataset)   # structured error, never a
    return PlanDecision(                       # raw crash downstream
        "scanned", True, f"host prefetch-queue fallback: {why}",
        packed_nbytes=packed, budget_bytes=budget,
        working_set_nbytes=working_set)


class _IdKey:
    """Identity-keyed cache-key component.  Holds a strong reference, so
    the wrapped object's ``id`` can never be recycled while a cache entry
    keyed on it is alive (the hazard of keying on bare ``id(obj)``)."""
    __slots__ = ("obj",)

    def __init__(self, obj):
        self.obj = obj

    def __hash__(self):
        return id(self.obj)

    def __eq__(self, other):
        return isinstance(other, _IdKey) and other.obj is self.obj

    def __repr__(self):
        return f"_IdKey({type(self.obj).__name__}@{id(self.obj):#x})"


@dataclass
class TrainSession:
    """Warm execution resources that outlive a single ``run()`` call.

    Owns the packed and the host streaming datasets (built once), the
    persistent ``ShardCache`` (resident shards survive across ``run()``
    calls, so a second run, an eval loop or a resumed run re-uploads
    nothing for already-cached clients), the chunk graphs (keyed by config
    identity, so a fresh trainer sharing the session, e.g. rebuilt for a
    resume, replays the graphs already captured) and the measured dispatch
    overhead.  ``plan_log`` is the in-memory audit trail of every plan
    resolution."""
    device_ds: Any = None
    stream_ds: Any = None
    shard_cache: Any = None
    graphs: dict = field(default_factory=dict)
    plan_log: list = field(default_factory=list)
    _device_key: Any = None
    _stream_src: Any = None
    _cache_key: Any = None
    _dispatch_overhead_s: Optional[float] = None

    def dispatch_overhead(self, device=None) -> float:
        """The measured per-chunk dispatch overhead (seconds), measured
        once per session and reused by every ``chunk_rounds="auto"``
        resolution: it is a property of the host and the runtime, not of
        any one plan."""
        if self._dispatch_overhead_s is None:
            self._dispatch_overhead_s = measure_dispatch_overhead(device)
        return self._dispatch_overhead_s

    def chunk_graph(self, key, build):
        """The chunk graph cached under ``key`` (``build()`` makes it on a
        miss): the counterpart of the reference's ``jit_fn``."""
        graph = self.graphs.get(key)
        if graph is None:
            graph = self.graphs[key] = build()
        return graph

    def device_dataset(self, dataset, shard_clients: bool = True,
                       mesh=None, device=None):
        """The packed corpus of ``dataset`` on ``device``, built once per
        (dataset, device); a ``DeviceFederatedDataset`` is taken as it
        is.  A mesh is refused: the mesh layer is not ported yet."""
        from repro_torch.data.device import DeviceFederatedDataset
        if mesh is not None:
            raise _not_ported("a mesh-sharded device corpus", "device")
        key = (dataset, str(device))
        if self.device_ds is None or not _same_key(self._device_key, key):
            if isinstance(dataset, DeviceFederatedDataset):
                self.device_ds = dataset
            else:
                self.device_ds = DeviceFederatedDataset.from_federated(
                    dataset, shard_clients=shard_clients, device=device)
            self._device_key = key
        return self.device_ds

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
