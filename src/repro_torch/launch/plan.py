"""Declarative execution plans for ``FederatedTrainer.run`` (the driver API).

The JAX package runs one algorithm on four execution planes
(``"per_round" | "scanned" | "device" | "streaming"``) plus ``"auto"``.
This port runs the **per-round** plane: one ``round_step`` per round, host
Python between rounds.  The other planes, and the plan fields that only
they or other unported layers read (``cache``, ``scenario``, ``secure``,
``mesh``), raise a structured ``PlanError`` naming what is not yet ported,
with ``nearest="per_round"`` — a plan is never silently run as something
else.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Union

PLANES = ("per_round", "scanned", "device", "streaming")
PORTED_PLANES = ("per_round",)
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
class EvalSpec:
    """Eval cadence in rounds (the per-round plane honors it exactly)."""
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
    return PlanError(
        f"{what} is not yet ported to repro_torch (this slice runs the "
        f"per-round plane); nearest viable plane: 'per_round'",
        plane=plane, nearest="per_round")


# read only by the chunked planes, the auto rule and layers not yet ported
_UNPORTED_FIELDS = ("chunk_rounds", "prefetch", "cache",
                    "memory_budget_bytes", "scenario", "secure", "mesh")


@dataclass(frozen=True)
class ExecutionPlan:
    """What to run.  ``local_batch`` overrides the trainer's
    ``local_batch`` field when set; ``eval`` and ``ckpt`` set the cadences
    of the per-round loop.  The reference's other fields are accepted by
    name and raise ``PlanError`` when set."""
    plane: str = "per_round"
    chunk_rounds: Optional[Any] = None
    prefetch: Optional[Any] = None
    cache: Optional[Any] = None
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
        if plane not in PORTED_PLANES:
            raise _not_ported(f"plane {plane!r}", plane)
        for name in _UNPORTED_FIELDS:
            if getattr(self, name) is not None:
                raise _not_ported(f"ExecutionPlan.{name}", plane)
        if self.local_batch is not None and (
                not isinstance(self.local_batch, int)
                or self.local_batch < 1):
            raise PlanError(f"local_batch must be a positive int, got "
                            f"{self.local_batch!r}", plane=plane)
        if not isinstance(self.eval.cadence, int) or self.eval.cadence < 1:
            raise PlanError(
                f"eval.cadence must be an int >= 1, got "
                f"{self.eval.cadence!r}", plane=plane)
        if (self.ckpt is not None and self.ckpt.every is not None
                and self.ckpt.every < 0):
            raise PlanError(
                f"ckpt.every must be >= 0, got {self.ckpt.every}",
                plane=plane)


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
