"""Typed serving errors (counterpart: paddle_tpu/inference/errors.py).

* `ServingError` — base class of every serving-stack failure;
* `PoolExhausted` — the KV pool has neither a free nor an evictable
  page: backpressure at admission, containable inside a step;
* `StepFault` — a step (decode / mixed / verify / drafter) raised;
  ``fatal`` once the whole containment ladder is spent;
* `InjectedFault` — a `FaultPlan` fired (FLAGS_fault_inject), a
  `StepFault` so every recovery path treats it as an organic fault;
* `HungStep` — the watchdog classified a step as hung (always fatal);
* `DegradedMode` — a degradation budget ran out (engine recoveries).

All subclass ``RuntimeError``, as in paddle_tpu.  `FaultInfo` is the
structured terminal record a faulted or recovered request carries
(`Request.fault_info`), with the JAX package's fields.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

__all__ = ["ServingError", "PoolExhausted", "StepFault", "InjectedFault",
           "HungStep", "DegradedMode", "FaultInfo"]


class ServingError(RuntimeError):
    """Base class of every typed serving-stack failure."""


class PoolExhausted(ServingError):
    """The KV page pool has neither a free nor an evictable page.

    Admission treats this as backpressure (the request stays queued);
    inside a step it is containable: quarantining or preempting a
    request frees its pages."""


class StepFault(ServingError):
    """A step failed.  ``site`` names the failing step or hook
    (`inference.resilience.FAULT_SITES`); ``attempts`` counts the
    containment attempts spent; ``fatal`` marks a fault that survived
    the whole ladder, which only `inference.resilience.recover` (or a
    fresh process, `inference.durability.restore_from_dir`) gets past."""

    def __init__(self, message: str, site: str = "step",
                 attempts: int = 0, fatal: bool = False):
        super().__init__(message)
        self.site = site
        self.attempts = int(attempts)
        self.fatal = bool(fatal)


class InjectedFault(StepFault):
    """A `FaultPlan` fired at a named site (FLAGS_fault_inject)."""


class HungStep(StepFault):
    """The hung-step watchdog (`inference.durability.StepWatchdog`,
    FLAGS_step_timeout_ms) found a step over its wall-clock budget with
    no graph capture or compile to excuse it.  Always ``fatal``."""

    def __init__(self, message: str, site: str = "hung",
                 attempts: int = 0):
        super().__init__(message, site=site, attempts=attempts,
                         fatal=True)


class DegradedMode(ServingError):
    """An operation required a subsystem the engine has degraded away,
    or a degradation budget (FLAGS_engine_recoveries) ran out."""


@dataclass
class FaultInfo:
    """Structured terminal state of a faulted or fault-recovered
    request: ``site`` where the fault hit, ``attempts`` spent on its
    behalf, the engine ``step`` of the verdict, ``recovered`` (True when
    the request survived, False when it was quarantined with
    ``finish_reason == "fault"``), ``message``, and the ``history`` of
    earlier sites."""

    site: str
    attempts: int = 0
    step: int = 0
    recovered: bool = False
    message: str = ""
    history: List[str] = field(default_factory=list)

    def as_dict(self) -> dict:
        return {"site": self.site, "attempts": self.attempts,
                "step": self.step, "recovered": self.recovered,
                "message": self.message, "history": list(self.history)}
