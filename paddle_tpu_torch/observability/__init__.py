"""Serving observability, the part the port's serving stack records
(counterpart: paddle_tpu/observability, copied and cut, not imported).

The metric objects keep the JAX package's Python and Prometheus names, so
``docs/OBSERVABILITY.md``'s catalog applies to them: the queue gauges
sampled after each admission pass, the TTFT and TPOT histograms the SLO
scheduler reads, and the reliability series (health, degraded modes,
injected faults, retries, recoveries and their seconds).  The flight
recorder, cost model, profiling plane, alert engine, ops server and the
other catalog entries wait for their own slice: where the JAX engine
calls one of them, the port has no hook.
"""
from __future__ import annotations

from .metrics import (DEFAULT_TIME_BUCKETS, LOCK, Counter, Gauge,  # noqa
                      Histogram, MetricRegistry, default_registry, disable,
                      enable, enabled, log_buckets)
from .tracing import clear_spans, now_ns, record_span, spans  # noqa: F401

registry = default_registry()


def snapshot() -> dict:
    return registry.snapshot()


def reset():
    """Zero every series (spans are cleared by `clear_spans`)."""
    registry.reset()


REQUEST_TTFT = registry.histogram(
    "paddle_request_ttft_seconds",
    "Time to first token: request enqueue -> first sampled token "
    "(includes queue wait + prefill)")
REQUEST_TPOT = registry.histogram(
    "paddle_request_tpot_seconds",
    "Time per output token after the first: (finish - first token) / "
    "(tokens - 1); requests emitting one token record nothing")
QUEUE_DEPTH = registry.gauge(
    "paddle_queue_depth",
    "Requests waiting in the admission queue after the engine's most "
    "recent between-steps admission pass",
    labels=("engine",))
QUEUE_OLDEST_AGE = registry.gauge(
    "paddle_queue_oldest_age_seconds",
    "Age of the oldest still-queued request (now - enqueue) as of the "
    "engine's most recent step; 0 when the queue is empty",
    labels=("engine",))
FAULTS_INJECTED = registry.counter(
    "paddle_faults_injected_total",
    "Faults the FLAGS_fault_inject harness fired, by site",
    labels=("site",))
STEP_RETRIES = registry.counter(
    "paddle_step_retries_total",
    "Same-step retries of a failed step before containment escalates")
RECOVERIES = registry.counter(
    "paddle_recoveries_total",
    "Engine rebuilds after a fatal step fault "
    "(inference.resilience.recover)")
DEGRADED_MODE = registry.gauge(
    "paddle_degraded_mode",
    "1 while the engine serves with a subsystem degraded away, by mode "
    "(spec_off | legacy_prefill)",
    labels=("engine", "mode"))
ENGINE_HEALTH = registry.gauge(
    "paddle_engine_health",
    "One-hot engine health state: live | degraded | recovering | hung",
    labels=("engine", "state"))
RECOVERY_SECONDS = registry.histogram(
    "paddle_recovery_seconds",
    "Wall time of one engine recovery (inference.resilience.recover): "
    "rebuild + re-admission, graph handoff included")
