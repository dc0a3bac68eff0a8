"""Declarative multi-window burn-rate alerting over the serving gauges
(counterpart: paddle_tpu/observability/alerts.py, copied, not imported:
the rules, the signals and the state machine are the same).

The serving stack emits raw signals (SLO burn, engine health, pool
pressure, HBM-ledger residue, cost-model drift), but a fleet router or
an operator pager consumes **fire/resolve transitions with
hysteresis**.  This module is the rule table between the two:

* `AlertRule` — one declarative rule: a named **signal** (resolved by
  the table below against the owning engine + the metric registry),
  either a plain threshold or a **multi-window burn-rate pair** in the
  SRE style (fire only when EVERY window's average exceeds its factor
  — e.g. 5m@14x AND 1h@6x over ``paddle_slo_burn`` — so a brief blip
  can't page but a sustained burn fires fast), a ``for_s`` hold before
  firing, and a ``resolve_after_s`` clean requirement before resolving
  (firing -> resolved requires clean windows: the shortest window must
  read clean continuously, so an alert never flaps at the threshold);
* `AlertEngine` — one engine's evaluator.  `DecodeEngine.step` calls
  `maybe_step` BETWEEN steps every ``FLAGS_alert_interval_steps``
  steps (the engine thread, so signal reads are between-steps
  consistent and the serve hot path gains no locks), and evaluation is
  also forced on a fatal step fault / watchdog abandonment so the
  crash dump records which alerts were firing at death.

Transitions land in three places at once: the
``paddle_alerts_firing{engine,rule,severity}`` gauge +
``paddle_alert_transitions_total{rule,state}`` counter (the scrape
surface), an ``alert_fire``/``alert_resolve`` event in the engine's
flight ring (the black box), and the bounded ``transitions`` list the
``/alertz`` endpoint serves (observability.opsserver).  `/readyz`
consults `firing("page")` — a page-severity alert makes the engine
NOT ready, the router's failover signal.

Threading: rule histories are engine-thread-private (like the flight
recorder's open record); everything cross-thread — the per-rule state
table and the transitions list `/alertz` reads — mutates under the
module's designated ``_lock``.  Metric updates happen outside the lock.  The
evaluator reads engine state and never mutates it.
"""
from __future__ import annotations

import os
import threading
import weakref
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from ..analysis.sanitizer import TrackedLock as _TrackedLock


__all__ = ["AlertRule", "AlertEngine", "default_rules", "SEVERITIES",
           "SIGNALS", "fleet_rollup"]

SEVERITIES = ("page", "ticket")

# THE alert-engine lock: every cross-thread surface — the per-rule
# state table and the transitions ring `/alertz` serves — mutates
# under it.  An RLock so a locked snapshot may call locked helpers.
# a TrackedLock under the JAX package's name, so FLAGS_sanitize
# records acquisition order (analysis.sanitizer)
_lock = _TrackedLock(threading.RLock(), "alerts._lock")

# bounded transition history per engine (the /alertz "recent
# transitions" window — operators read the tail, not the archive)
MAX_TRANSITIONS = 256

_obs_mod = None


def _obs():
    # lazy catalog resolution (the flight-recorder pattern): this
    # module never participates in the package import cycle, and the
    # evaluator pays one global read per metric update
    global _obs_mod
    if _obs_mod is None:
        from paddle_tpu_torch import observability

        _obs_mod = observability
    return _obs_mod


@dataclass(frozen=True)
class AlertRule:
    """One declarative alert: a signal, a condition, and its timing.

    ``windows`` non-empty selects multi-window burn-rate mode: every
    ``(window_s, factor)`` pair must see its windowed AVERAGE of the
    signal >= factor for the rule to breach (order the windows
    shortest first — the shortest window is also the resolve probe).
    ``windows`` empty selects plain threshold mode: ``value <op>
    threshold`` breaches."""

    name: str
    signal: str
    severity: str = "ticket"
    description: str = ""
    # threshold mode
    threshold: float = 1.0
    op: str = ">"                      # ">" | ">=" | "<" | "<="
    # burn-rate mode: ((window_s, factor), ...) shortest window first
    windows: Tuple[Tuple[float, float], ...] = ()
    # timing: breach must HOLD for_s before firing; the condition must
    # read clean continuously resolve_after_s before resolving
    for_s: float = 0.0
    resolve_after_s: float = 0.0

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"alert {self.name!r}: severity must be one of "
                f"{SEVERITIES}, got {self.severity!r}")
        if self.signal not in SIGNALS:
            raise ValueError(
                f"alert {self.name!r}: unknown signal "
                f"{self.signal!r} (have {tuple(sorted(SIGNALS))})")
        if self.op not in (">", ">=", "<", "<="):
            raise ValueError(
                f"alert {self.name!r}: op must be >, >=, < or <=")
        if self.windows and sorted(self.windows) != list(self.windows):
            raise ValueError(
                f"alert {self.name!r}: burn-rate windows must be "
                f"ordered shortest first")

    def to_wire(self) -> dict:
        return {
            "name": self.name, "signal": self.signal,
            "severity": self.severity,
            "description": self.description,
            "threshold": self.threshold, "op": self.op,
            "windows": [list(w) for w in self.windows],
            "for_s": self.for_s,
            "resolve_after_s": self.resolve_after_s,
        }

    @classmethod
    def from_wire(cls, obj: dict) -> "AlertRule":
        kw = dict(obj)
        kw["windows"] = tuple(tuple(w) for w in kw.get("windows", ()))
        return cls(**kw)


# ---------------------------------------------------------------------------
# Signals: how a rule's name resolves to a float against one engine.
# Each returns the current reading, or None for "no evidence" (the
# subsystem is disarmed — the rule stays quiet rather than firing or
# resolving on a phantom zero).
# ---------------------------------------------------------------------------
_BURN_KINDS = ("ttft", "tpot", "deadline")
_LEDGER_CATEGORIES = ("weights", "weights_int8", "weight_scales",
                      "kv_pages", "kv_scales", "draft_pool", "misc")


def _sig_slo_burn(eng) -> Optional[float]:
    """Worst live SLO budget burn across kinds — the flight recorder's
    ``paddle_slo_burn`` gauge, the signal the default catalog's
    5m@14x + 1h@6x pair integrates."""
    if eng._flight is None:
        return None
    obs = _obs()
    eid = eng._engine_id
    return max(obs.SLO_BURN.value(engine=eid, kind=k)
               for k in _BURN_KINDS)


def _sig_engine_hung(eng) -> Optional[float]:
    from ..inference.durability import _health_state

    return 1.0 if _health_state.get(eng._engine_id) == "hung" else 0.0


def _sig_engine_degraded(eng) -> Optional[float]:
    res = eng._resilience
    return 1.0 if (res.spec_disabled or res.legacy_mode) else 0.0


def _sig_pool_reclaimable_frac(eng) -> Optional[float]:
    pool = eng.pool
    return (pool.free_count + pool.cached_unreferenced_count) \
        / max(pool.num_pages, 1)


def _sig_hbm_unattributed_ratio(eng) -> Optional[float]:
    if eng._cost is None:
        return None
    obs = _obs()
    eid = eng._engine_id
    unattr = obs.HBM_UNATTRIBUTED.value(engine=eid)
    total = unattr + sum(
        obs.HBM_LEDGER.value(engine=eid, category=c)
        for c in _LEDGER_CATEGORIES)
    if total <= 0:
        return None  # no audit has run yet
    return unattr / total


def _sig_cost_error_max(eng) -> Optional[float]:
    """THIS engine's worst calibration-error EWMA across executable
    kinds — read from its own CostModel table, not the
    ``paddle_step_cost_error_ratio{fn}`` gauge: that gauge is keyed by
    fn only, so another engine's drift must not fire this one's
    alert."""
    cost = eng._cost
    if cost is None:
        return None
    errs = dict(cost._err)  # fn -> EWMA ratio; copy: it mutates per step
    if not errs:
        return None  # nothing calibrated yet: no evidence
    return max(errs.values())


def _sig_mfu_drift_max(eng) -> Optional[float]:
    """THIS engine's worst predicted-vs-measured MFU drift across
    device phases — read from its own Profiler table
    (observability.profiling), not the phase-only ``paddle_mfu_drift``
    gauge: another engine's drift must not fire this one's alert.
    None (no evidence) while the profiling plane is disarmed or no
    probe has scored yet."""
    prof = getattr(eng, "_profiling", None)
    if prof is None:
        return None
    drifts = prof.drift_table()
    if not drifts:
        return None  # no probed step scored yet: no evidence
    return max(drifts.values())


def _sig_journal_bytes(eng) -> Optional[float]:
    if eng._durability is None or not eng._journal_dir:
        return None
    try:
        return float(os.path.getsize(
            os.path.join(eng._journal_dir, "journal.wal")))
    except OSError:
        return None


# per-evaluator last-seen dropped-span count, keyed by engine id —
# engine-thread-private by the evaluation contract (each engine's
# alert engine runs on that engine's own thread between steps, and no
# two engines share an id), the _RuleHist lock-free pattern
_trace_drop_seen: Dict[int, float] = {}


def _sig_trace_span_drop_delta(eng) -> Optional[float]:
    """Growth of `tracing.dropped_span_count()` since THIS engine's
    previous evaluation.  Overflow is process-wide, but the delta is
    tracked per evaluator so co-resident engines don't consume each
    other's evidence.  First look (or a post-`clear_spans` reset,
    which makes the count fall) returns no-breach."""
    from . import tracing

    cur = float(tracing.dropped_span_count())
    prev = _trace_drop_seen.get(eng._engine_id)
    _trace_drop_seen[eng._engine_id] = cur
    if prev is None:
        return None  # no baseline yet: no evidence either way
    return max(cur - prev, 0.0)


SIGNALS = {
    "slo_burn": _sig_slo_burn,
    "engine_hung": _sig_engine_hung,
    "engine_degraded": _sig_engine_degraded,
    "pool_reclaimable_frac": _sig_pool_reclaimable_frac,
    "hbm_unattributed_ratio": _sig_hbm_unattributed_ratio,
    "cost_error_max": _sig_cost_error_max,
    "mfu_drift_max": _sig_mfu_drift_max,
    "journal_bytes": _sig_journal_bytes,
    "trace_span_drop_delta": _sig_trace_span_drop_delta,
}


def default_rules(window_scale: float = 1.0) -> Tuple[AlertRule, ...]:
    """The shipped catalog: one rule per signal the stack already
    emits (docs/OBSERVABILITY.md's alert-rule table mirrors this —
    the doc-drift test pins both directions).  ``window_scale``
    shrinks every window/duration uniformly (benches and chaos tests
    run the SAME catalog at second scale instead of SRE hour scale —
    the rule NAMES, factors and thresholds never change)."""
    s = float(window_scale)
    return (
        AlertRule(
            "slo_burn_rate", signal="slo_burn", severity="page",
            windows=((300.0 * s, 14.0), (3600.0 * s, 6.0)),
            resolve_after_s=60.0 * s,
            description="sustained SLO budget burn: the 5m window "
                        "averages >= 14x AND the 1h window >= 6x over "
                        "paddle_slo_burn — the classic multi-window "
                        "pair (fast on real fires, deaf to blips)"),
        AlertRule(
            "engine_hung", signal="engine_hung", severity="page",
            threshold=1.0, op=">=",
            description="paddle_engine_health one-hot reads hung: the "
                        "step watchdog classified a stalled step; "
                        "expect abandon + rebuild"),
        AlertRule(
            "engine_degraded", signal="engine_degraded",
            severity="ticket", threshold=1.0, op=">=",
            description="a subsystem is degraded away (speculation "
                        "off / legacy prefill) after repeated faults; "
                        "resolves when the re-enable probe restores "
                        "it"),
        AlertRule(
            "pool_pressure", signal="pool_reclaimable_frac",
            severity="page", threshold=0.05, op="<",
            resolve_after_s=30.0 * s,
            description="reclaimable KV pages (free + cached-"
                        "unreferenced) below 5% of the pool — the "
                        "next admissions will stall or evict; stop "
                        "routing work here"),
        AlertRule(
            "hbm_unattributed", signal="hbm_unattributed_ratio",
            severity="ticket", threshold=0.05, op=">",
            resolve_after_s=30.0 * s,
            description="HBM-ledger unattributed residue above 5% of "
                        "live device bytes — leaked temporaries or a "
                        "category the ledger forgot"),
        AlertRule(
            "cost_model_drift", signal="cost_error_max",
            severity="ticket", threshold=0.25, op=">",
            for_s=30.0 * s, resolve_after_s=30.0 * s,
            description="paddle_step_cost_error_ratio above the 25% "
                        "calibration gate for any executable kind — "
                        "headroom and admission numbers are no longer "
                        "trustworthy"),
        AlertRule(
            "mfu_regression", signal="mfu_drift_max",
            severity="ticket", threshold=0.5, op=">",
            for_s=30.0 * s, resolve_after_s=30.0 * s,
            description="predicted-vs-measured device-time drift "
                        "(paddle_mfu_drift) above the 50% gate for "
                        "any device phase: measured device seconds "
                        "ran far from the profile-based prediction "
                        "learned from earlier probes — the device "
                        "slowed, or the static profiles went stale "
                        "for this hardware"),
        AlertRule(
            "journal_growth", signal="journal_bytes",
            severity="ticket", threshold=256.0 * 1024 * 1024, op=">",
            resolve_after_s=30.0 * s,
            description="write-ahead journal past 256 MiB — restores "
                        "replay the whole journal; compact it "
                        "(rewrite on restore) before it dominates "
                        "recovery time"),
        AlertRule(
            "trace_span_drops", signal="trace_span_drop_delta",
            severity="ticket", threshold=0.0, op=">",
            resolve_after_s=30.0 * s,
            description="paddle_trace_spans_dropped_total grew since "
                        "the previous evaluation: the span buffer is "
                        "at MAX_SPANS and new spans are counted, not "
                        "stored — export and clear the trace.  Ticket "
                        "severity BY DESIGN (page-exempt): a full "
                        "trace buffer must never flip /readyz and "
                        "drain a healthy replica"),
    )


class _RuleHist:
    """Engine-thread-private evaluation history for one rule (the
    open-record analogue: only the evaluating thread touches it, so
    the windowed averages cost no locks)."""

    __slots__ = ("samples", "breach_since", "clean_since")

    def __init__(self):
        self.samples: "deque[Tuple[float, float]]" = deque()
        self.breach_since: Optional[float] = None
        self.clean_since: Optional[float] = None


class AlertEngine:
    """One engine's alert evaluator: rule table + state machine.

    States per rule: ``ok`` -> (breach) -> ``pending`` -> (held
    ``for_s``) -> ``firing`` -> (clean ``resolve_after_s``) -> ``ok``.
    Only the ok->firing and firing->ok edges transition externally
    (gauge, counter, flight event, transitions list); ``pending`` is
    internal debounce."""

    @property
    def engine(self):
        return self._engine()

    def __init__(self, engine, rules: Optional[Sequence] = None,
                 interval_steps: Optional[int] = None):
        from ..core import flags as _flags

        # held weakly: an engine dies by reference counting, with its
        # graphs and pools, while its helpers may outlive it
        self._engine = weakref.ref(engine)
        if rules is None:
            rules = default_rules()
        self.rules: Tuple[AlertRule, ...] = tuple(
            r if isinstance(r, AlertRule) else AlertRule.from_wire(r)
            for r in rules)
        names = [r.name for r in self.rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate alert rule names: {names}")
        if interval_steps is None:
            interval_steps = int(_flags.flag("alert_interval_steps"))
        # the flag documents "<= 0 falls back to 32" — an accidental 0
        # must not silently buy every-step evaluation on the serve loop
        self.interval_steps = int(interval_steps) \
            if int(interval_steps) > 0 else 32
        self._steps_since = 0
        # cross-thread state (under alerts._lock): rule -> state dict
        self._state: Dict[str, dict] = {}
        self._transitions: List[dict] = []
        with _lock:
            for r in self.rules:
                self._state[r.name] = {
                    "state": "ok", "severity": r.severity,
                    "value": None, "since_ns": None,
                }
        # engine-thread-private histories + accounting
        self._hist = {r.name: _RuleHist() for r in self.rules}
        self.eval_seconds = 0.0
        self.evals = 0

    # -- engine-thread side ---------------------------------------------------
    def maybe_step(self):
        """Between-steps cadence hook (`DecodeEngine.step`): evaluate
        every ``interval_steps`` steps.  The off-cadence cost is one
        integer bump."""
        self._steps_since += 1
        if self._steps_since >= self.interval_steps:
            self._steps_since = 0
            self.evaluate()

    def evaluate(self, now: Optional[float] = None):
        """Walk the rule table once.  ``now`` (seconds, monotonic
        domain) is injectable so tests drive the state machine through
        hours without sleeping."""
        t0 = time.perf_counter()
        if now is None:
            now = t0
        eng = self.engine
        fired: List[Tuple[AlertRule, float]] = []
        resolved: List[Tuple[AlertRule, float]] = []
        for rule in self.rules:
            v = SIGNALS[rule.signal](eng)
            h = self._hist[rule.name]
            if v is None:
                continue  # no evidence: state holds
            breach, short_clean = self._condition(rule, h, now, v)
            with _lock:
                st = self._state[rule.name]
                st["value"] = round(float(v), 6)
                state = st["state"]
                if state in ("ok", "pending"):
                    h.clean_since = None
                    if breach:
                        if h.breach_since is None:
                            h.breach_since = now
                        if now - h.breach_since >= rule.for_s:
                            st["state"] = "firing"
                            st["since_ns"] = _obs().now_ns()
                            fired.append((rule, float(v)))
                        elif state == "ok":
                            st["state"] = "pending"
                    else:
                        h.breach_since = None
                        if state == "pending":
                            st["state"] = "ok"
                else:  # firing
                    h.breach_since = None
                    if short_clean:
                        if h.clean_since is None:
                            h.clean_since = now
                        if now - h.clean_since >= rule.resolve_after_s:
                            st["state"] = "ok"
                            st["since_ns"] = _obs().now_ns()
                            resolved.append((rule, float(v)))
                    else:
                        h.clean_since = None
        self._emit_transitions(fired, resolved)
        self.evals += 1
        self.eval_seconds += time.perf_counter() - t0

    def _condition(self, rule: AlertRule, h: _RuleHist, now: float,
                   v: float):
        """(breach, short_window_clean) for one rule reading."""
        if not rule.windows:
            breach = self._cmp(rule.op, v, rule.threshold)
            return breach, not breach
        h.samples.append((now, float(v)))
        horizon = now - rule.windows[-1][0]
        while h.samples and h.samples[0][0] < horizon:
            h.samples.popleft()
        breach = True
        short_clean = False
        for i, (w, factor) in enumerate(rule.windows):
            vals = [x for t, x in h.samples if t >= now - w]
            avg = sum(vals) / len(vals) if vals else 0.0
            ok = self._cmp(rule.op, avg, factor)
            breach = breach and ok
            if i == 0:
                # the shortest window is the resolve probe: hysteresis
                # requires IT to read clean continuously — the long
                # window keeps history of the fire for hours by design
                short_clean = not ok
        return breach, short_clean

    @staticmethod
    def _cmp(op: str, a: float, b: float) -> bool:
        if op == ">":
            return a > b
        if op == ">=":
            return a >= b
        if op == "<":
            return a < b
        return a <= b

    def _emit_transitions(self, fired, resolved):
        """Gauge/counter/flight/transition-list updates for this
        round's edges — metrics outside the lock, the transitions
        list under it."""
        if not fired and not resolved:
            return
        obs = _obs()
        eng = self.engine
        eid = eng._engine_id
        now_ns = obs.now_ns()
        entries = []
        for rule, v in fired:
            entries.append({"t_ns": now_ns, "rule": rule.name,
                            "state": "firing",
                            "severity": rule.severity,
                            "value": round(v, 6)})
        for rule, v in resolved:
            entries.append({"t_ns": now_ns, "rule": rule.name,
                            "state": "resolved",
                            "severity": rule.severity,
                            "value": round(v, 6)})
        with _lock:
            self._transitions.extend(entries)
            del self._transitions[:-MAX_TRANSITIONS]
        if eng._abandoned:
            # a late evaluation on an abandoned engine must not
            # repopulate the gauges its retirement just removed
            return
        fr = eng._flight
        for rule, v in fired:
            obs.ALERTS_FIRING.set(1, engine=eid, rule=rule.name,
                                  severity=rule.severity)
            obs.ALERT_TRANSITIONS.inc(rule=rule.name, state="firing")
            if fr is not None:
                fr.event("alert_fire", rule=rule.name,
                         severity=rule.severity, value=round(v, 4))
        for rule, v in resolved:
            obs.ALERTS_FIRING.set(0, engine=eid, rule=rule.name,
                                  severity=rule.severity)
            obs.ALERT_TRANSITIONS.inc(rule=rule.name, state="resolved")
            if fr is not None:
                fr.event("alert_resolve", rule=rule.name,
                         severity=rule.severity, value=round(v, 4))

    # -- any-thread side ------------------------------------------------------
    def firing(self, severity: Optional[str] = None) -> List[str]:
        """Names of currently-firing rules (optionally filtered by
        severity) — `/readyz`'s page-alert probe."""
        with _lock:
            return sorted(
                name for name, st in self._state.items()
                if st["state"] == "firing"
                and (severity is None or st["severity"] == severity))

    def snapshot(self) -> dict:
        """JSON-serializable alert state: what `/alertz` serves, what
        `statusz` embeds, and what the flight recorder's crash dump
        includes so a post-mortem window shows the alerts firing at
        death."""
        with _lock:
            rules = {name: dict(st)
                     for name, st in self._state.items()}
            transitions = list(self._transitions)
        return {
            "engine": self.engine._engine_id,
            "interval_steps": self.interval_steps,
            "rules": rules,
            "firing": sorted(n for n, st in rules.items()
                             if st["state"] == "firing"),
            "transitions": transitions,
            "evals": self.evals,
        }
# Fleet-level rollup (served by /alertz when a FleetRouter registers)
# ---------------------------------------------------------------------------
def fleet_rollup(replicas, events=None, replicas_ready=None):
    """Merge per-replica ``/alertz`` documents into the one view an
    operator reads during an incident: which replicas are reachable,
    every rule firing fleet-wide grouped by severity (each entry named
    ``replica/engine/rule`` so the page points at a machine), and the
    router's own event narration (failovers, replicas joining/dying).

    ``replicas`` maps replica name -> the raw ``/alertz`` response
    body (``{"engines": {id: AlertEngine.snapshot()}}``), or None for
    a replica the poll could not reach — unreachability is itself the
    finding, so it rolls up as ``reachable: False`` rather than
    silently vanishing."""
    firing = {}
    per = {}
    for name, doc in (replicas or {}).items():
        if not isinstance(doc, dict):
            per[name] = {"reachable": False}
            continue
        entry = {"reachable": True, "firing": []}
        for eid, snap in (doc.get("engines") or {}).items():
            rules = snap.get("rules") or {}
            for rule in snap.get("firing", []):
                sev = (rules.get(rule) or {}).get("severity",
                                                  "unknown")
                label = f"{name}/{eid}/{rule}"
                firing.setdefault(sev, []).append(label)
                entry["firing"].append(label)
        per[name] = entry
    for sev in firing:
        firing[sev].sort()
    out = {
        "replicas": per,
        "reachable": sum(1 for p in per.values() if p["reachable"]),
        "firing": firing,
        "paging": bool(firing.get("page")) or
        any(not p["reachable"] for p in per.values()),
    }
    if replicas_ready is not None:
        out["replicas_ready"] = int(replicas_ready)
    if events:
        out["events"] = list(events)
    return out
