"""Fault injection, failure containment and crash recovery for the
serving stack (counterpart: paddle_tpu/inference/resilience.py).

* **`FaultPlan`** (``FLAGS_fault_inject`` or ``DecodeEngine(fault_plan=)``)
  — a deterministic, occurrence-counted schedule of failures at named
  sites (`FAULT_SITES`), with JAX's grammar: ``site@3,7-9`` entries,
  ``poison@TOKEN`` (the step fails while a request whose prompt holds the
  token is in the batch) and ``slow_ms=X``.  No wall clock: the Nth
  consult of a site fires.
* **`ResilienceManager`** — the ladder `DecodeEngine.step` runs under:
  retry with capped backoff ticks (``FLAGS_step_retries``,
  ``FLAGS_step_backoff_ms``); after ``FLAGS_degrade_after`` consecutive
  failures degrade the failing subsystem (speculation off, or chunked
  prefill back to the legacy one-shot prefill), re-enabled after
  ``FLAGS_degraded_probe_steps`` clean steps; then a bisect quarantine
  (preempt the newest request until the step succeeds, retire the last
  one with ``finish_reason="fault"``); an empty batch that still fails
  raises a fatal `StepFault`.
* **`EngineSnapshot` / `recover` / `serve_with_recovery`** — rebuild the
  engine in process from its resolved config and re-admit every request
  with its generated tokens folded into the prompt: greedy outputs are
  bit-identical and no streamed token is re-emitted.

What the card changes.  The steps are captured CUDA graphs that write
the KV pools in place, where JAX's executables return new, donated
pools:

* A retried step rewrites the rows it already wrote.  For f32 pages
  that is the same bytes; for int8 pages `paged_quant_write` folds the
  same absmax into an unchanged scale (ratio 1.0, no refold) and
  requantizes the rows to the same bytes, so a retry leaves the pools
  bit-equal to a clean step's.
* `recover` with ``handoff=True`` hands the dead engine's captured graphs
  to the successor together with the tensors they read (weights, pools,
  scales, generator, graph memory), zeroing the pools; an engine the
  watchdog abandoned never hands anything over (its worker may still be
  writing them), so its successor allocates and captures afresh.  The
  dead engine drops its graphs and pools, so two recoveries never hold
  three engines' memory.
* What the ladder contains.  JAX's ladder contains any exception a step
  raises.  On the card the port's contains only the faults the plan
  injects (`InjectedFault`, and the `PoolExhausted` of the ``pool``
  site): any other exception out of a step (a kernel's launch error, a
  wrapper's refusal, a failed or invalidated capture, a sticky CUDA
  error) leaves `DecodeEngine.step` at once, unretried and unwrapped.
  Retrying it would replay the same fault, and degrading would move the
  prefill from K1 to the legacy one-shot prefill's plain attention,
  hiding a fault of the port behind a slower path.  On the CPU (the
  plain versions throughout) the ladder keeps JAX's rule, so the tests
  hold its every rung against the JAX engine.  `ResilienceManager.
  contained` counts what the ladder took, by exception type and whether
  the plan injected it.
* A sticky CUDA error (an illegal address, a device-side assert) poisons
  the CUDA context of the whole process: every later launch, this
  engine's and a rebuilt one's, fails the same way, so neither the
  ladder nor `recover` in the same process can help.  Recovery from one
  has to come from a fresh process: `durability.restore_from_dir` over
  the journal.
* Sampling: the port draws from one engine `torch.Generator` where JAX
  folds per-step counters into a key.  The snapshot carries the
  generator's state (and the JAX fold counters ``step_no`` /
  ``prefill_no``, which here only date fault verdicts), so a recovered
  greedy serve is bit-identical and a sampled one continues its stream
  without losing or re-emitting a token; it is not the `jax.random`
  stream.

Everything here is host-side control between steps.  With no plan
armed each fault hook in the serve loop is one ``is None`` check; the
step itself still runs inside `ResilienceManager.run_step`'s ``try``,
which clears the failure counters after it.  Every rung lands as an
event in the engine's flight record (retry, degrade, degrade_end,
quarantine, recovery), and `recover` hands the dead engine's live
cost-model calibration to its successor.
"""
from __future__ import annotations

import time
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import observability as _obs
from ..analysis import sanitizer as _san
from ..core import flags as _flags
from .errors import (DegradedMode, FaultInfo, InjectedFault,
                     PoolExhausted, StepFault)
from .serving import _EngineRef

__all__ = ["FAULT_SITES", "FaultPlan", "ResilienceManager",
           "EngineSnapshot", "recover", "serve_with_recovery"]


FAULT_SITES = ("step", "mixed_step", "decode_step", "verify", "drafter",
               "pool", "nan_logits", "slow_step", "host_callback")


# ---------------------------------------------------------------------------
# The fault plan
# ---------------------------------------------------------------------------
class FaultPlan:
    """Deterministic fault schedule: ``schedule[site]`` is the set of
    1-based occurrence indices at which the site fires (the engine
    consults a site's counter every time execution passes the hook;
    the Nth consult fires iff N is scheduled).  ``poison_token`` arms
    the batch-content fault: the generic ``step`` site fails whenever
    a request whose PROMPT contains the token occupies an active slot
    — deterministic, and only the bisect containment can clear it.
    ``slow_ms`` is the stall the ``slow_step`` site injects.

    No wall-clock, no RNG at consult time: two runs over the same
    workload replay the same faults at the same steps.  Counters are
    carried across an engine rebuild (`recover` passes the same plan
    object), so a schedule never re-fires after recovery."""

    def __init__(self, schedule: Optional[Dict[str, Sequence[int]]] = None,
                 poison_token: Optional[int] = None, slow_ms: float = 5.0):
        self.schedule: Dict[str, frozenset] = {}
        for site, occs in (schedule or {}).items():
            if site not in FAULT_SITES:
                raise ValueError(
                    f"unknown fault site {site!r}: one of {FAULT_SITES}")
            occs = frozenset(int(o) for o in occs)
            if any(o < 1 for o in occs):
                raise ValueError(
                    f"occurrence indices are 1-based, got {sorted(occs)} "
                    f"for site {site!r}")
            self.schedule[site] = occs
        self.poison_token = None if poison_token is None \
            else int(poison_token)
        self.slow_ms = float(slow_ms)
        self._counts: Dict[str, int] = {}
        # the faults injected, by site ("poison" for the batch fault)
        self.fired: Dict[str, int] = {}

    def consult(self, site: str) -> bool:
        """Advance ``site``'s occurrence counter; True iff this
        occurrence is scheduled to fire."""
        n = self._counts.get(site, 0) + 1
        self._counts[site] = n
        return n in self.schedule.get(site, ())

    def poisoned(self, engine) -> bool:
        """Batch-content fault: True while any ACTIVE slot's request
        has the poison token in its prompt."""
        tok = self.poison_token
        if tok is None:
            return False
        for s in range(engine._slots):
            if not engine._active[s]:
                continue
            req = engine._by_slot[s]
            if req is not None and tok in req.prompt_ids:
                return True
        return False

    def consults(self, site: str) -> int:
        """How many times ``site`` has been consulted (telemetry)."""
        return self._counts.get(site, 0)

    @classmethod
    def parse(cls, spec: str) -> Optional["FaultPlan"]:
        """Parse the FLAGS_fault_inject grammar; None for an empty
        spec (harness disarmed, zero hot-path cost).

        ``spec`` is ';'-separated entries:

        * ``site@occs`` — ``occs`` is a ','-separated list of 1-based
          occurrence indices and ``a-b`` inclusive ranges, e.g.
          ``step@3,7-9``;
        * ``poison@TOKEN`` — arm the batch-content fault;
        * ``slow_ms=X`` — the ``slow_step`` stall duration.
        """
        spec = (spec or "").strip()
        if not spec:
            return None
        schedule: Dict[str, List[int]] = {}
        poison = None
        slow_ms = 5.0
        for entry in spec.split(";"):
            entry = entry.strip()
            if not entry:
                continue
            if entry.startswith("slow_ms="):
                slow_ms = float(entry.split("=", 1)[1])
                continue
            if "@" not in entry:
                raise ValueError(
                    f"bad fault_inject entry {entry!r}: expected "
                    f"'site@occurrences', 'poison@TOKEN' or 'slow_ms=X'")
            site, _, occs = entry.partition("@")
            site = site.strip()
            if site == "poison":
                poison = int(occs)
                continue
            out = schedule.setdefault(site, [])
            for part in occs.split(","):
                part = part.strip()
                if "-" in part:
                    a, _, b = part.partition("-")
                    out.extend(range(int(a), int(b) + 1))
                else:
                    out.append(int(part))
        return cls(schedule, poison_token=poison, slow_ms=slow_ms)

    @classmethod
    def seeded(cls, seed: int, sites: Sequence[str], rate: float,
               horizon: int, slow_ms: float = 5.0,
               poison_token: Optional[int] = None) -> "FaultPlan":
        """A pseudo-random — but fully deterministic given ``seed`` —
        schedule: each of the first ``horizon`` consults of every site
        fires with probability ``rate`` (drawn once, at construction,
        from a seeded RandomState; nothing is random at consult
        time).  The chaos bench (tools/bench_chaos.py) builds its
        storms with this."""
        rng = np.random.RandomState(seed)
        schedule = {
            site: [i + 1 for i in range(int(horizon))
                   if rng.random_sample() < rate]
            for site in sites
        }
        return cls(schedule, poison_token=poison_token, slow_ms=slow_ms)


# ---------------------------------------------------------------------------
# The containment ladder
# ---------------------------------------------------------------------------
class ResilienceManager:
    """Per-engine fault containment: injection hooks, the
    retry -> degrade -> bisect-quarantine ladder around
    `DecodeEngine._step_inner`, and the degraded-mode state machine.
    Constructed unconditionally (one per engine).  ``contain_foreign``
    is JAX's rule, to contain any raising step; it holds on the CPU and
    not on the card (see the module docstring)."""

    # never retried, never contained: the process state is suspect
    # (sanitizer invariants, audit asserts), not the step
    NONRETRYABLE = (_san.SanitizerError, AssertionError)
    engine = _EngineRef()

    def __init__(self, engine):
        self.engine = engine
        # consecutive failures per subsystem kind ("spec" | "mixed" |
        # "decode"), cleared by any clean step
        self._fail: Dict[str, int] = {}
        # contained drafter faults leave the STEP successful (the
        # round completes verify-only), so they carry their own
        # consecutive counter — cleared only by a round with no
        # drafter fault, not by mere step completion
        self._drafter_fail = 0
        self._drafter_faulted = False
        self.spec_disabled = False
        self.legacy_mode = False
        self._clean_since_degrade = 0
        self.backoff_ticks = 0  # deterministic, cumulative (telemetry)
        self.contain_foreign = engine.device.type != "cuda"
        # what the ladder and the drafter containment took:
        # (exception type name, injected) -> count
        self.contained: Counter = Counter()

    # -- injection hooks -----------------------------------------------------
    def _count_injection(self, site: str, fired: Optional[str] = None):
        from .serving import _stats_add

        plan = self.engine._fault
        key = fired or site
        plan.fired[key] = plan.fired.get(key, 0) + 1
        _stats_add(faults_injected=1)
        _obs.FAULTS_INJECTED.inc(site=site)

    @staticmethod
    def _injected(err: BaseException) -> BaseException:
        """Mark ``err`` as the plan's (`contain` reads the mark; keeping
        the exception would keep its traceback's frames, and with them
        the engine, alive).  The caller raises it inline."""
        err.injected = True
        return err

    def fault_point(self, site: str):
        """Consult one named site.  Fires according to the plan:
        ``pool`` raises `PoolExhausted`, ``slow_step`` stalls for
        ``plan.slow_ms``, everything else raises `InjectedFault`.
        Callers guard with ``engine._fault is not None`` so the
        disarmed hot path never enters here."""
        plan = self.engine._fault
        if plan is None or not plan.consult(site):
            return
        self._count_injection(site)
        if site == "slow_step":
            time.sleep(plan.slow_ms / 1e3)
            if self.engine._abandoned:
                # the frontend watchdog abandoned this engine while we
                # stalled: die here instead of running a step whose
                # requests already belong to the rebuilt engine
                raise StepFault(
                    "engine abandoned by the hung-step watchdog "
                    "mid-stall", site="hung", fatal=True)
            return
        if site == "pool":
            raise self._injected(PoolExhausted(
                "injected: KV page pool exhausted (fault site 'pool')"))
        raise self._injected(InjectedFault(
            f"injected fault at site {site!r}", site=site))

    def step_fault_point(self, kind_site: str):
        """The guard in front of every step executable: consults the
        generic ``step`` site (plus the poison-token batch fault),
        then the executable-specific site (``mixed_step`` /
        ``decode_step`` / ``verify``)."""
        plan = self.engine._fault
        if plan is None:
            return
        fired = "step" if plan.consult("step") else \
            "poison" if plan.poisoned(self.engine) else None
        if fired is not None:
            self._count_injection("step", fired)
            raise self._injected(InjectedFault(
                "injected fault at site 'step'", site=kind_site))
        self.fault_point(kind_site)

    def corrupt_tokens(self, toks, eligible_slots):
        """The ``nan_logits`` site, host half: when scheduled, replace
        the lowest eligible slot's sampled token with the NaN sentinel
        the in-graph `serving._guard_tokens` guard produces for a
        genuinely non-finite row — injection and organic NaN take the
        exact same quarantine path from here on.  ``toks`` is the
        fetched [B] token vector (or [B, Q] verify-target matrix:
        position 0 is corrupted)."""
        plan = self.engine._fault
        if plan is None or not eligible_slots or \
                not plan.consult("nan_logits"):
            return toks
        self._count_injection("nan_logits")
        toks = np.array(toks)  # the fetched buffer may be read-only
        s = min(eligible_slots)
        if toks.ndim == 1:
            toks[s] = -1
        else:
            toks[s, 0] = -1
        return toks

    # -- degraded-mode state machine -----------------------------------------
    def spec_active(self) -> bool:
        return self.engine._spec is not None and not self.spec_disabled

    def contain(self, err: Exception) -> bool:
        """Whether containment may take ``err``: a fault the plan
        injected, or, with ``contain_foreign``, anything but a lost mesh
        worker (`parallel.mesh.MeshError`: no retry brings a rank back).
        A taken one is counted in ``contained``; the caller re-raises
        the rest."""
        from ..parallel.mesh import MeshError

        injected = isinstance(err, InjectedFault) or \
            getattr(err, "injected", False)
        if not (injected or self.contain_foreign) or \
                isinstance(err, MeshError):
            return False
        self.contained[(type(err).__name__, injected)] += 1
        return True

    def on_drafter_fault(self, err: Exception):
        """A contained drafter raise (the round proceeds verify-only).
        Counts toward the spec-degradation threshold on its own
        consecutive counter — the step itself completes, so the
        generic per-step failure accounting never sees it."""
        self._drafter_faulted = True
        self._drafter_fail += 1
        self._maybe_disable_spec(err)

    def _maybe_disable_spec(self, err: Exception) -> bool:
        from .serving import _stats_add

        eng = self.engine
        consecutive = max(self._fail.get("spec", 0), self._drafter_fail)
        if eng._spec is None or self.spec_disabled or \
                consecutive < int(_flags.flag("degrade_after")):
            return False
        self.spec_disabled = True
        self._clean_since_degrade = 0
        self._fail.pop("spec", None)
        self._drafter_fail = 0
        _stats_add(spec_disables=1)
        _obs.DEGRADED_MODE.set(1, engine=eng._engine_id, mode="spec_off")
        from .durability import set_health

        set_health(eng._engine_id, "degraded")
        _obs.record_span("engine", "degrade:spec_off", _obs.now_ns(), 0,
                         tid=eng._engine_id,
                         args={"error": str(err)[:200]})
        if eng._flight is not None:
            eng._flight.event("degrade", mode="spec_off",
                              error=str(err)[:120])
        return True

    def _maybe_degrade_legacy(self, err: Exception) -> bool:
        """Persistent mixed-step failure: fall back to the legacy
        one-shot prefill oracle path.  Mid-prefill slots are preempted
        (their partially consumed prompts replay through the legacy
        prefill), chunked mode and the prefix cache switch off; the
        re-enable probe restores both after clean steps."""
        from .serving import _stats_add

        eng = self.engine
        if not eng._chunked or \
                self._fail.get("mixed", 0) < int(_flags.flag(
                    "degrade_after")):
            return False
        for s in range(eng._slots):
            if eng._active[s] and eng._is_prefilling(s):
                eng.preempt(eng._by_slot[s])
        eng._chunked = False
        eng._prefix_cache = False
        self.legacy_mode = True
        self._clean_since_degrade = 0
        self._fail.pop("mixed", None)
        _stats_add(legacy_fallbacks=1)
        _obs.DEGRADED_MODE.set(1, engine=eng._engine_id,
                               mode="legacy_prefill")
        from .durability import set_health

        set_health(eng._engine_id, "degraded")
        _obs.record_span("engine", "degrade:legacy_prefill",
                         _obs.now_ns(), 0, tid=eng._engine_id,
                         args={"error": str(err)[:200]})
        if eng._flight is not None:
            eng._flight.event("degrade", mode="legacy_prefill",
                              error=str(err)[:120])
        return True

    def _note_success(self):

        self._fail.clear()
        if not self._drafter_faulted:
            self._drafter_fail = 0  # a round with a healthy drafter
        self._drafter_faulted = False
        if not (self.spec_disabled or self.legacy_mode):
            return
        self._clean_since_degrade += 1
        if self._clean_since_degrade < int(_flags.flag(
                "degraded_probe_steps")):
            return
        eng = self.engine
        self._clean_since_degrade = 0
        if self.spec_disabled and \
                not getattr(eng._spec.drafter, "stateful", False):
            # probe: try speculation again; a fresh failure re-degrades
            self.spec_disabled = False
            _obs.DEGRADED_MODE.set(0, engine=eng._engine_id,
                                   mode="spec_off")
            if eng._flight is not None:
                eng._flight.event("degrade_end", mode="spec_off")
        if self.legacy_mode:
            eng._chunked = eng._chunked_cfg
            eng._prefix_cache = eng._prefix_cache_cfg
            self.legacy_mode = False
            _obs.DEGRADED_MODE.set(0, engine=eng._engine_id,
                                   mode="legacy_prefill")
            if eng._flight is not None:
                eng._flight.event("degrade_end", mode="legacy_prefill")
        if not (self.spec_disabled or self.legacy_mode):
            from .durability import set_health

            set_health(eng._engine_id, "live")

    # -- the ladder ----------------------------------------------------------
    def _backoff(self, attempt: int):
        """Capped exponential backoff between same-step retries:
        deterministic tick accounting (1, 2, 4, ... capped at 8) —
        the wall sleep is tick * FLAGS_step_backoff_ms and defaults to
        ZERO, so tier-1 tests replay instantly while production can
        give a transient device fault room to clear."""
        from .serving import _stats_add

        ticks = min(1 << (attempt - 1), 8)
        self.backoff_ticks += ticks
        _stats_add(step_retries=1)
        _obs.STEP_RETRIES.inc()
        fl = self.engine._flight
        if fl is not None:
            fl.event("retry", attempt=attempt, ticks=ticks)
        base_ms = float(_flags.flag("step_backoff_ms"))
        if base_ms > 0:
            time.sleep(ticks * base_ms / 1e3)

    def run_step(self) -> bool:
        """Run `DecodeEngine._step_inner` under the containment
        ladder.  See the module docstring for the rungs; any step that
        completes clears the consecutive-failure counters and advances
        the degraded-mode re-enable probe."""

        eng = self.engine
        attempt = 0
        while True:
            try:
                out = eng._step_inner()
            except self.NONRETRYABLE:
                raise
            except Exception as e:
                # an abandoned engine's requests live on the rebuilt one
                # (the watchdog): containment here would mutate state
                # nobody owns anymore
                if eng._abandoned or not self.contain(e):
                    raise
                # the subsystem the failed step ran, read at its start
                kind = eng._step_kind
                self._fail[kind] = self._fail.get(kind, 0) + 1
                if attempt < int(_flags.flag("step_retries")):
                    attempt += 1
                    self._backoff(attempt)
                    continue
                # retries exhausted: degrade the failing subsystem —
                # the degraded path gets its own retry budget
                if kind == "spec" and self._maybe_disable_spec(e):
                    attempt = 0
                    continue
                if kind == "mixed" and self._maybe_degrade_legacy(e):
                    attempt = 0
                    continue
                return self._bisect_quarantine(e, attempt)
            self._note_success()
            return out

    def _newest_running(self):
        """The most recently admitted running request (bisect order:
        newest admits are the most likely suspects — they are what
        changed about the batch)."""
        eng = self.engine
        live = [r for r in eng._by_slot if r is not None]
        if not live:
            return None
        return max(live, key=lambda r: (r.t_admit_ns or 0, r.request_id))

    def _bisect_quarantine(self, err: Exception, attempts: int) -> bool:
        """Isolate the suspect: preempt the newest-admitted request
        and retry, repeating until the step succeeds.  The LAST
        removal is the suspect — retired with ``finish_reason="fault"``
        and a structured `FaultInfo` — while the innocents preempted
        along the way resume from the queue (their replay rides the
        prefix cache, so the detour costs at most one partial page of
        recompute each).  An empty batch that still fails re-raises as
        a FATAL `StepFault`: the engine itself is broken and only
        `recover` can continue."""
        eng = self.engine
        removed = []
        while True:
            victim = self._newest_running()
            if victim is None:
                site = getattr(err, "site", "step")
                raise StepFault(
                    f"step fault survived retry, degradation and "
                    f"batch bisection — the engine is broken "
                    f"(last error: {err})", site=site,
                    attempts=attempts + len(removed), fatal=True) \
                    from err
            eng.preempt(victim)
            removed.append(victim)
            attempt_ns = _obs.now_ns()
            try:
                out = eng._step_inner()
            except self.NONRETRYABLE:
                raise
            except Exception as e:
                if not self.contain(e):
                    raise
                err = e
                continue
            suspect = removed[-1]
            # the suspect was preempted back into the queue: retire it
            # from there with the fault verdict; everyone else stays
            # queued and resumes on the following steps
            suspect.fault_info = FaultInfo(
                site=getattr(err, "site", "step"),
                attempts=attempts + len(removed), step=eng._step_no,
                recovered=False, message=str(err))
            # its traceback holds this frame: dropped, it frees the
            # engine without the cyclic collector
            del err
            eng._retire_queued(suspect, "fault")
            _obs.record_span(
                "engine", "quarantine", attempt_ns,
                _obs.now_ns() - attempt_ns, tid=eng._engine_id,
                args={"request": suspect.request_id,
                      "site": suspect.fault_info.site,
                      "bisected": len(removed)})
            if eng._flight is not None:
                eng._flight.event("quarantine",
                                  request=suspect.request_id,
                                  site=suspect.fault_info.site,
                                  bisected=len(removed))
            self._note_success()
            return out


# ---------------------------------------------------------------------------
# Crash recovery
# ---------------------------------------------------------------------------
class _ReqRecord:
    __slots__ = ("request", "prompt_ids", "output_ids", "max_new",
                 "absorbed", "orig_len", "streamed")

    def __init__(self, request):
        self.request = request
        self.prompt_ids = list(request.prompt_ids)
        self.output_ids = list(request.output_ids)
        self.max_new = int(request.max_new_tokens)
        self.absorbed = int(request._absorbed)
        self.orig_len = int(request.orig_prompt_len)
        # the emitted-token watermark at capture (a gated token was
        # streamed by an earlier life)
        self.streamed = self.absorbed + len(self.output_ids) + \
            int(request._emit_gate)


class EngineSnapshot:
    """Host state of every in-flight request, captured between steps:
    prompt and generated ids, remaining budget, the preemption fold, the
    step counters, and the sampling generator's state (``rng``, None for
    a greedy engine).  `Request` objects are kept by reference, so
    recovery re-admits the same objects and streams keep working.
    Capture order is admission order (running requests by admit stamp,
    then the queue)."""

    def __init__(self, engine):
        self.engine_id = engine._engine_id
        self.step_no = int(engine._step_no)
        self.prefill_no = int(engine._prefill_no)
        self.rng = None
        if engine._sampling["sampler"] != "greedy":
            self.rng = engine._generator.get_state().clone()
        running = sorted(
            (r for r in engine._by_slot if r is not None),
            key=lambda r: (r.t_admit_ns or 0, r.request_id))
        self.records = [_ReqRecord(r) for r in running] + \
            [_ReqRecord(r) for r in engine._queue]

    def __len__(self):
        return len(self.records)

    def to_wire(self, journal_pos: int = 0):
        """The serializable form (`durability.SnapshotWire`)."""
        from .durability import RequestWire, SnapshotWire

        return SnapshotWire(
            engine_id=self.engine_id, step_no=self.step_no,
            prefill_no=self.prefill_no, journal_pos=int(journal_pos),
            records=[RequestWire.from_record(rec)
                     for rec in self.records],
            rng=None if self.rng is None else bytes(
                self.rng.numpy()).hex())


def recover(engine, snapshot: Optional[EngineSnapshot] = None,
            fault: Optional[BaseException] = None,
            handoff: bool = True):
    """Rebuild a fresh engine after a fatal fault and re-admit every
    in-flight request.  The dead engine's resolved config (``_ctor``)
    rebuilds an identical engine; the scheduler and drafter instances
    are unbound and rebound, and the same fault plan carries its
    occurrence counters, so an injected schedule never fires again.

    ``handoff=True`` hands the dead engine's captured graphs, with the
    tensors they read, to the successor, which allocates none of its own
    (the constructor's ``_adopt``): no graph is captured again.  An
    abandoned engine hands nothing over; its successor allocates and
    captures anew.  Either way the dead engine lets go of its graphs and
    pools (an abandoned one keeps them until its worker returns), a cold
    rebuild's before the successor allocates.

    Each request's generated tokens fold into its prompt (the
    `DecodeEngine.preempt` fold), so replay is an ordinary prompt;
    tokens the live request streamed past an older ``snapshot`` (the
    watchdog's pre-step snapshot) are recomputed behind the `_emit`
    gate, streamed once, never twice.  Returns the new engine."""
    from .durability import retire_engine_series, set_health
    from .serving import DecodeEngine, _stats_add

    snap = snapshot if snapshot is not None else EngineSnapshot(engine)
    dead_dur, engine._durability = engine._durability, None
    if dead_dur is not None:
        # records buffered during the failing step must reach disk; the
        # successor owns the journal from here
        try:
            dead_dur.close()
        except Exception:
            pass
    t0 = time.perf_counter()
    t0_ns = _obs.now_ns()
    kw = dict(engine._ctor)
    for key in ("scheduler", "drafter"):
        obj = kw.get(key)
        if obj is not None and hasattr(obj, "engine"):
            obj.engine = None  # unbind: bind() rebuilds per-engine state
    if engine._cost is not None:
        # the dead engine's LIVE calibration: the successor's predictor
        # starts warm, like its graphs
        kw["cost_calibration"] = engine._cost.calibration_wire()
    donor = engine if handoff and not engine._abandoned and \
        engine._k_pages is not None else None
    if donor is None and not engine._abandoned:
        engine._release_device_state()
    new = DecodeEngine(**kw, _adopt=donor)
    set_health(new._engine_id, "recovering")
    if snap.rng is not None:
        new._generator.set_state(snap.rng)
    new._step_no = snap.step_no
    new._prefill_no = snap.prefill_no
    site = getattr(fault, "site", "engine")
    n_readmitted = 0
    for rec in snap.records:
        req = rec.request
        if req.state == "done":
            continue  # finished between capture and recover
        live_streamed = req._absorbed + len(req.output_ids) + \
            req._emit_gate
        n_gen = len(rec.output_ids)
        req.prompt_ids = list(rec.prompt_ids) + list(rec.output_ids)
        req.max_new_tokens = rec.max_new - n_gen
        req._absorbed = rec.absorbed + n_gen
        req._emit_gate = max(0, live_streamed - rec.absorbed - n_gen)
        req.output_ids = []
        req.pages = []
        req.slot = None
        req.cached_page_count = 0
        req.cached_prefix_len = 0
        req._page_hashes = None
        req.state = "queued"
        req._engine = new
        if req.fault_info is None:
            req.fault_info = FaultInfo(
                site=site, step=snap.step_no, recovered=True,
                message=str(fault) if fault is not None else
                "rode an engine recovery")
        else:
            req.fault_info.history.append(req.fault_info.site)
            req.fault_info.site = site
            req.fault_info.recovered = True
        new._queue.append(req)
        n_readmitted += 1
    _stats_add(recoveries=1)
    _obs.RECOVERIES.inc()
    _obs.RECOVERY_SECONDS.observe(time.perf_counter() - t0)
    _obs.record_span("engine", "recovery", t0_ns, _obs.now_ns() - t0_ns,
                     tid=new._engine_id,
                     args={"from_engine": snap.engine_id,
                           "requests": n_readmitted, "site": site})
    if new._flight is not None:
        new._flight.event("recovery", from_engine=snap.engine_id,
                          requests=n_readmitted, site=site)
    set_health(new._engine_id, "live")
    retire_engine_series(engine._engine_id)
    return new


def serve_with_recovery(engine, max_recoveries: Optional[int] = None,
                        max_steps: int = 100000
                        ) -> Tuple[object, int]:
    """Blocking serve loop with crash recovery: drive ``engine`` like
    `DecodeEngine.run`, rebuilding it through `recover` whenever a fault
    survives the ladder.  Returns ``(final_engine, recoveries)``; more
    than ``max_recoveries`` (default FLAGS_engine_recoveries) rebuilds
    raises `DegradedMode`."""
    limit = int(_flags.flag("engine_recoveries")) \
        if max_recoveries is None else int(max_recoveries)
    recoveries = 0
    steps = 0
    while engine._queue or engine._active.any():
        if steps >= max_steps:
            raise RuntimeError(
                f"serve_with_recovery(max_steps={max_steps}) exhausted "
                f"with work pending after {recoveries} recoveries")
        try:
            engine.step()
        except StepFault as e:
            if recoveries >= limit:
                raise DegradedMode(
                    f"engine recovery budget exhausted "
                    f"({limit} rebuilds): {e}") from e
            engine = recover(engine, fault=e)
            recoveries += 1
        steps += 1
    return engine, recoveries
