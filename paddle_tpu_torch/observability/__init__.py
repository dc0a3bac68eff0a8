"""Unified observability: metrics registry + request tracing + exporters
(counterpart: paddle_tpu/observability, copied and adapted, not
imported).

* `metrics`  — Counter/Gauge/Histogram registry, one shared lock,
  labeled series, near-zero cost when disabled;
* `tracing`  — named-track span buffer + the merged chrome-trace
  exporter (engine step spans, request lifecycle spans, probed device
  spans; the host track holds the eager profiler's host events);
* `reporter` — optional periodic snapshot thread
  (``FLAGS_metrics_report_interval_s``);
* `flight`, `costmodel`, `profiling`, `alerts`, `opsserver` — the
  serving telemetry plane the engine calls: the per-step flight
  recorder, the cost observatory, the probes, the alert rules and the
  ops HTTP endpoint.

``decode_stats`` (`profiler` / `inference.serving`) keeps its storage
and public API and is **re-registered as a view**: a collection-time
callable rendering its counters into the same Prometheus/JSON exports
as the first-class series below.

Metric catalog (all first-class series live here so the names are
defined in exactly one place — docs/OBSERVABILITY.md mirrors this):

=============================================  =========  ==========
name                                           type       labels
=============================================  =========  ==========
paddle_request_ttft_seconds                    histogram  —
paddle_request_tpot_seconds                    histogram  —
paddle_request_queue_wait_seconds              histogram  —
paddle_request_e2e_seconds                     histogram  —
paddle_decode_step_seconds                     histogram  —
paddle_prefill_chunk_tokens                    histogram  —
paddle_prefix_cached_tokens                    histogram  —
paddle_prefix_cache_page_hits_total            counter    —
paddle_prefix_cache_page_misses_total          counter    —
paddle_prefix_cache_evictions_total            counter    —
paddle_prefix_cached_pages                     gauge      engine
paddle_kv_free_pages                           gauge      engine
paddle_kv_pool_utilization                     gauge      engine
paddle_slot_occupancy                          gauge      engine
paddle_spec_last_step_accepted_tokens          gauge      engine
paddle_requests_enqueued_total                 counter    —
paddle_requests_finished_total                 counter    reason
paddle_queue_depth                             gauge      engine
paddle_queue_oldest_age_seconds                gauge      engine
paddle_sched_preemptions_total                 counter    —
paddle_sched_deadline_expired_total            counter    —
paddle_sched_slo_violations_total              counter    kind
paddle_faults_injected_total                   counter    site
paddle_step_retries_total                      counter    —
paddle_recoveries_total                        counter    —
paddle_degraded_mode                           gauge      engine, mode
paddle_step_phase_seconds                      histogram  phase
paddle_engine_tokens_per_second                gauge      engine
paddle_engine_goodput                          gauge      engine
paddle_slo_burn                                gauge      engine, kind
paddle_slo_burn_exceeded_total                 counter    kind
paddle_flight_dumps_total                      counter    reason
paddle_kv_quant_pages_total                    counter    —
paddle_kv_quant_refolds_total                  counter    —
paddle_kv_quant_bytes_per_token                gauge      engine
paddle_weight_quant_saved_bytes                gauge      engine
paddle_step_cost_error_ratio                   gauge      fn
paddle_phase_mfu                               gauge      phase
paddle_phase_hbm_util                          gauge      phase
paddle_hbm_ledger_bytes                        gauge      engine, category
paddle_hbm_ledger_unattributed_bytes           gauge      engine
paddle_capacity_headroom_slots                 gauge      engine
paddle_alerts_firing                           gauge      engine, rule, severity
paddle_alert_transitions_total                 counter    rule, state
paddle_executable_device_seconds               gauge      fn
paddle_host_overhead_ratio                     gauge      engine
paddle_phase_mfu_measured                      gauge      phase
paddle_mfu_drift                               gauge      phase
paddle_collective_bytes                        gauge      fn
paddle_chip_skew_seconds                       gauge      engine
paddle_trace_spans_dropped_total               counter    —
paddle_fleet_replicas_ready                    gauge      —
paddle_fleet_affinity_hits_total               counter    replica
paddle_fleet_affinity_misses_total             counter    replica
paddle_fleet_failovers_total                   counter    —
paddle_fleet_failover_seconds                  gauge      —
paddle_fleet_poll_rtt_seconds                  gauge      replica
=============================================  =========  ==========

plus the view ``paddle_decode_*`` (every `decode_stats` key).  The JAX
package's ``paddle_dispatch_*`` view waits for the eager slice.
"""
from __future__ import annotations

from .metrics import (  # noqa: F401
    DEFAULT_TIME_BUCKETS, LOCK, Counter, Gauge, Histogram,
    MetricRegistry, Sample, default_registry, disable, enable, enabled,
    log_buckets,
)
from .tracing import (  # noqa: F401
    HOST_TRACK, clear_spans, dropped_span_count, export_chrome_trace,
    merged_chrome_trace, now_ns, record_span, span, span_count, spans,
)
from .reporter import (  # noqa: F401
    maybe_start_reporter, reporter_running, start_reporter, stop_reporter,
)

__all__ = [
    "registry", "counter", "gauge", "histogram", "snapshot",
    "prometheus_text", "reset", "enable", "disable", "enabled",
    "LOCK", "Counter", "Gauge", "Histogram", "MetricRegistry",
    "DEFAULT_TIME_BUCKETS", "log_buckets", "default_registry",
    "record_span", "span", "spans", "clear_spans", "span_count",
    "merged_chrome_trace", "export_chrome_trace", "now_ns", "HOST_TRACK",
    "start_reporter", "stop_reporter", "reporter_running",
    "maybe_start_reporter",
]

registry = default_registry()


def counter(name, help="", labels=()) -> Counter:
    return registry.counter(name, help, labels)


def gauge(name, help="", labels=()) -> Gauge:
    return registry.gauge(name, help, labels)


def histogram(name, help="", labels=(), buckets=None) -> Histogram:
    return registry.histogram(name, help, labels, buckets=buckets)


def snapshot() -> dict:
    return registry.snapshot()


def prometheus_text() -> str:
    return registry.prometheus_text()


def reset():
    """Zero every first-class series (views keep their own reset APIs;
    the span buffer is cleared separately via `clear_spans`)."""
    registry.reset()


# ---------------------------------------------------------------------------
# First-class serving metrics (instrumented by inference.serving /
# inference.speculative; defined here so the catalog lives in one place)
# ---------------------------------------------------------------------------
REQUEST_TTFT = histogram(
    "paddle_request_ttft_seconds",
    "Time to first token: request enqueue -> first sampled token "
    "(includes queue wait + prefill)")
REQUEST_TPOT = histogram(
    "paddle_request_tpot_seconds",
    "Time per output token after the first: (finish - first token) / "
    "(tokens - 1); requests emitting one token record nothing")
REQUEST_QUEUE_WAIT = histogram(
    "paddle_request_queue_wait_seconds",
    "Time a request waited in the admission queue before its slot")
REQUEST_E2E = histogram(
    "paddle_request_e2e_seconds",
    "End-to-end request latency: enqueue -> finish")
STEP_SECONDS = histogram(
    "paddle_decode_step_seconds",
    "Wall time of one batched decode step (speculative: one "
    "propose->verify->accept round; chunked prefill: one mixed "
    "prefill+decode step)")
PREFILL_CHUNK_TOKENS = histogram(
    "paddle_prefill_chunk_tokens",
    "Prompt tokens a prefilling slot consumed in one mixed step "
    "(FLAGS_chunked_prefill / FLAGS_prefill_chunk_tokens); one "
    "observation per slot per chunk",
    buckets=log_buckets(1, 2.0, 13))  # 1 .. 4096 tokens
PREFIX_CACHED_TOKENS = histogram(
    "paddle_prefix_cached_tokens",
    "Prompt tokens a request skipped prefilling because its page-"
    "aligned prefix was served from the content-addressed KV cache "
    "(FLAGS_prefix_cache); one observation per chunked admission, "
    "0 on a full miss",
    buckets=log_buckets(1, 2.0, 13))  # 1 .. 4096 tokens
PREFIX_HITS = counter(
    "paddle_prefix_cache_page_hits_total",
    "KV pages mapped from the prefix cache at admission "
    "(refcount+1, no prefill compute)")
PREFIX_MISSES = counter(
    "paddle_prefix_cache_page_misses_total",
    "Probe-eligible full prompt pages NOT served from the prefix "
    "cache (computed fresh, then registered)")
PREFIX_EVICTIONS = counter(
    "paddle_prefix_cache_evictions_total",
    "Unreferenced cached pages recycled (LRU order) because the "
    "free list ran dry")
PREFIX_CACHED_PAGES = gauge(
    "paddle_prefix_cached_pages",
    "Content-addressed pages resident in the KV pool (referenced + "
    "retained) as of the engine's most recent step",
    labels=("engine",))
KV_FREE_PAGES = gauge(
    "paddle_kv_free_pages",
    "KV page-pool free pages as of the engine's most recent step",
    labels=("engine",))
KV_UTIL = gauge(
    "paddle_kv_pool_utilization",
    "KV page-pool used fraction as of the engine's most recent step",
    labels=("engine",))
SLOT_OCCUPANCY = gauge(
    "paddle_slot_occupancy",
    "Active-slot fraction of the engine's most recent step",
    labels=("engine",))
SPEC_ACCEPTED_LAST = gauge(
    "paddle_spec_last_step_accepted_tokens",
    "Tokens emitted by the engine's most recent speculative verify "
    "step (accepted drafts + bonus/correction, summed over slots)",
    labels=("engine",))
REQUESTS_ENQUEUED = counter(
    "paddle_requests_enqueued_total",
    "Requests ever accepted by DecodeEngine.add_request")
REQUESTS_FINISHED = counter(
    "paddle_requests_finished_total",
    "Requests that left an engine, by finish reason",
    labels=("reason",))
QUEUE_DEPTH = gauge(
    "paddle_queue_depth",
    "Requests waiting in the admission queue after the engine's most "
    "recent between-steps admission pass — the direct admission-"
    "pressure reading (previously only derivable from queued spans)",
    labels=("engine",))
QUEUE_OLDEST_AGE = gauge(
    "paddle_queue_oldest_age_seconds",
    "Age of the oldest still-queued request (now - enqueue) as of the "
    "engine's most recent step; 0 when the queue is empty",
    labels=("engine",))
SCHED_PREEMPTIONS = counter(
    "paddle_sched_preemptions_total",
    "Running requests preempted by the scheduler (slot and pages "
    "released between steps, re-enqueued for resume via the prefix "
    "cache)")
SCHED_DEADLINE_EXPIRED = counter(
    "paddle_sched_deadline_expired_total",
    "Still-queued requests retired because their deadline_ms passed "
    "before admission (finish_reason=\"deadline\"; no slot ever taken)")
SCHED_SLO_VIOLATIONS = counter(
    "paddle_sched_slo_violations_total",
    "Declared per-request latency targets missed, by kind (ttft | "
    "tpot | deadline); accounting only — a violating request is never "
    "aborted",
    labels=("kind",))
FAULTS_INJECTED = counter(
    "paddle_faults_injected_total",
    "Faults the FLAGS_fault_inject harness fired, by site (step | "
    "mixed_step | decode_step | verify | drafter | pool | nan_logits "
    "| slow_step | host_callback) — deterministic occurrence-count "
    "schedules, see docs/RELIABILITY.md",
    labels=("site",))
STEP_RETRIES = counter(
    "paddle_step_retries_total",
    "Same-step retries of a failed step executable "
    "(FLAGS_step_retries; capped exponential backoff in "
    "deterministic ticks) before containment escalates")
RECOVERIES = counter(
    "paddle_recoveries_total",
    "Engine rebuilds after a fatal step fault "
    "(inference.resilience.recover): every in-flight request "
    "re-admitted with its generated tokens folded into the replay "
    "prompt — already-emitted tokens are never re-emitted")
DEGRADED_MODE = gauge(
    "paddle_degraded_mode",
    "1 while the engine serves with a subsystem degraded away, by "
    "mode (spec_off: speculation disabled after repeated "
    "drafter/verify faults; legacy_prefill: mixed-step faults forced "
    "the fall back to the one-shot prefill oracle path); 0 after the "
    "re-enable probe (FLAGS_degraded_probe_steps) restores it",
    labels=("engine", "mode"))
ENGINE_HEALTH = gauge(
    "paddle_engine_health",
    "One-hot engine health state (exactly one state label reads 1 per "
    "engine): live (serving normally), degraded (a subsystem is "
    "degraded away — mirrors paddle_degraded_mode), recovering (an "
    "engine rebuild is re-admitting this engine's requests), hung "
    "(the step watchdog classified a stalled step; the supervisor is "
    "expected to abandon and rebuild).  Transitions also land as "
    "health:* engine spans so the sequence is reconstructable",
    labels=("engine", "state"))
RECOVERY_SECONDS = histogram(
    "paddle_recovery_seconds",
    "Wall time of one engine recovery (inference.resilience.recover): "
    "rebuild + re-admission, executable handoff included when the "
    "config fingerprints matched — the latency a fatal fault adds "
    "before the engine serves again")
STEP_PHASE_SECONDS = histogram(
    "paddle_step_phase_seconds",
    "Per-step wall time attributed to one serve-loop phase "
    "(observability.flight.PHASES: admit | prefill | mixed | decode | "
    "draft | verify | fetch | emit | cache) — host timers around the "
    "existing sites, one observation per phase per engine step; "
    "composite host phases (admit/draft/emit) are EXCLUSIVE of the "
    "leaf phases nested inside them, so the phases of a step sum to "
    "~its paddle_decode_step_seconds wall",
    labels=("phase",))
ENGINE_TOKENS_PER_SECOND = gauge(
    "paddle_engine_tokens_per_second",
    "Generated tokens per second over the engine's flight-recorder "
    "window (FLAGS_flight_window recent steps) — the live throughput "
    "reading a fleet router load-balances on",
    labels=("engine",))
ENGINE_GOODPUT = gauge(
    "paddle_engine_goodput",
    "Fraction of this engine's finished requests that completed "
    "normally (eos|length) with every declared SLO met "
    "(Request.slo_met), cumulative over the engine's life — the "
    "per-engine version of the goodput number tools/bench_slo.py "
    "reports",
    labels=("engine",))
SLO_BURN = gauge(
    "paddle_slo_burn",
    "Worst per-request SLO budget burn among this engine's live "
    "(queued + running) requests, by kind (ttft: elapsed since "
    "enqueue / slo_ttft_ms while the first token is pending; tpot: "
    "observed per-token latency / slo_tpot_ms; deadline: elapsed / "
    "deadline budget).  1.0 = the budget is spent; a router admitting "
    "against latency budgets reads this before routing more work here",
    labels=("engine", "kind"))
SLO_BURN_EXCEEDED = counter(
    "paddle_slo_burn_exceeded_total",
    "Requests whose SLO budget burn crossed 1.0 while still live, by "
    "kind (counted once per request per kind, BEFORE finish — the "
    "leading indicator paddle_sched_slo_violations_total confirms at "
    "finish time)",
    labels=("kind",))
KV_QUANT_PAGES = counter(
    "paddle_kv_quant_pages_total",
    "KV pages that entered quantized int8 service (FLAGS_kv_quant): "
    "their per-page, per-head quant scales were (re)initialized when "
    "the allocator handed them out — counts target-pool and shared "
    "draft-pool entry together (the allocation is shared)")
KV_QUANT_REFOLDS = counter(
    "paddle_kv_quant_refolds_total",
    "Quant-scale refolds on the write path (FLAGS_kv_quant=int8): "
    "(page, head, K-or-V) scale entries whose running absmax grew "
    "past an established value, re-quantizing that page's existing "
    "rows in-graph.  A refold-heavy serve is quantizing "
    "high-dynamic-range activations — the signal to revisit scale "
    "granularity before trusting the quality gate")
KV_QUANT_BYTES_PER_TOKEN = gauge(
    "paddle_kv_quant_bytes_per_token",
    "KV-pool storage bytes per cached token (payload + quant-scale "
    "overhead, both K and V, summed over layers/heads) as of the "
    "engine's most recent step — the density lever FLAGS_kv_quant "
    "halves/quarters; int8 and fp32 engines serving side by side "
    "read their true relative footprint here",
    labels=("engine",))
WEIGHT_QUANT_SAVED_BYTES = gauge(
    "paddle_weight_quant_saved_bytes",
    "HBM bytes the serve_weights=int8 fold reclaimed on this engine "
    "(f32 matmul-weight storage replaced by int8 + per-out-channel "
    "f32 scales, net of the scale leaves; drafter weights fold into "
    "the same engine's gauge at bind) — also the per-STEP weight "
    "traffic the fold removes from the bandwidth-bound decode path, "
    "since every step streams every weight once.  0 on serve_weights="
    "off engines",
    labels=("engine",))
STEP_COST_ERROR = gauge(
    "paddle_step_cost_error_ratio",
    "EWMA of |predicted - actual| / actual step wall time, per step-"
    "executable kind (fn: decode | mixed | spec) — the cost "
    "observatory's (observability.costmodel) calibration-drift "
    "signal.  After warmup this should sit well under 0.25 (the "
    "bench gate); a sustained rise means the static profiles or the "
    "roofline peaks no longer describe the hardware the engine is "
    "actually running on",
    labels=("fn",))
PHASE_MFU = gauge(
    "paddle_phase_mfu",
    "Model FLOP utilization of the engine's most recent step, per "
    "device phase (decode | mixed | verify): the phase executable's "
    "counted FLOP count / (measured phase wall + the step's fetch "
    "wait) / peak FLOP/s (FLAGS_peak_flops, autodetected by "
    "default).  The roofline's "
    "compute axis — compare against paddle_phase_hbm_util to see "
    "which ceiling binds",
    labels=("phase",))
PHASE_HBM_UTIL = gauge(
    "paddle_phase_hbm_util",
    "HBM bandwidth utilization of the engine's most recent step, per "
    "device phase (decode | mixed | verify): analytical bytes "
    "accessed / (measured phase wall + the step's fetch wait) / peak "
    "bytes-per-second "
    "(FLAGS_peak_hbm_gbps, autodetected by default).  Serving decode "
    "is expected to be bandwidth-bound: this axis near its ceiling "
    "with paddle_phase_mfu low is the healthy signature",
    labels=("phase",))
HBM_LEDGER = gauge(
    "paddle_hbm_ledger_bytes",
    "Live device bytes attributed to one ledger category (weights | "
    "kv_pages | kv_scales | draft_pool | temp_scratch | misc) as of "
    "the engine's most recent audit (FLAGS_cost_ledger_interval_"
    "steps).  temp_scratch is the engine's CUDA-graph pool, reported "
    "beside — not inside — the allocator reconciliation",
    labels=("engine", "category"))
HBM_UNATTRIBUTED = gauge(
    "paddle_hbm_ledger_unattributed_bytes",
    "Live device bytes NO ledger category claims as of the engine's "
    "most recent audit — another engine's arrays, leaked "
    "temporaries, or a category the ledger forgot.  Reconciled "
    "against torch.cuda.memory_allocated() at every audit on the "
    "card so untracked bytes are an alertable gauge instead of "
    "silent drift (never set on the CPU: not measured)",
    labels=("engine",))
CAPACITY_HEADROOM = gauge(
    "paddle_capacity_headroom_slots",
    "Admissible EXTRA slots right now given predicted step cost and "
    "the pool's reclaimable bytes (observability.costmodel."
    "CostModel.headroom): min of free slots, pool-page capacity at "
    "the running requests' mean page need, and the SLO ceiling "
    "(0 while the predicted step cost exceeds the tightest declared "
    "slo_tpot_ms) — the admission number a fleet router reads before "
    "routing more work here",
    labels=("engine",))
ALERTS_FIRING = gauge(
    "paddle_alerts_firing",
    "1 while the named alert rule (observability.alerts; the shipped "
    "catalog is in docs/OBSERVABILITY.md) is FIRING on this engine, "
    "0 after it resolves — transitions require the rule's for-"
    "duration to fire and clean windows to resolve, so this gauge is "
    "the debounced, actionable form of the raw signal it watches.  "
    "/readyz (observability.opsserver) flips an engine NOT-ready "
    "while any severity=page rule fires",
    labels=("engine", "rule", "severity"))
ALERT_TRANSITIONS = counter(
    "paddle_alert_transitions_total",
    "Alert state edges, by rule and edge (firing: the rule's "
    "condition held past its for-duration; resolved: the shortest "
    "window read clean past the rule's resolve duration).  Every "
    "transition also lands as an alert_fire/alert_resolve event in "
    "the engine's flight ring and in /alertz's recent-transitions "
    "list",
    labels=("rule", "state"))
EXEC_DEVICE_SECONDS = gauge(
    "paddle_executable_device_seconds",
    "MEASURED device seconds of one step executable's most recent "
    "probed dispatch (observability.profiling, FLAGS_profile: CUDA "
    "events around the step's graph replay every "
    "FLAGS_profile_sample_steps-th step and every step of an armed "
    "capture), by DISPATCHED executable kind (decode | mixed | "
    "verify — not the flight phase: a chunkless full mixed step "
    "dispatches the mixed program under the decode phase) — the "
    "actual-device-time half the cost observatory's static profiles "
    "predict against",
    labels=("fn",))
HOST_OVERHEAD_RATIO = gauge(
    "paddle_host_overhead_ratio",
    "Fraction of the most recent PROBED step's wall the probed "
    "executables were NOT executing (step wall minus measured device "
    "seconds, over step wall): host dispatch, the emit loop, cache "
    "bookkeeping — a rising ratio at fixed batch shape means the "
    "host is starving the device.  Probe coverage is the decode / "
    "mixed / verify executables: on a speculative engine the "
    "drafter's propose loop counts on the HOST side of this split",
    labels=("engine",))
PHASE_MFU_MEASURED = gauge(
    "paddle_phase_mfu_measured",
    "MEASURED model FLOP utilization of the most recent probed step "
    "per dispatched executable kind (decode | mixed | verify; label "
    "kept as `phase` beside paddle_phase_mfu): profile FLOPs / "
    "measured device seconds / peak FLOP/s — the device-time twin of "
    "the roofline paddle_phase_mfu (which divides by the host-timed "
    "phase wall)",
    labels=("phase",))
MFU_DRIFT = gauge(
    "paddle_mfu_drift",
    "Predicted-vs-measured DEVICE-time drift per dispatched "
    "executable kind (decode | mixed | verify): EWMA of "
    "|predicted - measured| / measured device seconds, where the "
    "prediction is the executable's raw roofline seconds times a "
    "per-phase factor learned from earlier probes (the cost "
    "observatory's EWMA scheme at device granularity; compile-"
    "bearing steps never calibrate).  Sustained drift past the 50% "
    "gate fires the mfu_regression alert rule — the static profiles "
    "no longer describe what the device actually does (a regime "
    "change relearns in tens of probes; the fire marks the change)",
    labels=("phase",))
COLLECTIVE_BYTES = gauge(
    "paddle_collective_bytes",
    "Interconnect bytes ONE invocation of a sharded step moves through "
    "collectives (FLAGS_serve_mesh: two all-reduces a block of the "
    "step's [rows, hidden] activations, and the int8 refold count; "
    "counted from the step's shapes by parallel.partition."
    "collective_bytes at its first call, by _StepGraph site) — the "
    "numerator of the cost observatory's interconnect roofline term "
    "(FLAGS_peak_ici_gbps).  An unsharded engine never emits this "
    "series",
    labels=("fn",))
CHIP_SKEW = gauge(
    "paddle_chip_skew_seconds",
    "Per-rank completion skew of the most recent probed sharded step "
    "(observability.profiling under FLAGS_serve_mesh: each rank stamps "
    "the host's monotonic clock when its step's output is complete, "
    "and the skew is max minus min) — sustained skew means one rank is "
    "the straggler every step and the mesh runs at its pace.  Absent "
    "on unsharded engines",
    labels=("engine",))
TRACE_SPANS_DROPPED = counter(
    "paddle_trace_spans_dropped_total",
    "Spans the tracing buffer (observability.tracing) refused past "
    "its MAX_SPANS cap — previously only visible via "
    "tracing.dropped_span_count(); a nonzero counter means the "
    "merged chrome trace (and /tracez) is missing the tail of the "
    "timeline")
FLIGHT_DUMPS = counter(
    "paddle_flight_dumps_total",
    "Flight-recorder windows auto-dumped to FLAGS_flight_dir, by "
    "reason (fault: a fatal StepFault/HungStep escaped the step; "
    "abandoned: the frontend watchdog abandoned a hung worker; "
    "manual: FlightRecorder.dump called directly) — every chaos/"
    "recovery event leaves a black box tools/explain_request.py reads",
    labels=("reason",))
FLEET_REPLICAS_READY = gauge(
    "paddle_fleet_replicas_ready",
    "Replicas the fleet router's last poll found ready to take "
    "traffic (fleet.FleetRouter: the replica's /readyz verdict — "
    "serving AND headroom > 0 AND no page-severity alert AND no "
    "watchdog-overdue step).  Dropping below the replica count means "
    "part of the fleet is draining/dead; zero means the edge is "
    "queueing everything")
FLEET_AFFINITY_HITS = counter(
    "paddle_fleet_affinity_hits_total",
    "Requests the fleet router placed on the replica its prefix "
    "routing key (the engine's content-addressed page chain hashes) "
    "already mapped to — the request lands where its prompt-prefix "
    "KV pages are cached",
    labels=("replica",))
FLEET_AFFINITY_MISSES = counter(
    "paddle_fleet_affinity_misses_total",
    "Requests the fleet router placed fresh (no admissible replica "
    "held the routing key): cold prefixes, round-robin policy, or "
    "the affinity target was not admissible at routing time",
    labels=("replica",))
FLEET_FAILOVERS = counter(
    "paddle_fleet_failovers_total",
    "Dead-replica failovers the fleet router completed: the dead "
    "replica's journal replayed into a survivor "
    "(durability.adopt_from_dir) with every in-flight stream resumed "
    "token-for-token")
FLEET_FAILOVER_SECONDS = gauge(
    "paddle_fleet_failover_seconds",
    "Wall seconds of the most recent fleet failover, death detection "
    "through journal adoption on the survivor (streams reconnect "
    "immediately after)")
FLEET_POLL_RTT = gauge(
    "paddle_fleet_poll_rtt_seconds",
    "Measured HTTP round-trip of the fleet router's most recent "
    "/readyz poll, per replica (fleet.ReplicaHandle.poll) — the "
    "router's only per-replica latency signal, and the error bound "
    "(rtt/2) on the NTP-style clock-offset estimate the fleet trace "
    "merge maps replica timestamps with "
    "(observability.fleettrace.ClockSync)",
    labels=("replica",))


# ---------------------------------------------------------------------------
# The decode_stats view
# ---------------------------------------------------------------------------
def _decode_view():
    """decode_stats as registry series.  Goes through
    `profiler.decode_stats`, so an engine-less process renders zeros
    WITHOUT importing the serving module."""
    from .. import profiler

    st = profiler.decode_stats()
    samples = []
    for k in profiler.DECODE_STAT_COUNTERS:
        v = st[k]
        if k.endswith("_s"):
            samples.append(Sample(f"paddle_decode_{k[:-2]}_seconds_total",
                                  "counter", "", (), [((), v)]))
        elif k.endswith("_sum"):
            samples.append(Sample(f"paddle_decode_{k}", "gauge", "", (),
                                  [((), v)]))
        else:
            samples.append(Sample(f"paddle_decode_{k}_total", "counter",
                                  "", (), [((), v)]))
    for k in profiler.DECODE_STAT_DERIVED:
        samples.append(Sample(f"paddle_decode_{k}", "gauge", "", (),
                              [((), st[k])]))
    return samples


registry.register_view(_decode_view)


# ---------------------------------------------------------------------------
# The ops plane (imported LAST: both modules resolve this catalog
# lazily, so the import is cycle-free and costs only stdlib imports)
# ---------------------------------------------------------------------------
from . import alerts  # noqa: E402,F401
from . import costmodel  # noqa: E402,F401
from . import flight  # noqa: E402,F401
from . import opsserver  # noqa: E402,F401
from . import profiling  # noqa: E402,F401
from .alerts import AlertEngine, AlertRule, default_rules  # noqa: E402,F401
from .opsserver import (  # noqa: E402,F401
    maybe_start_ops_server, ops_server_port, start_ops_server,
    stop_ops_server,
)
from .profiling import (  # noqa: E402,F401
    capture_status, hot_op_table, request_capture,
)

__all__ += [
    "alerts", "costmodel", "flight", "opsserver", "AlertEngine", "AlertRule", "default_rules",
    "start_ops_server", "stop_ops_server", "ops_server_port",
    "maybe_start_ops_server",
    "profiling", "request_capture", "capture_status", "hot_op_table",
]
