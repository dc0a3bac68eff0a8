"""Serving telemetry's schema and its process-wide read (counterpart:
the decode-stats part of paddle_tpu/profiler.py).

`DECODE_STAT_COUNTERS` and `DECODE_STAT_DERIVED` are the JAX package's
keys in its order, copied here: the port imports nothing of that
package.  Counters whose module the port has not brought over yet
(preemption, faults injected, the journal, the flight recorder, the
cost model, profiling) stay 0.  `decode_stats` and `reset_decode_stats`
forward to `paddle_tpu_torch.inference.serving` once it is imported,
and read zeros without importing it.
"""
from __future__ import annotations

import sys

__all__ = ["DECODE_STAT_COUNTERS", "DECODE_STAT_DERIVED", "decode_stats",
           "reset_decode_stats"]

_SERVING = "paddle_tpu_torch.inference.serving"

# Decode-telemetry schema, shared with inference.serving (which builds
# its live counter dict from these).
DECODE_STAT_COUNTERS = (
    "steps", "tokens", "prefills", "decode_time_s", "prefill_time_s",
    "decode_compiles", "prefill_compiles", "retraces_after_warmup",
    "occupancy_sum", "kv_util_sum",
    # chunked prefill (FLAGS_chunked_prefill): prompt chunks fused into
    # the decode step through the mixed-batch executable.
    # ``stalled_decode_steps`` counts legacy one-shot prefills that ran
    # while other slots were decoding (the stall chunking removes) —
    # it must stay 0 on the chunked path.
    "mixed_steps", "mixed_compiles", "prefill_chunks",
    "stalled_decode_steps",
    # prefix caching (FLAGS_prefix_cache): pages mapped from /
    # missing in the content-addressed cache at admission, prompt
    # tokens skipped, and unreferenced cached pages recycled under
    # pool pressure
    "prefix_hits", "prefix_misses", "prefix_cached_tokens",
    "prefix_evictions",
    # speculative decoding (inference.speculative): propose/verify loop
    "spec_steps", "spec_slot_steps", "spec_proposed", "spec_accepted",
    "spec_emitted",
    "draft_time_s", "verify_time_s", "verify_compiles", "draft_compiles",
    # request-completion accounting (Request.finish_reason; "cancelled"
    # counts queued AND running requests removed via Request.cancel())
    "finished_eos", "finished_length", "evicted", "cancelled",
    # SLO-aware scheduling (inference.frontend.SLOScheduler):
    # preempt/resume cycles, still-queued requests retired at their
    # deadline, and declared TTFT/TPOT/deadline targets missed
    "preemptions", "resumes", "deadline_expired", "slo_violations",
    # fault containment + crash recovery (inference.resilience):
    # injected faults fired, same-step retries spent, requests
    # quarantined with finish_reason="fault", engine rebuilds, and
    # degraded-mode transitions (speculation disabled / chunked
    # prefill fallen back to the legacy oracle path)
    "faults_injected", "step_retries", "finished_fault", "recoveries",
    "spec_disables", "legacy_fallbacks",
    # durable serving (inference.durability): write-ahead journal
    # records appended, on-disk snapshots written, fresh-process
    # restores performed, executables handed from a dead engine to its
    # rebuilt successor (recompiles avoided), and steps the watchdog
    # classified as hung (FLAGS_step_timeout_ms)
    "journal_records", "journal_snapshots", "restores", "exec_handoffs",
    "hung_steps",
    # fleet serving (paddle_tpu.fleet): a dead replica's journal
    # replayed into a LIVE survivor engine (zero-loss failover), and
    # journals rewritten down to their live state during restore
    # (FLAGS_journal_compact)
    "adoptions", "journal_compactions",
    # flight recorder (observability.flight): sealed per-step records
    # pushed into the bounded ring, and crash-safe window auto-dumps
    # (fatal fault / hung step / watchdog abandonment black boxes)
    "flight_records", "flight_dumps",
    # quantized KV pages (FLAGS_kv_quant=int8): pages whose quant
    # scale was (re)initialized on allocation ("pages quantized"),
    # (page, head) scale entries re-quantized after an absmax growth
    # (the write-path "refold"), and the tiny scale-reset executable's
    # compiles (target pool + draft pool, one signature each)
    "kv_quant_pages", "kv_quant_refolds", "kv_quant_compiles",
    # quantized weight storage (FLAGS_serve_weights=int8): matmul
    # weight matrices folded to int8 + per-out-channel f32 scales at
    # engine construction / drafter bind ("mats"), and the HBM bytes
    # that fold reclaimed net of the scale leaves it added — both stay
    # 0 on serve_weights=off engines (the off-mode-quiet proof the
    # bench's parity leg pins)
    "weight_quant_mats", "weight_quant_bytes_saved",
    # cost observatory (observability.costmodel): static FLOP/byte
    # profiles extracted at executable compile time, and calibration
    # updates scored against the flight recorder's measured steps
    "cost_profiles", "cost_updates",
    # profiling plane (observability.profiling): steps whose device
    # dispatches were sync-probed (FLAGS_profile_sample_steps cadence
    # or an armed capture), and bounded capture sessions completed
    "profile_probes", "profile_captures",
    # ragged unified step (FLAGS_ragged_step): compiles of the ONE
    # executable that serves decode, mixed prefill+decode, and
    # speculative verify traffic alike (every row carries its own
    # query span), and the adaptive per-slot speculation depth's
    # shrink/grow transitions (FLAGS_spec_adaptive_k)
    "ragged_compiles", "spec_k_shrinks", "spec_k_grows",
    # per-executable retrace attribution: ``retraces_after_warmup``
    # aggregates every site; these split the same events by the
    # tracker's compile_key (<kind>_compiles -> <kind>_retraces), so
    # "the ragged path compiles exactly one step executable and never
    # retraces it" is a counter assertion, not a log grep
    "decode_retraces", "prefill_retraces", "mixed_retraces",
    "verify_retraces", "draft_retraces", "kv_quant_retraces",
    "ragged_retraces",
)
DECODE_STAT_DERIVED = ("avg_step_ms", "batch_occupancy",
                       "kv_block_utilization",
                       "acceptance_rate", "mean_accepted_per_step")



def _decode_stat_zero(key):
    return 0.0 if key.endswith(("_s", "_sum", "_ms")) or \
        key in DECODE_STAT_DERIVED else 0


def decode_stats(reset=False):
    """Serving-loop telemetry (`inference.serving.decode_stats`): step
    latency, batch occupancy, KV-block utilization, step compile and
    retrace counts, process-wide.  All zeros, without importing the
    serving module, when no engine module was ever loaded."""
    mod = sys.modules.get(_SERVING)
    if mod is None:
        return {k: _decode_stat_zero(k)
                for k in DECODE_STAT_COUNTERS + DECODE_STAT_DERIVED}
    return mod.decode_stats(reset)


def reset_decode_stats():
    mod = sys.modules.get(_SERVING)
    if mod is not None:
        mod.reset_decode_stats()
