"""The eager profiler and serving telemetry's schema (counterpart:
paddle_tpu/profiler.py).

Host events: ``RecordEvent(name)`` times a region on
``time.monotonic_ns`` into the host tracer of
`observability.tracing` (the JAX package's is native, in csrc; the
port's is a bounded, lock-guarded Python buffer), between
`start_profiler` and `stop_profiler`.  With the profiler off a
``RecordEvent`` reads one flag and records nothing; it never touches
the device, so a replayed CUDA-graph step gains no host sync.
`summary_string` aggregates the host events in the JAX package's table
(its columns and sort keys), and `export_chrome_tracing` writes them on
the ``host`` track beside the serving spans (``engine``,
``requests``).  The serving steps carry the JAX package's event names:
``serving.mixed_step``, ``serving.decode_step`` and
``serving.spec_verify_step``.

Device trace: `start_trace`/`stop_trace`/`trace` run ``torch.profiler``
(CPU activity, and CUDA activity when a card is present) and write a
chrome trace into ``log_dir``, naming every kernel the card ran.

Dispatch report: ``dispatch_stats``/``dispatch_summary_string`` read
the per-op counts and wall time that ``FLAGS_eager_dispatch_report``
collects (`core.dispatch`).

`DECODE_STAT_COUNTERS` and `DECODE_STAT_DERIVED` are the JAX package's
keys in its order, copied here: the port imports nothing of that
package.  Counters whose module the port has not brought over yet
(preemption, faults injected, the journal, the flight recorder, the
cost model, profiling) stay 0.  `decode_stats` and `reset_decode_stats`
forward to `paddle_tpu_torch.inference.serving` once it is imported,
and read zeros without importing it.
"""
from __future__ import annotations

import contextlib
import os
import sys
import time
from collections import defaultdict

from .core.dispatch import (dispatch_stats, dispatch_summary_string,
                            reset_dispatch_stats)
from .observability import tracing as _tracing

__all__ = ["RecordEvent", "now_ns", "profiler", "start_profiler",
           "stop_profiler", "reset_profiler", "start_trace", "stop_trace",
           "trace", "summary_string", "export_chrome_tracing",
           "dispatch_stats", "dispatch_summary_string",
           "reset_dispatch_stats", "DECODE_STAT_COUNTERS",
           "DECODE_STAT_DERIVED", "decode_stats", "reset_decode_stats"]

now_ns = time.monotonic_ns
_HOST = _tracing.HOST_TRACER


class RecordEvent:
    """A timed host region: ``with RecordEvent(name): ...`` or
    ``begin()``/``end()``.  Recorded only while the profiler is on."""

    __slots__ = ("name", "_t0")

    def __init__(self, name: str):
        self.name = name
        self._t0 = None

    def __enter__(self):
        if _HOST.on:
            self._t0 = now_ns()
        return self

    def __exit__(self, *exc):
        if self._t0 is not None:
            _tracing.host_record(self.name, self._t0, now_ns() - self._t0)
            self._t0 = None
        return False

    def begin(self):
        self.__enter__()

    def end(self):
        self.__exit__(None, None, None)


def start_profiler(state="All", tracer_option="Default"):
    """Clear the host events and start recording them.  ``state`` and
    ``tracer_option`` are accepted as in the JAX package; the device
    trace is `start_trace`'s."""
    _tracing.clear_host_events()
    _HOST.on = True


def stop_profiler(sorted_key="total", profile_path=None, print_table=True):
    """Stop recording; return the summary table (printed unless
    ``print_table=False``) and, with ``profile_path``, write the merged
    chrome trace there."""
    _HOST.on = False
    text = summary_string(sorted_key=sorted_key)
    if print_table:
        print(text)
    if profile_path:
        export_chrome_tracing(profile_path)
    return text


def reset_profiler():
    _tracing.clear_host_events()


@contextlib.contextmanager
def profiler(state="All", sorted_key="total", profile_path=None):
    start_profiler(state)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)


def summary_string(sorted_key="total") -> str:
    """The host events by name: calls, total/avg/min/max ms and share of
    the total, sorted by ``sorted_key`` (``total``, ``calls``, ``max``,
    ``min``, ``ave``) — the JAX package's table, line for line."""
    agg = defaultdict(lambda: [0, 0.0, float("inf"), 0.0])
    for name, _, dur_ns, _ in _tracing.host_events():
        dur_ms = (dur_ns / 1e3) / 1000.0  # via the trace's us, as JAX
        a = agg[name]
        a[0] += 1
        a[1] += dur_ms
        a[2] = min(a[2], dur_ms)
        a[3] = max(a[3], dur_ms)
    total = sum(a[1] for a in agg.values()) or 1.0
    keyfn = {
        "total": lambda kv: -kv[1][1],
        "calls": lambda kv: -kv[1][0],
        "max": lambda kv: -kv[1][3],
        "min": lambda kv: kv[1][2],
        "ave": lambda kv: -(kv[1][1] / max(kv[1][0], 1)),
    }.get(sorted_key, lambda kv: -kv[1][1])
    lines = [
        "-------------------------     Profiling Report     "
        "-------------------------",
        f"{'Event':<40}{'Calls':>8}{'Total(ms)':>12}{'Avg(ms)':>10}"
        f"{'Min(ms)':>10}{'Max(ms)':>10}{'Ratio':>8}",
    ]
    for name, (n, tot, mn, mx) in sorted(agg.items(), key=keyfn):
        lines.append(
            f"{name:<40}{n:>8}{tot:>12.4f}{tot / max(n, 1):>10.4f}"
            f"{mn if n else 0:>10.4f}{mx:>10.4f}{tot / total:>8.2%}")
    return "\n".join(lines)


def export_chrome_tracing(path: str) -> dict:
    """Write the merged chrome trace: the ``host`` track (pid 0) and
    every span track (``engine``, ``requests``, ``device``)."""
    return _tracing.export_chrome_trace(path)


_device_trace = {"prof": None, "dir": None}


def start_trace(log_dir: str):
    """Start a ``torch.profiler`` trace of the host's ops and, when a card
    is present, of every kernel it runs; `stop_trace` writes it."""
    import torch

    if _device_trace["prof"] is not None:
        raise RuntimeError("a device trace is already running")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    _device_trace.update(prof=prof, dir=log_dir)


def stop_trace():
    """Stop the device trace and write it as ``trace_<pid>_<ns>.json`` in
    its ``log_dir``; returns the path (None when no trace ran)."""
    prof = _device_trace["prof"]
    if prof is None:
        return None
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    log_dir = _device_trace["dir"]
    _device_trace.update(prof=None, dir=None)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{now_ns()}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir: str):
    start_trace(log_dir)
    try:
        yield
    finally:
        stop_trace()

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
