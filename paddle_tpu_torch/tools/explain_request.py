"""Explain one request's life from flight records (+ optional spans)
(counterpart: tools/explain_request.py of the JAX package, copied, not
imported: stdlib only, and the same output for the same window).

The operator-facing answer to "why was this request slow" AFTER the
fact: given a flight-recorder window — a live `FlightRecorder
.snapshot()`, a crash auto-dump from ``FLAGS_flight_dir``, or the
``telemetry_flight.json`` that `paddle_tpu_torch.tools.telemetry_dump` emits — this
reconstructs a single request's timeline step by step:

* which steps carried it, in which phase (prefill chunks vs decode),
  and how many tokens each step emitted for it;
* the step's phase-time breakdown (where the wall actually went:
  admit / prefill / mixed / decode / draft / verify / fetch / emit /
  cache);
* the cost observatory's predicted-vs-actual step cost
  (``pred=X/act=Yms``) when the window carries cost records
  (FLAGS_cost_model — a step whose actual ran far past its prediction
  is where to start digging);
* the profiling plane's measured device/host split (``dev=X/host=Yms``)
  when the window carries probe records (FLAGS_profile — a step whose
  host half dominates is dispatch-bound, not device-bound);
* its SLO burn as it evolved (budget consumed vs slo_ttft_ms /
  slo_tpot_ms / deadline_ms);
* every ladder event that touched it or its engine — retry, degrade,
  preempt/resume, quarantine, recovery, restore, fault, abandon;
* its terminal state (finish reason).

With ``--trace`` (a merged chrome-trace JSON) the request's lifecycle
spans (queued / prefill / decode) are appended so the flight window's
step-level view and the span-level view line up on one report.

With ``--trace-id`` (FLAGS_fleet_trace; docs/FLEET_TRACING.md) the
report joins **multiple** flight windows — the dead donor's crash
dump and the adopting survivor's window — into one request story:
each window's slots are matched on their ``"trace"`` field, so a
request killed on one replica and finished on another reads as one
timeline, replica-labelled per line.

Usage:
    python -m paddle_tpu_torch.tools.explain_request FLIGHT.json
        --request ID [--trace TRACE.json] [--all]
    python -m paddle_tpu_torch.tools.explain_request DONOR.json
        ADOPTER.json --trace-id ID [--trace TRACE.json]

``--all`` lists every request id seen in the window (discovery mode).
`explain(window, request_id)` and `explain_trace(windows, trace_id)`
are the library entries the benches and tests call in-process.
"""
import argparse
import json
import os
import sys
from typing import List, Optional


def request_ids(window: dict) -> List[int]:
    """Every request id the window saw (slots, emissions, events,
    finishes)."""
    ids = set()
    for rec in window.get("records", []):
        for s in rec.get("slots", []):
            ids.add(int(s["request"]))
        for rid in rec.get("emitted", {}):
            ids.add(int(rid))
        for rid, _reason in rec.get("finished", []):
            ids.add(int(rid))
        for ev in rec.get("events", []):
            if "request" in ev:
                ids.add(int(ev["request"]))
    return sorted(ids)


def _fmt_phases(phases: dict) -> str:
    if not phases:
        return ""
    return " | " + " ".join(
        f"{k}={v * 1e3:.2f}ms" for k, v in
        sorted(phases.items(), key=lambda kv: -kv[1]))


def explain(window: dict, request_id: int,
            spans: Optional[list] = None) -> List[str]:
    """Render one request's timeline from a flight window dict;
    returns the report lines (empty `records` yields a header only)."""
    rid = int(request_id)
    lines = [
        f"request {rid} — engine {window.get('engine')}"
        + (f" — dump reason: {window['reason']}"
           if window.get("reason") else "")
    ]
    seen = False
    for rec in window.get("records", []):
        step = rec.get("step")
        slot_entry = next((s for s in rec.get("slots", [])
                           if int(s["request"]) == rid), None)
        emitted = int(rec.get("emitted", {}).get(str(rid),
                      rec.get("emitted", {}).get(rid, 0)))
        finish = next((reason for r, reason in rec.get("finished", [])
                       if int(r) == rid), None)
        events = [ev for ev in rec.get("events", [])
                  if ev.get("request") is None
                  or int(ev.get("request")) == rid]
        burn = (rec.get("burn") or {}).get(str(rid),
                                           (rec.get("burn") or {})
                                           .get(rid))
        touches = slot_entry is not None or emitted or finish or \
            any("request" in ev for ev in events)
        if not touches and not (seen and events):
            continue
        seen = seen or touches
        parts = [f"  step {step}"]
        if rec.get("kind") == "event":
            parts.append("(between steps)")
        else:
            parts.append(f"{rec.get('dur_s', 0) * 1e3:8.2f}ms")
        if slot_entry is not None:
            if slot_entry["phase"] == "prefill":
                parts.append(
                    f"prefill slot {slot_entry['slot']} "
                    f"{slot_entry['prefill_pos']}/"
                    f"{slot_entry['prompt_len']} prompt tokens")
            else:
                parts.append(
                    f"decode  slot {slot_entry['slot']} "
                    f"out {slot_entry['out']}")
        if emitted:
            parts.append(f"+{emitted} tok")
        if burn:
            parts.append("burn " + ",".join(
                f"{k}={v:.2f}" for k, v in sorted(burn.items())))
        cost = rec.get("cost")
        if cost and cost.get("actual_s") is not None and \
                (slot_entry is not None or emitted):
            parts.append(
                f"pred={cost.get('predicted_s', 0) * 1e3:.2f}"
                f"/act={cost['actual_s'] * 1e3:.2f}ms")
        probe = rec.get("probe")
        if probe and probe.get("device_s") is not None and \
                (slot_entry is not None or emitted):
            # the profiling plane's measured split (same pattern as
            # the pred=/act= column): device-executing vs host wall
            parts.append(
                f"dev={probe['device_s'] * 1e3:.2f}"
                f"/host={probe.get('host_s', 0) * 1e3:.2f}ms")
        line = " ".join(parts)
        if slot_entry is not None or emitted:
            line += _fmt_phases(rec.get("phases", {}))
        lines.append(line)
        for ev in events:
            tag = " ".join(f"{k}={v}" for k, v in ev.items()
                           if k != "kind")
            lines.append(f"    !! {ev['kind']}" + (f" ({tag})"
                                                   if tag else ""))
        if finish:
            lines.append(f"    -> finished: {finish}")
    if not seen:
        lines.append("  (not seen in this flight window)")
    if spans:
        lines.append("  spans:")
        for ev in spans:
            if ev.get("ph") != "X" or ev.get("tid") != rid:
                continue
            if ev.get("name") not in ("queued", "prefill", "decode",
                                      "preempted"):
                continue
            args = ev.get("args") or {}
            if args.get("request") not in (None, rid):
                continue
            lines.append(
                f"    {ev['name']:<10} {ev.get('dur', 0) / 1e3:9.3f}ms"
                + (f"  {args}" if args else ""))
    return lines


def trace_requests(window: dict, trace_id: str) -> List[int]:
    """Request ids whose flight slots carry this fleet trace id."""
    ids = set()
    for rec in window.get("records", []):
        for s in rec.get("slots", []):
            if s.get("trace") == trace_id:
                ids.add(int(s["request"]))
    return sorted(ids)


def explain_trace(windows, trace_id: str,
                  spans: Optional[list] = None) -> List[str]:
    """Join donor + adopter flight windows into ONE request story by
    fleet trace id (FLAGS_fleet_trace; docs/FLEET_TRACING.md).

    ``windows`` is a sequence of ``(label, window-dict)``.  Each
    window's slot records are matched on their ``"trace"`` field (the
    adopter admits the request under a FRESH request id, so the trace
    id is the only join key that survives failover); every matching
    request's timeline renders under its window label.  ``spans``
    (optional) is a merged fleet chrome trace's ``traceEvents`` list:
    request-track spans tagged with the trace id are appended,
    replica-attributed."""
    tid = str(trace_id)
    lines = [f"trace {tid}"]
    hits = 0
    for label, window in windows:
        rids = trace_requests(window, tid)
        if not rids:
            lines.append(f"[{label}] (trace not seen in this window)")
            continue
        for rid in rids:
            hits += 1
            for ln in explain(window, rid):
                lines.append(f"[{label}] {ln}")
    if not hits:
        lines.append("  (trace seen in no flight window)")
    if spans:
        lines.append("spans:")
        for ev in spans:
            if ev.get("ph") != "X":
                continue
            args = ev.get("args") or {}
            if args.get("trace") != tid:
                continue
            lines.append(
                f"  {str(args.get('replica', '?')):<12} "
                f"{ev.get('name', ''):<10} "
                f"{ev.get('dur', 0) / 1e3:9.3f}ms  {args}")
    return lines


def _load_spans(trace_path: str) -> list:
    with open(trace_path) as f:
        return json.load(f).get("traceEvents", [])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("flight", nargs="+",
                    help="flight window JSON(s) (auto-dump or "
                         "telemetry_flight.json); several files + "
                         "--trace-id joins them by fleet trace")
    ap.add_argument("--request", type=int, default=None)
    ap.add_argument("--trace", default=None,
                    help="merged chrome-trace JSON for span alignment")
    ap.add_argument("--trace-id", default=None,
                    help="fleet trace id (FLAGS_fleet_trace): join "
                         "every flight window given — e.g. the dead "
                         "donor's dump and the survivor's — into one "
                         "cross-replica report")
    ap.add_argument("--all", action="store_true",
                    help="list every request id in the window")
    args = ap.parse_args()
    windows = []
    for path in args.flight:
        with open(path) as f:
            windows.append((os.path.basename(path), json.load(f)))
    spans = _load_spans(args.trace) if args.trace else None
    if args.trace_id is not None:
        print("\n".join(explain_trace(windows, args.trace_id,
                                      spans=spans)))
        return 0
    if len(windows) > 1:
        print("explain_request: multiple flight files need --trace-id",
              file=sys.stderr)
        return 2
    window = windows[0][1]
    if args.all or args.request is None:
        ids = request_ids(window)
        print(f"requests in window: {ids}")
        if args.request is None:
            return 0 if args.all else 2
    print("\n".join(explain(window, args.request, spans=spans)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
