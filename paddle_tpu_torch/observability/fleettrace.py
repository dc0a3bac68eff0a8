"""Fleet-scope distributed tracing: one trace id from router to card
(counterpart: paddle_tpu/observability/fleettrace.py, copied, not
imported).

A request that traverses ``FleetRouter -> EdgeServer -> ServingFrontend
-> engine`` has, by default, no identity that survives the HTTP hop:
the router names streams by its own ids, each replica mints fresh
engine request ids, and a kill -9 failover produces two disconnected
flight records that nothing can join.  This module is the glue:

* **trace ids** — ``mint_trace_id()`` makes a compact random id; the
  router mints one per submitted stream and every HTTP leg (generate /
  adopt / resume) carries it in the ``x-paddle-trace`` header.  The
  edge threads it into the frontend so the engine's request spans and
  flight records tag themselves with it, and the durability journal
  persists it — an adopted request *keeps the donor's trace id*, so
  donor and adopter spans are two segments of one trace.

* **span slicing** — ``span_slice()`` filters the process-local span
  buffer by trace id and/or time window into JSON-ready dicts; each
  edge serves it at ``/tracez/spans``.

* **clock offsets** — replicas run on different hosts-of-record (in
  tests, different processes whose monotonic clocks share no epoch).
  ``ClockSync`` estimates a per-replica offset NTP-style from the
  router's existing ``poll()`` handshake: the replica reports its own
  ``now_ns`` inside the /readyz payload, the router brackets the
  request with its local clock, and ``offset = server - midpoint`` on
  the minimum-RTT sample (lowest queueing noise) maps replica
  timestamps onto the router's timeline.

* **fleet merge** — ``merge_fleet_trace()`` folds per-replica span
  sets into ONE chrome trace: each replica's host/engine/edge tracks
  become per-replica processes (offsets applied), while *request*
  spans from every replica land in a single fleet-wide ``requests``
  process whose lanes (tids) are keyed by trace id — a
  killed-and-adopted request renders as one contiguous lane even
  though its two segments ran in different processes under different
  engine request ids.

Everything here is flag-gated by ``FLAGS_fleet_trace`` (default off =
zero new wire headers, zero new spans, bit-exact serving).
"""
from __future__ import annotations

import binascii
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from ..core import flags as _flags

__all__ = ["TRACE_HEADER", "enabled", "mint_trace_id", "span_slice",
           "ClockSync", "merge_fleet_trace"]

# the wire header carrying the trace id on every fleet HTTP leg
TRACE_HEADER = "x-paddle-trace"

# span tracks whose tid is an engine request id and whose args carry
# the trace tag; these are re-homed onto the fleet-wide lane in the
# merged trace (everything else stays per-replica)
REQUEST_TRACKS = ("requests",)


def enabled() -> bool:
    """True when the fleet-trace plane is armed (FLAGS_fleet_trace)."""
    return bool(_flags.flag("fleet_trace"))


def mint_trace_id() -> str:
    """A compact random trace id (64 bits, hex)."""
    return binascii.hexlify(os.urandom(8)).decode("ascii")


def span_slice(spans: Iterable[tuple], trace: Optional[str] = None,
               since_ns: Optional[int] = None,
               until_ns: Optional[int] = None) -> List[dict]:
    """Filter raw span tuples (`tracing.spans()` layout) into
    JSON-ready dicts, optionally by trace id and/or time window.

    A span matches ``trace`` when its args carry ``{"trace": <id>}``;
    it matches the window when it *overlaps* [since_ns, until_ns].
    """
    out = []
    for track, name, t0, dur, tid, args in spans:
        if trace is not None and (args or {}).get("trace") != trace:
            continue
        if since_ns is not None and t0 + dur < since_ns:
            continue
        if until_ns is not None and t0 > until_ns:
            continue
        rec = {"track": track, "name": name, "start_ns": int(t0),
               "dur_ns": int(dur), "tid": int(tid)}
        if args:
            rec["args"] = args
        out.append(rec)
    return out


class ClockSync:
    """Per-replica clock-offset estimator over poll() handshakes.

    One ``observe()`` per poll: the router brackets the HTTP request
    with its local ``now_ns`` (t0 before send, t1 after receive) and
    the replica reports its own clock (``server_ns``) from inside the
    handler.  Classic NTP estimate::

        offset = server_ns - (t0 + t1) / 2      (replica - router)

    whose error is bounded by rtt/2.  The kept estimate is the one
    from the *minimum-RTT* sample seen so far — low RTT means low
    queueing noise, so it dominates a windowed average for short
    benches while staying O(1) per replica.
    """

    def __init__(self):
        # name -> (best_rtt_ns, offset_ns)
        self._best: Dict[str, Tuple[int, int]] = {}

    def observe(self, name: str, t0_ns: int, t1_ns: int,
                server_ns: int) -> int:
        """Fold one handshake; returns the current offset estimate."""
        rtt = max(0, int(t1_ns) - int(t0_ns))
        offset = int(server_ns) - (int(t0_ns) + int(t1_ns)) // 2
        best = self._best.get(name)
        if best is None or rtt < best[0]:
            self._best[name] = (rtt, offset)
        return self._best[name][1]

    def offset_ns(self, name: str) -> int:
        """replica->router offset for ``name`` (0 if never observed)."""
        best = self._best.get(name)
        return 0 if best is None else best[1]

    def snapshot(self) -> Dict[str, dict]:
        return {name: {"rtt_ns": rtt, "offset_ns": off}
                for name, (rtt, off) in self._best.items()}


def merge_fleet_trace(replica_spans: Dict[str, Sequence[dict]],
                      offsets_ns: Optional[Dict[str, int]] = None) -> dict:
    """Merge per-replica span slices into one chrome trace.

    ``replica_spans`` maps replica name -> span dicts in the
    ``span_slice()`` layout; ``offsets_ns`` maps replica name -> the
    replica->router clock offset (subtracted from each span's start so
    every lane shares the router's timeline).

    Layout: per-replica tracks become processes named
    ``<replica>/<track>`` (one pid each); spans on REQUEST_TRACKS from
    *all* replicas land in one fleet-wide ``requests`` process whose
    tids are assigned per trace id (falling back to per replica+tid
    for untraced spans) — so a request that failed over renders as a
    single contiguous lane.
    """
    offsets_ns = offsets_ns or {}
    events: List[dict] = []
    pids: Dict[str, int] = {}
    req_pid = [None]  # assigned lazily: no requests process unless needed
    lane_ids: Dict[str, int] = {}

    def _pid(label: str) -> int:
        pid = pids.get(label)
        if pid is None:
            pid = pids[label] = len(pids) + 1
            events.append({"ph": "M", "pid": pid, "name": "process_name",
                           "args": {"name": label}})
        return pid

    def _lane(key: str, label: str, pid: int) -> int:
        tid = lane_ids.get(key)
        if tid is None:
            tid = lane_ids[key] = len(lane_ids) + 1
            events.append({"ph": "M", "pid": pid, "tid": tid,
                           "name": "thread_name",
                           "args": {"name": label}})
        return tid

    for replica in sorted(replica_spans):
        off = int(offsets_ns.get(replica, 0))
        for rec in replica_spans[replica]:
            track = rec.get("track", "")
            args = dict(rec.get("args") or {})
            t0 = int(rec["start_ns"]) - off
            ev = {"name": rec["name"], "ph": "X",
                  "ts": t0 / 1e3, "dur": int(rec["dur_ns"]) / 1e3}
            if track in REQUEST_TRACKS:
                if req_pid[0] is None:
                    req_pid[0] = _pid("requests")
                pid = req_pid[0]
                trace = args.get("trace")
                if trace:
                    tid = _lane("trace:" + str(trace),
                                "trace " + str(trace), pid)
                else:
                    key = "%s:req:%s" % (replica, rec.get("tid", 0))
                    tid = _lane(key, "%s req %s" % (replica,
                                                    rec.get("tid", 0)), pid)
                args.setdefault("replica", replica)
            else:
                pid = _pid("%s/%s" % (replica, track))
                tid = int(rec.get("tid", 0))
            ev["pid"], ev["tid"] = pid, tid
            if args:
                ev["args"] = args
            events.append(ev)
    return {"traceEvents": events}
