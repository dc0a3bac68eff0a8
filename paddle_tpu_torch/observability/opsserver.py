"""Ops plane: live HTTP telemetry endpoints over the serving stack
(counterpart: paddle_tpu/observability/opsserver.py, copied, not
imported).

The serving stack's introspection surfaces (the metric registry,
`DecodeEngine.statusz`, the flight recorder, the cost observatory's
headroom, the alert engine) made **network-visible**: per-engine
health, readiness, capacity headroom and alert state a router or
operator polls without touching the engine thread.  This module is
that read-only front door:

========== ==============================================================
endpoint   serves
========== ==============================================================
/metrics   Prometheus text exposition (`observability.prometheus_text`)
/statusz   `DecodeEngine.statusz()` JSON (``?format=text`` renders
           `statusz_text`; ``?engine=<id>`` picks one; an engine
           fronted by a `ServingFrontend` serves `debug_dump()`)
/flightz   the flight-recorder window (``?n=<records>``;
           ``?request=<id>`` routes through `explain_request.explain`
           and returns the reconstructed timeline)
/healthz   liveness: 200 while any registered engine's
           `paddle_engine_health` one-hot reads live/degraded/
           recovering (503: no engine can serve)
/readyz    the router's routing key: 200 iff some engine is serving
           (live or degraded — degraded still completes requests) AND
           has capacity headroom (`paddle_capacity_headroom_slots` >
           0; free slots when the cost observatory is off) AND no
           page-severity alert is firing AND no armed watchdog is
           overdue (a step blocked past its budget flips NOT-ready
           BEFORE the frontend abandons — stop routing first, rebuild
           second)
/alertz    alert states + recent transitions (`AlertEngine.snapshot`)
/profilez  the profiling plane (`Profiler.statusz`): capture status,
           per-executable measured device time, hot-op top-K
           (404 while ``FLAGS_profile`` is off)
/tracez    the merged chrome trace (`merged_chrome_trace`), bounded —
           ``?n=<events>`` caps the non-metadata events (newest kept;
           default 20000) — plus the dropped-span count
/fleetz    the fleet-wide rollup (`fleet.FleetRouter.fleetz`): every
           replica's /metrics + /alertz + /statusz, poll RTT and
           clock-offset estimates, and the cross-replica merged chrome
           trace (``?trace=<id>`` narrows the span pull); 404 unless a
           FleetRouter is registered in this process
========== ==============================================================

The server is a stdlib `ThreadingHTTPServer` on a daemon thread,
armed by ``FLAGS_ops_port`` (0 = off: zero listening sockets, zero
new threads).  Every handler READS — engines are never mutated from
here (statusz/debug_dump/snapshot are the documented any-thread
surfaces) — so a hammering poller cannot perturb serving outputs.  On
the card the handlers read only host state: the engine thread
publishes between steps everything a handler renders (the HBM
ledger's residue is measured on the engine thread at its audit), so
the HTTP thread makes no CUDA call, which could otherwise land inside
a step graph's capture and invalidate it.

The **ops registry** is process-global: engines register at
construction and deregister at retirement
(`durability.retire_engine_series` — the one chokepoint recover /
restore / abandon already funnel through), so the endpoints stay
truthful across engine generations; frontends register around their
serve context so `/statusz` upgrades to the stream-aware
`debug_dump`.  Entries are weakrefs: an engine merely dropped (tests,
notebooks) leaves the registry with the object, no retirement
required.
"""
from __future__ import annotations

import json
import threading
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional
from urllib.parse import parse_qs, urlparse

from ..analysis.sanitizer import TrackedLock as _TrackedLock


__all__ = [
    "register_engine", "deregister_engine", "register_frontend",
    "deregister_frontend", "live_engines", "engine_ready",
    "readiness", "start_ops_server", "stop_ops_server",
    "maybe_start_ops_server", "ops_server_port", "register_fleet",
    "deregister_fleet",
]

# THE ops-registry lock: every registry mutation (engine/frontend
# registration, server handle swaps) happens under it; handlers copy
# under the lock and render outside it.
# a TrackedLock under the JAX package's name, so FLAGS_sanitize
# records acquisition order (analysis.sanitizer)
_lock = _TrackedLock(threading.RLock(), "opsserver._lock")

_ENGINES: Dict[int, "weakref.ref"] = {}
_FRONTENDS: Dict[int, "weakref.ref"] = {}
_SERVER: Optional[tuple] = None  # (ThreadingHTTPServer, thread)
_FLEET: Optional["weakref.ref"] = None  # the process's FleetRouter

_obs_mod = None


def _obs():
    global _obs_mod
    if _obs_mod is None:
        from paddle_tpu_torch import observability

        _obs_mod = observability
    return _obs_mod


# ---------------------------------------------------------------------------
# the process-global ops registry
# ---------------------------------------------------------------------------
def register_engine(engine):
    """Called at `DecodeEngine` construction (always — registration is
    one locked dict insert, the HTTP listener is what the flag arms)."""
    eid = int(engine._engine_id)

    def _gone(_ref, _eid=eid):
        with _lock:
            _ENGINES.pop(_eid, None)
    with _lock:
        _ENGINES[eid] = weakref.ref(engine, _gone)


def deregister_engine(engine_id: int):
    """Called from `durability.retire_engine_series` — recover /
    restore / watchdog abandonment all retire through it, so a dead
    generation leaves `/statusz`, `/healthz` and `/readyz` the moment
    it leaves the metric registry."""
    with _lock:
        _ENGINES.pop(int(engine_id), None)


def register_frontend(frontend):
    eid = int(frontend.engine._engine_id)

    def _gone(_ref, _eid=eid):
        with _lock:
            _FRONTENDS.pop(_eid, None)
    with _lock:
        _FRONTENDS[eid] = weakref.ref(frontend, _gone)


def deregister_frontend(frontend):
    with _lock:
        dead = [k for k, ref in _FRONTENDS.items()
                if ref() is frontend or ref() is None]
        for k in dead:
            _FRONTENDS.pop(k, None)


def register_fleet(router):
    """Called by `fleet.FleetRouter` at construction: this process's
    ``/alertz`` then carries the fleet-level rollup (reachability,
    fleet-wide firing set, failover narration) beside the local
    engines' alert state.  One router per process (latest wins);
    weakref, so a dropped router leaves the endpoint with the object."""
    global _FLEET
    with _lock:
        _FLEET = weakref.ref(router)


def deregister_fleet(router):
    global _FLEET
    with _lock:
        if _FLEET is not None and _FLEET() in (router, None):
            _FLEET = None


def _fleet_router():
    with _lock:
        ref = _FLEET
    return ref() if ref is not None else None


def live_engines() -> List[object]:
    """Registered engines still alive, id order."""
    with _lock:
        refs = sorted(_ENGINES.items())
    out = []
    for _eid, ref in refs:
        eng = ref()
        if eng is not None and not eng._abandoned:
            out.append(eng)
    return out


def _frontend_for(engine):
    with _lock:
        ref = _FRONTENDS.get(int(engine._engine_id))
    return ref() if ref is not None else None


# ---------------------------------------------------------------------------
# health / readiness probes (shared by the endpoints and in-process
# callers — a router embedding the engine can ask the same question
# without HTTP)
# ---------------------------------------------------------------------------
def _health_of(engine) -> str:
    from ..inference.durability import _health_state

    return _health_state.get(engine._engine_id, "live")


def engine_ready(engine) -> dict:
    """One engine's readiness verdict + the criteria that produced it
    (the router debugs a non-ready replica from the criteria, not the
    bit)."""
    health = _health_of(engine)
    # degraded still SERVES (speculation off / legacy prefill — slower,
    # not stopped), so it stays routable; recovering and hung do not
    crit = {"health": health,
            "serving": health in ("live", "degraded")}
    # capacity headroom: the cost observatory's admission number when
    # armed (free slots, pool capacity, SLO ceiling); plain free slots
    # otherwise.  ONE headroom() call — the fleet router reads the
    # predicted-cost fields beside the verdict, and two calls could
    # straddle a step and disagree with each other
    if engine._cost is not None:
        hr = engine._cost.headroom()
        headroom = int(hr["admissible_slots"])
        crit["predicted_step_s"] = hr.get("predicted_step_s")
        crit["slo_ok"] = hr.get("slo_ok")
    else:
        headroom = len(engine._free_slots)
    crit["headroom_slots"] = headroom
    # page-severity alerts: the alert engine's firing set (no alert
    # engine = no alert evidence = the criterion passes)
    al = getattr(engine, "_alerts", None)
    paging = al.firing("page") if al is not None else []
    crit["page_alerts"] = paging
    # watchdog overdue: a step blocked past its budget (compiles
    # excused) makes the engine not-ready BEFORE the frontend abandons
    wd = engine._watchdog
    overdue = bool(wd is not None and wd.overdue())
    crit["watchdog_overdue"] = overdue
    crit["ready"] = bool(crit["serving"] and headroom > 0
                         and not paging and not overdue)
    return crit


def readiness() -> dict:
    """Fleet-level readiness: per-engine verdicts + the any-ready
    bit `/readyz` statuses on.  With FLAGS_fleet_trace armed the
    verdict also reports this process's span clock (``now_ns``) — the
    router brackets its poll around it for the NTP-style clock-offset
    estimate (observability.fleettrace.ClockSync); flag off keeps the
    payload byte-identical."""
    engines = live_engines()
    per = {str(e._engine_id): engine_ready(e) for e in engines}
    doc = {
        "ready": any(c["ready"] for c in per.values()),
        "engines": per,
    }
    from . import fleettrace, tracing

    if fleettrace.enabled():
        doc["now_ns"] = int(tracing.now_ns())
    return doc


def _liveness() -> dict:
    engines = live_engines()
    states = {str(e._engine_id): _health_of(e) for e in engines}
    return {
        "ok": any(s in ("live", "degraded", "recovering")
                  for s in states.values()),
        "engines": states,
    }


# ---------------------------------------------------------------------------
# the HTTP endpoint
# ---------------------------------------------------------------------------
def _pick_engine(query) -> tuple:
    """(engine, error_json) — honors ?engine=<id>, defaults to the
    single live engine, and names the candidates when ambiguous."""
    engines = live_engines()
    want = query.get("engine", [None])[0]
    if want is not None:
        for e in engines:
            if str(e._engine_id) == str(want):
                return e, None
        return None, {"error": f"no live engine {want!r}",
                      "engines": [e._engine_id for e in engines]}
    if len(engines) == 1:
        return engines[0], None
    return None, {"error": "engine id required "
                           f"({len(engines)} live engines)",
                  "engines": [e._engine_id for e in engines]}


def _explain(window: dict, request_id: int) -> List[str]:
    """Route through the port's `tools.explain_request` library entry."""
    from ..tools import explain_request

    return explain_request.explain(window, request_id)


class _OpsHandler(BaseHTTPRequestHandler):
    server_version = "paddle-ops/1"

    def log_message(self, *args):  # noqa: D102 - silence per-request logs
        pass

    def _send(self, code: int, body: str, ctype: str):
        data = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _send_json(self, obj, code: int = 200):
        self._send(code, json.dumps(obj, indent=1, default=str),
                   "application/json")

    def do_GET(self):  # noqa: N802 - http.server API
        try:
            url = urlparse(self.path)
            query = parse_qs(url.query)
            route = getattr(self, "_route_" + url.path.strip("/")
                            .replace("/", "_"), None)
            if route is None:
                self._send_json(
                    {"error": f"unknown endpoint {url.path!r}",
                     "endpoints": ["/metrics", "/statusz", "/flightz",
                                   "/healthz", "/readyz", "/alertz",
                                   "/profilez", "/tracez"]},
                    code=404)
                return
            route(query)
        except (BrokenPipeError, ConnectionResetError):
            pass  # poller went away mid-write: nothing to salvage
        except Exception as e:  # read-only plane: report, never die
            try:
                self._send_json({"error": f"{type(e).__name__}: {e}"},
                                code=500)
            except Exception:
                pass

    # -- routes ---------------------------------------------------------------
    def _route_metrics(self, query):
        self._send(200, _obs().prometheus_text(),
                   "text/plain; version=0.0.4; charset=utf-8")

    def _route_statusz(self, query):
        fmt = query.get("format", ["json"])[0]
        eng, err = _pick_engine(query)
        if eng is None and err and "engines" in err \
                and query.get("engine", [None])[0] is None:
            # no ?engine= and not exactly one engine: the map form
            engines = live_engines()
            if fmt == "text":
                self._send(200, "\n\n".join(
                    e.statusz_text() for e in engines) + "\n",
                    "text/plain; charset=utf-8")
            else:
                self._send_json({"engines": {
                    str(e._engine_id): e.statusz() for e in engines}})
            return
        if eng is None:
            self._send_json(err, code=404)
            return
        if fmt == "text":
            self._send(200, eng.statusz_text() + "\n",
                       "text/plain; charset=utf-8")
            return
        fe = _frontend_for(eng)
        if fe is not None:
            self._send_json(fe.debug_dump())
        else:
            self._send_json(eng.statusz())

    def _route_flightz(self, query):
        eng, err = _pick_engine(query)
        if eng is None:
            self._send_json(err, code=404)
            return
        if eng._flight is None:
            self._send_json({"error": "flight recorder disabled "
                                      "(FLAGS_flight_window=0)"},
                            code=404)
            return
        n = query.get("n", [None])[0]
        window = eng._flight.snapshot(int(n) if n else None)
        rid = query.get("request", [None])[0]
        if rid is not None:
            self._send_json({
                "engine": eng._engine_id,
                "request": int(rid),
                "explain": _explain(window, int(rid)),
            })
        else:
            self._send_json(window)

    def _route_healthz(self, query):
        live = _liveness()
        self._send_json(live, code=200 if live["ok"] else 503)

    def _route_readyz(self, query):
        ready = readiness()
        self._send_json(ready, code=200 if ready["ready"] else 503)

    def _route_profilez(self, query):
        eng, err = _pick_engine(query)
        if eng is None:
            self._send_json(err, code=404)
            return
        prof = getattr(eng, "_profiling", None)
        if prof is None:
            self._send_json({"error": "profiling plane disabled "
                                      "(FLAGS_profile=0)"},
                            code=404)
            return
        self._send_json(prof.statusz())

    def _route_tracez(self, query):
        # bounded by construction: a long-lived serve can hold up to
        # MAX_SPANS spans — a poller asking for "the trace" must not
        # receive hundreds of MB.  Metadata (process_name) events are
        # always kept so the surviving spans stay labeled.
        n = query.get("n", [None])[0]
        cap = int(n) if n else 20000
        data = _obs().merged_chrome_trace()
        events = data.get("traceEvents", [])
        meta = [e for e in events if e.get("ph") == "M"]
        rest = [e for e in events if e.get("ph") != "M"]
        clipped = max(len(rest) - max(cap, 0), 0)
        if clipped:
            # "newest kept" means newest by TIMESTAMP: the merged
            # trace concatenates whole tracks (host first), so a
            # positional tail would drop the entire host track before
            # a single stale span
            rest.sort(key=lambda e: e.get("ts", 0.0))
            rest = rest[-cap:] if cap > 0 else []
        self._send_json({
            "traceEvents": meta + rest,
            "total_events": len(events),
            "clipped_events": clipped,
            "dropped_spans": _obs().dropped_span_count(),
        })

    def _route_alertz(self, query):
        out = {}
        for eng in live_engines():
            al = getattr(eng, "_alerts", None)
            if al is not None:
                out[str(eng._engine_id)] = al.snapshot()
        doc = {"engines": out}
        router = _fleet_router()
        if router is not None:
            # the fleet-level story beside the local engines': which
            # replicas are reachable/ready fleet-wide, every rule
            # firing anywhere, and the router's failover narration
            doc["fleet"] = router.alertz_rollup()
        self._send_json(doc)

    def _route_fleetz(self, query):
        # the fleet-wide rollup (fleet.FleetRouter.fleetz).  Synchronous
        # replica fetches are safe here: this handler runs in the
        # router's process and calls out to replica ops planes, never
        # back into itself
        router = _fleet_router()
        if router is None:
            self._send_json(
                {"error": "no fleet router registered in this "
                          "process"}, code=404)
            return
        trace = query.get("trace", [None])[0]
        self._send_json(router.fleetz(trace=trace))


# ---------------------------------------------------------------------------
# server lifecycle
# ---------------------------------------------------------------------------
def start_ops_server(port: Optional[int] = None,
                     host: str = "0.0.0.0") -> int:
    """Start the daemon-thread endpoint and return the bound port.
    ``port=None`` reads ``FLAGS_ops_port``; ``port=0`` binds an
    ephemeral port (tests).  Idempotent: a running server's port is
    returned as-is."""
    from ..core import flags as _flags

    with _lock:
        global _SERVER
        if _SERVER is not None:
            return _SERVER[0].server_address[1]
        if port is None:
            port = int(_flags.flag("ops_port"))
            if port <= 0:
                raise ValueError(
                    f"FLAGS_ops_port={port} does not name a port to "
                    f"bind (pass port=0 explicitly for ephemeral)")
        srv = ThreadingHTTPServer((host, int(port)), _OpsHandler)
        srv.daemon_threads = True
        thread = threading.Thread(target=srv.serve_forever,
                                  name="paddle-ops-server",
                                  daemon=True)
        # started BEFORE the handle publishes (still under the lock):
        # a concurrent stop_ops_server must never join a never-started
        # thread or close the socket under a not-yet-serving loop
        thread.start()
        _SERVER = (srv, thread)
    return srv.server_address[1]


def stop_ops_server():
    with _lock:
        global _SERVER
        server, _SERVER = _SERVER, None
    if server is not None:
        srv, thread = server
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=5)


def ops_server_port() -> Optional[int]:
    """The bound port, or None when no listener is up (the off-mode
    zero-socket assertion benches and tests pin)."""
    with _lock:
        return _SERVER[0].server_address[1] if _SERVER is not None \
            else None


def maybe_start_ops_server():
    """Engine-construction hook: start the listener iff
    ``FLAGS_ops_port`` names a port (> 0) and none is running.
    Repeated construction is free (one flag read + one locked
    check)."""
    from ..core import flags as _flags

    port = int(_flags.flag("ops_port"))
    if port > 0 and ops_server_port() is None:
        start_ops_server(port)
