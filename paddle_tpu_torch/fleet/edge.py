"""The HTTP/SSE serving edge on one engine replica (counterpart:
paddle_tpu/fleet/edge.py, copied and adapted, not imported).

`EdgeServer` is the network half of `inference.frontend.ServingFrontend`:
the frontend's asyncio driver runs on a dedicated daemon thread, and a
stdlib `ThreadingHTTPServer` (the `observability.opsserver` daemon
pattern — read that module first) bridges handler threads into it with
``asyncio.run_coroutine_threadsafe``.  Endpoints:

=================== ======================================================
endpoint            serves
=================== ======================================================
POST /v1/generate   body ``{"prompt_ids": [...], "max_new_tokens": N,
                    ...}`` (eos_token_id / priority / deadline_ms /
                    slo_ttft_ms / slo_tpot_ms pass through to
                    `DecodeEngine.add_request`).  Streams Server-Sent
                    Events: one ``meta`` event (``request_id``,
                    ``start_index``), one event per token
                    (``{"i": index, "t": token}``), one terminal event
                    (``{"done": true, "finish_reason": ..., "n": total}``)
POST /v1/adopt      body ``{"journal_dir": ..., "delivered": {id: n}}`` —
                    fleet failover: replay a dead sibling replica's
                    journal into THIS replica
                    (`ServingFrontend.adopt`) and park a relay per
                    migrated request for ``/v1/resume`` to drain.
                    Returns the migration map (donor id -> fresh id,
                    start_index, done)
GET /v1/resume      ``?request=<donor id>`` — one-shot: stream the
                    adopted request's remaining tokens as SSE with the
                    same framing ``/v1/generate`` uses, starting at
                    ``start_index`` (snapshot-known undelivered tokens
                    backfill first, live recompute follows) — the
                    reconnecting consumer sees token-for-token continuity
GET /v1/info        replica identity: engine id, config fingerprint,
                    routing salt + page size (the router's hash inputs),
                    ops-plane port, journal directory
GET /tracez/spans   this replica's span-buffer slice as JSON
                    (``?trace=<id>`` and/or ``?since_ns=&until_ns=``),
                    plus the replica clock (``now_ns``) — the fleet
                    rollup's merge input (observability.fleettrace)
=================== ======================================================

With ``FLAGS_fleet_trace`` on, ``/v1/generate`` / ``/v1/adopt`` /
``/v1/resume`` read the ``x-paddle-trace`` header (the router mints the
id) and thread it through the frontend onto the engine request, so
engine-side request spans and flight records tag themselves with the
fleet-wide trace id; SSE delivery, adoption and resume each record
spans on an ``edge`` track.  Flag off (default): the header is never
read, no edge spans record — bit-exact with the pre-trace edge.

A disconnected ``/v1/generate`` consumer cancels its request (queued or
running); a disconnected ``/v1/resume`` consumer does NOT — the adopted
request keeps generating so a second resume attempt (or a second
failover) still loses nothing.

On the card the handler threads read only host state: the engine
steps (and captures its graphs) on the frontend's worker thread,
adoption runs on the frontend's loop between two steps, never beside
one, and the one digest `/v1/info` needs from the weights
(`config_fingerprint`, memoized) is taken in `start()`, before the
first step.
"""
from __future__ import annotations

import asyncio
import contextlib
import json
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional
from urllib.parse import parse_qs, urlparse

from ..observability import fleettrace

__all__ = ["EdgeServer"]

# generation kwargs the edge forwards verbatim to add_request
_REQUEST_KWARGS = ("eos_token_id", "priority", "deadline_ms",
                   "slo_ttft_ms", "slo_tpot_ms")


def _edge_span(name: str, tid: int = 0, **args):
    """RAII span on the ``edge`` track — a no-op context unless
    FLAGS_fleet_trace, so the default edge records nothing."""
    if not fleettrace.enabled():
        return contextlib.nullcontext()
    from ..observability import tracing

    kept = {k: v for k, v in args.items() if v is not None}
    return tracing.span("edge", name, tid=int(tid), args=kept or None)


class _Relay:
    """Thread-safe conveyor from the frontend's event loop to one SSE
    handler thread: the async pump feeds ``("tok", value)`` /
    ``("done", reason, total)`` items, the handler drains and frames
    them.  ``start_index`` is the absolute index of the first token
    the consumer will see (nonzero on resumed streams)."""

    def __init__(self, start_index: int = 0):
        self.q: "queue.Queue" = queue.Queue()
        self.start_index = int(start_index)
        self.request_id: Optional[int] = None
        self.stream = None  # TokenStream, for cancel-on-disconnect
        self.trace: Optional[str] = None  # fleet trace id, if any


class EdgeServer:
    """One replica's serving edge: engine + frontend + HTTP listener.

    ::

        edge = EdgeServer(engine, port=0)   # 0 = ephemeral (tests)
        port = edge.start()
        ...
        edge.close()

    ``frontend_kwargs`` pass to `ServingFrontend` (queue depth, stream
    buffer).  The frontend's driver loop runs on a daemon thread owned
    by this object; handler threads never touch the engine directly —
    every mutation goes through the frontend's control queue, exactly
    like an in-process caller's would."""

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0,
                 submit_timeout_s: float = 120.0,
                 stream_idle_timeout_s: float = 600.0,
                 **frontend_kwargs):
        self.engine = engine
        self.host = str(host)
        self.port = int(port)
        self.submit_timeout_s = float(submit_timeout_s)
        self.stream_idle_timeout_s = float(stream_idle_timeout_s)
        self._fe_kwargs = dict(frontend_kwargs)
        self.frontend = None
        self._aloop: Optional[asyncio.AbstractEventLoop] = None
        self._loop_thread: Optional[threading.Thread] = None
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._http_thread: Optional[threading.Thread] = None
        self._adopted: Dict[int, _Relay] = {}  # donor id -> relay
        self._adopt_lock = threading.Lock()
        self._closed = False

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> int:
        """Start the frontend loop thread + HTTP listener; returns the
        bound port.  Idempotent."""
        if self._httpd is not None:
            return self._httpd.server_address[1]
        if self._closed:
            raise RuntimeError("edge is closed")
        # memoized here, before any step: `info()` then reads no tensor
        self.engine.config_fingerprint()
        ready = threading.Event()
        boot_err: list = []

        def _loop_main():
            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)
            self._aloop = loop

            async def _boot():
                from ..inference.frontend import ServingFrontend

                self.frontend = ServingFrontend(self.engine,
                                                **self._fe_kwargs)
                await self.frontend.start()
            try:
                loop.run_until_complete(_boot())
            except Exception as e:  # surface on start(), not the log
                boot_err.append(e)
                ready.set()
                return
            ready.set()
            loop.run_forever()
            # close() stopped the loop; drain callbacks then close
            loop.run_until_complete(loop.shutdown_asyncgens())
            loop.close()

        self._loop_thread = threading.Thread(
            target=_loop_main, name="paddle-fleet-edge-loop",
            daemon=True)
        self._loop_thread.start()
        ready.wait()
        if boot_err:
            raise boot_err[0]
        self._httpd = ThreadingHTTPServer((self.host, self.port),
                                          _EdgeHandler)
        self._httpd.daemon_threads = True
        self._httpd.edge = self  # handler back-pointer
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="paddle-fleet-edge-http", daemon=True)
        self._http_thread.start()
        return self._httpd.server_address[1]

    @property
    def bound_port(self) -> Optional[int]:
        return self._httpd.server_address[1] if self._httpd else None

    def close(self, drain: bool = False):
        """Stop the listener and the frontend (``drain=True`` serves
        outstanding requests to completion first)."""
        if self._closed:
            return
        self._closed = True
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            if self._http_thread is not None:
                self._http_thread.join(timeout=5)
        if self._aloop is not None and self.frontend is not None:
            try:
                asyncio.run_coroutine_threadsafe(
                    self.frontend.close(drain=drain),
                    self._aloop).result(timeout=60)
            except Exception:
                pass
            self._aloop.call_soon_threadsafe(self._aloop.stop)
            if self._loop_thread is not None:
                self._loop_thread.join(timeout=10)

    # -- handler-thread entries ----------------------------------------------
    def _run(self, coro, timeout: float):
        return asyncio.run_coroutine_threadsafe(
            coro, self._aloop).result(timeout=timeout)

    async def _pump(self, stream, relay: _Relay):
        """Event-loop side of one SSE stream: token queue -> relay."""
        try:
            async for tok in stream:
                relay.q.put(("tok", int(tok)))
        finally:
            relay.q.put(("done", stream.finish_reason,
                         len(stream.request.generated_ids)))

    def open_stream(self, prompt_ids, max_new_tokens: int,
                    kwargs: dict) -> _Relay:
        """Submit one request; returns its relay (meta already
        resolved).  Raises whatever `add_request` would."""
        relay = _Relay()
        relay.trace = kwargs.get("trace_id")

        async def _submit():
            stream = await self.frontend.submit(
                list(prompt_ids), int(max_new_tokens), **kwargs)
            relay.request_id = int(stream.request.request_id)
            relay.stream = stream
            # pump as a loop task: tokens flow while the handler
            # thread is blocked writing to a slow consumer
            asyncio.ensure_future(self._pump(stream, relay))
            return stream
        self._run(_submit(), self.submit_timeout_s)
        return relay

    def cancel_stream(self, relay: _Relay):
        """Consumer went away mid-generate: stop the request."""
        if relay.stream is None or self._aloop is None:
            return
        try:
            asyncio.run_coroutine_threadsafe(relay.stream.cancel(),
                                             self._aloop)
        except RuntimeError:
            pass

    def adopt(self, journal_dir: str,
              delivered: Optional[Dict[int, int]] = None,
              traces: Optional[Dict[int, str]] = None) -> dict:
        """Failover entry (``POST /v1/adopt``): replay the dead
        sibling's journal into this replica's engine and park one
        relay per migrated request for ``/v1/resume``.  Returns the
        JSON-safe migration map keyed by donor request id.  ``traces``
        (router-supplied donor id -> fleet trace id) is the fallback
        for trace-less journals — the journal's own record wins."""
        delivered = {int(k): int(v)
                     for k, v in (delivered or {}).items()}
        traces = {int(k): str(v) for k, v in (traces or {}).items()}

        async def _adopt():
            return await self.frontend.adopt(journal_dir,
                                             delivered=delivered,
                                             traces=traces or None)
        with _edge_span("adopt", donor=journal_dir):
            out = self._run(_adopt(), self.submit_timeout_s)
        migrated = {}
        with self._adopt_lock:
            for rid, info in out.items():
                relay = _Relay(start_index=info["start_index"])
                relay.request_id = int(info["request_id"])
                relay.trace = info.get("trace")
                # backfill BEFORE the pump is scheduled: the relay
                # queue then orders snapshot-known tokens ahead of
                # live recompute by construction
                for t in info["backfill"]:
                    relay.q.put(("tok", int(t)))
                asyncio.run_coroutine_threadsafe(
                    self._pump(info["stream"], relay), self._aloop)
                self._adopted[int(rid)] = relay
                migrated[int(rid)] = {
                    "request_id": int(info["request_id"]),
                    "start_index": int(info["start_index"]),
                    "backfill_tokens": len(info["backfill"]),
                    "done": bool(info["done"]),
                }
                if relay.trace is not None:
                    migrated[int(rid)]["trace"] = relay.trace
        return migrated

    def pop_adopted(self, donor_id: int) -> Optional[_Relay]:
        """One-shot claim of a migrated request's relay (the resume
        stream is exactly-once: a second resume gets 404, it does not
        restart the token sequence)."""
        with self._adopt_lock:
            return self._adopted.pop(int(donor_id), None)

    def info(self) -> dict:
        from ..observability import opsserver

        eng = self.engine
        return {
            "engine_id": int(eng._engine_id),
            "config_fp": eng.config_fingerprint().hex(),
            "route_salt": eng._model_salt.hex(),
            "page_size": int(eng._page),
            "prefix_cache": bool(eng._prefix_cache),
            "cache_generated_pages": bool(eng._cache_generated),
            "max_batch_size": int(eng._slots),
            "ops_port": opsserver.ops_server_port(),
            "journal": eng.journal_info(),
        }


class _EdgeHandler(BaseHTTPRequestHandler):
    server_version = "paddle-fleet-edge/1"

    def log_message(self, *args):  # noqa: D102 - silence request logs
        pass

    @property
    def edge(self) -> EdgeServer:
        return self.server.edge

    # -- plumbing ------------------------------------------------------------
    def _send_json(self, obj, code: int = 200):
        data = json.dumps(obj, default=str).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _body(self) -> dict:
        n = int(self.headers.get("Content-Length") or 0)
        if n <= 0:
            return {}
        return json.loads(self.rfile.read(n) or b"{}")

    def _sse_begin(self):
        # HTTP/1.0 + no Content-Length: the consumer reads events
        # until the connection closes (exactly what SSE wants here)
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.end_headers()

    def _sse_event(self, obj):
        self.wfile.write(b"data: " +
                         json.dumps(obj, separators=(",", ":")).encode()
                         + b"\n\n")
        self.wfile.flush()

    def _sse_drain(self, relay: _Relay):
        """Meta event, then token events, then the terminal event."""
        self._sse_begin()
        self._sse_event({"request_id": relay.request_id,
                         "start_index": relay.start_index})
        idx = relay.start_index
        while True:
            item = relay.q.get(
                timeout=self.edge.stream_idle_timeout_s)
            if item[0] == "tok":
                self._sse_event({"i": idx, "t": item[1]})
                idx += 1
            else:
                self._sse_event({"done": True, "finish_reason": item[1],
                                 "n": item[2]})
                return

    # -- routes --------------------------------------------------------------
    def do_GET(self):  # noqa: N802 - http.server API
        try:
            url = urlparse(self.path)
            if url.path == "/v1/info":
                self._send_json(self.edge.info())
            elif url.path == "/v1/resume":
                self._resume(parse_qs(url.query))
            elif url.path == "/tracez/spans":
                self._tracez_spans(parse_qs(url.query))
            else:
                self._send_json({"error": f"unknown endpoint "
                                          f"{url.path!r}"}, code=404)
        except (BrokenPipeError, ConnectionResetError):
            pass
        except Exception as e:
            self._try_error(e)

    def do_POST(self):  # noqa: N802 - http.server API
        try:
            url = urlparse(self.path)
            if url.path == "/v1/generate":
                self._generate()
            elif url.path == "/v1/adopt":
                body = self._body()
                if not body.get("journal_dir"):
                    self._send_json({"error": "journal_dir required"},
                                    code=400)
                    return
                self._send_json({"migrated": self.edge.adopt(
                    str(body["journal_dir"]),
                    body.get("delivered") or {},
                    traces=self._traces_in(body))})
            else:
                self._send_json({"error": f"unknown endpoint "
                                          f"{url.path!r}"}, code=404)
        except (BrokenPipeError, ConnectionResetError):
            pass
        except Exception as e:
            self._try_error(e)

    def _try_error(self, e: Exception):
        try:
            self._send_json({"error": f"{type(e).__name__}: {e}"},
                            code=500)
        except Exception:
            pass

    def _trace_in(self) -> Optional[str]:
        """The request's fleet trace id — only read while
        FLAGS_fleet_trace is on (default off never inspects headers)."""
        if not fleettrace.enabled():
            return None
        trace = self.headers.get(fleettrace.TRACE_HEADER)
        return str(trace) if trace else None

    def _traces_in(self, body: dict) -> Optional[dict]:
        if not fleettrace.enabled():
            return None
        return body.get("traces") or None

    def _generate(self):
        body = self._body()
        prompt = body.get("prompt_ids")
        if not prompt:
            self._send_json({"error": "prompt_ids required"}, code=400)
            return
        kwargs = {k: body[k] for k in _REQUEST_KWARGS if k in body}
        trace = self._trace_in()
        if trace is not None:
            kwargs["trace_id"] = trace
        try:
            relay = self.edge.open_stream(
                prompt, body.get("max_new_tokens", 32), kwargs)
        except Exception as e:
            # admission validation (empty prompt, over-horizon, pool
            # too small) surfaces as a 4xx, not a broken stream
            self._send_json({"error": f"{type(e).__name__}: {e}"},
                            code=400)
            return
        try:
            with _edge_span("sse", tid=relay.request_id or 0,
                            request=relay.request_id, trace=relay.trace):
                self._sse_drain(relay)
        except (BrokenPipeError, ConnectionResetError):
            self.edge.cancel_stream(relay)  # consumer went away

    def _resume(self, query):
        rid = query.get("request", [None])[0]
        if rid is None:
            self._send_json({"error": "request id required"}, code=400)
            return
        relay = self.edge.pop_adopted(int(rid))
        if relay is None:
            self._send_json(
                {"error": f"no adopted stream for request {rid} "
                          f"(already resumed, or never migrated "
                          f"here)"}, code=404)
            return
        # a dropped resume consumer does NOT cancel the request: the
        # engine keeps generating and a re-adoption (second failover)
        # still covers every token
        with _edge_span("resume", tid=relay.request_id or 0,
                        request=relay.request_id, trace=relay.trace):
            self._sse_drain(relay)

    def _tracez_spans(self, query):
        """``GET /tracez/spans`` — this replica's span-buffer slice
        (read-only; served regardless of FLAGS_fleet_trace so a
        router-side merge can still collect engine spans)."""
        from ..observability import tracing

        trace = query.get("trace", [None])[0]
        since = query.get("since_ns", [None])[0]
        until = query.get("until_ns", [None])[0]
        out = fleettrace.span_slice(
            tracing.spans(), trace=trace,
            since_ns=None if since is None else int(since),
            until_ns=None if until is None else int(until))
        self._send_json({
            "engine_id": int(self.edge.engine._engine_id),
            "now_ns": int(tracing.now_ns()),
            "spans": out,
        })
