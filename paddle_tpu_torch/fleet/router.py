"""The fleet router: prefix-affinity placement, predicted-cost
admission, and zero-loss failover over N `fleet.edge.EdgeServer`
replicas (counterpart: paddle_tpu/fleet/router.py, copied and adapted,
not imported).

**Routing key** — the prefix cache's content-addressed page chain
hashes: the router hashes the longest page-aligned prefix of each
prompt with the replicas' shared model salt (``/v1/info`` exposes salt
+ page size, so the router's digests are byte-identical to the ones the engines'
`_probe_prefix` matches against).  A request whose longest hash maps
to an admissible replica is an **affinity hit** — it lands on the
replica already holding those KV pages; everything else places
least-loaded and claims the affinity map for its prefix chain.

**Admission predicate** — a replica takes new work iff its ops plane's
``/readyz`` verdict holds (serving AND headroom > 0 AND no
page-severity alert AND no watchdog-overdue step; see
`observability.opsserver.engine_ready`).  When the cost observatory is
armed the same poll carries ``predicted_step_s``/``slo_ok``, and the
router prefers replicas whose predicted next step still meets the SLO
ceiling — admission by predicted cost, not by a raw slot count.

**Failover** — a replica that stops answering (its streams break, its
``/readyz`` refuses) is declared dead after ``dead_after`` consecutive
failures.  The router then picks a survivor, reports exactly how many
tokens each interrupted stream actually delivered, and calls the
survivor's ``/v1/adopt`` — `durability.adopt_from_dir` replays the
dead replica's journal into the survivor's LIVE engine.  Every
interrupted `FleetStream` reconnects through ``/v1/resume`` and
continues token-for-token: delivered tokens are never re-sent (the
emit gate), journaled-but-undelivered tokens re-deliver (snapshot
backfill or live recompute).  chip_smoke.py's fleet phase kill-9s a
replica under load and checks zero loss + greedy continuity on exactly
this path.

**Fleet trace** — ``/fleetz`` merges the span slices it pulls from each
replica's edge.  A replica that died keeps, in the merge, the slice
last pulled from it under the same query (the JAX router drops it), so
a ``/fleetz?trace=<id>`` pulled before a kill and again after the
failover shows the migrated request's donor and survivor segments on
one lane.
"""
from __future__ import annotations

import hashlib
import json
import struct
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from collections import OrderedDict, deque
from typing import Dict, List, Optional

from .. import observability as _obs
from ..observability import fleettrace

__all__ = ["FleetConfigError", "ReplicaHandle", "FleetStream",
           "FleetRouter"]


def _chain_hash(prev: bytes, tokens) -> bytes:
    """One link of a prompt's page chain hash, as the engine's prefix
    cache computes it (`inference.serving._chain_hash`: blake2b-128 over
    the previous link and the page's tokens as little-endian int32)."""
    h = hashlib.blake2b(prev, digest_size=16)
    h.update(struct.pack(f"<{len(tokens)}i", *(int(t) for t in tokens)))
    return h.digest()


class FleetConfigError(ValueError):
    """A fleet wiring mistake that must fail construction loudly
    (e.g. a replica with no ops plane: the router cannot admit what it
    cannot poll)."""


def _get_json(url: str, timeout: float) -> dict:
    """GET a JSON document; non-2xx responses that still carry JSON
    (``/readyz`` serves 503 with the full verdict) parse instead of
    raising."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return json.loads(e.read())


def _post_json(url: str, body: dict, timeout: float) -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read())
    except urllib.error.HTTPError as e:
        raise RuntimeError(
            f"POST {url} -> {e.code}: {e.read()[:300]!r}") from None


def _sse_events(resp):
    """Parse ``data: <json>`` Server-Sent Events off a streaming HTTP
    response until EOF."""
    for raw in resp:
        line = raw.strip()
        if line.startswith(b"data: "):
            yield json.loads(line[6:])


class ReplicaHandle:
    """The router's view of one replica: its edge + ops URLs, the
    cached ``/v1/info`` identity, and the latest ``/readyz`` poll."""

    def __init__(self, name: str, edge_url: str,
                 ops_url: Optional[str] = None,
                 journal_dir: Optional[str] = None,
                 timeout_s: float = 5.0):
        self.name = str(name)
        self.edge_url = edge_url.rstrip("/")
        self.ops_url = ops_url.rstrip("/") if ops_url else None
        # the journal path AS THE ROUTER (and a survivor) reaches it —
        # defaults to the path the replica self-reports, overridable
        # for setups where mounts differ
        self.journal_dir = journal_dir
        self.timeout_s = float(timeout_s)
        self.info: dict = {}
        # poll state
        self.alive = True
        self.ready = False
        self.headroom = 0
        # measured /readyz round-trip (the router's only per-replica
        # latency signal) + the NTP-style clock-offset estimator the
        # fleet trace merge maps replica timestamps with
        self.poll_rtt_s: Optional[float] = None
        self._clock = fleettrace.ClockSync()
        self.slo_ok: Optional[bool] = None
        self.predicted_step_s: Optional[float] = None
        self.failures = 0          # consecutive poll failures
        self.assigned_since_poll = 0
        # failover state
        self.failed_over = False
        self.migration: Optional[tuple] = None  # (survivor, migrated)
        self.fo_event = threading.Event()
        self._fo_lock = threading.Lock()
        # `/fleetz` query -> the span slice last pulled from this
        # replica's edge, merged in its place once it is dead
        self.spans_pulled: "OrderedDict[str, list]" = OrderedDict()

    # -- HTTP ----------------------------------------------------------------
    def fetch_info(self) -> dict:
        self.info = _get_json(self.edge_url + "/v1/info",
                              self.timeout_s)
        if self.journal_dir is None:
            j = self.info.get("journal") or {}
            self.journal_dir = j.get("dir")
        return self.info

    def poll(self) -> bool:
        """One ``/readyz`` round; returns the ready bit.  A poll that
        cannot reach the replica counts a consecutive failure (the
        death detector's input) and reads not-ready.  The measured
        round-trip lands on `paddle_fleet_poll_rtt_seconds{replica}`;
        when the replica reports its own clock (``now_ns``, served
        with FLAGS_fleet_trace on) the same handshake feeds the
        NTP-style offset estimate the trace merge uses."""
        t0 = _obs.now_ns()
        try:
            doc = _get_json(self.ops_url + "/readyz", self.timeout_s)
        except Exception:
            self.failures += 1
            self.ready = False
            return False
        t1 = _obs.now_ns()
        self.poll_rtt_s = (t1 - t0) / 1e9
        _obs.FLEET_POLL_RTT.set(self.poll_rtt_s, replica=self.name)
        server_ns = doc.get("now_ns")
        if server_ns is not None:
            self._clock.observe(self.name, t0, t1, int(server_ns))
        self.failures = 0
        engines = doc.get("engines") or {}
        crit = engines.get(str(self.info.get("engine_id")))
        if crit is None and len(engines) == 1:
            # the replica recovered in-process onto a new engine
            # generation: follow it
            crit = next(iter(engines.values()))
        if crit is None:
            self.ready = False
            return False
        self.ready = bool(crit.get("ready"))
        self.headroom = int(crit.get("headroom_slots") or 0)
        self.slo_ok = crit.get("slo_ok")
        self.predicted_step_s = crit.get("predicted_step_s")
        self.assigned_since_poll = 0
        return self.ready

    def clock_offset_ns(self) -> int:
        """Estimated replica-clock minus router-clock (0 until the
        replica reports ``now_ns`` on a poll)."""
        return self._clock.offset_ns(self.name)

    def admissible(self) -> bool:
        """May the router place NEW work here right now?  The /readyz
        verdict plus the router's own not-yet-polled assignments
        (headroom is a snapshot; work placed since then consumes
        it)."""
        return self.alive and self.ready and \
            self.headroom - self.assigned_since_poll > 0

    def generate(self, prompt_ids, max_new_tokens: int, kwargs: dict,
                 timeout_s: float = 600.0,
                 trace: Optional[str] = None):
        """Open one streaming generation; returns ``(resp, meta)`` —
        the live SSE response plus its already-parsed meta event.
        ``trace`` (a fleet trace id) rides the ``x-paddle-trace``
        header; None sends the pre-trace wire format byte for byte."""
        body = {"prompt_ids": list(prompt_ids),
                "max_new_tokens": int(max_new_tokens), **kwargs}
        headers = {"Content-Type": "application/json"}
        if trace is not None:
            headers[fleettrace.TRACE_HEADER] = str(trace)
        req = urllib.request.Request(
            self.edge_url + "/v1/generate",
            data=json.dumps(body).encode(),
            headers=headers, method="POST")
        resp = urllib.request.urlopen(req, timeout=timeout_s)
        if resp.status != 200:
            raise RuntimeError(
                f"{self.name}: /v1/generate -> {resp.status}")
        meta = next(_sse_events(resp))
        return resp, meta

    def adopt(self, journal_dir: str, delivered: Dict[int, int],
              traces: Optional[Dict[int, str]] = None) -> dict:
        body = {"journal_dir": journal_dir, "delivered": delivered}
        if traces:
            # donor id -> trace id: the adopting edge's fallback for
            # journals written before FLAGS_fleet_trace was flipped
            body["traces"] = {str(k): str(v)
                              for k, v in traces.items()}
        out = _post_json(self.edge_url + "/v1/adopt", body,
                         timeout_s := max(self.timeout_s, 60.0))
        return out["migrated"]

    def resume(self, donor_id: int, timeout_s: float = 600.0,
               trace: Optional[str] = None):
        url = self.edge_url + f"/v1/resume?request={int(donor_id)}"
        if trace is not None:
            req = urllib.request.Request(
                url, headers={fleettrace.TRACE_HEADER: str(trace)})
            resp = urllib.request.urlopen(req, timeout=timeout_s)
        else:
            resp = urllib.request.urlopen(url, timeout=timeout_s)
        meta = next(_sse_events(resp))
        return resp, meta

    def alertz(self) -> Optional[dict]:
        try:
            return _get_json(self.ops_url + "/alertz", self.timeout_s)
        except Exception:
            return None


class FleetStream:
    """One request's life through the fleet: routed, streamed, and —
    when its replica dies mid-generation — resumed on the survivor.
    A dedicated reader thread drains the SSE stream; consumers either
    iterate (blocking per token) or call `result()` for the final
    token list.  ``tokens`` only ever grows with DELIVERED tokens, so
    ``len(tokens)`` is exactly the count the router reports into a
    failover's ``delivered`` map."""

    _DONE = object()

    def __init__(self, router: "FleetRouter", prompt_ids,
                 max_new_tokens: int, kwargs: dict,
                 trace_id: Optional[str] = None):
        self.router = router
        self.prompt_ids = list(prompt_ids)
        self.max_new_tokens = int(max_new_tokens)
        self.kwargs = dict(kwargs)
        # fleet trace id (observability.fleettrace): minted by
        # FleetRouter.submit while FLAGS_fleet_trace is on; every leg
        # — including post-failover resume — carries the SAME id
        self.trace_id = trace_id
        self.tokens: List[int] = []
        self.finish_reason: Optional[str] = None
        self.error: Optional[BaseException] = None
        self.replica: Optional[str] = None   # current replica name
        self.remote_id: Optional[int] = None
        self.affinity_hit: Optional[bool] = None
        self.failovers = 0
        self.t_submit = time.perf_counter()
        self.ttft_s: Optional[float] = None
        self._q: "deque" = deque()
        self._cv = threading.Condition()
        self._done = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="fleet-stream", daemon=True)
        self._thread.start()

    # -- consumer side -------------------------------------------------------
    def __iter__(self):
        i = 0
        while True:
            with self._cv:
                while i >= len(self.tokens) and not self._done.is_set():
                    self._cv.wait(timeout=1.0)
                if i < len(self.tokens):
                    tok = self.tokens[i]
                else:
                    return
            yield tok
            i += 1

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Wait for completion; returns the full token list.  Raises
        the stream's terminal error, if any."""
        if not self._done.wait(timeout=timeout):
            raise TimeoutError(
                f"fleet stream incomplete after {timeout}s "
                f"({len(self.tokens)} tokens, replica {self.replica})")
        if self.error is not None:
            raise self.error
        return list(self.tokens)

    @property
    def done(self) -> bool:
        return self._done.is_set()

    # -- reader side ---------------------------------------------------------
    def _deliver(self, tok: int):
        with self._cv:
            if not self.tokens and self.ttft_s is None:
                self.ttft_s = time.perf_counter() - self.t_submit
            self.tokens.append(int(tok))
            self._cv.notify_all()

    def _finish(self, reason: Optional[str],
                error: Optional[BaseException] = None):
        self.finish_reason = reason
        self.error = error
        with self._cv:
            self._done.set()
            self._cv.notify_all()
        self.router._stream_closed(self)

    def _consume(self, resp) -> bool:
        """Drain one SSE leg; True when the terminal event arrived,
        False when the connection broke mid-stream (failover time).
        Duplicate re-delivery (an index below what we hold) drops; a
        GAP (index above) is a protocol failure and raises."""
        try:
            for ev in _sse_events(resp):
                if ev.get("done"):
                    self._finish(ev.get("finish_reason"))
                    return True
                if "t" in ev:
                    i = int(ev["i"])
                    if i < len(self.tokens):
                        continue  # duplicate after an imprecise resume
                    if i > len(self.tokens):
                        raise RuntimeError(
                            f"token gap: expected index "
                            f"{len(self.tokens)}, got {i}")
                    self._deliver(int(ev["t"]))
        except (OSError, urllib.error.URLError) as e:
            # connection reset / refused / EOF mid-stream: the replica
            # is dying — report and let failover take over.  (A clean
            # EOF WITHOUT a done event lands here too, via the loop
            # simply ending.)
            self._last_io_error = e
            return False
        return self.finish_reason is not None

    def _run(self):
        try:
            replica = self.router._route(self)
            while True:
                if self._open_leg(replica):
                    return
                replica = self.router._await_failover(self)
                if replica is None:
                    self._finish(None, RuntimeError(
                        "replica died and no survivor could adopt "
                        "its journal"))
                    return
                self.failovers += 1
        except BaseException as e:
            self._finish(None, e)

    def _open_leg(self, replica: ReplicaHandle) -> bool:
        """One attach-and-drain leg on ``replica``; True = complete."""
        self.replica = replica.name
        try:
            if self._resume_from is not None:
                donor_rid, survivor = self._resume_from
                self._resume_from = None
                resp, meta = survivor.resume(donor_rid,
                                             trace=self.trace_id)
                self.remote_id = int(meta["request_id"])
                start = int(meta["start_index"])
                if start > len(self.tokens):
                    raise RuntimeError(
                        f"resume gap: consumer holds "
                        f"{len(self.tokens)} tokens, survivor "
                        f"resumes at {start}")
            else:
                resp, meta = replica.generate(
                    self.prompt_ids, self.max_new_tokens, self.kwargs,
                    trace=self.trace_id)
                self.remote_id = int(meta["request_id"])
            self.router._stream_attached(self, replica)
        except (OSError, urllib.error.URLError):
            return False  # replica died at attach: failover
        return self._consume(resp)

    _resume_from: Optional[tuple] = None
    _last_io_error: Optional[BaseException] = None


class FleetRouter:
    """Routes `submit()` traffic over the replica set and supervises
    it: a monitor thread polls every replica's ``/readyz`` on
    ``poll_interval_s`` cadence, refreshes the fleet ``/alertz``
    rollup, and triggers failover when a replica dies.

    ::

        router = FleetRouter(policy="affinity")
        router.add_replica("r0", "http://127.0.0.1:8100")
        router.add_replica("r1", "http://127.0.0.1:8101")
        router.start()
        stream = router.submit(prompt_ids, max_new_tokens=64)
        tokens = stream.result(timeout=120)
    """

    POLICIES = ("affinity", "round_robin")
    # span slices `fleetz` keeps per replica (one per query)
    SPAN_PULLS_KEPT = 256

    def __init__(self, policy: str = "affinity",
                 poll_interval_s: float = 0.05, dead_after: int = 3,
                 admit_timeout_s: float = 60.0,
                 rollup_every: int = 20, affinity_cap: int = 65536):
        if policy not in self.POLICIES:
            raise ValueError(f"policy must be one of {self.POLICIES}, "
                             f"got {policy!r}")
        self.policy = policy
        self.poll_interval_s = float(poll_interval_s)
        self.dead_after = int(dead_after)
        self.admit_timeout_s = float(admit_timeout_s)
        self.rollup_every = int(rollup_every)
        self.affinity_cap = int(affinity_cap)
        self._replicas: "OrderedDict[str, ReplicaHandle]" = \
            OrderedDict()
        self._affinity: "OrderedDict[str, str]" = OrderedDict()
        self._salt: Optional[bytes] = None
        self._page: Optional[int] = None
        self._config_fp: Optional[str] = None
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._inflight: Dict[str, set] = {}  # replica -> streams
        self._events: "deque" = deque(maxlen=64)
        self._rollup: dict = {}
        self._rr_next = 0
        self._monitor: Optional[threading.Thread] = None
        self._closing = threading.Event()
        self.stats = {"submitted": 0, "affinity_hits": 0,
                      "affinity_misses": 0, "failovers": 0,
                      "failover_seconds": None}
        from ..observability import opsserver

        opsserver.register_fleet(self)

    # -- membership ----------------------------------------------------------
    def add_replica(self, name: str, edge_url: str,
                    ops_url: Optional[str] = None,
                    journal_dir: Optional[str] = None) -> ReplicaHandle:
        """Join one replica.  Validates the wiring LOUDLY: a replica
        whose ops plane is off (``FLAGS_ops_port=0``, no listener)
        cannot be admitted against — refusing here beats a router that
        silently reads it never-ready forever."""
        rep = ReplicaHandle(name, edge_url, ops_url=ops_url,
                            journal_dir=journal_dir)
        info = rep.fetch_info()
        if rep.ops_url is None:
            ops_port = info.get("ops_port")
            if not ops_port:
                raise FleetConfigError(
                    f"replica {name!r} ({edge_url}) has no ops plane: "
                    f"/v1/info reports ops_port={ops_port!r}.  The "
                    f"fleet router admits by polling /readyz — start "
                    f"the replica with FLAGS_ops_port=<port> (or "
                    f"start_ops_server()) or pass ops_url= "
                    f"explicitly.  A replica the router cannot poll "
                    f"would silently never take traffic.")
            host = urllib.parse.urlsplit(rep.edge_url).hostname
            rep.ops_url = f"http://{host}:{int(ops_port)}"
        fp = info.get("config_fp")
        with self._lock:
            if self._config_fp is None:
                self._config_fp = fp
                self._salt = bytes.fromhex(info.get("route_salt") or "")
                self._page = int(info.get("page_size") or 0)
            elif fp != self._config_fp:
                raise FleetConfigError(
                    f"replica {name!r} config fingerprint {fp!r} "
                    f"differs from the fleet's {self._config_fp!r} — "
                    f"zero-loss failover requires identical model "
                    f"weights and engine construction config across "
                    f"replicas")
            self._replicas[name] = rep
            self._inflight.setdefault(name, set())
        rep.poll()
        return rep

    def start(self):
        """Start the monitor thread (idempotent)."""
        if self._monitor is None:
            self._monitor = threading.Thread(
                target=self._monitor_main, name="fleet-monitor",
                daemon=True)
            self._monitor.start()

    def close(self):
        self._closing.set()
        if self._monitor is not None:
            self._monitor.join(timeout=5)
            self._monitor = None
        from ..observability import opsserver

        opsserver.deregister_fleet(self)

    # -- submission ----------------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens: int = 32,
               **request_kwargs) -> FleetStream:
        """Route one request and stream its tokens (returns
        immediately; the `FleetStream`'s reader thread does the
        work).  With FLAGS_fleet_trace on, mints the request's fleet
        trace id here — the one identity that survives every HTTP hop
        and failover."""
        self.start()
        with self._lock:
            self.stats["submitted"] += 1
        trace_id = fleettrace.mint_trace_id() if fleettrace.enabled() \
            else None
        return FleetStream(self, prompt_ids, max_new_tokens,
                           request_kwargs, trace_id=trace_id)

    # -- routing -------------------------------------------------------------
    def _route_key(self, prompt_ids) -> List[str]:
        """Hex chain hashes of every full page of ``prompt_ids`` under
        the fleet's shared salt — byte-identical to the digests the
        replicas' prefix caches key on."""
        if not self._page or self._salt is None:
            return []
        h = self._salt
        out = []
        for i in range(len(prompt_ids) // self._page):
            h = _chain_hash(
                h, prompt_ids[i * self._page:(i + 1) * self._page])
            out.append(h.hex())
        return out

    def _route(self, stream: FleetStream) -> ReplicaHandle:
        """Pick the replica for one fresh request: affinity first
        (longest matching prefix hash held by an ADMISSIBLE replica),
        else predicted-cost-aware least-loaded / round-robin.  Blocks
        while no replica is admissible (bounded by
        ``admit_timeout_s``)."""
        hashes = self._route_key(stream.prompt_ids)
        t0_ns = _obs.now_ns() if fleettrace.enabled() else 0
        deadline = time.perf_counter() + self.admit_timeout_s
        with self._cond:
            while True:
                cands = [r for r in self._replicas.values()
                         if r.admissible()]
                if cands:
                    chosen, hit = self._pick(cands, hashes)
                    chosen.assigned_since_poll += 1
                    stream.affinity_hit = hit
                    self.stats["affinity_hits" if hit
                               else "affinity_misses"] += 1
                    for hx in hashes:
                        self._affinity[hx] = chosen.name
                        self._affinity.move_to_end(hx)
                    while len(self._affinity) > self.affinity_cap:
                        self._affinity.popitem(last=False)
                    (_obs.FLEET_AFFINITY_HITS if hit else
                     _obs.FLEET_AFFINITY_MISSES).inc(
                        replica=chosen.name)
                    if fleettrace.enabled():
                        # the routing decision as a span: which
                        # replica, why (affinity vs load), and how
                        # long admission blocked
                        args = {"replica": chosen.name,
                                "affinity_hit": bool(hit),
                                "prefix_hashes": len(hashes),
                                "headroom": int(chosen.headroom)}
                        if stream.trace_id is not None:
                            args["trace"] = stream.trace_id
                        _obs.record_span(
                            "router", "route", t0_ns,
                            _obs.now_ns() - t0_ns, args=args)
                    return chosen
                if time.perf_counter() >= deadline:
                    raise RuntimeError(
                        f"no admissible replica within "
                        f"{self.admit_timeout_s}s "
                        f"(replicas: "
                        f"{[(r.name, r.alive, r.ready, r.headroom) for r in self._replicas.values()]})")
                self._cond.wait(timeout=self.poll_interval_s)

    def _pick(self, cands: List[ReplicaHandle], hashes: List[str]):
        """(replica, affinity_hit) among admissible candidates."""
        if self.policy == "affinity" and hashes:
            by_name = {r.name: r for r in cands}
            for hx in reversed(hashes):  # longest prefix first
                name = self._affinity.get(hx)
                if name in by_name:
                    return by_name[name], True
        if self.policy == "round_robin":
            names = sorted(r.name for r in cands)
            name = names[self._rr_next % len(names)]
            self._rr_next += 1
            return next(r for r in cands if r.name == name), False
        # least-loaded with predicted-cost preference: replicas whose
        # calibrated predictor says the next step still meets the SLO
        # ceiling outrank ones it says will blow it
        cost_ok = [r for r in cands if r.slo_ok is not False]
        pool = cost_ok or cands
        return max(pool, key=lambda r:
                   r.headroom - r.assigned_since_poll), False

    # -- stream bookkeeping --------------------------------------------------
    def _stream_attached(self, stream: FleetStream,
                         replica: ReplicaHandle):
        with self._lock:
            self._inflight.setdefault(replica.name, set()).add(stream)

    def _stream_closed(self, stream: FleetStream):
        with self._lock:
            for streams in self._inflight.values():
                streams.discard(stream)

    # -- failover ------------------------------------------------------------
    def _await_failover(self,
                        stream: FleetStream) -> Optional[ReplicaHandle]:
        """A stream's SSE leg broke: make sure its replica's failover
        runs (first caller executes it; the monitor may beat us to
        it), then hand back the survivor + resume coordinates."""
        with self._lock:
            rep = self._replicas.get(stream.replica)
        if rep is None:
            return None
        self._failover(rep)
        if not rep.fo_event.wait(timeout=120):
            return None
        migration = rep.migration
        if migration is None:
            return None
        survivor_name, migrated = migration
        with self._lock:
            survivor = self._replicas.get(survivor_name)
        if survivor is None:
            return None
        if stream.remote_id is None:
            # the replica died between admission and the meta event:
            # we cannot name our journaled twin, so re-submit fresh
            # (zero tokens were delivered; the orphaned adoptee on
            # the survivor runs out harmlessly)
            return self._route(stream)
        entry = migrated.get(stream.remote_id) or \
            migrated.get(str(stream.remote_id))
        if entry is None:
            # admitted on the dead replica but never journaled (died
            # pre-fsync with journal_fsync != always): re-submit
            return self._route(stream)
        stream._resume_from = (stream.remote_id, survivor)
        return survivor

    def _failover(self, dead: ReplicaHandle):
        """Adopt ``dead``'s journal into a survivor exactly once."""
        with dead._fo_lock:
            if dead.failed_over:
                return
            dead.failed_over = True
        t0 = time.perf_counter()
        t0_ns = _obs.now_ns() if fleettrace.enabled() else 0
        with self._lock:
            dead.alive = False
            dead.ready = False
            inflight = list(self._inflight.get(dead.name, ()))
        delivered = {s.remote_id: len(s.tokens) for s in inflight
                     if s.remote_id is not None}
        traces = {s.remote_id: s.trace_id for s in inflight
                  if s.remote_id is not None and
                  s.trace_id is not None}
        self._events.append({
            "event": "replica_dead", "replica": dead.name,
            "inflight": len(inflight)})
        if fleettrace.enabled():
            _obs.record_span("router", "replica_dead", t0_ns, 0,
                             args={"replica": dead.name,
                                   "inflight": len(inflight)})
        survivor = None
        deadline = time.perf_counter() + self.admit_timeout_s
        migrated: dict = {}
        while time.perf_counter() < deadline:
            with self._lock:
                cands = [r for r in self._replicas.values()
                         if r is not dead and r.alive and r.ready]
            if cands:
                survivor = max(cands, key=lambda r: r.headroom)
                try:
                    t_adopt = _obs.now_ns() if fleettrace.enabled() \
                        else 0
                    migrated = survivor.adopt(dead.journal_dir,
                                              delivered,
                                              traces=traces or None)
                    if fleettrace.enabled():
                        _obs.record_span(
                            "router", "adopt", t_adopt,
                            _obs.now_ns() - t_adopt,
                            args={"donor": dead.name,
                                  "survivor": survivor.name,
                                  "migrated": len(migrated)})
                    break
                except Exception as e:
                    self._events.append({
                        "event": "adopt_failed",
                        "replica": survivor.name, "error": str(e)})
                    survivor = None
            time.sleep(self.poll_interval_s)
        if survivor is None:
            dead.migration = None
            dead.fo_event.set()
            self._events.append({"event": "failover_failed",
                                 "replica": dead.name})
            return
        migrated = {int(k): v for k, v in migrated.items()}
        dt = time.perf_counter() - t0
        with self._lock:
            # future requests for the dead replica's prefixes now
            # belong to the survivor holding the adopted pages
            for hx, name in list(self._affinity.items()):
                if name == dead.name:
                    self._affinity[hx] = survivor.name
            self.stats["failovers"] += 1
            self.stats["failover_seconds"] = dt
        _obs.FLEET_FAILOVERS.inc()
        _obs.FLEET_FAILOVER_SECONDS.set(dt)
        if fleettrace.enabled():
            _obs.record_span(
                "router", "failover", t0_ns, _obs.now_ns() - t0_ns,
                args={"replica": dead.name, "survivor": survivor.name,
                      "migrated": len(migrated)})
        self._events.append({
            "event": "failover", "replica": dead.name,
            "survivor": survivor.name, "migrated": len(migrated),
            "delivered_reported": sum(delivered.values()),
            "seconds": round(dt, 4)})
        dead.migration = (survivor.name, migrated)
        dead.fo_event.set()

    # -- monitor -------------------------------------------------------------
    def _monitor_main(self):
        rounds = 0
        while not self._closing.is_set():
            with self._lock:
                reps = list(self._replicas.values())
            ready = 0
            for rep in reps:
                if not rep.alive:
                    continue
                if rep.poll():
                    ready += 1
                elif rep.failures >= self.dead_after and \
                        not rep.failed_over:
                    # consecutive refusals = dead process (kill -9
                    # closes the listener instantly); streams may not
                    # have noticed yet — the monitor runs failover so
                    # even a replica with NO open streams gets its
                    # queued journal replayed
                    self._failover(rep)
            _obs.FLEET_REPLICAS_READY.set(ready)
            with self._cond:
                self._cond.notify_all()
            rounds += 1
            if rounds % self.rollup_every == 1:
                self._refresh_rollup(ready)
            self._closing.wait(self.poll_interval_s)

    def _refresh_rollup(self, ready: int):
        from ..observability.alerts import fleet_rollup

        with self._lock:
            reps = list(self._replicas.items())
            events = list(self._events)
        docs = {}
        for name, rep in reps:
            doc = rep.alertz() if rep.alive else None
            if doc is not None:
                # a replica's /alertz may itself embed a fleet section
                # (this router registers with the shared ops plane in
                # in-process fleets) — strip it or rollups would nest
                doc = {k: v for k, v in doc.items() if k != "fleet"}
            docs[name] = doc
        rollup = fleet_rollup(docs, events=events,
                              replicas_ready=ready)
        with self._lock:
            self._rollup = rollup

    def alertz_rollup(self) -> dict:
        """The cached fleet-level `/alertz` section (see
        `observability.alerts.fleet_rollup`); refreshed by the monitor
        every ``rollup_every`` polls.  Cache-only by design: this is
        called from the ops server's own /alertz handler, and
        refreshing synchronously would recurse through HTTP (handler
        -> rollup -> GET replica /alertz -> handler ...)."""
        with self._lock:
            if self._rollup:
                return dict(self._rollup)
            return {"replicas": {}, "reachable": 0, "firing": {},
                    "paging": False, "pending": True}

    # -- fleet rollup (/fleetz) ----------------------------------------------
    @staticmethod
    def _fetch_text(url: str, timeout: float) -> Optional[str]:
        try:
            with urllib.request.urlopen(url, timeout=timeout) as resp:
                return resp.read().decode("utf-8", "replace")
        except Exception:
            return None

    def fleetz(self, trace: Optional[str] = None) -> dict:
        """The fleet-wide rollup surface (served at ``/fleetz``): one
        document aggregating every replica's ``/metrics`` (Prometheus
        text), ``/alertz`` and ``/statusz``, the poll-measured RTT and
        NTP-style clock-offset estimates, the router's failover event
        log, and — the point of the exercise — ONE merged chrome trace
        (`observability.fleettrace.merge_fleet_trace`): each replica's
        span buffer is pulled over its edge's ``/tracez/spans``,
        shifted onto the router's clock, and folded together with the
        router's own routing/failover spans, so a killed-and-adopted
        request renders as a single contiguous lane under its trace
        id.  ``trace`` narrows the span pull to one trace id.

        Synchronous by design (unlike `alertz_rollup`): ``/fleetz`` is
        served by the ROUTER process's ops plane but fetches REPLICA
        endpoints, so there is no handler recursion to avoid."""
        with self._lock:
            reps = list(self._replicas.items())
            events = list(self._events)
            stats = dict(self.stats)
        replicas: Dict[str, dict] = {}
        spans: Dict[str, list] = {}
        offsets: Dict[str, int] = {}
        q = "?trace=" + urllib.parse.quote(trace) if trace else ""
        for name, rep in reps:
            entry = {
                "alive": rep.alive, "ready": rep.ready,
                "headroom": int(rep.headroom),
                "poll_rtt_s": rep.poll_rtt_s,
                "clock_offset_ns": rep.clock_offset_ns(),
            }
            if rep.alive and rep.ops_url:
                entry["metrics"] = self._fetch_text(
                    rep.ops_url + "/metrics", rep.timeout_s)
                try:
                    entry["alertz"] = _get_json(
                        rep.ops_url + "/alertz", rep.timeout_s)
                except Exception:
                    entry["alertz"] = None
                try:
                    entry["statusz"] = _get_json(
                        rep.ops_url + "/statusz", rep.timeout_s)
                except Exception:
                    entry["statusz"] = None
            if rep.alive:
                try:
                    doc = _get_json(
                        rep.edge_url + "/tracez/spans" + q,
                        rep.timeout_s)
                    spans[name] = doc.get("spans") or []
                    offsets[name] = rep.clock_offset_ns()
                except Exception:
                    pass
                else:
                    with self._lock:
                        rep.spans_pulled[q] = spans[name]
                        rep.spans_pulled.move_to_end(q)
                        while len(rep.spans_pulled) > self.SPAN_PULLS_KEPT:
                            rep.spans_pulled.popitem(last=False)
            else:
                with self._lock:
                    last = rep.spans_pulled.get(q)
                if last is not None:
                    # a dead replica's spans, as last pulled: the donor's
                    # segment of a migrated request stays on its lane
                    spans[name] = last
                    offsets[name] = rep.clock_offset_ns()
                    entry["spans"] = "last pull"
            replicas[name] = entry
        # the router's own span buffer joins the merge at offset 0 —
        # routing and failover spans share the fleet timeline
        from ..observability import tracing

        local = fleettrace.span_slice(tracing.spans(), trace=trace)
        if local:
            spans["router"] = local
            offsets["router"] = 0
        return {
            "replicas": replicas,
            "events": events,
            "stats": stats,
            "alerts": self.alertz_rollup(),
            "trace": fleettrace.merge_fleet_trace(spans, offsets),
        }
