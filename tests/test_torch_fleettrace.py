"""Fleet-scope tracing of the port (``FLAGS_fleet_trace``,
`paddle_tpu_torch.observability.fleettrace`) against the JAX package's
(the scenarios of tests/test_fleettrace.py).

* the primitives — `span_slice`, `ClockSync`, `merge_fleet_trace` and
  the trace id — give output equal to JAX's on the same inputs;
* off is off: with the flag at its default a stray ``x-paddle-trace``
  header changes nothing, request spans carry no trace and the journal
  is byte-identical to a serve without the header;
* on: the header reaches the request's spans, flight slots, journal and
  ``/tracez/spans``; ``/readyz`` carries ``now_ns`` only while on;
* failover keeps the trace id across adoption and renders one lane;
* a live two-replica fleet mints ids, records route spans and serves
  ``/fleetz``, in both packages.
"""
import torch_test_env  # noqa: F401  (first: one intra-op thread)
import gc
import json
import os
import time
import types
import urllib.request

import pytest

from paddle_tpu.observability import fleettrace as JFT
from paddle_tpu_torch.observability import alerts as TAL
from paddle_tpu_torch.observability import fleettrace as TFT
from paddle_tpu_torch.observability import tracing as TTR
from paddle_tpu_torch.tools import explain_request

from torch_fleet_common import (HTTP_TIMEOUT, NEW, P1, SIDES, Fleet,
                                drain_sse, post, stop_all)


@pytest.fixture(autouse=True)
def _clean():
    gc.collect()
    stop_all()
    yield
    stop_all()


@pytest.fixture
def port_fl():
    return Fleet("torch")


@pytest.fixture
def trace_on(port_fl):
    with port_fl.side.flags(fleet_trace=True):
        yield


def _wait_for(pred, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        got = pred()
        if got:
            return got
        time.sleep(0.02)
    return pred()


def _request_span_traces():
    return [(args or {}).get("trace")
            for track, _n, _s, _d, _t, args in TTR.spans()
            if track == "requests"]


def _journal_bytes(jdir):
    out = []
    for name in sorted(os.listdir(jdir)):
        with open(os.path.join(jdir, name), "rb") as f:
            out.append(f.read())
    return b"\n".join(out)


# ---------------------------------------------------------------------------
# the primitives, equal to JAX's
# ---------------------------------------------------------------------------
SPANS = [
    ("requests", "decode", 100, 50, 1, {"trace": "aa"}),
    ("requests", "decode", 300, 50, 2, {"trace": "bb"}),
    ("engine", "prefill", 900, 10, 0, None),
    ("edge", "sse", 280, 200, 2, {"trace": "bb", "request": 2}),
]


class TestPrimitives:
    def test_constants_and_mint(self):
        assert TFT.TRACE_HEADER == JFT.TRACE_HEADER
        assert TFT.REQUEST_TRACKS == JFT.REQUEST_TRACKS
        assert set(TFT.__all__) == set(JFT.__all__)
        ids = {TFT.mint_trace_id() for _ in range(64)}
        assert len(ids) == 64
        assert all(len(t) == 16 and int(t, 16) >= 0 for t in ids)

    @pytest.mark.parametrize("query", [
        {}, {"trace": "aa"}, {"trace": "bb"}, {"trace": "zz"},
        {"since_ns": 320, "until_ns": 800}, {"since_ns": 0},
        {"until_ns": 150}, {"trace": "bb", "since_ns": 400}])
    def test_span_slice_equals_jax(self, query):
        assert TFT.span_slice(SPANS, **query) == \
            JFT.span_slice(SPANS, **query)

    def test_span_slice_filters_trace_and_window(self):
        by_trace = TFT.span_slice(SPANS, trace="aa")
        assert [s["tid"] for s in by_trace] == [1]
        windowed = TFT.span_slice(SPANS, since_ns=320, until_ns=800)
        assert [s["start_ns"] for s in windowed] == [300, 280]

    def test_clock_sync_equals_jax(self):
        samples = [("r0", 0, 1000, 10_500), ("r0", 0, 9000, 77_777),
                   ("r0", 100, 500, 20_300), ("r1", 5, 25, -40),
                   ("r1", 10, 12, 7)]
        t, j = TFT.ClockSync(), JFT.ClockSync()
        for s in samples:
            assert t.observe(*s) == j.observe(*s)
        assert t.snapshot() == j.snapshot()
        assert t.offset_ns("r0") == 20_000
        assert t.offset_ns("nobody") == j.offset_ns("nobody") == 0

    def test_merge_equals_jax_single_lane(self):
        t = "feedfacefeedface"
        spans = {
            "r0": [{"track": "requests", "name": "prefill",
                    "start_ns": 1_000, "dur_ns": 500, "tid": 5,
                    "args": {"trace": t}},
                   {"track": "engine", "name": "prefill",
                    "start_ns": 1_000, "dur_ns": 500, "tid": 0,
                    "args": None},
                   {"track": "requests", "name": "queued",
                    "start_ns": 800, "dur_ns": 100, "tid": 6}],
            "r1": [{"track": "requests", "name": "decode",
                    "start_ns": 9_000, "dur_ns": 500, "tid": 31,
                    "args": {"trace": t}}],
        }
        offsets = {"r0": 0, "r1": 2_000}
        merged = TFT.merge_fleet_trace(spans, offsets_ns=offsets)
        assert merged == JFT.merge_fleet_trace(spans, offsets_ns=offsets)
        events = merged["traceEvents"]
        procs = {ev["pid"]: ev["args"]["name"] for ev in events
                 if ev.get("name") == "process_name"}
        req = [ev for ev in events if ev.get("ph") == "X"
               and procs[ev["pid"]] == "requests"
               and ev["args"].get("trace") == t]
        assert len({(ev["pid"], ev["tid"]) for ev in req}) == 1
        assert {ev["args"]["replica"] for ev in req} == {"r0", "r1"}
        decode = next(ev for ev in req if ev["name"] == "decode")
        assert decode["ts"] == (9_000 - 2_000) / 1e3
        assert TFT.merge_fleet_trace({}) == JFT.merge_fleet_trace({})

    def test_enabled_reads_the_port_flag(self, port_fl):
        assert not TFT.enabled()
        with port_fl.side.flags(fleet_trace=True):
            assert TFT.enabled() and not JFT.enabled()


# ---------------------------------------------------------------------------
# off is off
# ---------------------------------------------------------------------------
class TestFlagOffBitExact:
    def test_spans_and_journal_carry_no_trace(self, port_fl, tmp_path):
        jd = str(tmp_path / "journal")
        eng = port_fl.engine(journal_dir=jd)
        eng.add_request(P1, max_new_tokens=NEW)
        eng.run()
        traces = _request_span_traces()
        assert traces and all(t is None for t in traces)
        assert all(track not in ("edge", "router")
                   for track, *_ in TTR.spans())
        assert b'"tr"' not in _journal_bytes(jd)

    def test_stray_header_changes_nothing_when_off(self, port_fl,
                                                   tmp_path):
        """Two edge serves, one with a stray trace header: equal tokens,
        the same spans (track, name, args) and byte-identical journals."""
        runs = []
        for header in (None, {"x-paddle-trace": "deadbeefdeadbeef"}):
            port_fl.side.reset()
            jd = str(tmp_path / f"j{len(runs)}")
            edge, port = port_fl.edge(journal_dir=jd)
            try:
                resp = post(f"http://127.0.0.1:{port}/v1/generate",
                            {"prompt_ids": P1, "max_new_tokens": NEW},
                            headers=header)
                _meta, toks, done = drain_sse(resp)
                assert done["finish_reason"] in ("eos", "length")
            finally:
                edge.close()
            spans = sorted((tr, n, json.dumps(a, sort_keys=True))
                           for tr, n, _s, _d, _t, a in TTR.spans()
                           if tr == "requests")
            runs.append((toks, spans, _journal_bytes(jd)))
        assert runs[1] == runs[0]
        assert all(t is None for t in _request_span_traces())
        assert all(track != "edge" for track, *_ in TTR.spans())


# ---------------------------------------------------------------------------
# on: header -> request -> spans/flight/journal/tracez
# ---------------------------------------------------------------------------
class TestPropagation:
    def test_header_to_spans_flight_journal_and_tracez(
            self, port_fl, tmp_path, trace_on):
        t = TFT.mint_trace_id()
        jd = str(tmp_path / "journal")
        edge, port = port_fl.edge(journal_dir=jd, flight_window=64)
        eng = edge.engine
        try:
            resp = post(f"http://127.0.0.1:{port}/v1/generate",
                        {"prompt_ids": P1, "max_new_tokens": NEW},
                        headers={TFT.TRACE_HEADER: t})
            _meta, _toks, done = drain_sse(resp)
            assert done["finish_reason"] in ("eos", "length")
            traces = _request_span_traces()
            assert traces and all(tr == t for tr in traces)
            assert _wait_for(lambda: [
                1 for track, name, _s, _d, _tid, args in TTR.spans()
                if track == "edge" and name == "sse"
                and (args or {}).get("trace") == t])
            slots = [s for rec in eng._flight.snapshot()["records"]
                     for s in rec.get("slots", [])]
            assert slots and all(s.get("trace") == t for s in slots)
            assert f'"tr":"{t}"'.encode() in _journal_bytes(jd)
            doc = json.loads(urllib.request.urlopen(
                f"http://127.0.0.1:{port}/tracez/spans?trace={t}",
                timeout=HTTP_TIMEOUT).read())
            assert doc["spans"]
            assert all(s["args"]["trace"] == t for s in doc["spans"])
            assert isinstance(doc["now_ns"], int)
            assert doc["engine_id"] == eng._engine_id
        finally:
            edge.close()

    def test_readyz_serves_now_ns_only_when_on(self, port_fl):
        eng = port_fl.engine()  # noqa: F841  (a live engine to report)
        off = port_fl.ops.readiness()
        assert "now_ns" not in off
        with port_fl.side.flags(fleet_trace=True):
            on = port_fl.ops.readiness()
        assert isinstance(on["now_ns"], int)
        assert {k: v for k, v in on.items() if k != "now_ns"} == off


# ---------------------------------------------------------------------------
# failover: the same trace id across the adoption, one merged lane
# ---------------------------------------------------------------------------
class TestFailoverContinuity:
    def test_adopted_stream_keeps_trace_and_single_lane(
            self, port_fl, tmp_path, trace_on):
        t = TFT.mint_trace_id()
        jd = str(tmp_path / "journal")
        dead = port_fl.engine(journal_dir=jd, flight_window=64)
        req = dead.add_request(P1, max_new_tokens=NEW, trace_id=t)
        streamed = []
        req.on_token = streamed.append
        for _ in range(6):
            dead.step()
        assert len(streamed) >= 3 and req.state != "done"
        donor_dump = dead._flight.snapshot()
        delivered = len(streamed) - 1
        edge, port = port_fl.edge(flight_window=64)
        survivor = edge.engine
        try:
            out = json.loads(post(
               f"http://127.0.0.1:{port}/v1/adopt",
               {"journal_dir": jd,
                "delivered": {req.request_id: delivered}}).read())
            entry = out["migrated"][str(req.request_id)]
            assert entry["trace"] == t  # the journal's "tr" survived
            new_rid = int(entry["request_id"])
            resp = urllib.request.urlopen(
                f"http://127.0.0.1:{port}/v1/resume"
                f"?request={req.request_id}", timeout=HTTP_TIMEOUT)
            _meta, _toks, done = drain_sse(resp)
            assert done["finish_reason"] in ("eos", "length")
        finally:
            edge.close()
        adopter_dump = survivor._flight.snapshot()
        assert _wait_for(lambda: [
            1 for track, _n, _s, _d, tid, args in TTR.spans()
            if track == "requests" and tid == new_rid
            and (args or {}).get("trace") == t])
        for dump in (donor_dump, adopter_dump):
            assert explain_request.trace_requests(dump, t)
        report = "\n".join(explain_request.explain_trace(
            [("donor", donor_dump), ("adopter", adopter_dump)], t))
        assert "[donor]" in report and "[adopter]" in report
        spans = TFT.span_slice(TTR.spans(), trace=t)
        merged = TFT.merge_fleet_trace({"dead": spans, "survivor": spans})
        procs = {ev["pid"]: ev["args"]["name"]
                 for ev in merged["traceEvents"]
                 if ev.get("name") == "process_name"}
        lanes = {(ev["pid"], ev["tid"]) for ev in merged["traceEvents"]
                 if ev.get("ph") == "X" and procs[ev["pid"]] == "requests"}
        assert len(lanes) == 1


# ---------------------------------------------------------------------------
# the live fleet: minted ids, route spans, poll RTT, /fleetz
# ---------------------------------------------------------------------------
def _two_replica_fleet(fl):
    edge1, p1 = fl.edge()
    edge2, p2 = fl.edge()
    ops = fl.ops.start_ops_server(port=0, host="127.0.0.1")
    router = fl.FL.FleetRouter(poll_interval_s=0.02)
    router.add_replica("r0", f"http://127.0.0.1:{p1}")
    router.add_replica("r1", f"http://127.0.0.1:{p2}")
    router.start()
    return router, (edge1, edge2), ops


class TestFleetRollup:
    @pytest.mark.parametrize("side", SIDES)
    def test_router_mints_and_fleetz_merges(self, side):
        fl = Fleet(side)
        with fl.side.flags(fleet_trace=True):
            router, edges, ops = _two_replica_fleet(fl)
            try:
                s = router.submit(P1, max_new_tokens=NEW)
                s.result(timeout=120)
                assert s.trace_id and len(s.trace_id) == 16
                route = [(args or {}) for track, name, _s, _d, _t, args
                         in fl.side.obs.spans()
                         if track == "router" and name == "route"]
                assert any(a.get("trace") == s.trace_id for a in route)
                # the rollup over the router process's own ops plane
                doc = json.loads(urllib.request.urlopen(
                    f"http://127.0.0.1:{ops}/fleetz?trace={s.trace_id}",
                    timeout=HTTP_TIMEOUT).read())
                cards = doc["replicas"]
                assert set(cards) == {"r0", "r1"}
                assert all(c["poll_rtt_s"] is not None
                           and "clock_offset_ns" in c
                           for c in cards.values())
                assert "paddle_fleet_poll_rtt_seconds" in \
                    fl.side.obs.prometheus_text()
                events = doc["trace"]["traceEvents"]
                procs = {ev["pid"]: ev["args"]["name"] for ev in events
                         if ev.get("name") == "process_name"}
                lanes = {(ev["pid"], ev["tid"]) for ev in events
                         if ev.get("ph") == "X"
                         and procs.get(ev["pid"]) == "requests"}
                assert len(lanes) == 1
                assert doc["stats"]["submitted"] == 1
            finally:
                router.close()
                for e in edges:
                    e.close()

    def test_flag_off_fleet_mints_nothing(self, port_fl):
        router, edges, _ops = _two_replica_fleet(port_fl)
        try:
            s = router.submit(P1, max_new_tokens=NEW)
            s.result(timeout=120)
            assert s.trace_id is None
            assert all(track not in ("router", "edge")
                       for track, *_ in TTR.spans())
        finally:
            router.close()
            for e in edges:
                e.close()

    def test_dead_replica_keeps_its_last_pulled_spans(self, port_fl,
                                                      trace_on):
        """The port's one addition to `/fleetz`: a replica that died
        keeps, in the merge, the slice last pulled from it under the
        same query."""
        router, edges, _ops = _two_replica_fleet(port_fl)
        try:
            s = router.submit(P1, max_new_tokens=NEW)
            s.result(timeout=120)
            before = router.fleetz(trace=s.trace_id)
            rep = router._replicas[s.replica]
            rep.alive = False
            after = router.fleetz(trace=s.trace_id)
            assert after["replicas"][s.replica]["spans"] == "last pull"
            assert after["trace"] == before["trace"]
            other = router.fleetz(trace="0" * 16)
            assert "spans" not in other["replicas"][s.replica]
        finally:
            router.close()
            for e in edges:
                e.close()


# ---------------------------------------------------------------------------
# span-buffer pressure: the page-exempt drop alert
# ---------------------------------------------------------------------------
class TestDropAlert:
    def test_rule_is_ticket_severity(self):
        rule = next(r for r in TAL.default_rules()
                    if r.name == "trace_span_drops")
        assert rule.severity == "ticket"

    def test_signal_fires_on_growth_between_evaluations(self,
                                                        monkeypatch):
        eng = types.SimpleNamespace(_engine_id=987654)
        sig = TAL.SIGNALS["trace_span_drop_delta"]
        counts = iter([10.0, 10.0, 25.0])
        monkeypatch.setattr(TTR, "dropped_span_count",
                            lambda: next(counts))
        assert sig(eng) is None
        assert sig(eng) == 0.0
        assert sig(eng) == 15.0
        TAL._trace_drop_seen.pop(987654, None)
