"""Fleet serving of the port (`paddle_tpu_torch.fleet`) against the JAX
package's (`paddle_tpu.fleet`, the scenarios of tests/test_fleet.py):
the HTTP/SSE edge, the prefix-affinity router, zero-loss failover through
``/v1/adopt`` + ``/v1/resume``, and the fleet ``/alertz`` rollup.

Each scenario runs on both packages (``side``), over the same tiny GPT
(the port's weights come through `params_from_numpy`); greedy tokens are
held exactly equal to one oracle, the JAX engine's uninterrupted
``generate``.  Two cross-package scenarios put the JAX router in front
of port edges and replay a JAX engine's journal into a port edge.  The
chaos test kills one of two port replica processes (the CPU's tiny GPT,
`tests/torch_fleet_child.py`) with SIGKILL mid-generation and holds
every stream to the oracle.  ``test_edge_round_trip_on_card`` needs a
CUDA device."""
import torch_test_env  # noqa: F401  (first: one intra-op thread)
import gc
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error

import numpy as np
import pytest
import torch

from paddle_tpu.observability import alerts as JAL
from paddle_tpu_torch import fleet as TFL
from paddle_tpu_torch.observability import alerts as TAL

from torch_fleet_common import (NEW, P1, P2, SIDES, Fleet, drain_sse, get,
                                post, stop_all)
from torch_reliability_common import TINY


@pytest.fixture(autouse=True)
def _clean():
    gc.collect()
    stop_all()
    yield
    stop_all()


@pytest.fixture(params=SIDES)
def fl(request):
    return Fleet(request.param)


@pytest.fixture(scope="module")
def oracle():
    """Uninterrupted greedy outputs every edge, fleet and failover serve
    must reproduce exactly: the JAX engine's, equal to the port's."""
    outs = {}
    for name in SIDES:
        eng = Fleet(name).engine()
        got = eng.generate([P1, P2], max_new_tokens=NEW)
        outs[name] = {tuple(P1): list(got[0]), tuple(P2): list(got[1])}
    assert outs["torch"] == outs["jax"]
    return outs["jax"]


# ---------------------------------------------------------------------------
# the HTTP/SSE edge
# ---------------------------------------------------------------------------
class TestEdge:
    def test_generate_sse_round_trip_matches_oracle(self, fl, oracle):
        edge, port = fl.edge()
        try:
            for p in (P1, P2):
                resp = post(f"http://127.0.0.1:{port}/v1/generate",
                            {"prompt_ids": p, "max_new_tokens": NEW})
                assert resp.status == 200
                assert resp.headers["Content-Type"] \
                    .startswith("text/event-stream")
                meta, toks, done = drain_sse(resp)
                assert meta["start_index"] == 0
                assert isinstance(meta["request_id"], int)
                assert toks == oracle[tuple(p)]
                assert done["finish_reason"] in ("eos", "length")
                assert done["n"] == len(toks)
        finally:
            edge.close()

    def test_info_document(self, fl):
        edge, port = fl.edge()
        eng = edge.engine
        try:
            info = json.loads(get(f"http://127.0.0.1:{port}/v1/info")
                              .read())
            assert info["engine_id"] == eng._engine_id
            assert info["config_fp"] == eng.config_fingerprint().hex()
            assert info["page_size"] == 4
            assert info["prefix_cache"] is True
            assert info["cache_generated_pages"] is False
            assert info["max_batch_size"] == 2
            assert info["route_salt"] == eng._model_salt.hex()
            assert info["ops_port"] is None  # no ops server running
            assert info["journal"] is None   # no journal armed
        finally:
            edge.close()

    def test_info_documents_equal_across_packages(self, tmp_path):
        """The same weights and configuration: equal digests, salt and
        keys in both packages' `/v1/info` (the router's inputs)."""
        docs = []
        for name in SIDES:
            fl = Fleet(name)
            edge, port = fl.edge(journal_dir=str(tmp_path / name))
            try:
                docs.append(json.loads(
                    get(f"http://127.0.0.1:{port}/v1/info").read()))
            finally:
                edge.close()
        jd, td = docs
        assert set(td) == set(jd)
        for k in ("config_fp", "route_salt", "page_size", "prefix_cache",
                  "cache_generated_pages", "max_batch_size"):
            assert td[k] == jd[k], k
        assert set(td["journal"]) == set(jd["journal"])
        assert td["journal"]["fsync"] == jd["journal"]["fsync"]
        assert td["journal"]["records"] == jd["journal"]["records"] == 1

    def test_validation_errors_are_400s(self, fl):
        edge, port = fl.edge()
        base = f"http://127.0.0.1:{port}"
        try:
            for body in ({"prompt_ids": [], "max_new_tokens": 4},
                         {"prompt_ids": P1, "max_new_tokens": 0},
                         {"max_new_tokens": 4}):
                with pytest.raises(urllib.error.HTTPError) as ei:
                    post(base + "/v1/generate", body)
                assert ei.value.code == 400
                assert "error" in json.loads(ei.value.read())
            with pytest.raises(urllib.error.HTTPError) as ei:
                post(base + "/v1/adopt", {})
            assert ei.value.code == 400
            with pytest.raises(urllib.error.HTTPError) as ei:
                get(base + "/v1/nowhere")
            assert ei.value.code == 404
        finally:
            edge.close()

    def test_resume_unknown_request_is_404(self, fl):
        edge, port = fl.edge()
        try:
            with pytest.raises(urllib.error.HTTPError) as ei:
                get(f"http://127.0.0.1:{port}/v1/resume?request=999")
            assert ei.value.code == 404
        finally:
            edge.close()


# ---------------------------------------------------------------------------
# routing key + placement policy (no HTTP)
# ---------------------------------------------------------------------------
def _fake_replica(fl, name, headroom=2, ready=True, slo_ok=None):
    rep = fl.FL.ReplicaHandle(name, f"http://127.0.0.1:1/{name}")
    rep.ready = ready
    rep.headroom = headroom
    rep.slo_ok = slo_ok
    return rep


def _bare_router(fl, reps, policy="affinity"):
    router = fl.FL.FleetRouter(policy=policy)
    for rep in reps:
        router._replicas[rep.name] = rep
        router._inflight[rep.name] = set()
    return router


class TestRouting:
    def test_route_key_matches_engine_prefix_chain(self):
        """The routing key is byte-identical in every place it is made:
        the port engine's prefix-cache keys (the pages it registers),
        both engines' `route_prefix_hashes` and both routers'
        `_route_key`, on the same weights."""
        jeng, teng = Fleet("jax").engine(), Fleet("torch").engine()
        assert teng._model_salt == jeng._model_salt
        routers = [fl.FL.FleetRouter() for fl in map(Fleet, SIDES)]
        try:
            for router in routers:
                router._salt = teng._model_salt
                router._page = 4
            for p in (P1, P2, [5] * 3):  # 3 pages, 2 pages, 0 pages
                key = teng.route_prefix_hashes(p)
                assert key == jeng.route_prefix_hashes(p)
                for router in routers:
                    assert router._route_key(p) == key
            assert teng.route_prefix_hashes([5] * 3) == []
            # the pages the port engine registers are keyed by them: a
            # 13-token prompt registers its 3 full pages
            teng.generate([P1 + [3]], max_new_tokens=2)
            keys = {h.hex() for h in teng.pool._hash_to_page}
            assert set(teng.route_prefix_hashes(P1)) <= keys
        finally:
            for router in routers:
                router.close()
        off = Fleet("torch").engine(prefix_cache=False)
        assert off.route_prefix_hashes(P1) == []

    def test_affinity_prefers_longest_prefix_holder(self, fl):
        a, b = _fake_replica(fl, "a"), _fake_replica(fl, "b")
        router = _bare_router(fl, [a, b])
        try:
            router._affinity["h0"] = "a"   # 1-page prefix -> a
            router._affinity["h1"] = "b"   # 2-page prefix -> b
            chosen, hit = router._pick([a, b], ["h0", "h1"])
            assert (chosen.name, hit) == ("b", True)
            chosen, hit = router._pick([a], ["h0", "h1"])
            assert (chosen.name, hit) == ("a", True)
            b.headroom = 5
            chosen, hit = router._pick([a, b], ["hx"])
            assert (chosen.name, hit) == ("b", False)
        finally:
            router.close()

    def test_round_robin_cycles(self, fl):
        reps = [_fake_replica(fl, n) for n in ("a", "b", "c")]
        router = _bare_router(fl, reps, policy="round_robin")
        try:
            picks = [router._pick(reps, [])[0].name for _ in range(6)]
            assert picks == ["a", "b", "c", "a", "b", "c"]
        finally:
            router.close()

    def test_admission_counts_unpolled_assignments(self, fl):
        a = _fake_replica(fl, "a", headroom=1)
        assert a.admissible()
        a.assigned_since_poll = 1
        assert not a.admissible()
        a.assigned_since_poll = 0
        a.ready = False
        assert not a.admissible()

    def test_cost_gate_prefers_slo_ok_replicas(self, fl):
        slow = _fake_replica(fl, "slow", headroom=5, slo_ok=False)
        fast = _fake_replica(fl, "fast", headroom=1, slo_ok=True)
        router = _bare_router(fl, [slow, fast])
        try:
            chosen, _ = router._pick([slow, fast], [])
            assert chosen.name == "fast"
            fast.slo_ok = False
            chosen, _ = router._pick([slow, fast], [])
            assert chosen.name == "slow"
        finally:
            router.close()

    def test_unknown_policy_refused(self, fl):
        with pytest.raises(ValueError, match="policy"):
            fl.FL.FleetRouter(policy="random")


# ---------------------------------------------------------------------------
# fleet wiring validation
# ---------------------------------------------------------------------------
class TestFleetConfig:
    def test_replica_without_ops_plane_refused(self, fl):
        edge, port = fl.edge()
        router = fl.FL.FleetRouter()
        try:
            with pytest.raises(fl.FL.FleetConfigError) as ei:
                router.add_replica("r0", f"http://127.0.0.1:{port}")
            msg = str(ei.value)
            assert "FLAGS_ops_port" in msg and "readyz" in msg
        finally:
            router.close()
            edge.close()

    def test_config_fingerprint_mismatch_refused(self, fl):
        edge1, p1 = fl.edge()
        edge2, p2 = fl.edge(page_size=8)
        fl.ops.start_ops_server(port=0, host="127.0.0.1")
        router = fl.FL.FleetRouter()
        try:
            router.add_replica("r0", f"http://127.0.0.1:{p1}")
            with pytest.raises(fl.FL.FleetConfigError) as ei:
                router.add_replica("r1", f"http://127.0.0.1:{p2}")
            assert "fingerprint" in str(ei.value)
        finally:
            router.close()
            edge1.close()
            edge2.close()


# ---------------------------------------------------------------------------
# zero-loss adoption: durability level
# ---------------------------------------------------------------------------
def _dead_replica(fl, tmp_path, steps=6, prompts=(P1, P2)):
    """A journaling engine that 'dies' mid-serve: its journal directory,
    its requests, and what each streamed."""
    jd = str(tmp_path / f"journal_{fl.side.name}")
    eng = fl.engine(journal_dir=jd)
    streamed = {}
    reqs = []
    for p in prompts:
        req = eng.add_request(p, max_new_tokens=NEW)
        req.on_token = (lambda rid: lambda t: streamed.setdefault(
            rid, []).append(t))(req.request_id)
        reqs.append(req)
    for _ in range(steps):
        eng.step()
    return jd, reqs, streamed


class TestAdoptFromDir:
    def test_token_for_token_continuity(self, fl, oracle, tmp_path):
        jd, reqs, streamed = _dead_replica(fl, tmp_path)
        assert any(streamed.values()), "kill must land mid-generation"
        delivered = {reqs[0].request_id: max(0, len(
            streamed.get(reqs[0].request_id, [])) - 2)}
        if reqs[1].request_id in streamed:
            delivered[reqs[1].request_id] = \
                len(streamed[reqs[1].request_id])
        survivor = fl.engine()
        got = {}
        factory = (lambda rid: lambda t: got.setdefault(
            rid, []).append(t))
        rmap, meta = fl.D.adopt_from_dir(
            jd, survivor, delivered=delivered, on_token_factory=factory)
        assert sorted(rmap) == sorted(r.request_id for r in reqs)
        survivor.run()
        for req in reqs:
            d = delivered.get(req.request_id, 0)
            m = meta[req.request_id]
            assert m["start_index"] == d
            full = (streamed.get(req.request_id, [])[:d] +
                    m["backfill"] + got.get(req.request_id, []))
            assert full == oracle[tuple(req.prompt_ids)], \
                (req.request_id, d, m)
        assert fl.side.stats()["adoptions"] == 1

    def test_finished_requests_never_re_adopt(self, fl, tmp_path):
        jd = str(tmp_path / "journal")
        eng = fl.engine(journal_dir=jd)
        done = eng.add_request(P1, max_new_tokens=4)
        while done.state != "done":
            eng.step()
        live = eng.add_request(P2, max_new_tokens=NEW)
        for _ in range(2):
            eng.step()
        assert live.state != "done"
        survivor = fl.engine()
        rmap, _ = fl.D.adopt_from_dir(jd, survivor)
        assert sorted(rmap) == [live.request_id]
        survivor.run()
        assert rmap[live.request_id].state == "done"

    def test_fingerprint_mismatch_refused(self, fl, tmp_path):
        jd, _, _ = _dead_replica(fl, tmp_path, steps=2)
        survivor = fl.engine(page_size=8)
        with pytest.raises(ValueError, match="fingerprint"):
            fl.D.adopt_from_dir(jd, survivor)

    def test_adopted_ids_never_collide_with_survivor(self, fl, tmp_path):
        jd, _, _ = _dead_replica(fl, tmp_path, steps=2)
        survivor = fl.engine()
        own = survivor.add_request(P2, max_new_tokens=4)
        rmap, _ = fl.D.adopt_from_dir(jd, survivor)
        ids = [own.request_id] + [r.request_id for r in rmap.values()]
        assert len(ids) == len(set(ids))
        survivor.run()
        assert own.state == "done"


# ---------------------------------------------------------------------------
# zero-loss failover: the HTTP surface (/v1/adopt + /v1/resume)
# ---------------------------------------------------------------------------
def _adopt_and_resume(dead_fl, edge_fl, oracle, tmp_path):
    """A journaling engine of ``dead_fl``'s package dies mid-stream; an
    edge of ``edge_fl``'s package adopts its journal and resumes the
    stream.  Returns what the resumed consumer saw."""
    jd = str(tmp_path / "journal")
    dead = dead_fl.engine(journal_dir=jd)
    req = dead.add_request(P1, max_new_tokens=NEW)
    streamed = []
    req.on_token = streamed.append
    for _ in range(6):
        dead.step()
    assert len(streamed) >= 3
    delivered = len(streamed) - 1  # one token never reached a client
    edge, port = edge_fl.edge()
    try:
        out = json.loads(post(
           f"http://127.0.0.1:{port}/v1/adopt",
           {"journal_dir": jd,
            "delivered": {req.request_id: delivered}}).read())
        entry = out["migrated"][str(req.request_id)]
        assert entry["start_index"] == delivered
        assert not entry["done"]
        resp = get(f"http://127.0.0.1:{port}/v1/resume"
                   f"?request={req.request_id}")
        meta, toks, done = drain_sse(resp)
        assert meta["start_index"] == delivered
        assert streamed[:delivered] + toks == oracle[tuple(P1)]
        assert done["finish_reason"] in ("eos", "length")
        # a resume is one-shot: the relay was claimed
        with pytest.raises(urllib.error.HTTPError) as ei:
            get(f"http://127.0.0.1:{port}/v1/resume"
                f"?request={req.request_id}")
        assert ei.value.code == 404
        return entry, toks
    finally:
        edge.close()


class TestFailoverHTTP:
    def test_adopt_and_resume_continue_the_stream(self, fl, oracle,
                                                  tmp_path):
        _adopt_and_resume(fl, fl, oracle, tmp_path)

    def test_port_edge_adopts_a_jax_journal(self, oracle, tmp_path):
        """Cross-package failover: a JAX replica dies, a port edge replays
        its journal through /v1/adopt and resumes the stream through
        /v1/resume, token for token."""
        jax_fl, torch_fl = Fleet("jax"), Fleet("torch")
        jax_fl.side.reset()
        torch_fl.side.reset(first_id=5000)
        entry, _ = _adopt_and_resume(jax_fl, torch_fl, oracle, tmp_path)
        assert entry["request_id"] >= 5000  # a fresh id of the port's


# ---------------------------------------------------------------------------
# end-to-end: router over live edges (one process, real HTTP)
# ---------------------------------------------------------------------------
def _route_three(router_fl, edge_fl, oracle):
    """Route P1, P1, P2 through ``router_fl``'s router over two edges of
    ``edge_fl``'s package; returns each stream's (tokens, affinity hit)
    and the replicas they landed on (a miss places by the replicas'
    polled headroom, so which replica is not fixed)."""
    edge1, p1 = edge_fl.edge()
    edge2, p2 = edge_fl.edge()
    edge_fl.ops.start_ops_server(port=0, host="127.0.0.1")
    router = router_fl.FL.FleetRouter(poll_interval_s=0.02)
    try:
        router.add_replica("r0", f"http://127.0.0.1:{p1}")
        router.add_replica("r1", f"http://127.0.0.1:{p2}")
        router.start()
        out, placed = [], []
        for p in (P1, P1, P2):
            s = router.submit(p, max_new_tokens=NEW)
            toks = s.result(timeout=120)
            assert toks == oracle[tuple(p)]
            assert s.finish_reason in ("eos", "length")
            out.append((toks, s.affinity_hit))
            placed.append(s.replica)
        assert router.stats["submitted"] == 3
        return out, placed
    finally:
        router.close()
        edge1.close()
        edge2.close()


class TestFleetEndToEnd:
    def test_affinity_routes_repeat_prefix_to_same_replica(self, fl,
                                                            oracle):
        out, (first, second, _) = _route_three(fl, fl, oracle)
        (_, hit1), (_, hit2), _ = out
        assert hit1 is False
        assert hit2 is True and second == first

    def test_jax_router_over_port_edges(self, oracle):
        """Cross-package fleet: the JAX router in front of two port edges
        routes and streams what the port router does over the same
        edges."""
        jax_out, jax_placed = _route_three(Fleet("jax"), Fleet("torch"),
                                           oracle)
        stop_all()
        torch_out, torch_placed = _route_three(Fleet("torch"),
                                               Fleet("torch"), oracle)
        assert jax_out == torch_out
        assert [hit for _, hit in jax_out] == [False, True, False]
        for placed in (jax_placed, torch_placed):
            assert placed[1] == placed[0]  # the repeated prefix's holder

    def test_round_robin_spreads_and_misses(self, fl, oracle):
        edge1, p1 = fl.edge()
        edge2, p2 = fl.edge()
        fl.ops.start_ops_server(port=0, host="127.0.0.1")
        router = fl.FL.FleetRouter(policy="round_robin",
                                   poll_interval_s=0.02)
        try:
            router.add_replica("r0", f"http://127.0.0.1:{p1}")
            router.add_replica("r1", f"http://127.0.0.1:{p2}")
            reps = []
            for _ in range(2):
                s = router.submit(P1, max_new_tokens=NEW)
                assert s.result(timeout=120) == oracle[tuple(P1)]
                reps.append(s.replica)
            assert sorted(reps) == ["r0", "r1"]
            assert router.stats["affinity_hits"] == 0
        finally:
            router.close()
            edge1.close()
            edge2.close()


# ---------------------------------------------------------------------------
# fleet /alertz rollup
# ---------------------------------------------------------------------------
class TestFleetRollup:
    def test_merges_firing_and_pages_on_unreachable(self):
        doc = {"engines": {"0": {
            "firing": ["kv_pressure"],
            "rules": {"kv_pressure": {"state": "firing",
                                      "severity": "page",
                                      "value": 0.99},
                      "quiet": {"state": "ok",
                                "severity": "ticket"}}}}}
        rolls = [al.fleet_rollup({"r0": doc, "r1": None},
                                 events=[{"event": "failover"}],
                                 replicas_ready=1) for al in (JAL, TAL)]
        assert rolls[1] == rolls[0]
        roll = rolls[1]
        assert roll["replicas"]["r0"]["reachable"]
        assert not roll["replicas"]["r1"]["reachable"]
        assert roll["reachable"] == 1
        assert roll["replicas_ready"] == 1
        assert roll["firing"]["page"] == ["r0/0/kv_pressure"]
        assert roll["paging"] is True
        assert roll["events"] == [{"event": "failover"}]
        quiet = TAL.fleet_rollup({"r0": {"engines": {"0": {
            "firing": [], "rules": {}}}}})
        assert quiet["paging"] is False

    def test_registered_router_surfaces_on_alertz(self, fl):
        class _Stub:
            def alertz_rollup(self):
                return {"replicas": {"r9": {"reachable": True,
                                            "firing": []}},
                        "reachable": 1, "firing": {}, "paging": False}

        eng = fl.engine()  # noqa: F841  (a live engine for /alertz)
        port = fl.ops.start_ops_server(port=0, host="127.0.0.1")
        stub = _Stub()
        fl.ops.register_fleet(stub)
        try:
            doc = json.loads(get(f"http://127.0.0.1:{port}/alertz")
                             .read())
            assert doc["fleet"]["replicas"]["r9"]["reachable"]
            with pytest.raises(urllib.error.HTTPError) as ei:
                get(f"http://127.0.0.1:{port}/fleetz")
            assert ei.value.code == 500  # a stub router has no fleetz
        finally:
            fl.ops.deregister_fleet(stub)
        doc = json.loads(get(f"http://127.0.0.1:{port}/alertz").read())
        assert "fleet" not in doc
        with pytest.raises(urllib.error.HTTPError) as ei:
            get(f"http://127.0.0.1:{port}/fleetz")
        assert ei.value.code == 404


# ---------------------------------------------------------------------------
# chaos: kill -9 of a replica process, zero loss, token continuity
# ---------------------------------------------------------------------------
CHAOS_NEW = 32
CHILD = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "torch_fleet_child.py")
CHILD_CONFIG = {"gpt": {k: TINY[k] for k in ("vocab_size", "hidden_size",
                                             "num_layers", "num_heads",
                                             "max_seq_len")},
                # six slots: a replica admits every stream it is given at
                # once, so each has a token before any finishes
                "engine": {"max_batch_size": 6, "max_seq_len": 96,
                           "page_size": 4, "prefix_cache": True},
                "fleet_trace": True}


def _spawn(tmp, name):
    env = {**os.environ, "PYTHONPATH": os.path.dirname(
        os.path.dirname(CHILD))}
    proc = subprocess.Popen(
        [sys.executable, CHILD, "--name", name, "--dir", tmp,
         "--config", json.dumps(CHILD_CONFIG),
         # a 25 ms stall a step: the kill lands mid-generation
         "--fault-plan", "slow_step@1-100000;slow_ms=25"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True, env=env)
    return proc


def _ports(proc, deadline):
    box = []
    t = threading.Thread(target=lambda: box.append(proc.stdout.readline()),
                         daemon=True)
    t.start()
    t.join(max(deadline - time.monotonic(), 0.1))
    line = box[0] if box else ""
    if not line.startswith("FLEET_CHILD "):
        raise RuntimeError(f"replica never announced its ports "
                           f"(rc={proc.poll()}, line={line!r})")
    kv = dict(f.split("=", 1) for f in line.split()[1:])
    return int(kv["edge"]), int(kv["ops"])


def test_chaos_kill9_zero_loss(tmp_path):
    """Two replica processes behind the port's affinity router, journals
    at fsync=always and FLAGS_fleet_trace on; with six streams in flight
    the busiest replica is killed with SIGKILL, four more requests
    follow, and every stream's full token list equals the uninterrupted
    serve's."""
    from paddle_tpu_torch.core import flags as tflags
    from paddle_tpu_torch.inference.serving import DecodeEngine
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig

    deadline = time.monotonic() + 120
    tmp = str(tmp_path)
    procs = {n: _spawn(tmp, n) for n in ("r0", "r1")}
    router = None
    try:
        rng = np.random.RandomState(7)
        prompts = [rng.randint(4, TINY["vocab_size"], (12,)).tolist()
                   for _ in range(10)]
        model = GPT.random(GPTConfig(**CHILD_CONFIG["gpt"]), seed=0,
                           device="cpu")
        ref = DecodeEngine(model, device="cpu", **CHILD_CONFIG["engine"]) \
            .generate(prompts, max_new_tokens=CHAOS_NEW)
        oracle = {tuple(p): o for p, o in zip(prompts, ref)}
        ports = {n: _ports(p, deadline) for n, p in procs.items()}
        tflags.set_flags({"fleet_trace": True})
        router = TFL.FleetRouter(policy="affinity", poll_interval_s=0.02,
                                 dead_after=3, admit_timeout_s=30.0,
                                 rollup_every=5)
        for n, (edge, _ops) in ports.items():
            router.add_replica(n, f"http://127.0.0.1:{edge}")
        router.start()
        streams = [router.submit(p, max_new_tokens=CHAOS_NEW)
                   for p in prompts[:6]]
        while not all(s.tokens for s in streams):
            assert time.monotonic() < deadline, "streams never started"
            assert not any(s.done for s in streams)
            time.sleep(0.005)
        assert not any(s.done for s in streams)
        by_rep = {}
        for s in streams:
            by_rep.setdefault(s.replica, []).append(s)
        victim = max(by_rep, key=lambda n: len(by_rep[n]))
        held = {id(s): len(s.tokens) for s in by_rep[victim]}
        # the victim's segment of each migrated trace, pulled before the
        # kill (a dead process serves no spans)
        for s in by_rep[victim]:
            router.fleetz(trace=s.trace_id)
        os.kill(procs[victim].pid, signal.SIGKILL)
        procs[victim].wait(timeout=10)
        late = [router.submit(p, max_new_tokens=CHAOS_NEW)
                for p in prompts[6:]]
        left = lambda: max(deadline - time.monotonic(), 1.0)  # noqa: E731
        for s in streams + late:
            assert s.result(timeout=left()) == oracle[tuple(s.prompt_ids)]
            assert s.finish_reason in ("eos", "length")
        assert procs[victim].returncode == -signal.SIGKILL
        assert router.stats["failovers"] == 1
        migrated = [s for s in by_rep[victim] if s.failovers]
        assert migrated and all(len(s.tokens) >= held[id(s)]
                                for s in by_rep[victim])
        assert all(s.replica != victim for s in late)
        survivor = next(n for n in procs if n != victim)
        # the rollup names the dead replica
        router._refresh_rollup(1)
        roll = router.alertz_rollup()
        assert roll["replicas"][victim] == {"reachable": False}
        assert any(e.get("event") == "failover" and
                   e.get("replica") == victim for e in roll["events"])
        # one lane per migrated trace, across the victim and the survivor
        for s in migrated:
            doc = router.fleetz(trace=s.trace_id)
            assert doc["replicas"][victim]["spans"] == "last pull"
            ev = doc["trace"]["traceEvents"]
            procs_named = {e["pid"]: e["args"]["name"] for e in ev
                           if e.get("name") == "process_name"}
            lane = [e for e in ev if e.get("ph") == "X" and
                    procs_named[e["pid"]] == "requests"]
            assert len({(e["pid"], e["tid"]) for e in lane}) == 1
            assert {e["args"]["replica"] for e in lane} == \
                {victim, survivor}
    finally:
        tflags.set_flags({"fleet_trace": False})
        if router is not None:
            router.close()
        for p in procs.values():
            if p.poll() is None:
                p.kill()
            p.wait(timeout=10)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_edge_round_trip_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the engine's captured steps and "
                    "K1 have no CPU mode")
    from paddle_tpu_torch.inference.serving import DecodeEngine
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig

    model = GPT.random(GPTConfig(vocab_size=512, hidden_size=128,
                                 num_layers=2, num_heads=2, max_seq_len=256),
                       seed=0, device="cuda")
    kw = dict(max_batch_size=2, max_seq_len=96, page_size=16)
    ref = DecodeEngine(model, **kw).generate([P1], max_new_tokens=NEW)[0]
    edge = TFL.EdgeServer(DecodeEngine(model, **kw))
    port = edge.start()
    try:
        resp = post(f"http://127.0.0.1:{port}/v1/generate",
                    {"prompt_ids": P1, "max_new_tokens": NEW})
        _meta, toks, done = drain_sse(resp)
    finally:
        edge.close()
    assert toks == ref
    assert done["finish_reason"] in ("eos", "length")
