"""The port's ops plane against the JAX package's (tests/test_opsplane.py):
the shipped alert rules and their wire forms, the same signal sequence
driving the same transitions, readiness criteria, and the ops server
(`/metrics`, `/statusz`, `/flightz`, `/healthz`, `/readyz`, `/alertz`,
`/profilez`, `/tracez`) answering with the same endpoints and JSON keys
as JAX's — mid-serve, without perturbing the tokens."""
import torch_test_env  # noqa: F401  (first: one intra-op thread)
import json
import threading
import urllib.error
import urllib.request

import pytest

from paddle_tpu import observability as JO
from paddle_tpu.inference import durability as JD
from paddle_tpu.observability import alerts as JA
from paddle_tpu.observability import opsserver as JOPS
from paddle_tpu_torch import observability as TO
from paddle_tpu_torch.inference import durability as TD
from paddle_tpu_torch.inference import resilience as TR
from paddle_tpu_torch.inference import serving as TS
from paddle_tpu_torch.inference.errors import StepFault
from paddle_tpu_torch.observability import alerts as TA
from paddle_tpu_torch.observability import opsserver as TOPS

from torch_telemetry_common import engines, models, prompts, reset_both

KW = dict(max_batch_size=2, page_size=16)
NEW = 6


def _get(base, path, timeout=10.0):
    try:
        with urllib.request.urlopen(base + path, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


@pytest.mark.parametrize("scale", [1.0, 0.01])
def test_default_rules_wire_equals_jax(scale):
    tw = [r.to_wire() for r in TA.default_rules(window_scale=scale)]
    jw = [r.to_wire() for r in JA.default_rules(window_scale=scale)]
    assert tw == jw
    assert [TA.AlertRule.from_wire(w).to_wire() for w in tw] == tw
    assert set(TA.SIGNALS) == set(JA.SIGNALS)
    assert TA.SEVERITIES == JA.SEVERITIES


def test_rule_validation():
    with pytest.raises(ValueError, match="severity"):
        TA.AlertRule("x", signal="slo_burn", severity="bogus")
    with pytest.raises(ValueError, match="unknown signal"):
        TA.AlertRule("x", signal="nope")
    with pytest.raises(ValueError, match="shortest first"):
        TA.AlertRule("x", signal="slo_burn",
                     windows=((100.0, 1.0), (10.0, 2.0)))


# (time, worst tpot burn) readings of a burn-rate scenario: a blip, a
# sustained burn, and the recovery
_BURN = ([(1000.0 + i, 1.0) for i in range(100)]
         + [(1100.0 + i, 40.0) for i in range(25)]
         + [(1125.0 + i, 0.0) for i in range(40)])


@pytest.mark.parametrize("rule", [
    dict(name="burn", signal="slo_burn", severity="page",
         windows=((10.0, 10.0), (100.0, 5.0)), resolve_after_s=20.0),
    dict(name="burn", signal="slo_burn", threshold=5.0, op=">=",
         for_s=5.0, resolve_after_s=3.0),
], ids=["burn_rate", "threshold"])
def test_same_signals_same_transitions(rule):
    """Both alert engines fed the same gauge readings at the same
    instants walk the same states and emit the same transitions."""
    m, tm = models(0)
    reset_both()
    je, te = engines(m, tm, alerts=[rule], **KW)
    out = []
    for eng, O, A in ((je, JO, JA), (te, TO, TA)):
        states = []
        for t, v in _BURN:
            O.SLO_BURN.set(v, engine=eng._engine_id, kind="tpot")
            eng._alerts.evaluate(now=t)
            states.append(eng._alerts.snapshot()["rules"]["burn"]["state"])
        snap = eng._alerts.snapshot()
        out.append((states, [(x["rule"], x["state"], x["severity"],
                              x["value"]) for x in snap["transitions"]],
                    O.ALERT_TRANSITIONS.value(rule="burn", state="firing")))
        fl = [ev["kind"] for r in eng._flight.records()
              for ev in r.get("events", [])]
        assert fl == [x["state"].replace("firing", "alert_fire")
                      .replace("resolved", "alert_resolve")
                      for x in snap["transitions"]]
    assert out[1] == out[0]
    assert ("burn", "firing") in [(a, b) for a, b, _, _ in out[0][1]]


def test_alert_engine_snapshot_schema_equals_jax():
    m, tm = models(0)
    je, te = engines(m, tm, alerts=True, **KW)
    je.generate(prompts(0), NEW)
    te.generate(prompts(0), NEW)
    for eng in (je, te):
        eng._alerts.evaluate()
    js, ts = je._alerts.snapshot(), te._alerts.snapshot()
    assert set(ts) == set(js)
    assert set(ts["rules"]) == set(js["rules"])
    assert {k: set(v) for k, v in ts["rules"].items()} == \
        {k: set(v) for k, v in js["rules"].items()}


def test_ready_criteria_equal_jax():
    m, tm = models(0)
    je, te = engines(m, tm, **KW)
    jc, tc = JOPS.engine_ready(je), TOPS.engine_ready(te)
    assert set(tc) == set(jc) and tc["ready"] and jc["ready"]
    for D, OPS, eng in ((JD, JOPS, je), (TD, TOPS, te)):
        D.set_health(eng._engine_id, "hung")
        assert not OPS.engine_ready(eng)["ready"]
        D.set_health(eng._engine_id, "live")
        D.clear_health(eng._engine_id)
    rule = dict(name="pp", signal="pool_reclaimable_frac",
                severity="page", threshold=2.0, op="<")
    eng = TS.DecodeEngine(tm, device="cpu", alerts=[rule], **KW)
    eng._alerts.evaluate(now=1.0)
    crit = TOPS.engine_ready(eng)
    assert crit["page_alerts"] == ["pp"] and not crit["ready"]


def test_ops_server_off_at_defaults():
    TOPS.stop_ops_server()
    _, tm = models(0)
    eng = TS.DecodeEngine(tm, device="cpu", **KW)
    eng.generate(prompts(0)[:1], 2)
    assert TOPS.ops_server_port() is None
    assert eng._alerts is None


@pytest.fixture
def servers(monkeypatch):
    """Both packages' ops servers on 127.0.0.1:0, over empty registries."""
    monkeypatch.setattr(TOPS, "_ENGINES", {})
    monkeypatch.setattr(TOPS, "_FRONTENDS", {})
    monkeypatch.setattr(JOPS, "_ENGINES", {})
    monkeypatch.setattr(JOPS, "_FRONTENDS", {})
    tp = TO.start_ops_server(port=0, host="127.0.0.1")
    jp = JO.start_ops_server(port=0, host="127.0.0.1")
    yield f"http://127.0.0.1:{jp}", f"http://127.0.0.1:{tp}"
    TO.stop_ops_server()
    JO.stop_ops_server()


_PATHS = ("/metrics", "/statusz", "/statusz?format=text", "/flightz",
          "/healthz", "/readyz", "/alertz", "/profilez", "/tracez")


def test_endpoints_mid_serve_bit_exact(servers):
    """A poller hits every endpoint of the port's server while the
    engine serves: every response parses and the tokens equal an
    unpolled serve's.  The serve holds after its first step until the
    poller has visited every path once, so each is read mid-serve
    however slowly the server answers (``/metrics`` carries every label
    set earlier engines of the process left)."""
    _, base = servers
    _, tm = models(0)
    ps = prompts(0)
    ref = TS.DecodeEngine(tm, device="cpu", **KW).generate(ps, NEW)
    TOPS._ENGINES.clear()
    eng = TS.DecodeEngine(tm, device="cpu", alerts=True, profile=True,
                          profile_sample_steps=1, **KW)
    seen, stop, visited = {}, threading.Event(), threading.Event()

    def poll():
        i = 0
        while not stop.is_set():
            p = _PATHS[i % len(_PATHS)]
            seen[p] = _get(base, p)
            i += 1
            if len(seen) == len(_PATHS):
                visited.set()

    t = threading.Thread(target=poll, daemon=True)
    t.start()
    try:
        reqs = [eng.add_request(p, max_new_tokens=NEW) for p in ps]
        eng.step()
        assert eng._active.any()  # mid-serve
        assert visited.wait(timeout=120)
        eng.run()
    finally:
        stop.set()
        t.join(timeout=10)
    assert [list(r.generated_ids) for r in reqs] == ref
    assert len(seen) == len(_PATHS)
    for p, (code, body) in seen.items():
        assert code in (200, 503), (p, code, body[:200])
        if p not in ("/metrics", "/statusz?format=text"):
            json.loads(body)
    assert "paddle_decode_step_seconds" in seen["/metrics"][1]
    z = json.loads(_get(base, "/statusz")[1])
    assert z["engine"] == eng._engine_id and set(z) == set(eng.statusz())
    w = json.loads(_get(base, "/flightz?n=4")[1])
    assert len(w["records"]) <= 4 and "alerts" in w
    code, body = _get(base, "/flightz?request=0")
    assert code == 200 and json.loads(body)["explain"]
    assert _get(base, "/bogus")[0] == 404


def test_endpoints_answer_with_jax_keys(servers):
    """The same endpoints, status codes and JSON keys as JAX's server
    over an engine of the same configuration."""
    jbase, tbase = servers
    m, tm = models(0)
    reset_both()
    je, te = engines(m, tm, alerts=True, profile=True, **KW)
    je.generate(prompts(0), NEW)
    te.generate(prompts(0), NEW)
    for p in ("/statusz", "/flightz", "/healthz", "/readyz", "/alertz",
              "/profilez", "/tracez", "/bogus", "/flightz?request=0",
              "/statusz?engine=99999"):
        jc, jb = _get(jbase, p)
        tc, tb = _get(tbase, p)
        assert tc == jc, p
        jd, td = json.loads(jb), json.loads(tb)
        # the port's /profilez adds its probe ``clock``
        extra = {"clock"} if p == "/profilez" else set()
        assert set(td) - extra == set(jd), p
    assert _get(tbase, "/metrics")[0] == 200


def test_statusz_serves_the_frontends_debug_dump(servers):
    import asyncio
    from paddle_tpu_torch.inference.frontend import ServingFrontend

    _, base = servers
    _, tm = models(0)
    eng = TS.DecodeEngine(tm, device="cpu", **KW)

    async def go():
        async with ServingFrontend(eng, step_in_thread=False) as fe:
            s = await fe.submit(prompts(0)[0], max_new_tokens=NEW)
            z = json.loads(_get(base, "/statusz")[1])
            await s.collect()
        return z

    z = asyncio.run(go())
    assert set(z) == {"frontend", "engine"}


def test_registry_follows_recovery_generations(servers):
    _, base = servers
    _, tm = models(0)
    eng = TS.DecodeEngine(tm, device="cpu", fault_plan="step@3-9", **KW)
    eng.add_request(prompts(0)[0], max_new_tokens=NEW)
    fault = None
    while fault is None:
        try:
            eng.step()
        except StepFault as e:
            fault = e
    new = TR.recover(eng, fault=fault)
    new.run()
    assert TOPS.live_engines() == [new]
    z = json.loads(_get(base, "/statusz")[1])
    assert z["engine"] == new._engine_id
    code, body = _get(base, "/healthz")
    assert code == 200 and list(json.loads(body)["engines"]) == \
        [str(new._engine_id)]
