"""The port's flight recorder and its engine hooks against the JAX
package's (tests/test_flight.py): for the same requests both engines
seal the same records (batch composition, queue, emissions, finishes,
ladder events, pool statistics and phase names), dumps render through
both packages' explain_request with the same output, statusz and
debug_dump keep JAX's schema, a JAX journal's telemetry keys restore
into a port engine, and the plane armed or disarmed leaves the tokens
unchanged."""
import torch_test_env  # noqa: F401  (first: one intra-op thread)
import asyncio
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest

from paddle_tpu.inference import durability as JD
from paddle_tpu.inference import serving as JS
from paddle_tpu_torch import observability as TO
from paddle_tpu_torch.inference import durability as TD
from paddle_tpu_torch.inference import frontend as TF
from paddle_tpu_torch.inference import resilience as TR
from paddle_tpu_torch.inference import serving as TS
from paddle_tpu_torch.observability import opsserver as TOPS
from paddle_tpu_torch.tools import explain_request as TX

from torch_telemetry_common import (MODES, deterministic, engines, models,
                                    prompts, reset_both)

REPO = Path(__file__).resolve().parents[1]
KW = dict(max_batch_size=2, page_size=16)
NEW = 6


@pytest.mark.parametrize("mode", sorted(MODES))
def test_records_equal_jax(mode):
    """Record by record: the same deterministic fields and phase names,
    and the same tokens."""
    m, tm = models(0)
    ps = prompts(0)
    reset_both()
    je, te = engines(m, tm, **KW, **MODES[mode])
    jt = je.generate(ps, NEW)
    tt = te.generate(ps, NEW)
    assert tt == [[int(t) for t in o] for o in jt]
    jr, tr = je._flight.records(), te._flight.records()
    assert len(tr) == len(jr) > 0
    for a, b in zip(jr, tr):
        assert deterministic(b) == deterministic(a), a["step"]
        assert b["step"] == a["step"] and b["dur_s"] > 0
    assert te._flight.window_stats()["finished"] == \
        je._flight.window_stats()["finished"] == len(ps)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_tokens_bit_exact_armed_and_disarmed(mode):
    """The whole plane armed (recorder, cost model, profiling every step,
    alerts) and disarmed serve the same tokens; disarmed, no recorder,
    cost model or profiler exists."""
    _, tm = models(1)
    ps = prompts(2)
    off = TS.DecodeEngine(tm, device="cpu", flight_window=0,
                          cost_model=False, **KW, **MODES[mode])
    on = TS.DecodeEngine(tm, device="cpu", profile=True,
                         profile_sample_steps=1, alerts=True, **KW,
                         **MODES[mode])
    assert off._flight is off._cost is off._profiling is None
    assert off._alerts is None
    assert on.generate(ps, NEW) == off.generate(ps, NEW)
    assert on._profiling.probes > 0 and on._alerts.evals >= 0


@pytest.mark.parametrize("plan", ["step@3;nan_logits@4", "nan_logits@2",
                                  "step@2;step@5"])
def test_ladder_events_equal_jax(plan):
    """Retries and quarantines under the same fault plan land as the same
    events on the same records."""
    m, tm = models(0)
    ps = prompts(0)
    reset_both()
    je, te = engines(m, tm, fault_plan=plan, **KW)
    je.generate(ps, NEW)
    te.generate(ps, NEW)
    jr, tr = je._flight.records(), te._flight.records()
    assert [deterministic(r) for r in tr] == [deterministic(r) for r in jr]
    kinds = {ev["kind"] for r in tr for ev in r.get("events", [])}
    assert kinds


def test_fault_dump_renders_through_both_explainers(tmp_path):
    """A fatal fault leaves a crash-safe dump; JAX's stdlib
    tools/explain_request.py and the port's copy render it alike."""
    _, tm = models(0)
    d = str(tmp_path / "flight")
    reset_both()
    eng = TS.DecodeEngine(tm, device="cpu", fault_plan="step@3;step@6-16",
                          flight_dir=d, **KW)
    reqs = [eng.add_request(p, max_new_tokens=NEW) for p in prompts(0)]
    TR.serve_with_recovery(eng, max_recoveries=8)
    assert all(r.state == "done" for r in reqs)
    dumps = sorted(f for f in os.listdir(d) if f.endswith("_fault.json"))
    assert dumps and not any(f.endswith(".tmp") for f in os.listdir(d))
    path = os.path.join(d, dumps[0])
    with open(path) as f:
        window = json.load(f)
    kinds = {ev["kind"] for rec in window["records"]
             for ev in rec.get("events", [])}
    assert {"fault", "retry"} <= kinds
    assert TS.decode_stats()["flight_dumps"] >= 1
    assert TO.FLIGHT_DUMPS.value(reason="fault") >= 1
    for rid in TX.request_ids(window)[:2]:
        jx = subprocess.run(
            [sys.executable, str(REPO / "tools" / "explain_request.py"),
             path, "--request", str(rid)], capture_output=True, text=True,
            timeout=120)
        pt = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch.tools.explain_request",
             path, "--request", str(rid)], capture_output=True, text=True,
            timeout=120, cwd=REPO,
            env=dict(os.environ, PYTHONPATH=str(REPO)))
        assert jx.returncode == pt.returncode == 0, jx.stderr + pt.stderr
        assert pt.stdout == jx.stdout and f"request {rid}" in pt.stdout


def test_quarantine_renders_in_explain(tmp_path):
    _, tm = models(0)
    eng = TS.DecodeEngine(tm, device="cpu", fault_plan="step@3;nan_logits@4",
                          flight_dir=str(tmp_path), **KW)
    reqs = [eng.add_request(p, max_new_tokens=NEW) for p in prompts(0)]
    eng.run()
    with open(eng._flight.dump("manual")) as f:
        window = json.load(f)
    suspect = next(r for r in reqs if r.finish_reason == "fault")
    text = "\n".join(TX.explain(window, suspect.request_id))
    assert "quarantine" in text and "finished: fault" in text


def test_abandonment_dumps_and_retires(tmp_path):
    """Watchdog abandonment: the alert engine evaluates, the window dumps
    ("abandoned"), and the engine leaves the ops and profiling
    registries with its gauges."""
    _, tm = models(0)
    eng = TS.DecodeEngine(tm, device="cpu", flight_dir=str(tmp_path),
                          alerts=True, profile=True, **KW)
    for p in prompts(0):
        eng.add_request(p, max_new_tokens=NEW)
    eng.step()
    eng.step()
    assert eng in TOPS.live_engines()
    eng._abandon_inflight()
    assert any(f.endswith("_abandoned.json") for f in os.listdir(tmp_path))
    assert eng not in TOPS.live_engines()
    assert eng._alerts.evals >= 1
    from paddle_tpu_torch.observability import profiling
    with pytest.raises(ValueError):
        profiling.profiler_for(eng)


def test_dump_paths():
    _, tm = models(0)
    eng = TS.DecodeEngine(tm, device="cpu", **KW)
    eng.generate([prompts(0)[0]], 2)
    assert eng._flight.dump("manual") is None  # no directory: no dump


def test_flight_dir_defaults_beside_journal(tmp_path):
    _, tm = models(0)
    d = str(tmp_path / "j")
    eng = TS.DecodeEngine(tm, device="cpu", journal_dir=d, **KW)
    assert eng._flight.flight_dir == os.path.join(d, "flight")


def test_slo_burn_equals_jax():
    """`Request.slo_burn` at fixed timestamps, and the burn gauges and
    exceeded counter a serve with impossible targets moves."""
    out = []
    for S in (JS, TS):
        r = S.Request([1, 2, 3], max_new_tokens=8, slo_ttft_ms=5.0,
                      slo_tpot_ms=2.0, deadline_ms=100.0)
        r.t_enqueue_ns = 1_000_000
        r._deadline_ns = r.t_enqueue_ns + 100_000_000
        first = r.slo_burn(4_000_000)
        r.t_first_token_ns = 6_000_000
        r.output_ids = [5, 6, 7]
        out.append((first, r.slo_burn(20_000_000)))
    assert out[0] == out[1]
    _, tm = models(0)
    reset_both()
    eng = TS.DecodeEngine(tm, device="cpu", **KW)
    for p in prompts(0):
        eng.add_request(p, max_new_tokens=NEW, slo_tpot_ms=1e-6)
    eng.run()
    assert TO.SLO_BURN_EXCEEDED.value(kind="tpot") == len(prompts(0))


def _schema(x, depth=0):
    """Nested dict keys (lists by their first element), values' types
    folded to None/number/str/other."""
    if isinstance(x, dict):
        return {k: _schema(v, depth + 1) for k, v in x.items()}
    if isinstance(x, list):
        return [_schema(x[0], depth + 1)] if x else []
    return None


def _strip(z):
    """Keys whose members are data (sites, fns) rather than schema."""
    z = json.loads(json.dumps(z, default=str))
    cost = z.get("cost")
    if cost:
        for k in ("profiles", "calibration", "error_ratio"):
            cost[k] = {}
    for rec in z.get("flight", {}).get("records", []):
        rec["phases"] = {}
        rec["emitted"] = {}
        rec.pop("burn", None)
    return z


def test_statusz_schema_equals_jax():
    m, tm = models(0)
    ps = prompts(0)
    reset_both()
    je, te = engines(m, tm, **KW)
    for eng in (je, te):
        eng.add_request(ps[0], max_new_tokens=NEW, slo_ttft_ms=1000.0)
        eng.add_request(ps[1], max_new_tokens=NEW)
        eng.add_request(ps[2], max_new_tokens=NEW)
        eng.step()
        eng.step()
    jz, tz = _strip(je.statusz()), _strip(te.statusz())
    assert _schema(tz) == _schema(jz)
    assert tz["config"] == jz["config"]
    assert tz["pool"] == jz["pool"]
    txt = te.statusz_text()
    assert f"engine {te._engine_id}" in txt and "slots (2/2):" in txt
    assert "cost: predicted" in txt


def test_debug_dump_schema_equals_jax():
    from paddle_tpu.inference import frontend as JF

    m, tm = models(0)
    ps = prompts(0)

    async def go(F, eng):
        async with F.ServingFrontend(eng, step_in_thread=False) as fe:
            s = await fe.submit(ps[0], max_new_tokens=NEW)
            dump = fe.debug_dump()
            await s.collect()
        return fe, dump

    reset_both()
    je, te = engines(m, tm, **KW)
    jfe, jd = asyncio.run(go(JF, je))
    tfe, td = asyncio.run(go(TF, te))
    assert _schema(_strip(td["engine"])) == _schema(_strip(jd["engine"]))
    assert _schema(td["frontend"]) == _schema(jd["frontend"])
    assert tfe.debug_dump()["frontend"]["driver_alive"] is False


def test_statusz_midserve_thread_never_perturbs():
    _, tm = models(0)
    ps = prompts(0)
    ref = TS.DecodeEngine(tm, device="cpu", **KW).generate(ps, NEW)
    eng = TS.DecodeEngine(tm, device="cpu", **KW)
    reqs = [eng.add_request(p, max_new_tokens=NEW) for p in ps]
    errors, polls, stop = [], [0], threading.Event()

    def hammer():
        while not stop.is_set():
            try:
                json.dumps(eng.statusz(), default=str)
                polls[0] += 1
            except Exception as e:  # noqa: BLE001
                errors.append(repr(e))

    t = threading.Thread(target=hammer)
    t.start()
    try:
        eng.run()
    finally:
        stop.set()
        t.join()
    assert not errors and polls[0] >= 1
    assert [list(r.generated_ids) for r in reqs] == ref


def test_jax_journal_telemetry_keys_restore_into_port(tmp_path):
    """A JAX journal written with the telemetry plane configured: the
    port's restore keeps its flight window, profiling cadence, alert
    table and cost model, and records the restore."""
    from paddle_tpu.observability.alerts import default_rules

    m, tm = models(0)
    ps = prompts(0)
    d = str(tmp_path / "j")
    reset_both()
    rules = default_rules(window_scale=0.01)
    je = JS.DecodeEngine(m, journal_dir=d, flight_window=16,
                         profile=True, profile_sample_steps=4,
                         alerts=rules, **KW)
    for p in ps:
        je.add_request(p, max_new_tokens=NEW)
    for _ in range(3):
        je.step()
    je._durability.flush()
    cfg = JD.read_journal(os.path.join(d, "journal.wal"))[0][0]["cfg"]
    assert cfg["flight_window"] == 16 and cfg["profile"] is True
    eng, reqs = TD.restore_from_dir(d, tm, journal=False, device="cpu")
    assert eng._flight is not None and eng._flight.window == 16
    assert eng._profiling is not None and \
        eng._profiling.sample_steps == 4
    assert [r.to_wire() for r in eng._alerts.rules] == \
        [r.to_wire() for r in rules]
    assert eng._cost is not None and eng._ctor["cost_model"] is True
    evs = [ev["kind"] for r in eng._flight.records()
           for ev in r.get("events", [])]
    assert "restore" in evs
    eng.run()
    assert all(r.state == "done" for r in reqs.values())


def test_recover_and_snapshot_carry_calibration(tmp_path):
    _, tm = models(0)
    ps = prompts(0)
    eng = TS.DecodeEngine(tm, device="cpu", journal_dir=str(tmp_path / "j"),
                          **KW)
    for p in ps:
        eng.add_request(p, max_new_tokens=NEW)
    for _ in range(5):
        eng.step()
    calib = eng._cost.calibration_wire()
    assert calib
    eng._durability.write_snapshot()
    snap = TD.load_snapshot(str(tmp_path / "j"))
    assert snap.cost == calib
    new = TR.recover(eng)
    assert new._cost.calibration_wire() == calib
    evs = [ev["kind"] for r in new._flight.records()
           for ev in r.get("events", [])]
    assert "recovery" in evs
    new.run()
