"""The port's observability substrate against the JAX package's: the
metric catalog, the registry's exports and estimators, the span buffer
and merged chrome trace, the reporter, and the telemetry flags."""
import json

import pytest

from paddle_tpu import observability as JO
from paddle_tpu.core import flags as JF
from paddle_tpu.observability import metrics as JM
from paddle_tpu_torch import observability as TO
from paddle_tpu_torch.core import flags as TF
from paddle_tpu_torch.observability import metrics as TM

from torch_telemetry_common import (engines, models, prompts,
                                    reset_both)

# JAX catalog series that belong to a later slice of the port: none now
# (the fleet router's six paddle_fleet_* series are ported)
LATER_SERIES = set()

TELEMETRY_FLAGS = ("flight_window", "flight_dir", "cost_model",
                   "sched_cost_admission", "peak_flops", "peak_hbm_gbps",
                   "peak_ici_gbps", "cost_memory_analysis",
                   "cost_ledger_interval_steps", "ops_port",
                   "alert_interval_steps", "profile",
                   "profile_sample_steps", "profile_dir",
                   "metrics_report_interval_s")


def test_catalog_equals_jax_less_later_slices():
    """Every first-class series of the JAX catalog, under its name, type,
    labels and buckets, less the named later-slice series (help texts
    name the port's own mechanisms where they differ)."""
    jm = JO.registry._metrics
    tm = TO.registry._metrics
    assert set(tm) == set(jm) - LATER_SERIES
    assert LATER_SERIES <= set(jm)
    for name, t in tm.items():
        j = jm[name]
        assert (t.kind, t.label_names) == (j.kind, j.label_names), name
        if t.kind == "histogram":
            assert t.buckets == j.buckets, name


def test_decode_view_series_equal_jax():
    reset_both()
    tv = [s.name for s in TO._decode_view()]
    jv = [s.name for s in JO._decode_view()]
    assert tv == jv


@pytest.mark.parametrize("values", [
    [0.0002, 0.004, 0.004, 1.5, 300.0],
    [1e-5, 2e-4, 3e-4, 0.05],
    [],
], ids=["spread", "small", "empty"])
def test_registry_exports_match_jax(values):
    """One labeled histogram, counter and gauge fed the same values:
    the Prometheus text, the snapshot and the quantile estimates equal
    the JAX registry's."""
    outs = []
    for M in (JM, TM):
        reg = M.MetricRegistry()
        h = reg.histogram("x_seconds", "h\nhelp", labels=("phase",))
        c = reg.counter("x_total", "c", labels=("k",))
        g = reg.gauge("x_level", "g")
        h.observe_batch([({"phase": "a"}, v) for v in values])
        for v in values:
            h.observe(v, phase="b")
            c.inc(2, k='q"x')
        g.set(float("inf") if values else 3.0)
        qs = [h.quantile(q, phase="a") for q in (0.0, 0.5, 0.9, 0.99, 1.0)]
        outs.append((reg.prometheus_text(), reg.snapshot(), qs,
                     h.series_state(phase="b")))
    assert outs[0] == outs[1]


def test_views_render_in_exports():
    reg = TM.MetricRegistry()
    reg.register_view(lambda: [TM.Sample("v_total", "counter", "", (),
                                         [((), 7)])])
    assert "v_total 7" in reg.prometheus_text()
    assert reg.snapshot()["v_total"]["series"][0]["value"] == 7


def test_spans_and_merged_chrome_trace():
    """Span buffer accounting and the merged trace's layout: the host
    track at pid 0 (empty in the port), one process per track."""
    reset_both()
    TO.record_span("engine", "decode_step", 1000, 500, tid=3,
                   args={"step": 1})
    with TO.span("requests", "queued", tid=7):
        pass
    assert TO.span_count() == 2 and TO.dropped_span_count() == 0
    tr = TO.merged_chrome_trace()
    meta = {e["args"]["name"]: e["pid"] for e in tr["traceEvents"]
            if e["ph"] == "M"}
    assert meta == {"host": 0, "engine": 1, "requests": 2}
    ev = [e for e in tr["traceEvents"] if e["ph"] == "X"]
    assert ev[0] == {"name": "decode_step", "ph": "X", "pid": 1, "tid": 3,
                     "ts": 1.0, "dur": 0.5, "args": {"step": 1}}
    TO.clear_spans()
    assert TO.span_count() == 0


def test_span_overflow_counts_drops(monkeypatch):
    from paddle_tpu_torch.observability import tracing

    reset_both()
    monkeypatch.setattr(tracing, "MAX_SPANS", 2)
    for i in range(5):
        TO.record_span("engine", "s", i, 1)
    assert TO.span_count() == 2 and TO.dropped_span_count() == 3
    assert TO.TRACE_SPANS_DROPPED.value() == 3
    TO.clear_spans()


def test_export_chrome_trace(tmp_path):
    reset_both()
    TO.record_span("engine", "s", 10, 5)
    path = tmp_path / "t" / "trace.json"
    data = TO.export_chrome_trace(str(path))
    assert json.loads(path.read_text()) == data


def _moved(before, after, name):
    """What one serve added to a counter or histogram: label set -> the
    value (count) it moved by, label sets it left alone dropped.  A
    reset keeps every label set earlier tests of the process made (at
    0), so the series lists themselves differ between the packages."""
    def val(s):
        return s.get("count", s.get("value"))

    base = {tuple(sorted(s["labels"].items())): val(s)
            for s in before[name]["series"]}
    out = {}
    for s in after[name]["series"]:
        key = tuple(sorted(s["labels"].items()))
        d = val(s) - base.get(key, 0)
        if d:
            out[key] = d
    return out


def test_serve_fills_the_catalog_as_jax():
    """One serve on each engine: the same first-class series carry
    samples (names and label sets), and the request counters agree (the
    delta of two snapshots around each serve)."""
    m, tm = models(0)
    ps = prompts(1)
    reset_both()
    je, te = engines(m, tm, max_batch_size=2, page_size=16)
    j0, t0 = JO.snapshot(), TO.snapshot()
    je.generate(ps, 6)
    te.generate(ps, 6)
    js, ts = JO.snapshot(), TO.snapshot()

    def filled(snap):
        # series this serve moved (a reset keeps earlier label sets at
        # 0); the views keep their own counts across tests: the decode
        # view is compared above, JAX's dispatch view waits for the
        # port's eager slice
        out = {}
        for name, m_ in snap.items():
            live = [s for s in m_["series"]
                    if s.get("count", s.get("value"))]
            if live and not name.startswith(("paddle_decode_",
                                             "paddle_dispatch_")):
                out[name] = sorted(tuple(sorted(s["labels"].items()))
                                   for s in live)
        return out
    jf, tf = filled(js), filled(ts)
    jf = {k: [tuple((a, b) for a, b in lv if a != "engine") for lv in v]
          for k, v in jf.items() if k not in LATER_SERIES}
    tf = {k: [tuple((a, b) for a, b in lv if a != "engine") for lv in v]
          for k, v in tf.items()}
    assert tf == jf
    for name in ("paddle_requests_enqueued_total",
                 "paddle_requests_finished_total",
                 "paddle_request_e2e_seconds", "paddle_decode_step_seconds",
                 "paddle_request_queue_wait_seconds"):
        assert _moved(t0, ts, name) == _moved(j0, js, name), name
    assert _moved(t0, ts, "paddle_requests_finished_total") == \
        {(("reason", "length"),): len(ps)}


def test_reporter_hands_snapshots_to_the_sink():
    got = []
    assert not TO.reporter_running()
    assert TO.start_reporter(interval_s=0.01, sink=got.append)
    try:
        import time
        for _ in range(200):
            if got:
                break
            time.sleep(0.01)
    finally:
        TO.stop_reporter()
    assert got and "paddle_request_ttft_seconds" in got[0]
    assert not TO.reporter_running()
    assert TO.start_reporter(interval_s=0) is False  # 0 = off


@pytest.mark.parametrize("name", TELEMETRY_FLAGS)
def test_telemetry_flags_take_jax_defaults(name):
    assert TF.flag(name) == JF.flag(name)


def test_fleet_trace_waits_for_the_fleet_slice():
    """The fleet slice is ported: FLAGS_fleet_trace takes JAX's default
    and can be set (`observability.fleettrace.enabled` reads it)."""
    from paddle_tpu_torch.observability import fleettrace

    assert TF.flag("fleet_trace") == JF.flag("fleet_trace") is False
    assert not fleettrace.enabled()
    TF.set_flags({"fleet_trace": True})
    try:
        assert fleettrace.enabled()
    finally:
        TF.set_flags({"fleet_trace": False})
