"""The port's profiling plane against the JAX package's
(tests/test_profiling.py): the probe cadence and the kinds probes
attribute to equal JAX's record by record, a probed record splits its
wall into device and host seconds, the hot-op tables and `/profilez`
payload keep JAX's schema, and a capture session writes a torch.profiler
trace and the merged chrome trace.  On the CPU a probe is the host clock
around the synchronous eager step; on the card, CUDA events (the
``cuda``-marked test)."""
import json
import os

import pytest
import torch

from paddle_tpu.core import flags as JF
from paddle_tpu_torch import observability as TO
from paddle_tpu_torch.core import flags as TF
from paddle_tpu_torch.inference import serving as TS
from paddle_tpu_torch.observability import alerts as TA
from paddle_tpu_torch.observability import profiling as TP

from torch_telemetry_common import (MODES, engines, models, prompts,
                                    reset_both)

KW = dict(max_batch_size=2, page_size=16)
NEW = 6


def _probed(eng):
    return [(r["step"], sorted(r["probe"]["device"]))
            for r in eng._flight.records()
            if r.get("kind") == "step" and "probe" in r]


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("every", [1, 3])
def test_probe_cadence_and_kinds_equal_jax(mode, every):
    """Which steps probe and which dispatched step kinds they attribute
    to: the same records as JAX's."""
    m, tm = models(0)
    reset_both()
    je, te = engines(m, tm, profile=True, profile_sample_steps=every,
                     **KW, **MODES[mode])
    je.generate(prompts(0), NEW)
    te.generate(prompts(0), NEW)
    assert _probed(te) == _probed(je) and _probed(te)
    assert te._profiling.probes == je._profiling.probes
    assert TS.decode_stats()["profile_probes"] == te._profiling.probes


def test_probe_splits_wall_into_device_and_host():
    _, tm = models(0)
    reset_both()
    eng = TS.DecodeEngine(tm, device="cpu", profile=True,
                          profile_sample_steps=1, **KW)
    eng.generate(prompts(0), NEW)
    z = eng._profiling.statusz()
    assert z["clock"] == "host" and z["probes"] > 0
    for r in eng._flight.records():
        pr = r.get("probe")
        if pr is None:
            continue
        assert 0 < pr["device_s"] <= r["dur_s"]
        assert pr["host_s"] == pytest.approx(r["dur_s"] - pr["device_s"],
                                             abs=1e-8)
    assert set(z["device_seconds"]) == {"decode", "mixed"}
    assert 0 <= z["host_overhead_ratio"] <= 1
    assert TO.EXEC_DEVICE_SECONDS.value(fn="decode") > 0
    assert TO.PHASE_MFU_MEASURED.value(phase="decode") > 0
    assert TO.HOST_OVERHEAD_RATIO.value(engine=eng._engine_id) > 0


def test_profilez_schema_equals_jax():
    """The `/profilez` payload's keys, less the port's renames: the probe
    ``clock`` it adds, and its capture trace (``torch_trace``, JAX's
    ``jax_trace``)."""
    m, tm = models(0)
    reset_both()
    je, te = engines(m, tm, profile=True, profile_sample_steps=1, **KW)
    je.generate(prompts(0), NEW)
    te.generate(prompts(0), NEW)
    jz, tz = je._profiling.statusz(), te._profiling.statusz()
    assert set(tz) - {"clock"} == set(jz)
    jcap = dict(jz["capture"])
    jcap["torch_trace"] = jcap.pop("jax_trace")
    assert set(tz["capture"]) == set(jcap)
    assert set(tz["hot_ops"]) <= set(jz["hot_ops"]) | set(tz["hot_ops"])
    for site, rows in tz["hot_ops"].items():
        assert rows and set(rows[0]) == {"op", "count", "flops", "bytes",
                                         "flops_frac", "bytes_frac"}
    assert set(tz["device_seconds"]) == set(jz["device_seconds"])
    assert set(tz["mfu_measured"]) == set(jz["mfu_measured"])


def test_hot_ops_carry_the_kernel_rows():
    _, tm = models(0)
    eng = TS.DecodeEngine(tm, device="cpu", profile=True, **KW,
                          kv_quant="int8")
    eng.generate(prompts(0), NEW)
    rows = TP.hot_op_table(eng._decode_fn)
    assert any(r["op"] == "paged_attention[K2]" for r in rows)
    assert sum(r["flops_frac"] for r in rows) <= 1.0 + 1e-6


def test_capture_session_writes_both_traces(tmp_path):
    """FLAGS_profile_dir: a bounded capture runs its steps under
    torch.profiler and writes its chrome trace and the merged chrome
    trace (engine, requests and device tracks)."""
    _, tm = models(0)
    reset_both()
    TF.set_flags({"profile_dir": str(tmp_path)})
    try:
        eng = TS.DecodeEngine(tm, device="cpu", profile=True,
                              profile_sample_steps=1000, **KW)
        st = TP.request_capture(3, engine=eng)
        assert st["pending_steps"] == 3
        eng.generate(prompts(0), NEW)
    finally:
        TF.set_flags({"profile_dir": ""})
    st = eng._profiling.capture_status()
    assert (st["captured_steps"], st["captures_completed"]) == (3, 1)
    assert TS.decode_stats()["profile_captures"] == 1
    assert len(_probed(eng)) == 3
    path = st["trace_path"]
    with open(os.path.join(path, "torch_trace.json")) as f:
        assert "traceEvents" in json.load(f)
    with open(os.path.join(path, "merged_trace.json")) as f:
        merged = json.load(f)
    tracks = {e["args"]["name"] for e in merged["traceEvents"]
              if e.get("ph") == "M"}
    assert {"host", "engine", "requests", "device"} <= tracks
    assert not st["torch_trace"]


def test_capture_registry():
    _, tm = models(0)
    with pytest.raises(ValueError):
        TP.request_capture(0)
    a = TS.DecodeEngine(tm, device="cpu", profile=True, **KW)
    b = TS.DecodeEngine(tm, device="cpu", profile=True, **KW)
    with pytest.raises(ValueError, match="explicit engine"):
        TP.profiler_for()
    assert TP.profiler_for(b) is b._profiling
    assert TP.capture_status(a)["captures_completed"] == 0
    from paddle_tpu_torch.inference.durability import retire_engine_series

    retire_engine_series(a._engine_id)
    with pytest.raises(ValueError):
        TP.profiler_for(a)


def test_mfu_regression_rule_reads_the_drift_table():
    _, tm = models(0)
    rule = TA.AlertRule("mfu", signal="mfu_drift_max", threshold=0.5,
                        op=">")
    eng = TS.DecodeEngine(tm, device="cpu", profile=True,
                          alerts=[rule], **KW)
    eng._alerts.evaluate(now=1.0)
    assert eng._alerts.snapshot()["rules"]["mfu"]["value"] is None
    eng._profiling._drift["decode"] = 0.9
    eng._alerts.evaluate(now=2.0)
    assert eng._alerts.firing() == ["mfu"]


def test_profile_flag_defaults_off():
    assert TF.flag("profile") == JF.flag("profile") is False
    _, tm = models(0)
    assert TS.DecodeEngine(tm, device="cpu", **KW)._profiling is None


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_probes_read_events(cuda_device):
    """On the card a probe is two CUDA events around the graph replay,
    read after the step's fetch: device seconds within the step's wall,
    and the tokens of the probed serve equal the unprobed one's."""
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig

    cfg = GPTConfig(vocab_size=96, hidden_size=128, num_layers=2,
                    num_heads=2, max_seq_len=128, use_parallel_layers=False)
    tm = GPT.random(cfg, seed=3, device=cuda_device)
    ps = prompts(0, vocab=96)
    off = TS.DecodeEngine(tm, flight_window=0, cost_model=False, **KW)
    on = TS.DecodeEngine(tm, profile=True, profile_sample_steps=1, **KW)
    assert on.generate(ps, NEW) == off.generate(ps, NEW)
    assert on._profiling.clock == "cuda_event"
    for r in on._flight.records():
        if "probe" in r:
            assert 0 < r["probe"]["device_s"] <= r["dur_s"]
