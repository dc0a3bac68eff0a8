"""paddle_tpu_torch.profiler's eager part against the JAX package's.

The same ``RecordEvent``s in both packages give the same summary rows
(names, calls, order under each sort key; the times are each process's
own); the merged chrome trace carries the host events on the ``host``
track beside a CPU serve's ``engine`` and ``requests`` tracks, and the
serve's steps under the JAX package's event names; a profiler that is
off records nothing, ``print_table=False`` prints nothing; the device
trace writes a chrome trace; ``FLAGS_eager_dispatch_report`` counts a
small eager loop's ops into the JAX package's table layout.
"""
import torch_test_env  # noqa: F401  (first: one intra-op thread)
import json
import time

import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import profiler as JP
from paddle_tpu_torch import profiler as TP
from paddle_tpu_torch.core import dispatch as TD
from paddle_tpu_torch.core import flags as TF
from paddle_tpu_torch.observability import tracing as TT

from torch_native_common import jax_native  # noqa: F401
from torch_telemetry_common import engines, models, prompts, reset_both

# JAX's profiler records through the JAX package's native tracer
pytestmark = pytest.mark.usefixtures("jax_native")

# name -> (calls, seconds a call): totals 240, 40 and 5 ms, calls 3, 1
# and 5, a call 80, 40 and 1 ms: each sort key orders them by a margin
# far above a loaded machine's oversleep
EVENTS = {"step.fwd": (3, 0.080), "step.bwd": (5, 0.001),
          "step.opt": (1, 0.040)}


def _record(pkg):
    for name, (n, s) in EVENTS.items():
        for _ in range(n):
            with pkg.RecordEvent(name):
                time.sleep(s)


def _rows(table):
    """(name, calls) of each row, in the table's order."""
    lines = table.splitlines()[2:]
    return [(ln[:40].strip(), int(ln[40:48])) for ln in lines]


@pytest.fixture
def clean_profiler():
    TP.reset_profiler()
    yield
    TP.stop_profiler(print_table=False)
    TP.reset_profiler()
    JP.reset_profiler()


@pytest.mark.parametrize("sorted_key", ["total", "calls", "max", "ave"])
def test_summary_rows_match_jax(sorted_key, clean_profiler):
    tables = {}
    for pkg in (JP, TP):
        pkg.start_profiler()
        _record(pkg)
        tables[pkg] = pkg.stop_profiler(sorted_key=sorted_key,
                                        print_table=False)
        pkg.reset_profiler()
    assert tables[TP].splitlines()[:2] == tables[JP].splitlines()[:2]
    assert _rows(tables[TP]) == _rows(tables[JP])
    assert sorted(_rows(tables[TP])) == sorted(
        (k, n) for k, (n, _) in EVENTS.items())


def test_disabled_records_nothing_and_quiet_stop(capsys, clean_profiler):
    _record(TP)
    assert TT.host_events() == []
    TP.start_profiler()
    ev = TP.RecordEvent("manual")
    ev.begin()
    ev.end()
    text = TP.stop_profiler(print_table=False)
    assert capsys.readouterr().out == ""
    assert [e[0] for e in TT.host_events()] == ["manual"]
    assert "manual" in text
    TP.start_profiler()
    TP.stop_profiler()
    assert "Profiling Report" in capsys.readouterr().out


def test_chrome_trace_tracks_and_serving_events(tmp_path, clean_profiler):
    """A CPU serve (chunked, then speculative) under the profiler: the
    trace's ``host`` track at pid 0 holds the steps' events under the JAX
    package's names, beside the ``engine`` and ``requests`` tracks."""
    reset_both()
    m, tm = models(seed=1)
    _, eng = engines(m, tm, max_batch_size=4, page_size=8)
    _, spec = engines(m, tm, max_batch_size=4, page_size=8,
                      spec_decode_k=2)
    path = tmp_path / "trace.json"
    with TP.profiler(profile_path=str(path)):
        eng.generate(prompts(seed=2), 6)
        spec.generate(prompts(seed=3), 6)
    data = json.loads(path.read_text())
    meta = {e["args"]["name"]: e["pid"] for e in data["traceEvents"]
            if e["ph"] == "M"}
    assert meta["host"] == 0 and {"engine", "requests"} <= set(meta)
    host = {e["name"] for e in data["traceEvents"]
            if e["ph"] == "X" and e["pid"] == 0}
    assert {"serving.mixed_step", "serving.decode_step",
            "serving.spec_verify_step"} <= host
    rows = dict(_rows(TP.summary_string()))
    assert rows["serving.mixed_step"] >= 1
    reset_both()


def test_device_trace_writes_chrome_trace(tmp_path):
    with TP.trace(str(tmp_path)):
        torch.ones(8, 8) @ torch.ones(8, 8)
    files = list(tmp_path.glob("trace_*.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())[
        "traceEvents"]}
    assert "aten::mm" in names
    assert TP.stop_trace() is None


def test_dispatch_report_counts_an_eager_loop(capsys):
    """The flag on: a small eager loop's ops by name with their calls;
    the JAX package's header and columns, its cache columns 0; the flag
    off again: the mode gone, the counts kept for the exit report."""
    TD.reset_dispatch_stats()
    lin = torch.nn.Linear(4, 3)
    TF.set_flags({"eager_dispatch_report": True})
    try:
        for _ in range(3):
            loss = torch.nn.functional.linear(torch.ones(2, 4), lin.weight,
                                              lin.bias).sum()
            loss.backward()
    finally:
        TF.set_flags({"eager_dispatch_report": False})
    assert TD.active_mode() is None
    stats = TP.dispatch_stats()
    assert stats["linear"]["calls"] == 3 and stats["sum"]["calls"] == 3
    assert all(s["hits"] == s["misses"] == s["bypasses"] == 0
               for s in stats.values())
    table = TP.dispatch_summary_string(sorted_key="calls")
    want_head = paddle.profiler.dispatch_summary_string().splitlines()[:2]
    assert table.splitlines()[:2] == want_head
    assert any(ln.startswith("linear ") for ln in table.splitlines()[2:])
    TP.reset_dispatch_stats()
    assert TP.dispatch_stats() == {}
