"""paddle_tpu_torch's process-wide serving telemetry (`profiler.decode_stats`,
`inference.serving.decode_stats`) against the JAX package's.

The schema (`DECODE_STAT_COUNTERS` and `DECODE_STAT_DERIVED`, copied into
the port) must equal JAX's key for key and in order.  After the same
tiny serve on the CPU, the counters the port fills must equal the JAX
engine's exactly, and the occupancy and KV-utilization sums (means of
host-side ratios, the same operations in the same order) within 1e-9;
``reset=True`` zeroes what it read.  Keys whose module the port has not
brought over stay 0.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax

import paddle_tpu as paddle
from paddle_tpu import profiler as JP
from paddle_tpu.inference import serving as JS
from paddle_tpu.models.gpt import GPT, GPTConfig
from paddle_tpu_torch import profiler as TP
from paddle_tpu_torch.inference import serving as TS
from paddle_tpu_torch.inference.weights import params_from_numpy
from paddle_tpu_torch.models.gpt import GPT as TGPT
from paddle_tpu_torch.models.gpt import GPTConfig as TGPTConfig

REPO = Path(__file__).resolve().parents[1]
TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            max_seq_len=128, use_parallel_layers=False, dropout=0.0)
# the counters this port fills as JAX does
FILLED = ("steps", "tokens", "prefills", "stalled_decode_steps",
          "prefix_evictions", "finished_eos", "finished_length",
          "finished_fault", "mixed_steps", "prefill_chunks", "prefix_hits",
          "prefix_misses", "prefix_cached_tokens", "spec_steps",
          "spec_slot_steps", "spec_proposed", "spec_accepted",
          "spec_emitted", "kv_quant_pages", "kv_quant_refolds",
          "weight_quant_mats", "weight_quant_bytes_saved",
          # the telemetry plane: a flight record a step on both, and with
          # the cost model and profiling disarmed on both, no calibration
          # update or probe (``cost_profiles`` counts additions to a
          # process-wide table, which earlier serves of the process fill:
          # test_torch_costmodel holds it against JAX)
          "flight_records", "flight_dumps", "cost_updates",
          "profile_probes", "profile_captures")
SUMS = ("occupancy_sum", "kv_util_sum", "batch_occupancy",
        "kv_block_utilization", "acceptance_rate", "mean_accepted_per_step")
# modules the port has not brought over yet: their counters stay 0
NOT_PORTED = ("evicted", "cancelled", "preemptions", "resumes",
              "deadline_expired", "slo_violations", "faults_injected",
              "step_retries", "recoveries", "spec_disables",
              "legacy_fallbacks", "journal_records", "journal_snapshots",
              "restores", "exec_handoffs", "hung_steps", "adoptions",
              "journal_compactions")
SERVES = {
    "split": {},
    "ragged": dict(ragged_step=True),
    "spec": dict(spec_decode_k=3),
    "legacy": dict(chunked_prefill=False),
    "int8": dict(kv_quant="int8", serve_weights="int8"),
    # a pool of four pages: a cached prompt page is recycled
    "evicting": dict(num_pages=4),
}


def _models(seed):
    paddle.seed(seed)
    m = GPT(GPTConfig(**TINY))
    m.eval()
    tree = jax.tree_util.tree_map(np.asarray, JS._extract_gpt_params(m))
    return m, TGPT.from_params(TGPTConfig(**TINY),
                               params_from_numpy(tree, device="cpu"))


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 64, (n,)).astype(np.int32) for n in lens]


def test_schema_equals_jax():
    assert TP.DECODE_STAT_COUNTERS == JP.DECODE_STAT_COUNTERS
    assert TP.DECODE_STAT_DERIVED == JP.DECODE_STAT_DERIVED
    assert list(TP.decode_stats()) == list(JP.decode_stats())
    assert list(TS.decode_stats()) == list(JS.decode_stats())
    for k in TP.DECODE_STAT_COUNTERS + TP.DECODE_STAT_DERIVED:
        assert type(TP._decode_stat_zero(k)) is \
            type(JP._decode_stat_zero(k)), k


_FRESH = """
import sys
from paddle_tpu_torch import profiler
st = profiler.decode_stats()
profiler.reset_decode_stats()
ok = (list(st) == list(profiler.DECODE_STAT_COUNTERS
                       + profiler.DECODE_STAT_DERIVED)
      and not any(st.values())
      and "paddle_tpu_torch.inference.serving" not in sys.modules)
sys.exit(0 if ok else 1)
"""


def test_profiler_reads_zeros_without_the_engine():
    """With no engine module loaded the profiler's read is all zeros and
    does not import the serving module (as JAX's profiler does)."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", _FRESH], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("serve", sorted(SERVES))
def test_serve_counters_equal_jax(serve):
    """Five requests through two slots, an EOS token some of them meet:
    every counter the port fills equals the JAX engine's, the sums and
    derived means agree, the unported counters stay 0, and the profiler
    reads the serving module's dict."""
    m, tm = _models(5)
    rng = np.random.RandomState(3)
    shared = rng.randint(0, 64, 16)
    prompts = _prompts(3, (5, 9, 13, 21, 30))
    prompts[3] = np.concatenate([shared, prompts[3]]).astype(np.int32)
    prompts[4] = np.concatenate([shared, prompts[4]]).astype(np.int32)
    kw = dict(max_batch_size=2, max_seq_len=64, page_size=16,
              prefill_chunk_tokens=8, **SERVES[serve])
    eos = TS.DecodeEngine(tm, device="cpu", **kw).generate(prompts, 8)[1][3]
    JS.reset_decode_stats()
    je = JS.DecodeEngine(m, cost_model=False, eos_token_id=eos, **kw)
    jt, jr = je.generate(prompts, 8, return_meta=True)
    jst = JS.decode_stats()
    TS.reset_decode_stats()
    te = TS.DecodeEngine(tm, device="cpu", cost_model=False,
                         eos_token_id=eos, **kw)
    tt, tr = te.generate(prompts, 8, return_meta=True)
    tst = TP.decode_stats()
    assert tt == [[int(t) for t in o] for o in jt] and tr == jr
    assert "eos" in tr
    assert {k: int(tst[k]) for k in FILLED} == \
        {k: int(jst[k]) for k in FILLED}
    for k in SUMS:
        assert tst[k] == pytest.approx(float(jst[k]), abs=1e-9), k
    assert all(tst[k] == 0 for k in NOT_PORTED)
    assert tst["steps"] == te.decode_stats()["steps"] > 0
    if serve == "evicting":
        assert tst["prefix_evictions"] > 0
    if serve == "legacy":
        assert tst["stalled_decode_steps"] > 0


def test_reset_zeroes_and_engines_sum():
    """Two engines add into one process-wide dict; ``reset=True`` returns
    the read and leaves zeros; `reset_decode_stats` zeroes too."""
    _, tm = _models(2)
    prompts = _prompts(4, (6, 10))
    TS.reset_decode_stats()
    engines = [TS.DecodeEngine(tm, device="cpu", max_batch_size=2,
                               max_seq_len=64, page_size=16)
               for _ in range(2)]
    for eng in engines:
        eng.generate(prompts, 5)
    st = TS.decode_stats(reset=True)
    assert st["steps"] == sum(e.decode_stats()["steps"] for e in engines)
    assert st["tokens"] == 2 * 2 * 5 and st["decode_time_s"] > 0
    assert st["avg_step_ms"] > 0 and 0 < st["batch_occupancy"] <= 1
    after = TP.decode_stats()
    assert not any(after[k] for k in TP.DECODE_STAT_COUNTERS)
    engines[0].generate(prompts, 3)
    assert TS.decode_stats()["tokens"] == 6
    TP.reset_decode_stats()
    assert TS.decode_stats()["tokens"] == 0
