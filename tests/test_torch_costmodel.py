"""The port's cost observatory against the JAX package's
(tests/test_costmodel.py): the analytical formula and the CPU peaks are
equal, the same sealed records teach both the same EWMA factors, the
port's counted step FLOPs stay within a stated tolerance of JAX's HLO
count, the HBM ledger attributes the same bytes, and the
cost-gated admission decisions and the speculative K trajectories equal
JAX's with the cost model on."""
import torch_test_env  # noqa: F401  (first: one intra-op thread)
import math

import numpy as np
import pytest
import torch

from paddle_tpu.core import flags as JF
from paddle_tpu.inference import serving as JS
from paddle_tpu.inference import speculative as JSP
from paddle_tpu.observability import costmodel as JC
from paddle_tpu_torch.core import flags as TF
from paddle_tpu_torch.inference import serving as TS
from paddle_tpu_torch.inference import speculative as TSP
from paddle_tpu_torch.observability import costmodel as TC

from torch_telemetry_common import (HD64, TINY, engines, models, prompts,
                                    reset_both)

KW = dict(max_batch_size=2, page_size=16)
# the port counts each step's FLOPs over its eager run (the matrix
# products exactly, one per output element elsewhere, K1/K2 by their
# horizon-wide work formula); JAX reads XLA's HLO cost analysis, which
# counts the elementwise ops and the interpreted attention its own way.
# On these configurations the two stay within 25% of each other.
FLOPS_RTOL = 0.25


@pytest.mark.parametrize("args", [
    dict(batch=8, q=1, kv_len=300, layers=12, hidden=768, vocab=50304),
    dict(batch=2, q=64, kv_len=1, layers=2, hidden=32, vocab=64,
         num_heads=4, weight_bytes=1, kv_bytes=1),
    dict(batch=4, q=5, kv_len=77, layers=3, hidden=96, vocab=100,
         kv_heads=2, num_heads=6),
])
def test_analytical_cost_equals_jax(args):
    assert TC.analytical_gpt_cost(**args) == JC.analytical_gpt_cost(**args)


def test_cpu_peaks_equal_jax():
    assert TC.resolve_peaks(torch.device("cpu")) == JC.resolve_peaks()
    for F in (JF, TF):
        F.set_flags({"peak_flops": 3e12, "peak_hbm_gbps": 500.0,
                     "peak_ici_gbps": 25.0})
    try:
        assert TC.resolve_peaks(torch.device("cpu")) == JC.resolve_peaks()
        assert TC.resolve_peaks()["source"] == "flags"
    finally:
        for F in (JF, TF):
            F.set_flags({"peak_flops": 0.0, "peak_hbm_gbps": 0.0,
                         "peak_ici_gbps": 0.0})


def test_h100_peaks_from_the_card_name(monkeypatch):
    """The device table: NVIDIA's datasheet dense bf16 rate and HBM3
    bandwidth for an H100, read from the card's name."""
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    p = TC.resolve_peaks(torch.device("cuda", 0))
    assert (p["flops"], p["bytes_per_s"]) == (989e12, 3.35e12)
    assert p["source"] == "autodetect:nvidia h100 80gb hbm3"
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "other")
    assert TC.resolve_peaks(torch.device("cuda", 0))["source"] == \
        "cpu-pinned"


def _records(seed):
    """Sealed step records with predicted/actual pairs, some from a
    learned factor, across two step kinds."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(40):
        fn = "decode" if i % 3 else "mixed"
        raw = float(rng.uniform(1e-5, 1e-3))
        out.append({"kind": "step", "dur_s": float(rng.uniform(1e-4, 5e-2)),
                    "cost": {"fn": fn, "raw_s": raw,
                             "predicted_s": raw * float(rng.uniform(1, 80)),
                             "calibrated": i > 2}})
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_records_teach_the_same_factors(seed):
    m, tm = models(0)
    je, te = engines(m, tm, **KW)
    for rec in _records(seed):
        for cm in (je._cost, te._cost):
            cm._pending = {"sig": cm._tracker_sig()}
            cm.observe(dict(rec, cost=dict(rec["cost"])))
    for a, b in ((je._cost._calib, te._cost._calib),
                 (je._cost._err, te._cost._err)):
        assert set(a) == set(b) and a
        for k in a:
            assert math.isclose(a[k], b[k], rel_tol=1e-12), k


def _serve_profiles(cfg, mode):
    m, tm = models(0, cfg)
    reset_both()
    JC.clear_profiles()
    TC.clear_profiles()
    je, te = engines(m, tm, **KW, **mode)
    ps = prompts(0, vocab=cfg["vocab_size"])
    je.generate(ps, 6)
    te.generate(ps, 6)
    return je, te


@pytest.mark.parametrize("mode", [{}, {"kv_quant": "int8",
                                       "serve_weights": "int8"},
                                  {"ragged_step": True}],
                         ids=["f32", "int8", "ragged"])
@pytest.mark.parametrize("cfg", [TINY, HD64], ids=["tiny", "hd64"])
def test_counted_flops_near_hlo(cfg, mode):
    je, te = _serve_profiles(cfg, mode)
    kinds = ("ragged",) if mode.get("ragged_step") else ("decode", "mixed")
    for kind in kinds:
        jp, tp = je._cost.profile_for(kind), te._cost.profile_for(kind)
        assert (jp.source, tp.source) == ("hlo", "counted"), kind
        assert tp.site == jp.site
        assert tp.flops == pytest.approx(jp.flops, rel=FLOPS_RTOL), kind
        assert tp.bytes_accessed > 0
        ops = {r["op"] for r in tp.hot_ops}
        k = "paged_attention[K2]" if mode.get("kv_quant") else \
            "paged_attention[K1]"
        assert k in ops, ops
    assert TS.decode_stats()["cost_profiles"] == \
        len(TC._PROFILES) > 0


@pytest.mark.parametrize("mode", [{}, {"kv_quant": "int8",
                                       "serve_weights": "int8"}],
                         ids=["f32", "int8"])
def test_ledger_attributes_the_same_bytes(mode):
    """Weights by storage dtype byte for byte; the port's pools and
    scales carry one drop page past JAX's (``P + 1`` pages); JAX's PRNG
    key (misc) has no tensor counterpart; no residue is measured on the
    CPU."""
    m, tm = models(0)
    je, te = engines(m, tm, **KW, **mode)
    jl, tl = je._cost.hbm_ledger(), te._cost.hbm_ledger()
    jc, tc = jl["categories"], tl["categories"]
    assert set(jc) == set(tc) == set(TC.LEDGER_CATEGORIES)
    for cat in ("weights", "weights_int8", "weight_scales", "draft_pool",
                "temp_scratch"):
        assert tc[cat] == jc[cat], cat
    p = je.pool.num_pages
    for cat in ("kv_pages", "kv_scales"):
        assert tc[cat] * p == jc[cat] * (p + 1), cat
    assert jc["misc"] == 8 and tc["misc"] == 0
    assert tl["unattributed_bytes"] is None
    assert tl["total_live_bytes"] is None
    assert tc["weights"] == sum(
        t.numel() * t.element_size()
        for t in [v for k, v in te._params.items() if k != "blocks"
                  and v is not None]
        + [v for b in te._params["blocks"] for k, v in b.items()
           if v.dtype != torch.int8 and not k.endswith("_s")])


def _admission_log(eng):
    log = []
    inner = eng._cost.admission_ok

    def wrapped(req):
        ok = inner(req)
        log.append((int(eng._step_no), req.request_id, ok))
        return ok
    eng._cost.admission_ok = wrapped
    return log


def test_cost_admission_decisions_equal_jax():
    """FLAGS_sched_cost_admission: with targets far below and far above
    any step's cost, both engines refuse and admit the same requests at
    the same steps."""
    m, tm = models(0)
    ps = prompts(0, lens=(5, 9, 13, 7, 11))
    for F in (JF, TF):
        F.set_flags({"sched_cost_admission": True})
    try:
        reset_both()
        je, te = engines(m, tm, **KW)
        logs = [_admission_log(je), _admission_log(te)]
        reqs = []
        for eng in (je, te):
            reqs.append([eng.add_request(p, max_new_tokens=5,
                                         slo_tpot_ms=t)
                         for p, t in zip(ps, (None, 1e-3, 1e6, 1e-3,
                                              None))])
            eng.run()
    finally:
        for F in (JF, TF):
            F.set_flags({"sched_cost_admission": False})
    assert logs[1] == logs[0]
    assert any(not ok for _, _, ok in logs[0])
    assert any(ok for _, _, ok in logs[0])
    assert [r.finish_reason for r in reqs[1]] == \
        [r.finish_reason for r in reqs[0]]


def _regime(base):
    class Regime(base):
        """The true continuation while ``accept``, else off by one: a
        reject phase shrinks K, an accept phase asks to grow it."""
        name = "regime"

        def __init__(self, refs):
            self.refs = refs
            self.accept = False

        def propose(self, write_caps):
            eng = self.engine
            out = np.zeros((eng._slots, self.k), np.int32)
            for s in range(eng._slots):
                req = eng._by_slot[s]
                if req is None or not eng._active[s]:
                    continue
                ref = self.refs[tuple(int(t) for t in
                                      req.prompt_ids[:req.orig_prompt_len])]
                pos = len(req.generated_ids)
                cont = np.asarray((list(ref) + [0] * self.k)
                                  [pos:pos + self.k], np.int32)
                out[s] = cont if self.accept else (cont + 1) % 64
            return out
    return Regime


@pytest.mark.parametrize("ragged", [False, True], ids=["split", "ragged"])
def test_spec_k_trajectories_equal_jax(ragged):
    """Adaptive K with the cost model on (the default): every `_grow_ok`
    verdict and the per-slot K after every step equal JAX's."""
    m, tm = models(21)
    ps = prompts(9, lens=(6, 8))
    ref = TS.DecodeEngine(tm, device="cpu", max_batch_size=2,
                          max_seq_len=96, page_size=16).generate(ps, 40)
    refs = {tuple(p): r for p, r in zip(ps, ref)}
    out = []
    for S, SP in ((JS, JSP), (TS, TSP)):
        reset_both()
        drafter = _regime(SP.Drafter)(refs)
        kw = dict(max_batch_size=2, max_seq_len=96, page_size=16,
                  spec_decode_k=3, spec_adaptive_k=True, drafter=drafter,
                  ragged_step=ragged)
        eng = S.DecodeEngine(tm, device="cpu", **kw) if S is TS else \
            S.DecodeEngine(m, **kw)
        sd = eng._spec
        verdicts = []
        inner = sd._grow_ok

        def grow_ok(_inner=inner, _v=verdicts):
            ok = _inner()
            _v.append(ok)
            return ok
        sd._grow_ok = grow_ok
        for p in ps:
            eng.add_request(p, max_new_tokens=36)
        traj = []
        for i in range(40):
            drafter.accept = i >= 5
            if not eng.step():
                break
            traj.append(tuple(int(k) for k in sd.k_slot))
        eng.run()
        st = S.decode_stats()
        out.append((verdicts, traj, st["spec_k_grows"],
                    st["spec_k_shrinks"]))
    assert out[1] == out[0]
    assert out[0][0], "no growth was ever asked for"
