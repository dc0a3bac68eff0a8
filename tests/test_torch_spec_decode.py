"""paddle_tpu_torch's speculative decoding against the JAX package's.

The scenarios of tests/test_spec_decode.py and the adaptive-depth ones of
tests/test_ragged_step.py.  Greedy tokens of the port's speculative
engine (prompt-lookup, draft-model and always-wrong drafters; adaptive
depth on and off; f32 and int8 KV pages) must equal the port's
non-speculative engine's and the JAX speculative engine's, with the
speculative counters equal to JAX's; a rejected draft is rolled back by
the length alone, so every pool drains.  Sampled output is held against
the non-speculative engine's marginal (port engines only: torch cannot
reproduce JAX's random streams).
"""
import numpy as np
import pytest
import torch

import jax

import paddle_tpu as paddle
from paddle_tpu.inference import serving as JS
from paddle_tpu.inference import speculative as JSP
from paddle_tpu.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.core import flags as TF
from paddle_tpu_torch.inference import serving as TS
from paddle_tpu_torch.inference import speculative as TSP
from paddle_tpu_torch.inference.weights import params_from_numpy
from paddle_tpu_torch.models.gpt import GPT as TGPT
from paddle_tpu_torch.models.gpt import GPTConfig as TGPTConfig

# tests/test_spec_decode.py's TINY
TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            max_seq_len=128, use_parallel_layers=False, dropout=0.0)
SPEC_KEYS = ("steps", "tokens", "spec_steps", "spec_slot_steps",
             "spec_proposed", "spec_accepted", "spec_emitted",
             "spec_k_shrinks", "spec_k_grows")


def _models(seed, cfg=TINY):
    """A random JAX GPT and the port's GPT over the same weights."""
    paddle.seed(seed)
    m = GPT(GPTConfig(**cfg))
    m.eval()
    tree = jax.tree_util.tree_map(np.asarray, JS._extract_gpt_params(m))
    return m, TGPT.from_params(TGPTConfig(**cfg),
                               params_from_numpy(tree, device="cpu"))


def _draft_cfg():
    c = GPTConfig(**TINY).draft_config()
    return dict(vocab_size=c.vocab_size, hidden_size=c.hidden_size,
                num_layers=c.num_layers, num_heads=c.num_heads,
                max_seq_len=c.max_seq_len, use_parallel_layers=False,
                dropout=0.0)


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 64, (n,)).astype(np.int32) for n in lens]


def _kw(**kw):
    out = dict(max_batch_size=2, max_seq_len=64, page_size=16)
    out.update(kw)
    return out


def _port(tm, **kw):
    return TS.DecodeEngine(tm, device="cpu", **_kw(**kw))


def _drained(eng):
    assert eng.pool.available_count == eng.pool.num_pages
    assert eng.pool.reserved == 0 and not eng._active.any()


def _wrong(eng, k):
    """Rotating off-by-one drafts: acceptance ~0, a full rollback a
    round (tests/test_spec_decode.py's `_AlwaysWrongDrafter`)."""
    out = np.zeros((eng._slots, k), np.int32)
    for s in range(eng._slots):
        out[s] = (int(eng._last[s]) + 1 + np.arange(k)) % 64
    return out


class _TWrong(TSP.Drafter):
    name = "always_wrong"

    def propose(self, write_caps):
        return _wrong(self.engine, self.k)


class _JWrong(JSP.Drafter):
    name = "always_wrong"

    def propose(self, write_caps):
        return _wrong(self.engine, self.k)


def _drafters(kind, seed):
    """The (JAX, port) drafter pair of ``kind``, the draft models on the
    same weights."""
    if kind == "prompt_lookup":
        return "prompt_lookup", "prompt_lookup"
    if kind == "always_wrong":
        return _JWrong(), _TWrong()
    dm, tdm = _models(seed, _draft_cfg())
    return JSP.DraftModelDrafter(dm), TSP.DraftModelDrafter(tdm)


# ---------------------------------------------------------------------------
# greedy parity and the counters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("adaptive", [False, True], ids=["fixed", "adaptive"])
@pytest.mark.parametrize("kv", ["off", "int8"])
@pytest.mark.parametrize("kind", ["prompt_lookup", "draft_model",
                                  "always_wrong"])
def test_greedy_parity_and_counters(kind, kv, adaptive):
    """Staggered batching (three prompts, two slots): the speculative
    engine's tokens equal the non-speculative engine's and the JAX
    speculative engine's, and so do the speculative counters."""
    m, tm = _models(5)
    prompts = _prompts(3, (5, 9, 13))
    kw = dict(kv_quant=kv, spec_decode_k=3, spec_adaptive_k=adaptive)
    ref = _port(tm, kv_quant=kv).generate(prompts, 10)
    jd, td = _drafters(kind, seed=17)
    JS.reset_decode_stats()
    # no cost model on either side: the ungated growth (the gated one is
    # held against JAX in test_torch_costmodel)
    je = JS.DecodeEngine(m, drafter=jd, cost_model=False, **_kw(**kw))
    jt = [[int(t) for t in o] for o in je.generate(prompts, 10)]
    jst = JS.decode_stats()
    te = _port(tm, drafter=td, cost_model=False, **kw)
    tt = te.generate(prompts, 10)
    assert tt == ref == jt
    tst = te.decode_stats()
    assert {k: int(tst[k]) for k in SPEC_KEYS} == \
        {k: int(jst[k]) for k in SPEC_KEYS}
    assert tst["acceptance_rate"] == pytest.approx(jst["acceptance_rate"])
    assert tst["mean_accepted_per_step"] == \
        pytest.approx(jst["mean_accepted_per_step"])
    if kind == "always_wrong":
        assert tst["acceptance_rate"] < 0.2
    for eng in (je, te):
        _drained(eng)
    te.pool.assert_consistent(live_pages=[])


@pytest.mark.parametrize("k", [2, 4])
def test_prompt_lookup_matches_engine_for_several_k(k):
    _, tm = _models(5)
    prompts = _prompts(3, (5, 9, 13))
    ref = _port(tm).generate(prompts, 10)
    eng = _port(tm, spec_decode_k=k)
    assert eng.generate(prompts, 10) == ref
    _drained(eng)


def test_self_draft_accepts_everything():
    """The target as its own draft model proposes the target's greedy
    continuation: every usable draft is accepted."""
    _, tm = _models(6)
    prompts = _prompts(4, (6, 11))
    ref = _port(tm).generate(prompts, 12)
    eng = _port(tm, spec_decode_k=4, drafter=TSP.DraftModelDrafter(tm))
    assert eng.generate(prompts, 12) == ref
    st = eng.decode_stats()
    assert st["acceptance_rate"] >= 0.9, st["acceptance_rate"]
    assert st["mean_accepted_per_step"] > 2
    _drained(eng)


# ---------------------------------------------------------------------------
# adaptive depth (tests/test_ragged_step.py:215-300)
# ---------------------------------------------------------------------------
class _Regime(TSP.Drafter):
    """Proposes the true greedy continuation (accept regime) or that
    continuation off by one (reject regime)."""

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
            ref = self.refs[tuple(int(t) for t in req.prompt_ids)]
            pos = len(req.output_ids)
            cont = np.asarray((list(ref) + [0] * self.k)[pos:pos + self.k],
                              np.int32)
            out[s] = cont if self.accept else (cont + 1) % 64
        return out


@pytest.mark.parametrize("ragged", [True, False], ids=["ragged", "split"])
def test_adaptive_k_shrinks_then_regrows(ragged):
    """Rejection streaks walk K down 4 -> 2 -> 1, acceptance runs walk it
    back 1 -> 2 -> 3 -> 4, and the tokens stay the target's."""
    _, tm = _models(21)
    p = _prompts(9, (6,))[0]
    ref = _port(tm, max_batch_size=1, max_seq_len=96).generate([p], 60)[0]
    drafter = _Regime({tuple(int(t) for t in p): ref})
    # the depth controller alone, as JAX's test runs it: no cost model
    # to gate the regrowth
    eng = _port(tm, max_batch_size=1, max_seq_len=96, spec_decode_k=4,
                spec_adaptive_k=True, drafter=drafter, ragged_step=ragged,
                cost_model=False)
    sd = eng._spec
    assert sd.adaptive and sd.k_min == 1 and sd._grow_ok()
    req = eng.add_request(p, max_new_tokens=58)
    for _ in range(4):
        eng.step()
    assert int(sd.k_slot[0]) == 1
    assert eng.decode_stats()["spec_k_shrinks"] == 2
    assert req.output_ids == ref[:len(req.output_ids)]
    drafter.accept = True
    for _ in range(6):
        eng.step()
    assert int(sd.k_slot[0]) == 4
    st = eng.decode_stats()
    assert (st["spec_k_grows"], st["spec_k_shrinks"]) == (3, 2)
    assert req.output_ids == ref[:len(req.output_ids)]
    eng.run()
    assert req.output_ids == ref[:58]
    assert int(sd.k_slot[0]) == 4  # the finish reset the slot's depth
    _drained(eng)


def test_adaptive_k_flags_set_the_controller():
    _, tm = _models(24)
    TF.set_flags({"spec_k_min": 2, "spec_k_shrink_streak": 3,
                  "spec_k_grow_streak": 5})
    try:
        sd = _port(tm, spec_decode_k=4, spec_adaptive_k=True)._spec
    finally:
        TF.set_flags({"spec_k_min": 1, "spec_k_shrink_streak": 2,
                      "spec_k_grow_streak": 2})
    assert (sd.k_min, sd._shrink_after, sd._grow_after) == (2, 3, 5)
    TF.set_flags({"spec_adaptive_k": True})
    try:
        assert _port(tm, spec_decode_k=2)._spec.adaptive
        assert _port(tm)._spec is None  # the flag alone implies nothing
    finally:
        TF.set_flags({"spec_adaptive_k": False})


# ---------------------------------------------------------------------------
# rollback invariants (tests/test_spec_decode.py:368-425)
# ---------------------------------------------------------------------------
def test_pool_clean_after_mixed_traffic():
    _, tm = _models(9)
    rng = np.random.RandomState(7)
    for drafter in (_TWrong(), TSP.PromptLookupDrafter()):
        eng = _port(tm, spec_decode_k=3, drafter=drafter)
        for _ in range(3):
            prompts = [rng.randint(0, 64, (n,)).astype(np.int32)
                       for n in (4, 9, 6)]
            ref = _port(tm).generate(prompts, 6)
            assert eng.generate(prompts, 6) == ref
            _drained(eng)
            eng.pool.assert_consistent(live_pages=[])


def test_rollback_never_outruns_reservation():
    """K = 6 against 3 new tokens: the windows clamp to the need."""
    _, tm = _models(10)
    p = _prompts(8, (4,))[0]
    ref = _port(tm, max_batch_size=1, max_seq_len=32).generate([p], 3)[0]
    eng = _port(tm, max_batch_size=1, max_seq_len=32, spec_decode_k=6)
    assert eng.generate([p], 3)[0] == ref
    _drained(eng)


def test_lens_rollback_exact():
    """A fully rejected round writes K+1 rows and advances the length by
    exactly the one correction token."""
    _, tm = _models(11)
    p = _prompts(9, (5,))[0]
    eng = _port(tm, max_batch_size=1, spec_decode_k=4, drafter=_TWrong())
    req = eng.add_request(p, max_new_tokens=10)
    eng.step()
    lens0, out0 = int(eng._lens[0]), len(req.output_ids)
    eng.step()
    assert int(eng._lens[0]) == lens0 + 1
    assert len(req.output_ids) == out0 + 1
    eng.run()
    assert req.output_ids == _port(tm, max_batch_size=1).generate([p],
                                                                   10)[0]
    _drained(eng)


# ---------------------------------------------------------------------------
# finish reasons, eos, refusals and flags
# ---------------------------------------------------------------------------
def test_finish_reasons():
    m, tm = _models(12)
    p = _prompts(10, (5,))[0]
    first = _port(tm).generate([p], 1)[0][0]
    eng = _port(tm, spec_decode_k=3, eos_token_id=int(first))
    toks, reasons = eng.generate([p, p], 6, return_meta=True)
    assert reasons == ["eos", "eos"] and toks == [[first], [first]]
    other = _prompts(11, (7,))[0]
    _, reasons = eng.generate([other], 2, return_meta=True)
    assert reasons == ["length"]
    _drained(eng)


class _Oracle(TSP.Drafter):
    """Proposes the true greedy continuation: every draft lands, so each
    round's window runs K+1 tokens deep."""

    def __init__(self, ref):
        self.ref = ref

    def propose(self, write_caps):
        eng = self.engine
        out = np.zeros((eng._slots, self.k), np.int32)
        req = eng._by_slot[0]
        pos = len(req.output_ids)
        out[0] = (list(self.ref) + [0] * self.k)[pos:pos + self.k]
        return out


def _eos_fixture(k):
    """The first (seed, prompt, greedy chain, j) whose chain's token j
    appears there first with 1 <= j < k: with every draft accepted, the
    first round's window covers chain positions 1..k+1, so that token
    falls strictly inside it, with accepted tokens after it."""
    for seed in range(40):
        _, tm = _models(seed)
        p = _prompts(seed, (5,))[0]
        ref = _port(tm, max_batch_size=1).generate([p], 12)[0]
        for j in range(1, k):
            if ref[j] not in ref[:j]:
                return tm, p, ref, j
    raise AssertionError("no fixture found")


@pytest.mark.parametrize("drafter", ["oracle", "prompt_lookup"])
def test_eos_inside_verify_window_truncates(drafter):
    """The non-speculative chain cut at its first eos is what the
    speculative engine emits, with reason "eos", and the pool drains."""
    k = 4
    tm, p, ref, j = _eos_fixture(k)
    eos = ref[j]
    d = _Oracle(ref) if drafter == "oracle" else TSP.PromptLookupDrafter()
    eng = _port(tm, max_batch_size=1, spec_decode_k=k, eos_token_id=eos,
                drafter=d)
    toks, reasons = eng.generate([p], 12, return_meta=True)
    assert toks[0] == ref[:j + 1]
    assert reasons == ["eos"]
    if drafter == "oracle":
        st = eng.decode_stats()
        # one round: the drafts after eos were accepted and dropped
        assert (st["spec_steps"], st["spec_emitted"]) == (1, j)
    _drained(eng)
    eng.pool.assert_consistent(live_pages=[])


def test_draft_config_pins_token_space():
    cfg = TGPTConfig(**TINY)
    d = cfg.draft_config()
    j = GPTConfig(**TINY).draft_config()
    assert (d.vocab_size, d.max_seq_len, d.num_layers, d.hidden_size,
            d.num_heads, d.intermediate_size) == \
        (j.vocab_size, j.max_seq_len, j.num_layers, j.hidden_size,
         j.num_heads, j.intermediate_size)
    small = TGPTConfig(vocab_size=50304, hidden_size=768, num_layers=12,
                       num_heads=12).draft_config()
    # GPT-2-small's draft: 384 wide in 6 heads, head_dim 64 (K1's)
    assert (small.hidden_size, small.num_heads) == (384, 6)
    with pytest.raises(ValueError, match="divisible"):
        cfg.draft_config(hidden_size=30, num_heads=4)


def test_draft_refusals():
    _, tm = _models(15)
    bad = TGPT.random(TGPTConfig(vocab_size=32, hidden_size=16,
                                 num_layers=1, num_heads=2,
                                 max_seq_len=128), device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        _port(tm, spec_decode_k=2, drafter=TSP.DraftModelDrafter(bad))
    short = TGPT.random(TGPTConfig(vocab_size=64, hidden_size=16,
                                   num_layers=1, num_heads=2,
                                   max_seq_len=32), device="cpu")
    with pytest.raises(ValueError, match="position table"):
        _port(tm, spec_decode_k=2, drafter=TSP.DraftModelDrafter(short))
    with pytest.raises(ValueError, match="unknown drafter"):
        _port(tm, spec_decode_k=2, drafter="no_such_drafter")
    with pytest.raises(ValueError, match="spec_decode_k"):
        _port(tm, drafter="prompt_lookup")
    with pytest.raises(ValueError, match="spec_adaptive_k"):
        _port(tm, spec_adaptive_k=True)
    with pytest.raises(ValueError, match="spec_decode_k must be"):
        TSP.SpeculativeDecoder(_port(tm), k=0)
    d = TSP.PromptLookupDrafter()
    _port(tm, spec_decode_k=2, drafter=d)
    with pytest.raises(ValueError, match="already bound"):
        _port(tm, spec_decode_k=2, drafter=d)


def test_flag_enables_spec_decode():
    _, tm = _models(18)
    p = _prompts(11, (6,))[0]
    ref = _port(tm).generate([p], 6)[0]
    TF.set_flags({"FLAGS_spec_decode_k": 3})
    try:
        eng = _port(tm)
        assert eng._spec is not None and eng._spec.k == 3
        assert isinstance(eng._spec.drafter, TSP.PromptLookupDrafter)
        assert eng.generate([p], 6)[0] == ref
        assert _port(tm, spec_decode_k=2)._spec.k == 2  # the argument wins
    finally:
        TF.set_flags({"FLAGS_spec_decode_k": 0})
    TF.set_flags({"spec_drafter": "no_such_drafter"})
    try:
        with pytest.raises(ValueError, match="unknown drafter"):
            _port(tm, spec_decode_k=2)
    finally:
        TF.set_flags({"spec_drafter": "prompt_lookup"})


def test_prompt_lookup_proposals():
    d = TSP.PromptLookupDrafter(ngram_max=2)
    d.k = 3
    np.testing.assert_array_equal(
        d._lookup(np.asarray([5, 1, 2, 9, 1, 2], np.int32)), [9, 1, 2])
    np.testing.assert_array_equal(
        d._lookup(np.asarray([1, 2, 3], np.int32)), [3, 3, 3])
    d1 = TSP.PromptLookupDrafter(ngram_max=1)
    d1.k = 4
    np.testing.assert_array_equal(
        d1._lookup(np.asarray([7, 8, 7], np.int32)), [8, 7, 7, 7])
    with pytest.raises(ValueError, match="ngram"):
        TSP.PromptLookupDrafter(ngram_max=0)


# ---------------------------------------------------------------------------
# sampling: the emitted tokens are target draws
# ---------------------------------------------------------------------------
def test_spec_marginals_match_engine():
    """Under top_k sampling the speculative engine's second-token
    marginal matches the non-speculative engine's (total variation below
    0.35 over 200 draws each, the JAX test's bound)."""
    cfg = dict(vocab_size=16, hidden_size=16, num_layers=1, num_heads=2,
               max_seq_len=64, use_parallel_layers=False, dropout=0.0)
    _, tm = _models(3, cfg)
    p = np.asarray([3, 7, 3, 7], np.int32)
    kw = dict(max_batch_size=1, max_seq_len=32, page_size=16,
              sampler="top_k", top_k=16, temperature=1.0, seed=0)
    plain = TS.DecodeEngine(tm, device="cpu", **kw)
    spec = TS.DecodeEngine(tm, device="cpu", spec_decode_k=2, **kw)
    n = 200
    hists = []
    for eng in (plain, spec):
        toks = [eng.generate([p], 2)[0][1] for _ in range(n)]
        hists.append(np.bincount(toks, minlength=16) / n)
    tv = 0.5 * np.abs(hists[0] - hists[1]).sum()
    assert tv < 0.35, (tv, hists)
    assert spec.decode_stats()["spec_steps"] >= n


def test_sampled_spec_serving_is_seeded():
    _, tm = _models(8)
    p = _prompts(6, (6,))[0]
    outs = [_port(tm, max_batch_size=1, sampler="top_p", top_p=0.9,
                  temperature=0.8, seed=11, spec_decode_k=3).generate(
                      [p], 6)[0] for _ in range(2)]
    assert outs[0] == outs[1] and len(outs[0]) == 6
    assert all(0 <= t < 64 for t in outs[0])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("drafter", ["prompt_lookup", "self", "draft_model"])
@pytest.mark.parametrize("ragged", [False, True], ids=["split", "ragged"])
def test_cuda_spec_engine_matches_cpu(cuda_device, ragged, drafter):
    """Speculative engines on the card (verify windows and draft steps on
    K1) against the CPU's non-speculative engine, same weights (head_dim
    64): equal greedy tokens; K1 launched once a layer for every mixed
    step and verify round, and once a draft layer for every draft step;
    a self-draft accepts at least 90% of its drafts."""
    from paddle_tpu_torch.ops import paged_attention as TPA

    cfg = TGPTConfig(vocab_size=96, hidden_size=256, num_layers=2,
                     num_heads=4, max_seq_len=128)
    prompts = [p.tolist() for p in _prompts(3, (5, 40, 13, 70))]
    kw = dict(max_batch_size=2, max_seq_len=128, page_size=16)
    cpu = TS.DecodeEngine(TGPT.random(cfg, seed=3, device="cpu"),
                          device="cpu", **kw).generate(prompts, 12)
    model = TGPT.random(cfg, seed=3, device=cuda_device)
    d = None
    if drafter == "self":
        d = TSP.DraftModelDrafter(model)
    elif drafter == "draft_model":
        d = TSP.DraftModelDrafter(TGPT.random(cfg.draft_config(), seed=4,
                                              device=cuda_device))
    eng = TS.DecodeEngine(model, spec_decode_k=4, ragged_step=ragged,
                          drafter=d, **kw)
    before = TPA.paged_attention_cuda.launches
    assert eng.generate(prompts, 12) == cpu
    st = eng.decode_stats()
    draft = 0 if d is None else len(d._params["blocks"]) * d.steps
    assert TPA.paged_attention_cuda.launches - before == \
        2 * (st["mixed_steps"] + st["spec_steps"]) + draft
    if drafter == "self":
        assert st["acceptance_rate"] >= 0.9
    assert eng.pool.available_count == eng.pool.num_pages
