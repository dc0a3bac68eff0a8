"""paddle_tpu_torch's legacy one-shot prefill (``chunked_prefill=False``:
`_gpt_prefill`, one graph a power-of-two prompt bucket) against the JAX
package's, on the CPU.

Greedy tokens, finish reasons and the prefill counters (``prefills``,
``stalled_decode_steps``, ``prefill_compiles``, ``draft_compiles``) must
equal the JAX legacy engine's, in f32 and with int8 KV pages, with and
without a draft model; the chunked engine's tokens must equal the legacy
engine's across chunk sizes (the scenarios of
tests/test_chunked_prefill.py), and a prompt whose logits go non-finite
finishes as "fault" with nothing emitted, as in JAX.  The tolerance is
token equality throughout.
"""
import torch_test_env  # noqa: F401  (first: one intra-op thread)
import numpy as np
import pytest

import jax

import paddle_tpu as paddle
from paddle_tpu.inference import serving as JS
from paddle_tpu.inference import speculative as JSP
from paddle_tpu.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.inference import serving as TS
from paddle_tpu_torch.inference import speculative as TSP
from paddle_tpu_torch.inference.weights import params_from_numpy
from paddle_tpu_torch.models.gpt import GPT as TGPT
from paddle_tpu_torch.models.gpt import GPTConfig as TGPTConfig

# tests/test_chunked_prefill.py's TINY
TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            max_seq_len=128, use_parallel_layers=False, dropout=0.0)
KEYS = ("steps", "tokens", "prefills", "stalled_decode_steps",
        "prefill_compiles", "draft_compiles", "decode_compiles",
        "mixed_compiles", "verify_compiles", "kv_quant_compiles",
        "retraces_after_warmup", "finished_eos", "finished_length",
        "finished_fault", "mixed_steps", "spec_steps", "spec_accepted")


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


def _both(m, tm, prompts, max_new, jd=None, td=None, **kw):
    """Serve on both engines from zeroed counters; returns the tokens,
    finish reasons and counters of each, after checking the pools
    drained."""
    JS.reset_decode_stats()
    je = JS.DecodeEngine(m, cost_model=False, **_kw(drafter=jd, **kw))
    jt, jr = je.generate(prompts, max_new, return_meta=True)
    jst = JS.decode_stats()
    TS.reset_decode_stats()
    te = TS.DecodeEngine(tm, device="cpu", **_kw(drafter=td, **kw))
    tt, tr = te.generate(prompts, max_new, return_meta=True)
    tst = TS.decode_stats()
    for eng in (je, te):
        assert eng.pool.available_count == eng.pool.num_pages
        assert eng.pool.reserved == 0 and not eng._active.any()
    te.pool.assert_consistent(live_pages=[])
    return ([[int(t) for t in o] for o in jt], jr, jst), (tt, tr, tst)


def _same(j, t, skip=()):
    (jt, jr, jst), (tt, tr, tst) = j, t
    assert tt == jt
    assert tr == jr
    keys = [k for k in KEYS if k not in skip]
    assert {k: int(tst[k]) for k in keys} == {k: int(jst[k]) for k in keys}


@pytest.mark.parametrize("draft", [False, True], ids=["plain", "draft"])
@pytest.mark.parametrize("kv", ["off", "int8"])
def test_legacy_greedy_matches_jax(kv, draft):
    """Five prompts through two slots, some admitted while the other slot
    decodes (stalled steps), lengths across three buckets (16, 32, 64):
    tokens, reasons and the counters equal the JAX legacy engine's; with
    a draft model its one-shot prefill runs a bucket graph of its own
    (``draft_compiles``) and the speculative counters agree too."""
    m, tm = _models(5)
    prompts = _prompts(3, (5, 9, 20, 33, 13))
    kw = dict(chunked_prefill=False, kv_quant=kv)
    jd = td = None
    if draft:
        dm, tdm = _models(17, _draft_cfg())
        jd, td = JSP.DraftModelDrafter(dm), TSP.DraftModelDrafter(tdm)
        kw["spec_decode_k"] = 3
    j, t = _both(m, tm, prompts, 10, jd, td, **kw)
    # JAX's engine-side scale reset retraces once beside an int8 draft
    # model (its scales arrive first as the fresh zeros array, later as
    # an executable's output); the port's graphs key on the host inputs
    # alone and meet one signature
    quirk = ("retraces_after_warmup",) if draft and kv == "int8" else ()
    _same(j, t, skip=quirk)
    if quirk:
        assert j[2]["kv_quant_retraces"] == j[2]["retraces_after_warmup"]
    st = t[2]
    assert st["retraces_after_warmup"] == 0
    assert st["prefills"] == len(prompts) and st["mixed_steps"] == 0
    assert st["stalled_decode_steps"] > 0
    assert st["prefill_compiles"] == 3  # buckets 16, 32 and 64
    if draft:
        assert st["draft_compiles"] == 2 + 3  # catch-up, step, 3 buckets
    if kv == "int8":
        assert st["kv_quant_pages"] > 0


def test_legacy_path_counts_stalls():
    """tests/test_chunked_prefill.py's scenario: a second request
    admitted while slot 0 decodes prefills between steps, one stall."""
    m, tm = _models(11)
    rng = np.random.RandomState(9)
    a = rng.randint(0, 64, (4,)).astype(np.int32)
    b = rng.randint(0, 64, (9,)).astype(np.int32)
    stalls, outs = [], []
    for mod, eng in ((JS, JS.DecodeEngine(m, **_kw(chunked_prefill=False))),
                     (TS, TS.DecodeEngine(tm, device="cpu",
                                          **_kw(chunked_prefill=False)))):
        mod.reset_decode_stats()
        ra = eng.add_request(a, max_new_tokens=8)
        eng.step()
        rb = eng.add_request(b, max_new_tokens=4)
        eng.run()
        stalls.append(int(mod.decode_stats()["stalled_decode_steps"]))
        outs.append([[int(t) for t in r.output_ids] for r in (ra, rb)])
    assert stalls == [1, 1]
    assert outs[0] == outs[1]


@pytest.mark.parametrize("chunk", [16, 64, 24, 10])
def test_matches_legacy_across_chunk_sizes(chunk):
    """tests/test_chunked_prefill.py's parity: the chunked engine, at
    page-aligned, whole-prompt and page-straddling chunk sizes, gives
    the legacy engine's tokens, and so does the JAX legacy engine."""
    m, tm = _models(5)
    prompts = _prompts(3, (5, 16, 37))
    legacy = TS.DecodeEngine(tm, device="cpu",
                             **_kw(chunked_prefill=False)).generate(
        prompts, 8)
    chunked = TS.DecodeEngine(tm, device="cpu",
                              **_kw(prefill_chunk_tokens=chunk)).generate(
        prompts, 8)
    assert chunked == legacy
    jax_legacy = JS.DecodeEngine(m, **_kw(chunked_prefill=False)).generate(
        prompts, 8)
    assert legacy == [[int(t) for t in o] for o in jax_legacy]


@pytest.mark.parametrize("ragged", [False, True], ids=["split", "ragged"])
def test_nan_prompt_is_quarantined_like_jax(ragged):
    """A prompt holding a token whose embedding is NaN (an untied head,
    so no other row's logits read it): its one-shot prefill samples the
    NaN sentinel, and the request finishes as "fault" with nothing
    emitted, its slot and pages released while the others serve on (a
    request that reuses its pages may meet the NaN rows it left); the
    JAX legacy engine does all of it the same way."""
    m, tm = _models(3, dict(TINY, tie_embeddings=False))
    prompts = _prompts(6, (6, 12, 9))
    prompts[1][4] = 7
    for p in (prompts[0], prompts[2]):
        p[p == 7] = 8
    kw = _kw(chunked_prefill=False, ragged_step=ragged)
    JS.reset_decode_stats()
    je = JS.DecodeEngine(m, **kw)
    je._params = dict(je._params, wte=je._params["wte"].at[7].set(np.nan))
    jt, jr = je.generate(prompts, 5, return_meta=True)
    TS.reset_decode_stats()
    te = TS.DecodeEngine(tm, device="cpu", **kw)
    te._params["wte"][7] = float("nan")
    tt, tr = te.generate(prompts, 5, return_meta=True)
    assert tr == jr and tr[0] == "length" and tr[1] == "fault"
    assert tt == [[int(t) for t in o] for o in jt] and tt[1] == []
    keys = ("finished_fault", "finished_length", "prefills", "tokens")
    assert {k: int(TS.decode_stats()[k]) for k in keys} == \
        {k: int(JS.decode_stats()[k]) for k in keys}
    assert te.pool.available_count == te.pool.num_pages


def test_legacy_refuses_the_prefix_cache():
    """As in JAX: the one-shot prefill cannot start mid-prompt, so an
    explicit prefix cache raises and the flag's default resolves off."""
    _, tm = _models(0)
    with pytest.raises(ValueError, match="prefix_cache needs chunked"):
        TS.DecodeEngine(tm, device="cpu",
                        **_kw(chunked_prefill=False, prefix_cache=True))
    eng = TS.DecodeEngine(tm, device="cpu", **_kw(chunked_prefill=False))
    assert not eng._prefix_cache
    assert eng._prefill_bucket(5) == 16 and eng._prefill_bucket(17) == 32
    assert eng._prefill_bucket(60) == 64  # capped at the horizon
