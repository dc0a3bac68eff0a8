"""The quantization gate (tools/bench_kv_quant.py and tools/bench_wquant.py,
`_teacher_forced_match`) on the port, on the CPU.

A random GPT (the JAX package's init from ``paddle.seed``, which makes
decisive logits; the port's over the same weights) greedily generates
`EVAL_TOKENS` tokens for each of `EVAL_REQUESTS` prompts through the f32
engine: the references.  Then, at every reference position, the int8
engine (int8 KV pages, kernel K2's plain version on the CPU; or int8
matmul weights) is asked for one token conditioned on the reference
prefix (teacher forcing), and the share that equals the reference is
its match rate.  Each package runs the gate against its own f32
references; the port's rate must reach the JAX package's on the same
weights (at most one token fewer in the whole evaluation), and the tools'
99% bar wherever the JAX package's rate meets it.  Both rates are in
the assertion message.
"""
import numpy as np
import pytest

from paddle_tpu.inference import serving as JS
from paddle_tpu_torch.inference import serving as TS

from torch_telemetry_common import models

CFG = dict(vocab_size=96, hidden_size=64, num_layers=2, num_heads=2,
           max_seq_len=128, use_parallel_layers=False, dropout=0.0)
EVAL_REQUESTS = 3
EVAL_TOKENS = 12
PROMPT = 16
BAR = 0.99


def _engine(pkg, model, **kw):
    extra = {} if pkg is JS else {"device": "cpu"}
    return pkg.DecodeEngine(model, max_batch_size=2, max_seq_len=128,
                            page_size=16, **kw, **extra)


def _prompts():
    rng = np.random.RandomState(42)
    return [rng.randint(0, CFG["vocab_size"], (PROMPT,)).astype(np.int32)
            for _ in range(EVAL_REQUESTS)]


def _match_rate(pkg, model, prompts, **quant):
    refs = _engine(pkg, model).generate(prompts,
                                        max_new_tokens=EVAL_TOKENS)
    eng = _engine(pkg, model, **quant)
    match = total = 0
    for p, ref in zip(prompts, refs):
        ctx = list(p)
        for want in ref:
            got = eng.generate([np.asarray(ctx, np.int32)],
                               max_new_tokens=1)[0][0]
            total += 1
            match += int(got) == int(want)
            ctx.append(int(want))
    return match, total


@pytest.mark.parametrize("quant", [dict(kv_quant="int8"),
                                   dict(serve_weights="int8")],
                         ids=["kv_int8", "weights_int8"])
def test_teacher_forced_match_reaches_jax(quant):
    m, tm = models(seed=3, cfg=CFG)
    prompts = _prompts()
    jm, jt = _match_rate(JS, m, prompts, **quant)
    pm, pt = _match_rate(TS, tm, prompts, **quant)
    rates = f"port {pm}/{pt} = {pm / pt:.4f}, JAX {jm}/{jt} = {jm / jt:.4f}"
    assert pt == jt == EVAL_REQUESTS * EVAL_TOKENS
    assert pm >= jm - 1, rates
    if jm / jt >= BAR:
        assert pm / pt >= BAR, rates
    print(rates)
