"""Shared fixtures of the telemetry-plane tests (test_torch_flight,
test_torch_costmodel, test_torch_profiling, test_torch_opsplane,
test_torch_observability): one random JAX GPT per case with the port's
GPT over the same weights, seeded numpy prompts, and both packages'
telemetry state reset between cases."""
import itertools

import jax
import numpy as np

import paddle_tpu as paddle
from paddle_tpu import observability as JO
from paddle_tpu.inference import serving as JS
from paddle_tpu.models.gpt import GPT, GPTConfig
from paddle_tpu_torch import observability as TO
from paddle_tpu_torch.inference import serving as TS
from paddle_tpu_torch.inference.weights import params_from_numpy
from paddle_tpu_torch.models.gpt import GPT as TGPT
from paddle_tpu_torch.models.gpt import GPTConfig as TGPTConfig

# the TINY config of tests/test_flight.py and tests/test_opsplane.py, and
# the head_dim-64 one of tests/test_torch_serving.py
TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            max_seq_len=128, use_parallel_layers=False, dropout=0.0)
HD64 = dict(vocab_size=96, hidden_size=128, num_layers=2, num_heads=2,
            max_seq_len=128, use_parallel_layers=False, dropout=0.0)

# the serving modes the flight records are compared in
MODES = {
    "chunked": dict(),
    "legacy": dict(chunked_prefill=False),
    "ragged": dict(ragged_step=True),
    "spec": dict(spec_decode_k=2),
    "int8": dict(kv_quant="int8", serve_weights="int8"),
}


def models(seed=0, cfg=TINY):
    """A random JAX GPT and the port's GPT over the same weights."""
    paddle.seed(seed)
    m = GPT(GPTConfig(**cfg))
    m.eval()
    tree = jax.tree_util.tree_map(np.asarray, JS._extract_gpt_params(m))
    tm = TGPT.from_params(TGPTConfig(**cfg),
                          params_from_numpy(tree, device="cpu"))
    return m, tm


def prompts(seed=0, lens=(5, 17, 30), vocab=64):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(0, vocab, n)] for n in lens]


def reset_both():
    """Fresh telemetry in both packages, and request ids from 0 (the
    flight records carry them)."""
    for o in (JO, TO):
        o.reset()
        o.clear_spans()
    JS.reset_decode_stats()
    TS.reset_decode_stats()
    JS.Request._next_id = itertools.count()
    TS.Request._next_id = itertools.count()


def engines(m, tm, **kw):
    """A JAX engine and a port engine (on the CPU) of one config."""
    return JS.DecodeEngine(m, **kw), TS.DecodeEngine(tm, device="cpu", **kw)


# the flight-record fields that do not depend on the clock
DETERMINISTIC = ("kind", "slots", "queued", "emitted", "finished", "events")


def deterministic(rec: dict) -> dict:
    out = {k: rec.get(k) for k in DETERMINISTIC}
    out["phases"] = sorted(rec.get("phases", {}))
    pool = dict(rec.get("pool", {}))
    out["pool"] = pool
    out["cost_fn"] = rec.get("cost", {}).get("fn")
    return out
