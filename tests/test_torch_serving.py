"""paddle_tpu_torch serving against the JAX package's `DecodeEngine`.

Weights cross over through `params_from_numpy(_extract_gpt_params(m))`:
one random JAX GPT per case, its weights handed to the port as numpy
arrays.  The port's engine runs on ``device="cpu"`` (the plain PyTorch
path) with the same page size as the JAX engine, and must produce the
same greedy tokens, the same finish reasons and the same counters in
each scenario, and drain its pool.  The isolation tests hold the port
to its rule of never importing JAX or the JAX package.
"""
import torch_test_env  # noqa: F401  (first: one intra-op thread)
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import paddle_tpu as paddle
from paddle_tpu.inference import serving as JS
from paddle_tpu.models.gpt import GPT, GPTConfig
from paddle_tpu_torch import device as TD
from paddle_tpu_torch.inference import serving as TS
from paddle_tpu_torch.inference.weights import params_from_numpy
from paddle_tpu_torch.models.gpt import GPT as TGPT
from paddle_tpu_torch.models.gpt import GPTConfig as TGPTConfig

REPO = Path(__file__).resolve().parents[1]

# the TINY config of tests/test_paged_decode.py, one with head_dim 64
# (a width K1 takes on the card) and one with an untied head
CONFIGS = {
    "tiny": dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
                 max_seq_len=128, use_parallel_layers=False, dropout=0.0),
    "head_dim_64": dict(vocab_size=96, hidden_size=128, num_layers=2,
                        num_heads=2, max_seq_len=128,
                        use_parallel_layers=False, dropout=0.0),
    "untied": dict(vocab_size=64, hidden_size=32, num_layers=2,
                   num_heads=4, max_seq_len=128, use_parallel_layers=False,
                   dropout=0.0, tie_embeddings=False),
}
STAT_KEYS = ("steps", "tokens", "mixed_steps", "prefill_chunks",
             "prefix_hits", "prefix_misses", "prefix_cached_tokens")


def _models(name, seed):
    """A random JAX GPT and the port's GPT over the same weights."""
    kw = CONFIGS[name]
    paddle.seed(seed)
    m = GPT(GPTConfig(**kw))
    m.eval()
    tree = jax.tree_util.tree_map(np.asarray, JS._extract_gpt_params(m))
    tm = TGPT.from_params(TGPTConfig(**kw),
                          params_from_numpy(tree, device="cpu"))
    return m, tm


def _serve_both(m, tm, prompts, max_new, **kw):
    """Serve ``prompts`` on both engines; returns (tokens, reasons,
    stats) of each after checking that both pools drained."""
    JS.reset_decode_stats()
    je = JS.DecodeEngine(m, **kw)
    jt, jr = je.generate(prompts, max_new, return_meta=True)
    jst = JS.decode_stats()
    te = TS.DecodeEngine(tm, device="cpu", **kw)
    tt, tr = te.generate(prompts, max_new, return_meta=True)
    tst = te.decode_stats()
    for eng in (je, te):
        assert eng.pool.available_count == eng.pool.num_pages
        assert not eng._active.any()
    te.pool.assert_consistent(live_pages=[])
    return ([[int(t) for t in o] for o in jt], jr, jst), (tt, tr, tst)


def _assert_same(j, t):
    (jt, jr, jst), (tt, tr, tst) = j, t
    assert tt == jt
    assert tr == jr
    assert {k: int(tst[k]) for k in STAT_KEYS} == \
        {k: int(jst[k]) for k in STAT_KEYS}


def _prompts(seed, lens, vocab=64):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (n,)).astype(np.int32) for n in lens]


# ---------------------------------------------------------------------------
# weight carry-over
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_params_carry_over_names_and_values(name):
    m, tm = _models(name, seed=1)
    # the JAX package's parameter names and [in, out] shapes
    assert [(n, tuple(p.shape)) for n, p in tm.named_parameters()] == \
        [(n, tuple(p.shape)) for n, p in m.named_parameters()]
    jtree = JS._extract_gpt_params(m)
    ttree = tm.params()
    assert set(ttree) == set(jtree)
    assert len(ttree["blocks"]) == len(jtree["blocks"])
    pairs = [(ttree[k], jtree[k]) for k in jtree if k != "blocks"]
    for jb, tb in zip(jtree["blocks"], ttree["blocks"]):
        assert set(jb) == set(tb)
        pairs += [(tb[k], jb[k]) for k in jb]
    for t, j in pairs:  # [in, out] layout, bit-identical values
        if j is None:
            assert t is None
            continue
        assert t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


# ---------------------------------------------------------------------------
# greedy parity with the JAX engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_continuous_batching_staggered_matches_jax(name):
    """More requests than slots, ragged prompt lengths (the scenario of
    tests/test_paged_decode.py's staggered batching test)."""
    m, tm = _models(name, seed=5)
    vocab = CONFIGS[name]["vocab_size"]
    prompts = _prompts(3, (5, 9, 13), vocab)
    j, t = _serve_both(m, tm, prompts, 6, max_batch_size=2, max_seq_len=64,
                       page_size=16)
    _assert_same(j, t)
    assert all(len(o) == 6 for o in t[0])
    assert t[1] == ["length"] * 3


@pytest.mark.parametrize("name", ["tiny", "head_dim_64"])
def test_chunk_budget_below_prompt_matches_jax(name):
    """prefill_chunk_tokens=4: every prompt streams in over several mixed
    steps, and the budget is shared fairly between prefilling slots."""
    m, tm = _models(name, seed=7)
    prompts = _prompts(8, (5, 9, 13, 21), CONFIGS[name]["vocab_size"])
    j, t = _serve_both(m, tm, prompts, 5, max_batch_size=3, max_seq_len=64,
                       page_size=16, prefill_chunk_tokens=4)
    _assert_same(j, t)
    assert t[2]["prefill_chunks"] > len(prompts)
    assert t[2]["mixed_steps"] > 0


@pytest.mark.parametrize("prefix_cache", [True, False])
def test_prefix_cache_matches_jax(prefix_cache):
    """Four prompts sharing a two-page prefix through two slots: the
    later two map the cached pages.  Tokens equal the JAX engine's (and,
    cache on or off, each other), and so do the hit counters."""
    m, tm = _models("tiny", seed=2)
    rng = np.random.RandomState(4)
    shared = rng.randint(0, 64, 32)
    prompts = [np.concatenate([shared, rng.randint(0, 64, n)]).astype(
        np.int32) for n in (3, 7, 16, 1)]
    j, t = _serve_both(m, tm, prompts, 4, max_batch_size=2, max_seq_len=64,
                       page_size=16, prefix_cache=prefix_cache)
    _assert_same(j, t)
    if prefix_cache:
        assert t[2]["prefix_hits"] > 0
        assert t[2]["prefix_cached_tokens"] >= 32
        # the same engine with the cache off gives the same tokens
        off = TS.DecodeEngine(tm, device="cpu", max_batch_size=2,
                              max_seq_len=64, page_size=16,
                              prefix_cache=False)
        assert off.generate(prompts, 4) == t[0]
    else:
        assert t[2]["prefix_hits"] == 0


@pytest.mark.parametrize("cache_generated", [True, False])
def test_cache_generated_pages_matches_jax(cache_generated):
    """A follow-up request whose prompt extends an earlier request's
    prompt with its generated tokens maps the generated page only with
    ``cache_generated_pages``; tokens and hit counts equal the JAX
    engine's either way."""
    m, tm = _models("tiny", seed=6)
    first = _prompts(12, (20,))[0]
    kw = dict(max_batch_size=1, max_seq_len=64, page_size=16,
              cache_generated_pages=cache_generated)
    JS.reset_decode_stats()
    je = JS.DecodeEngine(m, **kw)
    te = TS.DecodeEngine(tm, device="cpu", **kw)
    out = te.generate([first], 30)[0]
    assert [int(t) for t in je.generate([first], 30)[0]] == out
    follow = np.concatenate([first, np.asarray(out[:24], np.int32)])
    assert te.generate([follow], 6) == \
        [[int(t) for t in o] for o in je.generate([follow], 6)]
    hits = te.decode_stats()["prefix_hits"]
    assert hits == int(JS.decode_stats()["prefix_hits"])
    assert hits == (2 if cache_generated else 1)
    for eng in (je, te):
        assert eng.pool.available_count == eng.pool.num_pages


def test_eos_matches_jax():
    """An eos equal to one request's first greedy token finishes it
    after that token; the others run to length."""
    m, tm = _models("tiny", seed=9)
    prompts = _prompts(10, (6, 11, 4))
    first = TS.DecodeEngine(tm, device="cpu", max_batch_size=1,
                            max_seq_len=64, page_size=16).generate(
        prompts[:1], 1)[0][0]
    j, t = _serve_both(m, tm, prompts, 8, max_batch_size=2, max_seq_len=64,
                       page_size=16, eos_token_id=int(first))
    _assert_same(j, t)
    assert t[1][0] == "eos" and t[0][0] == [first]


def test_nonfinite_logits_finish_only_as_fault():
    """A NaN embedding row poisons the request that uses it: the guard
    samples the sentinel, the slot finishes as "fault" with no token
    and no cached page, and the pool drains — as in the JAX engine."""
    m, tm = _models("tiny", seed=3)
    poison = 17
    with torch.no_grad():
        tm.wte.weight[poison] = float("nan")
    wte = np.asarray(m.wte.weight.numpy()).copy()
    wte[poison] = np.nan
    m.wte.weight.set_value(wte)
    prompt = np.array([1, 2, poison, 4, 5], np.int32)
    j, t = _serve_both(m, tm, [prompt], 4, max_batch_size=1,
                       max_seq_len=64, page_size=16)
    assert t[1] == j[1] == ["fault"]
    assert t[0] == j[0] == [[]]


def test_sampled_serving_is_seeded():
    """top_k sampling draws from the engine's torch.Generator: one seed
    gives one stream; tokens stay inside the vocab."""
    _, tm = _models("tiny", seed=4)
    prompts = _prompts(5, (5, 9))

    def run(seed):
        return TS.DecodeEngine(tm, device="cpu", max_batch_size=2,
                               max_seq_len=64, page_size=16,
                               sampler="top_k", top_k=8,
                               seed=seed).generate(prompts, 6)

    a = run(0)
    assert a == run(0)
    assert all(0 <= tok < 64 for o in a for tok in o)


# ---------------------------------------------------------------------------
# what the slice refuses
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [dict(kv_quant="int8"),
                                dict(serve_weights="int8"),
                                dict(ragged_step=True),
                                dict(spec_decode_k=2),
                                dict(serve_mesh="mp=2"),
                                dict(chunked_prefill=False)])
def test_unported_options_raise(kw):
    """kv_quant and serve_weights are ported: the engine takes "int8" and
    serves, and raises ValueError on any other mode, as the JAX engine
    does.  ragged_step, spec_decode_k, chunked_prefill=False (the legacy
    one-shot prefill) and serve_mesh (tensor-parallel serving) are
    ported: the engine takes each and serves the same greedy tokens as
    without it."""
    _, tm = _models("tiny", seed=0)
    name = next(iter(kw))
    if name in ("kv_quant", "serve_weights"):
        eng = TS.DecodeEngine(tm, device="cpu", max_batch_size=1,
                              max_seq_len=64, page_size=16, **kw)
        assert len(eng.generate(_prompts(1, (6,)), 3)[0]) == 3
        assert eng.pool.available_count == eng.pool.num_pages
        with pytest.raises(ValueError, match=name):
            TS.DecodeEngine(tm, device="cpu", max_batch_size=1,
                            max_seq_len=64, page_size=16,
                            **{name: "int4"})
        return
    if name in ("ragged_step", "spec_decode_k", "chunked_prefill",
                "serve_mesh"):
        prompts = _prompts(1, (6, 11))
        ref = TS.DecodeEngine(tm, device="cpu", max_batch_size=1,
                              max_seq_len=64, page_size=16).generate(
            prompts, 5)
        TS.reset_decode_stats()
        eng = TS.DecodeEngine(tm, device="cpu", max_batch_size=1,
                              max_seq_len=64, page_size=16, **kw)
        assert eng.generate(prompts, 5) == ref
        assert eng.pool.available_count == eng.pool.num_pages
        if name == "chunked_prefill":
            # two one-shot prefills through one bucket's graph (16), no
            # mixed step
            st = TS.decode_stats()
            assert (st["prefills"], st["prefill_compiles"],
                    st["mixed_steps"]) == (2, 1, 0)
            return
        st = eng.decode_stats()
        key = "spec_steps" if name == "spec_decode_k" else "ragged_steps"
        assert st[key] > 0
        if name == "serve_mesh":
            # rank 0 holds half the heads of every page
            assert eng._mesh_mp == 2 and eng._k_pages.shape[1] * 2 == \
                tm.cfg.num_heads
        return


def test_engine_argument_checks():
    _, tm = _models("tiny", seed=0)
    with pytest.raises(ValueError, match="position table"):
        TS.DecodeEngine(tm, device="cpu", max_seq_len=256)
    eng = TS.DecodeEngine(tm, device="cpu", max_batch_size=1,
                          max_seq_len=32, page_size=16)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.add_request([])
    with pytest.raises(ValueError, match="exceeds max_seq_len"):
        eng.add_request(list(range(30)), max_new_tokens=8)


# ---------------------------------------------------------------------------
# isolation: the port never imports JAX, and never runs silently on CPU
# ---------------------------------------------------------------------------
_IMPORT_ALL = """
import importlib, pkgutil, sys
import paddle_tpu_torch
for mod in pkgutil.walk_packages(paddle_tpu_torch.__path__,
                                 "paddle_tpu_torch."):
    importlib.import_module(mod.name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu", "PIL"))
# the serving modules this guard must see: the ragged step's, the
# speculative decoder's, the serving stack around the engine, the
# telemetry plane, the serving mesh, the port's telemetry tools, the
# sanitizer, the fleet, the eager core and training, the data-
# parallel training, profiler and auto-checkpoint modules, and the
# hybrid-parallel ones, the functional tensor API with nn's
# activations, losses and norms, the rest of nn with BERT,
# vision (whose image decoders import PIL only when they run: the card's
# machine has none), and quantization, sparsity, distribution, the
# metrics, the text datasets and the op long tail, and the static
# graph, its exporter, jit and the inference API
missing = [m for m in ("paddle_tpu_torch.inference.serving",
                       "paddle_tpu_torch.inference.speculative",
                       "paddle_tpu_torch.inference.frontend",
                       "paddle_tpu_torch.inference.resilience",
                       "paddle_tpu_torch.inference.durability",
                       "paddle_tpu_torch.observability",
                       "paddle_tpu_torch.observability.metrics",
                       "paddle_tpu_torch.observability.tracing",
                       "paddle_tpu_torch.observability.reporter",
                       "paddle_tpu_torch.observability.flight",
                       "paddle_tpu_torch.observability.costmodel",
                       "paddle_tpu_torch.observability.profiling",
                       "paddle_tpu_torch.observability.alerts",
                       "paddle_tpu_torch.observability.opsserver",
                       "paddle_tpu_torch.parallel",
                       "paddle_tpu_torch.parallel.partition",
                       "paddle_tpu_torch.parallel.mesh",
                       "paddle_tpu_torch.tools.explain_request",
                       "paddle_tpu_torch.tools.telemetry_dump",
                       "paddle_tpu_torch.analysis",
                       "paddle_tpu_torch.analysis.sanitizer",
                       "paddle_tpu_torch.observability.fleettrace",
                       "paddle_tpu_torch.fleet",
                       "paddle_tpu_torch.fleet.edge",
                       "paddle_tpu_torch.fleet.router",
                       "paddle_tpu_torch.core.framework",
                       "paddle_tpu_torch.core.dtype",
                       "paddle_tpu_torch.core.place",
                       "paddle_tpu_torch.core.tensor",
                       "paddle_tpu_torch.core.dispatch",
                       "paddle_tpu_torch.autograd",
                       "paddle_tpu_torch.nn.initializer",
                       "paddle_tpu_torch.nn.layer.layers",
                       "paddle_tpu_torch.nn.layer.transformer",
                       "paddle_tpu_torch.framework.param_attr",
                       "paddle_tpu_torch.framework.io",
                       "paddle_tpu_torch.regularizer",
                       "paddle_tpu_torch.utils.clip",
                       "paddle_tpu_torch.optimizer.lr",
                       "paddle_tpu_torch.io",
                       "paddle_tpu_torch.metric",
                       "paddle_tpu_torch.hapi.model",
                       "paddle_tpu_torch.hapi.callbacks",
                       "paddle_tpu_torch.hapi.summary",
                       "paddle_tpu_torch.profiler",
                       "paddle_tpu_torch.incubate.checkpoint.auto_checkpoint",
                       "paddle_tpu_torch.distributed",
                       "paddle_tpu_torch.distributed.parallel",
                       "paddle_tpu_torch.distributed.collective",
                       "paddle_tpu_torch.distributed.spawn",
                       "paddle_tpu_torch.distributed.launch",
                       "paddle_tpu_torch.distributed.topology",
                       "paddle_tpu_torch.distributed.fleet",
                       "paddle_tpu_torch.distributed.fleet.base",
                       "paddle_tpu_torch.distributed.fleet.strategy",
                       "paddle_tpu_torch.distributed.fleet.data_parallel",
                       "paddle_tpu_torch.distributed.fleet.sharded_step",
                       "paddle_tpu_torch.distributed.fleet."
                       "meta_optimizers",
                       "paddle_tpu_torch.distributed.fleet.utils.recompute",
                       "paddle_tpu_torch.distributed.fleet.utils."
                       "hybrid_parallel_util",
                       "paddle_tpu_torch.distributed.fleet.zero",
                       "paddle_tpu_torch.distributed.fleet.pipeline_step",
                       "paddle_tpu_torch.distributed.fleet.meta_parallel."
                       "mp_layers",
                       "paddle_tpu_torch.distributed.fleet.meta_parallel."
                       "pipeline_parallel",
                       "paddle_tpu_torch.distributed.fleet.meta_parallel."
                       "moe_layer",
                       "paddle_tpu_torch.distributed.fleet.elastic",
                       "paddle_tpu_torch.distributed.fleet.dataset",
                       "paddle_tpu_torch.distributed.ps",
                       "paddle_tpu_torch.distributed.ps._native",
                       "paddle_tpu_torch.io.worker",
                       "paddle_tpu_torch.parallel.pipeline",
                       "paddle_tpu_torch.parallel.ring_attention",
                       "paddle_tpu_torch.models.gpt_spmd",
                       "paddle_tpu_torch.linalg",
                       "paddle_tpu_torch.ops._util",
                       "paddle_tpu_torch.ops.creation",
                       "paddle_tpu_torch.ops.math",
                       "paddle_tpu_torch.ops.manipulation",
                       "paddle_tpu_torch.ops.logic",
                       "paddle_tpu_torch.ops.search",
                       "paddle_tpu_torch.ops.stat",
                       "paddle_tpu_torch.ops.random",
                       "paddle_tpu_torch.ops.linalg",
                       "paddle_tpu_torch.nn.functional.activation",
                       "paddle_tpu_torch.nn.functional.loss",
                       "paddle_tpu_torch.nn.functional.norm",
                       "paddle_tpu_torch.nn.layer.activation",
                       "paddle_tpu_torch.nn.layer.loss",
                       "paddle_tpu_torch.nn.layer.norm",
                       "paddle_tpu_torch.nn.layer.layers",
                       "paddle_tpu_torch.nn.layer.container",
                       "paddle_tpu_torch.nn.layer.common",
                       "paddle_tpu_torch.nn.layer.conv",
                       "paddle_tpu_torch.nn.layer.pooling",
                       "paddle_tpu_torch.nn.layer.rnn",
                       "paddle_tpu_torch.nn.layer.transformer",
                       "paddle_tpu_torch.nn.functional.common",
                       "paddle_tpu_torch.nn.functional.conv",
                       "paddle_tpu_torch.nn.functional.pooling",
                       "paddle_tpu_torch.nn.functional.sampling",
                       "paddle_tpu_torch.nn.utils",
                       "paddle_tpu_torch.nn.decode",
                       "paddle_tpu_torch.ops.misc",
                       "paddle_tpu_torch.models.bert",
                       "paddle_tpu_torch.vision",
                       "paddle_tpu_torch.vision.transforms",
                       "paddle_tpu_torch.vision.datasets",
                       "paddle_tpu_torch.vision.ops",
                       "paddle_tpu_torch.vision.detection",
                       "paddle_tpu_torch.vision.models.lenet",
                       "paddle_tpu_torch.vision.models.resnet",
                       "paddle_tpu_torch.vision.models.vgg",
                       "paddle_tpu_torch.vision.models.mobilenet",
                       "paddle_tpu_torch.vision.models.vit",
                       "paddle_tpu_torch.vision.models.yolov3",
                       "paddle_tpu_torch.quantization",
                       "paddle_tpu_torch.quantization.int8",
                       "paddle_tpu_torch.sparsity",
                       "paddle_tpu_torch.distribution",
                       "paddle_tpu_torch.text",
                       "paddle_tpu_torch.text.datasets",
                       "paddle_tpu_torch.ops.sequence",
                       "paddle_tpu_torch.ops.crf",
                       "paddle_tpu_torch.ops.control_flow",
                       "paddle_tpu_torch.ops.industrial",
                       "paddle_tpu_torch.static",
                       "paddle_tpu_torch.static.input_spec",
                       "paddle_tpu_torch.static.proto",
                       "paddle_tpu_torch.static.op_version",
                       "paddle_tpu_torch.static.program",
                       "paddle_tpu_torch.static.interp",
                       "paddle_tpu_torch.static.op_bridge",
                       "paddle_tpu_torch.static.nn",
                       "paddle_tpu_torch.static.fx_export",
                       "paddle_tpu_torch.static.export_marker",
                       "paddle_tpu_torch.ops.capture",
                       "paddle_tpu_torch.jit",
                       "paddle_tpu_torch.inference")
           if m not in sys.modules]
print(len(sys.modules), bad, missing)
sys.exit(1 if bad or missing else 0)
"""


def test_import_loads_neither_jax_nor_paddle_tpu():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


_TENSOR_GUARD = """
import torch
before = dict(vars(torch.Tensor))
names = set(dir(torch.Tensor))
import paddle_tpu_torch
after = vars(torch.Tensor)
changed = sorted(k for k, v in before.items() if after.get(k) is not v)
added = sorted(set(dir(torch.Tensor)) - names)
from paddle_tpu_torch.ops import _TENSOR_METHODS
x = torch.arange(6.).reshape(2, 3)
assert x.gather_nd(torch.tensor([[1, 2]])).tolist() == [5.0]
assert [t.tolist() for t in x.unstack()] == [[0., 1., 2.], [3., 4., 5.]]
print(changed, added)
raise SystemExit(1 if changed or not set(added) <= set(_TENSOR_METHODS)
                 else 0)
"""


def test_import_replaces_no_tensor_attribute():
    """After ``import paddle_tpu_torch`` every attribute ``torch.Tensor``
    had is the same object (no torch method or operator is replaced); the
    only new names are the Paddle methods torch lacks
    (``ops._TENSOR_METHODS``)."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", _TENSOR_GUARD], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO))
    for p in [*(REPO / "paddle_tpu_torch").rglob("*.py"),
              REPO / "chip_smoke.py"]))
def test_source_imports_no_jax(path):
    for name in _imports(REPO / path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "paddle_tpu"), (path, name)


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tm = _models("tiny", seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.DecodeEngine(tm, max_batch_size=1, max_seq_len=64, page_size=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        TD.default_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        TD.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({"wte": np.zeros(2), "blocks": []})
    with pytest.raises(RuntimeError, match="CUDA"):
        TGPT.random(TGPTConfig(**CONFIGS["tiny"]))
