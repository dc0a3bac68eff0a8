"""paddle_tpu_torch's cached GPT against the JAX package's.

`GPT.forward` with the concat and the prealloc KV caches, `gen_caches`,
the KV-cache helpers and `GPT.generate`, on the TINY config of
tests/test_paged_decode.py (vocab 64, hidden 32, 2 layers, 4 heads),
from one weight tree (the JAX package's init, drawn by the port) set
into both packages.  Both
sides run on the CPU: the port's attention takes its composed form (a
mask, or a query shorter than the keys) or the flash kernels' plain
version (the concat prefill), the JAX package's its XLA reference.
Greedy tokens must be equal; logits hold within 1e-5 (f32 sums in
another order).
"""
import torch_test_env  # noqa: F401  (first: one intra-op thread)
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPT, GPTConfig
from paddle_tpu.nn import initializer as JI
from paddle_tpu.nn.layer import transformer as JT
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.inference import serving as TS
from paddle_tpu_torch.models.gpt import GPT as TGPT
from paddle_tpu_torch.models.gpt import GPTConfig as TGPTConfig
from paddle_tpu_torch.nn.layer import transformer as TT

TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            max_seq_len=128, use_parallel_layers=False, dropout=0.0)
LOGIT_TOL = 1e-5


def _zeros(self, shape, dtype):
    return jnp.zeros(shape, dtype)


def _models(seed, **over):
    """The port's GPT with the JAX package's init drawn from ``seed``
    (`GPT(cfg)`: embeddings N(0, 1), which make the greedy choice sharp)
    and a JAX GPT over its weights, both in eval mode.  The JAX GPT is
    built with its initializers drawing zeros: its own draws (a compile
    a shape) would be overwritten."""
    kw = dict(TINY, **over)
    tpaddle.seed(seed)
    tm = TGPT(TGPTConfig(**kw), device="cpu").eval()
    with mock.patch.object(JI.Normal, "_init", _zeros), \
            mock.patch.object(JI.XavierUniform, "_init", _zeros), \
            mock.patch.object(JI.Constant, "_init", _zeros):
        m = GPT(GPTConfig(**kw))
    m.eval()
    named = dict(tm.named_parameters())
    for name, p in m.named_parameters():
        p.set_value(named[name].detach().numpy())
    return m, tm


def _ids(seed, b, s, vocab=64):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("mode", ["concat", "prealloc"])
def test_cached_forward_logits_match_jax(mode):
    """A 7-token prompt, then two steps of 1 and 3 tokens through each
    cache; every step's logits within `LOGIT_TOL` of JAX's, and the
    cached steps' within it of the cacheless forward of the whole
    sequence (the same positions)."""
    m, tm = _models(seed=11)
    ids = _ids(0, 2, 11)
    jc = m.gen_caches(2, mode, max_length=16)
    tc = tm.gen_caches(2, mode, max_length=16)
    full = tm(torch.from_numpy(ids)).detach().numpy()
    pos = 0
    for n in (7, 1, 3):
        chunk = ids[:, pos:pos + n]
        jl, jc = m(paddle.to_tensor(chunk), caches=jc, pos_start=pos)
        with torch.no_grad():
            tl, tc = tm(torch.from_numpy(chunk), caches=tc, pos_start=pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl._array),
                                   atol=LOGIT_TOL)
        np.testing.assert_allclose(tl.numpy(), full[:, pos:pos + n],
                                   atol=LOGIT_TOL)
        pos += n
    if mode == "prealloc":
        assert all(c.length == 11 for c in tc)
        assert tc[0].k.shape == (2, 4, 16, 8)
        np.testing.assert_allclose(tc[1].v[:, :, :11].numpy(),
                                   np.asarray(jc[1].v._array)[:, :, :11],
                                   atol=LOGIT_TOL)
        assert float(tc[1].v[:, :, 11:].abs().sum()) == 0.0
    else:
        assert tc[0][1].shape == (2, 4, 11, 8)


@pytest.mark.parametrize("mode", ["concat", "prealloc"])
def test_generate_greedy_tokens_match_jax_and_engine(mode):
    """Greedy tokens of two prompts of 9 and 11 tokens, 8 new each (close
    lengths: JAX's concat decode compiles once a length): the port's
    ``generate`` equals JAX's ``generate`` and the port's `DecodeEngine`
    (the serving path), request by request."""
    m, tm = _models(seed=12)
    prompts = [_ids(s, 1, n)[0].tolist() for s, n in ((1, 9), (3, 11))]
    eng = TS.DecodeEngine(tm, device="cpu", max_batch_size=2,
                          max_seq_len=64, page_size=16, cost_model=False,
                          flight_window=0)
    served = eng.generate(prompts, 8)
    for p, want in zip(prompts, served):
        ids = np.asarray([p], np.int32)
        jt = np.asarray(m.generate(paddle.to_tensor(ids), max_new_tokens=8,
                                   use_cache=mode)._array)
        tt = tm.generate(torch.from_numpy(ids), max_new_tokens=8,
                         use_cache=mode)
        assert tt.dtype == torch.int32 and tt.shape == (1, 8)
        assert tt[0].tolist() == jt[0].tolist() == list(want)


def test_generate_batch_eos_and_sampling():
    """A batch of two 6-token prompts with an eos: rows that emitted it
    keep emitting it and decoding stops when both have, as in JAX (the
    eos is the token JAX's greedy row 0 emits third).  Sampling draws
    from a generator seeded with ``seed``: equal seeds give equal tokens
    in the port (the streams differ from jax.random's)."""
    m, tm = _models(seed=13)
    ids = _ids(4, 2, 6)
    first = np.asarray(m.generate(paddle.to_tensor(ids), max_new_tokens=8)
                       ._array)
    eos = int(first[0, 2])
    jt = np.asarray(m.generate(paddle.to_tensor(ids), max_new_tokens=8,
                               eos_token_id=eos)._array)
    tt = tm.generate(torch.from_numpy(ids), max_new_tokens=8,
                     eos_token_id=eos)
    assert tt.tolist() == jt.tolist()
    kw = dict(max_new_tokens=6, sampler="top_k", top_k=8, temperature=0.8)
    a = tm.generate(torch.from_numpy(ids), seed=5, **kw)
    b = tm.generate(torch.from_numpy(ids), seed=5, **kw)
    assert torch.equal(a, b)
    assert int(a.min()) >= 0 and int(a.max()) < 64


@pytest.mark.parametrize("case", ["zero_new", "past_horizon", "bad_cache",
                                  "train_dropout", "bad_gen_mode",
                                  "overflow"])
def test_generate_value_errors_are_jax_s(case):
    """The JAX package's ValueErrors, with its messages' key words."""
    m, tm = _models(seed=14, dropout=0.1 if case == "train_dropout" else 0.0)
    ids = _ids(5, 1, 4)
    jid, tid = paddle.to_tensor(ids), torch.from_numpy(ids)
    calls = {
        "zero_new": (lambda g, x: g.generate(x, max_new_tokens=0),
                     "max_new_tokens"),
        "past_horizon": (lambda g, x: g.generate(x, max_new_tokens=125),
                         "max_seq_len"),
        "bad_cache": (lambda g, x: g.generate(x, use_cache="paged"),
                      "use_cache"),
        "train_dropout": (lambda g, x: (g.train(), g.generate(x)),
                          "eval"),
        "bad_gen_mode": (lambda g, x: g.gen_caches(1, "ring"),
                         "cache mode"),
        "overflow": (lambda g, x: g(x, caches=g.gen_caches(
            1, "prealloc", max_length=3)), "overflow"),
    }
    fn, words = calls[case]
    for g, x in ((m, jid), (tm, tid)):
        with pytest.raises(ValueError, match=words):
            fn(g, x)


def test_kv_helpers_match_jax():
    """`kv_cache_write` and both forms of `kv_valid_mask` against JAX's
    on the same buffer (exact), and the capacity check."""
    rng = np.random.RandomState(6)
    buf = rng.randn(2, 3, 8, 4).astype(np.float32)
    new = rng.randn(2, 3, 3, 4).astype(np.float32)
    jw = JT.kv_cache_write(paddle.to_tensor(buf), paddle.to_tensor(new),
                           paddle.to_tensor(np.int32(2)))
    tw = TT.kv_cache_write(torch.from_numpy(buf.copy()),
                           torch.from_numpy(new), 2)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw._array))
    for causal in (True, False):
        jm = JT.kv_valid_mask(paddle.to_tensor(np.int32(2)), 3, 8,
                              causal=causal)
        tm_ = TT.kv_valid_mask(2, 3, 8, causal=causal)
        assert tm_.shape == (1, 1, 3, 8)
        np.testing.assert_array_equal(tm_.numpy(), np.asarray(jm._array))
    with pytest.raises(ValueError, match="overflow"):
        TT.kv_cache_write(torch.zeros(1, 1, 4, 2), torch.zeros(1, 1, 3, 2),
                          2)
    # under autograd the write leaves the buffer it was given as it was
    b = torch.zeros(1, 1, 4, 2)
    n = torch.ones(1, 1, 1, 2, requires_grad=True)
    out = TT.kv_cache_write(b, n, 1)
    assert float(b.abs().sum()) == 0.0 and out.requires_grad


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernel K3 has no CPU "
                    "mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_generate_both_caches_and_k3(cuda_device):
    """A head_dim-64 GPT on the card: greedy ``generate`` with the concat
    and the prealloc cache gives the card engine's tokens; a concat call
    launches K3 num_layers times (its prompt), a prealloc call never
    (masked, the composed form)."""
    from paddle_tpu_torch.ops import flash_attention as fa

    cfg = TGPTConfig(vocab_size=96, hidden_size=128, num_layers=2,
                     num_heads=2, max_seq_len=128)
    tm = TGPT.random(cfg, seed=5, device=cuda_device).eval()
    prompts = [list(range(3, 20)), list(range(40, 45))]
    want = TS.DecodeEngine(tm, max_batch_size=2, max_seq_len=64,
                           page_size=16).generate(prompts, 8)
    for mode, k3 in (("concat", cfg.num_layers), ("prealloc", 0)):
        for p, w in zip(prompts, want):
            n0 = fa.flash_attention_cuda_fwd.launches
            got = tm.generate(torch.tensor([p], device=cuda_device),
                              max_new_tokens=8, use_cache=mode)
            assert fa.flash_attention_cuda_fwd.launches - n0 == k3
            assert got[0].tolist() == list(w)
