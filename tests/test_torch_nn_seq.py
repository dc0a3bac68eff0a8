"""paddle_tpu_torch's sequence layers against the JAX package's: the RNN
cells and layers, MultiHeadAttention with each cache kind, the
Transformer encoder and decoder layers and stacks, beam search
(`BeamSearchDecoder`, `dynamic_decode`, `gather_tree`) and BERT.

The same weights (the JAX layer's ``state_dict()`` as numpy, loaded by
``set_state_dict``) and inputs (a numpy seed) through both packages, the
port on the CPU.  JAX forwards and their parameter gradients run under
one ``jax.jit`` a case (`test_torch_nn_layers.jax_layer_run`: JAX's eager
RNN loop would compile every step's ops).  Tolerances: f32 outputs and
gradients rtol 1e-5, atol 1e-5; beam-search tokens and parents equal,
scores rtol 1e-5; BERT's loss rtol 1e-5 and gradients rtol 1e-4, atol
1e-5 (two encoder layers and the tied decoder sum each gradient over
more terms).  Two behaviours of the JAX package that the port keeps are
stated here: `SimpleRNN`/`LSTM`/`GRU` ignore ``initial_states`` and
`RNN`/`BiRNN` ignore ``sequence_length``.
"""
import torch_test_env  # noqa: F401  (first: one intra-op thread)
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu_torch as T
from paddle_tpu_torch.core import place as TPL

import torch_op_tables as tab
from test_torch_nn_functional import f, floats, m
from test_torch_nn_layers import jax_layer_run, port_layer_grads
from test_torch_tensor_api import _tensors, assert_close, rng, to_np

R = "reduce"


@pytest.fixture(autouse=True)
def on_cpu():
    prev = TPL._EXPECTED_DEVICE[0]
    T.set_device("cpu")
    yield
    TPL._EXPECTED_DEVICE[0] = prev


def _load(jl, build_t, seed=3):
    """The port's layer (``build_t(T.nn)``) over ``jl``'s weights, each
    perturbed from its init by N(0, 0.1) first."""
    r = rng(seed)
    for p in jl.parameters():
        p.set_value((np.asarray(p.numpy()) + 0.1 * r.standard_normal(
            p.shape)).astype(np.float32))
    tl = build_t(T.nn)
    missing, unexpected = tl.set_state_dict(
        {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()})
    assert missing == [] and unexpected == [], (missing, unexpected)
    return tl


class S:
    """A layer ``build(nn)`` of either package over the inputs of
    ``make``; outputs and parameter gradients compared."""

    def __init__(self, name, build, make, call=None):
        self.name, self.build, self.make = name, build, make
        self.call = call

    def __repr__(self):
        return self.name


def states(*shapes):
    """Inputs plus initial states, all normal."""
    return floats(*shapes)


LAYERS = [
    S("SimpleRNNCell", lambda nn: nn.SimpleRNNCell(4, 5),
      states((3, 4), (3, 5))),
    S("SimpleRNNCell_relu", lambda nn: nn.SimpleRNNCell(4, 5, "relu"),
      states((3, 4), (3, 5))),
    S("LSTMCell", lambda nn: nn.LSTMCell(4, 5),
      lambda r: [r.standard_normal(s).astype(np.float32)
                 for s in ((3, 4), (3, 5), (3, 5))],
      call=lambda cell, x, h, c: cell(x, (h, c))),
    S("GRUCell", lambda nn: nn.GRUCell(4, 5), states((3, 4), (3, 5))),
    S("RNN", lambda nn: nn.RNN(nn.LSTMCell(4, 5), is_reverse=True),
      floats((2, 3, 4))),
    S("BiRNN", lambda nn: nn.BiRNN(nn.GRUCell(4, 5), nn.GRUCell(4, 5),
                                   time_major=True), floats((3, 2, 4))),
    S("SimpleRNN", lambda nn: nn.SimpleRNN(4, 5, num_layers=2),
      floats((2, 3, 4))),
    S("LSTM", lambda nn: nn.LSTM(4, 5, 2, direction="bidirect"),
      floats((2, 3, 4))),
    S("GRU", lambda nn: nn.GRU(4, 5, time_major=True), floats((3, 2, 4))),
    S("MultiHeadAttention", lambda nn: nn.MultiHeadAttention(8, 2),
      floats((2, 3, 8))),
    S("MultiHeadAttention_cross_masked",
      lambda nn: nn.MultiHeadAttention(8, 2, kdim=6, vdim=5),
      lambda r: [r.standard_normal(s).astype(np.float32)
                 for s in ((2, 3, 8), (2, 4, 6), (2, 4, 5))]
      + [np.where(r.random((2, 1, 3, 4)) < 0.3, -1e9, 0.0).astype(
          np.float32)]),
    S("TransformerEncoderLayer",
      lambda nn: nn.TransformerEncoderLayer(8, 2, 16, dropout=0.0),
      floats((2, 5, 8))),
    S("TransformerEncoderLayer_prenorm_gelu",
      lambda nn: nn.TransformerEncoderLayer(8, 2, 16, dropout=0.0,
                                            activation="gelu",
                                            normalize_before=True),
      floats((2, 5, 8))),
    S("TransformerEncoder",
      lambda nn: nn.TransformerEncoder(nn.TransformerEncoderLayer(
          8, 2, 16, dropout=0.0, normalize_before=True), 2,
          nn.LayerNorm(8)), floats((2, 5, 8))),
    S("TransformerDecoderLayer",
      lambda nn: nn.TransformerDecoderLayer(8, 2, 16, dropout=0.0),
      floats((2, 4, 8), (2, 5, 8))),
    S("TransformerDecoder",
      lambda nn: nn.TransformerDecoder(nn.TransformerDecoderLayer(
          8, 2, 16, dropout=0.0, normalize_before=True), 2),
      floats((2, 4, 8), (2, 5, 8))),
    S("Transformer",
      lambda nn: nn.Transformer(8, 2, 1, 2, 16, dropout=0.0),
      lambda r: [r.standard_normal(s).astype(np.float32)
                 for s in ((2, 5, 8), (2, 4, 8))]
      + [np.zeros((2, 1, 5, 5), np.float32),
         np.triu(np.full((4, 4), -1e9, np.float32), 1)]),
]


@pytest.mark.parametrize("case", LAYERS, ids=repr)
def test_layer_matches_jax_with_gradients(case):
    arrays = case.make(rng())
    jl = case.build(P.nn)
    tl = _load(jl, case.build)
    jl.eval()
    tl.eval()
    want, jgrads = jax_layer_run(jl, arrays, True, case.call)
    ins = _tensors(T, arrays)
    got = tab.flat(case.call(tl, *ins) if case.call else tl(*ins))
    assert_close(got, want, R, case.name)
    tgrads = port_layer_grads(tl, got)
    assert set(tgrads) == set(jgrads)
    for k, g in tgrads.items():
        assert_close(g, jgrads[k], R, f"{case.name}.grad.{k}")


def test_rnn_ignores_initial_states_and_sequence_length():
    """Both packages: `LSTM` runs every layer from zeros whatever
    ``initial_states`` says, and `RNN` runs every step of every sequence
    whatever ``sequence_length`` says (JAX ``_RNNBase.forward`` and
    ``RNN.forward`` take both and read neither)."""
    r = rng(2)
    x = r.standard_normal((2, 4, 3)).astype(np.float32)
    h0 = r.standard_normal((1, 2, 5)).astype(np.float32)
    for pkg in (P, T):
        t = (lambda a: pkg.to_tensor(a)) if pkg is P else torch.from_numpy
        lstm = pkg.nn.LSTM(3, 5)
        plain = to_np(lstm(t(x))[0])
        given = to_np(lstm(t(x), (t(h0), t(h0)))[0])
        np.testing.assert_array_equal(given, plain)
        rnn = pkg.nn.RNN(pkg.nn.GRUCell(3, 5))
        lens = t(np.array([1, 4]))
        np.testing.assert_array_equal(
            to_np(rnn(t(x), sequence_length=lens)[0]), to_np(rnn(t(x))[0]))


# ---------------------------------------------------------------------------
# MultiHeadAttention's caches and the layers' incremental decoding
# ---------------------------------------------------------------------------
def _pair(build):
    jl = build(P.nn)
    tl = _load(jl, build)
    return jl.eval(), tl.eval()


def _jt(a):
    return P.to_tensor(a)


def _tt(a):
    return torch.from_numpy(a)


@pytest.mark.parametrize("kind", ["Cache", "PreallocCache", "StaticCache"])
def test_attention_caches_step_like_jax(kind):
    """Three steps of 1, 2 and 1 new rows through each cache kind (the
    prealloc one with an additive causal mask over its horizon of 6): each
    step's output and the cache's K/V equal JAX's."""
    jl, tl = _pair(lambda nn: nn.MultiHeadAttention(8, 2))
    r = rng(4)
    mem = r.standard_normal((2, 5, 8)).astype(np.float32)
    steps = [r.standard_normal((2, s, 8)).astype(np.float32)
             for s in (1, 2, 1)]
    if kind == "StaticCache":
        jc = jl.gen_cache(_jt(mem), type=P.nn.MultiHeadAttention.StaticCache)
        tc = tl.gen_cache(_tt(mem), type=T.nn.MultiHeadAttention.StaticCache)
    elif kind == "PreallocCache":
        jc = jl.gen_cache(_jt(mem), max_length=6)
        tc = tl.gen_cache(_tt(mem), max_length=6)
    else:
        jc, tc = jl.gen_cache(_jt(mem)), tl.gen_cache(_tt(mem))
    pos = 0
    for x in steps:
        mask = None
        if kind == "PreallocCache":
            s = x.shape[1]
            keep = np.arange(6)[None, :] <= pos + np.arange(s)[:, None]
            mask = np.where(keep, 0.0, -1e9).astype(np.float32)[None, None]
        jm, tm = (None, None) if mask is None else (_jt(mask), _tt(mask))
        if kind == "StaticCache":
            jo, to = jl(_jt(x), None, None, jm, jc), tl(_tt(x), None, None,
                                                       tm, tc)
        else:
            (jo, jc), (to, tc) = jl(_jt(x), None, None, jm, jc), \
                tl(_tt(x), None, None, tm, tc)
        assert_close(to, jo, R, f"{kind} step at {pos}")
        assert_close(tc.k, jc.k, R)
        assert_close(tc.v, jc.v, R)
        pos += x.shape[1]
    if kind == "PreallocCache":
        assert tc.length == int(jc.length.numpy()) == 4


def test_decoder_incremental_cache_matches_full_pass():
    """A 2-layer decoder stepped token by token through its caches (a
    concat cache and the static memory a layer) equals JAX's stepped
    decoder, and both equal the full causal pass."""
    build = (lambda nn: nn.TransformerDecoder(nn.TransformerDecoderLayer(
        8, 2, 16, dropout=0.0), 2))
    jl, tl = _pair(build)
    r = rng(5)
    mem = r.standard_normal((2, 5, 8)).astype(np.float32)
    tgt = r.standard_normal((2, 4, 8)).astype(np.float32)
    full = to_np(tl(_tt(tgt), _tt(mem), _tt(np.triu(np.full(
        (4, 4), -1e9, np.float32), 1))))
    jc, tc = jl.gen_cache(_jt(mem)), tl.gen_cache(_tt(mem))
    for i in range(4):
        jo, jc = jl(_jt(tgt[:, i:i + 1]), _jt(mem), None, None, jc)
        to, tc = tl(_tt(tgt[:, i:i + 1]), _tt(mem), None, None, tc)
        assert_close(to, jo, R, f"step {i}")
        assert_close(to, full[:, i:i + 1], R, f"step {i} against full")
    zipped = tl.gen_cache(_tt(mem), do_zip=True)
    assert len(zipped) == 2 and len(zipped[0]) == 2


def test_square_subsequent_mask():
    got = T.nn.Transformer(8, 2, 1, 1, 16).generate_square_subsequent_mask(4)
    want = P.nn.Transformer(8, 2, 1, 1, 16).generate_square_subsequent_mask(4)
    np.testing.assert_array_equal(to_np(got), to_np(want))


# ---------------------------------------------------------------------------
# beam search
# ---------------------------------------------------------------------------
V, EMB, W, START, END = 11, 6, 3, 1, 2


def _gru_decoder(pkg, emb, cell, out):
    return pkg.nn.BeamSearchDecoder(cell, START, END, W, embedding_fn=emb,
                                    output_fn=out)


def _beam_parts(pkg, state):
    nn = pkg.nn
    return nn.Embedding(V, EMB), nn.GRUCell(EMB, 8), nn.Linear(8, V)


def _copy_params(jmods, tmods, seed=6):
    r = rng(seed)
    for jm, tm in zip(jmods, tmods):
        for p in jm.parameters():
            p.set_value((np.asarray(p.numpy()) * 3 + 0.3 * r.standard_normal(
                p.shape)).astype(np.float32))
        tm.set_state_dict({k: np.asarray(v.numpy())
                           for k, v in jm.state_dict().items()})


def test_beam_search_gru_matches_jax():
    """Beam 3 over a GRU cell, 7 steps: sequences (tokens backtraced
    through the parents by `gather_tree`) equal, final scores rtol 1e-5;
    the raw step tokens and parents equal too."""
    jm, tm = _beam_parts(P, None), _beam_parts(T, None)
    _copy_params(jm, tm)
    h0 = rng(7).standard_normal((2, 8)).astype(np.float32)
    jd, td = _gru_decoder(P, *jm), _gru_decoder(T, *tm)
    jseq, jscore = P.nn.dynamic_decode(jd, _jt(h0), max_step_num=7)
    tseq, tscore = T.nn.dynamic_decode(td, _tt(h0), max_step_num=7)
    np.testing.assert_array_equal(to_np(tseq), to_np(jseq))
    assert_close(tscore, jscore, R)
    jt, js = jd.initialize(_jt(h0), 2)[0], jd.initialize(_jt(h0), 2)[3]
    tt, ts = td.initialize(_tt(h0), 2)[0], td.initialize(_tt(h0), 2)[3]
    jlp, tlp = jd.initialize(_jt(h0), 2)[1], td.initialize(_tt(h0), 2)[1]
    jf = tf = None
    for step in range(3):
        jf = jd.initialize(_jt(h0), 2)[2] if jf is None else jf
        tf = td.initialize(_tt(h0), 2)[2] if tf is None else tf
        jt, jlp, jf, js, jpar = jd.step(jt, jlp, jf, js, 2)
        tt, tlp, tf, ts, tpar = td.step(tt, tlp, tf, ts, 2)
        np.testing.assert_array_equal(to_np(tt), to_np(jt))
        np.testing.assert_array_equal(to_np(tpar), to_np(jpar))
        assert_close(tlp, jlp, R, f"step {step}")
    ids = rng(8).integers(0, V, (4, 2, W))
    par = rng(9).integers(0, W, (4, 2, W))
    np.testing.assert_array_equal(
        to_np(T.gather_tree(_tt(ids), _tt(par))),
        to_np(P.ops.gather_tree(_jt(ids.astype(np.int32)),
                                _jt(par.astype(np.int32)))))


@pytest.mark.parametrize("cache", ["concat", "prealloc"])
def test_beam_search_transformer_decoder_caches(cache):
    """Beam 3 through a 2-layer TransformerDecoder's incremental caches
    (tiled over the beams and reordered by parent; a prealloc cache's
    length is shared by the beams, neither tiled nor reordered): the
    sequences equal JAX's, scores rtol 1e-5."""
    build = (lambda nn: nn.TransformerDecoder(nn.TransformerDecoderLayer(
        8, 2, 16, dropout=0.0), 2))
    jdec, tdec = _pair(build)
    jm = [P.nn.Embedding(V, 8), P.nn.Linear(8, V)]
    tm = [T.nn.Embedding(V, 8), T.nn.Linear(8, V)]
    _copy_params(jm, tm)
    mem = rng(10).standard_normal((2, 5, 8)).astype(np.float32)
    out = {}
    for pkg, dec, (emb, head), mk in ((P, jdec, jm, _jt),
                                      (T, tdec, tm, _tt)):
        mha = pkg.nn.MultiHeadAttention
        caches = [(ly.self_attn.gen_cache(mk(mem), max_length=8)
                   if cache == "prealloc" else
                   ly.self_attn.gen_cache(mk(mem)),
                   ly.cross_attn.gen_cache(mk(mem), mk(mem),
                                           type=mha.StaticCache))
                  for ly in dec.layers]

        def cell(inp, st, dec=dec, emb=emb):
            x = emb(inp).unsqueeze(1)
            o, new = dec(x, None, None, None, st)
            return o[:, 0], new

        d = pkg.nn.BeamSearchDecoder(cell, START, END, W, output_fn=head)
        out[pkg.__name__] = pkg.nn.dynamic_decode(d, caches, max_step_num=6,
                                                  batch_size=2)
    (jseq, jsc), (tseq, tsc) = out["paddle_tpu"], out["paddle_tpu_torch"]
    np.testing.assert_array_equal(to_np(tseq), to_np(jseq))
    assert_close(tsc, jsc, R)


# ---------------------------------------------------------------------------
# BERT
# ---------------------------------------------------------------------------
def tiny_cfg(pkg):
    from importlib import import_module
    mod = import_module(f"{pkg.__name__}.models.bert")
    return mod, mod.BertConfig(vocab_size=128, hidden_size=32, num_layers=2,
                               num_heads=4, intermediate_size=64,
                               max_position_embeddings=64,
                               hidden_dropout=0.0, attention_dropout=0.0)


def bert_batch(seed=0, b=2, s=16, p=4, vocab=128):
    r = np.random.default_rng(seed)
    ids = r.integers(3, vocab, (b, s))
    ids[1, -3:] = 0  # padding: the mask path
    return [ids, (r.random((b, s)) > 0.5).astype(np.int64),
            r.integers(0, s, (b, p)), r.integers(3, vocab, (b, p)),
            r.integers(0, 2, (b,)), np.ones((b, p), np.float32)]


@pytest.fixture(scope="module")
def berts():
    """The JAX BertForPretraining (seed 0) and the port's over its state
    through its ``set_state_dict`` (the same names, nothing left out)."""
    JB, jcfg = tiny_cfg(P)
    TB, tcfg = tiny_cfg(T)
    P.seed(0)
    jm = JB.BertForPretraining(jcfg)
    tm = TB.BertForPretraining(tcfg, device="cpu")
    missing, unexpected = tm.set_state_dict(
        {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    assert missing == [] and unexpected == []
    return JB, jm, TB, tm


def _jax_loss_and_grads(JB, jm, batch):
    named = list(jm.named_parameters())

    def run(ps, *arrs):
        old = [p._array for _, p in named]
        try:
            for (_, p), a in zip(named, ps):
                p._array = a
            loss = JB.bert_pretrain_loss_fn(jm, *[P.Tensor(a)
                                                  for a in arrs])
            gs = P.grad([loss], [p for _, p in named])
            return loss._array, [g._array for g in gs]
        finally:
            for (_, p), a in zip(named, old):
                p._array = a

    arrs = [a.astype(np.int32) if a.dtype.kind == "i" else a for a in batch]
    loss, grads = jax.jit(run)([p._array for _, p in named], *arrs)
    return float(loss), {n: np.asarray(g) for (n, _), g in zip(named,
                                                                 grads)}


def test_bert_pretraining_loss_and_gradients_match_jax(berts):
    JB, jm, TB, tm = berts
    batch = bert_batch()
    want_loss, want_grads = _jax_loss_and_grads(JB, jm, batch)
    loss = TB.bert_pretrain_loss_fn(tm, *[torch.from_numpy(a)
                                          for a in batch])
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-5)
    grads = {n: p.grad for n, p in tm.named_parameters()}
    assert set(grads) == set(want_grads)
    for n, g in grads.items():
        np.testing.assert_allclose(to_np(g), want_grads[n], rtol=1e-4,
                                   atol=1e-5, err_msg=n)
    tm.zero_grad()


def test_bert_train_steps_and_ernie_match_jax(berts):
    """Two `jit.TrainStep` AdamW steps of each package from the same
    weights: equal losses (rtol 1e-5); the tied decoder weight is the
    embedding's in both; ErnieModel's trunk equals JAX's."""
    import copy
    JB, jm, TB, tm = berts
    jm, tm = copy.deepcopy(jm), copy.deepcopy(tm)
    assert tm.heads.decoder_weight is \
        tm.bert.embeddings.word_embeddings.weight
    jstep = P.jit.TrainStep(jm, JB.bert_pretrain_loss_fn, P.optimizer.AdamW(
        1e-3, parameters=jm.parameters()))
    tstep = T.jit.TrainStep(tm, TB.bert_pretrain_loss_fn, T.optimizer.AdamW(
        1e-3, parameters=tm.parameters()))
    for s in range(2):
        batch = bert_batch(seed=s + 1)
        jl = jstep(*[P.to_tensor(a.astype(np.int32) if a.dtype.kind == "i"
                                 else a) for a in batch])
        tl = tstep(*[torch.from_numpy(a) for a in batch])
        np.testing.assert_allclose(float(tl), float(np.asarray(
            jl.numpy() if hasattr(jl, "numpy") else jl)), rtol=1e-5)
    P.seed(1)
    je = JB.ErnieModel(vocab_size=64, hidden_size=16, num_layers=1,
                       num_heads=2, intermediate_size=32,
                       max_position_embeddings=16, hidden_dropout=0.0,
                       attention_dropout=0.0)
    te = TB.ErnieModel(vocab_size=64, hidden_size=16, num_layers=1,
                       num_heads=2, intermediate_size=32,
                       max_position_embeddings=16, hidden_dropout=0.0,
                       attention_dropout=0.0, device="cpu")
    te.set_state_dict({k: np.asarray(v.numpy())
                       for k, v in je.state_dict().items()})
    ids = bert_batch(seed=4, s=8, vocab=64)[0]
    jseq, jpool = je.eval()(P.to_tensor(ids.astype(np.int32)))
    tseq, tpool = te.eval()(torch.from_numpy(ids))
    assert_close([tseq, tpool], [jseq, jpool], R)
