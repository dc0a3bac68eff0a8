"""paddle_tpu_torch's op long tail against the JAX package's: the CRF,
the sequence family, control flow, the industrial and the misc ops.

Every public name of ``paddle_tpu/ops/{crf,sequence,control_flow,
industrial,misc}.py`` is a case of one table (`test_every_public_name_
has_a_case`): the same inputs, made from a numpy seed, go through
``paddle_tpu`` and ``paddle_tpu_torch`` (the port on the CPU) at tiny
shapes, each JAX case traced under one ``jax.jit`` (eagerly where it
reads values on the host; `test_torch_tensor_api.jax_ref`).  Integer
outputs (Viterbi paths, hash ids, indices, lengths, counts, masks) are
equal; float outputs within rtol 1e-5, atol 1e-5 (the ``reduce``
family); gradients, where the JAX package differentiates, at the same
tolerance.  The Viterbi case runs on emissions with ties (quantized to
0.5), where the lowest tag index must win.  The samplers (`tdm_sampler`,
`sample_logits`'s own draw, `sampling_id`, `shuffle_batch`,
`pyramid_hash`'s dropout) draw from each package's own generator: their
cases hold what a draw must satisfy, and the deterministic parts equal.
"""
import torch_test_env  # noqa: F401  (first: one intra-op thread)
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu_torch as T
from paddle_tpu_torch.core import place as TPL

import torch_op_tables as tab
from test_torch_tensor_api import (_float_out, _public, _tensors,
                                   assert_close, cotangents, jax_ref,
                                   port_grads, rng)

R = "reduce"


@pytest.fixture(autouse=True)
def on_cpu():
    prev = TPL._EXPECTED_DEVICE[0]
    T.set_device("cpu")
    yield
    TPL._EXPECTED_DEVICE[0] = prev


class C:
    """``call(pkg, *tensors)`` on ``make(rng)``'s arrays."""

    def __init__(self, label, make, call, grad=False):
        self.label, self.make, self.call, self.grad = label, make, call, grad
        self.name = label.split("[")[0]

    def __repr__(self):
        return self.label


def f32(a):
    return np.asarray(a, np.float32)


def i32(a):
    return np.asarray(a, np.int32)


def nrm(r, *shape):
    return f32(r.standard_normal(shape))


LENS = i32([5, 2, 3])           # a full row, a short one, a middle one
LENS0 = i32([5, 0, 3])          # with an empty row


def cf(pkg):
    return pkg.ops.control_flow


# ---------------------------------------------------------------------------
# sequence
# ---------------------------------------------------------------------------
SEQUENCE = [
    C("sequence_mask", lambda r: [LENS],
      lambda p, l: p.sequence_mask(l)),
    C("sequence_mask[maxlen]", lambda r: [LENS],
      lambda p, l: p.sequence_mask(l, maxlen=7, dtype="float32")),
    C("sequence_pad", lambda r: [nrm(r, 10, 4), LENS],
      lambda p, x, l: p.sequence_pad(x, l, pad_value=-1.0), grad=True),
    C("sequence_unpad", lambda r: [nrm(r, 3, 5, 4), LENS],
      lambda p, x, l: p.sequence_unpad(x, l), grad=True),
    *[C(f"sequence_pool[{t}]", lambda r: [nrm(r, 3, 5, 4), LENS0],
        lambda p, x, l, t=t: p.sequence_pool(x, l, t), grad=True)
      for t in ("sum", "average", "sqrt", "max", "last", "first")],
    C("sequence_first_step", lambda r: [nrm(r, 3, 5, 4), LENS],
      lambda p, x, l: p.sequence_first_step(x, l), grad=True),
    C("sequence_last_step", lambda r: [nrm(r, 3, 5, 4), LENS],
      lambda p, x, l: p.sequence_last_step(x, l), grad=True),
    C("sequence_reverse", lambda r: [nrm(r, 3, 5, 4), LENS],
      lambda p, x, l: p.sequence_reverse(x, l), grad=True),
    C("sequence_softmax", lambda r: [nrm(r, 3, 5), LENS0],
      lambda p, x, l: p.sequence_softmax(x, l), grad=True),
    C("sequence_expand", lambda r: [nrm(r, 3, 4)],
      lambda p, x: p.sequence_expand(x, [2, 0, 3]), grad=True),
    C("sequence_concat", lambda r: [nrm(r, 3, 5, 2), LENS, nrm(r, 3, 4, 2),
                                    i32([1, 4, 0])],
      lambda p, a, la, b, lb: p.sequence_concat([a, b], [la, lb]),
      grad=True),
    C("sequence_expand_as", lambda r: [nrm(r, 3, 4), LENS],
      lambda p, x, l: p.sequence_expand_as(x, l), grad=True),
    C("sequence_enumerate", lambda r: [i32(r.integers(1, 9, (3, 5))), LENS],
      lambda p, x, l: p.sequence_enumerate(x, l, win_size=3, pad_value=-2)),
    C("sequence_erase", lambda r: [i32(r.integers(0, 5, (3, 6))),
                                   i32([6, 3, 4])],
      lambda p, x, l: p.sequence_erase(x, l, tokens=[1, 3])),
    C("sequence_reshape", lambda r: [nrm(r, 3, 4, 6), i32([4, 1, 2])],
      lambda p, x, l: p.sequence_reshape(x, l, new_dim=3), grad=True),
    C("sequence_scatter", lambda r: [nrm(r, 3, 6), i32([[1, 1], [4, 0],
                                                        [2, 5]]),
                                     nrm(r, 3, 2), i32([2, 1, 0])],
      lambda p, x, i, u, l: p.sequence_scatter(x, i, u, l), grad=True),
    C("sequence_slice", lambda r: [nrm(r, 3, 5, 2), LENS, i32([1, 0, 2]),
                                   i32([3, 2, 1])],
      lambda p, x, l, o, n: p.sequence_slice(x, l, o, n), grad=True),
    C("sequence_topk_avg_pooling",
      lambda r: [nrm(r, 2, 2, 3, 5), i32([3, 2]), i32([5, 2])],
      lambda p, x, rl, cl: p.sequence_topk_avg_pooling(x, rl, cl, [1, 3]),
      grad=True),
    C("sequence_conv", lambda r: [nrm(r, 3, 5, 4), LENS, nrm(r, 12, 6),
                                  nrm(r, 6)],
      lambda p, x, l, w, b: p.sequence_conv(x, l, w, b, context_length=3),
      grad=True),
    C("sequence_conv[padding_data]",
      lambda r: [nrm(r, 3, 5, 4), LENS, nrm(r, 16, 6), nrm(r, 3, 4)],
      lambda p, x, l, w, pad: p.sequence_conv(
          x, l, w, context_length=4, context_start=-2, padding_data=pad),
      grad=True),
]


# ---------------------------------------------------------------------------
# CRF
# ---------------------------------------------------------------------------
def _crf_inputs(r, tied=False):
    em = nrm(r, 3, 6, 4)
    trans = nrm(r, 6, 4)
    if tied:  # many equal path scores: the lowest tag must win
        em, trans = f32(np.round(em * 2) / 2), f32(np.round(trans * 2) / 2)
    return [em, trans, i32(r.integers(0, 4, (3, 6))), i32([6, 1, 4])]


CRF = [
    C("linear_chain_crf", _crf_inputs,
      lambda p, e, t, y, l: p.linear_chain_crf(e, t, y, l), grad=True),
    C("crf_decoding", lambda r: _crf_inputs(r, tied=True),
      lambda p, e, t, y, l: p.crf_decoding(e, t, length=l)),
    C("crf_decoding[label]", lambda r: _crf_inputs(r, tied=True),
      lambda p, e, t, y, l: p.crf_decoding(e, t, label=y, length=l)),
    C("crf_decoding[no_length]", lambda r: _crf_inputs(r, tied=True),
      lambda p, e, t, y, l: p.crf_decoding(e, t)),
]


# ---------------------------------------------------------------------------
# control flow (the port is eager; the JAX side traces under jit)
# ---------------------------------------------------------------------------
CONTROL = [
    *[C(f"cond[{s}]", lambda r, s=s: [f32(s * np.abs(nrm(r, 4)))],
        lambda p, x: cf(p).cond(x.sum() > 0, lambda: x * 2.0,
                                lambda: x - 1.0), grad=True)
      for s in (1, -1)],
    C("while_loop", lambda r: [i32(0), nrm(r, 3)],
      lambda p, i, x: cf(p).while_loop(lambda i, s: i < 4,
                                       lambda i, s: [i + 1, s * 1.5],
                                       [i, x]), grad=True),
    *[C(f"case[{v}]", lambda r, v=v: [f32(v), nrm(r, 3)],
        lambda p, v, x: cf(p).case(
            [(v < 0, lambda: x * 3.0), (v < 1, lambda: x + 1.0)],
            default=lambda: x * 0.5), grad=True)
      for v in (-1.0, 0.5, 2.0)],
    C("case[no_default]", lambda r: [f32(5.0), nrm(r, 3)],
      lambda p, v, x: cf(p).case(
          [(v < 0, lambda: x * 3.0), (v < 1, lambda: x + 1.0)]), grad=True),
    *[C(f"switch_case[{i}]", lambda r, i=i: [i32(i), nrm(r, 3)],
        lambda p, i, x: cf(p).switch_case(
            i, [lambda: x * 2.0, lambda: x - 3.0],
            default=lambda: x * 0.0), grad=True)
      for i in (0, 1, 5)],
    C("switch_case[dict]", lambda r: [i32(7), nrm(r, 3)],
      lambda p, i, x: cf(p).switch_case(
          i, {3: lambda: x * 2.0, 7: lambda: x + 4.0}), grad=True),
]


# ---------------------------------------------------------------------------
# industrial
# ---------------------------------------------------------------------------
def _tree_info():
    """A 2-ary tree of 7 nodes (ids 1-7; 0 the padding node): 1 -> 2, 3;
    2 -> 4, 5; 3 -> 6, 7; items are the leaves 4-7."""
    info = np.zeros((8, 5), np.int32)
    for node, kids in ((1, (2, 3)), (2, (4, 5)), (3, (6, 7))):
        info[node, 3:5] = kids
    for leaf in (4, 5, 6, 7):
        info[leaf, 0] = leaf + 100
    info[:, 1] = [0, 0, 1, 1, 2, 2, 2, 2]
    return info


def _rank_offset(r, n, k):
    ro = np.zeros((n, 1 + 2 * k), np.int32)
    ro[:, 0] = r.integers(0, k + 1, n)           # 0: no rank (padding)
    for j in range(k):
        ro[:, 1 + 2 * j] = r.integers(0, k + 1, n)
        ro[:, 2 + 2 * j] = r.integers(0, n, n)
    return ro


def _edges():
    e = np.zeros((2, 5, 2), np.int32)
    e[0, :4] = [[1, 2], [1, 3], [2, 4], [3, 5]]
    e[1, :3] = [[1, 2], [2, 3], [2, 4]]
    return e


def _instags(r):
    tags = r.integers(0, 6, (6, 3)).astype(np.int32)
    tags[1] = -1
    tags[4, 1:] = -1
    return tags


def _cust_samples():
    return [i32([1, 7, 3, 9]), f32([0.2, 0.05, 0.1, 0.02])]


INDUSTRIAL = [
    C("tdm_child", lambda r: [i32([[1], [2], [6], [0]]), _tree_info()],
      lambda p, x, info: p.tdm_child(x, info, child_nums=2)),
    C("tdm_child[flat]", lambda r: [i32([3, 4, 1]), _tree_info()],
      lambda p, x, info: p.tdm_child(x, info, child_nums=2)),
    C("rank_attention", lambda r: [nrm(r, 5, 3), _rank_offset(r, 5, 3),
                                   nrm(r, 27, 4)],
      lambda p, x, ro, par: p.rank_attention(x, ro, par, max_rank=3),
      grad=True),
    C("match_matrix_tensor", lambda r: [nrm(r, 2, 3, 4), nrm(r, 2, 5, 4),
                                        nrm(r, 4, 2, 4), i32([3, 1]),
                                        i32([2, 5])],
      lambda p, x, y, w, xl, yl: p.match_matrix_tensor(x, y, w, xl, yl,
                                                       dim_t=2),
      grad=True),
    C("match_matrix_tensor[no_lens]",
      lambda r: [nrm(r, 2, 3, 4), nrm(r, 2, 5, 4), nrm(r, 4, 1, 4)],
      lambda p, x, y, w: p.match_matrix_tensor(x, y, w), grad=True),
    *[C(f"var_conv_2d[stride{s}]",
        lambda r: [nrm(r, 2, 2, 6, 7), nrm(r, 3, 2 * 3 * 2), i32([6, 3]),
                   i32([4, 7])],
        lambda p, x, w, rl, cl, s=s: p.var_conv_2d(x, w, rl, cl, 2, 3, 3, 2,
                                                   s, s),
        grad=True) for s in (1, 2)],
    C("filter_by_instag", lambda r: [nrm(r, 6, 3), _instags(r), i32([2, 5])],
      lambda p, x, tags, ft: p.filter_by_instag(x, tags, ft,
                                                out_val_if_empty=-7),
      grad=True),
    C("tree_conv", lambda r: [nrm(r, 2, 5, 3), _edges(),
                              nrm(r, 3, 3, 2, 4)],
      lambda p, n, e, f: p.tree_conv(n, e, f, max_depth=3), grad=True),
    C("pyramid_hash", lambda r: [i32(r.integers(0, 3000, (2, 6))),
                                 nrm(r, 54), i32([6, 3])],
      lambda p, x, w, l: p.pyramid_hash(x, w, l, num_emb=8, space_len=50,
                                        pyramid_layer=3, rand_len=4),
      grad=True),
    C("pyramid_hash[no_lengths]", lambda r: [i32(r.integers(0, 2 ** 30,
                                                             (3, 5))),
                                             nrm(r, 1004)],
      lambda p, x, w: p.pyramid_hash(x, w, num_emb=12, space_len=1000,
                                     pyramid_layer=2, rand_len=4)),
    *[C(f"lstmp[reverse={rv}]",
        lambda r: [nrm(r, 2, 4, 12), nrm(r, 2, 12), nrm(r, 3, 2),
                   nrm(r, 21), nrm(r, 2, 2), nrm(r, 2, 3)],
        lambda p, x, w, pw, b, h0, c0, rv=rv: p.lstmp(
            x, w, pw, b, h0, c0, is_reverse=rv), grad=True)
      for rv in (False, True)],
    C("lstmp[single,no_peepholes]",
      lambda r: [nrm(r, 4, 12), nrm(r, 2, 12), nrm(r, 3, 2)],
      lambda p, x, w, pw: p.lstmp(x, w, pw, use_peepholes=False,
                                  proj_activation="identity"), grad=True),
    C("sample_logits[customized]",
      lambda r: [nrm(r, 3, 10), i32([[1, 2], [7, 0], [4, 4]]),
                 *_cust_samples()],
      lambda p, lg, lb, s, pr: p.sample_logits(
          lg, lb, 4, use_customized_samples=True, customized_samples=s,
          customized_probabilities=pr), grad=True),
]


# ---------------------------------------------------------------------------
# misc
# ---------------------------------------------------------------------------
def _dequant_table(r):
    codes = r.integers(0, 256, (5, 8)).astype(np.uint8)
    mn = r.uniform(-2, -1, (5, 1)).astype(np.float32)
    mx = r.uniform(1, 2, (5, 1)).astype(np.float32)
    return f32(np.concatenate([mn, mx, codes.view(np.float32)], 1))


def _ts_labels(r):
    return f32([-2.0, -1.0, 0.3, 1.7, -1.5, 0.0, 1.0, 0.9])


def _segments():
    return i32([0, 0, 1, 3, 3, 3])


def _ctc(r):
    x = i32([[0, 1, 1, 0, 2, 2, 3, 0], [4, 4, 4, 0, 0, 1, 0, 1],
             [0, 0, 0, 0, 2, 0, 2, 2]])
    return [x, i32([[8], [5], [7]])]


MISC = [
    C("add_position_encoding", lambda r: [nrm(r, 2, 5, 7)],
      lambda p, x: p.add_position_encoding(x, alpha=0.5, beta=2.0),
      grad=True),
    *[C(f"affine_channel[{fmt}]", lambda r: [nrm(r, 2, 3, 4, 3), nrm(r, 3),
                                            nrm(r, 3)],
        lambda p, x, s, b, fmt=fmt: p.affine_channel(x, s, b, fmt),
        grad=True) for fmt in ("NCHW", "NHWC")],
    C("anchor_generator", lambda r: [nrm(r, 1, 8, 3, 4)],
      lambda p, x: p.anchor_generator(x, [32.0, 64.0], [0.5, 1.0, 2.0],
                                      [0.1, 0.1, 0.2, 0.2], [16.0, 16.0])),
    *[C(f"bipartite_match[{mt}]",
        lambda r: [f32(np.round(r.uniform(0, 1, (3, 6)), 1))],
        lambda p, d, mt=mt: p.bipartite_match(d, mt, 0.3))
      for mt in ("bipartite", "per_prediction")],
    C("bpr_loss", lambda r: [nrm(r, 4, 5), i32([[1], [0], [4], [2]])],
      lambda p, x, y: p.bpr_loss(x, y), grad=True),
    *[C(f"center_loss[update={u}]", lambda r: [nrm(r, 4, 3), i32([0, 2, 2, 1]),
                                              nrm(r, 3, 3)],
        lambda p, x, y, c, u=u: p.center_loss(x, y, c, alpha=0.4,
                                              update_center=u), grad=True)
      for u in (True, False)],
    C("ctc_align", _ctc,
      lambda p, x, l: p.ctc_align(x, blank=0, padding_value=-1,
                                  input_length=l)),
    C("ctc_align[no_merge]", _ctc,
      lambda p, x, l: p.ctc_align(x, blank=0, merge_repeated=False)),
    C("data_norm", lambda r: [nrm(r, 4, 3), nrm(r, 3), nrm(r, 3)],
      lambda p, x, m, s: p.data_norm(x, m, s), grad=True),
    *[C(f"edit_distance[normalized={n}]",
        lambda r: [i32(r.integers(0, 4, (3, 6))), i32(r.integers(0, 4,
                                                                 (3, 5))),
                   i32([6, 2, 0]), i32([5, 4, 3])],
        lambda p, a, b, la, lb, n=n: p.edit_distance(a, b, n, la, lb))
      for n in (True, False)],
    C("gather_tree", lambda r: [i32(r.integers(0, 9, (4, 2, 3))),
                                i32(r.integers(0, 3, (4, 2, 3)))],
      lambda p, i, par: p.gather_tree(i, par)),
    C("hinge_loss", lambda r: [nrm(r, 6, 1), f32(r.integers(0, 2, (6, 1)))],
      lambda p, x, y: p.hinge_loss(x, y), grad=True),
    C("l1_norm", lambda r: [nrm(r, 3, 4)], lambda p, x: p.l1_norm(x),
      grad=True),
    C("mean_iou", lambda r: [i32(r.integers(0, 4, (2, 8))),
                             i32(r.integers(0, 4, (2, 8)))],
      lambda p, x, y: p.mean_iou(x, y, 5)),
    C("modified_huber_loss", lambda r: [f32(r.uniform(-3, 3, (8, 1))),
                                        f32(r.integers(0, 2, (8, 1)))],
      lambda p, x, y: p.modified_huber_loss(x, y), grad=True),
    C("rank_loss", lambda r: [f32(r.integers(0, 2, (5, 1))), nrm(r, 5, 1),
                              nrm(r, 5, 1)],
      lambda p, y, a, b: p.rank_loss(y, a, b), grad=True),
    C("space_to_depth", lambda r: [nrm(r, 2, 8, 4, 6)],
      lambda p, x: p.space_to_depth(x, 2), grad=True),
    C("squared_l2_distance", lambda r: [nrm(r, 4, 3), nrm(r, 4, 3)],
      lambda p, x, y: p.squared_l2_distance(x, y), grad=True),
    C("squared_l2_norm", lambda r: [nrm(r, 4, 3)],
      lambda p, x: p.squared_l2_norm(x), grad=True),
    C("teacher_student_sigmoid_loss", lambda r: [nrm(r, 8), _ts_labels(r)],
      lambda p, x, y: p.teacher_student_sigmoid_loss(x, y), grad=True),
    C("row_conv", lambda r: [nrm(r, 2, 5, 3), nrm(r, 3, 3)],
      lambda p, x, w: p.row_conv(x, w), grad=True),
    C("set_value", lambda r: [nrm(r, 4, 3), nrm(r, 2)],
      lambda p, x, v: p.set_value(x, v, (slice(1, 3), 2)), grad=True),
    C("set_value[whole]", lambda r: [nrm(r, 4, 3), nrm(r, 3)],
      lambda p, x, v: p.set_value(x, v), grad=True),
    *[C(f"{op}", lambda r: [nrm(r, 6, 3), _segments()],
        lambda p, d, s, op=op: getattr(p, op)(d, s), grad=True)
      for op in ("segment_sum", "segment_mean", "segment_max",
                 "segment_min")],
    *[C(f"segment_pool[{t}]", lambda r: [nrm(r, 6, 3), _segments()],
        lambda p, d, s, t=t: p.segment_pool(d, s, t), grad=True)
      for t in ("SUM", "mean", "max", "min")],
    C("fsp_matrix", lambda r: [nrm(r, 2, 3, 4, 5), nrm(r, 2, 2, 4, 5)],
      lambda p, x, y: p.fsp_matrix(x, y), grad=True),
    C("Print", lambda r: [nrm(r, 3, 4)],
      lambda p, x: p.Print(x, message="probe", summarize=5) * 1.0,
      grad=True),
    C("Assert", lambda r: [f32(np.abs(nrm(r, 4)) + 0.1)],
      lambda p, x: p.Assert(x > 0, [x]) * 1),
    C("conv_shift", lambda r: [nrm(r, 3, 7), nrm(r, 3, 3)],
      lambda p, x, y: p.conv_shift(x, y), grad=True),
    *[C(f"cvm[use_cvm={u}]", lambda r: [f32(r.uniform(0, 9, (4, 5))),
                                        f32(r.uniform(0, 1, (4, 2)))],
        lambda p, x, c, u=u: p.cvm(x, c, use_cvm=u), grad=True)
      for u in (True, False)],
    C("hash_op", lambda r: [i32(r.integers(0, 2 ** 31 - 1, (5, 3)))],
      lambda p, x: p.hash_op(x, num_hash=3, mod_by=10007)),
    C("batch_fc", lambda r: [nrm(r, 2, 3, 4), nrm(r, 2, 4, 5), nrm(r, 2, 5)],
      lambda p, x, w, b: p.batch_fc(x, w, b), grad=True),
    *[C(f"similarity_focus[axis={a}]", lambda r: [nrm(r, 2, 3, 4, 5)],
        lambda p, x, a=a: p.similarity_focus(x, a, [0, 2]))
      for a in (1, 2, 3)],
    C("lookup_table_dequant", lambda r: [_dequant_table(r), i32([[4, 0],
                                                                 [2, 2]])],
      lambda p, w, i: p.lookup_table_dequant(w, i)),
]

OPS = SEQUENCE + CRF + CONTROL + INDUSTRIAL + MISC


@pytest.mark.parametrize("case", OPS, ids=repr)
def test_op_matches_jax(case):
    arrays = case.make(rng())
    want, _ = jax_ref(case, case.call, arrays, False)
    got = tab.flat(case.call(T, *_tensors(T, arrays)))
    assert_close(got, want, R, case.label)


def _eager_grads(call, arrays):
    """`jax_ref`'s gradients, run eagerly: the JAX package's tape does not
    see into a traced ``lax.cond``, so control flow's gradients are held
    against its eager (concrete-predicate) branch, which the port's
    matches."""
    xs = [P.to_tensor(a, stop_gradient=a.dtype.kind != "f") for a in arrays]
    fl = [o for o in tab.flat(call(P, *xs)) if _float_out(o)]
    live = [(o, P.to_tensor(c)) for o, c in zip(
        fl, cotangents([tuple(o.shape) for o in fl])) if not o.stop_gradient]
    wrt = [x for x in xs if not x.stop_gradient]
    return [None if g is None else np.asarray(g.numpy()) for g in P.grad(
        [o for o, _ in live], wrt, grad_outputs=[c for _, c in live],
        allow_unused=True)]


@pytest.mark.parametrize("case", [c for c in OPS if c.grad], ids=repr)
def test_op_gradients_match_jax(case):
    arrays = case.make(rng())
    if case in CONTROL:
        jgrads = _eager_grads(case.call, arrays)
    else:
        _, jgrads = jax_ref(case, case.call, arrays, True)
    tgrads = port_grads(case.call, arrays)
    assert len(tgrads) == len(jgrads)
    for i, (g, w) in enumerate(zip(tgrads, jgrads)):
        w = np.zeros(g.shape, np.float32) if w is None else w
        assert_close(g, w, R, f"{case.label}.grad[{i}]")


RANDOM = ("tdm_sampler", "sampling_id", "shuffle_batch")


def test_every_public_name_has_a_case():
    """Each public name of the five JAX modules is at the port's module of
    the same name and has a case here (the samplers, in the tests
    below); the ops are at the port's top level as at the JAX
    package's, control flow's ``cond`` only in its namespace."""
    from paddle_tpu.ops import control_flow, crf, industrial, misc, sequence

    from paddle_tpu_torch.ops import control_flow as tcf
    from paddle_tpu_torch.ops import crf as tcrf
    from paddle_tpu_torch.ops import industrial as tind
    from paddle_tpu_torch.ops import misc as tmisc
    from paddle_tpu_torch.ops import sequence as tseq

    names = {c.name for c in OPS} | set(RANDOM)
    for jmod, tmod in ((control_flow, tcf), (crf, tcrf),
                       (industrial, tind), (misc, tmisc),
                       (sequence, tseq)):
        want = set(jmod.__all__) | _public(jmod)
        assert set(jmod.__all__) <= set(tmod.__all__), \
            sorted(set(jmod.__all__) - set(tmod.__all__))
        assert set(jmod.__all__) <= names, sorted(set(jmod.__all__) - names)
        assert want <= set(dir(tmod)) | {"Tensor", "unwrap", "dispatch"}, \
            sorted(want - set(dir(tmod)))
        for nm in jmod.__all__:
            if nm != "cond":
                assert hasattr(P, nm) == hasattr(T, nm), nm
    assert T.cond is T.linalg.cond and P.cond is P.linalg.cond
    assert T.ops.sample_logits is tind.sample_logits
    from paddle_tpu_torch.inference import serving
    from paddle_tpu_torch.nn import decode
    assert serving.sample_logits is decode.sample_logits


# ---------------------------------------------------------------------------
# the samplers: each package's own generator
# ---------------------------------------------------------------------------
def _tdm_inputs():
    # travel paths of 4 items over a 3-layer tree (layer node ids
    # 1-2, 3-6, 7-14); item 3 is padding (its path all 0)
    travel = np.array([[1, 3, 7], [1, 4, 9], [2, 6, 14], [0, 0, 0]],
                      np.int32)
    layer = np.arange(1, 15, dtype=np.int32)[:, None]
    return np.array([[0], [1], [2], [3]], np.int32), travel, layer


@pytest.mark.parametrize("positive", [True, False])
def test_tdm_sampler_draws_valid_negatives(positive):
    x, travel, layer = _tdm_inputs()
    offs, negs = [0, 2, 6, 14], [1, 2, 4]
    want = [np.asarray(t) for t in P.tdm_sampler(
        P.to_tensor(x), P.to_tensor(travel), P.to_tensor(layer), negs, offs,
        output_positive=positive)]
    for seed in (0, 3, 5):
        got = [t.numpy() for t in T.tdm_sampler(
            torch.from_numpy(x), torch.from_numpy(travel),
            torch.from_numpy(layer), negs, offs, output_positive=positive,
            seed=seed)]
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == np.int64
        out, labels, mask = got
        # labels and masks are deterministic: equal to JAX's
        np.testing.assert_array_equal(labels, want[1])
        np.testing.assert_array_equal(mask, want[2])
        col = 0
        for li, neg in enumerate(negs):
            nodes = set(range(offs[li] + 1, offs[li + 1] + 1))
            for i in range(3):
                pos = travel[i, li]
                if positive:
                    assert out[i, col] == pos
                drawn = out[i, col + positive:col + positive + neg]
                assert len(set(drawn)) == neg and pos not in drawn
                assert set(drawn) <= nodes
            assert (out[3, col:col + positive + neg] == 0).all()
            col += positive + neg


def test_sample_logits_own_draw():
    """The log-uniform draw: unique samples (``uniq``), the true logits'
    correction equal to JAX's, hits masked, the labels 0..T-1."""
    r = rng()
    lg = nrm(r, 4, 50)
    lb = i32([[1, 2], [7, 0], [4, 4], [49, 3]])
    jl, jlab = P.sample_logits(P.to_tensor(lg), P.to_tensor(lb), 8)
    tl, tlab = T.sample_logits(torch.from_numpy(lg), torch.from_numpy(lb),
                               8, seed=11)
    np.testing.assert_array_equal(tlab.numpy(), np.asarray(jlab))
    np.testing.assert_allclose(tl[:, :2].numpy(), np.asarray(jl)[:, :2],
                               rtol=1e-6, atol=1e-6)
    assert tl.shape == (4, 10)
    samp = tl[:, 2:].numpy()
    hits = samp == -1e20
    assert hits.sum() >= 0 and np.isfinite(samp[~hits]).all()
    t2, _ = T.sample_logits(torch.from_numpy(lg), torch.from_numpy(lb), 8,
                            uniq=False, seed=11)
    assert t2.shape == (4, 10)


def test_sampling_id_and_shuffle_batch_in_distribution():
    """``sampling_id`` follows each row's probabilities (chi-square over
    20000 rows); ``shuffle_batch`` is a permutation, equal under one
    seed and a different one under another."""
    probs = f32([[0.1, 0.6, 0.3], [0.5, 0.0, 0.5]])
    big = torch.from_numpy(np.repeat(probs, 10000, axis=0))
    ids = T.sampling_id(big, seed=7).numpy().reshape(2, 10000)
    for row, p in zip(ids, probs):
        counts = np.bincount(row, minlength=3)
        expected = p * 10000
        live = expected > 0
        chi2 = (((counts[live] - expected[live]) ** 2)
                / expected[live]).sum()
        assert chi2 < 16.3, (counts, chi2)   # p = 0.001 at 2 dof
        assert counts[~live].sum() == 0
    jid = np.asarray(P.sampling_id(P.to_tensor(probs), seed=7))
    assert jid.shape == (2,) and set(jid.tolist()) <= {0, 1, 2}
    x = torch.arange(40.).reshape(20, 2)
    a, ia, sa = T.shuffle_batch(x, seed=3)
    b, ib, _ = T.shuffle_batch(x, seed=3)
    c, ic, _ = T.shuffle_batch(x, seed=4)
    assert sorted(ia.tolist()) == list(range(20))
    assert torch.equal(a, x[ia]) and torch.equal(ia, ib)
    assert not torch.equal(ia, ic) and sa.tolist() == [3]
    jx, jidx, jseed = P.shuffle_batch(P.to_tensor(x.numpy()), seed=3)
    assert sorted(np.asarray(jidx).tolist()) == list(range(20))


def test_pyramid_hash_dropout_keeps_whole_ngrams():
    """Training dropout drops whole n-grams: a kept row equals the
    deterministic output, a dropped one is zero with mask 0."""
    r = rng()
    x = torch.from_numpy(i32(r.integers(0, 100, (4, 9))))
    w = torch.from_numpy(nrm(r, 44))
    full, fmask = T.pyramid_hash(x, w, num_emb=8, space_len=40,
                                 pyramid_layer=3)
    out, mask = T.pyramid_hash(x, w, num_emb=8, space_len=40,
                               pyramid_layer=3, drop_out_percent=0.5,
                               is_training=True, seed=2)
    kept = mask.bool()
    assert 0 < kept.sum() < fmask.sum()
    assert torch.equal(out[kept], full[kept])
    assert (out[~kept] == 0).all()


def test_assert_raises_in_both_packages():
    bad = f32([1.0, -1.0])
    with pytest.raises(AssertionError):
        P.Assert(P.to_tensor(bad) > 0, [P.to_tensor(bad)])
    with pytest.raises(AssertionError, match="data="):
        T.Assert(torch.from_numpy(bad) > 0, [torch.from_numpy(bad)])


def test_switch_case_without_default_raises_in_both():
    x = f32([1.0])
    with pytest.raises(ValueError):
        P.ops.control_flow.switch_case(4, [lambda: x])
    with pytest.raises(ValueError):
        T.ops.control_flow.switch_case(torch.tensor(4), [lambda: x])
