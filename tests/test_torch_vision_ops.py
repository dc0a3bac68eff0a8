"""paddle_tpu_torch.vision's ops and detection long tail against the JAX
package's.

Every public name of ``paddle_tpu/vision/ops.py`` and
``paddle_tpu/vision/detection.py`` is a case of one table: the same
inputs, made from a numpy seed, go through ``paddle_tpu.vision`` and
``paddle_tpu_torch.vision`` (the port on the CPU) at tiny shapes, each
JAX case traced under one ``jax.jit`` (eagerly where it reads values on
the host, as ``nms`` does; `test_torch_tensor_api.jax_ref`).  Index,
label and count outputs are equal, float outputs within rtol 1e-5, atol
1e-5 (the ``reduce`` family: the ops sum and average); gradients, where
the JAX package differentiates (``roi_align``, ``roi_pool``,
``deform_conv2d``, ``psroi_pool``, ``prroi_pool``, ``yolov3_loss``,
``correlation``), at the same tolerance.  The NMS family runs on scores
with ties (quantized to 0.1), where the stable sort and top-k's lowest
index first decide the indices.  `test_yolov3_loss_last_row_wins_a_cell`
states the JAX package's scatter on a cell two ground-truth rows share.
"""
import torch_test_env  # noqa: F401  (first: one intra-op thread)
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu.vision.detection  # noqa: F401
import paddle_tpu.vision.ops  # noqa: F401
import paddle_tpu_torch as T
import paddle_tpu_torch.vision.detection as TDET
import paddle_tpu_torch.vision.ops as TOPS
from paddle_tpu_torch.core import place as TPL

import torch_op_tables as tab
from test_torch_tensor_api import (_public, _tensors, assert_close, jax_ref,
                                   port_grads, rng)

R = "reduce"


@pytest.fixture(autouse=True)
def on_cpu():
    prev = TPL._EXPECTED_DEVICE[0]
    T.set_device("cpu")
    yield
    TPL._EXPECTED_DEVICE[0] = prev


class V:
    """``call(pkg, *tensors)`` on ``make(rng)``'s arrays."""

    def __init__(self, label, make, call, grad=False):
        self.label, self.make, self.call, self.grad = label, make, call, grad
        self.name = label.split("[")[0]

    def __repr__(self):
        return self.label


def ops(pkg):
    return pkg.vision.ops


def det(pkg):
    return pkg.vision.detection


def f32(a):
    return np.asarray(a, np.float32)


def i32(a):
    return np.asarray(a, np.int32)


def boxes(r, n, size=1.0, lo=0.02):
    """``n`` xyxy boxes inside [0, size]."""
    xy = r.uniform(0, size * 0.7, (n, 2))
    wh = r.uniform(size * lo, size * 0.3, (n, 2))
    return f32(np.concatenate([xy, xy + wh], 1))


def tied(r, shape):
    """Scores quantized to 0.1: many equal values."""
    return f32(np.round(r.uniform(0, 1, shape), 1))


def quads(r, n, h, w):
    """Convex-ish quadrilaterals (x0, y0, ..., x3, y3) inside the map."""
    cx, cy = r.uniform(w * 0.3, w * 0.7, n), r.uniform(h * 0.3, h * 0.7, n)
    dx, dy = r.uniform(2, w * 0.3, n), r.uniform(2, h * 0.3, n)
    j = r.uniform(-0.5, 0.5, (n, 8))
    q = np.stack([cx - dx, cy - dy, cx + dx, cy - dy, cx + dx, cy + dy,
                  cx - dx, cy + dy], 1) + j
    return f32(q)


def _yolo_gt(r, n=2, b=5):
    xy = r.uniform(0.05, 0.95, (n, b, 2))
    wh = r.uniform(0.05, 0.6, (n, b, 2))
    gt = np.concatenate([xy, wh], -1)
    gt[:, -2:] = 0.0  # padded rows
    return f32(gt)


def _yolo_collision():
    """A real box in cell (0, 0), best anchor 0, then padded rows (w = h
    = 0), which land on the same cell and anchor."""
    gt = np.zeros((1, 4, 4), np.float32)
    gt[0, 0] = [0.05, 0.05, 0.08, 0.1]
    gt[0, 1] = [0.6, 0.55, 0.3, 0.4]
    return gt


ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90,
           156, 198, 373, 326]


def _rpn_inputs(r):
    anchors = boxes(r, 24, 64.0, 0.1)
    gt = np.stack([boxes(r, 3, 64.0, 0.2) for _ in range(2)])
    return [anchors, gt, i32([[0, 0, 1], [0, 0, 0]]),
            f32([[64, 64, 1.0], [60, 56, 1.0]]), i32([3, 2])]


def _proposal_inputs(r, v1=True):
    a, h, w = 3, 4, 5
    cy, cx = np.meshgrid(np.arange(h) * 16.0, np.arange(w) * 16.0,
                         indexing="ij")
    size = np.asarray([16.0, 24.0, 32.0])
    anc = np.stack([cx[..., None] - size / 2, cy[..., None] - size / 2,
                    cx[..., None] + size / 2, cy[..., None] + size / 2], -1)
    im = f32([[64, 80, 1.0], [60, 70, 1.0]]) if v1 else f32([[64, 80],
                                                              [60, 70]])
    return [tied(r, (2, a, h, w)),
            f32(r.normal(0, 0.3, (2, 4 * a, h, w))), im, f32(anc),
            f32(np.broadcast_to([0.1, 0.1, 0.2, 0.2], anc.shape))]


OPS = [
    V("iou_similarity[normalized]",
      lambda r: [boxes(r, 5), boxes(r, 6)],
      lambda p, a, b: ops(p).iou_similarity(a, b)),
    V("iou_similarity[pixels]",
      lambda r: [boxes(r, 5, 30.0), boxes(r, 6, 30.0)],
      lambda p, a, b: ops(p).iou_similarity(a, b, box_normalized=False)),
    V("box_clip", lambda r: [f32(r.uniform(-10, 50, (2, 5, 4))),
                             f32([30, 40, 1.5])],
      lambda p, b, i: ops(p).box_clip(b, i)),
    V("box_coder[encode]",
      lambda r: [boxes(r, 6), f32(r.uniform(0.1, 0.3, (6, 4))),
                 boxes(r, 5)],
      lambda p, pr, v, t: ops(p).box_coder(pr, v, t)),
    V("box_coder[decode]",
      lambda r: [boxes(r, 6, 30.0), f32(r.uniform(0.1, 0.3, (6, 4))),
                 f32(r.normal(0, 0.5, (5, 6, 4)))],
      lambda p, pr, v, t: ops(p).box_coder(
          pr, v, t, code_type="decode_center_size", box_normalized=False)),
    V("box_coder[decode-axis1-listvar]",
      lambda r: [boxes(r, 6), f32(r.normal(0, 0.5, (6, 5, 4)))],
      lambda p, pr, t: ops(p).box_coder(
          pr, [0.1, 0.1, 0.2, 0.2], t, code_type="decode_center_size",
          axis=1)),
    V("prior_box", lambda r: [f32(r.normal(size=(1, 8, 6, 5))),
                              f32(r.normal(size=(1, 3, 48, 40)))],
      lambda p, x, im: [ops(p).prior_box(
          x, im, [8.0, 16.0], [12.0, 24.0], [2.0], flip=True, clip=True),
          ops(p).prior_box(x, im, [8.0], [12.0], [2.0, 3.0],
                           min_max_aspect_ratios_order=True,
                           steps=(7.0, 6.0))]),
    V("yolo_box", lambda r: [f32(r.normal(0, 1.5, (2, 27, 5, 6))),
                             i32([[160, 192], [150, 170]])],
      lambda p, x, s: [ops(p).yolo_box(x, s, [10, 13, 16, 30, 33, 23], 4,
                                       0.3, 32),
                       ops(p).yolo_box(x, s, [10, 13, 16, 30, 33, 23], 4,
                                       0.3, 32, clip_bbox=False,
                                       scale_x_y=1.05)]),
    V("roi_align[aligned]",
      lambda r: [f32(r.normal(size=(2, 3, 12, 14))), boxes(r, 5, 26.0),
                 i32([2, 3])],
      lambda p, x, b, n: ops(p).roi_align(x, b, n, 3, spatial_scale=0.5),
      grad=True),
    V("roi_align[unaligned]",
      lambda r: [f32(r.normal(size=(2, 3, 12, 14))), boxes(r, 5, 26.0),
                 i32([4, 1])],
      lambda p, x, b, n: ops(p).roi_align(x, b, n, (2, 3), 0.5, 3,
                                          aligned=False), grad=True),
    V("roi_pool",
      lambda r: [f32(r.normal(size=(2, 3, 12, 14))), boxes(r, 6, 26.0, 0.0),
                 i32([2, 4])],
      lambda p, x, b, n: ops(p).roi_pool(x, b, n, (3, 2), 0.5), grad=True),
    V("nms[ties]", lambda r: [boxes(r, 20), tied(r, (20,))],
      lambda p, b, s: ops(p).nms(b, 0.3, s)),
    V("nms[categories]", lambda r: [boxes(r, 20), tied(r, (20,)),
                                    i32(r.integers(0, 3, 20))],
      lambda p, b, s, c: ops(p).nms(b, 0.4, s, c, [0, 1, 2], top_k=6)),
    V("multiclass_nms[ties]",
      lambda r: [np.stack([boxes(r, 12) for _ in range(2)]),
                 tied(r, (2, 3, 12))],
      lambda p, b, s: [ops(p).multiclass_nms(b, s, 0.15, 8, 10,
                                             return_index=True),
                       ops(p).multiclass_nms(b, s, 0.15, -1, 40,
                                             nms_threshold=0.5,
                                             background_label=0,
                                             return_index=True),
                       ops(p).multiclass_nms(b, s, 0.05, 10, 6,
                                             nms_eta=0.8)]),
    V("matrix_nms[ties]",
      lambda r: [np.stack([boxes(r, 12) for _ in range(2)]),
                 tied(r, (2, 3, 12))],
      lambda p, b, s: [ops(p).matrix_nms(b, s, 0.15, 0.1, 8, 10,
                                         return_index=True),
                       ops(p).matrix_nms(b, s, 0.15, 0.05, -1, 50,
                                         use_gaussian=True,
                                         background_label=1,
                                         return_index=True)]),
    V("deform_conv2d[v2]",
      lambda r: [f32(r.normal(size=(2, 4, 7, 7))),
                 f32(r.normal(0, 1.5, (2, 2 * 2 * 9, 7, 7))),
                 f32(r.normal(size=(6, 2, 3, 3))),
                 f32(r.uniform(0, 1, (2, 2 * 9, 7, 7))),
                 f32(r.normal(size=(6,)))],
      lambda p, x, o, w, m, b: ops(p).deform_conv2d(
          x, o, w, b, padding=1, deformable_groups=2, groups=2, mask=m),
      grad=True),
    V("deform_conv2d[v1-stride]",
      lambda r: [f32(r.normal(size=(1, 3, 8, 8))),
                 f32(r.normal(0, 1.5, (1, 2 * 9, 3, 3))),
                 f32(r.normal(size=(4, 3, 3, 3)))],
      lambda p, x, o, w: ops(p).deform_conv2d(x, o, w, stride=2,
                                              dilation=1), grad=True),
    V("correlation",
      lambda r: [f32(r.normal(size=(2, 3, 9, 9))),
                 f32(r.normal(size=(2, 3, 9, 9)))],
      lambda p, a, b: [ops(p).correlation(a, b, 2, 1, 2, 1, 1),
                       ops(p).correlation(a, b, 2, 3, 2, 2, 2)], grad=True),
    V("bilateral_slice",
      lambda r: [f32(r.normal(size=(2, 2, 6, 7))),
                 f32(r.normal(size=(2, 6, 4, 3, 3))),
                 f32(r.uniform(0, 1, (2, 6, 7))),
                 f32(r.normal(size=(2, 4, 4, 3, 3)))],
      lambda p, x, g, gd, g2: [ops(p).bilateral_slice(x, g, gd, True),
                               ops(p).bilateral_slice(x, g2, gd)]),
    # -- detection ---------------------------------------------------------
    V("psroi_pool",
      lambda r: [f32(r.normal(size=(2, 18, 10, 12))), boxes(r, 4, 22.0),
                 i32([1, 3])],
      lambda p, x, b, n: det(p).psroi_pool(x, b, n, 2, 0.5, 3, 3),
      grad=True),
    V("prroi_pool",
      lambda r: [f32(r.normal(size=(2, 3, 10, 12))), boxes(r, 4, 22.0),
                 i32([3, 1])],
      lambda p, x, b, n: det(p).prroi_pool(x, b, n, 3, 2, 0.5), grad=True),
    V("deformable_psroi_pooling",
      lambda r: [f32(r.normal(size=(2, 8, 10, 10))), boxes(r, 3, 18.0),
                 f32(r.normal(0, 0.5, (3, 2, 2, 2))), i32([1, 2])],
      lambda p, x, b, t, n: [det(p).deformable_psroi_pooling(
          x, b, t, n, spatial_scale=0.5, output_channels=2,
          pooled_height=2, pooled_width=2, part_size=2, sample_per_part=2),
          det(p).deformable_psroi_pooling(
              x[:1], b, t, no_trans=True, spatial_scale=0.5,
              pooled_height=2, pooled_width=2, sample_per_part=3)]),
    V("generate_proposals", lambda r: _proposal_inputs(r),
      lambda p, s, d, im, a, v: det(p).generate_proposals(
          s, d, im, a, v, pre_nms_top_n=30, post_nms_top_n=10,
          nms_thresh=0.5, min_size=2.0)),
    V("generate_proposals_v2", lambda r: _proposal_inputs(r, v1=False),
      lambda p, s, d, im, a, v: det(p).generate_proposals_v2(
          s, d, im, a, v, pre_nms_top_n=-1, post_nms_top_n=12,
          nms_thresh=0.6, min_size=1.0, pixel_offset=False)),
    V("distribute_fpn_proposals",
      lambda r: [f32(np.concatenate([boxes(r, 6, 300.0, 0.05),
                                     boxes(r, 6, 900.0, 0.2)]))],
      lambda p, b: det(p).distribute_fpn_proposals(b, 2, 5, 4, 224)),
    V("collect_fpn_proposals",
      lambda r: [boxes(r, 6, 50.0), boxes(r, 5, 50.0),
                 tied(r, (6, 1)), tied(r, (5, 1)), i32(4), i32(3)],
      lambda p, b1, b2, s1, s2, n1, n2: [
          det(p).collect_fpn_proposals([b1, b2], [s1, s2], 2, 3, 7),
          det(p).collect_fpn_proposals([b1, b2], [s1, s2], 2, 3, 7,
                                       rois_num_per_level=[n1, n2])]),
    V("box_decoder_and_assign",
      lambda r: [boxes(r, 5, 40.0), f32([0.1, 0.1, 0.2, 0.2]),
                 f32(r.normal(0, 0.5, (5, 12))),
                 f32(r.uniform(0, 1, (5, 3))),
                 f32(r.uniform(0.1, 0.3, (5, 4)))],
      lambda p, pr, v, t, s, v2: [
          det(p).box_decoder_and_assign(pr, v, t, s),
          det(p).box_decoder_and_assign(pr, v2, t, s, box_clip=0.5)]),
    V("locality_aware_nms",
      lambda r: [boxes(r, 10), tied(r, (2, 10))],
      lambda p, b, s: [det(p).locality_aware_nms(b, s, 0.1, 8, 6),
                       det(p).locality_aware_nms(b, s, 0.1, -1, -1, 0.5,
                                                 background_label=0)]),
    V("retinanet_detection_output",
      lambda r: [f32(r.normal(0, 0.3, (1, 8, 4))),
                 f32(r.normal(0, 0.3, (1, 6, 4))),
                 tied(r, (1, 8, 3)), tied(r, (1, 6, 3)),
                 boxes(r, 8, 60.0, 0.1), boxes(r, 6, 60.0, 0.2),
                 f32([64, 72, 1.0])],
      lambda p, b1, b2, s1, s2, a1, a2, im:
          det(p).retinanet_detection_output(
              [b1, b2], [s1, s2], [a1, a2], im, score_threshold=0.2,
              nms_top_k=5, keep_top_k=7)),
    V("density_prior_box",
      lambda r: [f32(r.normal(size=(1, 4, 3, 4))),
                 f32(r.normal(size=(1, 3, 24, 32)))],
      lambda p, x, im: [det(p).density_prior_box(
          x, im, [2, 1], [8.0, 16.0], [1.0, 2.0]),
          det(p).density_prior_box(x, im, [1], [12.0], [0.5], clip=True,
                                   flatten_to_2d=True, step_w=9.0)]),
    V("yolov3_loss",
      lambda r: [f32(r.normal(0, 1.0, (2, 3 * 8, 4, 4))), _yolo_gt(r),
                 i32(r.integers(0, 3, (2, 5))),
                 f32(r.uniform(0.5, 1.0, (2, 5)))],
      lambda p, x, g, lab, sc: [
          det(p).yolov3_loss(x, g, lab, ANCHORS, [6, 7, 8], 3, 0.5, 32),
          det(p).yolov3_loss(x, g, lab, ANCHORS, [3, 4, 5], 3, 0.3, 32,
                             gt_score=sc, use_label_smooth=False,
                             scale_x_y=1.1)], grad=True),
    V("yolov3_loss[collision]",
      lambda r: [f32(r.normal(0, 1.0, (1, 3 * 7, 4, 4))), _yolo_collision(),
                 i32([[1, 0, 0, 0]])],
      lambda p, x, g, lab: det(p).yolov3_loss(x, g, lab, ANCHORS, [0, 1, 2],
                                              2, 0.7, 32), grad=True),
    V("multiclass_nms2",
      lambda r: [np.stack([boxes(r, 12) for _ in range(2)]),
                 tied(r, (2, 3, 12))],
      lambda p, b, s: [det(p).multiclass_nms2(b, s, 0.15, 8, 10,
                                              return_index=True),
                       det(p).multiclass_nms2(b, s, 0.15, 8, 10)]),
    V("multiclass_nms3",
      lambda r: [np.stack([boxes(r, 12) for _ in range(2)]),
                 tied(r, (2, 3, 12))],
      lambda p, b, s: det(p).multiclass_nms3(b, s, score_threshold=0.15,
                                             nms_top_k=6, keep_top_k=9)),
    V("target_assign",
      lambda r: [f32(r.normal(size=(2, 3, 5, 4))),
                 i32([[0, -1, 2, 1, -1], [-1, -1, 1, 0, 2]]),
                 i32([[1, 4, -1], [0, -1, -1]])],
      lambda p, x, m, ng: [det(p).target_assign(x, m, mismatch_value=0.5),
                           det(p).target_assign(x, m, ng)]),
    V("mine_hard_examples",
      lambda r: [tied(r, (2, 8)), i32([[0, -1, -1, 1, -1, -1, -1, -1],
                                       [-1, -1, 2, -1, -1, -1, -1, -1]]),
                 f32(r.uniform(0, 1, (2, 8))), tied(r, (2, 8))],
      lambda p, c, m, d, lo: [
          det(p).mine_hard_examples(c, m, d, neg_pos_ratio=2.0,
                                    neg_dist_threshold=0.7),
          det(p).mine_hard_examples(c, m, d, lo, sample_size=4,
                                    mining_type="hard_example")]),
    V("rpn_target_assign", _rpn_inputs,
      lambda p, a, g, c, im, n: [det(p).rpn_target_assign(
          None, None, a, None, g, c, im, n, rpn_batch_size_per_im=8,
          rpn_positive_overlap=0.5, rpn_negative_overlap=0.3),
          det(p).rpn_target_assign(None, None, a, None, g, c, im,
                                   rpn_batch_size_per_im=6,
                                   rpn_straddle_thresh=-1.0)]),
    V("retinanet_target_assign",
      lambda r: _rpn_inputs(r) + [i32([[1, 2, 3], [4, 5, 6]])],
      lambda p, a, g, c, im, n, lab: det(p).retinanet_target_assign(
          None, None, a, None, g, lab, c, im, n)),
    V("polygon_box_transform", lambda r: [f32(r.normal(size=(1, 4, 3, 5)))],
      lambda p, x: det(p).polygon_box_transform(x)),
    V("generate_proposal_labels",
      lambda r: [np.stack([boxes(r, 6, 60.0, 0.1) for _ in range(2)]),
                 i32([[1, 2, 3], [2, 1, 0]]), i32([[0, 1, 0], [0, 0, 0]]),
                 np.stack([boxes(r, 3, 60.0, 0.2) for _ in range(2)]),
                 f32([[64, 64, 1.0], [64, 64, 2.0]]), i32([6, 4]),
                 i32([3, 2])],
      lambda p, ro, gc, cr, g, im, rn, gn: det(p).generate_proposal_labels(
          ro, gc, cr, g, im, rn, gn, batch_size_per_im=8, fg_thresh=0.3,
          bg_thresh_hi=0.3, class_nums=4)),
    V("roi_perspective_transform",
      lambda r: [f32(r.normal(size=(2, 2, 10, 12))), quads(r, 3, 10, 12),
                 i32([0, 1, 1])],
      lambda p, x, q, b: det(p).roi_perspective_transform(x, q, 4, 5,
                                                          roi_batch_idx=b)),
    V("generate_mask_labels",
      lambda r: [f32([[32, 32, 1.0]]), i32([[1, 2]]), i32([[0, 0]]),
                 f32([[[[[2, 2], [14, 3], [13, 15], [3, 12]]],
                       [[[16, 16], [30, 17], [28, 30], [15, 29]]]]]),
                 f32([[[1, 1, 15, 15], [15, 15, 31, 31], [0, 0, 8, 8]]]),
                 i32([[1, 2, 0]])],
      lambda p, im, gc, cr, sg, ro, lab: det(p).generate_mask_labels(
          im, gc, cr, sg, ro, lab, 3, 4)),
]


@pytest.mark.parametrize("case", OPS, ids=repr)
def test_op_matches_jax(case):
    arrays = case.make(rng())
    want, _ = jax_ref(case, case.call, arrays, False)
    got = tab.flat(case.call(T, *_tensors(T, arrays)))
    assert_close(got, want, R, case.label)


@pytest.mark.parametrize("case", [c for c in OPS if c.grad], ids=repr)
def test_op_gradients_match_jax(case):
    arrays = case.make(rng())
    _, jgrads = jax_ref(case, case.call, arrays, True)
    tgrads = port_grads(case.call, arrays)
    assert len(tgrads) == len(jgrads)
    for i, (g, w) in enumerate(zip(tgrads, jgrads)):
        w = np.zeros(g.shape, np.float32) if w is None else w
        assert_close(g, w, R, f"{case.label}.grad[{i}]")


def test_every_public_name_has_a_case():
    names = {c.name for c in OPS}
    for jmod, tmod in ((P.vision.ops, TOPS), (P.vision.detection, TDET)):
        want = set(jmod.__all__) | _public(jmod)
        assert want <= set(dir(tmod)), sorted(want - set(dir(tmod)))
        assert set(jmod.__all__) <= names, sorted(set(jmod.__all__) - names)
    # the detection long tail is reachable through vision.ops too
    assert T.vision.ops.psroi_pool is TDET.psroi_pool
    with pytest.raises(AttributeError):
        T.vision.ops.no_such_op


def test_yolov3_loss_last_row_wins_a_cell():
    """Two ground-truth rows on one cell and anchor: a real box (row 0)
    and a padded row after it (w = h = 0 maps to cell (0, 0), anchor 0).
    The JAX package's scatter applies the rows in order on the CPU, so
    the padded row writes the cell's old value over the real box's score
    (the cell is no positive); the port gives the same on any device."""
    case = OPS[[c.label for c in OPS].index("yolov3_loss[collision]")]
    arrays = case.make(rng())
    _, jmask, jmatch = jax_ref(case, case.call, arrays, False)[0]
    _, tmask, tmatch = case.call(T, *_tensors(T, arrays))
    assert jmatch[0, 0] == 0  # row 0 matched anchor 0
    assert jmask[0, 0, 0, 0] <= 0.0  # the padded row's old value won
    np.testing.assert_array_equal(tmask.numpy(), jmask)
    np.testing.assert_array_equal(tmatch.numpy(), jmatch)


def test_multiclass_nms_rois_num_raises_in_both():
    b = np.zeros((1, 2, 4), np.float32)
    s = np.zeros((1, 1, 2), np.float32)
    for pkg, conv in ((P, P.to_tensor), (T, torch.from_numpy)):
        with pytest.raises(NotImplementedError):
            pkg.vision.ops.multiclass_nms(conv(b), conv(s), 0.1, 2, 2,
                                          rois_num=conv(np.ones(1)))
