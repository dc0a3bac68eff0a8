"""OpDesc cases for the op types the JAX interpreter tests reach only
under jit (or not at all): one reference-schema OpDesc each, inputs made
by numpy from a seed.  `torch_static_common.run_jax_case` runs each
through the JAX translator to make a case that `replay` then runs on the
port.  Detection and sequence inputs reuse the recipes of
`test_torch_vision_ops.py` and `test_torch_seq_ops.py`.
"""
from __future__ import annotations

import numpy as np


def f32(a):
    return np.asarray(a, np.float32)


def i32(a):
    return np.asarray(a, np.int32)


def i64(a):
    return np.asarray(a, np.int64)


def _r(seed=0):
    return np.random.default_rng(seed)


def nrm(*shape, seed=0):
    return f32(_r(seed).standard_normal(shape))


def pos(*shape, seed=0):
    return f32(_r(seed).uniform(0.2, 2.0, shape))


def _boxes(r, n, size=1.0, lo=0.02):
    xy = r.uniform(0, size * 0.7, (n, 2))
    wh = r.uniform(size * lo, size * 0.3, (n, 2))
    return f32(np.concatenate([xy, xy + wh], 1))


def _tied(r, shape):
    return f32(np.round(r.uniform(0, 1, shape), 1))


class Case:
    """One OpDesc: ``ins`` {param: array | [arrays]}, ``attrs``, ``outs``
    (``"Name*k"`` declares k arguments), ``lods`` {param: lengths} (the
    ``@LOD`` sidecars), ``sub`` ops of a sub-block (block 1)."""

    def __init__(self, optype, ins=None, attrs=None, outs=("Out",),
                 lods=None, sub=None, label=None):
        self.type = optype
        self.ins = ins or {}
        self.attrs = attrs or {}
        self.outs = outs
        self.lods = lods or {}
        self.sub = sub
        self.label = label or optype


def _unary(names, make=nrm):
    return [Case(n, {"X": make(3, 4)}) for n in names.split()]


def _binary(names, x=None, y=None):
    x = nrm(3, 4) if x is None else x
    y = nrm(3, 4, seed=1) if y is None else y
    return [Case(n, {"X": x, "Y": y}) for n in names.split()]


def extra_cases():
    r = _r(0)
    cases = []
    cases += _unary("abs ceil cos exp floor relu relu6 round sigmoid sign "
                    "silu sin softplus softsign square erf logsigmoid mish "
                    "reciprocal isfinite isfinite_v2 tanh")
    cases += _unary("log log1p rsqrt sqrt", make=pos)
    cases += [Case("gelu", {"X": nrm(3, 4)}, {"approximate": True}),
              Case("gelu", {"X": nrm(3, 4)}, label="gelu[erf]"),
              Case("hard_sigmoid", {"X": nrm(3, 4) * 4},
                   {"slope": 0.25, "offset": 0.4}),
              Case("hard_swish", {"X": nrm(3, 4) * 4}),
              Case("swish", {"X": nrm(3, 4)}, {"beta": 1.5}),
              Case("log_softmax", {"X": nrm(3, 4)}, {"axis": 0}),
              Case("softmax", {"X": nrm(3, 4)}, {"axis": -1}),
              Case("clip", {"X": nrm(3, 4)}, {"min": -0.3, "max": 0.5}),
              Case("clip_by_norm", {"X": nrm(3, 4)}, {"max_norm": 1.0}),
              Case("pow", {"X": pos(3, 4)}, {"factor": 2.5}),
              Case("prelu", {"X": nrm(2, 3, 4), "Alpha": f32([0.1, 0.2,
                                                               0.3])},
                   {"mode": "channel"}),
              Case("dropout", {"X": nrm(3, 4)},
                   {"dropout_prob": 0.3, "is_test": True},
                   outs=("Out",)),
              Case("dropout", {"X": nrm(3, 4)},
                   {"dropout_prob": 0.3,
                    "dropout_implementation": "upscale_in_train"},
                   label="dropout[upscale]")]
    cases += _binary("elementwise_add elementwise_div elementwise_max "
                     "elementwise_min elementwise_sub equal not_equal "
                     "greater_equal less_equal")
    cases += [Case("elementwise_add", {"X": nrm(2, 3, 4),
                                       "Y": nrm(3, seed=1)}, {"axis": 1},
                   label="elementwise_add[axis]"),
              Case("elementwise_pow", {"X": pos(3, 4),
                                       "Y": nrm(3, 4, seed=1)}),
              Case("elementwise_mod", {"X": i32([[7, -7, 9]]),
                                       "Y": i32([[3, 3, -4]])}),
              Case("elementwise_floordiv", {"X": i32([[7, -7, 9]]),
                                            "Y": i32([[3, 3, -4]])})]
    b1 = np.asarray(r.integers(0, 2, (3, 4)), bool)
    b2 = np.asarray(r.integers(0, 2, (3, 4)), bool)
    cases += _binary("logical_and logical_or logical_xor", b1, b2)
    cases += [Case("sum", {"X": [nrm(3, 4), nrm(3, 4, seed=1),
                                 nrm(3, 4, seed=2)]}),
              Case("mean", {"X": nrm(3, 4)}),
              Case("mul", {"X": nrm(2, 3, 4), "Y": nrm(12, 5, seed=1)},
                   {"x_num_col_dims": 1, "y_num_col_dims": 1}),
              Case("matmul", {"X": nrm(2, 4, 3), "Y": nrm(2, 5, 4, seed=1)},
                   {"transpose_X": True, "transpose_Y": True,
                    "alpha": 0.5}),
              Case("fc", {"Input": nrm(2, 3, 4), "W": nrm(4, 5, seed=1),
                          "Bias": nrm(5, seed=2)},
                   {"in_num_col_dims": 2, "activation_type": "relu"}),
              Case("cast", {"X": nrm(3, 4) * 3}, {"out_dtype": 2},
                   label="cast[int32]"),
              Case("shape", {"Input": nrm(2, 3, 4)}),
              Case("assign", {"X": nrm(3)}),
              Case("share_data", {"X": nrm(3)}),
              Case("memcpy", {"X": nrm(3)}),
              Case("fill_any_like", {"X": nrm(3, 4)}, {"value": 2.5}),
              Case("fill_zeros_like", {"X": nrm(3, 4)}),
              Case("fill_zeros_like2", {"X": nrm(3, 4)}),
              Case("increment", {"X": f32([2.0])}, {"step": 1.5}),
              Case("is_empty", {"X": nrm(0, 3)}),
              Case("reshape", {"X": nrm(2, 3, 4)}, {"shape": [0, -1]}),
              Case("reshape2", {"X": nrm(2, 3, 4)}, {"shape": [4, 0, 2]}),
              Case("transpose", {"X": nrm(2, 3, 4)}, {"axis": [2, 0, 1]}),
              Case("transpose2", {"X": nrm(2, 3, 4)}, {"axis": [1, 0, 2]}),
              Case("flatten", {"X": nrm(2, 3, 4)}, {"axis": 2}),
              Case("flatten2", {"X": nrm(2, 3, 4)}, {"axis": 1}),
              Case("flatten_contiguous_range", {"X": nrm(2, 3, 4, 5)},
                   {"start_axis": 1, "stop_axis": 2}),
              Case("squeeze", {"X": nrm(2, 1, 4, 1)}, {"axes": [1, -1]}),
              Case("squeeze2", {"X": nrm(1, 3, 1)}),
              Case("unsqueeze", {"X": nrm(3, 4)}, {"axes": [0, 2]}),
              Case("unsqueeze2", {"X": nrm(3, 4)}, {"axes": [1]}),
              Case("concat", {"X": [nrm(2, 3), nrm(2, 5, seed=1)]},
                   {"axis": 1}),
              Case("split", {"X": nrm(6, 4)}, {"axis": 0, "num": 3},
                   outs=("Out*3",)),
              Case("split", {"X": nrm(4, 7)}, {"axis": 1,
                                              "sections": [2, 4, 1]},
                   outs=("Out*3",), label="split[sections]"),
              Case("stack", {"X": [nrm(2, 3), nrm(2, 3, seed=1)]},
                   {"axis": 1}, outs=("Y",)),
              Case("slice", {"Input": nrm(4, 5, 6)},
                   {"axes": [0, 2], "starts": [1, -4], "ends": [3, 100],
                    "decrease_axis": [0]}, label="slice[decrease_size2]"),
              Case("slice", {"Input": nrm(4, 5, 6)},
                   {"axes": [0, 2], "starts": [1, -4], "ends": [2, 100],
                    "decrease_axis": [0]}),
              Case("gather", {"X": nrm(5, 3), "Index": i32([4, 0, 2])}),
              Case("gather_nd", {"X": nrm(3, 4, 2),
                                 "Index": i32([[0, 1], [2, 3]])}),
              Case("scatter", {"X": nrm(5, 3), "Ids": i32([1, 3]),
                               "Updates": nrm(2, 3, seed=1)}),
              Case("expand_v2", {"X": nrm(3, 1)}, {"shape": [-1, 4]}),
              Case("tile", {"X": nrm(2, 3)}, {"repeat_times": [2, 1, 2]}),
              Case("cumsum", {"X": nrm(3, 4)},
                   {"axis": 1, "exclusive": True, "reverse": True}),
              Case("arg_max", {"X": nrm(3, 4)}, {"axis": 1,
                                                 "keepdims": True}),
              Case("top_k", {"X": _tied(r, (3, 6))}, {"k": 3},
                   outs=("Out", "Indices")),
              Case("top_k_v2", {"X": _tied(r, (3, 6))}, {"k": 2},
                   outs=("Out", "Indices")),
              Case("argsort", {"X": _tied(r, (3, 6))},
                   {"axis": 1, "descending": True},
                   outs=("Out", "Indices")),
              Case("where", {"Condition": b1, "X": nrm(3, 4),
                             "Y": nrm(3, 4, seed=1)}),
              Case("one_hot", {"X": i64([[1], [3], [0]])}, {"depth": 4}),
              Case("one_hot_v2", {"X": i64([1, 3, 0])}, {"depth": 4}),
              Case("pixel_shuffle", {"X": nrm(1, 8, 2, 3)},
                   {"upscale_factor": 2}),
              Case("range", {"Start": f32([1.0]), "End": f32([4.0]),
                             "Step": f32([0.5])})]
    for red in ("reduce_max", "reduce_min", "reduce_prod", "reduce_sum",
                "reduce_mean"):
        cases.append(Case(red, {"X": nrm(2, 3, 4)},
                          {"dim": [0, -1], "keep_dim": True}))
    for red in ("reduce_all", "reduce_any"):
        cases.append(Case(red, {"X": np.asarray(r.integers(0, 2, (3, 4)),
                                                bool)}, {"dim": [1]}))
    cases += [Case("p_norm", {"X": nrm(3, 4)}, {"porder": 3.0, "axis": 1}),
              Case("norm", {"X": nrm(3, 4)}, {"axis": 1},
                   outs=("Out", "Norm")),
              Case("accuracy", {"Indices": i64([[1, 0], [2, 1], [0, 2]]),
                                "Label": i64([[1], [1], [2]])},
                   outs=("Accuracy", "Correct", "Total")),
              Case("sigmoid_cross_entropy_with_logits",
                   {"X": nrm(3, 4), "Label": f32(r.integers(0, 2, (3, 4)))},
                   {"normalize": True}),
              Case("softmax_with_cross_entropy",
                   {"Logits": nrm(3, 5), "Label": i64([[1], [4], [0]])},
                   outs=("Softmax", "Loss")),
              Case("cross_entropy", {"X": f32(np.full((3, 4), 0.25)),
                                     "Label": i64([[1], [3], [0]])},
                   outs=("Y",)),
              Case("cross_entropy2", {"X": pos(2, 3, 4) / 4,
                                      "Label": i64([[1, 3, 0], [2, 2, 1]])},
                   outs=("Y",)),
              Case("lookup_table", {"W": nrm(6, 3),
                                    "Ids": i64([[1], [5], [0]])},
                   {"padding_idx": 5}),
              Case("lookup_table_v2", {"W": nrm(6, 3), "Ids": i64([1, 5])},
                   {"padding_idx": -1}),
              Case("layer_norm", {"X": nrm(2, 3, 4), "Scale": nrm(12, seed=1),
                                  "Bias": nrm(12, seed=2)},
                   {"begin_norm_axis": 1, "epsilon": 1e-5},
                   outs=("Y",)),
              Case("group_norm", {"X": nrm(2, 4, 3, 3), "Scale": nrm(4),
                                  "Bias": nrm(4, seed=1)}, {"groups": 2},
                   outs=("Y",)),
              Case("instance_norm", {"X": nrm(2, 3, 4, 4),
                                     "Scale": nrm(3), "Bias": nrm(3)},
                   outs=("Y",))]
    bn = {"X": nrm(2, 3, 4, 4), "Scale": nrm(3), "Bias": nrm(3, seed=1),
          "Mean": nrm(3, seed=2), "Variance": pos(3)}
    cases += [Case("batch_norm", bn, {"epsilon": 1e-5, "is_test": True},
                   outs=("Y",)),
              Case("sync_batch_norm", bn, {"is_test": True}, outs=("Y",))]
    conv = {"Input": nrm(1, 4, 6, 6), "Filter": nrm(4, 1, 3, 3, seed=1)}
    cases += [Case("depthwise_conv2d", conv,
                   {"strides": [1, 1], "paddings": [1, 1], "groups": 4},
                   outs=("Output",)),
              Case("conv2d_transpose", {"Input": nrm(1, 3, 4, 4),
                                        "Filter": nrm(3, 2, 3, 3, seed=1)},
                   {"strides": [2, 2], "paddings": [1, 1]},
                   outs=("Output",)),
              Case("pool2d", {"X": nrm(1, 2, 6, 6)},
                   {"pooling_type": "avg", "ksize": [3, 3],
                    "strides": [2, 2], "paddings": [1, 1],
                    "exclusive": False}),
              Case("pool2d", {"X": nrm(1, 2, 6, 6)},
                   {"pooling_type": "max", "ksize": [2, 2],
                    "strides": [2, 2]}, label="pool2d[max]"),
              Case("pool2d", {"X": nrm(1, 2, 6, 6)},
                   {"pooling_type": "avg", "ksize": [1, 1],
                    "global_pooling": True}, label="pool2d[global]"),
              Case("pad2d", {"X": nrm(1, 2, 3, 4)},
                   {"paddings": [1, 0, 2, 1], "mode": "reflect"}),
              Case("pad3d", {"X": nrm(1, 1, 2, 3, 4)},
                   {"paddings": [1, 1, 0, 1, 1, 0], "mode": "constant",
                    "value": 0.5}),
              Case("nearest_interp", {"X": nrm(1, 2, 3, 4)},
                   {"out_h": 6, "out_w": 7}),
              Case("nearest_interp_v2", {"X": nrm(1, 2, 6, 4)},
                   {"out_h": 3, "out_w": 8}),
              Case("bilinear_interp", {"X": nrm(1, 2, 3, 4)},
                   {"out_h": 6, "out_w": 8}),
              Case("bilinear_interp_v2", {"X": nrm(1, 2, 8, 6)},
                   {"out_h": 3, "out_w": 4}),
              Case("bicubic_interp", {"X": nrm(1, 2, 4, 4)},
                   {"out_h": 7, "out_w": 5}),
              Case("linear_interp", {"X": nrm(1, 2, 5)}, {"out_w": 9}),
              Case("trilinear_interp", {"X": nrm(1, 1, 2, 3, 3)},
                   {"out_d": 3, "out_h": 5, "out_w": 2}),
              Case("grid_sampler", {"X": nrm(1, 2, 4, 5),
                                    "Grid": f32(r.uniform(-1, 1,
                                                          (1, 3, 3, 2)))},
                   outs=("Output",))]
    # random ops: shapes and dtypes only
    cases += [Case("uniform_random", {}, {"shape": [3, 4], "min": -2.0,
                                          "max": 1.0, "seed": 3,
                                          "dtype": 5}),
              Case("gaussian_random", {}, {"shape": [2, 5], "mean": 1.0,
                                           "std": 0.5, "seed": 4,
                                           "dtype": 5}),
              Case("pyramid_hash", {"X": i32(r.integers(0, 3000, (2, 6))),
                                    "W": nrm(54)},
                   {"num_emb": 8, "space_len": 50, "pyramid_layer": 3,
                    "rand_len": 4}, outs=("Out", "DropPos"))]
    # optimizers
    p, g = nrm(3, 4), nrm(3, 4, seed=1)
    cases += [Case("sgd", {"Param": p, "Grad": g,
                           "LearningRate": f32([0.1])}, outs=("ParamOut",)),
              Case("momentum", {"Param": p, "Grad": g, "Velocity": nrm(3, 4),
                                "LearningRate": f32([0.1])},
                   {"mu": 0.8, "use_nesterov": True},
                   outs=("ParamOut", "VelocityOut"))]
    # LoD family
    x3 = nrm(3, 4, 2)
    lens = i32([4, 2, 3])
    cases += [Case("sequence_pool", {"X": x3}, {"pooltype": "MAX"},
                   lods={"X": lens}),
              Case("sequence_softmax", {"X": nrm(3, 4)}, lods={"X": lens}),
              Case("sequence_reverse", {"X": x3}, lods={"X": lens},
                   outs=("Y",)),
              Case("sequence_pad", {"X": x3}, {"padded_length": 5},
                   lods={"X": lens}, outs=("Out", "Length")),
              Case("sequence_mask", {"X": i64([3, 1, 4])}, {"maxlen": 5},
                   outs=("Y",)),
              Case("lod_reset", {"X": nrm(3, 4)}, {"target_lod": [0, 1, 3]}),
              Case("split_lod_tensor", {"X": x3, "Mask": i32([1, 0, 1])},
                   lods={"X": lens}, outs=("OutTrue", "OutFalse")),
              Case("merge_lod_tensor", {"InTrue": x3,
                                        "InFalse": nrm(3, 4, 2, seed=1),
                                        "Mask": i32([1, 0, 1])},
                   outs=("Out",)),
              Case("merge_lod_tensor_infer", {"InTrue": x3,
                                              "InFalse": nrm(3, 4, 2,
                                                             seed=1),
                                              "Mask": i32([0, 0, 1])}),
              Case("lod_rank_table", {"X": x3}, lods={"X": lens}),
              Case("shrink_rnn_memory", {"X": nrm(3, 4)}),
              Case("select_output", {"X": nrm(3), "Mask": i32([1])},
                   outs=("Out*2",)),
              Case("select_input", {"X": [nrm(3), nrm(3, seed=1)],
                                    "Mask": i32([1])})]
    # RNN family
    cases += [Case("lstm", {"Input": nrm(2, 3, 8), "Weight": nrm(2, 8),
                            "Bias": nrm(1, 14, seed=1)},
                   {"use_peepholes": True}, outs=("Hidden", "Cell")),
              Case("gru", {"Input": nrm(2, 3, 6), "Weight": nrm(2, 6),
                           "Bias": nrm(1, 6, seed=1)},
                   {"origin_mode": True}, outs=("Hidden",)),
              Case("gru_unit", {"Input": nrm(2, 6), "HiddenPrev": nrm(2, 2),
                                "Weight": nrm(2, 6, seed=1)},
                   outs=("Hidden", "Gate", "ResetHiddenPrev")),
              Case("lstm_unit", {"X": nrm(2, 8), "C_prev": nrm(2, 2)},
                   {"forget_bias": 0.5}, outs=("C", "H"))]
    # vision / detection
    cases += [Case("roi_align", {"X": nrm(1, 2, 8, 8),
                                 "ROIs": _boxes(r, 3, 8.0, 0.2)},
                   {"pooled_height": 2, "pooled_width": 2,
                    "sampling_ratio": 2}),
              Case("box_coder", {"PriorBox": _boxes(r, 4),
                                 "PriorBoxVar": f32(np.full((4, 4), 0.1)),
                                 "TargetBox": _boxes(r, 3)},
                   {"code_type": "encode_center_size"},
                   outs=("OutputBox",)),
              Case("prior_box", {"Input": nrm(1, 4, 3, 4),
                                 "Image": nrm(1, 3, 24, 32)},
                   {"min_sizes": [8.0], "max_sizes": [16.0],
                    "aspect_ratios": [1.0, 2.0], "flip": True},
                   outs=("Boxes", "Variances")),
              Case("yolo_box", {"X": nrm(1, 2 * 7, 3, 3),
                                "ImgSize": i32([[96, 96]])},
                   {"anchors": [10, 13, 16, 30], "class_num": 2,
                    "conf_thresh": 0.01, "downsample_ratio": 32},
                   outs=("Boxes", "Scores"))]
    nb = np.stack([_boxes(r, 12) for _ in range(2)])
    ns = _tied(r, (2, 3, 12))
    for t in ("multiclass_nms", "multiclass_nms2", "multiclass_nms3"):
        outs = ("Out", "NmsRoisNum") if t == "multiclass_nms" else \
            ("Out", "Index", "NmsRoisNum")
        cases.append(Case(t, {"BBoxes": nb, "Scores": ns},
                          {"score_threshold": 0.15, "nms_top_k": 8,
                           "keep_top_k": 10}, outs=outs))
    anchors = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90,
               156, 198, 373, 326]
    gt = np.concatenate([r.uniform(0.05, 0.95, (2, 5, 2)),
                         r.uniform(0.05, 0.6, (2, 5, 2))], -1)
    gt[:, -2:] = 0.0
    cases += [Case("yolov3_loss", {"X": nrm(2, 24, 4, 4), "GTBox": f32(gt),
                                   "GTLabel": i32(r.integers(0, 3, (2, 5)))},
                   {"class_num": 3, "anchors": anchors,
                    "anchor_mask": [6, 7, 8], "downsample_ratio": 32,
                    "ignore_thresh": 0.5}, outs=("Loss",)),
              Case("box_decoder_and_assign",
                   {"PriorBox": _boxes(r, 5, 40.0),
                    "PriorBoxVar": f32([0.1, 0.1, 0.2, 0.2]),
                    "TargetBox": f32(r.normal(0, 0.5, (5, 12))),
                    "BoxScore": f32(r.uniform(0, 1, (5, 3)))},
                   outs=("DecodeBox", "OutputAssignBox")),
              Case("collect_fpn_proposals",
                   {"MultiLevelRois": [_boxes(r, 6, 50.0),
                                       _boxes(r, 5, 50.0)],
                    "MultiLevelScores": [_tied(r, (6, 1)),
                                         _tied(r, (5, 1))]},
                   {"post_nms_topN": 7}, outs=("FpnRois",)),
              Case("distribute_fpn_proposals",
                   {"FpnRois": f32(np.concatenate([
                       _boxes(r, 6, 300.0, 0.05),
                       _boxes(r, 6, 900.0, 0.2)]))},
                   {"min_level": 2, "max_level": 5, "refer_level": 4,
                    "refer_scale": 224},
                   outs=("MultiFpnRois*4", "RestoreIndex",
                         "MultiLevelRoIsNum*4")),
              Case("retinanet_detection_output",
                   {"BBoxes": [f32(r.normal(0, 0.3, (1, 8, 4))),
                               f32(r.normal(0, 0.3, (1, 6, 4)))],
                    "Scores": [_tied(r, (1, 8, 3)), _tied(r, (1, 6, 3))],
                    "Anchors": [_boxes(r, 8, 60.0, 0.1),
                                _boxes(r, 6, 60.0, 0.2)],
                    "ImInfo": f32([64, 72, 1.0])},
                   {"score_threshold": 0.2, "nms_top_k": 5,
                    "keep_top_k": 7}),
              Case("correlation", {"Input1": nrm(1, 2, 6, 6),
                                   "Input2": nrm(1, 2, 6, 6, seed=1)},
                   {"pad_size": 2, "kernel_size": 1,
                    "max_displacement": 2, "stride1": 1, "stride2": 1},
                   outs=("Output",)),
              Case("bilateral_slice", {"X": nrm(2, 2, 6, 7),
                                       "Grid": nrm(2, 6, 4, 3, 3, seed=1),
                                       "Guide": f32(r.uniform(0, 1,
                                                              (2, 6, 7)))},
                   {"has_offset": True}),
              Case("deformable_conv_v1",
                   {"Input": nrm(1, 2, 5, 5),
                    "Offset": f32(r.normal(0, 0.5, (1, 18, 5, 5))),
                    "Filter": nrm(3, 2, 3, 3, seed=1)},
                   {"strides": [1, 1], "paddings": [1, 1],
                    "dilations": [1, 1], "groups": 1,
                    "deformable_groups": 1}, outs=("Output",)),
              Case("deformable_psroi_pooling",
                   {"Input": nrm(1, 8, 10, 10), "ROIs": _boxes(r, 3, 18.0),
                    "Trans": f32(r.normal(0, 0.5, (3, 2, 2, 2)))},
                   {"spatial_scale": 0.5, "output_dim": 2,
                    "pooled_height": 2, "pooled_width": 2,
                    "part_size": [2, 2], "sample_per_part": 2},
                   outs=("Output",)),
              Case("mine_hard_examples",
                   {"ClsLoss": _tied(r, (2, 8)),
                    "MatchIndices": i32([[0, -1, -1, 1, -1, -1, -1, -1],
                                         [-1, -1, 2, -1, -1, -1, -1, -1]]),
                    "MatchDist": f32(r.uniform(0, 1, (2, 8)))},
                   {"neg_pos_ratio": 2.0, "neg_dist_threshold": 0.7},
                   outs=("NegIndices", "UpdatedMatchIndices")),
              Case("roi_perspective_transform",
                   {"X": nrm(1, 2, 10, 12), "ROIs": _quads(r, 3, 10, 12)},
                   {"transformed_height": 4, "transformed_width": 5},
                   outs=("Out", "Mask"))]
    anchor = _boxes(r, 24, 64.0, 0.1)
    gtb = np.stack([_boxes(r, 3, 64.0, 0.2) for _ in range(2)])
    crowd = i32([[0, 0, 1], [0, 0, 0]])
    im = f32([[64, 64, 1.0], [60, 56, 1.0]])
    cases += [Case("rpn_target_assign",
                   {"Anchor": anchor, "GtBoxes": gtb, "IsCrowd": crowd,
                    "ImInfo": im},
                   {"rpn_batch_size_per_im": 8, "rpn_positive_overlap": 0.5,
                    "rpn_negative_overlap": 0.3},
                   outs=("LocationIndex", "ScoreIndex", "TargetBBox",
                         "TargetLabel", "BBoxInsideWeight")),
              Case("retinanet_target_assign",
                   {"Anchor": anchor, "GtBoxes": gtb,
                    "GtLabels": i32([[1, 2, 3], [4, 5, 6]]),
                    "IsCrowd": crowd, "ImInfo": im},
                   outs=("LocationIndex", "ScoreIndex", "TargetBBox",
                         "TargetLabel", "BBoxInsideWeight",
                         "ForegroundNumber")),
              Case("generate_proposal_labels",
                   {"RpnRois": np.stack([_boxes(r, 6, 60.0, 0.1)
                                         for _ in range(2)]),
                    "GtClasses": i32([[1, 2, 3], [2, 1, 0]]),
                    "IsCrowd": i32([[0, 1, 0], [0, 0, 0]]),
                    "GtBoxes": np.stack([_boxes(r, 3, 60.0, 0.2)
                                         for _ in range(2)]),
                    "ImInfo": f32([[64, 64, 1.0], [64, 64, 2.0]])},
                   {"batch_size_per_im": 8, "fg_thresh": 0.3,
                    "bg_thresh_hi": 0.3, "class_nums": 4},
                   outs=("Rois", "LabelsInt32", "BboxTargets",
                         "BboxInsideWeights", "BboxOutsideWeights")),
              Case("generate_mask_labels",
                   {"ImInfo": f32([[32, 32, 1.0]]),
                    "GtClasses": i32([[1, 2]]), "IsCrowd": i32([[0, 0]]),
                    "GtSegms": f32([[[[[2, 2], [14, 3], [13, 15], [3, 12]]],
                                     [[[16, 16], [30, 17], [28, 30],
                                       [15, 29]]]]]),
                    "Rois": f32([[[1, 1, 15, 15], [15, 15, 31, 31],
                                  [0, 0, 8, 8]]]),
                    "LabelsInt32": i32([[1, 2, 0]])},
                   {"num_classes": 3, "resolution": 4},
                   outs=("MaskRois", "RoiHasMaskInt32", "MaskInt32"))]
    a, h, w = 3, 4, 5
    cy, cx = np.meshgrid(np.arange(h) * 16.0, np.arange(w) * 16.0,
                         indexing="ij")
    size = np.asarray([16.0, 24.0, 32.0])
    anc = np.stack([cx[..., None] - size / 2, cy[..., None] - size / 2,
                    cx[..., None] + size / 2, cy[..., None] + size / 2], -1)
    cases += [Case("generate_proposals_v2",
                   {"Scores": _tied(r, (2, a, h, w)),
                    "BboxDeltas": f32(r.normal(0, 0.3, (2, 4 * a, h, w))),
                    "ImShape": f32([[64, 80], [60, 70]]),
                    "Anchors": f32(anc),
                    "Variances": f32(np.broadcast_to([0.1, 0.1, 0.2, 0.2],
                                                     anc.shape))},
                   {"pre_nms_topN": 30, "post_nms_topN": 10,
                    "nms_thresh": 0.5, "min_size": 2.0},
                   outs=("RpnRois", "RpnRoiProbs", "RpnRoisNum"))]
    # sequence / industrial
    tags = r.integers(0, 6, (6, 3)).astype(np.int32)
    tags[1] = -1
    tags[4, 1:] = -1
    cases += [Case("linear_chain_crf",
                   {"Emission": nrm(3, 6, 4), "Transition": nrm(6, 4),
                    "Label": i32(r.integers(0, 4, (3, 6))),
                    "Length": i32([6, 1, 4])}, outs=("LogLikelihood",)),
              Case("match_matrix_tensor",
                   {"X": nrm(2, 3, 4), "Y": nrm(2, 5, 4, seed=1),
                    "W": nrm(4, 2, 4, seed=2)}, {"dim_t": 2}),
              Case("var_conv_2d", {"X": nrm(2, 2, 6, 7),
                                   "W": nrm(3, 2 * 3 * 2, seed=1),
                                   "ROW": i32([6, 3]),
                                   "COLUMN": i32([4, 7])},
                   {"InputChannel": 2, "OutputChannel": 3, "KernelH": 3,
                    "KernelW": 2, "StrideH": 1, "StrideW": 1}),
              Case("filter_by_instag", {"Ins": nrm(6, 3), "Ins_tag": tags,
                                        "Filter_tag": i32([2, 5])},
                   {"out_val_if_empty": -7},
                   outs=("Out", "LossWeight", "IndexMap")),
              Case("fake_channel_wise_quantize_dequantize_abs_max",
                   {"X": nrm(3, 4)}, {"quant_axis": 1, "bit_length": 8},
                   outs=("Out", "OutScale")),
              Case("partial_concat", {"X": [nrm(2, 5), nrm(2, 5, seed=1)]},
                   {"start_index": 1, "length": 3}),
              Case("partial_sum", {"X": [nrm(2, 5), nrm(2, 5, seed=1)]},
                   {"start_index": -3, "length": 2}),
              Case("reorder_lod_tensor_by_rank",
                   {"X": nrm(3, 2),
                    "RankTable": ("RT", i32([1, 2, 0]), i32([2, 4, 3]),
                                  4)})]
    # collective, bootstrap and sync ops outside any group: identity /
    # no-op semantics, as in the JAX package
    for t in ("c_allgather", "c_concat", "c_reduce_max", "c_reduce_min",
              "c_reduce_prod", "c_reducescatter", "c_scatter", "c_split",
              "mp_allreduce_sum", "alltoall", "c_allreduce_sum",
              "c_allreduce_max", "c_allreduce_min", "c_allreduce_prod",
              "c_reduce_sum", "c_broadcast", "broadcast", "allreduce",
              "c_identity", "barrier"):
        cases.append(Case(t, {"X": nrm(4, 6)}, {"ring_id": 0, "nranks": 1}))
    cases += [Case("c_embedding", {"W": nrm(5, 3), "Ids": i64([1, 7, 4])},
                   {"start_index": 2}),
              Case("c_softmax_with_cross_entropy",
                   {"Logits": nrm(3, 5), "Label": i64([[1], [4], [0]])},
                   outs=("Softmax", "Loss"))]
    for t in ("c_gen_nccl_id", "c_gen_bkcl_id", "c_gen_hccl_id"):
        cases.append(Case(t, {}, {}))
    for t in ("gen_nccl_id", "gen_bkcl_id", "gen_hccl_id"):
        cases.append(Case(t, {}, {}, outs=("NCCLID",)))
    for t in ("c_comm_init", "c_comm_init_all", "c_comm_init_hccl",
              "c_comm_init_multitrainer", "comm_init", "marker"):
        cases.append(Case(t, {"X": i32([0])}, {}, outs=()))
    for t in ("c_sync_calc_stream", "c_sync_comm_stream", "c_wait_comm",
              "c_wait_compute"):
        cases.append(Case(t, {"X": [nrm(3), nrm(2, seed=1)]}, {},
                          outs=("Out*2",)))
    cases += [Case("assert", {"Cond": np.asarray([True])}, {}, outs=()),
              Case("conditional_block_infer",
                   {"Cond": np.asarray([True]), "Input": [nrm(3)]},
                   {"is_scalar_condition": True, "sub_block": 1},
                   outs=("Out",),
                   sub=[("scale", {"X": "input_0"}, {"Out": "out_out_0"},
                         {"scale": 2.0})])]
    return cases


def _quads(r, n, h, w):
    cx, cy = r.uniform(w * 0.3, w * 0.7, n), r.uniform(h * 0.3, h * 0.7, n)
    dx, dy = r.uniform(2, w * 0.3, n), r.uniform(2, h * 0.3, n)
    j = r.uniform(-0.5, 0.5, (n, 8))
    q = np.stack([cx - dx, cy - dy, cx + dx, cy - dy, cx + dx, cy + dy,
                  cx - dx, cy + dy], 1) + j
    return f32(q)
