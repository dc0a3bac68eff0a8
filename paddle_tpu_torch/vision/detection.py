"""The detection long tail (counterpart: paddle_tpu/vision/detection.py):
the RPN, FPN, RCNN, RetinaNet and YOLOv3 families, position-sensitive
and precise ROI pooling.

Python over torch ops, with the JAX package's static shapes: padded
outputs and valid counts in place of Paddle's LoD outputs, selections as
sorts and masks, every image of a batch at once (JAX's ``vmap``).
`yolov3_loss` reproduces the JAX package's scatter on the CPU: where
several ground-truth rows land on one cell (a real box and the padded
rows, which map to cell (0, 0) and anchor 0), the last row in order
writes the objectness target, on any device.  ``use_random=True`` in
`rpn_target_assign` draws from torch's generator (the JAX package's
stream is ``jax.random``'s).
"""
from __future__ import annotations

import numpy as np
import torch

from .ops import (_div, _nms_keep_mask, _pairwise_iou, _roi_batch_ids, _t,
                  _take_rows, _topk)

__all__ = [
    "psroi_pool", "prroi_pool", "deformable_psroi_pooling",
    "generate_proposals", "generate_proposals_v2",
    "distribute_fpn_proposals", "collect_fpn_proposals",
    "box_decoder_and_assign", "retinanet_detection_output",
    "locality_aware_nms", "density_prior_box", "yolov3_loss",
    "multiclass_nms2", "multiclass_nms3",
    "target_assign", "mine_hard_examples", "rpn_target_assign",
    "retinanet_target_assign", "polygon_box_transform",
    "generate_proposal_labels", "roi_perspective_transform",
    "generate_mask_labels",
]

_NINF = float("-inf")


def _ninf_like(x):
    return torch.full_like(x, _NINF)


# ---------------------------------------------------------------------------
# position-sensitive and precise ROI pooling
# ---------------------------------------------------------------------------
def psroi_pool(x, boxes, boxes_num, output_channels, spatial_scale,
               pooled_height, pooled_width, name=None):
    """Position-sensitive ROI average pooling: input channel
    ``(c * PH + ph) * PW + pw`` feeds output [c, ph, pw]; integer bins
    from ``round(coord) * scale`` edges; an empty bin is 0."""
    PH, PW, C = int(pooled_height), int(pooled_width), int(output_channels)
    n, in_c, h, w = x.shape
    if in_c != C * PH * PW:
        raise ValueError(
            f"psroi_pool: input channels {in_c} != output_channels*"
            f"pooled_height*pooled_width = {C * PH * PW}")
    rois = _t(boxes, x)
    batch = _roi_batch_ids(boxes_num, rois.shape[0], x)

    def cround(v):
        return torch.sign(v) * torch.floor(torch.abs(v) + 0.5)

    x1 = cround(rois[:, 0]) * spatial_scale
    y1 = cround(rois[:, 1]) * spatial_scale
    x2 = (cround(rois[:, 2]) + 1.0) * spatial_scale
    y2 = (cround(rois[:, 3]) + 1.0) * spatial_scale
    bh = _div(torch.clamp(y2 - y1, min=0.1), PH)
    bw = _div(torch.clamp(x2 - x1, min=0.1), PW)
    dev = x.device
    ph = torch.arange(PH, dtype=torch.float32, device=dev)
    pw = torch.arange(PW, dtype=torch.float32, device=dev)
    hs = torch.clamp(torch.floor(ph[None] * bh[:, None] + y1[:, None]), 0, h)
    he = torch.clamp(torch.ceil((ph[None] + 1) * bh[:, None] + y1[:, None]),
                     0, h)
    ws = torch.clamp(torch.floor(pw[None] * bw[:, None] + x1[:, None]), 0, w)
    we = torch.clamp(torch.ceil((pw[None] + 1) * bw[:, None] + x1[:, None]),
                     0, w)
    hidx = torch.arange(h, dtype=torch.float32, device=dev)
    widx = torch.arange(w, dtype=torch.float32, device=dev)
    rm = ((hidx >= hs[..., None]) & (hidx < he[..., None])).to(x.dtype)
    cm = ((widx >= ws[..., None]) & (widx < we[..., None])).to(x.dtype)
    xg = x[batch].reshape(-1, C, PH, PW, h, w)
    sums = torch.einsum("rih,rcijhw,rjw->rcij", rm, xg, cm)
    area = rm.sum(-1)[:, None, :, None] * cm.sum(-1)[:, None, None, :]
    return torch.where(area > 0, sums / torch.clamp(area, min=1.0),
                       torch.zeros_like(sums))


def _tri_integral(lo, hi, n):
    """The integral over [lo, hi] of max(0, 1 - |t - i|) for each integer
    i in [0, n): PrRoI pooling's exact weight of a pixel, from the
    triangle kernel's antiderivative."""
    idx = torch.arange(n, dtype=torch.float32, device=lo.device)

    def T(t):
        t = torch.clamp(t, -1.0, 1.0)
        return torch.where(t < 0, (t + 1.0) ** 2 / 2.0,
                           0.5 + t - t * t / 2.0)

    return T(hi[..., None] - idx) - T(lo[..., None] - idx)


def prroi_pool(x, boxes, boxes_num, pooled_height, pooled_width,
               spatial_scale=1.0, name=None):
    """Precise ROI pooling: the exact integral of the bilinearly
    interpolated feature over each bin over the bin's area, as a
    separable triangle-kernel integral (differentiable in the features
    and the coordinates)."""
    PH, PW = int(pooled_height), int(pooled_width)
    n, c, h, w = x.shape
    rois = _t(boxes, x)
    batch = _roi_batch_ids(boxes_num, rois.shape[0], x)
    x1 = rois[:, 0] * spatial_scale
    y1 = rois[:, 1] * spatial_scale
    bw = _div(torch.clamp(rois[:, 2] * spatial_scale - x1, min=0.0), PW)
    bh = _div(torch.clamp(rois[:, 3] * spatial_scale - y1, min=0.0), PH)
    dev = x.device
    ph = torch.arange(PH, dtype=torch.float32, device=dev)
    pw = torch.arange(PW, dtype=torch.float32, device=dev)
    gh = _tri_integral(y1[:, None] + ph[None] * bh[:, None],
                       y1[:, None] + (ph[None] + 1) * bh[:, None], h)
    gw = _tri_integral(x1[:, None] + pw[None] * bw[:, None],
                       x1[:, None] + (pw[None] + 1) * bw[:, None], w)
    area = torch.clamp(bh * bw, min=1e-9)[:, None, None, None]
    return torch.einsum("rih,rchw,rjw->rcij", gh, x[batch], gw) / area


def deformable_psroi_pooling(x, rois, trans, rois_num=None, no_trans=False,
                             spatial_scale=1.0, output_channels=None,
                             group_size=1, pooled_height=1, pooled_width=1,
                             part_size=None, sample_per_part=4,
                             trans_std=0.1, name=None):
    """Deformable position-sensitive ROI pooling: psroi bins shifted by
    the normalised offsets ``trans`` [R, 2, part_h, part_w], each the
    mean of its ``sample_per_part``^2 bilinear samples inside the map."""
    PH, PW = int(pooled_height), int(pooled_width)
    S = int(sample_per_part)
    part = int(part_size or PH)
    n, in_c, h, w = x.shape
    C = int(output_channels or in_c // (PH * PW))
    roi = _t(rois, x)
    R = roi.shape[0]
    if rois_num is None:
        rois_num = torch.tensor([R], dtype=torch.int32)
    batch = _roi_batch_ids(rois_num, R, x)
    x1 = roi[:, 0] * spatial_scale - 0.5
    y1 = roi[:, 1] * spatial_scale - 0.5
    x2 = (roi[:, 2] + 1.0) * spatial_scale - 0.5
    y2 = (roi[:, 3] + 1.0) * spatial_scale - 0.5
    rw = torch.clamp(x2 - x1, min=0.1)
    rh = torch.clamp(y2 - y1, min=0.1)
    bh, bw = _div(rh, PH), _div(rw, PW)
    sub_h, sub_w = _div(bh, S), _div(bw, S)
    dev = x.device
    ph = torch.arange(PH, device=dev)
    pw = torch.arange(PW, device=dev)
    part_h = torch.floor(ph.float() / PH * part).long()
    part_w = torch.floor(pw.float() / PW * part).long()
    if no_trans:
        off_h = x.new_zeros((R, PH, PW))
        off_w = x.new_zeros((R, PH, PW))
    else:
        t = _t(trans, x)
        t = t[:, :, part_h[:, None], part_w[None, :]]  # [R, 2, PH, PW]
        off_h = t[:, 0] * trans_std * rh[:, None, None]
        off_w = t[:, 1] * trans_std * rw[:, None, None]
    ar = torch.arange(S, device=dev)
    sy = (y1[:, None, None, None, None]
          + ph[None, :, None, None, None] * bh[:, None, None, None, None]
          + off_h[:, :, :, None, None]
          + (ar[None, None, None, :, None] + 0.5)
          * sub_h[:, None, None, None, None])
    sx = (x1[:, None, None, None, None]
          + pw[None, None, :, None, None] * bw[:, None, None, None, None]
          + off_w[:, :, :, None, None]
          + (ar[None, None, None, None, :] + 0.5)
          * sub_w[:, None, None, None, None])  # [R, PH, PW, S, S]
    valid = (sy > -1.0) & (sy < h) & (sx > -1.0) & (sx < w)
    syc = torch.clamp(sy, 0.0, h - 1.0)
    sxc = torch.clamp(sx, 0.0, w - 1.0)
    y0 = torch.floor(syc).long()
    x0 = torch.floor(sxc).long()
    y1i = torch.clamp(y0 + 1, max=h - 1)
    x1i = torch.clamp(x0 + 1, max=w - 1)
    ly = (syc - y0)[:, None]
    lx = (sxc - x0)[:, None]
    img = x.reshape(n, C, PH, PW, h, w)
    bb = batch[:, None, None, None, None, None]
    cc = torch.arange(C, device=dev)[None, :, None, None, None, None]
    pp = ph[None, None, :, None, None, None]
    qq = pw[None, None, None, :, None, None]

    def gather(yy, xx):  # [R, C, PH, PW, S, S]
        return img[bb, cc, pp, qq, yy[:, None], xx[:, None]]

    v = (gather(y0, x0) * ((1 - ly) * (1 - lx))
         + gather(y0, x1i) * ((1 - ly) * lx)
         + gather(y1i, x0) * (ly * (1 - lx))
         + gather(y1i, x1i) * (ly * lx))
    v = torch.where(valid[:, None], v, torch.zeros_like(v))
    cnt = torch.clamp(valid.sum(dim=(-1, -2)), min=1)
    return v.sum(dim=(-1, -2)) / cnt[:, None]


# ---------------------------------------------------------------------------
# RPN proposals
# ---------------------------------------------------------------------------
def _decode_proposals(anchors, deltas, variances, offset):
    """generate_proposals' box coder: centre-size decode with per-anchor
    variances, dw/dh clipped at log(1000 / 16)."""
    clip = float(np.log(1000.0 / 16.0))
    aw = anchors[..., 2] - anchors[..., 0] + offset
    ah = anchors[..., 3] - anchors[..., 1] + offset
    acx = anchors[..., 0] + 0.5 * aw
    acy = anchors[..., 1] + 0.5 * ah
    dx, dy, dw, dh = deltas.unbind(-1)
    vx, vy, vw, vh = variances.unbind(-1)
    cx = acx + dx * vx * aw
    cy = acy + dy * vy * ah
    w = torch.exp(torch.clamp(dw * vw, max=clip)) * aw
    h = torch.exp(torch.clamp(dh * vh, max=clip)) * ah
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h,
                        cx + 0.5 * w - offset, cy + 0.5 * h - offset], -1)


def _clip_to(v, hi):
    return torch.minimum(torch.clamp(v, min=0), hi)


def generate_proposals(scores, bbox_deltas, img_size, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0,
                       pixel_offset=True, return_rois_num=True, name=None):
    """RPN proposals an image: the top ``pre_nms_top_n`` scores, decoded
    against anchors and variances, clipped, filtered by size, NMS, the
    top ``post_nms_top_n``.  Returns ([N, post, 4], [N, post], counts
    [N]); ``img_size`` rows are [H, W] (v2) or [H, W, scale] (v1)."""
    off = 1.0 if pixel_offset else 0.0
    sc = scores
    n, a_per, fh, fw = sc.shape
    imgs = _t(img_size, sc).float()
    anc = _t(anchors, sc).reshape(-1, 4)
    var = _t(variances, sc)
    var = var.reshape(-1, 4) if var.dim() > 2 else var
    if var.shape[0] != anc.shape[0]:
        var = var.expand(anc.shape)
    # scores [A, H, W] -> [H*W*A], the anchors' [H, W, A, 4] order
    s = sc.permute(0, 2, 3, 1).reshape(n, -1)
    d = _t(bbox_deltas, sc).reshape(n, a_per, 4, fh, fw).permute(
        0, 3, 4, 1, 2).reshape(n, -1, 4)
    A = s.shape[1]
    k = min(pre_nms_top_n if pre_nms_top_n > 0 else A, A)
    top_scores, idx = _topk(s, k)
    props = _decode_proposals(anc[idx], _take_rows(d, idx), var[idx], off)
    im_h, im_w = imgs[:, 0, None], imgs[:, 1, None]
    scale = imgs[:, 2, None] if imgs.shape[1] > 2 else 1.0
    props = torch.stack([_clip_to(props[..., 0], im_w - off),
                         _clip_to(props[..., 1], im_h - off),
                         _clip_to(props[..., 2], im_w - off),
                         _clip_to(props[..., 3], im_h - off)], -1)
    ms = max(min_size, 1.0) * scale
    ww = props[..., 2] - props[..., 0] + off
    hh = props[..., 3] - props[..., 1] + off
    cx = props[..., 0] + ww / 2.0
    cy = props[..., 1] + hh / 2.0
    valid = (ww >= ms) & (hh >= ms) & (cx <= im_w) & (cy <= im_h)
    sc_v = torch.where(valid, top_scores, _ninf_like(top_scores))
    keep = _nms_keep_mask(props, sc_v, nms_thresh, box_normalized=False) \
        & valid
    final = torch.where(keep, sc_v, _ninf_like(sc_v))
    out_sc, out_idx = _topk(final, min(post_nms_top_n, k))
    rois = _take_rows(props, out_idx)
    good = torch.isfinite(out_sc)
    rois = torch.where(good[..., None], rois, torch.zeros_like(rois))
    probs = torch.where(good, out_sc, torch.zeros_like(out_sc))
    counts = good.sum(1).to(torch.int32)
    if return_rois_num:
        return rois, probs, counts
    return rois, probs


def generate_proposals_v2(scores, bbox_deltas, img_size, anchors, variances,
                          **kwargs):
    """`generate_proposals` with im_shape = [H, W] and ``pixel_offset``."""
    return generate_proposals(scores, bbox_deltas, img_size, anchors,
                              variances, **kwargs)


# ---------------------------------------------------------------------------
# FPN proposal routing
# ---------------------------------------------------------------------------
def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, pixel_offset=True, rois_num=None,
                             name=None):
    """Each ROI to its FPN level, ``floor(log2(sqrt(area) / refer_scale
    + 1e-6)) + refer_level`` clipped to [min_level, max_level]: a padded
    [R, 4] a level (its ROIs first, in order), the restore index [R] and
    the counts a level."""
    off = 1.0 if pixel_offset else 0.0
    rois = fpn_rois
    R = rois.shape[0]
    w = torch.clamp(rois[:, 2] - rois[:, 0] + off, min=0.0)
    h = torch.clamp(rois[:, 3] - rois[:, 1] + off, min=0.0)
    lvl = torch.floor(torch.log2(_div(torch.sqrt(w * h), refer_scale)
                                  + 1e-6)) + refer_level
    lvl = torch.clamp(lvl, min_level, max_level).long()
    ar = torch.arange(R, device=rois.device)
    outs, counts, perms = [], [], []
    for L in range(min_level, max_level + 1):
        mask = lvl == L
        perm = torch.argsort(torch.where(mask, ar, R + ar), stable=True)
        outs.append(torch.where(mask[perm][:, None], rois[perm],
                                torch.zeros_like(rois)))
        counts.append(mask.sum().to(torch.int32))
        perms.append(perm)
    counts = torch.stack(counts)
    starts = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)[:-1]])
    restore = torch.zeros(R, dtype=torch.int32, device=rois.device)
    for li, L in enumerate(range(min_level, max_level + 1)):
        pos_in_level = torch.argsort(perms[li], stable=True)
        restore = torch.where(lvl == L, (starts[li] + pos_in_level).to(
            torch.int32), restore)
    return outs, restore, counts


def collect_fpn_proposals(multi_rois, multi_scores, min_level, max_level,
                          post_nms_top_n, rois_num_per_level=None,
                          name=None):
    """The levels' ROIs merged, the top ``post_nms_top_n`` by score:
    (rois [post, 4], scores, count).  ``rois_num_per_level`` (the valid
    counts a level) marks the padding; without it, scores <= 0 are
    padding."""
    like = multi_rois[0]
    rois = torch.cat([_t(r, like) for r in multi_rois], 0)
    scores = torch.cat([_t(s, like).reshape(-1) for s in multi_scores], 0)
    if rois_num_per_level is not None:
        valid = torch.cat([
            torch.arange(r.shape[0], device=like.device) < _t(cnt, like)
            for r, cnt in zip(multi_rois, rois_num_per_level)])
    else:
        valid = scores > 0.0
    scores = torch.where(valid, scores, _ninf_like(scores))
    sc, idx = _topk(scores, min(post_nms_top_n, scores.shape[0]))
    keep = sc > _NINF
    return (torch.where(keep[:, None], rois[idx], torch.zeros_like(
        rois[idx])), sc, keep.sum().to(torch.int32))


# ---------------------------------------------------------------------------
# decode and assign, RetinaNet's output, locality-aware NMS
# ---------------------------------------------------------------------------
def box_decoder_and_assign(prior_box, prior_box_var, target_box, box_score,
                           box_clip=4.135, name=None):
    """Per-class deltas decoded against the priors (variance-weighted,
    dw/dh clipped), and each ROI's box of its best class other than the
    background (the last column)."""
    prior = prior_box
    var, target, score = (_t(v, prior) for v in (prior_box_var, target_box,
                                                 box_score))
    R = prior.shape[0]
    C = target.shape[1] // 4
    pw = prior[:, 2] - prior[:, 0] + 1.0
    ph = prior[:, 3] - prior[:, 1] + 1.0
    pcx = prior[:, 0] + 0.5 * pw
    pcy = prior[:, 1] + 0.5 * ph
    t = target.reshape(R, C, 4)
    v = var.reshape(R if var.shape[0] == R else 1, -1)[:, :4].expand(R, 4)
    dx = t[..., 0] * v[:, None, 0]
    dy = t[..., 1] * v[:, None, 1]
    dw = torch.clamp(t[..., 2] * v[:, None, 2], -box_clip, box_clip)
    dh = torch.clamp(t[..., 3] * v[:, None, 3], -box_clip, box_clip)
    cx = dx * pw[:, None] + pcx[:, None]
    cy = dy * ph[:, None] + pcy[:, None]
    w = torch.exp(dw) * pw[:, None]
    h = torch.exp(dh) * ph[:, None]
    decoded = torch.stack([cx - 0.5 * w, cy - 0.5 * h,
                           cx + 0.5 * w - 1.0, cy + 0.5 * h - 1.0], -1)
    best = torch.argmax(score[:, :-1], dim=1)
    assigned = decoded[torch.arange(R, device=prior.device), best]
    return decoded.reshape(R, C * 4), assigned


def _class_rows(boxes, labels, vals, keep_top_k):
    """The top ``keep_top_k`` of the flat candidates ``vals`` (-inf for
    none): [K, 6] rows (label, score, box), zeros where invalid, and the
    valid count."""
    k = min(keep_top_k if keep_top_k > 0 else vals.shape[0], vals.shape[0])
    sc, idx = _topk(vals, k)
    good = torch.isfinite(sc)
    out = torch.cat([labels[idx][:, None],
                     torch.where(good, sc, torch.zeros_like(sc))[:, None],
                     torch.where(good[:, None], boxes[idx],
                                 torch.zeros_like(boxes[idx]))], 1)
    return out, good.sum().to(torch.int32)


def locality_aware_nms(bboxes, scores, score_threshold, nms_top_k,
                       keep_top_k, nms_threshold=0.3, normalized=True,
                       nms_eta=1.0, background_label=-1, name=None):
    """EAST's NMS: each box first merged with its overlapping neighbours
    by score-weighted averaging (one pass), then class-wise NMS and the
    global top ``keep_top_k``: ([K, 6], count)."""
    boxes = bboxes
    score = _t(scores, boxes)
    C, n = score.shape
    cls_ids = [c for c in range(C) if c != background_label]
    sc = score[cls_ids]  # [C', n]
    iou = _pairwise_iou(boxes, boxes, normalized)
    wmat = torch.where(iou[None] > nms_threshold, sc[:, None, :],
                       torch.zeros_like(sc[:, None, :]))
    wsum = wmat.sum(-1, keepdim=True)
    merged = torch.where(wsum > 0, (wmat @ boxes) / torch.clamp(
        wsum, min=1e-9), boxes)  # [C', n, 4]
    msc = torch.where(sc >= score_threshold, sc, _ninf_like(sc))
    k = min(nms_top_k if nms_top_k > 0 else n, n)
    top_sc, idx = _topk(msc, k)
    mb = _take_rows(merged, idx)
    keep = _nms_keep_mask(mb, top_sc, nms_threshold, normalized) \
        & torch.isfinite(top_sc)
    vals = torch.where(keep, top_sc, _ninf_like(top_sc))
    labels = torch.tensor(cls_ids, dtype=torch.float32,
                          device=boxes.device)[:, None].expand(-1, k)
    return _class_rows(mb.reshape(-1, 4), labels.reshape(-1),
                       vals.reshape(-1), keep_top_k)


def retinanet_detection_output(bboxes, scores, anchors, im_info,
                               score_threshold=0.05, nms_top_k=1000,
                               keep_top_k=100, nms_threshold=0.3,
                               nms_eta=1.0, name=None):
    """RetinaNet's output for one image: the top ``nms_top_k`` anchors a
    level by their best score, decoded (variance-free), clipped, merged
    over levels, class-wise NMS, the global top ``keep_top_k``: ([K, 6],
    count)."""
    like = bboxes[0]
    im = _t(im_info, like)
    h_im, w_im, scale = im[0], im[1], im[2]
    all_boxes, all_scores = [], []
    for lb, ls, la in zip(bboxes, scores, anchors):
        s = _t(ls, like)
        s = s.reshape(-1, s.shape[-1])
        d = _t(lb, like).reshape(-1, 4)
        a = _t(la, like).reshape(-1, 4)
        k = min(nms_top_k, s.shape[0])
        _, idx = _topk(s.amax(1), k)
        dec = _decode_proposals(a[idx], d[idx], torch.ones(
            (k, 4), device=like.device), 1.0)
        zero = torch.zeros((), device=like.device)
        dec = torch.stack([
            torch.minimum(torch.maximum(dec[:, 0] / scale, zero),
                          w_im / scale - 1),
            torch.minimum(torch.maximum(dec[:, 1] / scale, zero),
                          h_im / scale - 1),
            torch.minimum(torch.maximum(dec[:, 2] / scale, zero),
                          w_im / scale - 1),
            torch.minimum(torch.maximum(dec[:, 3] / scale, zero),
                          h_im / scale - 1)], 1)
        all_boxes.append(dec)
        all_scores.append(s[idx])
    boxes = torch.cat(all_boxes)       # [M, 4]
    scores_m = torch.cat(all_scores)   # [M, C]
    C = scores_m.shape[1]
    s = scores_m.t()
    s = torch.where(s >= score_threshold, s, _ninf_like(s))  # [C, M]
    keep = _nms_keep_mask(boxes.expand(C, -1, -1), s, nms_threshold, False)
    vals = torch.where(keep, s, _ninf_like(s))
    labels = torch.arange(C, dtype=torch.float32,
                          device=like.device)[:, None].expand_as(vals)
    return _class_rows(boxes.repeat(C, 1), labels.reshape(-1),
                       vals.reshape(-1), keep_top_k)


def density_prior_box(input, image, densities, fixed_sizes, fixed_ratios,
                      variance=(0.1, 0.1, 0.2, 0.2), clip=False,
                      step_w=0.0, step_h=0.0, offset=0.5, flatten_to_2d=False,
                      name=None):
    """SSD's densified anchors: for each (density, fixed_size) and each
    fixed_ratio, a density x density sub-grid of anchors in every cell."""
    fh, fw = input.shape[2], input.shape[3]
    ih, iw = image.shape[2], image.shape[3]
    sw = step_w or iw / fw
    sh = step_h or ih / fh
    dev = input.device
    ys, xs = torch.meshgrid(torch.arange(fh, dtype=torch.float32, device=dev),
                            torch.arange(fw, dtype=torch.float32, device=dev),
                            indexing="ij")
    cx0 = (xs + offset) * sw
    cy0 = (ys + offset) * sh
    boxes = []
    for size, dens in zip(fixed_sizes, densities):
        dens = int(dens)
        shift = size / dens
        for ratio in fixed_ratios:
            bw = size * np.sqrt(ratio)
            bh = size / np.sqrt(ratio)
            for di in range(dens):
                for dj in range(dens):
                    ccx = cx0 - size / 2.0 + shift / 2.0 + dj * shift
                    ccy = cy0 - size / 2.0 + shift / 2.0 + di * shift
                    boxes.append(torch.stack([(ccx - bw / 2.0) / iw,
                                              (ccy - bh / 2.0) / ih,
                                              (ccx + bw / 2.0) / iw,
                                              (ccy + bh / 2.0) / ih], -1))
    out = torch.stack(boxes, dim=2)  # [fh, fw, P, 4]
    if clip:
        out = torch.clamp(out, 0.0, 1.0)
    var = torch.tensor(variance, dtype=torch.float32,
                       device=dev).expand(out.shape).contiguous()
    if flatten_to_2d:
        return out.reshape(-1, 4), var.reshape(-1, 4)
    return out, var


# ---------------------------------------------------------------------------
# the YOLOv3 training loss
# ---------------------------------------------------------------------------
def _bce(logit, label):
    return torch.clamp(logit, min=0) - logit * label + \
        torch.log1p(torch.exp(-torch.abs(logit)))


def _last_writer(flat_idx, size):
    """For each of the ``[n, b]`` scatter targets in ``flat_idx`` (in
    ``[0, size)``, in update order along b), whether it is the last
    update of its target: the winner of XLA's in-order scatter on the
    CPU."""
    n, b = flat_idx.shape
    order = torch.arange(b, device=flat_idx.device).expand(n, b)
    last = torch.full((n, size), -1, dtype=torch.long,
                      device=flat_idx.device)
    last.scatter_reduce_(1, flat_idx, order, "amax")
    return torch.gather(last, 1, flat_idx) == order


def yolov3_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
                ignore_thresh, downsample_ratio, gt_score=None,
                use_label_smooth=True, scale_x_y=1.0, name=None):
    """YOLOv3's loss: the per-cell best-IoU ignore mask, each ground
    truth's best anchor over all anchors, sigmoid cross entropy for x, y,
    objectness and classes, L1 for w and h, the (2 - w h) box weight,
    label smoothing and mixup scores.  Returns the loss an image [N],
    the objectness mask [N, m, H, W] and the match [N, B]."""
    an = np.asarray(anchors, np.float32).reshape(-1, 2)
    mask = list(anchor_mask)
    C = int(class_num)
    scale = float(scale_x_y)
    bias = -0.5 * (scale - 1.0)
    xv = x
    dev = xv.device
    gtb = _t(gt_box, xv).float().detach()  # no gradient, as in JAX
    gtl = _t(gt_label, xv)
    n, _, h, w = xv.shape
    m = len(mask)
    b = gtb.shape[1]
    gts = _t(gt_score, xv).float() if gt_score is not None else \
        torch.ones((n, b), device=dev)
    input_size = downsample_ratio * h
    pred = xv.reshape(n, m, 5 + C, h, w)
    tx, ty = pred[:, :, 0], pred[:, :, 1]
    tw, th = pred[:, :, 2], pred[:, :, 3]
    tobj = pred[:, :, 4]
    tcls = pred[:, :, 5:]
    gt_valid = (gtb[:, :, 2] > 0) & (gtb[:, :, 3] > 0)

    # predicted boxes, normalised to the input size, for the ignore mask
    gx = torch.arange(w, dtype=torch.float32, device=dev)
    gy = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    aw = torch.from_numpy(an[mask, 0]).to(dev)[None, :, None, None]
    ah = torch.from_numpy(an[mask, 1]).to(dev)[None, :, None, None]
    px = (gx + torch.sigmoid(tx) * scale + bias) / w
    py = (gy + torch.sigmoid(ty) * scale + bias) / h
    pw = torch.exp(tw) * aw / input_size
    ph = torch.exp(th) * ah / input_size

    def iou_centered(x1, y1, w1, h1, x2, y2, w2, h2):
        ox = torch.clamp(torch.minimum(x1 + w1 / 2, x2 + w2 / 2)
                         - torch.maximum(x1 - w1 / 2, x2 - w2 / 2), min=0)
        oy = torch.clamp(torch.minimum(y1 + h1 / 2, y2 + h2 / 2)
                         - torch.maximum(y1 - h1 / 2, y2 - h2 / 2), min=0)
        inter = ox * oy
        return inter / torch.clamp(w1 * h1 + w2 * h2 - inter, min=1e-10)

    g = gtb[:, None, None, None]  # [n, 1, 1, 1, b, 4]
    with torch.no_grad():
        iou_all = iou_centered(px[..., None], py[..., None], pw[..., None],
                               ph[..., None], g[..., 0], g[..., 1],
                               g[..., 2], g[..., 3])
        iou_all = torch.where(gt_valid[:, None, None, None, :], iou_all,
                              torch.zeros_like(iou_all))
        ignore = iou_all.amax(-1) > ignore_thresh

    # each ground truth's best anchor over all anchors (origin-shifted)
    a_w = torch.from_numpy(an[:, 0]).to(dev) / input_size
    a_h = torch.from_numpy(an[:, 1]).to(dev) / input_size
    inter = torch.minimum(gtb[:, :, 2:3], a_w) * \
        torch.minimum(gtb[:, :, 3:4], a_h)
    iou_an = inter / (gtb[:, :, 2:3] * gtb[:, :, 3:4] + a_w * a_h - inter
                      + 1e-10)
    best_n = torch.argmax(iou_an, dim=-1)  # [n, b]
    mask_arr = np.full(an.shape[0], -1, np.int64)
    for mi, a_idx in enumerate(mask):
        mask_arr[a_idx] = mi
    mask_idx = torch.from_numpy(mask_arr).to(dev)[best_n]  # -1: unmatched
    gi = torch.clamp((gtb[:, :, 0] * w).to(torch.int32), 0, w - 1).long()
    gj = torch.clamp((gtb[:, :, 1] * h).to(torch.int32), 0, h - 1).long()
    matched = (mask_idx >= 0) & gt_valid
    mi_c = torch.clamp(mask_idx, 0, m - 1)

    smooth = min(1.0 / C, 1.0 / 40.0) if use_label_smooth else 0.0
    pos, neg = 1.0 - smooth, smooth
    nb = torch.arange(n, device=dev)[:, None].expand(n, b)
    nb_idx = (nb, mi_c, gj, gi)
    t_x = gtb[:, :, 0] * w - gi
    t_y = gtb[:, :, 1] * h - gj
    anw = torch.from_numpy(an[:, 0]).to(dev)[best_n]
    anh = torch.from_numpy(an[:, 1]).to(dev)[best_n]
    t_w = torch.log(torch.clamp(gtb[:, :, 2] * input_size / anw, min=1e-9))
    t_h = torch.log(torch.clamp(gtb[:, :, 3] * input_size / anh, min=1e-9))
    box_scale = (2.0 - gtb[:, :, 2] * gtb[:, :, 3]) * gts

    zero = torch.zeros((), device=dev)
    loc = (_bce(tx[nb_idx], t_x) + _bce(ty[nb_idx], t_y)
           + torch.abs(tw[nb_idx] - t_w) + torch.abs(th[nb_idx] - t_h))
    loc_loss = torch.where(matched, loc * box_scale, zero).sum(1)

    cls_label = torch.nn.functional.one_hot(gtl.long(), C).float() \
        * (pos - neg) + neg
    cls_logits = tcls[nb, mi_c, :, gj, gi]  # [n, b, C]
    cls = _bce(cls_logits, cls_label).sum(-1)
    cls_loss = torch.where(matched, cls * gts, zero).sum(1)

    # objectness: positive cells take the score, ignored cells are
    # skipped; of several rows on one cell the last writes (XLA's order)
    obj_mask = torch.where(ignore, -1.0, 0.0)
    upd = torch.where(matched, gts, obj_mask[nb_idx])
    wins = _last_writer((mi_c * h + gj) * w + gi, m * h * w)
    obj_mask = obj_mask.index_put(
        (nb[wins], mi_c[wins], gj[wins], gi[wins]), upd[wins])
    obj_pos = torch.where(obj_mask > 1e-5, _bce(tobj, 1.0) * obj_mask, zero)
    obj_neg = torch.where((obj_mask <= 1e-5) & (obj_mask > -0.5),
                          _bce(tobj, 0.0), zero)
    obj_loss = (obj_pos + obj_neg).sum(dim=(1, 2, 3))

    total = loc_loss + cls_loss + obj_loss
    gt_match = torch.where(matched, mi_c, -1).to(torch.int32)
    return total, obj_mask, gt_match


# ---------------------------------------------------------------------------
# multiclass_nms versions
# ---------------------------------------------------------------------------
def multiclass_nms2(bboxes, scores, score_threshold, nms_top_k, keep_top_k,
                    nms_threshold=0.3, normalized=True, nms_eta=1.0,
                    background_label=0, return_index=False, name=None):
    """`multiclass_nms` with the selected indices: each row's index is
    that of the first input box equal to it (within 1e-5), offset by
    ``image * M``, -1 for padding (equal boxes resolve to the first, as
    in the JAX package)."""
    from .ops import multiclass_nms

    out, counts = multiclass_nms(
        bboxes, scores, score_threshold, nms_top_k, keep_top_k,
        nms_threshold=nms_threshold, normalized=normalized,
        nms_eta=nms_eta, background_label=background_label)
    if not return_index:
        return out, counts
    boxes = bboxes
    m = boxes.shape[1]
    eq = (torch.abs(out[:, :, None, 2:6] - boxes[:, None, :, :])
          < 1e-5).all(-1)
    base = (torch.arange(out.shape[0], device=boxes.device) * m)[:, None]
    idx = torch.where(eq.any(-1), torch.argmax(eq.int(), dim=-1) + base,
                      -1)
    row_valid = torch.arange(out.shape[1], device=boxes.device)[None, :] \
        < counts.reshape(-1)[:, None]
    return out, counts, torch.where(row_valid, idx, -1).long()


def multiclass_nms3(bboxes, scores, rois_num=None, score_threshold=0.05,
                    nms_top_k=1000, keep_top_k=100, nms_threshold=0.3,
                    normalized=True, nms_eta=1.0, background_label=0,
                    return_index=True, name=None):
    """`multiclass_nms2` under v3's signature."""
    return multiclass_nms2(bboxes, scores, score_threshold, nms_top_k,
                           keep_top_k, nms_threshold=nms_threshold,
                           normalized=normalized, nms_eta=nms_eta,
                           background_label=background_label,
                           return_index=return_index)


# ---------------------------------------------------------------------------
# train-time target assigners
# ---------------------------------------------------------------------------
def _select_k(order, count, k):
    """The first ``count`` entries of each row of ``order`` [N, n] laid
    into k slots, -1 after."""
    n = order.shape[-1]
    ar = torch.arange(k, device=order.device)
    taken = order[..., torch.clamp(ar, 0, n - 1)]
    return torch.where(ar < count[..., None], taken, -1)


def _firsts(cand):
    """Candidates' indices in ascending order, ``cand`` [N, a] ->
    (order [N, a], the count of candidates)."""
    a = cand.shape[-1]
    ar = torch.arange(a, device=cand.device)
    return torch.argsort(torch.where(cand, ar, a + ar), dim=-1,
                         stable=True), cand.sum(-1)


def _fg_then_bg(fg_sel, fg_count, bg_sel, bg_count):
    """Score slots: the foreground first, then the background, -1 after;
    labels 1, 0, -1."""
    B = fg_sel.shape[-1]
    slot = torch.arange(B, device=fg_sel.device)
    shifted_bg = torch.gather(bg_sel, -1, torch.clamp(
        slot - fg_count[..., None], 0, B - 1))
    fgc, cnt = fg_count[..., None], (fg_count + bg_count)[..., None]
    index = torch.where(slot < fgc, fg_sel, shifted_bg)
    index = torch.where(slot < cnt, index, -1)
    label = torch.where(slot < fgc, 1, torch.where(slot < cnt, 0, -1))
    return index, label


def target_assign(x, match_indices, negative_indices=None, mismatch_value=0,
                  name=None):
    """``out[n, p] = x[n, match[n, p], p]`` where matched (weight 1),
    ``mismatch_value`` elsewhere (weight 0); ``negative_indices`` ([N, Q],
    -1 padded) force weight 1 and the mismatch value at those priors."""
    xv = x
    n, g, p, k = xv.shape
    mt = _t(match_indices, xv).long()
    nn_ = torch.arange(n, device=xv.device)[:, None]
    gathered = xv[nn_, torch.clamp(mt, 0, g - 1),
                  torch.arange(p, device=xv.device)[None, :]]  # [N, P, K]
    matched = (mt > -1)[:, :, None]
    fill = torch.full_like(gathered, float(mismatch_value))
    out = torch.where(matched, gathered, fill)
    wt = matched.float()
    if negative_indices is not None:
        neg = _t(negative_indices, xv).long()
        neg_mask = torch.zeros((n, p), dtype=torch.long, device=xv.device)
        neg_mask.scatter_reduce_(1, torch.clamp(neg, 0, p - 1),
                                 (neg >= 0).long(), "amax")
        neg_mask = neg_mask.bool()[:, :, None]
        out = torch.where(neg_mask, fill, out)
        wt = torch.where(neg_mask, 1.0, wt)
    return out, wt


def mine_hard_examples(cls_loss, match_indices, match_dist, loc_loss=None,
                       neg_pos_ratio=3.0, neg_dist_threshold=0.5,
                       sample_size=0, mining_type="max_negative", name=None):
    """SSD's hard example mining: (neg_indices [N, P], -1 padded and
    ascending; neg counts [N]; updated match indices [N, P]).
    max_negative ranks the unmatched priors under ``neg_dist_threshold``
    by loss, up to ``neg_pos_ratio`` x the positives; hard_example ranks
    every prior (cls + loc loss) up to ``sample_size``."""
    cl = cls_loss
    m = _t(match_indices, cl).long()
    dist = _t(match_dist, cl)
    hard = mining_type == "hard_example"
    n, p = cl.shape
    loss = cl + (_t(loc_loss, cl) if loc_loss is not None and hard else 0.0)
    if hard:
        eligible = torch.ones((n, p), dtype=torch.bool, device=cl.device)
    else:
        eligible = (m == -1) & (dist < neg_dist_threshold)
    key = torch.where(eligible, loss, _ninf_like(loss))
    order = torch.argsort(-key, dim=1, stable=True)
    n_cand = eligible.sum(1)
    if hard:
        cap = torch.clamp(n_cand, max=sample_size)
    else:
        num_pos = (m != -1).sum(1)
        cap = torch.minimum(n_cand, (num_pos * neg_pos_ratio).long())
    ar = torch.arange(p, device=cl.device)
    take = (ar[None, :] < cap[:, None]).long()
    sel = torch.zeros((n, p), dtype=torch.long, device=cl.device)
    sel.scatter_reduce_(1, order, take, "amax")
    sel = sel.bool()
    if hard:
        upd = torch.where((m > -1) & ~sel, -1, m)
        neg_mask = sel & (m == -1)
    else:
        upd = m
        neg_mask = sel
    neg_sorted = torch.sort(torch.where(neg_mask, ar[None, :], p), 1).values
    neg_sorted = torch.where(neg_sorted == p, -1, neg_sorted)
    return neg_sorted, neg_mask.sum(1).to(torch.int32), upd


def _box_to_delta(boxes, anchors):
    """Ground truths encoded against anchors (no variance weights)."""
    aw = anchors[..., 2] - anchors[..., 0] + 1.0
    ah = anchors[..., 3] - anchors[..., 1] + 1.0
    ax = anchors[..., 0] + aw * 0.5
    ay = anchors[..., 1] + ah * 0.5
    gw = boxes[..., 2] - boxes[..., 0] + 1.0
    gh = boxes[..., 3] - boxes[..., 1] + 1.0
    gx = boxes[..., 0] + gw * 0.5
    gy = boxes[..., 1] + gh * 0.5
    return torch.stack([(gx - ax) / aw, (gy - ay) / ah,
                        torch.log(gw / aw), torch.log(gh / ah)], -1)


def _iou_matrix(a, b):
    """Pixel IoU with the +1 convention of the RPN assigners: a [..., A,
    4], b [..., G, 4] -> [..., A, G]."""
    aw = torch.clamp(a[..., 2] - a[..., 0] + 1, min=0)
    ah = torch.clamp(a[..., 3] - a[..., 1] + 1, min=0)
    bw = torch.clamp(b[..., 2] - b[..., 0] + 1, min=0)
    bh = torch.clamp(b[..., 3] - b[..., 1] + 1, min=0)
    ix = torch.clamp(torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
                     - torch.maximum(a[..., :, None, 0], b[..., None, :, 0])
                     + 1, min=0)
    iy = torch.clamp(torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
                     - torch.maximum(a[..., :, None, 1], b[..., None, :, 1])
                     + 1, min=0)
    inter = ix * iy
    union = aw[..., :, None] * ah[..., :, None] \
        + bw[..., None, :] * bh[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def _assign_overlaps(anchors, gt, gt_valid):
    """(a2g max [N, A], a2g argmax, is-some-gt's-max [N, A], has-gt [N])
    of the anchors against the valid ground truths."""
    iou = _iou_matrix(anchors, gt)  # [N, A, G]
    iou = torch.where(gt_valid[:, None, :], iou, torch.zeros_like(iou))
    a2g_max = iou.amax(2)
    a2g_arg = torch.argmax(iou, dim=2)
    g2a_max = torch.where(gt_valid, iou.amax(1),
                          torch.full_like(gt_valid, float("inf"),
                                          dtype=iou.dtype))
    is_max = ((torch.abs(iou - g2a_max[:, None, :]) < 1e-5)
              & gt_valid[:, None, :]).any(2)
    return a2g_max, a2g_arg, is_max, gt_valid.any(1)


def _gt_valid(gt_boxes, gt_num, crowd, like):
    n, g = gt_boxes.shape[:2]
    gtn = _t(gt_num, like).long() if gt_num is not None else \
        torch.full((n,), g, dtype=torch.long, device=like.device)
    return (torch.arange(g, device=like.device)[None, :] < gtn[:, None]) \
        & (crowd == 0)


def rpn_target_assign(bbox_pred, cls_logits, anchor_box, anchor_var,
                      gt_boxes, is_crowd, im_info, gt_num=None,
                      rpn_batch_size_per_im=256, rpn_straddle_thresh=0.0,
                      rpn_fg_fraction=0.5, rpn_positive_overlap=0.7,
                      rpn_negative_overlap=0.3, use_random=False, name=None):
    """RPN targets, batched: anchor_box [A, 4]; gt_boxes [N, G, 4] with
    ``gt_num`` [N]; is_crowd [N, G]; im_info [N, 3].  Returns (loc_index
    [N, B], score_index [N, B], tgt_label [N, B], tgt_bbox [N, B, 4],
    bbox_inside_weight [N, B, 4], fg_num [N]), B = rpn_batch_size_per_im,
    -1 in unused slots; ``use_random=False`` takes the first candidates,
    as Paddle's deterministic path."""
    B = int(rpn_batch_size_per_im)
    anchors = anchor_box
    gt = _t(gt_boxes, anchors)
    crowd = _t(is_crowd, anchors)
    info = _t(im_info, anchors)
    a = anchors.shape[0]
    n = gt.shape[0]
    gt_valid = _gt_valid(gt, gt_num, crowd, anchors)
    if rpn_straddle_thresh >= 0:
        st = rpn_straddle_thresh
        inside = ((anchors[None, :, 0] >= -st) & (anchors[None, :, 1] >= -st)
                  & (anchors[None, :, 2] < info[:, 1, None] + st)
                  & (anchors[None, :, 3] < info[:, 0, None] + st))
    else:
        inside = torch.ones((n, a), dtype=torch.bool, device=anchors.device)
    a2g_max, a2g_arg, is_max, has_gt = _assign_overlaps(anchors, gt,
                                                        gt_valid)
    fg_cand = inside & has_gt[:, None] & \
        (is_max | (a2g_max >= rpn_positive_overlap))
    # an anchor takes one label: the foreground candidates leave the bg
    bg_cand = inside & (a2g_max < rpn_negative_overlap) & ~fg_cand
    if use_random:
        fg_order = torch.argsort(torch.where(
            fg_cand, torch.rand((n, a), device=anchors.device), 2.0), 1)
        bg_order = torch.argsort(torch.where(
            bg_cand, torch.rand((n, a), device=anchors.device), 2.0), 1)
        n_fg, n_bg = fg_cand.sum(1), bg_cand.sum(1)
    else:
        fg_order, n_fg = _firsts(fg_cand)
        bg_order, n_bg = _firsts(bg_cand)
    fg_count = torch.clamp(n_fg, max=int(rpn_fg_fraction * B))
    fg_sel = _select_k(fg_order, fg_count, B)
    bg_count = torch.minimum(n_bg, B - fg_count)
    bg_sel = _select_k(bg_order, bg_count, B)
    score_index, tgt_label = _fg_then_bg(fg_sel, fg_count, bg_sel,
                                         bg_count)
    fg_c = torch.clamp(fg_sel, 0, a - 1)
    matched_gt = _take_rows(gt, torch.gather(a2g_arg, 1, fg_c))
    tgt_bbox = _box_to_delta(matched_gt, anchors[fg_c])
    wgt = (fg_sel >= 0)[..., None].float()
    return (fg_sel, score_index, tgt_label,
            torch.where(wgt > 0, tgt_bbox, torch.zeros_like(tgt_bbox)),
            wgt.expand(n, B, 4), fg_count.to(torch.int32))


def retinanet_target_assign(bbox_pred, cls_logits, anchor_box, anchor_var,
                            gt_boxes, gt_labels, is_crowd, im_info,
                            gt_num=None, positive_overlap=0.5,
                            negative_overlap=0.4, name=None):
    """RetinaNet targets (every anchor, no subsampling): (labels [N, A]
    (-1 ignore, 0 background, else the gt label), tgt_bbox [N, A, 4],
    bbox_inside_weight [N, A, 4], fg_num [N, 1])."""
    anchors = anchor_box
    gt = _t(gt_boxes, anchors)
    gtl = _t(gt_labels, anchors)
    crowd = _t(is_crowd, anchors)
    a = anchors.shape[0]
    n = gt.shape[0]
    gt_valid = _gt_valid(gt, gt_num, crowd, anchors)
    a2g_max, a2g_arg, is_max, has_gt = _assign_overlaps(anchors, gt,
                                                        gt_valid)
    fg = has_gt[:, None] & (is_max | (a2g_max >= positive_overlap))
    bg = ~fg & (a2g_max < negative_overlap)
    labels = torch.where(fg, torch.gather(gtl.reshape(n, -1).long(), 1,
                                          a2g_arg).to(torch.int32),
                         torch.where(bg, 0, -1).to(torch.int32))
    tgt = _box_to_delta(_take_rows(gt, a2g_arg), anchors)
    wgt = fg[..., None].float()
    return (labels, torch.where(wgt > 0, tgt, torch.zeros_like(tgt)),
            wgt.expand(n, a, 4), fg.sum(1).to(torch.int32)[:, None])


def polygon_box_transform(x, name=None):
    """EAST's geometry decode: [N, 2n, H, W] corner offsets; even channels
    become 4 w - offset, odd ones 4 h - offset."""
    n, c, h, w = x.shape
    wi = torch.arange(w, dtype=x.dtype, device=x.device) * 4.0
    hi = torch.arange(h, dtype=x.dtype, device=x.device)[:, None] * 4.0
    even = (torch.arange(c, device=x.device) % 2 == 0)[None, :, None, None]
    return torch.where(even, wi - x, hi - x)


def generate_proposal_labels(rpn_rois, gt_classes, is_crowd, gt_boxes,
                             im_info, rois_num=None, gt_num=None,
                             batch_size_per_im=256, fg_fraction=0.25,
                             fg_thresh=0.5, bg_thresh_hi=0.5,
                             bg_thresh_lo=0.0,
                             bbox_reg_weights=(0.1, 0.1, 0.2, 0.2),
                             class_nums=81, use_random=False,
                             is_cls_agnostic=False, name=None):
    """RCNN's second-stage sampler, batched: the ground truths prepended
    to the proposals; IoU >= fg_thresh foreground (its best gt's class),
    [bg_lo, bg_hi) background, the first floor(B * fg_fraction)
    foreground then background kept.  Returns (rois [N, B, 4], labels
    [N, B] (-1 pad), bbox_targets [N, B, 4 * class_nums],
    bbox_inside_weights, bbox_outside_weights, counts [N])."""
    B = int(batch_size_per_im)
    rois = rpn_rois.detach()  # the targets take no gradient, as in JAX
    dev = rois.device
    W = torch.tensor(bbox_reg_weights, dtype=torch.float32, device=dev)
    gtc = _t(gt_classes, rois)
    crowd = _t(is_crowd, rois)
    gt = _t(gt_boxes, rois)
    info = _t(im_info, rois)
    n, r = rois.shape[:2]
    g = gt.shape[1]
    rn = _t(rois_num, rois).long() if rois_num is not None else \
        torch.full((n,), r, device=dev)
    gn = _t(gt_num, rois).long() if gt_num is not None else \
        torch.full((n,), g, device=dev)
    # the proposals come scaled; the ground truths in the original image
    rois_s = rois / torch.clamp(info[:, 2], min=1e-6)[:, None, None]
    all_boxes = torch.cat([gt, rois_s], 1)  # [N, G+R, 4]
    nb = g + r
    gt_valid = torch.arange(g, device=dev)[None] < gn[:, None]
    valid = torch.cat([gt_valid,
                       torch.arange(r, device=dev)[None] < rn[:, None]], 1)
    iou = _iou_matrix(all_boxes, gt)
    iou = torch.where(gt_valid[:, None, :] & valid[:, :, None], iou,
                      torch.zeros_like(iou))
    max_ov = iou.amax(2)
    arg = torch.argmax(iou, dim=2)
    is_crowd_row = torch.cat([crowd != 0, torch.zeros(
        (n, r), dtype=torch.bool, device=dev)], 1)
    max_ov = torch.where(is_crowd_row, -1.0, max_ov)
    fg_cand = valid & (max_ov >= fg_thresh)
    bg_cand = valid & (max_ov >= bg_thresh_lo) & (max_ov < bg_thresh_hi)
    fg_order, n_fg = _firsts(fg_cand)
    fg_count = torch.clamp(n_fg, max=int(B * fg_fraction))
    fg_sel = _select_k(fg_order, fg_count, B)
    bg_order, n_bg = _firsts(bg_cand)
    bg_count = torch.minimum(n_bg, B - fg_count)
    bg_sel = _select_k(bg_order, bg_count, B)
    sel, _ = _fg_then_bg(fg_sel, fg_count, bg_sel, bg_count)
    count = fg_count + bg_count
    slot = torch.arange(B, device=dev)
    sel_c = torch.clamp(sel, 0, nb - 1)
    picked = _take_rows(all_boxes, sel_c)
    out_rois = torch.where((sel >= 0)[..., None], picked,
                           torch.zeros_like(picked))
    mapped_gt = torch.gather(arg, 1, sel_c)
    is_fg = slot < fg_count[:, None]
    labels = torch.where(is_fg, torch.gather(gtc.long(), 1, mapped_gt),
                         torch.where(slot < count[:, None], 0, -1)).to(
                             torch.int32)
    deltas = _box_to_delta(_take_rows(gt, mapped_gt), picked) / W
    cls = torch.ones_like(labels) if is_cls_agnostic else labels
    cols = (torch.clamp(cls, 0, class_nums - 1).long() * 4)[..., None] \
        + torch.arange(4, device=dev)
    tgt = torch.zeros((n, B, 4 * class_nums), device=dev).scatter(
        2, cols, torch.where(is_fg[..., None], deltas,
                             torch.zeros_like(deltas)))
    w_in = torch.zeros_like(tgt).scatter(
        2, cols, is_fg[..., None].float().expand(n, B, 4))
    return out_rois, labels, tgt, w_in, w_in, count.to(torch.int32)


def roi_perspective_transform(x, rois, transformed_height, transformed_width,
                              spatial_scale=1.0, roi_batch_idx=None,
                              name=None):
    """Quadrilateral ROIs [R, 8] warped to a fixed size with Paddle's
    closed-form quad-to-rect transform, each output pixel inverse-mapped
    and sampled bilinearly; outside the quad or the image 0 (mask 0).
    ``roi_batch_idx`` [R] is each ROI's image.  Returns (out [R, C, th,
    tw], mask [R, 1, th, tw] int32, transform_matrix [R, 9])."""
    th, tw = int(transformed_height), int(transformed_width)
    xv = x
    n_im, c, h, w = xv.shape
    rv = _t(rois, xv).detach()  # no gradient to the quads, as in JAX
    bidx = torch.zeros(rv.shape[0], dtype=torch.long, device=xv.device) \
        if roi_batch_idx is None else _t(roi_batch_idx, xv).long()
    rx = rv[:, 0::2] * spatial_scale
    ry = rv[:, 1::2] * spatial_scale
    x0, x1, x2, x3 = rx.unbind(1)
    y0, y1, y2, y3 = ry.unbind(1)
    len1 = torch.hypot(x0 - x1, y0 - y1)
    len2 = torch.hypot(x1 - x2, y1 - y2)
    len3 = torch.hypot(x2 - x3, y2 - y3)
    len4 = torch.hypot(x3 - x0, y3 - y0)
    est_h = (len2 + len4) / 2.0
    est_w = (len1 + len3) / 2.0
    norm_h = float(max(2, th))
    norm_w = torch.round(est_w * (norm_h - 1) / torch.clamp(
        est_h, min=1e-5)) + 1
    norm_w = torch.clamp(norm_w, 2, tw)
    dx1, dx2, dx3 = x1 - x2, x3 - x2, x0 - x1 + x2 - x3
    dy1, dy2, dy3 = y1 - y2, y3 - y2, y0 - y1 + y2 - y3
    den = dx1 * dy2 - dx2 * dy1 + 1e-5
    m6 = (dx3 * dy2 - dx2 * dy3) / den / (norm_w - 1)
    m7 = (dx1 * dy3 - dx3 * dy1) / den / (norm_h - 1)
    m8 = torch.ones_like(m6)
    m3 = (y1 - y0 + m6 * (norm_w - 1) * y1) / (norm_w - 1)
    m4 = (y3 - y0 + m7 * (norm_h - 1) * y3) / (norm_h - 1)
    m5 = y0
    m0 = (x1 - x0 + m6 * (norm_w - 1) * x1) / (norm_w - 1)
    m1 = (x3 - x0 + m7 * (norm_h - 1) * x3) / (norm_h - 1)
    m2 = x0
    mat = torch.stack([m0, m1, m2, m3, m4, m5, m6, m7, m8], -1)
    gh, gw = torch.meshgrid(torch.arange(th, dtype=torch.float32,
                                         device=xv.device),
                            torch.arange(tw, dtype=torch.float32,
                                         device=xv.device), indexing="ij")

    def e(v):
        return v[:, None, None]

    u = e(m0) * gw + e(m1) * gh + e(m2)
    v = e(m3) * gw + e(m4) * gh + e(m5)
    ww = e(m6) * gw + e(m7) * gh + e(m8)
    ww = torch.where(torch.abs(ww) < 1e-10, 1e-10, ww)
    in_w = u / ww
    in_h = v / ww
    # crossing-number in-quad test
    cnt = torch.zeros_like(in_w, dtype=torch.int32)
    for i in range(4):
        xs_, ys_ = e(rx[:, i]), e(ry[:, i])
        xe_, ye_ = e(rx[:, (i + 1) % 4]), e(ry[:, (i + 1) % 4])
        non_horiz = torch.abs(ys_ - ye_) >= 1e-4
        t = (in_h - ys_) / torch.where(non_horiz, ye_ - ys_, 1.0)
        ix = xs_ + t * (xe_ - xs_)
        cnt = cnt + (non_horiz & (t >= 0) & (t < 1) & (ix > in_w)).to(
            torch.int32)
    inside_quad = (cnt % 2) == 1
    in_bounds = ((in_w > -0.5) & (in_w < w - 0.5) & (in_h > -0.5)
                 & (in_h < h - 0.5))
    valid = inside_quad & in_bounds
    cw = torch.clamp(in_w, 0.0, w - 1.0)
    ch = torch.clamp(in_h, 0.0, h - 1.0)
    wf, hf = torch.floor(cw), torch.floor(ch)
    wc = torch.clamp(wf + 1, max=w - 1)
    hc = torch.clamp(hf + 1, max=h - 1)
    lw_ = (cw - wf)[:, None]
    lh_ = (ch - hf)[:, None]
    bb = bidx[:, None, None]

    def gat(hh, wq):  # [R, C, th, tw]
        return xv[bb, :, hh.long(), wq.long()].permute(0, 3, 1, 2)

    out = (gat(hf, wf) * (1 - lw_) * (1 - lh_) + gat(hf, wc) * lw_ * (1 - lh_)
           + gat(hc, wf) * (1 - lw_) * lh_ + gat(hc, wc) * lw_ * lh_)
    out = torch.where(valid[:, None], out, torch.zeros_like(out))
    return out, valid[:, None].to(torch.int32), mat


def generate_mask_labels(im_info, gt_classes, is_crowd, gt_segms, rois,
                         labels_int32, num_classes, resolution,
                         gt_num=None, name=None):
    """Mask-RCNN's mask targets, batched: each foreground ROI (label > 0)
    takes the non-crowd gt polygon whose box overlaps it most, rasterised
    inside the ROI at resolution x resolution (pixel-centre even-odd
    test) into its class slot, -1 elsewhere; foreground ROIs first.
    gt_segms [N, G, P, V, 2] padded with NaN.  Returns (mask_rois [N, R,
    4], roi_has_mask [N, R] (-1 pad), mask_int32 [N, R, num_classes *
    res^2], fg_counts [N])."""
    res = int(resolution)
    ncls = int(num_classes)
    rois_v = rois.detach()  # the targets take no gradient, as in JAX
    dev = rois_v.device
    info = _t(im_info, rois_v)
    gtc = _t(gt_classes, rois_v)
    crowd = _t(is_crowd, rois_v)
    segms = _t(gt_segms, rois_v)
    labels = _t(labels_int32, rois_v)
    n, g, p, vmax, _ = segms.shape
    r = rois_v.shape[1]
    gn = _t(gt_num, rois_v).long() if gt_num is not None else \
        torch.full((n,), g, device=dev)
    im_scale = info[:, 2]
    gt_valid = (torch.arange(g, device=dev)[None] < gn[:, None]) \
        & (gtc > 0) & (crowd == 0)
    pts = segms.reshape(n, g, p * vmax, 2)
    finite = torch.isfinite(pts).all(-1, keepdim=True)
    big = torch.where(finite, pts, float("inf"))
    small = torch.where(finite, pts, _NINF)
    gt_boxes = torch.stack([big[..., 0].amin(2), big[..., 1].amin(2),
                            small[..., 0].amax(2), small[..., 1].amax(2)],
                           -1)  # [N, G, 4]
    fg = labels > 0
    order = torch.argsort((~fg).int(), dim=1, stable=True)
    fg_sorted = torch.gather(fg, 1, order)
    rois_s = _take_rows(rois_v, order) / im_scale[:, None, None]
    labels_s = torch.gather(labels, 1, order)
    x1 = torch.maximum(rois_s[..., :, None, 0], gt_boxes[..., None, :, 0])
    y1 = torch.maximum(rois_s[..., :, None, 1], gt_boxes[..., None, :, 1])
    x2 = torch.minimum(rois_s[..., :, None, 2], gt_boxes[..., None, :, 2])
    y2 = torch.minimum(rois_s[..., :, None, 3], gt_boxes[..., None, :, 3])
    inter = torch.clamp(x2 - x1 + 1, min=0) * torch.clamp(y2 - y1 + 1, min=0)
    area_r = ((rois_s[..., 2] - rois_s[..., 0] + 1)
              * (rois_s[..., 3] - rois_s[..., 1] + 1))
    area_g = ((gt_boxes[..., 2] - gt_boxes[..., 0] + 1)
              * (gt_boxes[..., 3] - gt_boxes[..., 1] + 1))
    iou = inter / torch.clamp(area_r[..., :, None] + area_g[..., None, :]
                              - inter, min=1e-10)
    iou = torch.where(gt_valid[:, None, :], iou, -1.0)
    best_gt = torch.argmax(iou, dim=2)  # [N, R]
    ctr = (torch.arange(res, dtype=torch.float32, device=dev) + 0.5) / res
    gy, gx = torch.meshgrid(ctr, ctr, indexing="ij")
    bw = torch.clamp(rois_s[..., 2] - rois_s[..., 0], min=1e-5)
    bh = torch.clamp(rois_s[..., 3] - rois_s[..., 1], min=1e-5)
    qx = rois_s[..., 0, None, None] + gx * bw[..., None, None]  # [N,R,res,res]
    qy = rois_s[..., 1, None, None] + gy * bh[..., None, None]
    polys = segms[torch.arange(n, device=dev)[:, None], best_gt]  # [N,R,P,V,2]
    vx, vy = polys[..., 0], polys[..., 1]  # [N, R, P, V]
    ok = torch.isfinite(vx) & torch.isfinite(vy)
    nv = ok.sum(-1, keepdim=True)
    idx = torch.arange(vmax, device=dev)
    nxt = torch.where(idx + 1 >= nv, 0, idx + 1)
    xe, ye = torch.gather(vx, -1, nxt), torch.gather(vy, -1, nxt)
    live = (idx < nv)[..., None, None]

    def q(v):  # [N, R, P, V] -> [N, R, P, V, 1, 1]
        return v[..., None, None]

    non_h = torch.abs(q(ye) - q(vy)) > 1e-12
    t = (qy[:, :, None, None] - q(vy)) / torch.where(non_h, q(ye) - q(vy),
                                                     1.0)
    ix = q(vx) + t * (q(xe) - q(vx))
    hit = live & non_h & (t >= 0) & (t < 1) & (ix > qx[:, :, None, None])
    masks = ((hit.sum(3) % 2) == 1).any(2)  # [N, R, res, res]
    has_any_gt = gt_valid.any(1)[:, None, None, None]
    mask_rows = fg_sorted[..., None, None] & has_any_gt & masks
    cls = torch.clamp(labels_s, 0, ncls - 1).long()
    expanded = torch.full((n, r, ncls, res * res), -1, dtype=torch.int32,
                          device=dev)
    expanded.scatter_(2, cls[..., None, None].expand(n, r, 1, res * res),
                      mask_rows.reshape(n, r, 1, res * res).to(torch.int32))
    expanded = torch.where(fg_sorted[..., None, None], expanded, -1)
    mask_rois = torch.where(fg_sorted[..., None],
                            rois_s * im_scale[:, None, None],
                            torch.zeros_like(rois_s))
    roi_has_mask = torch.where(fg_sorted, order, -1).to(torch.int32)
    return (mask_rois, roi_has_mask, expanded.reshape(n, r, ncls * res * res),
            fg.sum(1).to(torch.int32))
