"""Vision and detection operators (counterpart: paddle_tpu/vision/ops.py).

Python over torch ops, as the JAX package's are XLA: no kernel of their
own.  Kept from the JAX package (each a departure from Paddle):

- outputs have static shapes: the NMS family returns fixed
  ``[N, keep_top_k, 6]`` rows filled with -1 and a valid count an image
  where Paddle returns LoD tensors; ``multiclass_nms(rois_num=)`` raises;
- NMS is greedy over a sorted suppression mask, one step a candidate,
  every class and image of a call in one loop (JAX's ``vmap``); the sort
  is stable and top-k takes the lowest index first among equal scores,
  so indices equal the JAX package's, ties included;
- ``roi_align`` clamps samples outside the feature map onto its edge.

Inputs are tensors (or numpy arrays, taken to the device of the first
tensor argument); outputs follow the inputs' device.  ``deform_conv2d``
and ``roi_align`` are batched gathers, not loops over regions;
``roi_pool`` finds each bin's maximum over a gathered window in chunks of
regions, and takes its value with one gather (on a tie the gradient goes
to the first maximum, where the JAX package splits it).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops._util import div as _div

__all__ = [
    "iou_similarity", "box_clip", "box_coder", "prior_box", "yolo_box",
    "roi_align", "roi_pool", "nms", "multiclass_nms", "matrix_nms",
    "deform_conv2d", "correlation", "bilateral_slice",
]


def __getattr__(name):
    # the detection long tail lives in vision.detection and is reachable
    # here too, as in Paddle's fluid.layers.detection
    from . import detection as _det

    if name in _det.__all__:
        return getattr(_det, name)
    raise AttributeError(name)


def _t(x, like=None):
    """``x`` as a tensor (float64 data as float32, as the JAX package
    without x64), on ``like``'s device when given."""
    if not isinstance(x, torch.Tensor):
        a = np.asarray(x)
        x = torch.from_numpy(np.array(a, dtype=np.float32 if a.dtype ==
                                      np.float64 else a.dtype))
    return x if like is None else x.to(like.device)


def _topk(x, k):
    """The ``k`` largest along the last axis, the lowest index first
    among equal values (``jax.lax.top_k``'s order)."""
    idx = torch.argsort(x, dim=-1, descending=True, stable=True)[..., :k]
    return torch.gather(x, -1, idx), idx


def _take_rows(x, idx):
    """``x[..., idx, :]`` a batch row at a time: x [..., n, d], idx
    [..., k] -> [..., k, d]."""
    return torch.gather(x, -2, idx[..., None].expand(
        *idx.shape, x.shape[-1]))


# ---------------------------------------------------------------------------
# IoU and box utilities
# ---------------------------------------------------------------------------
def _pairwise_iou(a, b, box_normalized=True):
    """a [..., N, 4], b [..., M, 4] in xyxy -> [..., N, M] IoU."""
    off = 0.0 if box_normalized else 1.0
    ax1, ay1, ax2, ay2 = a.unbind(-1)
    bx1, by1, bx2, by2 = b.unbind(-1)
    area_a = (ax2 - ax1 + off) * (ay2 - ay1 + off)
    area_b = (bx2 - bx1 + off) * (by2 - by1 + off)
    ix1 = torch.maximum(ax1[..., :, None], bx1[..., None, :])
    iy1 = torch.maximum(ay1[..., :, None], by1[..., None, :])
    ix2 = torch.minimum(ax2[..., :, None], bx2[..., None, :])
    iy2 = torch.minimum(ay2[..., :, None], by2[..., None, :])
    iw = torch.clamp(ix2 - ix1 + off, min=0)
    ih = torch.clamp(iy2 - iy1 + off, min=0)
    inter = iw * ih
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def iou_similarity(x, y, box_normalized=True, name=None):
    """[N, 4] x [M, 4] -> [N, M] IoU."""
    return _pairwise_iou(x, _t(y, x), box_normalized)


def box_clip(input, im_info, name=None):
    """Boxes clipped to ``[0, dim / scale - 1]`` of im_info = [H, W,
    scale]."""
    info = _t(im_info, input).to(input.dtype)
    hmax = info[0] / info[2] - 1.0
    wmax = info[1] / info[2] - 1.0
    zero = torch.zeros((), dtype=input.dtype, device=input.device)
    x1 = torch.minimum(torch.maximum(input[..., 0], zero), wmax)
    y1 = torch.minimum(torch.maximum(input[..., 1], zero), hmax)
    x2 = torch.minimum(torch.maximum(input[..., 2], zero), wmax)
    y2 = torch.minimum(torch.maximum(input[..., 3], zero), hmax)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True, axis=0,
              name=None):
    """Encode boxes against priors ([M, 4] targets -> [M, N, 4]) or
    decode deltas ([N, M, 4]) into boxes."""
    prior = prior_box
    target = _t(target_box, prior)
    var = None if prior_box_var is None else _t(prior_box_var, prior)
    off = 0.0 if box_normalized else 1.0
    pw = prior[:, 2] - prior[:, 0] + off
    ph = prior[:, 3] - prior[:, 1] + off
    pcx = prior[:, 0] + pw * 0.5
    pcy = prior[:, 1] + ph * 0.5
    if code_type == "encode_center_size":
        tw = target[:, 2] - target[:, 0] + off
        th = target[:, 3] - target[:, 1] + off
        tcx = target[:, 0] + tw * 0.5
        tcy = target[:, 1] + th * 0.5
        ox = (tcx[:, None] - pcx[None, :]) / pw[None, :]
        oy = (tcy[:, None] - pcy[None, :]) / ph[None, :]
        ow = torch.log(torch.abs(tw[:, None] / pw[None, :]))
        oh = torch.log(torch.abs(th[:, None] / ph[None, :]))
        out = torch.stack([ox, oy, ow, oh], dim=-1)
        if var is not None:
            out = out / (var.reshape(1, -1, 4) if var.dim() == 2
                         else var.reshape(1, 1, 4))
        return out
    if axis == 0:
        pw_, ph_, pcx_, pcy_ = (v[None, :, None] for v in (pw, ph, pcx, pcy))
    else:
        pw_, ph_, pcx_, pcy_ = (v[:, None, None] for v in (pw, ph, pcx, pcy))
    t = target
    if var is not None:
        v4 = var.reshape(1, -1, 4) if var.dim() == 2 else \
            var.reshape(1, 1, 4)
        if axis == 1 and var.dim() == 2:
            v4 = var.reshape(-1, 1, 4)
        t = t * v4
    cx = t[..., 0:1] * pw_ + pcx_
    cy = t[..., 1:2] * ph_ + pcy_
    w = torch.exp(t[..., 2:3]) * pw_
    h = torch.exp(t[..., 3:4]) * ph_
    return torch.cat([cx - w * 0.5, cy - h * 0.5, cx + w * 0.5 - off,
                      cy + h * 0.5 - off], dim=-1)


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, min_max_aspect_ratios_order=False,
              name=None):
    """SSD priors: (boxes [H, W, P, 4], variances [H, W, P, 4]), laid out
    on the host (the shapes are attributes) and placed on ``input``'s
    device."""
    in_h, in_w = int(input.shape[2]), int(input.shape[3])
    img_h, img_w = int(image.shape[2]), int(image.shape[3])
    step_w = steps[0] or img_w / in_w
    step_h = steps[1] or img_h / in_h
    ars = [1.0]
    for ar in aspect_ratios:
        if not any(abs(ar - e) < 1e-6 for e in ars):
            ars.append(float(ar))
            if flip:
                ars.append(1.0 / float(ar))
    widths, heights = [], []
    maxs = list(max_sizes) if max_sizes else [None] * len(min_sizes)
    for ms, mx in zip(min_sizes, maxs):
        if min_max_aspect_ratios_order:
            widths.append(ms)
            heights.append(ms)
            if mx is not None:
                widths.append(np.sqrt(ms * mx))
                heights.append(np.sqrt(ms * mx))
            for ar in ars:
                if abs(ar - 1.0) < 1e-6:
                    continue
                widths.append(ms * np.sqrt(ar))
                heights.append(ms / np.sqrt(ar))
        else:
            for ar in ars:
                widths.append(ms * np.sqrt(ar))
                heights.append(ms / np.sqrt(ar))
            if mx is not None:
                widths.append(np.sqrt(ms * mx))
                heights.append(np.sqrt(ms * mx))
    num_priors = len(widths)
    cxg, cyg = np.meshgrid((np.arange(in_w) + offset) * step_w,
                           (np.arange(in_h) + offset) * step_h)
    w = np.asarray(widths, np.float32) * 0.5
    h = np.asarray(heights, np.float32) * 0.5
    boxes = np.stack([(cxg[..., None] - w) / img_w,
                      (cyg[..., None] - h) / img_h,
                      (cxg[..., None] + w) / img_w,
                      (cyg[..., None] + h) / img_h],
                     axis=-1).astype(np.float32)
    if clip:
        boxes = np.clip(boxes, 0.0, 1.0)
    vars_ = np.broadcast_to(np.asarray(variance, np.float32),
                            (in_h, in_w, num_priors, 4)).copy()
    return (torch.from_numpy(boxes).to(input.device),
            torch.from_numpy(vars_).to(input.device))


# ---------------------------------------------------------------------------
# YOLO
# ---------------------------------------------------------------------------
def yolo_box(x, img_size, anchors, class_num, conf_thresh,
             downsample_ratio, clip_bbox=True, scale_x_y=1.0, name=None):
    """YOLOv3 head [N, A*(5+C), H, W] -> boxes [N, A*H*W, 4] (xyxy in
    the image's scale) and scores [N, A*H*W, C]; candidates under
    ``conf_thresh`` are zeros.  img_size [N, 2] is (h, w)."""
    na = len(anchors) // 2
    anc = torch.tensor(anchors, dtype=torch.float32,
                       device=x.device).reshape(na, 2)
    imgs = _t(img_size, x)
    n, _, h, w = x.shape
    xv = x.reshape(n, na, 5 + class_num, h, w)
    grid_x = torch.arange(w, dtype=torch.float32, device=x.device)
    grid_y = torch.arange(h, dtype=torch.float32,
                          device=x.device)[:, None]
    bias = 0.5 * (scale_x_y - 1.0)
    cx = (torch.sigmoid(xv[:, :, 0]) * scale_x_y - bias + grid_x) / w
    cy = (torch.sigmoid(xv[:, :, 1]) * scale_x_y - bias + grid_y) / h
    bw = torch.exp(xv[:, :, 2]) * anc[None, :, 0, None, None] \
        / (downsample_ratio * w)
    bh = torch.exp(xv[:, :, 3]) * anc[None, :, 1, None, None] \
        / (downsample_ratio * h)
    conf = torch.sigmoid(xv[:, :, 4])
    score = conf[:, :, None] * torch.sigmoid(xv[:, :, 5:])
    keep = (conf >= conf_thresh).to(xv.dtype)
    imgh = imgs[:, 0].float()[:, None, None, None]
    imgw = imgs[:, 1].float()[:, None, None, None]
    x1 = (cx - bw * 0.5) * imgw
    y1 = (cy - bh * 0.5) * imgh
    x2 = (cx + bw * 0.5) * imgw
    y2 = (cy + bh * 0.5) * imgh
    if clip_bbox:
        zero = torch.zeros((), device=x.device)
        x1 = torch.minimum(torch.maximum(x1, zero), imgw - 1.0)
        y1 = torch.minimum(torch.maximum(y1, zero), imgh - 1.0)
        x2 = torch.minimum(torch.maximum(x2, zero), imgw - 1.0)
        y2 = torch.minimum(torch.maximum(y2, zero), imgh - 1.0)
    boxes = torch.stack([x1, y1, x2, y2], dim=2) * keep[:, :, None]
    scores = score * keep[:, :, None]
    # [n, a, 4|C, h, w] -> [n, a*h*w, 4|C]
    boxes = boxes.permute(0, 1, 3, 4, 2).reshape(n, na * h * w, 4)
    scores = scores.permute(0, 1, 3, 4, 2).reshape(n, na * h * w, class_num)
    return boxes, scores


# ---------------------------------------------------------------------------
# ROI pooling
# ---------------------------------------------------------------------------
def _roi_batch_ids(rois_num, n_rois, like):
    """The image of each ROI from the per-image counts (a prefix
    partition, the LoD's replacement)."""
    ends = torch.cumsum(_t(rois_num, like).long(), 0)
    ar = torch.arange(n_rois, device=like.device)
    return (ar[:, None] >= ends[None, :]).long().sum(1)


def _out_hw(output_size):
    return (output_size, output_size) if isinstance(output_size, int) \
        else tuple(output_size)


def roi_align(x, boxes, boxes_num, output_size, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True, name=None):
    """ROIAlign: x [N, C, H, W], boxes [R, 4] (xyxy, input-image
    coordinates), boxes_num [N] -> [R, C, out_h, out_w], each bin the
    mean of ratio x ratio bilinear samples (samples outside the map
    clamped onto its edge)."""
    out_h, out_w = _out_hw(output_size)
    ratio = sampling_ratio if sampling_ratio > 0 else 2
    n, c, h, w = x.shape
    rois = _t(boxes, x)
    batch = _roi_batch_ids(boxes_num, rois.shape[0], x)
    offset = 0.5 if aligned else 0.0
    x1 = rois[:, 0] * spatial_scale - offset
    y1 = rois[:, 1] * spatial_scale - offset
    x2 = rois[:, 2] * spatial_scale - offset
    y2 = rois[:, 3] * spatial_scale - offset
    rw, rh = x2 - x1, y2 - y1
    if not aligned:
        rw = torch.clamp(rw, min=1.0)
        rh = torch.clamp(rh, min=1.0)
    bin_w, bin_h = _div(rw, out_w), _div(rh, out_h)
    dev = x.device
    gy = (torch.arange(out_h * ratio, device=dev) + 0.5) / ratio
    gx = (torch.arange(out_w * ratio, device=dev) + 0.5) / ratio
    ys = y1[:, None] + bin_h[:, None] * gy[None, :]  # [R, Sy]
    xs = x1[:, None] + bin_w[:, None] * gx[None, :]  # [R, Sx]
    y0 = torch.clamp(torch.floor(ys), 0, h - 1)
    x0 = torch.clamp(torch.floor(xs), 0, w - 1)
    y1i = torch.clamp(y0 + 1, 0, h - 1).long()
    x1i = torch.clamp(x0 + 1, 0, w - 1).long()
    y0i, x0i = y0.long(), x0.long()
    ly = (torch.clamp(ys, 0, h - 1) - y0)[:, None, :, None]
    lx = (torch.clamp(xs, 0, w - 1) - x0)[:, None, None, :]
    b = batch[:, None, None]

    def at(yi, xi):  # [R, C, Sy, Sx]
        return x[b, :, yi[:, :, None], xi[:, None, :]].permute(0, 3, 1, 2)

    val = (at(y0i, x0i) * (1 - ly) * (1 - lx)
           + at(y0i, x1i) * (1 - ly) * lx
           + at(y1i, x0i) * ly * (1 - lx)
           + at(y1i, x1i) * ly * lx)
    r = rois.shape[0]
    return val.reshape(r, c, out_h, ratio, out_w, ratio).mean(dim=(3, 5))


def _c_round(v):
    """C's round(): half away from zero."""
    return torch.sign(v) * torch.floor(torch.abs(v) + 0.5)


# elements a gathered window of roi_pool holds at once
_ROI_POOL_CHUNK = 1 << 26


def roi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0, name=None):
    """Max ROI pooling with Paddle's integer bins (``hstart =
    floor(ph * bin_h) + y1``, ``hend = ceil((ph + 1) * bin_h) + y1``,
    clipped), the true maximum over each bin, 0 for an empty bin."""
    out_h, out_w = _out_hw(output_size)
    n, c, h, w = x.shape
    rois = _t(boxes, x)
    r = rois.shape[0]
    batch = _roi_batch_ids(boxes_num, r, x)
    x1 = _c_round(rois[:, 0] * spatial_scale)
    y1 = _c_round(rois[:, 1] * spatial_scale)
    x2 = _c_round(rois[:, 2] * spatial_scale)
    y2 = _c_round(rois[:, 3] * spatial_scale)
    rw = torch.clamp(x2 - x1 + 1, min=1.0)
    rh = torch.clamp(y2 - y1 + 1, min=1.0)
    bin_h, bin_w = _div(rh, out_h), _div(rw, out_w)
    ph = torch.arange(out_h, dtype=torch.float32, device=x.device)
    pw = torch.arange(out_w, dtype=torch.float32, device=x.device)
    hs = torch.clamp(torch.floor(ph[None] * bin_h[:, None]) + y1[:, None],
                     0, h)
    he = torch.clamp(torch.ceil((ph[None] + 1) * bin_h[:, None])
                     + y1[:, None], 0, h)
    ws = torch.clamp(torch.floor(pw[None] * bin_w[:, None]) + x1[:, None],
                     0, w)
    we = torch.clamp(torch.ceil((pw[None] + 1) * bin_w[:, None])
                     + x1[:, None], 0, w)
    if r == 0:
        return x.new_zeros((0, c, out_h, out_w))
    # the widest bin, read once: the windows' static extent
    th, tw = (int(v) for v in torch.stack([
        (he - hs).max(), (we - ws).max()]).clamp(min=1).tolist())
    hs_l, ws_l = hs.long(), ws.long()
    flat = torch.empty((r, c, out_h, out_w), dtype=torch.long,
                       device=x.device)
    ah = torch.arange(th, device=x.device)
    aw = torch.arange(tw, device=x.device)
    step = max(1, _ROI_POOL_CHUNK // (c * out_h * out_w * th * tw))
    with torch.no_grad():
        for s in range(0, r, step):
            sl = slice(s, s + step)
            # rows [R', oh, th], columns [R', ow, tw] of each bin's window
            rows = hs_l[sl, :, None] + ah
            cols = ws_l[sl, :, None] + aw
            rok = rows < he[sl, :, None]
            cok = cols < we[sl, :, None]
            rows = rows.clamp(max=h - 1)
            cols = cols.clamp(max=w - 1)
            bb = batch[sl, None, None, None, None, None]
            cc = torch.arange(c, device=x.device)[None, :, None, None, None,
                                                 None]
            rr = rows[:, None, :, None, :, None]
            ww = cols[:, None, None, :, None, :]
            win = x[bb, cc, rr, ww]  # [R', C, oh, ow, th, tw]
            ok = (rok[:, None, :, None, :, None]
                  & cok[:, None, None, :, None, :])
            win = win.masked_fill(~ok, float("-inf"))
            arg = win.flatten(4).argmax(-1)  # first maximum
            at_r = torch.gather(rows[:, None, :, None, :].expand(
                -1, c, -1, out_w, -1), 4, (arg // tw)[..., None])[..., 0]
            at_c = torch.gather(cols[:, None, None, :, :].expand(
                -1, c, out_h, -1, -1), 4, (arg % tw)[..., None])[..., 0]
            empty = ~(ok.flatten(4).any(-1))
            idx = ((batch[sl, None, None, None] * c
                    + torch.arange(c, device=x.device)[None, :, None, None])
                   * h + at_r) * w + at_c
            flat[sl] = torch.where(empty, -1, idx)
    vals = x.reshape(-1)[flat.clamp(min=0)]
    return torch.where(flat >= 0, vals, torch.zeros_like(vals))


# ---------------------------------------------------------------------------
# the NMS family
# ---------------------------------------------------------------------------
def _nms_keep_mask(boxes, scores, iou_threshold, box_normalized=True,
                   eta=1.0):
    """Greedy NMS over the score-sorted candidates: boxes [..., n, 4],
    scores [..., n] -> keep [..., n] (in the input's order).  One step a
    candidate for every leading index at once, no host sync; eta < 1
    decays the threshold by eta after each kept box while it exceeds
    0.5 (Paddle's adaptive NMS)."""
    lead, n = scores.shape[:-1], scores.shape[-1]
    s2 = scores.reshape(-1, n)
    b2 = boxes.reshape(-1, n, 4)
    order = torch.argsort(-s2, dim=-1, stable=True)
    iou = _pairwise_iou(_take_rows(b2, order), _take_rows(b2, order),
                        box_normalized)
    keep = torch.zeros_like(s2, dtype=torch.bool)
    if n:
        keep[:, 0] = True
    earlier = torch.ones(n, n, dtype=torch.bool,
                         device=scores.device).tril(-1)
    if eta >= 1.0:
        # a sum of 0/1 terms: exact in f32, 0 only if nothing suppresses
        over = ((iou > iou_threshold) & earlier).float()
        keepf = keep.float()
        for i in range(1, n):
            hit = torch.linalg.vecdot(over[:, i], keepf)
            keepf[:, i] = (hit == 0).float()
        keep = keepf > 0
    else:
        thresh = torch.full(s2.shape[:1], float(iou_threshold),
                            dtype=torch.float32, device=scores.device)
        for i in range(1, n):
            sup = ((iou[:, i] > thresh[:, None]) & keep
                   & earlier[i]).any(-1)
            keep[:, i] = ~sup
            thresh = torch.where(~sup & (thresh > 0.5), thresh * eta,
                                 thresh)
    out = torch.zeros_like(keep).scatter_(1, order, keep)
    return out.reshape(*lead, n)


def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None, name=None):
    """Greedy NMS: the indices of the kept boxes, highest score first (a
    tensor whose length depends on the data)."""
    b = boxes
    s = _t(scores, b) if scores is not None else \
        torch.ones(b.shape[0], device=b.device)
    if category_idxs is not None:
        # boxes of different categories never overlap once offset
        cat = _t(category_idxs, b).to(b.dtype)
        keep = _nms_keep_mask(b + (cat * (b.max() + 1.0))[:, None], s,
                              iou_threshold)
    else:
        keep = _nms_keep_mask(b, s, iou_threshold)
    idx = torch.nonzero(keep)[:, 0]
    idx = idx[torch.argsort(-s[idx], stable=True)]
    return idx[:top_k] if top_k is not None else idx


def _pad_rows(out, idx, keep_top_k, take):
    """Fill ``out`` [N, take, 6] and ``idx`` [N, take] to keep_top_k rows
    (-1), the documented fixed shape when the pool is smaller."""
    if keep_top_k > 0 and take < keep_top_k:
        pad = keep_top_k - take
        out = torch.cat([out, out.new_full((out.shape[0], pad, 6), -1.0)],
                        dim=1)
        idx = torch.cat([idx, idx.new_full((idx.shape[0], pad), -1)], dim=1)
    return out, idx


def _select_rows(bb, vals, labels, cand_idx, keep_top_k):
    """The per-image global top ``keep_top_k`` of ``vals`` [N, C, K]
    (-inf for none): rows (label, score, box) -1 where invalid, the
    valid count and the candidates' box indices."""
    n, c, k = vals.shape
    flat_s = vals.reshape(n, -1)
    pool = flat_s.shape[1]
    take = min(keep_top_k, pool) if keep_top_k > 0 else pool
    sel_s, sel = _topk(flat_s, take)
    sel_l = torch.gather(labels.reshape(1, -1).expand(n, -1), 1,
                         sel).to(bb.dtype)
    out_idx = torch.gather(cand_idx.reshape(n, -1), 1, sel)
    sel_b = _take_rows(bb, out_idx)
    valid = torch.isfinite(sel_s)
    neg = torch.full_like(sel_s, -1.0)
    out = torch.cat([torch.where(valid, sel_l, neg)[..., None],
                     torch.where(valid, sel_s, neg)[..., None],
                     torch.where(valid[..., None], sel_b,
                                 torch.full_like(sel_b, -1.0))], dim=2)
    out, out_idx = _pad_rows(out, out_idx, keep_top_k, take)
    return out, valid.sum(1).to(torch.int32), out_idx


def multiclass_nms(bboxes, scores, score_threshold, nms_top_k, keep_top_k,
                   nms_threshold=0.3, normalized=True, nms_eta=1.0,
                   background_label=-1, return_index=False, rois_num=None,
                   name=None):
    """Static-shape multiclass NMS: bboxes [N, M, 4], scores [N, C, M] ->
    (out [N, keep_top_k, 6] rows of (label, score, x1, y1, x2, y2), -1
    where invalid, and counts [N]); with ``return_index`` (out, index,
    counts).  Every class of every image goes through one NMS loop."""
    if rois_num is not None:
        raise NotImplementedError(
            "multiclass_nms(rois_num=...) LoD-batched input is not "
            "supported; pass dense [N, M, 4] boxes")
    bb = bboxes
    sc = _t(scores, bb)
    n, m, _ = bb.shape
    c = sc.shape[1]
    s = torch.where(sc > score_threshold, sc,
                    torch.full_like(sc, float("-inf")))
    if 0 < nms_top_k < m:
        topv, topi = _topk(s, nms_top_k)
    else:
        topi = torch.argsort(-s, dim=-1, stable=True)
        topv = torch.gather(s, -1, topi)
    k = topi.shape[-1]
    cand = _take_rows(bb, topi.reshape(n, c * k)).reshape(n, c, k, 4)
    keep = _nms_keep_mask(cand, topv, nms_threshold, normalized,
                          eta=nms_eta) & torch.isfinite(topv)
    labels = torch.arange(c, device=bb.device)[:, None].expand(c, k)
    if background_label >= 0:
        keep &= labels != background_label
    vals = torch.where(keep, topv, torch.full_like(topv, float("-inf")))
    out, counts, index = _select_rows(bb, vals, labels, topi, keep_top_k)
    if return_index:
        return out, index, counts
    return out, counts


def matrix_nms(bboxes, scores, score_threshold, post_threshold, nms_top_k,
               keep_top_k, use_gaussian=False, gaussian_sigma=2.0,
               background_label=-1, normalized=True, return_index=False,
               return_rois_num=True, name=None):
    """Matrix NMS (SOLOv2): each score decays by its IoU with the
    higher-scored boxes of its class, all in parallel.  bboxes [N, M,
    4], scores [N, C, M] -> (out [N, keep_top_k, 6], counts [N]) (and
    the indices with ``return_index``)."""
    bb = bboxes
    sc = _t(scores, bb)
    n, m, _ = bb.shape
    c = sc.shape[1]
    k = min(nms_top_k, m) if nms_top_k > 0 else m
    topv, topi = _topk(torch.where(sc > score_threshold, sc,
                                   torch.full_like(sc, float("-inf"))), k)
    b = _take_rows(bb, topi.reshape(n, c * k)).reshape(n, c, k, 4)
    iou = _pairwise_iou(b, b, normalized)
    upper = torch.ones(k, k, dtype=torch.bool, device=bb.device).triu(1)
    ious = torch.where(upper, iou, torch.zeros_like(iou))
    iou_cmax = ious.amax(dim=-2)  # [.., k] each box's max IoU above it
    if use_gaussian:
        decay = torch.exp((torch.square(iou_cmax)[..., :, None]
                           - torch.square(ious)) * gaussian_sigma)
    else:
        denom = torch.clamp(1.0 - iou_cmax[..., :, None], min=1e-10)
        decay = (1.0 - ious) / denom
    decay = torch.where(upper, decay, torch.ones_like(decay)).amin(dim=-2)
    ninf = torch.full_like(topv, float("-inf"))
    vals = torch.where(torch.isfinite(topv), topv * decay, ninf)
    labels = torch.arange(c, device=bb.device)[:, None].expand(c, k)
    if background_label >= 0:
        vals = torch.where(labels == background_label, ninf, vals)
    vals = torch.where(vals > post_threshold, vals, ninf)
    out, counts, index = _select_rows(bb, vals, labels, topi, keep_top_k)
    index = index[:, :min(keep_top_k, c * k) if keep_top_k > 0 else c * k]
    if return_index:
        return out, index, counts
    return out, counts


# ---------------------------------------------------------------------------
# deformable convolution, correlation, bilateral slice
# ---------------------------------------------------------------------------
def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None,
                  name=None):
    """Deformable convolution v1 (v2 with ``mask``): one bilinear gather
    a corner for every tap, zero outside the image, then one einsum.
    x [N, Cin, H, W]; offset [N, 2*dg*kh*kw, Ho, Wo] ((dy, dx) a tap);
    mask [N, dg*kh*kw, Ho, Wo]; weight [Cout, Cin/groups, kh, kw]."""
    s, p, d = _pair(stride), _pair(padding), _pair(dilation)
    n, cin, h, wd = x.shape
    cout, cin_g, kh, kw = weight.shape
    ho = (h + 2 * p[0] - d[0] * (kh - 1) - 1) // s[0] + 1
    wo = (wd + 2 * p[1] - d[1] * (kw - 1) - 1) // s[1] + 1
    dg = deformable_groups
    kk = kh * kw
    off = offset.reshape(n, dg, kk, 2, ho, wo)
    dev = x.device
    base_y = torch.arange(ho, device=dev) * s[0] - p[0]
    base_x = torch.arange(wo, device=dev) * s[1] - p[1]
    ky = torch.arange(kh, device=dev) * d[0]
    kx = torch.arange(kw, device=dev) * d[1]
    taps_y = (ky[:, None, None, None] + base_y[None, None, :, None]).expand(
        kh, kw, ho, wo).reshape(kk, ho, wo)
    taps_x = (kx[None, :, None, None] + base_x[None, None, None, :]).expand(
        kh, kw, ho, wo).reshape(kk, ho, wo)
    sy = taps_y[None, None] + off[:, :, :, 0]  # [N, dg, K, Ho, Wo]
    sx = taps_x[None, None] + off[:, :, :, 1]
    y0 = torch.floor(sy)
    x0 = torch.floor(sx)
    ly = (sy - y0)[:, :, None]
    lx = (sx - x0)[:, :, None]
    cdg = cin // dg
    flat = x.reshape(n, dg, cdg, h * wd)

    def gather(yi, xi):
        # a corner outside the image contributes 0, not an edge pixel
        valid = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= wd - 1)
        yic = torch.clamp(yi, 0, h - 1).long()
        xic = torch.clamp(xi, 0, wd - 1).long()
        idx = (yic * wd + xic).reshape(n, dg, 1, -1).expand(
            n, dg, cdg, kk * ho * wo)
        out = torch.gather(flat, 3, idx).reshape(n, dg, cdg, kk, ho, wo)
        return out * valid[:, :, None].to(out.dtype)

    val = (gather(y0, x0) * (1 - ly) * (1 - lx)
           + gather(y0, x0 + 1) * (1 - ly) * lx
           + gather(y0 + 1, x0) * ly * (1 - lx)
           + gather(y0 + 1, x0 + 1) * ly * lx)
    if mask is not None:
        val = val * mask.reshape(n, dg, 1, kk, ho, wo)
    cols_g = val.reshape(n, groups, cin // groups, kk, ho, wo)
    wflat = weight.reshape(groups, cout // groups, cin_g, kk)
    out = torch.einsum("ngckyx,gock->ngoyx", cols_g, wflat).reshape(
        n, cout, ho, wo)
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


def correlation(x1, x2, pad_size, kernel_size, max_displacement, stride1,
                stride2, corr_type_multiply=1, name=None):
    """FlowNet's correlation volume: for each displacement within
    ``max_displacement`` (step ``stride2``) the channel-and-window mean
    of x1 times the shifted x2, on a ``stride1`` grid ->
    [N, (2 * max_displacement // stride2 + 1)^2, OH, OW]."""
    K = int(kernel_size)
    krad = (K - 1) // 2
    rad = int(max_displacement) // int(stride2)
    if int(max_displacement) < krad:
        raise ValueError("correlation: max_displacement must be >= "
                         "kernel radius")
    n, c, h, w = x1.shape
    p = int(pad_size)
    border = int(max_displacement) + krad
    pa = torch.nn.functional.pad(x1, (p, p, p, p))
    pb = torch.nn.functional.pad(x2, (p, p, p, p))
    oh = int(np.ceil((h + 2 * p - 2 * border) / stride1))
    ow = int(np.ceil((w + 2 * p - 2 * border) / stride1))
    start = int(max_displacement) - krad
    s1 = int(stride1)
    planes = []
    for tj in range(-rad, rad + 1):
        for ti in range(-rad, rad + 1):
            shifted = torch.roll(pb, (-tj * stride2, -ti * stride2),
                                 dims=(2, 3))
            prod = (pa * shifted).sum(dim=1)  # [N, PH, PW]
            ph, pw = prod.shape[1] - K + 1, prod.shape[2] - K + 1
            win = sum(prod[:, a:a + ph, b:b + pw] for a in range(K)
                      for b in range(K))
            sub = win[:, start:start + (oh - 1) * s1 + 1:s1,
                      start:start + (ow - 1) * s1 + 1:s1]
            planes.append(sub / (K * K * c))
    return torch.stack(planes, dim=1)


def bilateral_slice(x, grid, guide, has_offset=False, name=None):
    """HDRNet's slice-and-apply: each pixel's affine coefficients sampled
    trilinearly (tent weights) from the bilateral grid at (x / w * gw,
    y / h * gh, guide * gd), applied to the input's channels (+ an offset
    row with ``has_offset``).  x [N, Ci, H, W], grid [N, Cg, gd, gh, gw],
    guide [N, H, W] -> [N, Co, H, W]."""
    n, ci, h, w = x.shape
    _, cg, gd, gh, gw = grid.shape
    stride = ci + (1 if has_offset else 0)
    if cg % stride:
        raise ValueError(
            f"bilateral_slice: grid channels {cg} not divisible by "
            f"input channels{' + offset' if has_offset else ''} ({stride})")
    co = cg // stride
    dev = x.device
    gx = (torch.arange(w, device=dev) + 0.5) * gw / w
    gy = (torch.arange(h, device=dev) + 0.5) * gh / h
    gz = guide * gd

    def tent(v):
        return torch.clamp(1.0 - torch.abs(v), min=0.0)

    fx = torch.floor(gx - 0.5).long()
    fy = torch.floor(gy - 0.5).long()
    fz = torch.floor(gz - 0.5).long()
    acc = grid.new_zeros((n, cg, h, w))
    for dx in (0, 1):
        x_ = torch.clamp(fx + dx, 0, gw - 1)
        wx = tent(fx + dx + 0.5 - gx)
        for dy in (0, 1):
            y_ = torch.clamp(fy + dy, 0, gh - 1)
            wy = tent(fy + dy + 0.5 - gy)
            plane = grid[:, :, :, y_, :][:, :, :, :, x_]  # [N, Cg, gd, H, W]
            for dz in (0, 1):
                z_ = torch.clamp(fz + dz, 0, gd - 1)
                wz = tent(fz + dz + 0.5 - gz)
                samp = torch.gather(plane, 2, z_[:, None, None].expand(
                    n, cg, 1, h, w))[:, :, 0]
                acc = acc + samp * (wx[None, None, None, :]
                                    * wy[None, None, :, None]
                                    * wz[:, None])
    coeff = acc.reshape(n, co, stride, h, w)
    out = torch.einsum("nosij,nsij->noij", coeff[:, :, :ci], x)
    if has_offset:
        out = out + coeff[:, :, ci]
    return out
