"""Metrics (counterpart: paddle_tpu/metric/__init__.py).

Host-side, as the JAX package's: predictions and labels are read as
numpy arrays and every accumulator is numpy, so counts, curves and
averages equal the JAX package's bit for bit.  `mean_iou` is the
op library's confusion matrix on the inputs' device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops._util import host as _np

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy",
           "extract_chunk_spans", "ChunkEvaluator", "DetectionMAP",
           "mean_iou", "detection_map_update"]

# numpy 2 names the trapezoid rule `trapezoid`; older numpy only `trapz`
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        return args


class Accuracy(Metric):
    """Top-k accuracy: ``compute`` marks, per row, which of the ``maxk``
    best predictions is the label; ``update`` counts them."""

    def __init__(self, topk=(1,), name=None):
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def compute(self, pred, label, *args):
        pred_np = _np(pred)
        label_np = _np(label)
        idx = np.argsort(-pred_np, axis=-1)[..., : self.maxk]
        if label_np.ndim == pred_np.ndim:
            label_np = label_np.squeeze(-1)
        correct = idx == label_np[..., None]
        return torch.from_numpy(correct.astype(np.float32))

    def update(self, correct, *args):
        c = _np(correct)
        num = c.shape[0] if c.ndim > 0 else 1
        accs = []
        for k in self.topk:
            corr_k = c[..., :k].sum()
            accs.append(corr_k / max(num, 1))
            self.total[self.topk.index(k)] += corr_k
            self.count[self.topk.index(k)] += num
        return accs[0] if len(accs) == 1 else accs

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def accumulate(self):
        res = [t / c if c > 0 else 0.0 for t, c in zip(self.total,
                                                       self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name="precision"):
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int32).reshape(-1)
        l = _np(labels).astype(np.int32).reshape(-1)
        self.tp += int(np.sum((p == 1) & (l == 1)))
        self.fp += int(np.sum((p == 1) & (l == 0)))

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name="recall"):
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int32).reshape(-1)
        l = _np(labels).astype(np.int32).reshape(-1)
        self.tp += int(np.sum((p == 1) & (l == 1)))
        self.fn += int(np.sum((p == 0) & (l == 1)))

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        self._name = name
        self.num_thresholds = num_thresholds
        self.reset()

    def update(self, preds, labels):
        p = _np(preds)
        if p.ndim == 2:
            p = p[:, 1]
        l = _np(labels).reshape(-1)
        bins = np.minimum((p * self.num_thresholds).astype(np.int64),
                          self.num_thresholds - 1)
        for b, y in zip(bins, l):
            if y:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds, dtype=np.int64)
        self._stat_neg = np.zeros(self.num_thresholds, dtype=np.int64)

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        # trapezoid over thresholds from high to low
        tp = np.cumsum(self._stat_pos[::-1])
        fp = np.cumsum(self._stat_neg[::-1])
        tpr = tp / tot_pos
        fpr = fp / tot_neg
        return float(_trapezoid(tpr, fpr))

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    pred = _np(input)
    lab = _np(label)
    idx = np.argsort(-pred, axis=-1)[..., :k]
    if lab.ndim == pred.ndim:
        lab = lab.squeeze(-1)
    corr = (idx == lab[..., None]).any(axis=-1).mean()
    return torch.from_numpy(np.asarray(corr, dtype=np.float32))


def extract_chunk_spans(tags, scheme="IOB", num_chunk_types=1,
                        excluded=()):
    """[(start, end_exclusive, type)] per the reference's GetSegments
    rules (`operators/metrics/chunk_eval_op.h`): label = chunk_type *
    num_tag_types + tag; labels outside [0, num_chunk_types*num_tag_types)
    are Outside.  Schemes: plain (every in-range position its own
    chunk), IOB (B=0/I=1), IOE (I=0/E=1), IOBES (B/I/E/S=0..3).  The
    ONE chunk decoder — ChunkEvaluator and the `chunk_eval` interp
    translator both use it."""
    n_tag = {"plain": 1, "IOB": 2, "IOE": 2, "IOBES": 4}[scheme]
    excluded = set(excluded)
    chunks = []
    start = None
    cur_type = None

    def flush(end):
        if start is not None and cur_type not in excluded:
            chunks.append((start, end, cur_type))

    tags = [int(t) for t in tags]
    for i, lab in enumerate(tags):
        if lab < 0 or lab >= num_chunk_types * n_tag:
            flush(i)
            start, cur_type = None, None
            continue
        ctype, tag = divmod(lab, n_tag)
        if scheme == "plain":
            begins, ends_here = True, True
        elif scheme == "IOB":
            begins = tag == 0 or ctype != cur_type or start is None
            ends_here = False
        elif scheme == "IOE":
            begins = ctype != cur_type or start is None
            ends_here = tag == 1
        else:  # IOBES
            begins = tag in (0, 3) or ctype != cur_type or start is None
            ends_here = tag in (2, 3)
        if begins:
            flush(i)
            start, cur_type = i, ctype
        if ends_here:
            flush(i + 1)
            start, cur_type = None, None
    flush(len(tags))
    return chunks


class ChunkEvaluator(Metric):
    """Chunking (NER) precision/recall/F1 over IOB-style tag sequences
    (reference `operators/metrics/chunk_eval_op.*` + `metric` wrapper).
    update() takes (num_infer_chunks, num_label_chunks, num_correct_chunks)
    like the reference's compute() outputs."""

    def __init__(self, name=None):
        self._name = name or "chunk"
        self.reset()

    def reset(self):
        self.num_infer = 0
        self.num_label = 0
        self.num_correct = 0

    def update(self, num_infer_chunks, num_label_chunks,
               num_correct_chunks):
        def _i(v):
            return int(_np(v).sum())

        self.num_infer += _i(num_infer_chunks)
        self.num_label += _i(num_label_chunks)
        self.num_correct += _i(num_correct_chunks)

    def accumulate(self):
        p = self.num_correct / self.num_infer if self.num_infer else 0.0
        r = self.num_correct / self.num_label if self.num_label else 0.0
        f1 = 2 * p * r / (p + r) if p + r else 0.0
        return p, r, f1

    def name(self):
        return self._name

    @staticmethod
    def extract_chunks(tags, scheme="IOB", n_types=None):
        """Decode (start, end_inclusive, type) chunks; thin wrapper over
        the module-level multi-scheme `extract_chunk_spans` (the single
        chunk decoder, shared with the `chunk_eval` interp translator)."""
        spans = extract_chunk_spans(
            tags, scheme=scheme,
            num_chunk_types=n_types if n_types is not None else 1 << 30,
            excluded=())
        return [(s, e - 1, t) for s, e, t in spans]

    def compute(self, infer_tags, label_tags, lengths=None, n_types=None):
        """Host-side chunk extraction; returns the three counts update()
        wants."""
        inf, lab = _np(infer_tags), _np(label_tags)
        if inf.ndim == 1:
            inf, lab = inf[None], lab[None]
        lens = _np(lengths) if lengths is not None else \
            np.full(inf.shape[0], inf.shape[1])
        ni = nl = nc = 0
        for row_i, row_l, L in zip(inf, lab, lens):
            ci = set(self.extract_chunks(row_i[:int(L)], n_types=n_types))
            cl = set(self.extract_chunks(row_l[:int(L)], n_types=n_types))
            ni += len(ci)
            nl += len(cl)
            nc += len(ci & cl)
        return ni, nl, nc


def _voc_ap(rec, prec, ap_type):
    """Average precision per the reference `detection_map_op.h:460-482`:
    '11point' = mean of max-precision at 11 recall thresholds;
    'integral' = the NATURAL integral sum(prec[i] * delta_rec[i]) — NOT
    the VOC-interpolated variant (round-4 fix: both callers previously
    right-maxed the curve, inflating integral AP)."""
    if ap_type == "11point":
        return float(np.mean(
            [prec[rec >= t].max() if (rec >= t).any() else 0.0
             for t in np.linspace(0, 1, 11)]))
    ap = 0.0
    prev = 0.0
    for r, pv in zip(rec, prec):
        if abs(r - prev) > 1e-6:
            ap += float(pv) * abs(float(r) - prev)
        prev = float(r)
    return ap


class DetectionMAP(Metric):
    """VOC-style detection mAP (reference `operators/metrics/` detection
    map machinery + `fluid/metrics.py DetectionMAP`): 11-point or
    'integral' interpolated average precision over IoU-matched
    detections."""

    def __init__(self, overlap_threshold=0.5, ap_version="11point",
                 class_num=None, name=None):
        self.overlap_threshold = overlap_threshold
        self.ap_version = ap_version
        self._name = name or "mAP"
        self.reset()

    def reset(self):
        self._dets = []   # (class, score, matched_gt)
        self._gt_count = {}

    def update(self, pred_boxes, pred_scores, pred_labels, gt_boxes,
               gt_labels):
        """Single-image update; all inputs numpy-able. pred_boxes [P,4],
        gt_boxes [G,4] xyxy."""
        pb, ps, pl = _np(pred_boxes), _np(pred_scores), _np(pred_labels)
        gb, gl = _np(gt_boxes), _np(gt_labels)
        for c in np.unique(gl):
            self._gt_count[int(c)] = self._gt_count.get(int(c), 0) + \
                int((gl == c).sum())
        order = np.argsort(-ps)
        taken = np.zeros(len(gb), bool)
        for i in order:
            c = int(pl[i])
            best, best_j = 0.0, -1
            for j in range(len(gb)):
                if taken[j] or int(gl[j]) != c:
                    continue
                ixmin = max(pb[i, 0], gb[j, 0])
                iymin = max(pb[i, 1], gb[j, 1])
                ixmax = min(pb[i, 2], gb[j, 2])
                iymax = min(pb[i, 3], gb[j, 3])
                iw = max(ixmax - ixmin, 0)
                ih = max(iymax - iymin, 0)
                inter = iw * ih
                a1 = (pb[i, 2] - pb[i, 0]) * (pb[i, 3] - pb[i, 1])
                a2 = (gb[j, 2] - gb[j, 0]) * (gb[j, 3] - gb[j, 1])
                iou = inter / max(a1 + a2 - inter, 1e-10)
                if iou > best:
                    best, best_j = iou, j
            # strict >, matching detection_map_op.h:401
            hit = best > self.overlap_threshold and best_j >= 0
            if hit:
                taken[best_j] = True
            self._dets.append((c, float(ps[i]), hit))

    def accumulate(self):
        aps = []
        for c, total in self._gt_count.items():
            rows = sorted((d for d in self._dets if d[0] == c),
                          key=lambda d: -d[1])
            if not rows or total == 0:
                continue
            tp = np.cumsum([1.0 if r[2] else 0.0 for r in rows])
            fp = np.cumsum([0.0 if r[2] else 1.0 for r in rows])
            rec = tp / total
            prec = tp / np.maximum(tp + fp, 1e-10)
            aps.append(_voc_ap(rec, prec, self.ap_version))
        return float(np.mean(aps)) if aps else 0.0

    def name(self):
        return self._name


def mean_iou(pred, label, num_classes, name=None):
    """Semantic-segmentation mean IoU: `ops.misc.mean_iou`'s confusion
    matrix (``(mean_iou, out_wrong [C], out_correct [C])``); numpy inputs
    are taken to tensors on the CPU."""
    from ..ops.misc import mean_iou as _mi

    if not isinstance(pred, torch.Tensor):
        pred = torch.from_numpy(np.asarray(pred))
    if not isinstance(label, torch.Tensor):
        label = torch.from_numpy(np.asarray(label))
    return _mi(pred, label, num_classes)


def detection_map_update(det, det_lens, gt, gt_lens, pos_count,
                         true_pos, tp_count, false_pos, fp_count,
                         class_num, overlap_threshold=0.5,
                         ap_type="11point", evaluate_difficult=True):
    """Numpy core of the `detection_map` op
    (`operators/detection/detection_map_op.cc`), shared by the interp
    translator and host evaluators.

    det: [B, M, 6] padded (label, score, x1, y1, x2, y2) with per-image
    det_lens [B]; gt: [B, G, 6] (label, [difficult,] x1, y1, x2, y2 —
    6-wide rows carry `difficult` at col 1) with gt_lens [B].  States
    are FIXED-CAPACITY dense stand-ins for the reference's growing LoD
    tensors: pos_count [C], (true|false)_pos [C, CAP, 2] (score, flag)
    with valid counts (tp|fp)_count [C].  Returns the accumulated
    states + mAP.  Overflow beyond CAP raises (silent drops would skew
    the metric).
    """
    det = np.asarray(det, np.float32)
    gt = np.asarray(gt, np.float32)
    C = int(class_num)
    pos_count = np.array(pos_count, np.int64).reshape(C).copy()
    cap = int(np.shape(true_pos)[1])
    true_pos = np.array(true_pos, np.float32).reshape(C, cap, 2).copy()
    false_pos = np.array(false_pos, np.float32).reshape(C, cap, 2).copy()
    tp_count = np.array(tp_count, np.int64).reshape(C).copy()
    fp_count = np.array(fp_count, np.int64).reshape(C).copy()

    def iou(a, b):
        ix1 = np.maximum(a[0], b[0])
        iy1 = np.maximum(a[1], b[1])
        ix2 = np.minimum(a[2], b[2])
        iy2 = np.minimum(a[3], b[3])
        iw = max(ix2 - ix1, 0.0)
        ih = max(iy2 - iy1, 0.0)
        inter = iw * ih
        ua = ((a[2] - a[0]) * (a[3] - a[1])
              + (b[2] - b[0]) * (b[3] - b[1]) - inter)
        return inter / ua if ua > 0 else 0.0

    def push(buf, cnt, c, score, flag):
        if cnt[c] >= cap:
            raise ValueError(
                f"detection_map: class {c} exceeded the state capacity "
                f"{cap}; raise the TruePos/FalsePos state size")
        buf[c, cnt[c], 0] = score
        buf[c, cnt[c], 1] = flag
        cnt[c] += 1

    wide = gt.shape[-1] >= 6  # rows carry a difficult flag at col 1
    for b in range(det.shape[0]):
        g = gt[b, : int(gt_lens[b])]
        d = det[b, : int(det_lens[b])]
        g_lab = g[:, 0].astype(np.int64)
        g_diff = g[:, 1].astype(bool) if wide else \
            np.zeros(len(g), bool)
        g_box = g[:, 2:6] if wide else g[:, 1:5]
        for c in range(C):
            sel = (g_lab == c) & (evaluate_difficult | ~g_diff)
            pos_count[c] += int(sel.sum())
        matched = np.zeros(len(g), bool)
        order = np.argsort(-d[:, 1], kind="stable")
        for i in order:
            c = int(d[i, 0])
            if c < 0 or c >= C:
                continue
            score = float(d[i, 1])
            box = d[i, 2:6]
            best, best_j = 0.0, -1
            for j in range(len(g)):
                if g_lab[j] != c:
                    continue
                ov = iou(box, g_box[j])
                if ov > best:
                    best, best_j = ov, j
            # strict >, matching detection_map_op.h:401
            if best > overlap_threshold and best_j >= 0:
                if not evaluate_difficult and g_diff[best_j]:
                    continue  # difficult gt: ignore the detection
                if not matched[best_j]:
                    matched[best_j] = True
                    push(true_pos, tp_count, c, score, 1.0)
                else:
                    push(false_pos, fp_count, c, score, 1.0)
            else:
                push(false_pos, fp_count, c, score, 1.0)

    # AP over the ACCUMULATED state
    aps = []
    for c in range(C):
        npos = int(pos_count[c])
        if npos == 0:
            continue
        tps = true_pos[c, : tp_count[c]]
        fps = false_pos[c, : fp_count[c]]
        ent = np.concatenate(
            [np.stack([tps[:, 0], np.ones(len(tps))], 1),
             np.stack([fps[:, 0], np.zeros(len(fps))], 1)])
        if len(ent) == 0:
            aps.append(0.0)
            continue
        ent = ent[np.argsort(-ent[:, 0], kind="stable")]
        tp_cum = np.cumsum(ent[:, 1])
        fp_cum = np.cumsum(1 - ent[:, 1])
        rec = tp_cum / npos
        prec = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
        aps.append(_voc_ap(rec, prec, ap_type))
    m_ap = float(np.mean(aps)) if aps else 0.0
    return (pos_count, true_pos, tp_count, false_pos, fp_count,
            np.asarray([m_ap], np.float32))
