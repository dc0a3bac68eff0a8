"""YOLOv3 over a DarkNet-53 backbone (counterpart:
paddle_tpu/vision/models/yolov3.py).  Training sums the three scales'
`yolov3_loss`; eval decodes each scale with `yolo_box` and runs one
`multiclass_nms` over the concatenated candidates, with static shapes
(``[N, keep_top_k, 6]`` rows, -1 filled, and a count an image)."""
from __future__ import annotations

import torch

from ... import nn
from ...nn import functional as F
from ..detection import yolov3_loss
from ..ops import multiclass_nms, yolo_box

__all__ = ["DarkNet53", "YOLOv3", "yolov3_darknet53"]


class ConvBNLayer(nn.Layer):
    def __init__(self, cin, cout, ksize=3, stride=1):
        super().__init__()
        self.conv = nn.Conv2D(cin, cout, ksize, stride=stride,
                              padding=(ksize - 1) // 2, bias_attr=False)
        self.bn = nn.BatchNorm2D(cout)
        self.act = nn.LeakyReLU(0.1)

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class BasicBlock(nn.Layer):
    def __init__(self, ch):
        super().__init__()
        self.conv1 = ConvBNLayer(ch, ch // 2, 1)
        self.conv2 = ConvBNLayer(ch // 2, ch, 3)

    def forward(self, x):
        return x + self.conv2(self.conv1(x))


class DarkNet53(nn.Layer):
    """The backbone; returns the feature maps at strides 8, 16 and 32
    (C3, C4, C5)."""

    DEPTHS = (1, 2, 8, 8, 4)

    def __init__(self):
        super().__init__()
        self.stem = ConvBNLayer(3, 32, 3)
        stages = []
        cin = 32
        for depth, cout in zip(self.DEPTHS, (64, 128, 256, 512, 1024)):
            blocks = [ConvBNLayer(cin, cout, 3, stride=2)]
            blocks += [BasicBlock(cout) for _ in range(depth)]
            stages.append(nn.Sequential(*blocks))
            cin = cout
        self.stages = nn.LayerList(stages)

    def forward(self, x):
        feats = []
        h = self.stem(x)
        for i, stage in enumerate(self.stages):
            h = stage(h)
            if i >= 2:  # strides 8, 16, 32
                feats.append(h)
        return feats


class YoloDetBlock(nn.Layer):
    def __init__(self, cin, ch):
        super().__init__()
        self.body = nn.Sequential(
            ConvBNLayer(cin, ch, 1), ConvBNLayer(ch, ch * 2, 3),
            ConvBNLayer(ch * 2, ch, 1), ConvBNLayer(ch, ch * 2, 3),
            ConvBNLayer(ch * 2, ch, 1))
        self.tip = ConvBNLayer(ch, ch * 2, 3)

    def forward(self, x):
        route = self.body(x)
        return route, self.tip(route)


class YOLOv3(nn.Layer):
    """Three-scale YOLOv3 head over DarkNet53.

    train: ``model(img, gt_box, gt_label)`` -> the scalar loss (the sum
    of the three scales' `yolov3_loss`);
    eval: ``model(img, im_shape=...)`` -> ``(boxes [N, K, 6], counts
    [N])`` after `yolo_box` at each scale and one `multiclass_nms`."""

    ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90,
               156, 198, 373, 326]
    MASKS = [[6, 7, 8], [3, 4, 5], [0, 1, 2]]  # C5, C4, C3 order

    def __init__(self, num_classes=80, ignore_thresh=0.7,
                 downsamples=(32, 16, 8)):
        super().__init__()
        self.num_classes = num_classes
        self.ignore_thresh = ignore_thresh
        self.downsamples = downsamples
        self.backbone = DarkNet53()
        out_ch = len(self.MASKS[0]) * (5 + num_classes)
        self.blocks = nn.LayerList()
        self.outs = nn.LayerList()
        self.routes = nn.LayerList()
        in_chs = (1024, 768, 384)  # C5, C4 + route / 2, C3 + route / 2
        for i, (cin, ch) in enumerate(zip(in_chs, (512, 256, 128))):
            self.blocks.append(YoloDetBlock(cin, ch))
            self.outs.append(nn.Conv2D(ch * 2, out_ch, 1))
            if i < 2:
                self.routes.append(ConvBNLayer(ch, ch // 2, 1))

    def _heads(self, img):
        """The three heads' raw outputs, strides 32, 16 and 8."""
        c3, c4, c5 = self.backbone(img)
        outs = []
        route = None
        for i, feat in enumerate((c5, c4, c3)):
            if route is not None:
                up = F.interpolate(route, scale_factor=2, mode="nearest")
                feat = torch.cat([up.to(feat.dtype), feat], dim=1)
            route_t, tip = self.blocks[i](feat)
            outs.append(self.outs[i](tip))
            if i < 2:
                route = self.routes[i](route_t)
        return outs

    def decode(self, outs, im_shape, score_threshold=0.01):
        """``(boxes [N, M, 4], scores [N, C, M])``: every scale's
        `yolo_box` candidates, concatenated, in f32."""
        boxes_all, scores_all = [], []
        for i, out in enumerate(outs):
            anchors = [self.ANCHORS[2 * m + d] for m in self.MASKS[i]
                       for d in (0, 1)]
            boxes, scores = yolo_box(
                out.float(), im_shape, anchors=anchors,
                class_num=self.num_classes, conf_thresh=score_threshold,
                downsample_ratio=self.downsamples[i])
            boxes_all.append(boxes)
            scores_all.append(scores)
        return (torch.cat(boxes_all, dim=1),
                torch.cat(scores_all, dim=1).transpose(1, 2))

    def forward(self, img, gt_box=None, gt_label=None, im_shape=None,
                score_threshold=0.01, nms_top_k=400, keep_top_k=100,
                nms_threshold=0.45):
        outs = self._heads(img)
        if self.training:
            if gt_box is None or gt_label is None:
                raise ValueError("YOLOv3 in train mode takes gt_box and "
                                 "gt_label")
            total = None
            for i, out in enumerate(outs):
                loss, _, _ = yolov3_loss(
                    out.float(), gt_box, gt_label, anchors=self.ANCHORS,
                    anchor_mask=self.MASKS[i], class_num=self.num_classes,
                    ignore_thresh=self.ignore_thresh,
                    downsample_ratio=self.downsamples[i])
                s = loss.sum()
                total = s if total is None else total + s
            return total
        if im_shape is None:
            raise ValueError("YOLOv3 in eval mode takes im_shape")
        boxes, scores = self.decode(outs, im_shape, score_threshold)
        return multiclass_nms(
            boxes, scores, score_threshold=score_threshold,
            nms_top_k=nms_top_k, keep_top_k=keep_top_k,
            nms_threshold=nms_threshold, background_label=-1)


def yolov3_darknet53(num_classes=80, **kwargs):
    return YOLOv3(num_classes=num_classes, **kwargs)
