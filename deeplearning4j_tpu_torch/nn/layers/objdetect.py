"""Object detection: the YOLOv2 output layer (port of
``nn/layers/objdetect.py``).

NHWC layout, as in the JAX package:

  network activations  [b, H, W, B*(5+C)]   per box: (tx, ty, tw, th, tconf)
  labels               [b, H, W, 4+C]       (x1, y1, x2, y2) in GRID units
                                            + one-hot class; an all-zero
                                            class vector: no object there

Loss (YOLOv2): the responsible predictor of an object cell is its
best-IoU box (argmax, the first of equal IoUs, under ``detach``);
position and size L2 on (sigmoid(xy) + cell, sqrt(wh)); confidence
targets the IoU for responsible boxes and 0 elsewhere (λ_noobj
weighted); softmax cross-entropy over the classes.  The clips are
``jnp.clip``'s ``minimum(maximum(x, lo), hi)`` (``activations._clip``):
on a bound each side takes half the gradient, as in JAX, where
``torch.clamp`` would pass all of it.  The loss ignores a mask
(``SUPPORTS_LOSS_MASK = False``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from ...utils.device import constant
from ...utils.serde import register_serde
from .. import activations as _act
from ..conf.input_type import InputType
from .base import LayerConf


@register_serde
@dataclass
class Yolo2OutputLayer(LayerConf):
    """YOLOv2 detection head: no params, the loss over conv features."""
    boxes: List[List[float]] = field(default_factory=lambda: [[1.0, 1.0]])
    lambda_coord: float = 5.0
    lambda_no_obj: float = 0.5

    INPUT_KIND = "cnn"
    SUPPORTS_LOSS_MASK = False

    def output_type(self, itype: InputType) -> InputType:
        return itype

    def has_params(self):
        return False

    def n_boxes(self):
        return len(self.boxes)

    def n_classes(self, channels: int) -> int:
        return channels // self.n_boxes() - 5

    def _split(self, x):
        """[b,H,W,B*(5+C)] -> xy [b,H,W,B,2], wh, conf [b,H,W,B],
        cls [b,H,W,B,C]."""
        b, H, W, ch = x.shape
        B = self.n_boxes()
        x = x.reshape(b, H, W, B, 5 + self.n_classes(ch))
        return x[..., 0:2], x[..., 2:4], x[..., 4], x[..., 5:]

    @staticmethod
    def _cell_offsets(H, W, like):
        gy, gx = torch.meshgrid(
            torch.arange(H, dtype=like.dtype, device=like.device),
            torch.arange(W, dtype=like.dtype, device=like.device),
            indexing="ij")
        return torch.stack([gx, gy], dim=-1)              # [H, W, 2] (x, y)

    def _boxes(self, txy, twh):
        """Predicted centres and sizes in grid units."""
        H, W = txy.shape[1], txy.shape[2]
        cell = self._cell_offsets(H, W, txy)
        priors = constant([v for box in self.boxes for v in box],
                          txy.dtype, txy.device).reshape(-1, 2)
        xy = torch.sigmoid(txy) + cell[None, :, :, None, :]
        wh = priors[None, None, None] * torch.exp(_act._clip(twh, -10, 10))
        return xy, wh

    def apply(self, params, x, *, train=False, key=None):
        """Activated predictions [b,H,W,B,5+C] in grid units:
        sigmoid(xy) + cell, priors·exp(wh), sigmoid(conf),
        softmax(classes)."""
        txy, twh, tconf, tcls = self._split(x)
        xy, wh = self._boxes(txy, twh)
        return torch.cat([xy, wh, torch.sigmoid(tconf)[..., None],
                          torch.softmax(tcls, dim=-1)], dim=-1)

    def compute_loss(self, params, x, labels, *, train=False, key=None,
                     mask=None, average=True):
        txy, twh, tconf, tcls = self._split(x)
        b, B = tconf.shape[0], tconf.shape[-1]
        dtype = x.dtype
        pred_xy, pred_wh = self._boxes(txy, twh)
        pred_conf = torch.sigmoid(tconf)

        labels = labels.to(dtype)
        gt_x1y1, gt_x2y2, gt_cls = labels[..., 0:2], labels[..., 2:4], \
            labels[..., 4:]
        obj = (torch.sum(gt_cls, dim=-1) > 0).to(dtype)       # [b,H,W]
        gt_xy = 0.5 * (gt_x1y1 + gt_x2y2)
        gt_wh = torch.maximum(gt_x2y2 - gt_x1y1, gt_x1y1.new_tensor(1e-6))

        iou = self._iou(pred_xy, pred_wh, gt_xy[..., None, :],
                        gt_wh[..., None, :])                   # [b,H,W,B]
        best = F.one_hot(torch.argmax(iou.detach(), dim=-1), B).to(dtype)
        resp = best * obj[..., None]

        d_xy = torch.sum((pred_xy - gt_xy[..., None, :]) ** 2, dim=-1)
        d_wh = torch.sum((torch.sqrt(pred_wh)
                          - torch.sqrt(gt_wh[..., None, :])) ** 2, dim=-1)
        loss_coord = torch.sum(resp * (d_xy + d_wh))

        conf_tgt = iou.detach()
        loss_conf = torch.sum(resp * (pred_conf - conf_tgt) ** 2) + \
            self.lambda_no_obj * torch.sum((1 - resp) * pred_conf ** 2)

        logp = torch.log_softmax(tcls, dim=-1)
        cls_xent = -torch.sum(gt_cls[..., None, :] * logp, dim=-1)
        loss_cls = torch.sum(resp * cls_xent)

        total = self.lambda_coord * loss_coord + loss_conf + loss_cls
        return total / b if average else total

    @staticmethod
    def _iou(xy1, wh1, xy2, wh2):
        min1, max1 = xy1 - wh1 / 2, xy1 + wh1 / 2
        min2, max2 = xy2 - wh2 / 2, xy2 + wh2 / 2
        side = torch.minimum(max1, max2) - torch.maximum(min1, min2)
        inter = torch.prod(torch.maximum(side, side.new_tensor(0.0)), dim=-1)
        a1 = torch.prod(wh1, dim=-1)
        a2 = torch.prod(wh2, dim=-1)
        return inter / (a1 + a2 - inter + 1e-9)


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def get_predicted_objects(activated, threshold: float = 0.5):
    """Decode [b,H,W,B,5+C] activated predictions into per-image
    detections (reference ``YoloUtils.getPredictedObjects``): a list over
    the batch of ``[n, 6]`` float32 arrays (x1, y1, x2, y2, confidence,
    class index) in grid units, in (row, column, box) order."""
    acts = _host(activated)
    out = []
    for img in acts:
        conf = img[..., 4]
        r, c, bi = np.nonzero(conf >= threshold)
        p = img[r, c, bi]
        cls = np.argmax(p[:, 5:], axis=-1)
        cx, cy, w, h = p[:, 0], p[:, 1], p[:, 2], p[:, 3]
        score = (p[:, 4] * p[np.arange(len(p)), 5 + cls]).astype(np.float64)
        dets = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2,
                         score, cls], axis=-1) if len(p) else np.zeros((0, 6))
        out.append(np.asarray(dets, dtype=np.float32).reshape(-1, 6))
    return out


def non_max_suppression(detections, iou_threshold: float = 0.45):
    """Greedy per-class NMS over one image's ``[n, 6]`` detections
    (x1, y1, x2, y2, score, class), reference ``YoloUtils.nms``.  Returns
    the surviving rows, score-descending."""
    dets = np.asarray(_host(detections), np.float32).reshape(-1, 6)
    if len(dets) == 0:
        return dets
    keep = []
    for cls in np.unique(dets[:, 5]):
        d = dets[dets[:, 5] == cls]
        d = d[np.argsort(-d[:, 4])]
        while len(d):
            best = d[0]
            keep.append(best)
            if len(d) == 1:
                break
            rest = d[1:]
            ix1 = np.maximum(best[0], rest[:, 0])
            iy1 = np.maximum(best[1], rest[:, 1])
            ix2 = np.minimum(best[2], rest[:, 2])
            iy2 = np.minimum(best[3], rest[:, 3])
            inter = (np.clip(ix2 - ix1, 0, None)
                     * np.clip(iy2 - iy1, 0, None))
            a1 = (best[2] - best[0]) * (best[3] - best[1])
            a2 = ((rest[:, 2] - rest[:, 0])
                  * (rest[:, 3] - rest[:, 1]))
            iou = inter / np.maximum(a1 + a2 - inter, 1e-9)
            d = rest[iou < iou_threshold]
    out = np.asarray(keep, np.float32).reshape(-1, 6)
    return out[np.argsort(-out[:, 4])]
