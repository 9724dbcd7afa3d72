"""RetinaNet (port of ``cald_tpu/models/retinanet.py``; the reference's
retinanet_cal).

  - ResNet-50-FPN on C3..C5 with LastLevelP6P7 (P3..P7), the ``tiny``
    miniature, or MobileNetV3-Large's C5 through a 1x1 ``reduce`` conv to
    one stride-32 level;
  - 4-conv classification and regression subnets shared across levels, the
    classification bias at the focal prior -log((1-pi)/pi), pi = 0.01
    (``models/init.py``);
  - the sigmoid focal loss summed over the non-ignored anchors and the L1
    box loss over the foreground, both over the image's foreground count,
    with the 0.5/0.4 matcher and low-quality matches;
  - detection: per-level top ``topk_candidates`` (anchor, class) pairs,
    decoded and clipped; candidates need score > 0.05, sides >= 1e-2 and a
    label > 0; one class-aware NMS over the union into
    ``detections_per_img`` slots, with each kept anchor's full sigmoid row
    (``scores_cls``) and its max (``prob_max``).

The JAX package's documented deviations from the reference hold here too
(its module docstring): the per-level top-k envelope with one global NMS,
no channel-0 detections, and the SSM variant as NMS 0.3 through this
postprocess. The per-level top-k is ``torch.topk``, which may order equal
scores differently from ``jax.lax.top_k``; equal scores that can survive
the 0.05 filter need logits equal to the last bit.

Images arrive as fixed-canvas padded NHWC batches of raw 0..255 pixels with
their valid (h, w), as for ``FasterRCNN``; the pyramid is NCHW
(channels-last). RetinaNet runs no RoIAlign and never the fused
bottlenecks, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from cald_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from cald_tpu_torch.models.anchors import (
    ASPECT_RATIOS, MOBILE_RETINA_SIZES, RETINA_SIZES, generate_anchors,
)
from cald_tpu_torch.models.detections import Detections
from cald_tpu_torch.models.faster_rcnn import BACKBONES, normalized_input
from cald_tpu_torch.models.fpn import FPN
from cald_tpu_torch.models.layers import Conv
from cald_tpu_torch.models.matcher import BETWEEN, Draw, match_anchors
from cald_tpu_torch.models.mobilenetv3 import MobileNetV3Backbone
from cald_tpu_torch.models.resnet import ResNetBackbone
from cald_tpu_torch.ops.boxes import clip_boxes, decode_boxes, encode_boxes
from cald_tpu_torch.ops.losses import sigmoid_focal_loss
from cald_tpu_torch.ops.nms import batched_nms
from cald_tpu_torch.utils.spans import span


@dataclasses.dataclass(frozen=True)
class RetinaNetConfig:
    num_classes: int = 21               # the channel space includes background 0
    backbone: str = "resnet50"          # resnet50 | tiny | mobilenet
    norm: str = "frozen"
    compute_dtype: str = "bfloat16"
    fpn_channels: int = 256
    anchor_sizes: tuple = RETINA_SIZES
    aspect_ratios: tuple = ASPECT_RATIOS
    fg_iou: float = 0.5
    bg_iou: float = 0.4
    prior_probability: float = 0.01
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    score_thresh: float = 0.05
    nms_thresh: float = 0.5
    detections_per_img: int = 300
    topk_candidates: int = 1000

    @property
    def strides(self) -> tuple[int, ...]:
        if self.backbone == "mobilenet":
            return (32,)
        return (8, 16, 32, 64, 128)      # P3..P7


class RetinaNetHead(nn.Module):
    """The shared subnets. ``forward`` maps NCHW levels to logits (B, N, C)
    and regressions (B, N, 4) in float32, N ordered (level, y, x, anchor)
    as the anchors are: each output is made channels-last before the
    reshape, as Flax reshapes its NHWC (B, H, W, A*C)."""

    def __init__(self, num_classes: int, num_anchors: int, channels: int = 256,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.num_classes = num_classes
        for i in range(4):
            self.add_module(f"cls_conv{i}", Conv(channels, channels, 3, padding=1, dtype=dtype))
            self.add_module(f"reg_conv{i}", Conv(channels, channels, 3, padding=1, dtype=dtype))
        self.cls_logits = Conv(channels, num_anchors * num_classes, 3, padding=1, dtype=dtype)
        self.bbox_reg = Conv(channels, num_anchors * 4, 3, padding=1, dtype=dtype)

    def _tower(self, f: torch.Tensor, kind: str) -> torch.Tensor:
        for i in range(4):
            f = F.relu(getattr(self, f"{kind}_conv{i}")(f))
        return f

    def forward(self, pyramid: Sequence[torch.Tensor]):
        logits, regs = [], []
        for f in pyramid:
            b = f.shape[0]
            logits.append(self.cls_logits(self._tower(f, "cls")).permute(0, 2, 3, 1)
                          .reshape(b, -1, self.num_classes).float())
            regs.append(self.bbox_reg(self._tower(f, "reg")).permute(0, 2, 3, 1)
                        .reshape(b, -1, 4).float())
        return torch.cat(logits, dim=1), torch.cat(regs, dim=1)


def retinanet_losses(cls_logits: torch.Tensor, bbox_reg: torch.Tensor, anchors: torch.Tensor,
                     gt_boxes: torch.Tensor, gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                     *, num_classes: int, fg_iou: float, bg_iou: float, alpha: float,
                     gamma: float):
    """Per-image (classification (B,), bbox_regression (B,)) losses.
    cls_logits (B, N, C), bbox_reg (B, N, 4), anchors (N, 4), gt_boxes
    (B, G, 4), gt_labels (B, G), gt_valid (B, G)."""
    matches = match_anchors(gt_boxes, gt_valid, anchors, high=fg_iou, low=bg_iou,
                            allow_low_quality=True)                          # (B, N)
    fg = matches >= 0
    num_fg = fg.sum(dim=1).to(cls_logits.dtype).clamp_min(1.0)
    valid = (matches != BETWEEN).to(cls_logits.dtype)
    m = matches.clamp_min(0)
    # one-hot of the matched label, all zero for background and ignored anchors
    target = torch.where(fg, torch.gather(gt_labels.long(), 1, m), torch.full_like(m, -1))
    classes = torch.arange(num_classes, device=target.device)
    onehot = (target[..., None] == classes).to(cls_logits.dtype)
    focal = sigmoid_focal_loss(cls_logits, onehot, alpha=alpha, gamma=gamma)
    cls_loss = (focal.sum(dim=-1) * valid).sum(dim=1) / num_fg

    reg_targets = encode_boxes(torch.gather(gt_boxes, 1, m[..., None].expand(-1, -1, 4)),
                               anchors)
    l1 = (bbox_reg - reg_targets).abs().sum(dim=-1)
    reg_loss = (l1 * fg.to(l1.dtype)).sum(dim=1) / num_fg
    return cls_loss, reg_loss


def retinanet_postprocess(cls_logits: torch.Tensor, bbox_reg: torch.Tensor,
                          anchors: torch.Tensor, level_counts: Sequence[int],
                          valid_hw: torch.Tensor, *, score_thresh: float, nms_thresh: float,
                          detections_per_img: int, topk_candidates: int,
                          min_size: float = 1e-2) -> Detections:
    """cls_logits (B, N, C), bbox_reg (B, N, 4), anchors (N, 4), valid_hw
    (B, 2) -> Detections with ``detections_per_img`` slots. Anchors centred
    on canvas padding (outside ``valid_hw``) are never candidates; ``props``
    is zero."""
    b, _, c = cls_logits.shape
    hw = valid_hw.to(anchors.dtype)
    cx = (anchors[:, 0] + anchors[:, 2]) * 0.5
    cy = (anchors[:, 1] + anchors[:, 3]) * 0.5
    inside = (cx[None] < hw[:, 1:2]) & (cy[None] < hw[:, 0:1])               # (B, N)
    # zeroed rows never pass the score filter, so kept detections always
    # index unmasked rows
    scores_all = torch.sigmoid(cls_logits) * inside[..., None].to(cls_logits.dtype)

    cand_scores, cand_boxes, cand_labels, cand_anchor = [], [], [], []
    offset = 0
    for cnt in level_counts:
        k = min(topk_candidates, cnt * c)
        top_v, top_i = torch.topk(scores_all[:, offset:offset + cnt].reshape(b, -1), k, dim=1)
        a_idx = top_i // c + offset
        reg = torch.gather(bbox_reg, 1, a_idx[..., None].expand(-1, -1, 4))
        cand_scores.append(top_v)
        cand_boxes.append(decode_boxes(reg, anchors[a_idx]))
        cand_labels.append(top_i % c)
        cand_anchor.append(a_idx)
        offset += cnt
    scores = torch.cat(cand_scores, dim=1)
    boxes = clip_boxes(torch.cat(cand_boxes, dim=1), (hw[:, 0:1], hw[:, 1:2]))
    labels = torch.cat(cand_labels, dim=1)
    anchor_idx = torch.cat(cand_anchor, dim=1)
    ws = boxes[..., 2] - boxes[..., 0]
    hs = boxes[..., 3] - boxes[..., 1]
    # background channel 0 is never a detection (gt labels are 1-based)
    cand = (scores > score_thresh) & (ws >= min_size) & (hs >= min_size) & (labels > 0)

    keep_idx, mask = batched_nms(boxes, scores, labels, iou_threshold=nms_thresh,
                                 max_outputs=detections_per_img, valid=cand,
                                 pre_nms_size=min(boxes.shape[1], 2048))
    m = mask.to(scores.dtype)
    kept_anchor = torch.gather(anchor_idx, 1, keep_idx)
    rows = torch.gather(scores_all, 1, kept_anchor[..., None].expand(-1, -1, c))   # (B, K, C)
    return Detections(
        boxes=torch.gather(boxes, 1, keep_idx[..., None].expand(-1, -1, 4)) * m[..., None],
        scores=torch.gather(scores, 1, keep_idx) * m,
        labels=torch.gather(labels, 1, keep_idx).to(torch.int32) * mask,
        valid=mask,
        scores_cls=rows * m[..., None],
        prob_max=rows.amax(dim=-1) * m,
        props=boxes.new_zeros((b, keep_idx.shape[1], 4)),
    )


class RetinaNet(nn.Module):
    def __init__(self, cfg: RetinaNetConfig):
        super().__init__()
        self.cfg = cfg
        dt = None if cfg.compute_dtype == "float32" else getattr(torch, cfg.compute_dtype)
        self.dtype = dt
        if cfg.backbone == "mobilenet":
            self.feat_keys = ("c5",)
            self.backbone = MobileNetV3Backbone(self.feat_keys, norm=cfg.norm, dtype=dt)
            # the single 960 -> 256 1x1 feature (retinanet_cal.py:685-716)
            self.fpn = None
            self.reduce = Conv(self.backbone.out_channels[-1], cfg.fpn_channels, 1, dtype=dt)
        elif cfg.backbone in BACKBONES:
            self.feat_keys = ("c3", "c4", "c5")
            blocks, width = BACKBONES[cfg.backbone]
            self.backbone = ResNetBackbone(blocks, width, dtype=dt, norm=cfg.norm)
            self.fpn = FPN(self.backbone.out_channels[1:], cfg.fpn_channels, dtype=dt,
                           extra="p6p7")
        else:
            raise ValueError(f"unknown backbone {cfg.backbone!r}")
        a_per_cell = len(cfg.anchor_sizes[0]) * len(cfg.aspect_ratios)
        self.head = RetinaNetHead(cfg.num_classes, a_per_cell, cfg.fpn_channels, dtype=dt)
        self._anchor_cache: dict = {}
        self.register_buffer("pixel_mean", torch.from_numpy(IMAGENET_MEAN), persistent=False)
        self.register_buffer("pixel_std", torch.from_numpy(IMAGENET_STD), persistent=False)

    def features(self, images: torch.Tensor, valid_hw: torch.Tensor) -> list[torch.Tensor]:
        """The pyramid, NCHW channels-last, finest first: P3..P7, or the one
        reduced MobileNet level."""
        x = normalized_input(images, valid_hw, self.pixel_mean, self.pixel_std, self.dtype)
        feats = self.backbone(x)
        maps = [feats[k] for k in self.feat_keys]
        if self.fpn is None:
            return [self.reduce(maps[-1])]
        return self.fpn(maps)

    def _anchors(self, pyramid, device):
        cfg = self.cfg
        shapes = tuple(tuple(f.shape[-2:]) for f in pyramid)
        key = (shapes, str(device), torch.is_inference_mode_enabled())
        if key not in self._anchor_cache:
            self._anchor_cache[key] = generate_anchors(shapes, cfg.strides, cfg.anchor_sizes,
                                                       cfg.aspect_ratios, device)
        return self._anchor_cache[key]

    def loss(self, images: torch.Tensor, valid_hw: torch.Tensor, gt_boxes: torch.Tensor,
             gt_labels: torch.Tensor, gt_valid: torch.Tensor, draw: Draw | None = None, *,
             per_image: bool = False):
        """Returns ({'classification', 'bbox_regression'}, pyramid): scalars,
        or (B,) vectors with ``per_image=True``. ``draw`` is taken for the
        detectors' common interface; RetinaNet samples nothing."""
        cfg = self.cfg
        pyramid = self.features(images, valid_hw)
        cls_logits, bbox_reg = self.head(pyramid)
        anchors, _ = self._anchors(pyramid, images.device)
        cls_loss, reg_loss = retinanet_losses(
            cls_logits, bbox_reg, anchors, gt_boxes, gt_labels, gt_valid,
            num_classes=cfg.num_classes, fg_iou=cfg.fg_iou, bg_iou=cfg.bg_iou,
            alpha=cfg.focal_alpha, gamma=cfg.focal_gamma)
        losses = {"classification": cls_loss, "bbox_regression": reg_loss}
        if not per_image:
            losses = {k: v.mean() for k, v in losses.items()}
        return losses, pyramid

    def detect(self, images: torch.Tensor, valid_hw: torch.Tensor) -> Detections:
        """images (B, H, W, 3) raw pixels; valid_hw (B, 2) int ->
        ``detections_per_img`` slots per image in canvas coordinates."""
        cfg = self.cfg
        with span("detect.trunk"):
            pyramid = self.features(images, valid_hw)
        with span("detect.head"):
            cls_logits, bbox_reg = self.head(pyramid)
        with span("detect.postprocess"):
            anchors, counts = self._anchors(pyramid, images.device)
            return retinanet_postprocess(
                cls_logits, bbox_reg, anchors, counts, valid_hw, score_thresh=cfg.score_thresh,
                nms_thresh=cfg.nms_thresh, detections_per_img=cfg.detections_per_img,
                topk_candidates=cfg.topk_candidates)

    def forward(self, images: torch.Tensor, valid_hw: torch.Tensor) -> Detections:
        return self.detect(images, valid_hw)


def retinanet_resnet50_fpn_cal(num_classes: int = 21, **kw) -> RetinaNet:
    """The reference constructor (retinanet_cal.py:584)."""
    return RetinaNet(RetinaNetConfig(num_classes=num_classes, backbone="resnet50", **kw))


def retinanet_mobilenet(num_classes: int = 21, **kw) -> RetinaNet:
    """The single-level MobileNetV3-Large variant (retinanet_cal.py:628-665)."""
    kw.setdefault("anchor_sizes", MOBILE_RETINA_SIZES)
    return RetinaNet(RetinaNetConfig(num_classes=num_classes, backbone="mobilenet", **kw))
