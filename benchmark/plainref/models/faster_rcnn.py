"""Faster R-CNN, assembled (port of ``cald_tpu/models/faster_rcnn.py``).

Images arrive as fixed-canvas padded NHWC batches of raw 0..255 pixels with
their valid (h, w); ``detect`` returns exactly ``detections_per_img`` slots per
image with the CALD extras, and ``loss`` the four training losses. Inside the
backbone tensors are NCHW in ``torch.channels_last`` format; the pyramid
handed to RoIAlign is NHWC. RoIAlign is ``ops/roi_align.py``'s plain
version, differentiable by autograd.

Backbones: ResNet-50 (``resnet50``, FPN on C2..C5, RoIAlign on P2..P5) and
its ``tiny`` miniature; any other name is ``models/backbones/<name>.py``,
built with the configuration's ``backbone_args``.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from plainref.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from plainref.models import backbones
from plainref.models.anchors import ASPECT_RATIOS, FRCNN_SIZES, generate_anchors
from plainref.models.detections import Detections
from plainref.models.fpn import FPN
from plainref.models.matcher import Draw
from plainref.models.resnet import ResNetBackbone
from plainref.models.roi_heads import (
    FastRCNNPredictor, TwoMLPHead, fastrcnn_loss, pool_box_features,
    postprocess_detections, select_training_samples,
)
from plainref.models.rpn import RPNHead, rpn_loss, select_proposals
from plainref.ops.roi_align import multi_scale_roi_align

# ResNet backbones: (blocks per stage, width)
BACKBONES = {"resnet50": ((3, 4, 6, 3), 64), "tiny": ((1, 1, 1, 1), 16)}
# the FPN inputs of each backbone
RESNET_KEYS = ("c2", "c3", "c4", "c5")


@dataclasses.dataclass(frozen=True)
class FasterRCNNConfig:
    """Architecture, training and inference configuration (the JAX package's
    defaults)."""

    num_classes: int = 21
    backbone: str = "resnet50"          # resnet50 | tiny | models/backbones/<name>.py
    # the keywords of a backbone of models/backbones/ (its published widths)
    backbone_args: dict = dataclasses.field(default_factory=dict, hash=False)
    norm: str = "frozen"                # the backbone's norms: frozen | group
    # conv/matmul compute dtype; box decoding, NMS and scores stay float32
    compute_dtype: str = "bfloat16"
    fpn_channels: int = 256
    anchor_sizes: tuple = FRCNN_SIZES
    aspect_ratios: tuple = ASPECT_RATIOS
    rpn_pre_nms_top_n_train: int = 2000
    rpn_pre_nms_top_n_test: int = 1000
    rpn_post_nms_top_n_train: int = 2000
    rpn_post_nms_top_n_test: int = 1000
    rpn_nms_thresh: float = 0.7
    rpn_fg_iou: float = 0.7
    rpn_bg_iou: float = 0.3
    rpn_batch_size_per_image: int = 256
    rpn_positive_fraction: float = 0.5
    box_score_thresh: float = 0.05
    box_nms_thresh: float = 0.5
    detections_per_img: int = 100
    box_fg_iou: float = 0.5
    box_bg_iou: float = 0.5
    box_batch_size_per_image: int = 512
    box_positive_fraction: float = 0.25
    representation_size: int = 1024

    @property
    def strides(self) -> tuple[int, ...]:
        return (4, 8, 16, 32, 64)

    @property
    def roi_levels(self) -> int:
        """Pyramid levels RoIAlign uses: all but the RPN-only P6."""
        return len(self.strides) - 1


def _valid_mask(h: int, w: int, valid_hw: torch.Tensor, dtype) -> torch.Tensor:
    """(B, H, W, 1) indicator of the valid (non-padding) canvas region."""
    rows = torch.arange(h, device=valid_hw.device)[None, :] < valid_hw[:, 0:1]
    cols = torch.arange(w, device=valid_hw.device)[None, :] < valid_hw[:, 1:2]
    return (rows[:, :, None] & cols[:, None, :]).to(dtype)[..., None]


def normalized_input(images: torch.Tensor, valid_hw: torch.Tensor, mean: torch.Tensor,
                     std: torch.Tensor, dtype: torch.dtype | None) -> torch.Tensor:
    """Raw NHWC canvas pixels -> the backbone's NCHW channels-last input:
    ImageNet-normalized, cast to ``dtype``, with the canvas padding zeroed in
    NORMALIZED space, as the reference normalizes each image first and
    zero-pads the batch after."""
    x = (images / 255.0 - mean) / std
    if dtype is not None:
        x = x.to(dtype)
    x = x * _valid_mask(images.shape[1], images.shape[2], valid_hw, x.dtype)
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


class FasterRCNN(nn.Module):
    def __init__(self, cfg: FasterRCNNConfig):
        super().__init__()
        self.cfg = cfg
        dt = None if cfg.compute_dtype == "float32" else getattr(torch, cfg.compute_dtype)
        self.dtype = dt
        if cfg.backbone in BACKBONES:
            self.feat_keys = RESNET_KEYS
            blocks, width = BACKBONES[cfg.backbone]
            self.backbone = ResNetBackbone(blocks, width, dtype=dt, norm=cfg.norm)
        else:
            self.backbone = backbones.build(cfg.backbone, cfg.backbone_args, dt, cfg.norm)
            self.feat_keys = tuple(self.backbone.out_keys)
        self.fpn = FPN(self.backbone.out_channels, cfg.fpn_channels, dtype=dt)
        a_per_cell = len(cfg.anchor_sizes[0]) * len(cfg.aspect_ratios)
        self.rpn_head = RPNHead(a_per_cell, cfg.fpn_channels, dtype=dt)
        pooled = 7 * 7 * cfg.fpn_channels
        self.box_head = TwoMLPHead(pooled, cfg.representation_size, dtype=dt)
        self.box_predictor = FastRCNNPredictor(cfg.representation_size, cfg.num_classes,
                                               dtype=dt)
        self._anchor_cache: dict = {}
        # the correctness control rounds the float32 stages' inputs and
        # outputs with it (None: the configuration's precision)
        self.lowp = None
        # on the model's device, so that normalizing copies nothing from the host
        self.register_buffer("pixel_mean", torch.from_numpy(IMAGENET_MEAN), persistent=False)
        self.register_buffer("pixel_std", torch.from_numpy(IMAGENET_STD), persistent=False)

    def features(self, images: torch.Tensor, valid_hw: torch.Tensor) -> list[torch.Tensor]:
        """FPN pyramid, NCHW channels-last tensors, finest first (P2..P6)."""
        x = normalized_input(images, valid_hw, self.pixel_mean, self.pixel_std, self.dtype)
        feats = self.backbone(x)
        return self.fpn([feats[k] for k in self.feat_keys])

    def _anchors(self, pyramid, device):
        cfg = self.cfg
        shapes = tuple(tuple(f.shape[-2:]) for f in pyramid)
        # anchors made under inference mode are inference tensors, which
        # autograd refuses to save: training never reuses them
        key = (shapes, str(device), torch.is_inference_mode_enabled())
        if key not in self._anchor_cache:
            self._anchor_cache[key] = generate_anchors(shapes, cfg.strides, cfg.anchor_sizes,
                                                       cfg.aspect_ratios, device)
        return self._anchor_cache[key]

    def _roi_levels(self, pyramid):
        """The NHWC levels RoIAlign reads and their spatial scales."""
        cfg = self.cfg
        levels = [f.permute(0, 2, 3, 1).contiguous() for f in pyramid[: cfg.roi_levels]]
        return levels, [1.0 / s for s in cfg.strides[: cfg.roi_levels]]

    def loss(self, images: torch.Tensor, valid_hw: torch.Tensor, gt_boxes: torch.Tensor,
             gt_labels: torch.Tensor, gt_valid: torch.Tensor, draw: Draw, *,
             per_image: bool = False, samples=None):
        """Training losses. images (B, H, W, 3) raw pixels; valid_hw (B, 2);
        gt_boxes (B, G, 4) canvas xyxy, gt_labels (B, G), gt_valid (B, G).
        ``draw`` supplies the samplers' Gumbel noise: streams 0/1 for the RPN
        sampler's positives/negatives, 2/3 for the box head's.

        Returns (losses, pyramid): dict(loss_objectness, loss_rpn_box_reg,
        loss_classifier, loss_box_reg) of scalars, or of (B,) vectors with
        ``per_image=True``, and the FPN pyramid (NCHW, finest first).
        ``samples`` (rois, labels, reg_targets, is_pos, valid) replaces the
        proposals and the box head's sampling: the check follows a program's
        step with the RoIs that program sampled.
        """
        cfg = self.cfg
        pyramid = self.features(images, valid_hw)
        objectness, deltas = self.rpn_head(pyramid)
        anchors, counts = self._anchors(pyramid, images.device)
        obj_loss, rpn_box_loss = rpn_loss(
            objectness, deltas, anchors, gt_boxes, gt_valid, draw,
            batch_size_per_image=cfg.rpn_batch_size_per_image,
            positive_fraction=cfg.rpn_positive_fraction, fg_iou=cfg.rpn_fg_iou,
            bg_iou=cfg.rpn_bg_iou, stream=0)

        # proposals are fixed inputs to the second stage (JAX's stop_gradient)
        if samples is None:
            samples = self.training_samples(objectness.detach(), deltas.detach(), anchors,
                                            counts, valid_hw, gt_boxes, gt_labels, gt_valid,
                                            draw)
        rois, labels, reg_targets, is_pos, valid = samples

        levels, scales = self._roi_levels(pyramid)
        box_feats = pool_box_features(levels, rois, valid, scales)    # (B, S, 7, 7, C) f32
        b, s = rois.shape[:2]
        rep = self.box_head(box_feats.reshape(b * s, -1))
        class_logits, box_regression = self.box_predictor(rep)
        cls_loss, box_loss = fastrcnn_loss(class_logits.reshape(b, s, -1),
                                           box_regression.reshape(b, s, -1), labels,
                                           reg_targets, is_pos, valid)
        losses = {"loss_objectness": obj_loss, "loss_rpn_box_reg": rpn_box_loss,
                  "loss_classifier": cls_loss, "loss_box_reg": box_loss}
        if not per_image:
            losses = {k: v.mean() for k, v in losses.items()}
        return losses, pyramid

    @torch.no_grad()
    def training_samples(self, objectness, deltas, anchors, counts, valid_hw, gt_boxes,
                         gt_labels, gt_valid, draw):
        """The training proposals and the box head's sampled RoIs:
        (rois, labels, reg_targets, is_pos, valid)."""
        cfg = self.cfg
        if self.lowp is not None:
            objectness, deltas = self.lowp(objectness), self.lowp(deltas)
        props, _, pvalid = select_proposals(
            objectness, deltas, anchors, counts, valid_hw,
            pre_nms_top_n=cfg.rpn_pre_nms_top_n_train,
            post_nms_top_n=cfg.rpn_post_nms_top_n_train, nms_thresh=cfg.rpn_nms_thresh)
        return select_training_samples(
            props, pvalid, gt_boxes, gt_labels, gt_valid, draw,
            batch_size_per_image=cfg.box_batch_size_per_image,
            positive_fraction=cfg.box_positive_fraction, fg_iou=cfg.box_fg_iou,
            bg_iou=cfg.box_bg_iou, stream=2)

    def detect(self, images: torch.Tensor, valid_hw: torch.Tensor) -> Detections:
        """images (B, H, W, 3) raw pixels; valid_hw (B, 2) int. Returns
        fixed-slot Detections in the canvas (resized-image) coordinates:
        ``detections_per_img`` slots."""
        cfg = self.cfg
        pyramid = self.features(images, valid_hw)
        objectness, deltas = self.rpn_head(pyramid)
        if self.lowp is not None:
            objectness, deltas = self.lowp(objectness), self.lowp(deltas)
        anchors, counts = self._anchors(pyramid, images.device)
        props, _, pvalid = select_proposals(
            objectness, deltas, anchors, counts, valid_hw,
            pre_nms_top_n=cfg.rpn_pre_nms_top_n_test,
            post_nms_top_n=cfg.rpn_post_nms_top_n_test, nms_thresh=cfg.rpn_nms_thresh)

        b, n = props.shape[:2]
        levels, scales = self._roi_levels(pyramid)
        props, pvalid = props.contiguous(), pvalid.contiguous()
        pooled = multi_scale_roi_align(levels, props, valid=pvalid, spatial_scales=scales)
        rep = self.box_head(pooled.reshape(b * n, -1))
        class_logits, box_regression = self.box_predictor(rep)
        class_logits, box_regression = class_logits.float(), box_regression.float()
        if self.lowp is not None:
            class_logits, box_regression, props = (
                self.lowp(class_logits), self.lowp(box_regression), self.lowp(props))
        dets = postprocess_detections(
            class_logits.reshape(b, n, -1), box_regression.reshape(b, n, -1), props, pvalid,
            valid_hw, score_thresh=cfg.box_score_thresh, nms_thresh=cfg.box_nms_thresh,
            detections_per_img=cfg.detections_per_img)
        return dets if self.lowp is None else dets.map(self.lowp)

    def forward(self, images: torch.Tensor, valid_hw: torch.Tensor) -> Detections:
        return self.detect(images, valid_hw)
