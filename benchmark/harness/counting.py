"""The yardstick's arithmetic: the card's peaks, the model's operations from
shapes, and K1's bytes and operations (copied from ``chip_smoke.py``'s
``bound`` and ``roi_work``).

``detect_flops`` counts the convolutions and matrix products a detect needs
at a canvas shape (2 operations a multiply-add): backbone, FPN, RPN head
and box head (Faster R-CNN, at every proposal slot) or RetinaNet's subnets.
A product between activations (a bmm, attention's QK^T and AV) counts 2
operations a multiply-add too, as ``FlopCounterMode`` counts it. NMS,
RoIAlign, normalisation, softmax and elementwise work are left out. The
count is a function of the configuration and the shape alone, whatever
implements the layers; ``benchmark/tests`` holds it to
``torch.utils.flop_counter.FlopCounterMode`` on the plain reference.

The backbone's count is ``backbone_flops`` for ResNet (``resnet50``,
``tiny``); a backbone of any other name brings ``counts/<name>.py``, whose
``backbone_flops(cfg, h, w)`` gives (operations, [(channels, h, w) of each
map the backbone returns, finest first]) from the detector configuration
``cfg`` (its ``backbone_args``) and the canvas.
"""

from __future__ import annotations

import importlib
from pathlib import Path

# H100 SXM peaks (NVIDIA's data sheet, dense, at 700 W): HBM bytes/s, bf16
# tensor-core and float32 (outside the tensor cores) operations/s
HBM_BYTES_S = 3.35e12
BF16_OPS_S = 989e12
F32_OPS_S = 67e12

RESNET50 = ((3, 4, 6, 3), 64)
# ResNets by the configuration's name: (blocks per stage, width)
RESNETS = {"resnet50": RESNET50, "tiny": ((1, 1, 1, 1), 16)}
COUNTS = Path(__file__).resolve().parent / "counts"


def _conv(cin: int, cout: int, k: int, h: int, w: int, stride: int = 1, pad: int = 0):
    ho = (h + 2 * pad - k) // stride + 1
    wo = (w + 2 * pad - k) // stride + 1
    return 2 * cin * cout * k * k * ho * wo, ho, wo


def backbone_flops(h: int, w: int, blocks=RESNET50[0], width: int = RESNET50[1]):
    """(operations, [(channels, h, w) of C2..C5]) of ResNet on one image."""
    f, h, w = _conv(3, width, 7, h, w, 2, 3)
    h, w = (h + 2 - 3) // 2 + 1, (w + 2 - 3) // 2 + 1          # max pool 3, stride 2
    total, maps, cin = f, [], width
    for stage, n in enumerate(blocks):
        planes = width * 2 ** stage
        for b in range(n):
            stride = 2 if (b == 0 and stage > 0) else 1
            f1, _, _ = _conv(cin, planes, 1, h, w)
            f2, ho, wo = _conv(planes, planes, 3, h, w, stride, 1)
            f3, _, _ = _conv(planes, planes * 4, 1, ho, wo)
            total += f1 + f2 + f3
            if cin != planes * 4 or stride != 1:
                total += _conv(cin, planes * 4, 1, h, w, stride)[0]
            cin, h, w = planes * 4, ho, wo
        maps.append((cin, h, w))
    return total, maps


def fpn_flops(maps, channels: int, extra: str):
    """(operations, [(h, w) of every pyramid level]) of the FPN on ``maps``."""
    total, levels = 0, []
    for cin, h, w in maps:
        total += _conv(cin, channels, 1, h, w)[0] + _conv(channels, channels, 3, h, w, 1, 1)[0]
        levels.append((h, w))
    h, w = levels[-1]
    if extra == "pool":
        levels.append(((h + 1) // 2, (w + 1) // 2))
    elif extra == "p6p7":
        for _ in range(2):
            f, h, w = _conv(channels, channels, 3, h, w, 2, 1)
            total += f
            levels.append((h, w))
    return total, levels


def backbone_counts(cfg, h: int, w: int):
    """(operations, [(channels, h, w) of each map]) of the backbone that
    ``cfg.backbone`` names, on one image of an (h, w) canvas."""
    if cfg.backbone in RESNETS:
        return backbone_flops(h, w, *RESNETS[cfg.backbone])
    path = COUNTS / f"{cfg.backbone}.py"
    if not cfg.backbone.isidentifier() or not path.is_file():
        raise ValueError(f"no operation count for backbone {cfg.backbone!r}: no file {path}")
    return importlib.import_module(f"harness.counts.{cfg.backbone}").backbone_flops(cfg, h, w)


def detect_flops(cfg, h: int, w: int) -> int:
    """Operations of one detect of one image on an (h, w) canvas, for a
    detector configuration ``cfg`` (the reference's ``FasterRCNNConfig`` or
    ``RetinaNetConfig``)."""
    c = cfg.fpn_channels
    classes = cfg.num_classes
    anchors = len(cfg.anchor_sizes[0]) * len(cfg.aspect_ratios)
    total, maps = backbone_counts(cfg, h, w)
    if hasattr(cfg, "rpn_post_nms_top_n_test"):
        f, levels = fpn_flops(maps, c, "pool")
        total += f
        for lh, lw in levels:
            total += (_conv(c, c, 3, lh, lw, 1, 1)[0] + _conv(c, anchors, 1, lh, lw)[0]
                      + _conv(c, 4 * anchors, 1, lh, lw)[0])
        n, rep = cfg.rpn_post_nms_top_n_test, cfg.representation_size
        total += 2 * n * (7 * 7 * c * rep + rep * rep + rep * classes + rep * 4 * classes)
    else:
        f, levels = fpn_flops(maps[1:], c, "p6p7")
        total += f
        for lh, lw in levels:
            tower = 8 * _conv(c, c, 3, lh, lw, 1, 1)[0]
            total += (tower + _conv(c, anchors * classes, 3, lh, lw, 1, 1)[0]
                      + _conv(c, anchors * 4, 3, lh, lw, 1, 1)[0])
    return int(total)


def bound_s(n_bytes: float, n_ops: float, ops_per_s: float) -> float:
    """The least time the card could take for work that moves ``n_bytes``
    (each input read once, each output written once) and does ``n_ops``
    operations at ``ops_per_s``."""
    return max(n_bytes / HBM_BYTES_S, n_ops / ops_per_s)


def roi_work(level_shapes, elem_size: int, rois, valid, levels, scales,
             output_size: int = 7, sr: int = 2) -> tuple[int, float]:
    """What a RoIAlign over these inputs must touch: (bytes of the level
    pixels that the valid rois' bilinear taps read, each once, plus the
    output written and the rois, flags and levels read; operations, one
    multiply and one add per tap and channel: S*S*sr*sr samples x 4 corners
    per valid roi). ``level_shapes`` are the NHWC levels' shapes."""
    import torch

    from plainref.ops import roi_align as plain

    b, n = rois.shape[:2]
    c = level_shapes[0][-1]
    pyr = plain._Pyramid(level_shapes, scales, rois.device)
    keep = valid.reshape(-1)
    r = rois.reshape(-1, 4)[keep].float()
    lv = levels.reshape(-1)[keep].long()
    img = torch.arange(b, device=rois.device).repeat_interleave(n)[keep]
    touched = torch.zeros(b * pyr.p_total, dtype=torch.bool, device=rois.device)
    for start in range(0, r.shape[0], 1024):
        sl = slice(start, start + 1024)
        scale = pyr.scales[lv[sl]]
        x1, y1 = r[sl, 0] * scale, r[sl, 1] * scale
        rw = (r[sl, 2] * scale - x1).clamp_min(1.0)
        rh = (r[sl, 3] * scale - y1).clamp_min(1.0)
        rows, wy = plain._pooled_taps(y1, rh, pyr.hs[lv[sl]], output_size, sr, False)
        cols, wx = plain._pooled_taps(x1, rw, pyr.ws[lv[sl]], output_size, sr, False)
        m = rows.shape[0]
        idx = ((img[sl] * pyr.p_total + pyr.offs[lv[sl]])[:, None, None]
               + rows.reshape(m, -1)[:, :, None] * pyr.ws[lv[sl]].long()[:, None, None]
               + cols.reshape(m, -1)[:, None, :])
        hit = (wy.reshape(m, -1) > 0)[:, :, None] & (wx.reshape(m, -1) > 0)[:, None, :]
        touched[idx[hit]] = True
    out_bytes = b * n * output_size ** 2 * c * elem_size
    index_bytes = rois.numel() * 4 + valid.numel() + levels.numel() * 4
    n_ops = 2.0 * int(keep.sum()) * c * output_size ** 2 * sr ** 2 * 4
    return int(touched.sum()) * c * elem_size + out_bytes + index_bytes, n_ops
