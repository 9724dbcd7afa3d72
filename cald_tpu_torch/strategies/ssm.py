"""SSM: self-supervised sample mining (copy of ``cald_tpu/strategies/ssm.py``,
host NumPy; reference ssm_train.py, ssm/ssm_helper.py, frcnn_ssm.py).

Pipeline per cycle (ssm_train.py:190-275):
  stage 1  detect the pool in ssm mode; images whose best detection confidence
           is < 0.5 carry al=1 (frcnn_ssm.py:60,71-74) and go straight to the
           to-label list.
  stage 2  for remaining images, per detection: pseudo label y over fg classes
           (judge_y: +1 iff s > 0.5, frcnn_ssm.py:29-39), loss vector
           l = -((1+y)/2 log s + (1-y)/2 log(1-s)) (ssm_train.py:228-229);
           judge_uv (ssm_helper.py:36-54): hard (sum l > gamma) -> label the
           image; easy single-fg-class boxes are verified by pasting the patch
           into <=5 labeled images lacking that class and re-detecting
           (ssm_helper.py:57-111); failed verification -> label the image.
  adapt    gamma += 0.05 (cap 1); clslambda = 0.9*clslambda
           - 0.1*log softmax(avg cls loss) (ssm_train.py:272-273).

Stage-1 detection is canvas-batched; the per-box host logic uses the
fixed-slot score rows; cross-validation paste jobs are composed on the host
and handed to the re-detect hook together.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from cald_tpu_torch.data.loader import decode_image


@dataclasses.dataclass
class SSMConfig:
    conf_thresh: float = 0.5      # al flag + judge_y threshold (frcnn_ssm.py:60)
    gamma: float = 0.15           # ssm_train.py initial (adapted per cycle)
    total_select: int = 5         # cross-validation pastes (ssm_helper.py:65)
    cv_score_thresh: float = 0.5
    cv_iou_thresh: float = 0.5
    nms_thresh: float = 0.3       # ssm per-class NMS (frcnn_ssm.py:88)


def judge_y(score_rows: np.ndarray, conf: float = 0.5) -> np.ndarray:
    """Pseudo labels over fg classes: +1 iff log s > log(1-s) (frcnn_ssm.py:29-39)."""
    return np.where(score_rows > conf, 1.0, -1.0)


def pseudo_loss(score_rows: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Per-class loss vector (ssm_train.py:228-229)."""
    s = np.clip(score_rows, 1e-30, 1.0)
    return -((1 + y) / 2 * np.log(s) + (1 - y) / 2 * np.log(1 - s + 1e-30))


def judge_uv(loss: np.ndarray, gamma: float, clslambda: np.ndarray):
    """(is_easy, v weights) — ssm_helper.py:36-54."""
    lsum = float(np.sum(loss))
    v = np.zeros_like(loss)
    if lsum > gamma:
        return False, v
    v = np.where(loss > clslambda, 0.0, 1.0 - loss / np.maximum(clslambda, 1e-30))
    return True, v


def _legacy_iou(a, b) -> float:
    width = min(a[2], b[2]) - max(a[0], b[0]) + 1
    height = min(a[3], b[3]) - max(a[1], b[1]) + 1
    if width <= 0 or height <= 0:
        return 0.0
    a_area = (a[2] - a[0]) * (a[3] - a[1] + 1)
    b_area = (b[2] - b[0]) * (b[3] - b[1] + 1)
    inter = width * height
    return float(inter / (a_area + b_area - inter))


class CrossValidator:
    """Paste-and-redetect verification (ssm_helper.py:57-111), batched.

    detect_host: fn(list of (H, W, 3) uint8-ish arrays) -> list of per-image
    dicts {'boxes', 'scores', 'labels'} in the pasted image's coordinates
    (the AL driver builds this from the canvas-batched detect path).
    """

    def __init__(self, dataset, detect_host: Callable, cfg: SSMConfig,
                 rng: np.random.Generator):
        self.dataset = dataset
        self.detect_host = detect_host
        self.cfg = cfg
        self.rng = rng

    def verify(self, patch: np.ndarray, pre_cls: int, labeled_indices) -> bool:
        """True iff a majority of <=total_select pastes re-detect the class at
        the pasted location."""
        ph, pw = patch.shape[:2]
        if ph <= 0 or pw <= 0:
            return False
        jobs, origin_boxes = [], []
        order = self.rng.permutation(len(labeled_indices))
        for li in order:
            rec = self.dataset.record(int(labeled_indices[li]))
            if pre_cls in set(rec.labels.tolist()):
                continue
            img = decode_image(rec.image_path).astype(np.float32)
            if ph > img.shape[0] or pw > img.shape[1]:
                continue
            y0 = self.rng.integers(0, img.shape[0] - ph + 1)
            x0 = self.rng.integers(0, img.shape[1] - pw + 1)
            img[y0:y0 + ph, x0:x0 + pw] = patch
            jobs.append(img)
            origin_boxes.append([x0, y0, x0 + pw, y0 + ph])
            if len(jobs) >= self.cfg.total_select:
                break
        if not jobs:
            return False
        votes = 0
        for det, obox in zip(self.detect_host(jobs), origin_boxes):
            m = det["labels"] == pre_cls
            if not m.any():
                continue
            k = int(np.argmax(det["scores"][m]))
            if (det["scores"][m][k] > self.cfg.cv_score_thresh
                    and _legacy_iou(obox, det["boxes"][m][k]) > self.cfg.cv_iou_thresh):
                votes += 1
        return votes > self.cfg.total_select / 2


def ssm_select(pool_dets: list[dict], pool_positions: np.ndarray, budget: int,
               *, gamma: float, clslambda: np.ndarray,
               cross_validator: CrossValidator | None,
               labeled_indices, rng: np.random.Generator,
               patch_getter: Callable | None = None):
    """Run SSM's two-stage selection over host-side pool detections.

    pool_dets[i]: {'score_rows' (K, C-1) fg sigmoid/softmax rows of kept dets,
                   'boxes' (K, 4) original coords, 'al' bool}
    patch_getter(pool_position, box) -> (h, w, 3) image patch (for CV).

    Returns (chosen positions into pool arrays, new_gamma, new_clslambda).
    """
    n = len(pool_dets)
    chosen: list[int] = [i for i in range(n) if pool_dets[i]["al"]]
    chosen_set = set(chosen)
    cls_sum = 0
    cls_loss_sum = np.zeros_like(clslambda)

    if len(chosen) < budget:
        for i in range(n):
            if len(chosen) >= budget:
                break
            if i in chosen_set:
                continue
            det = pool_dets[i]
            boxes, rows = det["boxes"], det["score_rows"]
            cls_sum += len(boxes)
            labeled_this = False
            for j in range(len(boxes)):
                y = judge_y(rows[j])
                loss = pseudo_loss(rows[j], y)
                cls_loss_sum += loss
                easy, _ = judge_uv(loss, gamma, clslambda)
                if not easy:
                    labeled_this = True
                    break
                pos_classes = np.where(y == 1)[0]
                # single-fg-class easy boxes get cross-validated
                # (ssm_train.py:233-252; class index 0 excluded there because
                # its label space includes background at 0)
                if len(pos_classes) == 1 and cross_validator is not None \
                        and patch_getter is not None:
                    pre_cls = int(pos_classes[0]) + 1          # 1-based label
                    patch = patch_getter(i, boxes[j])
                    if patch is None:
                        continue
                    if not cross_validator.verify(patch, pre_cls, labeled_indices):
                        labeled_this = True
                        break
            if labeled_this:
                chosen.append(i)
                chosen_set.add(i)

    chosen = chosen[:budget]
    # backfill from the remaining pool (ssm_train.py:265-266)
    if len(chosen) < budget:
        rest = [i for i in range(n) if i not in chosen_set]
        chosen += rest[: budget - len(chosen)]

    # adaptive thresholds (ssm_train.py:272-273)
    avg = cls_loss_sum / (cls_sum + 1e-30)
    e = np.exp(avg - avg.max())
    new_clslambda = 0.9 * clslambda - 0.1 * np.log(e / e.sum())
    new_gamma = min(gamma + 0.05, 1.0)
    return np.asarray(chosen, int), new_gamma, new_clslambda
