"""PASCAL VOC mAP evaluation, host-side NumPy (copy of
``cald_tpu/engine/voc_eval.py``).

Same math as the reference's file-based pipeline
(reference detection/voc_eval.py): legacy +1 box-area convention (:154-160),
difficult-object handling (:168-175: difficult gts are neither TP nor FP),
greedy highest-score-first matching with per-gt de-dup, area-under-PR AP
(:50-65), IoU sweep 0.5:0.05:0.95, and the exact pipe-row output format
``mAP|AP50|AP75|recall|<20 per-class AP50s>`` x100 at 1 decimal (:260-266).

No /tmp detection files: detections stay as arrays (the reference writes
per-class text files only to mimic the VOCdevkit, :188-222).
"""

from __future__ import annotations

import numpy as np

IOU_SWEEP = tuple(np.arange(0.5, 1.0, 0.05).round(2))


def voc_ap(rec: np.ndarray, prec: np.ndarray, use_07_metric: bool = False) -> float:
    """AP from PR points (reference voc_eval.py:34-65)."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.sum(rec >= t) > 0 else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def _overlaps_legacy(gt: np.ndarray, box: np.ndarray) -> np.ndarray:
    """IoU of one det box against gt boxes with the +1 convention
    (voc_eval.py:146-160)."""
    ixmin = np.maximum(gt[:, 0], box[0])
    iymin = np.maximum(gt[:, 1], box[1])
    ixmax = np.minimum(gt[:, 2], box[2])
    iymax = np.minimum(gt[:, 3], box[3])
    iw = np.maximum(ixmax - ixmin + 1.0, 0.0)
    ih = np.maximum(iymax - iymin + 1.0, 0.0)
    inters = iw * ih
    uni = ((box[2] - box[0] + 1.0) * (box[3] - box[1] + 1.0)
           + (gt[:, 2] - gt[:, 0] + 1.0) * (gt[:, 3] - gt[:, 1] + 1.0) - inters)
    return inters / uni


def voc_eval_class(dets: dict, gts: dict, ovthresh: float = 0.5,
                   use_07_metric: bool = False):
    """One class.

    dets: {image_id: (boxes (N,4), scores (N,))}
    gts:  {image_id: (boxes (M,4), difficult (M,) bool)} — every eval image must
          appear (possibly with empty arrays).
    Returns (rec array, prec array, ap).
    """
    npos = 0
    state = {}
    for img_id, (gb, diff) in gts.items():
        diff = np.asarray(diff, bool)
        npos += int((~diff).sum())
        state[img_id] = {"bbox": np.asarray(gb, float),
                         "difficult": diff,
                         "det": np.zeros(len(gb), bool)}

    image_ids, confidence, bb = [], [], []
    for img_id, (boxes, scores) in dets.items():
        for b, s in zip(np.asarray(boxes, float), np.asarray(scores, float)):
            image_ids.append(img_id)
            confidence.append(s)
            bb.append(b)
    nd = len(image_ids)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    if nd:
        order = np.argsort(-np.asarray(confidence))
        for rank, d in enumerate(order):
            r = state[image_ids[d]]
            ovmax, jmax = -np.inf, -1
            if len(r["bbox"]):
                overlaps = _overlaps_legacy(r["bbox"], bb[d])
                jmax = int(np.argmax(overlaps))
                ovmax = overlaps[jmax]
            if ovmax > ovthresh:
                if not r["difficult"][jmax]:
                    if not r["det"][jmax]:
                        tp[rank] = 1.0
                        r["det"][jmax] = True
                    else:
                        fp[rank] = 1.0
            else:
                fp[rank] = 1.0
    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / float(max(npos, 1))
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return rec, prec, voc_ap(rec, prec, use_07_metric)


def voc_evaluate_detections(results: list[dict], dataset, *, class_names=None,
                            print_fn=print) -> dict:
    """Full VOC protocol over in-memory results.

    results: one dict per eval image: {'image_id', 'boxes' (N,4) original-image
    xyxy, 'scores' (N,), 'labels' (N,) 1-based}.
    dataset: provides record(i) with gt boxes/labels/difficult.

    Returns {'mAP', 'AP50', 'AP75', 'recall', 'per_class_ap50': {...}} and
    prints the reference pipe row.
    """
    class_names = class_names or dataset.class_names
    num_classes = len(class_names)

    # group gt and detections per class
    gt_by_class = {c: {} for c in range(1, num_classes)}
    for i in range(len(dataset)):
        rec = dataset.record(i)
        for c in range(1, num_classes):
            m = rec.labels == c
            gt_by_class[c][rec.image_id] = (rec.boxes[m], rec.difficult[m].astype(bool))
    det_by_class = {c: {} for c in range(1, num_classes)}
    for res in results:
        lb = np.asarray(res["labels"])
        for c in range(1, num_classes):
            m = lb == c
            det_by_class[c][res["image_id"]] = (np.asarray(res["boxes"])[m],
                                                np.asarray(res["scores"])[m])

    ap_iou, ap_50, ap_75, rec_cls = [], [], [], []
    per_class = {}
    for c in range(1, num_classes):
        for iou in IOU_SWEEP:
            rec, _, ap = voc_eval_class(det_by_class[c], gt_by_class[c], float(iou))
            ap_iou.append(ap)
            if abs(iou - 0.5) < 1e-9:
                ap_50.append(ap)
                per_class[class_names[c]] = ap
                rec_cls.append(float(np.mean(rec)) if len(rec) else 0.0)
            if abs(iou - 0.75) < 1e-9:
                ap_75.append(ap)

    out = {
        "mAP": float(np.mean(ap_iou)),
        "AP50": float(np.mean(ap_50)),
        "AP75": float(np.mean(ap_75)),
        "recall": float(np.mean(rec_cls)),
        "per_class_ap50": per_class,
    }
    bar = "=" * 101
    print_fn(bar)
    row = "{}|{}|{}|{}|".format(round(out["mAP"] * 100, 1), round(out["AP50"] * 100, 1),
                                round(out["AP75"] * 100, 1), round(out["recall"] * 100, 1))
    row += "".join(f"{round(ap * 100, 1)}|" for ap in per_class.values())
    print_fn(row)
    print_fn(bar)
    return out
