"""COCO-style detection evaluation, host NumPy (copy of
``cald_tpu/engine/coco_eval.py``).

The reference wraps pycocotools' C extension (detection/coco_eval.py:19-353).
pycocotools is not a dependency; this module implements the COCOeval bbox
protocol:

  - IoU thresholds 0.5:0.05:0.95, recall grid 0:0.01:1 (101 points),
  - area ranges all / small(<32^2) / medium / large, maxDets (1, 10, 100),
  - crowd gts use IoU = inter / det_area and may match many dets,
  - greedy matching in score order; within a det, prefer non-ignored gts and
    higher IoU; matched-to-ignored dets are ignored, as are unmatched dets
    outside the area range,
  - precision envelope + 101-point interpolation, the standard 12-metric
    summary (AP, AP50, AP75, APs/m/l, AR1/10/100, ARs/m/l).

The Python loops over images x classes x thresholds are the JAX package's,
unchanged; tests/test_torch_coco.py holds the stats equal to its evaluator
and to tests/coco_naive_oracle.py.
"""

from __future__ import annotations

import numpy as np

IOU_THRS = np.round(np.arange(0.5, 1.0, 0.05), 2)
REC_THRS = np.round(np.arange(0.0, 1.01, 0.01), 2)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = (1, 10, 100)


def iou_matrix(dets: np.ndarray, gts: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """(D, G) IoU; crowd gt columns use inter/det_area (pycocotools maskUtils.iou)."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    lt = np.maximum(dets[:, None, :2], gts[None, :, :2])
    rb = np.minimum(dets[:, None, 2:], gts[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    d_area = (dets[:, 2] - dets[:, 0]) * (dets[:, 3] - dets[:, 1])
    g_area = (gts[:, 2] - gts[:, 0]) * (gts[:, 3] - gts[:, 1])
    union = np.where(iscrowd[None, :].astype(bool), d_area[:, None],
                     d_area[:, None] + g_area[None, :] - inter)
    return inter / np.maximum(union, 1e-12)


def _evaluate_image(det_boxes, det_scores, gt_boxes, gt_iscrowd, gt_area,
                    area_rng, max_det):
    """pycocotools evaluateImg for one (image, class, area, maxDet).

    Returns dict with per-det match flags and ignore masks (score-sorted).
    """
    g_ignore = gt_iscrowd.astype(bool) | (gt_area < area_rng[0]) | (gt_area > area_rng[1])
    # sort gts: non-ignored first (pycocotools gtind ordering)
    gt_order = np.argsort(g_ignore, kind="stable")
    gt_boxes = gt_boxes[gt_order]
    g_ignore = g_ignore[gt_order]
    gt_crowd = gt_iscrowd[gt_order]

    d_order = np.argsort(-det_scores, kind="stable")[:max_det]
    det_boxes = det_boxes[d_order]
    det_scores = det_scores[d_order]

    ious = iou_matrix(det_boxes, gt_boxes, gt_crowd)
    nd, ng = len(det_boxes), len(gt_boxes)
    T = len(IOU_THRS)
    dt_m = -np.ones((T, nd), np.int64)      # matched gt index or -1
    gt_m = -np.ones((T, ng), np.int64)
    dt_ig = np.zeros((T, nd), bool)

    for ti, t in enumerate(IOU_THRS):
        for d in range(nd):
            best_iou = min(t, 1 - 1e-10)
            best_g = -1
            for g in range(ng):
                if gt_m[ti, g] >= 0 and not gt_crowd[g]:
                    continue  # gt already used (crowds can absorb many dets)
                if best_g >= 0 and not g_ignore[best_g] and g_ignore[g]:
                    break     # gts sorted: once past non-ignored best, stop
                if ious[d, g] < best_iou:
                    continue
                best_iou = ious[d, g]
                best_g = g
            if best_g >= 0:
                dt_m[ti, d] = best_g
                gt_m[ti, best_g] = d
                dt_ig[ti, d] = g_ignore[best_g]

    # unmatched dets outside the area range are ignored
    d_area = (det_boxes[:, 2] - det_boxes[:, 0]) * (det_boxes[:, 3] - det_boxes[:, 1])
    d_out = (d_area < area_rng[0]) | (d_area > area_rng[1])
    dt_ig |= (dt_m == -1) & d_out[None, :]
    return {"dt_m": dt_m, "dt_ig": dt_ig, "g_ignore": g_ignore,
            "scores": det_scores}


def coco_evaluate_detections(results: list[dict], dataset, *, print_fn=print,
                             classwise: bool = False) -> dict:
    """Full COCO bbox protocol over in-memory results.

    results: one dict per eval image: {'image_id' (dataset-native str),
    'boxes' (N,4) original-coords xyxy, 'scores' (N,), 'labels' (N,) dense
    1-based}. dataset: CocoDataset (or any dataset with record()/class_names).

    Returns the 12 standard metrics (+ optional per-class AP table) and prints
    the COCOeval-style summary block.
    """
    class_names = dataset.class_names
    num_classes = len(class_names)
    res_by_id = {r["image_id"]: r for r in results}

    # per (class, area, image): evaluate with maxDet=max(MAX_DETS)
    evals: dict[tuple, list] = {}
    img_ids = []
    for i in range(len(dataset)):
        rec = dataset.record(i)
        img_ids.append(rec.image_id)
        r = res_by_id.get(rec.image_id)
        db = np.asarray(r["boxes"], float) if r is not None else np.zeros((0, 4))
        ds = np.asarray(r["scores"], float) if r is not None else np.zeros((0,))
        dl = np.asarray(r["labels"]) if r is not None else np.zeros((0,), int)
        for c in range(1, num_classes):
            gm = rec.labels == c
            dm = dl == c
            for aname, arng in AREA_RNG.items():
                evals.setdefault((c, aname), []).append(_evaluate_image(
                    db[dm], ds[dm], rec.boxes[gm],
                    rec.iscrowd[gm] if rec.iscrowd is not None else np.zeros(gm.sum()),
                    rec.area[gm] if rec.area is not None else
                    (rec.boxes[gm, 2] - rec.boxes[gm, 0]) * (rec.boxes[gm, 3] - rec.boxes[gm, 1]),
                    arng, max(MAX_DETS)))

    T, R = len(IOU_THRS), len(REC_THRS)
    K, A, M = num_classes - 1, len(AREA_RNG), len(MAX_DETS)
    precision = -np.ones((T, R, K, A, M))
    recall = -np.ones((T, K, A, M))

    for ki, c in enumerate(range(1, num_classes)):
        for ai, aname in enumerate(AREA_RNG):
            per_img = evals[(c, aname)]
            for mi, max_det in enumerate(MAX_DETS):
                scores = np.concatenate([e["scores"][:max_det] for e in per_img])
                if scores.size == 0 and all((~e["g_ignore"]).sum() == 0 for e in per_img):
                    continue
                order = np.argsort(-scores, kind="mergesort")
                dt_m = np.concatenate([e["dt_m"][:, :max_det] for e in per_img],
                                      axis=1)[:, order]
                dt_ig = np.concatenate([e["dt_ig"][:, :max_det] for e in per_img],
                                       axis=1)[:, order]
                npig = sum(int((~e["g_ignore"]).sum()) for e in per_img)
                if npig == 0:
                    continue
                tps = (dt_m >= 0) & ~dt_ig
                fps = (dt_m == -1) & ~dt_ig
                tp_sum = np.cumsum(tps, axis=1).astype(float)
                fp_sum = np.cumsum(fps, axis=1).astype(float)
                for ti in range(T):
                    tp, fp = tp_sum[ti], fp_sum[ti]
                    rc = tp / npig
                    pr = tp / np.maximum(tp + fp, np.spacing(1))
                    recall[ti, ki, ai, mi] = rc[-1] if len(rc) else 0.0
                    # precision envelope
                    pr = pr.tolist()
                    for i in range(len(pr) - 1, 0, -1):
                        pr[i - 1] = max(pr[i - 1], pr[i])
                    inds = np.searchsorted(rc, REC_THRS, side="left")
                    q = np.zeros(R)
                    for ri, pi in enumerate(inds):
                        if pi < len(pr):
                            q[ri] = pr[pi]
                    precision[ti, :, ki, ai, mi] = q

    def _summ(ap: bool, iou=None, area="all", max_det=100):
        ai = list(AREA_RNG).index(area)
        mi = MAX_DETS.index(max_det)
        if ap:
            s = precision[:, :, :, ai, mi]
            if iou is not None:
                s = s[np.where(np.isclose(IOU_THRS, iou))[0]]
        else:
            s = recall[:, :, ai, mi]
            if iou is not None:
                s = s[np.where(np.isclose(IOU_THRS, iou))[0]]
        s = s[s > -1]
        return float(np.mean(s)) if s.size else -1.0

    stats = {
        "AP": _summ(True), "AP50": _summ(True, 0.5), "AP75": _summ(True, 0.75),
        "APs": _summ(True, area="small"), "APm": _summ(True, area="medium"),
        "APl": _summ(True, area="large"),
        "AR1": _summ(False, max_det=1), "AR10": _summ(False, max_det=10),
        "AR100": _summ(False), "ARs": _summ(False, area="small"),
        "ARm": _summ(False, area="medium"), "ARl": _summ(False, area="large"),
    }
    _print_summary(stats, print_fn)

    if classwise:  # per-class AP table (reference engine.py:221-254)
        per_cls = {}
        ai, mi = 0, MAX_DETS.index(100)
        for ki, c in enumerate(range(1, num_classes)):
            s = precision[:, :, ki, ai, mi]
            s = s[s > -1]
            per_cls[class_names[c]] = float(np.mean(s)) if s.size else float("nan")
        stats["per_class_ap"] = per_cls
        width = max(len(n) for n in per_cls)
        print_fn("| {:{w}} | {:>6} |".format("category", "AP", w=width))
        for n, v in per_cls.items():
            print_fn("| {:{w}} | {:6.3f} |".format(n, v, w=width))
    return stats


def _print_summary(stats: dict, print_fn):
    rows = [
        ("Average Precision", "(AP)", "0.50:0.95", "all", 100, stats["AP"]),
        ("Average Precision", "(AP)", "0.50", "all", 100, stats["AP50"]),
        ("Average Precision", "(AP)", "0.75", "all", 100, stats["AP75"]),
        ("Average Precision", "(AP)", "0.50:0.95", "small", 100, stats["APs"]),
        ("Average Precision", "(AP)", "0.50:0.95", "medium", 100, stats["APm"]),
        ("Average Precision", "(AP)", "0.50:0.95", "large", 100, stats["APl"]),
        ("Average Recall", "(AR)", "0.50:0.95", "all", 1, stats["AR1"]),
        ("Average Recall", "(AR)", "0.50:0.95", "all", 10, stats["AR10"]),
        ("Average Recall", "(AR)", "0.50:0.95", "all", 100, stats["AR100"]),
        ("Average Recall", "(AR)", "0.50:0.95", "small", 100, stats["ARs"]),
        ("Average Recall", "(AR)", "0.50:0.95", "medium", 100, stats["ARm"]),
        ("Average Recall", "(AR)", "0.50:0.95", "large", 100, stats["ARl"]),
    ]
    for name, abbr, iou, area, md, val in rows:
        print_fn(f" {name:<18} {abbr} @[ IoU={iou:<9} | area={area:>6} | "
                 f"maxDets={md:>3} ] = {val:0.3f}")
