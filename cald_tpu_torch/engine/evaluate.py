"""Batched evaluation inference driving the host-side evaluators (port of
``cald_tpu/engine/evaluate.py``).

``run_inference`` runs ``FasterRCNN.detect`` under ``torch.inference_mode``
on canvas batches, maps the detections back to original image coordinates
and returns the small per-image result dicts the evaluators take.
"""

from __future__ import annotations

import torch

from cald_tpu_torch.engine.voc_eval import voc_evaluate_detections


def run_inference(model, loader, *, device, score_thresh: float = 0.0) -> list[dict]:
    """Detect over a loader; per-image dicts in original image coordinates
    (later batches win on duplicate padded indices)."""
    results: dict[int, dict] = {}
    with torch.inference_mode():
        for batch in loader:
            dets = model.detect(torch.from_numpy(batch.images).to(device),
                                torch.from_numpy(batch.valid_hw).to(device))
            dets = dets.rescale(torch.from_numpy(batch.scale).to(device))
            boxes, scores, labels, valid = (t.cpu().numpy() for t in (
                dets.boxes, dets.scores, dets.labels, dets.valid))
            if score_thresh > 0:
                valid = valid & (scores > score_thresh)
            for i, idx in enumerate(batch.image_idx):
                m = valid[i]
                results[int(idx)] = {
                    "dataset_index": int(idx),
                    "boxes": boxes[i][m],
                    "scores": scores[i][m],
                    "labels": labels[i][m],
                }
    return list(results.values())


def evaluate(model, loader, dataset, *, kind: str, device, print_fn=print) -> dict:
    """kind: 'voc' ('coco' is not ported yet). Returns the evaluator's
    metric dict."""
    if kind == "coco":
        raise NotImplementedError("COCO evaluation is not ported yet (ROADMAP queue 1 item 5)")
    if kind != "voc":
        raise ValueError(f"unknown eval kind {kind!r}")
    results = run_inference(model, loader, device=device)
    for r in results:
        r["image_id"] = dataset.record(r["dataset_index"]).image_id
    return voc_evaluate_detections(results, dataset, print_fn=print_fn)
