"""Batched evaluation inference driving the host-side evaluators (port of
``cald_tpu/engine/evaluate.py``).

``run_inference`` runs ``FasterRCNN.detect`` under ``torch.inference_mode``
on canvas batches, maps the detections back to original image coordinates
and returns the small per-image result dicts the evaluators take.
"""

from __future__ import annotations

import torch

from cald_tpu_torch.data.batching import images_tensor
from cald_tpu_torch.engine.coco_eval import coco_evaluate_detections
from cald_tpu_torch.engine.voc_eval import voc_evaluate_detections
from cald_tpu_torch.parallel import all_gather_objects, process_count


def run_inference(model, loader, *, device, score_thresh: float = 0.0) -> list[dict]:
    """Detect over a loader; per-image dicts in original image coordinates
    (later batches win on duplicate padded indices)."""
    results: dict[int, dict] = {}
    with torch.inference_mode():
        for batch in loader:
            dets = model.detect(images_tensor(batch.images, device),
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


def evaluate(model, loader, dataset, *, kind: str, device, classwise: bool = False,
             print_fn=print) -> dict:
    """kind: 'voc' or 'coco' (``classwise`` adds COCO's per-class AP table).
    Returns the evaluator's metric dict.

    Under more than one process each rank detects its own loader's images
    and the per-image results of all ranks are gathered before the
    evaluator runs on every rank (the reference's ``utils.all_gather`` of
    pickled predictions)."""
    if kind not in ("voc", "coco"):
        raise ValueError(f"unknown eval kind {kind!r}")
    results = run_inference(model, loader, device=device)
    if process_count() > 1:
        results = list({r["dataset_index"]: r for part in all_gather_objects(results)
                        for r in part}.values())
    for r in results:
        r["image_id"] = dataset.record(r["dataset_index"]).image_id
    if kind == "voc":
        return voc_evaluate_detections(results, dataset, print_fn=print_fn)
    return coco_evaluate_detections(results, dataset, classwise=classwise, print_fn=print_fn)
