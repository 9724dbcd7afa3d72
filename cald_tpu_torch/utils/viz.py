"""Detection visualisation (port of ``cald_tpu/utils/viz.py``): host-side PIL
drawing, the reference's cald_helper.py:271-350 ``draw_PIL_image`` family.
Pillow is imported when an image is drawn."""

from __future__ import annotations

import numpy as np

# distinct colours cycled per class id
_COLORS = ["red", "lime", "blue", "yellow", "magenta", "cyan", "orange",
           "green", "purple", "brown", "pink", "teal", "navy", "maroon",
           "olive", "coral", "gold", "indigo", "crimson", "turquoise"]


def draw_detections(image: np.ndarray, boxes, labels=None, scores=None,
                    class_names=None, score_thresh: float = 0.0):
    """A PIL image of ``image`` ((H, W, 3) uint8 or float) with the boxes
    (xyxy, original coordinates) drawn, each tagged with its class and
    score; boxes scoring below ``score_thresh`` are left out."""
    from PIL import Image, ImageDraw

    img = Image.fromarray(np.asarray(image, np.uint8))
    draw = ImageDraw.Draw(img)
    boxes = np.asarray(boxes).reshape(-1, 4)
    n = len(boxes)
    labels = np.asarray(labels) if labels is not None else np.zeros(n, int)
    scores = np.asarray(scores) if scores is not None else np.ones(n)
    for b, l, s in zip(boxes, labels, scores):
        if s < score_thresh:
            continue
        color = _COLORS[int(l) % len(_COLORS)]
        draw.rectangle([float(b[0]), float(b[1]), float(b[2]), float(b[3])],
                       outline=color, width=2)
        tag = (class_names[int(l)] if class_names and int(l) < len(class_names)
               else str(int(l)))
        draw.text((float(b[0]) + 2, float(b[1]) + 2), f"{tag}:{float(s):.2f}", fill=color)
    return img


def save_detection_image(path: str, image, boxes, labels=None, scores=None,
                         class_names=None, score_thresh: float = 0.3):
    """Draw and save (the reference's commented-out cv2 dumps, engine.py:118-133)."""
    draw_detections(image, boxes, labels, scores, class_names, score_thresh).save(path)
