"""Synthetic VOC-layout data (port of ``make_learnable_voc`` in
``cald_tpu/data/synthetic.py``): the same seed gives the same annotations
and pixels as the JAX package's generator.

``image_format="jpg"`` writes JPEGs through Pillow, as the JAX generator
does; ``"npy"`` writes each image as a ``.npy`` array, which the loader
reads without an image codec.
"""

from __future__ import annotations

import os

import numpy as np


def make_learnable_voc(root, num_images=32, hw=(96, 128), seed=0, year="2007",
                       class_probs=None, image_format: str = "jpg"):
    """A learnable synthetic VOC set: solid colour-coded rectangles (class =
    colour) on a gray background, 1-2 objects per image; every id goes to
    both ``trainval`` and ``test``. ``class_probs``: optional per-class
    sampling weights. Returns the devkit root (holding ``VOC{year}/``)."""
    if image_format not in ("jpg", "npy"):
        raise ValueError(f"image_format must be 'jpg' or 'npy', not {image_format!r}")
    rng = np.random.default_rng(seed)
    classes = ["aeroplane", "bicycle", "bird"]
    colors = [(220, 40, 40), (40, 220, 40), (40, 40, 220)]
    probs = (np.asarray(class_probs, float) / np.sum(class_probs)
             if class_probs is not None else None)
    voc = os.path.join(str(root), f"VOC{year}")
    for sub in ("JPEGImages", "Annotations", os.path.join("ImageSets", "Main")):
        os.makedirs(os.path.join(voc, sub), exist_ok=True)
    ids = []
    h, w = hw
    for i in range(num_images):
        img_id = f"{i:06d}"
        ids.append(img_id)
        img = np.full((h, w, 3), 128, np.uint8)
        img += rng.integers(-10, 10, img.shape).astype(np.uint8)
        objs = []
        for _ in range(int(rng.integers(1, 3))):
            c = int(rng.choice(len(classes), p=probs))
            bw, bh = int(rng.integers(24, 48)), int(rng.integers(24, 48))
            x1 = int(rng.integers(1, w - bw))
            y1 = int(rng.integers(1, h - bh))
            img[y1:y1 + bh, x1:x1 + bw] = colors[c]
            objs.append((classes[c], x1, y1, x1 + bw, y1 + bh))
        filename = f"{img_id}.{image_format}"
        path = os.path.join(voc, "JPEGImages", filename)
        if image_format == "npy":
            np.save(path, img)
        else:
            from PIL import Image

            Image.fromarray(img).save(path)
        xml_objs = "".join(
            f"<object><name>{n_}</name><difficult>0</difficult><bndbox>"
            f"<xmin>{x1}</xmin><ymin>{y1}</ymin><xmax>{x2}</xmax><ymax>{y2}</ymax>"
            f"</bndbox></object>" for n_, x1, y1, x2, y2 in objs)
        with open(os.path.join(voc, "Annotations", img_id + ".xml"), "w") as f:
            f.write(f"<annotation><filename>{filename}</filename><size>"
                    f"<width>{w}</width><height>{h}</height><depth>3</depth>"
                    f"</size>{xml_objs}</annotation>")
    for split in ("trainval", "test"):
        with open(os.path.join(voc, "ImageSets", "Main", split + ".txt"), "w") as f:
            f.write("\n".join(ids))
    return str(root)
