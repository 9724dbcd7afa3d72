"""Synthetic VOC- and COCO-layout data (port of ``make_learnable_voc`` and
``make_coco`` in ``cald_tpu/data/synthetic.py``): the same seed gives the
same annotations and pixels as the JAX package's generators.

``image_format="jpg"`` writes JPEGs through Pillow, as the JAX generators
do; ``"npy"`` writes each image as a ``.npy`` array, which the loader
reads without an image codec.
"""

from __future__ import annotations

import json
import os

import numpy as np


def _check_format(image_format: str):
    if image_format not in ("jpg", "npy"):
        raise ValueError(f"image_format must be 'jpg' or 'npy', not {image_format!r}")


def _save_image(path: str, img: np.ndarray, image_format: str):
    if image_format == "npy":
        np.save(path, img)
    else:
        from PIL import Image

        Image.fromarray(img).save(path)


def make_learnable_voc(root, num_images=32, hw=(96, 128), seed=0, year="2007",
                       class_probs=None, image_format: str = "jpg"):
    """A learnable synthetic VOC set: solid colour-coded rectangles (class =
    colour) on a gray background, 1-2 objects per image; every id goes to
    both ``trainval`` and ``test``. ``class_probs``: optional per-class
    sampling weights. Returns the devkit root (holding ``VOC{year}/``)."""
    _check_format(image_format)
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
        _save_image(os.path.join(voc, "JPEGImages", filename), img, image_format)
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


def make_coco(root, num_images=5, hw=(50, 60), num_classes=3, seed=0, split="train",
              year="2017", image_format: str = "jpg", max_objects: int = 3,
              box_size=(4.0, 12.0)):
    """Write a tiny COCO tree (random-pixel images + the instances json) with
    sparse category ids ``3 * i + 1``; returns root. ``hw`` is one (h, w) or
    a sequence of them, taken in turn image by image; each image gets 1 to
    ``max_objects`` boxes with sides drawn from ``box_size``. The defaults
    are the JAX generator's, which has the one ``hw`` only."""
    _check_format(image_format)
    rng = np.random.default_rng(seed)
    img_dir = os.path.join(str(root), f"{split}{year}")
    ann_dir = os.path.join(str(root), "annotations")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)
    sizes = [tuple(hw)] if np.ndim(hw) == 1 else [tuple(s) for s in hw]
    lo, hi = box_size

    cat_ids = [3 * i + 1 for i in range(num_classes)]
    images, annotations = [], []
    ann_id = 1
    for n in range(num_images):
        h, w = sizes[n % len(sizes)]
        img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        fname = f"img{n:04d}.{image_format}"
        _save_image(os.path.join(img_dir, fname), img, image_format)
        images.append({"id": 100 + n, "file_name": fname, "width": w, "height": h})
        for _ in range(int(rng.integers(1, max_objects + 1))):
            x = float(rng.uniform(0, w - hi))
            y = float(rng.uniform(0, h - hi))
            bw = float(rng.uniform(lo, hi))
            bh = float(rng.uniform(lo, hi))
            annotations.append({
                "id": ann_id, "image_id": 100 + n,
                "category_id": cat_ids[int(rng.integers(num_classes))],
                "bbox": [x, y, bw, bh], "area": bw * bh, "iscrowd": 0,
                # rectangle polygon matching the bbox (mask-API tests)
                "segmentation": [[x, y, x + bw, y, x + bw, y + bh, x, y + bh]],
            })
            ann_id += 1
    data = {
        "images": images,
        "annotations": annotations,
        "categories": [{"id": c, "name": f"cat{c}"} for c in cat_ids],
    }
    with open(os.path.join(ann_dir, f"instances_{split}{year}.json"), "w") as f:
        json.dump(data, f)
    return str(root)
