"""Synthetic VOC- and COCO-layout data (port of ``make_voc``,
``make_learnable_voc``, ``make_hard_easy_voc`` and ``make_coco`` in
``cald_tpu/data/synthetic.py``): the same seed gives the same annotations
and pixels as the JAX package's generators, and with JPEGs the same files.

``make_learnable_voc`` and ``make_coco`` take ``image_format``: ``"jpg"``
writes JPEGs through Pillow, as the JAX generators do; ``"npy"`` writes each
image as a ``.npy`` array, which the loader reads without an image codec.
``make_voc`` and ``make_hard_easy_voc`` write JPEGs.
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


def make_voc(root, num_images=6, size_range=((40, 80), (40, 80)), classes=None,
             max_objects=3, seed=0, year="2007", image_set="trainval",
             extra_image_sets=("test", "val")):
    """A tiny VOCdevkit tree of random-pixel images with 1 to
    ``max_objects`` random boxes each (15% difficult). The full id list is
    written to ``image_set`` and to each of ``extra_image_sets``. Returns
    the devkit root (holding ``VOC{year}/``)."""
    rng = np.random.default_rng(seed)
    classes = classes or ["aeroplane", "bicycle", "bird", "person"]
    voc = os.path.join(str(root), f"VOC{year}")
    for sub in ("JPEGImages", "Annotations", os.path.join("ImageSets", "Main")):
        os.makedirs(os.path.join(voc, sub), exist_ok=True)

    ids = []
    for n in range(num_images):
        img_id = f"{n:06d}"
        ids.append(img_id)
        h = int(rng.integers(*size_range[0]))
        w = int(rng.integers(*size_range[1]))
        img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        filename = f"{img_id}.jpg"
        _save_image(os.path.join(voc, "JPEGImages", filename), img, "jpg")

        objs = []
        for _ in range(int(rng.integers(1, max_objects + 1))):
            x1 = int(rng.integers(1, w - 10))
            y1 = int(rng.integers(1, h - 10))
            x2 = int(rng.integers(x1 + 5, min(x1 + 30, w)))
            y2 = int(rng.integers(y1 + 5, min(y1 + 30, h)))
            cls = classes[int(rng.integers(len(classes)))]
            diff = int(rng.random() < 0.15)
            objs.append(
                f"<object><name>{cls}</name><difficult>{diff}</difficult>"
                f"<bndbox><xmin>{x1}</xmin><ymin>{y1}</ymin>"
                f"<xmax>{x2}</xmax><ymax>{y2}</ymax></bndbox></object>")
        xml = (f"<annotation><filename>{filename}</filename>"
               f"<size><width>{w}</width><height>{h}</height><depth>3</depth></size>"
               + "".join(objs) + "</annotation>")
        with open(os.path.join(voc, "Annotations", img_id + ".xml"), "w") as f:
            f.write(xml)

    for name in (image_set,) + tuple(extra_image_sets):
        with open(os.path.join(voc, "ImageSets", "Main", name + ".txt"), "w") as f:
            f.write("\n".join(ids) + "\n")
    return str(root)


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


def make_hard_easy_voc(root, num_images=60, hw=(192, 256), hard_frac=0.3,
                       seed=0, year="2007", image_set="trainval"):
    """A learnable VOC set with an EASY/HARD image split designed so that
    augmentation-consistency scoring has something real to find
    (EXPERIMENTS.md: selection effectiveness, round 3).

    Easy images: 1-2 large, clean, fully visible class-coded shapes.
    Hard images (``hard_frac``): the same classes under the conditions that
    make detection unstable under the CALD augmentations — border truncation
    (flip/rotate change visibility), occluder bars (cutout-like occlusion),
    small scale, crowding, plus annotation-free distractor patches in class
    colors (precision pressure).

    Class = (color, shape): rectangle / ellipse / triangle / plus-cross, so a
    detector must read shape, not just color. All objects difficult=0 (they
    count in eval). Returns the devkit root; image ids prefixed 'h'/'e' so
    experiments can audit what a strategy selected.
    """
    rng = np.random.default_rng(seed)
    classes = ["aeroplane", "bicycle", "bird", "person"]
    colors = np.asarray([(210, 60, 50), (60, 200, 60), (60, 80, 210),
                         (200, 180, 50)], np.float32)
    h, w = hw
    voc = os.path.join(str(root), f"VOC{year}")
    for sub in ("JPEGImages", "Annotations", os.path.join("ImageSets", "Main")):
        os.makedirs(os.path.join(voc, sub), exist_ok=True)

    def draw(img, c, size, cx, cy):
        """Class-shaped textured patch centered at (cx, cy); returns the
        clipped bbox or None when <35% visible."""
        bh = bw = size
        yy, xx = np.mgrid[0:bh, 0:bw]
        u = (yy - bh / 2) / (bh / 2)
        v = (xx - bw / 2) / (bw / 2)
        if c == 0:
            mask = (np.abs(u) <= 0.95) & (np.abs(v) <= 0.95)
        elif c == 1:
            mask = u ** 2 + v ** 2 <= 1.0
        elif c == 2:
            mask = (u >= -0.9) & (np.abs(v) * 2 <= 1.05 - u)
        else:
            mask = (np.abs(u) <= 0.33) | (np.abs(v) <= 0.33)
        patch = colors[c] + rng.normal(0, 12, (bh, bw, 3))
        y1, x1 = int(cy - bh / 2), int(cx - bw / 2)
        sy1, sx1 = max(y1, 0), max(x1, 0)
        sy2, sx2 = min(y1 + bh, h), min(x1 + bw, w)
        if sy2 <= sy1 or sx2 <= sx1:
            return None
        m = mask[sy1 - y1: sy2 - y1, sx1 - x1: sx2 - x1]
        if m.sum() < 0.35 * mask.sum():
            return None                      # too little visible to label
        region = img[sy1:sy2, sx1:sx2]
        region[m] = patch[sy1 - y1: sy2 - y1, sx1 - x1: sx2 - x1][m]
        ys, xs = np.where(m)
        return (sx1 + xs.min(), sy1 + ys.min(), sx1 + xs.max() + 1,
                sy1 + ys.max() + 1, c)

    ids = []
    for i in range(num_images):
        hard = rng.random() < hard_frac
        img_id = ("h" if hard else "e") + f"{i:05d}"
        img = np.full((h, w, 3), 120.0, np.float32)
        img += rng.normal(0, 8, (h, w, 3))
        objs = []
        if not hard:
            for _ in range(int(rng.integers(1, 3))):
                c = int(rng.integers(4))
                size = int(rng.integers(56, 96))
                cx = rng.uniform(size / 2 + 2, w - size / 2 - 2)
                cy = rng.uniform(size / 2 + 2, h - size / 2 - 2)
                r = draw(img, c, size, cx, cy)
                if r:
                    objs.append(r)
        else:
            mode = rng.integers(4)
            if mode == 0:        # truncation: centers near/past the border
                for _ in range(int(rng.integers(1, 3))):
                    c = int(rng.integers(4))
                    size = int(rng.integers(56, 96))
                    edge = rng.integers(4)
                    off = rng.uniform(-0.25, 0.25) * size
                    if edge == 0:
                        cx, cy = off, rng.uniform(20, h - 20)
                    elif edge == 1:
                        cx, cy = w - off, rng.uniform(20, h - 20)
                    elif edge == 2:
                        cx, cy = rng.uniform(20, w - 20), off
                    else:
                        cx, cy = rng.uniform(20, w - 20), h - off
                    r = draw(img, c, size, cx, cy)
                    if r:
                        objs.append(r)
            elif mode == 1:      # occlusion: bars over the object
                c = int(rng.integers(4))
                size = int(rng.integers(56, 96))
                cx = rng.uniform(size / 2 + 2, w - size / 2 - 2)
                cy = rng.uniform(size / 2 + 2, h - size / 2 - 2)
                r = draw(img, c, size, cx, cy)
                if r:
                    objs.append(r)
                    for _ in range(int(rng.integers(1, 3))):
                        bw_ = int(rng.uniform(0.25, 0.45) * size)
                        bx = int(rng.uniform(r[0], max(r[0], r[2] - bw_)))
                        img[:, bx:bx + bw_] = (
                            120.0 + rng.normal(0, 8, (h, bw_, 3)))
            elif mode == 2:      # small scale
                for _ in range(int(rng.integers(2, 4))):
                    c = int(rng.integers(4))
                    size = int(rng.integers(20, 34))
                    cx = rng.uniform(size / 2 + 2, w - size / 2 - 2)
                    cy = rng.uniform(size / 2 + 2, h - size / 2 - 2)
                    r = draw(img, c, size, cx, cy)
                    if r:
                        objs.append(r)
            else:                # crowding: overlapping cluster
                base_x = rng.uniform(60, w - 60)
                base_y = rng.uniform(50, h - 50)
                for _ in range(int(rng.integers(3, 6))):
                    c = int(rng.integers(4))
                    size = int(rng.integers(40, 64))
                    cx = np.clip(base_x + rng.normal(0, 24), 10, w - 10)
                    cy = np.clip(base_y + rng.normal(0, 24), 10, h - 10)
                    r = draw(img, c, size, cx, cy)
                    if r:
                        objs.append(r)
            # annotation-free distractors: class colors, wrong shape (thin bar)
            for _ in range(int(rng.integers(0, 3))):
                c = int(rng.integers(4))
                dw, dh = int(rng.integers(24, 48)), int(rng.integers(4, 8))
                x1 = int(rng.integers(0, w - dw))
                y1 = int(rng.integers(0, h - dh))
                img[y1:y1 + dh, x1:x1 + dw] = (
                    colors[c] + rng.normal(0, 12, (dh, dw, 3)))
        if not objs:             # guarantee at least one labeled object
            c = int(rng.integers(4))
            r = draw(img, c, 64, w / 2, h / 2)
            objs.append(r)
        ids.append(img_id)
        filename = f"{img_id}.jpg"
        _save_image(os.path.join(voc, "JPEGImages", filename),
                    np.clip(img, 0, 255).astype(np.uint8), "jpg")
        xml_objs = "".join(
            f"<object><name>{classes[c]}</name><difficult>0</difficult>"
            f"<bndbox><xmin>{max(x1, 1)}</xmin><ymin>{max(y1, 1)}</ymin>"
            f"<xmax>{x2}</xmax><ymax>{y2}</ymax></bndbox></object>"
            for x1, y1, x2, y2, c in objs)
        with open(os.path.join(voc, "Annotations", img_id + ".xml"), "w") as f:
            f.write(f"<annotation><filename>{filename}</filename><size>"
                    f"<width>{w}</width><height>{h}</height><depth>3</depth>"
                    f"</size>{xml_objs}</annotation>")
    for split in (image_set, "test"):
        with open(os.path.join(voc, "ImageSets", "Main", split + ".txt"), "w") as f:
            f.write("\n".join(ids))
    return str(root)
