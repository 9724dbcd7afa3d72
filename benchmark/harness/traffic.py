"""The one traffic generator: a VOC-layout JPEG tree made from a mix file and
a seed.

A mix (``traffic/<name>.json``) fixes the work: how many images of each size,
the histogram of ground-truth boxes an image, the JPEG quality, the batch,
the loader's workers and the pool's budget. The seed only orders and fills
it: every seed gets the same sizes and box counts, shuffled, and its own
picture content, so seeds change no amount of work.

Pictures are photo-like (``chip_smoke.py::_scene``'s kind: smooth gradients,
flat shapes, mild noise), made in vectorised NumPy and written by Pillow.
A tree is cached per (mix, seed) under ``benchmark/cache/``, which git
ignores, so that a later run of the same seed skips the writes.
"""

from __future__ import annotations

import json
import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

BENCH_DIR = Path(__file__).resolve().parents[1]
CACHE_DIR = BENCH_DIR / "cache"
VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat", "chair",
    "cow", "diningtable", "dog", "horse", "motorbike", "person", "pottedplant",
    "sheep", "sofa", "train", "tvmonitor",
)


def load_mix(name: str) -> dict:
    with open(BENCH_DIR / "traffic" / f"{name}.json") as f:
        return json.load(f)


def seed_rng(seed: int, *stream: int) -> np.random.Generator:
    """A NumPy generator for ``seed`` (any integer, however large) and a
    stream number."""
    return np.random.default_rng(np.random.SeedSequence([seed % 2 ** 64, *stream]))


def _layout(mix: dict, seed: int):
    """(sizes (N, 2) as (h, w), box counts (N,)) of the pool's images, and
    the labeled records' box counts: the mix's fixed multisets in the
    seed's order."""
    rng = seed_rng(seed, 0)
    sizes = np.concatenate([np.tile([s["height"], s["width"]], (s["count"], 1))
                            for s in mix["sizes"]])
    sizes = sizes[rng.permutation(len(sizes))]

    def counts(n):
        hist = np.asarray(mix["boxes_per_image"], np.float64)
        per = np.floor(hist / hist.sum() * n).astype(int)
        per[0] += n - per.sum()
        c = np.repeat(np.arange(1, len(hist) + 1), per)
        return c[rng.permutation(n)]

    return sizes, counts(len(sizes)), counts(mix["labeled_images"])


def _boxes(rng, h: int, w: int, k: int) -> np.ndarray:
    """k xyxy boxes of 1/8 to 2/3 of the image's sides, inside it."""
    bw = rng.uniform(w / 8, 2 * w / 3, k)
    bh = rng.uniform(h / 8, 2 * h / 3, k)
    x0 = rng.uniform(0, 1, k) * (w - bw)
    y0 = rng.uniform(0, 1, k) * (h - bh)
    return np.stack([x0, y0, x0 + bw, y0 + bh], -1)


def scenes(rng, h: int, w: int, boxes: list[np.ndarray]) -> np.ndarray:
    """(n, h, w, 3) uint8 pictures: per image a gradient of its own
    frequencies, its boxes painted as flat shapes with two more, mild noise
    (one noise field a call, rolled by a random offset per image)."""
    n = len(boxes)
    fx = rng.uniform(12, 30, (n, 1, 3)).astype(np.float32)
    fy = rng.uniform(16, 36, (n, 1, 3)).astype(np.float32)
    ph = rng.uniform(0, 2 * np.pi, (n, 1, 3)).astype(np.float32)
    a = np.arange(w, dtype=np.float32)[None, :, None] / fx + ph      # (n, w, 3)
    b = np.arange(h, dtype=np.float32)[None, :, None] / fy           # (n, h, 3)
    # sin(a + b), separably
    img = 120 + 80 * (np.sin(a)[:, None] * np.cos(b)[:, :, None]
                      + np.cos(a)[:, None] * np.sin(b)[:, :, None])
    for i, bx in enumerate(boxes):
        for x0, y0, x1, y1 in np.concatenate([bx, _boxes(rng, h, w, 2)]):
            img[i, int(y0):int(y1), int(x0):int(x1)] = rng.uniform(0, 255, 3)
    noise = rng.standard_normal((h, w, 3), dtype=np.float32) * 6
    for i in range(n):
        img[i] += np.roll(noise, (int(rng.integers(h)), int(rng.integers(w))), axis=(0, 1))
    return np.clip(img, 0, 255).astype(np.uint8)


def _xml(name: str, w: int, h: int, boxes: np.ndarray, labels: np.ndarray) -> str:
    objs = "".join(
        f"<object><name>{VOC_CLASSES[l - 1]}</name><difficult>0</difficult><bndbox>"
        f"<xmin>{int(b[0]) + 1}</xmin><ymin>{int(b[1]) + 1}</ymin>"
        f"<xmax>{int(b[2]) + 1}</xmax><ymax>{int(b[3]) + 1}</ymax></bndbox></object>"
        for b, l in zip(boxes, labels))
    return (f"<annotation><filename>{name}.jpg</filename><size><width>{w}</width>"
            f"<height>{h}</height><depth>3</depth></size>{objs}</annotation>")


def build_tree(mix_name: str, seed: int, mix: dict | None = None,
               cache_dir: Path = CACHE_DIR, workers: int = 8) -> dict:
    """The (mix, seed) tree, from the cache or written now. Returns its
    layout: ``root`` (the VOCdevkit root), ``labeled`` and ``pool`` (dataset
    indices), and ``cached`` (whether it was there already)."""
    mix = load_mix(mix_name) if mix is None else mix
    out = Path(cache_dir) / mix_name / str(seed)
    sizes, pool_counts, labeled_counts = _layout(mix, seed)
    n_lab, n_pool = len(labeled_counts), len(sizes)
    layout = {"root": str(out), "labeled": list(range(n_lab)),
              "pool": list(range(n_lab, n_lab + n_pool)), "cached": True}
    if (out / "done").exists():
        return layout
    layout["cached"] = False
    tmp = out.with_name(out.name + ".partial")
    shutil.rmtree(tmp, ignore_errors=True)
    voc = tmp / "VOC2007"
    for d in ("JPEGImages", "Annotations", "ImageSets/Main"):
        (voc / d).mkdir(parents=True, exist_ok=True)
    rng = seed_rng(seed, 1)
    ids = [f"{i:06d}" for i in range(n_lab + n_pool)]
    # labeled images: annotations only (scoring reads their labels, never
    # their pixels)
    for i, k in enumerate(labeled_counts):
        h, w = mix["sizes"][0]["height"], mix["sizes"][0]["width"]
        b = _boxes(rng, h, w, int(k))
        (voc / "Annotations" / f"{ids[i]}.xml").write_text(
            _xml(ids[i], w, h, b, rng.integers(1, 21, int(k))))
    quality = int(mix["jpeg_quality"])

    def write(job):
        from PIL import Image

        (h, w), idxs, bxs, labels, sub_seed = job
        pics = scenes(seed_rng(seed, 2, sub_seed), h, w, bxs)
        for i, pic, b, l in zip(idxs, pics, bxs, labels):
            Image.fromarray(pic).save(voc / "JPEGImages" / f"{ids[i]}.jpg", quality=quality)
            (voc / "Annotations" / f"{ids[i]}.xml").write_text(_xml(ids[i], w, h, b, l))

    jobs = []
    chunk = 16
    for hw in sorted({tuple(s) for s in sizes.tolist()}):
        members = [n_lab + j for j in range(n_pool) if tuple(sizes[j]) == hw]
        for s in range(0, len(members), chunk):
            idxs = members[s:s + chunk]
            bxs = [_boxes(rng, *hw, int(pool_counts[i - n_lab])) for i in idxs]
            labels = [rng.integers(1, 21, len(b)) for b in bxs]
            jobs.append((hw, idxs, bxs, labels, len(jobs)))
    with ThreadPoolExecutor(max_workers=workers) as ex:
        list(ex.map(write, jobs))
    (voc / "ImageSets/Main/trainval.txt").write_text("\n".join(ids) + "\n")
    (tmp / "done").write_text(json.dumps({"mix": mix_name, "seed": seed}))
    shutil.rmtree(out, ignore_errors=True)
    os.replace(tmp, out)
    return layout
