"""Prefetching batch loader (port of ``cald_tpu/data/loader.py``): decode on
a thread pool, assemble padded batches in a deterministic order.

``decode_image`` reads ``.npy`` images with NumPy, JPEGs with the native
decoder (``cald_tpu_torch.native``) once it is built, and everything else
with Pillow, imported only when such a file is read. Batches of JPEGs with
no host transform take the native fused decode + resize + paste once the
decoder is built, as in the JAX package.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Sequence

import numpy as np

from cald_tpu_torch import native
from cald_tpu_torch.data.batching import (
    Batch, Canvas, choose_canvas, make_padded_batch, resize_scale,
)


def _is_jpeg(path: str) -> bool:
    return path.lower().endswith((".jpg", ".jpeg"))


def decode_image(path: str) -> np.ndarray:
    """An image file -> (H, W, 3) uint8 RGB: ``.npy`` by ``np.load``, JPEG
    by the native decoder when built, else (and for a JPEG it cannot read)
    by Pillow."""
    if path.lower().endswith(".npy"):
        return np.load(path)
    if _is_jpeg(path) and native.available():
        try:
            return native.decode(path)
        except IOError:
            pass  # corrupt header etc.: Pillow reads it or raises properly
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


class BatchLoader:
    """Iterates index batches -> padded ``Batch``es with background prefetch.

    Args:
      dataset: object with ``record(i)`` and ``__len__``.
      batches: list of same-group index lists (from ``grouped_batch_indices``).
      canvases: static canvas set; each batch uses the canvas fitting its
        largest member.
      min_size/max_size: reference resize rule parameters.
      max_boxes: GT slots per image.
      transform: optional host transform fn(image, boxes, rng) -> (image, boxes)
        applied before resizing (e.g. random_horizontal_flip), drawing from
        ``default_rng((seed, batch_no))``.
      seed: RNG seed for the transform stream (per-epoch determinism).
    """

    def __init__(self, dataset, batches: Sequence[Sequence[int]], *,
                 canvases: Sequence[Canvas], min_size: int, max_size: int,
                 max_boxes: int, transform: Callable | None = None,
                 num_workers: int = 8, prefetch: int = 4, seed: int = 0):
        self.dataset = dataset
        self.batches = [list(b) for b in batches]
        self.canvases = tuple(canvases)
        self.min_size = min_size
        self.max_size = max_size
        self.max_boxes = max_boxes
        self.transform = transform
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.seed = seed

    def __len__(self) -> int:
        return len(self.batches)

    def _build(self, batch_no: int, indices: list[int]) -> Batch:
        records = [self.dataset.record(i) for i in indices]
        fast = self._build_native(indices, records)
        if fast is not None:
            return fast
        images = [decode_image(r.image_path) for r in records]
        boxes = [r.boxes for r in records]
        if self.transform is not None:
            rng = np.random.default_rng((self.seed, batch_no))
            images, boxes = map(list, zip(*(
                self.transform(im, bx, rng) for im, bx in zip(images, boxes))))
        # one canvas per batch: must fit every member's resized shape
        need_h = need_w = 0
        for im in images:
            h, w = im.shape[:2]
            s = resize_scale(h, w, self.min_size, self.max_size)
            need_h = max(need_h, int(round(h * s)))
            need_w = max(need_w, int(round(w * s)))
        canvas = choose_canvas(need_h, need_w, self.canvases)
        return make_padded_batch(images, records, canvas,
                                 min_size=self.min_size, max_size=self.max_size,
                                 max_boxes=self.max_boxes, indices=indices,
                                 boxes_override=boxes)

    def _build_native(self, indices: list[int], records) -> Batch | None:
        """The fast path: decode + resize + canvas paste fused in C++ (one
        pass, no uint8 round trips), only when no host transform is set, the
        decoder is built and every member is a JPEG. The canvas comes from the
        records' stored sizes, so nothing is decoded twice."""
        if self.transform is not None or not native.available():
            return None
        if not all(_is_jpeg(r.image_path) for r in records):
            return None
        b = len(records)
        need_h = need_w = 0
        scales = []
        for r in records:
            s = resize_scale(r.height, r.width, self.min_size, self.max_size)
            scales.append(s)
            need_h = max(need_h, int(round(r.height * s)))
            need_w = max(need_w, int(round(r.width * s)))
        canvas = choose_canvas(need_h, need_w, self.canvases)

        images = np.zeros((b, canvas.height, canvas.width, 3), np.float32)
        valid_hw = np.zeros((b, 2), np.int32)
        out_scale = np.zeros((b,), np.float32)
        boxes = np.zeros((b, self.max_boxes, 4), np.float32)
        labels = np.zeros((b, self.max_boxes), np.int32)
        box_valid = np.zeros((b, self.max_boxes), bool)
        try:
            for i, (r, s) in enumerate(zip(records, scales)):
                s = min(s, canvas.height / r.height, canvas.width / r.width)
                valid_hw[i] = native.decode_resize_into(r.image_path, images[i], s)
                out_scale[i] = s
                n = min(len(r.boxes), self.max_boxes)
                if n:
                    boxes[i, :n] = r.boxes[:n] * s
                    labels[i, :n] = r.labels[:n]
                    box_valid[i, :n] = True
        except IOError:
            return None  # a corrupt file: the Pillow path raises properly
        return Batch(images=images, valid_hw=valid_hw, scale=out_scale, boxes=boxes,
                     labels=labels, box_valid=box_valid,
                     image_idx=np.asarray(indices, np.int32))

    def __iter__(self) -> Iterable[Batch]:
        if not self.batches:
            return
        if self.num_workers <= 0:
            # synchronous path (the reference's -j 0): decode on the consumer
            # thread, no prefetch
            for n, idxs in enumerate(self.batches):
                yield self._build(n, idxs)
            return
        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                futures = [pool.submit(self._build, n, idxs)
                           for n, idxs in enumerate(self.batches)]
                for fut in futures:
                    if stop.is_set():
                        fut.cancel()
                        continue
                    try:
                        out_q.put(fut.result())
                    except Exception as e:  # handed to the consumer, which raises it
                        out_q.put(e)
                        return
            out_q.put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            # drain so the producer can exit
            while thread.is_alive():
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    thread.join(timeout=0.1)
