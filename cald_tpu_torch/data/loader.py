"""Prefetching batch loader (port of ``cald_tpu/data/loader.py``): decode on
a thread pool, assemble padded batches in a deterministic order.

``decode_image`` reads ``.npy`` images with NumPy, JPEGs with the native
decoder (``cald_tpu_torch.native``) once it is built, and everything else
with Pillow, imported only when such a file is read. Batches of JPEGs with
no host transform take the native fused decode + resize + paste once the
decoder is built, as in the JAX package.

On a CUDA ``device`` the loader takes the native decoder's device route
instead: a batch of JPEGs with no host transform is decoded by nvJPEG and
resized into its canvas on the card, and ``Batch.images`` is then that
CUDA canvas (every other field stays NumPy); JPEGs of the other batches are
decoded by nvJPEG to host arrays. Of the JPEGs, only a file nvJPEG rejects
(counted in ``native.rejected``) reaches Pillow. The consumers take
``images`` of either kind through ``batching.images_tensor``.

While a profiler capture runs, each batch built is a span ``loader.build``
on its worker thread (on the device route with ``loader.decode`` and
``loader.resize`` inside), and the consumer's wait for the next batch a span
``loader.wait`` (``cald_tpu_torch.utils.spans``).
"""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from cald_tpu_torch import native
from cald_tpu_torch.data.batching import (
    Batch, Canvas, choose_canvas, make_padded_batch, resize_scale,
)
from cald_tpu_torch.utils.spans import span


def _is_jpeg(path: str) -> bool:
    return path.lower().endswith((".jpg", ".jpeg"))


def decode_image(path: str, device=None) -> np.ndarray:
    """An image file -> (H, W, 3) uint8 RGB: ``.npy`` by ``np.load``, JPEG
    by the native decoder (on a CUDA ``device`` its nvJPEG route, else the
    libjpeg library when built), else (and for a JPEG it cannot read) by
    Pillow."""
    if path.lower().endswith(".npy"):
        return np.load(path)
    if _is_jpeg(path) and (native.on_cuda(device) or native.available()):
        try:
            return native.decode(path, device)
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
      device: the consumer's torch device. On a CUDA device JPEGs take the
        native decoder's device route (a batch without a transform arrives
        as a CUDA canvas); a CUDA device without CUDA raises here.
    """

    def __init__(self, dataset, batches: Sequence[Sequence[int]], *,
                 canvases: Sequence[Canvas], min_size: int, max_size: int,
                 max_boxes: int, transform: Callable | None = None,
                 num_workers: int = 8, prefetch: int = 4, seed: int = 0,
                 device=None):
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
        self.device = torch.device(device if device is not None else "cpu")
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"BatchLoader: device {self.device} but CUDA is not "
                                   "available")
            # the worker threads do not inherit the consumer's current device
            self.device = native.cuda_device(self.device)

    def __len__(self) -> int:
        return len(self.batches)

    def _build(self, batch_no: int, indices: list[int]) -> Batch:
        with span("loader.build"):
            records = [self.dataset.record(i) for i in indices]
            if self.device.type == "cuda":
                fast = self._build_device(indices, records)
            else:
                fast = self._build_native(indices, records)
            if fast is not None:
                return fast
            images = [decode_image(r.image_path, self.device) for r in records]
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

    def _fused_plan(self, records) -> tuple[Canvas, list[float]] | None:
        """The fused paths' canvas and per-image scales, from the records'
        stored sizes (so nothing is decoded twice), or None when a host
        transform is set or a member is not a JPEG."""
        if self.transform is not None or not all(_is_jpeg(r.image_path) for r in records):
            return None
        need_h = need_w = 0
        scales = []
        for r in records:
            s = resize_scale(r.height, r.width, self.min_size, self.max_size)
            scales.append(s)
            need_h = max(need_h, int(round(r.height * s)))
            need_w = max(need_w, int(round(r.width * s)))
        canvas = choose_canvas(need_h, need_w, self.canvases)
        # shrink further where the canvas is smaller than the resize target
        return canvas, [min(s, canvas.height / r.height, canvas.width / r.width)
                        for r, s in zip(records, scales)]

    def _fused_batch(self, indices, records, images, valid_hw, scales) -> Batch:
        b = len(records)
        boxes = np.zeros((b, self.max_boxes, 4), np.float32)
        labels = np.zeros((b, self.max_boxes), np.int32)
        box_valid = np.zeros((b, self.max_boxes), bool)
        for i, (r, s) in enumerate(zip(records, scales)):
            n = min(len(r.boxes), self.max_boxes)
            if n:
                boxes[i, :n] = r.boxes[:n] * s
                labels[i, :n] = r.labels[:n]
                box_valid[i, :n] = True
        return Batch(images=images, valid_hw=valid_hw, scale=np.asarray(scales, np.float32),
                     boxes=boxes, labels=labels, box_valid=box_valid,
                     image_idx=np.asarray(indices, np.int32))

    def _build_native(self, indices: list[int], records) -> Batch | None:
        """The fast path: decode + resize + canvas paste fused in C++ (one
        pass, no uint8 round trips), only when no host transform is set, the
        decoder is built and every member is a JPEG."""
        plan = self._fused_plan(records) if native.available() else None
        if plan is None:
            return None
        canvas, scales = plan
        images = np.zeros((len(records), canvas.height, canvas.width, 3), np.float32)
        valid_hw = np.zeros((len(records), 2), np.int32)
        try:
            for i, (r, s) in enumerate(zip(records, scales)):
                valid_hw[i] = native.decode_resize_into(r.image_path, images[i], s)
        except IOError:
            return None  # a corrupt file: the Pillow path raises properly
        return self._fused_batch(indices, records, images, valid_hw, scales)

    def _build_device(self, indices: list[int], records) -> Batch | None:
        """The device route's fast path: the batch decoded and resized into
        its canvas on ``self.device`` (``native.decode_resize_batch``), under
        the same conditions as ``_build_native`` and with the same batch.
        For a CPU device the resize is the kernel's plain version (the
        tests' route)."""
        plan = self._fused_plan(records)
        if plan is None:
            return None
        canvas, scales = plan
        try:
            images, valid_hw = native.decode_resize_batch(
                [r.image_path for r in records], scales, (canvas.height, canvas.width),
                self.device)
        except IOError:
            return None  # a file the route rejects: decoded one by one, Pillow takes it
        return self._fused_batch(indices, records, images, valid_hw, scales)

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
            # at most num_workers + prefetch batches in flight besides the
            # queue's: a device-route batch holds its canvas on the card
            jobs = iter(enumerate(self.batches))
            pending: collections.deque = collections.deque()
            with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                def fill():
                    while len(pending) < self.num_workers + self.prefetch and not stop.is_set():
                        job = next(jobs, None)
                        if job is None:
                            return
                        pending.append(pool.submit(self._build, *job))

                fill()
                while pending:
                    fut = pending.popleft()
                    if stop.is_set():
                        fut.cancel()
                        continue
                    try:
                        out_q.put(fut.result())
                    except Exception as e:  # handed to the consumer, which raises it
                        for f in pending:
                            f.cancel()
                        out_q.put(e)
                        return
                    fill()
            out_q.put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                with span("loader.wait"):       # as long as the queue is empty
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
