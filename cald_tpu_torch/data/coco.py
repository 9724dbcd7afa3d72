"""COCO dataset parsing, stdlib json only (port of ``cald_tpu/data/coco.py``).

The reference's conversion pipeline (detection/coco_utils.py) on plain
dicts:
  - xywh -> xyxy with clamping to the image bounds (coco_utils.py:74-87),
  - degenerate boxes (zero/negative extent) dropped (coco_utils.py:82-87),
  - crowd annotations dropped for training (coco_utils.py:71),
  - images without usable annotations filtered out (coco_utils.py:106-143).

Category ids are remapped to a dense, sorted 1..C label space (0 =
background); ``CocoIndex`` keeps both directions so eval can emit native
category ids. The reference trains on raw COCO category ids with
num_classes=91 (detection/train.py:41-51); the dense labels give the
classifier 81 logits instead, and map back losslessly at eval time.
"""

from __future__ import annotations

import json
import os

import numpy as np

from cald_tpu_torch.data.records import ImageRecord

# The 80 populated COCO categories in ascending category-id order
# (the reference's detection/engine.py:161-176 minus background).
COCO_CLASSES = (
    "__background__",
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train", "truck",
    "boat", "traffic light", "fire hydrant", "stop sign", "parking meter", "bench",
    "bird", "cat", "dog", "horse", "sheep", "cow", "elephant", "bear", "zebra",
    "giraffe", "backpack", "umbrella", "handbag", "tie", "suitcase", "frisbee",
    "skis", "snowboard", "sports ball", "kite", "baseball bat", "baseball glove",
    "skateboard", "surfboard", "tennis racket", "bottle", "wine glass", "cup",
    "fork", "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair", "couch",
    "potted plant", "bed", "dining table", "toilet", "tv", "laptop", "mouse",
    "remote", "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear",
    "hair drier", "toothbrush",
)


class CocoIndex:
    """Minimal in-memory COCO annotation index built from the raw json."""

    def __init__(self, ann_file: str):
        with open(ann_file) as f:
            data = json.load(f)
        self.images = {im["id"]: im for im in data["images"]}
        self.categories = {c["id"]: c for c in data.get("categories", [])}
        self.anns_by_image: dict[int, list[dict]] = {im_id: [] for im_id in self.images}
        for ann in data.get("annotations", []):
            if ann["image_id"] in self.anns_by_image:
                self.anns_by_image[ann["image_id"]].append(ann)
        # dense label mapping: sorted category ids -> 1..C
        self.cat_ids = sorted(self.categories.keys())
        self.cat_to_label = {cid: i + 1 for i, cid in enumerate(self.cat_ids)}
        self.label_to_cat = {i + 1: cid for i, cid in enumerate(self.cat_ids)}

    @property
    def num_classes(self) -> int:
        return len(self.cat_ids) + 1


def _convert_anns(index: CocoIndex, im: dict) -> dict:
    """annotation list -> clamped xyxy arrays, crowd + degenerate boxes dropped."""
    w, h = im["width"], im["height"]
    boxes, labels, areas, iscrowd = [], [], [], []
    for ann in index.anns_by_image[im["id"]]:
        if ann.get("iscrowd", 0):
            continue
        x, y, bw, bh = ann["bbox"]
        x1 = min(max(x, 0.0), w)
        y1 = min(max(y, 0.0), h)
        x2 = min(max(x + bw, 0.0), w)
        y2 = min(max(y + bh, 0.0), h)
        if x2 <= x1 or y2 <= y1:
            continue
        boxes.append([x1, y1, x2, y2])
        labels.append(index.cat_to_label[ann["category_id"]])
        areas.append(ann.get("area", (x2 - x1) * (y2 - y1)))
        iscrowd.append(0)
    n = len(boxes)
    return {
        "boxes": np.asarray(boxes, np.float32).reshape(n, 4),
        "labels": np.asarray(labels, np.int32),
        "area": np.asarray(areas, np.float32),
        "iscrowd": np.asarray(iscrowd, np.int32),
    }


class CocoDataset:
    """COCO detection dataset over a pre-built index; images w/o annotations are
    dropped for training splits (reference coco_utils.py:106-143)."""

    def __init__(self, img_dir: str, ann_file: str, *, filter_empty: bool = True):
        self.img_dir = img_dir
        self.index = CocoIndex(ann_file)
        ids = sorted(self.index.images.keys())
        if filter_empty:
            ids = [i for i in ids if len(_convert_anns(self.index, self.index.images[i])["boxes"])]
        self.ids = ids
        self._records: list[ImageRecord | None] = [None] * len(ids)

    def __len__(self) -> int:
        return len(self.ids)

    @property
    def num_classes(self) -> int:
        return self.index.num_classes

    @property
    def class_names(self):
        return tuple(["__background__"] +
                     [self.index.categories[c]["name"] for c in self.index.cat_ids])

    def record(self, i: int) -> ImageRecord:
        if self._records[i] is None:
            im = self.index.images[self.ids[i]]
            t = _convert_anns(self.index, im)
            self._records[i] = ImageRecord(
                image_id=str(im["id"]),
                image_path=os.path.join(self.img_dir, im["file_name"]),
                width=im["width"],
                height=im["height"],
                boxes=t["boxes"],
                labels=t["labels"],
                difficult=np.zeros((len(t["boxes"]),), np.int32),
                area=t["area"],
                iscrowd=t["iscrowd"],
            )
        return self._records[i]

    __getitem__ = record

    def _kept_anns(self, i: int) -> list[dict]:
        """The annotation dicts surviving _convert_anns' filters, in record
        box order (non-crowd, non-degenerate)."""
        im = self.index.images[self.ids[i]]
        w, h = im["width"], im["height"]
        kept = []
        for ann in self.index.anns_by_image[im["id"]]:
            if ann.get("iscrowd", 0):
                continue
            x, y, bw, bh = ann["bbox"]
            if min(x + bw, w) <= max(x, 0) or min(y + bh, h) <= max(y, 0):
                continue
            kept.append(ann)
        return kept

    def masks_for(self, i: int) -> np.ndarray:
        """(N, H, W) uint8 instance masks aligned with ``record(i).boxes``
        (reference coco_utils.py:33-47 / ConvertCocoPolysToMask; decoded on
        demand — masks are heavy and unused by the AL drivers)."""
        from cald_tpu_torch.data.masks import convert_coco_poly_to_mask

        im = self.index.images[self.ids[i]]
        segs = [a.get("segmentation") or [] for a in self._kept_anns(i)]
        return convert_coco_poly_to_mask(segs, im["height"], im["width"])

    def keypoints_for(self, i: int) -> np.ndarray:
        """(N, 17, 3) float32 COCO person keypoints aligned with
        ``record(i).boxes`` (zeros where absent; coco_utils.py:77-81)."""
        kept = self._kept_anns(i)
        out = np.zeros((len(kept), 17, 3), np.float32)
        for j, ann in enumerate(kept):
            kp = ann.get("keypoints")
            if kp:
                out[j] = np.asarray(kp, np.float32).reshape(17, 3)
        return out

    def aspect_ratios(self) -> np.ndarray:
        out = np.empty((len(self),), np.float64)
        for i, img_id in enumerate(self.ids):
            im = self.index.images[img_id]
            out[i] = im["width"] / max(im["height"], 1)
        return out


def get_coco(root: str, image_set: str = "train", year: str = "2017") -> CocoDataset:
    """Standard COCO layout: root/{split}{year}/ + root/annotations/instances_*.json
    (reference get_coco, coco_utils.py:223-249)."""
    split = f"{image_set}{year}"
    return CocoDataset(
        img_dir=os.path.join(root, split),
        ann_file=os.path.join(root, "annotations", f"instances_{split}.json"),
        filter_empty=(image_set == "train"),
    )
