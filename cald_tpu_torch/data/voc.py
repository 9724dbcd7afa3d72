"""PASCAL VOC dataset parsing, stdlib only (port of ``cald_tpu/data/voc.py``).

The reference's conversion: 21 classes with '__background__' at index 0,
boxes shifted to 0-based pixels by ``int(coord) - 1``, the 'difficult' flag
kept per object. The image file is the annotation's ``<filename>`` under
``JPEGImages/`` (``<id>.jpg`` in real VOC; the synthetic generator's NumPy
variant writes ``<id>.npy``).
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

from cald_tpu_torch.data.records import ImageRecord

VOC_CLASSES = (
    "__background__",
    "aeroplane", "bicycle", "bird", "boat", "bottle",
    "bus", "car", "cat", "chair", "cow",
    "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)
VOC_CLASS_TO_IDX = {c: i for i, c in enumerate(VOC_CLASSES)}


def parse_voc_xml(xml_path: str) -> dict:
    """Parse one VOC annotation file into numpy arrays (0-based xyxy boxes)."""
    root = ET.parse(xml_path).getroot()
    size = root.find("size")
    width = int(size.find("width").text)
    height = int(size.find("height").text)
    filename = root.find("filename").text

    boxes, labels, difficult = [], [], []
    for obj in root.iter("object"):
        name = obj.find("name").text.strip().lower()
        if name not in VOC_CLASS_TO_IDX:
            continue
        bb = obj.find("bndbox")
        # reference does int(coord) - 1 for every corner (voc_utils.py:29).
        box = [int(float(bb.find(k).text)) - 1 for k in ("xmin", "ymin", "xmax", "ymax")]
        diff_node = obj.find("difficult")
        diff = int(diff_node.text) if diff_node is not None else 0
        boxes.append(box)
        labels.append(VOC_CLASS_TO_IDX[name])
        difficult.append(diff)

    n = len(boxes)
    return {
        "filename": filename,
        "width": width,
        "height": height,
        "boxes": np.asarray(boxes, np.float32).reshape(n, 4),
        "labels": np.asarray(labels, np.int32),
        "difficult": np.asarray(difficult, np.int32),
    }


class VOCDataset:
    """Index over a VOCdevkit split; annotations parsed lazily (cheap XML),
    images decoded by the loader."""

    def __init__(self, root: str, year: str, image_set: str):
        voc_root = os.path.join(root, f"VOC{year}")
        if not os.path.isdir(voc_root):
            # tolerate roots that already point at VOCxxxx or VOCdevkit
            alt = os.path.join(root, "VOCdevkit", f"VOC{year}")
            voc_root = alt if os.path.isdir(alt) else root
        self.root = voc_root
        self.year = year
        self.image_set = image_set
        split_file = os.path.join(voc_root, "ImageSets", "Main", image_set + ".txt")
        with open(split_file) as f:
            self.ids = [line.strip() for line in f if line.strip()]
        self._records: list[ImageRecord | None] = [None] * len(self.ids)

    def __len__(self) -> int:
        return len(self.ids)

    @property
    def num_classes(self) -> int:
        return len(VOC_CLASSES)

    @property
    def class_names(self):
        return VOC_CLASSES

    def record(self, i: int) -> ImageRecord:
        if self._records[i] is None:
            img_id = self.ids[i]
            ann = parse_voc_xml(os.path.join(self.root, "Annotations", img_id + ".xml"))
            self._records[i] = ImageRecord(
                image_id=img_id,
                image_path=os.path.join(self.root, "JPEGImages",
                                        ann["filename"] or img_id + ".jpg"),
                width=ann["width"],
                height=ann["height"],
                boxes=ann["boxes"],
                labels=ann["labels"],
                difficult=ann["difficult"],
            )
        return self._records[i]

    __getitem__ = record

    def aspect_ratios(self) -> np.ndarray:
        """w/h per image from the XMLs (no image decode), for grouping."""
        return np.asarray([self.record(i).aspect_ratio for i in range(len(self))])


def get_voc2007(root: str, image_set: str = "train") -> VOCDataset:
    return VOCDataset(root, "2007", image_set)


def get_voc2012(root: str, image_set: str = "train") -> VOCDataset:
    return VOCDataset(root, "2012", image_set)
