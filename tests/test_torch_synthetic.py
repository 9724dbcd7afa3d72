"""The port's ``make_voc`` and ``make_hard_easy_voc`` against the JAX
package's: the same arguments write the same tree, byte for byte (JPEGs,
XML and the ``ImageSets`` lists)."""

from __future__ import annotations

import os

import pytest

from cald_tpu.data import synthetic as jsynthetic
from cald_tpu_torch.data import synthetic


def tree(root) -> dict:
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


@pytest.mark.parametrize("seed", [0, 5])
def test_make_voc_matches(tmp_path, seed):
    kw = dict(num_images=7, size_range=((40, 90), (50, 100)), max_objects=4, seed=seed,
              image_set="train", extra_image_sets=("val",))
    want = tree(jsynthetic.make_voc(tmp_path / "jax", **kw))
    got = tree(synthetic.make_voc(tmp_path / "port", **kw))
    assert len(want) == 7 * 2 + 2
    assert got == want


@pytest.mark.parametrize("seed", [1, 100])
def test_make_hard_easy_voc_matches(tmp_path, seed):
    kw = dict(num_images=24, hard_frac=0.5, seed=seed)
    want = tree(jsynthetic.make_hard_easy_voc(tmp_path / "jax", **kw))
    got = tree(synthetic.make_hard_easy_voc(tmp_path / "port", **kw))
    assert got == want
    ids = want["VOC2007/ImageSets/Main/trainval.txt"].decode().split("\n")
    # the prefixes the experiments audit, both kinds present
    assert {i[0] for i in ids} == {"h", "e"}
    assert want["VOC2007/ImageSets/Main/test.txt"] == want["VOC2007/ImageSets/Main/trainval.txt"]
