"""The port's detection drawing (``cald_tpu_torch.utils.viz``), the
counterpart of tests/test_engine.py::TestViz, and the same pixels as the JAX
package's on the same inputs."""

import numpy as np
import pytest

from cald_tpu.utils.viz import draw_detections as jdraw
from cald_tpu_torch.utils import draw_detections, save_detection_image


def test_draw_and_save(tmp_path, rng):
    img = rng.uniform(0, 255, (40, 60, 3)).astype(np.uint8)
    boxes = np.array([[5, 5, 30, 30], [20, 10, 55, 35.0]])
    out = draw_detections(img, boxes, labels=[1, 2], scores=[0.9, 0.4],
                          class_names=("bg", "a", "b"), score_thresh=0.5)
    assert out.size == (60, 40)
    # the low-score box is skipped; the drawn one changed pixels
    assert not np.array_equal(np.asarray(out), img)
    p = tmp_path / "det.png"
    save_detection_image(str(p), img, boxes, labels=[1, 2])
    assert p.exists() and p.stat().st_size > 0


@pytest.mark.parametrize("kw", [dict(), dict(labels=[3, 25], scores=[0.9, 0.2], score_thresh=0.3),
                                dict(labels=[1, 2], class_names=("bg", "a", "b"))])
def test_same_pixels_as_jax(rng, kw):
    img = rng.uniform(0, 255, (48, 64, 3)).astype(np.float32)
    boxes = np.array([[4, 6, 40, 30], [10.5, 12.25, 60, 44]])
    np.testing.assert_array_equal(np.asarray(draw_detections(img, boxes, **kw)),
                                  np.asarray(jdraw(img, boxes, **kw)))
