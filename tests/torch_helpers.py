"""Shared set-up of the PyTorch-port parity tests (tests/test_torch_*.py).

Importing this module pins torch to one CPU thread: the suite runs under
several xdist workers, and torch's default of one thread per core would
oversubscribe the machine. The helpers build the same tiny Faster R-CNN in
both packages from one seeded Flax init, moved into the port through the
weight bridge.
"""

from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cald_tpu.models.faster_rcnn import FasterRCNN as JaxFasterRCNN
from cald_tpu.models.faster_rcnn import FasterRCNNConfig as JaxConfig
from cald_tpu_torch.convert.from_flax import flax_to_state_dict
from cald_tpu_torch.models.faster_rcnn import FasterRCNN, FasterRCNNConfig

torch.set_num_threads(1)

CANVAS = (96, 128)
TINY = dict(num_classes=4, backbone="tiny", compute_dtype="float32",
            rpn_pre_nms_top_n_test=200, rpn_post_nms_top_n_test=64,
            detections_per_img=20, representation_size=64)


def tiny_images(seed: int = 7):
    """Two 0..255 images on the 96x128 canvas, the second one padded."""
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 255, (2, *CANVAS, 3)).astype(np.float32)
    images[1, 80:] = 0.0
    images[1, :, 100:] = 0.0
    return images, np.array([[96, 128], [80, 100]], np.int32)


def _amplify(params, frozen, rng):
    """Random heads are near zero (std 0.01): flat softmax rows, identical
    boxes. Scale them as tests/test_golden_parity.py does so the filter, NMS
    and top-k have work to do; give the frozen norms non-trivial statistics
    so the bridge's norm mapping is exercised."""
    p = copy.deepcopy(jax.tree.map(np.asarray, params))
    for name, f in (("objectness", 60.0), ("deltas", 8.0), ("conv", 3.0)):
        p["rpn_head"][name]["kernel"] = p["rpn_head"][name]["kernel"] * f
    p["box_predictor"]["cls_score"]["kernel"] = p["box_predictor"]["cls_score"]["kernel"] * 35.0
    p["box_predictor"]["bbox_pred"]["kernel"] = p["box_predictor"]["bbox_pred"]["kernel"] * 15.0

    def perturb(path, x):
        name = path[-1].key
        shape = np.shape(x)
        if name == "scale":
            return rng.uniform(0.7, 1.3, shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.7, 1.4, shape).astype(np.float32)
        return rng.normal(0.0, 0.05, shape).astype(np.float32)     # bias, mean

    return p, jax.tree_util.tree_map_with_path(perturb, frozen)


def tiny_models(seed: int = 0):
    """(jax_model, variables, torch_model) sharing one seeded set of weights."""
    jmodel = JaxFasterRCNN(JaxConfig(norm="frozen", **TINY))
    images, valid_hw = tiny_images()
    variables = jax.jit(jmodel.init)(jax.random.key(seed), jnp.asarray(images),
                                     jnp.asarray(valid_hw))
    params, frozen = _amplify(variables["params"], variables["frozen"],
                              np.random.default_rng(seed))
    variables = {"params": params, "frozen": frozen}
    tmodel = FasterRCNN(FasterRCNNConfig(**TINY))
    tmodel.load_state_dict(flax_to_state_dict(variables), strict=True)
    return jmodel, variables, tmodel.eval()


def to_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()
