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
from cald_tpu.models.retinanet import RetinaNet as JaxRetinaNet
from cald_tpu.models.retinanet import RetinaNetConfig as JaxRetinaConfig
from cald_tpu_torch.convert.from_flax import flax_to_state_dict
from cald_tpu_torch.models.faster_rcnn import FasterRCNN, FasterRCNNConfig
from cald_tpu_torch.models.retinanet import RetinaNet, RetinaNetConfig

torch.set_num_threads(1)

CANVAS = (96, 128)
TINY = dict(num_classes=4, backbone="tiny", compute_dtype="float32",
            rpn_pre_nms_top_n_test=200, rpn_post_nms_top_n_test=64,
            detections_per_img=20, representation_size=64)
# the tiny training counts of the JAX package's CLI (cald_tpu.cli, build_model
# with tiny=True)
TINY_TRAIN = dict(rpn_pre_nms_top_n_train=128, rpn_post_nms_top_n_train=64,
                  rpn_batch_size_per_image=32, box_batch_size_per_image=32)
# the JAX CLI's tiny RetinaNet (cald_tpu.cli.driver.build_model, tiny=True)
# with 4 classes, in float32
TINY_RETINA = dict(num_classes=4, backbone="tiny", compute_dtype="float32",
                   detections_per_img=16, topk_candidates=64, anchor_sizes=((16, 20),) * 5)
MOBILE_ANCHORS = ((32, 64, 128, 256, 512),)


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
    and top-k have work to do; give the norms (frozen statistics, or the
    GroupNorms' scale and bias) non-trivial values so the bridge's norm
    mapping is exercised."""
    p = copy.deepcopy(jax.tree.map(np.asarray, params))
    for name, f in (("objectness", 60.0), ("deltas", 8.0), ("conv", 3.0)):
        p["rpn_head"][name]["kernel"] = p["rpn_head"][name]["kernel"] * f
    p["box_predictor"]["cls_score"]["kernel"] = p["box_predictor"]["cls_score"]["kernel"] * 35.0
    p["box_predictor"]["bbox_pred"]["kernel"] = p["box_predictor"]["bbox_pred"]["kernel"] * 15.0

    return perturb_norms(p, frozen, rng)


def perturb_norms(params, frozen, rng):
    """(params, frozen) with every norm's statistics, or GroupNorm's scale
    and bias, drawn around their identity values."""
    def perturb(path, x):
        name = path[-1].key
        shape = np.shape(x)
        if name == "scale":
            return rng.uniform(0.7, 1.3, shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.7, 1.4, shape).astype(np.float32)
        return rng.normal(0.0, 0.05, shape).astype(np.float32)     # bias, mean

    def group_norm(path):
        return any(str(getattr(k, "key", "")).startswith("GroupNorm_") for k in path)

    p = jax.tree_util.tree_map_with_path(
        lambda path, x: perturb(path, x) if group_norm(path) else x, params)
    return p, jax.tree_util.tree_map_with_path(perturb, frozen)


def tiny_models(seed: int = 0, norm: str = "frozen", **overrides):
    """(jax_model, variables, torch_model) sharing one seeded set of weights;
    ``norm`` and ``overrides`` change both configurations alike."""
    cfg = {**TINY, **overrides}
    jmodel = JaxFasterRCNN(JaxConfig(norm=norm, **cfg))
    images, valid_hw = tiny_images()
    variables = jax.jit(jmodel.init)(jax.random.key(seed), jnp.asarray(images),
                                     jnp.asarray(valid_hw))
    params, frozen = _amplify(variables["params"], variables.get("frozen", {}),
                              np.random.default_rng(seed))
    variables = {"params": params, **({"frozen": frozen} if frozen else {})}
    tmodel = FasterRCNN(FasterRCNNConfig(norm=norm, **cfg))
    tmodel.load_state_dict(flax_to_state_dict(variables), strict=True)
    return jmodel, variables, tmodel.eval()


def retina_models(seed: int = 0, cls_gain: float = 30.0, cls_bias: float = -2.5, **overrides):
    """(jax_model, variables, torch_model): a RetinaNet in both packages
    from one seeded Flax init (``TINY_RETINA`` and ``overrides``), its norms
    perturbed and its output convs amplified (``cls_logits`` by
    ``cls_gain`` with its bias at ``cls_bias``, ``bbox_reg`` by 8) so that
    detections survive the 0.05 filter."""
    cfg = {**TINY_RETINA, **overrides}
    jmodel = JaxRetinaNet(JaxRetinaConfig(**cfg))
    images, valid_hw = tiny_images()
    variables = jax.jit(jmodel.init)(jax.random.key(seed), jnp.asarray(images),
                                     jnp.asarray(valid_hw))
    params = copy.deepcopy(jax.tree.map(np.asarray, variables["params"]))
    head = params["head"]
    head["cls_logits"]["kernel"] = head["cls_logits"]["kernel"] * np.float32(cls_gain)
    head["cls_logits"]["bias"] = np.full_like(head["cls_logits"]["bias"], cls_bias)
    head["bbox_reg"]["kernel"] = head["bbox_reg"]["kernel"] * np.float32(8.0)
    params, frozen = perturb_norms(params, variables.get("frozen", {}),
                                   np.random.default_rng(seed))
    variables = {"params": params, **({"frozen": frozen} if frozen else {})}
    tmodel = RetinaNet(RetinaNetConfig(**cfg))
    tmodel.load_state_dict(flax_to_state_dict(variables), strict=True)
    return jmodel, variables, tmodel.eval()


def scale_pyramid(variables, factor):
    """The variables with the FPN's output convs scaled by ``factor``: a
    smaller pyramid, so that the amplified heads do not turn f32 rounding
    differences of the backbone into box differences."""
    params = jax.tree.map(np.asarray, variables["params"])
    for name, conv in params["fpn"].items():
        if name.startswith("output"):
            conv["kernel"] = conv["kernel"] * np.float32(factor)
            conv["bias"] = conv["bias"] * np.float32(factor)
    return {**variables, "params": params}


def to_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()
