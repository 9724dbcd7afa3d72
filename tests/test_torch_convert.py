"""The weight bridge (cald_tpu_torch.convert.from_flax) and the port's import
hygiene."""

import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from cald_tpu_torch.convert.from_flax import flax_to_state_dict
from cald_tpu_torch.models.faster_rcnn import FasterRCNN, FasterRCNNConfig
from tests.torch_helpers import TINY, tiny_models


@pytest.fixture(scope="module")
def bridged():
    _, variables, _ = tiny_models()
    return variables, flax_to_state_dict(variables)


def test_every_leaf_consumed_and_every_parameter_filled(bridged):
    variables, sd = bridged
    n_leaves = len(jax.tree_util.tree_leaves(variables))
    assert len(sd) == n_leaves                       # one key per Flax leaf
    model = FasterRCNN(FasterRCNNConfig(**TINY))
    want = model.state_dict()
    assert set(sd) == set(want)                      # nothing missing, nothing extra
    for k, v in sd.items():
        assert v.shape == want[k].shape, k
    model.load_state_dict(sd, strict=True)


def test_layouts(bridged):
    variables, sd = bridged
    p, f = variables["params"], variables["frozen"]
    # conv HWIO -> OIHW, Dense (in, out) -> (out, in)
    np.testing.assert_array_equal(sd["backbone.conv1.weight"].numpy(),
                                  np.asarray(p["backbone"]["conv1"]["kernel"]).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["box_head.fc6.weight"].numpy(),
                                  np.asarray(p["box_head"]["fc6"]["kernel"]).T)
    # the Flax auto-named norms land on torchvision's names
    np.testing.assert_array_equal(
        sd["backbone.layer2_0.downsample_bn.var"].numpy(),
        np.asarray(f["backbone"]["layer2_0"]["FrozenBatchNorm_3"]["var"]))
    np.testing.assert_array_equal(sd["backbone.bn1.scale"].numpy(),
                                  np.asarray(f["backbone"]["FrozenBatchNorm_0"]["scale"]))


@pytest.mark.parametrize("bad", ["collection", "leaf"])
def test_unexpected_input_raises(bridged, bad):
    variables, _ = bridged
    if bad == "collection":
        broken = {**variables, "batch_stats": {}}
    else:
        broken = {"params": {"x": {"scale": np.ones(3)}}, "frozen": {}}
    with pytest.raises(ValueError):
        flax_to_state_dict(broken)


def test_port_imports_no_jax():
    """Importing every module of the port pulls in neither JAX, Flax nor
    the JAX package (the machine with the card has none of them)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import cald_tpu_torch\n"
        "for m in pkgutil.walk_packages(cald_tpu_torch.__path__, 'cald_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'cald_tpu')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('cald_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 32          # the scoring and the training modules


def test_chip_smoke_refuses_without_cuda():
    """chip_smoke.py has no CPU path: without a CUDA device it exits non-zero
    and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    script = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    out = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
