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


# the modules of the AL loop (slice 4), each of which must import on its own
AL_LOOP_MODULES = (
    "cli.config", "cli.driver", "cli.main", "convert.torchvision_import", "data.batching",
    "data.loader", "data.pool", "data.records", "data.synthetic", "data.transforms",
    "data.voc", "engine.checkpoint", "engine.evaluate", "engine.voc_eval", "models.init",
    "strategies.random_strategy")


def test_port_imports_no_jax():
    """Importing every module of the port pulls in neither JAX, Flax nor
    the JAX package (the machine with the card has none of them), nor
    Pillow (only the loader's JPEG/PNG decode asks for it, when it reads
    such a file)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import cald_tpu_torch\n"
        "for m in pkgutil.walk_packages(cald_tpu_torch.__path__, 'cald_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'cald_tpu', 'PIL')]\n"
        "assert not bad, bad\n"
        "print(' '.join(m for m in sys.modules if m.startswith('cald_tpu_torch')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = set(out.stdout.split())
    assert len(loaded) >= 53          # scoring, training, the fused backbone, the AL loop
    assert {f"cald_tpu_torch.{m}" for m in AL_LOOP_MODULES} <= loaded


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


def test_roi_kernel_turns_imports_no_jax_and_refuses_without_cuda():
    """roi_kernel_turns.py, run on the card, imports neither JAX nor the JAX
    package, and without a CUDA device exits non-zero before building."""
    root = Path(__file__).resolve().parent.parent
    code = ("import sys\n"
            "import roi_kernel_turns\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'cald_tpu')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(root / "roi_kernel_turns.py"), "--old",
                          str(root / "cald_tpu_torch" / "csrc" / "roi_align.cu")],
                         capture_output=True, text=True, timeout=120, cwd=root)
    assert out.returncode != 0 and "wrote" not in out.stdout


def test_bottleneck_turns_imports_no_jax_and_refuses_without_cuda():
    """bottleneck_turns.py, run on the card, imports neither JAX nor the JAX
    package, and without a CUDA device exits non-zero before building."""
    root = Path(__file__).resolve().parent.parent
    code = ("import sys\n"
            "import bottleneck_turns\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'cald_tpu')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(root / "bottleneck_turns.py"), "--old",
                          str(root / "cald_tpu_torch" / "csrc" / "bottleneck.cu"), "--sweep"],
                         capture_output=True, text=True, timeout=120, cwd=root)
    assert out.returncode != 0 and "wrote" not in out.stdout
