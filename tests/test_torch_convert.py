"""The weight bridge (cald_tpu_torch.convert.from_flax) and the port's import
hygiene."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cald_tpu.models.lossnet import LossNet as JLossNet
from cald_tpu.models.retinanet import RetinaNet as JRetinaNet
from cald_tpu.models.retinanet import RetinaNetConfig as JRetinaConfig
from cald_tpu.models.vae import VAAL_VAE as JVAE
from cald_tpu.models.vae import VAALDiscriminator as JDisc
from cald_tpu_torch.convert.from_flax import VAE_TRANSPOSED, flax_to_state_dict, module_state_dict
from cald_tpu_torch.models.lossnet import LossNet
from cald_tpu_torch.models.vae import VAAL_VAE, VAALDiscriminator
from cald_tpu_torch.models.faster_rcnn import FasterRCNN, FasterRCNNConfig
from cald_tpu_torch.models.retinanet import RetinaNet, RetinaNetConfig
from tests.torch_helpers import TINY, TINY_RETINA, tiny_images, tiny_models


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


RETINA_VARIANTS = {"retina": {},
                   "retina_mobilenet": dict(backbone="mobilenet",
                                            anchor_sizes=((16, 32, 64, 128, 256),))}


@pytest.fixture(scope="module", params=sorted(RETINA_VARIANTS))
def retina_bridged(request):
    """A Flax-initialised RetinaNet (tiny or MobileNetV3, 4 classes) and its
    bridged state dict; the init runs the pyramid and the head only."""
    cfg = {**TINY_RETINA, **RETINA_VARIANTS[request.param]}
    jm = JRetinaNet(JRetinaConfig(**cfg))
    images, hw = (jnp.asarray(a) for a in tiny_images())
    variables = jax.jit(lambda k: jm.init(k, images, hw, method=lambda m, i, h: m.head(
        m.extract_features(i, h))))(jax.random.key(0))
    variables = jax.tree.map(np.asarray, variables)
    return request.param, cfg, variables, flax_to_state_dict(variables)


def test_retina_bridge_fills_every_parameter(retina_bridged):
    """Every Flax leaf of RetinaNet (ResNet + P6/P7, or MobileNetV3 +
    ``reduce``) lands on a port tensor of the same shape, strict."""
    _, cfg, variables, sd = retina_bridged
    assert len(sd) == len(jax.tree_util.tree_leaves(variables))
    model = RetinaNet(RetinaNetConfig(**cfg))
    want = model.state_dict()
    assert set(sd) == set(want)
    for k, v in sd.items():
        assert v.shape == want[k].shape, k
    model.load_state_dict(sd, strict=True)


def test_retina_bridge_layouts(retina_bridged):
    """Depthwise (k, k, 1, E) -> (E, 1, k, k); squeeze-excite biases; the
    MobileNet norms by their block's convs (block0 has no expand); P6/P7,
    the head's output convs and ``reduce`` as plain convs."""
    name, _, variables, sd = retina_bridged
    p, f = variables["params"], variables["frozen"]

    def oihw(k):
        return np.asarray(k).transpose(3, 2, 0, 1)

    head = p["head"]
    for conv in ("cls_logits", "bbox_reg", "cls_conv3"):
        np.testing.assert_array_equal(sd[f"head.{conv}.weight"].numpy(), oihw(head[conv]["kernel"]))
        np.testing.assert_array_equal(sd[f"head.{conv}.bias"].numpy(), head[conv]["bias"])
    if name == "retina":
        for conv in ("p6", "p7"):
            np.testing.assert_array_equal(sd[f"fpn.{conv}.weight"].numpy(),
                                          oihw(p["fpn"][conv]["kernel"]))
        return
    bb, fb = p["backbone"], f["backbone"]
    dw = sd["backbone.block12.depthwise.weight"].numpy()
    assert dw.shape == (672, 1, 5, 5) == oihw(bb["block12"]["depthwise"]["kernel"]).shape
    np.testing.assert_array_equal(dw, oihw(bb["block12"]["depthwise"]["kernel"]))
    np.testing.assert_array_equal(sd["backbone.block12.se.fc1.bias"].numpy(),
                                  bb["block12"]["se"]["fc1"]["bias"])
    np.testing.assert_array_equal(sd["reduce.weight"].numpy(), oihw(p["reduce"]["kernel"]))
    for key, (block, i) in {"block0.depthwise_bn": ("block0", 0),
                            "block0.project_bn": ("block0", 1),
                            "block1.expand_bn": ("block1", 0),
                            "block1.project_bn": ("block1", 2)}.items():
        np.testing.assert_array_equal(sd[f"backbone.{key}.var"].numpy(),
                                      fb[block][f"FrozenBatchNorm_{i}"]["var"])
    np.testing.assert_array_equal(sd["backbone.lastconv_bn.mean"].numpy(),
                                  fb["FrozenBatchNorm_1"]["mean"])


def _flax_modules():
    """(name, Flax module, its params as numpy, the port's module) for
    LossNet, the VAE (small widths) and the discriminator, initialised by
    Flax."""
    feats = [jnp.zeros((1, 8, 8, 16)), jnp.zeros((1, 4, 4, 16))]
    x = jnp.zeros((1, 64, 64, 3))
    out = []
    for name, jm, args, tm in (
            ("lossnet", JLossNet(num_levels=2, interm_dim=8), (feats,),
             LossNet(num_levels=2, interm_dim=8, in_channels=16)),
            ("vae", JVAE(z_dim=16, base_width=8, start_hw=2), (x, jax.random.key(1)),
             VAAL_VAE(z_dim=16, base_width=8, start_hw=2)),
            ("disc", JDisc(), (jnp.zeros((1, 16)),), VAALDiscriminator(z_dim=16))):
        params = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.key(0), *args)["params"])
        out.append((name, jm, params, tm))
    return out


@pytest.mark.parametrize("which", [0, 1, 2], ids=["lossnet", "vae", "disc"])
def test_module_bridge_fills_every_parameter(which):
    """Every Flax leaf lands on a port parameter of the same size, strict."""
    _, _, params, tm = _flax_modules()[which]
    sd = module_state_dict(params, transposed=VAE_TRANSPOSED)
    n_leaves = len(jax.tree.leaves(params))
    assert len(sd) == n_leaves == len(tm.state_dict())
    tm.load_state_dict(sd, strict=True)
    for k, v in tm.state_dict().items():
        assert v.shape == sd[k].shape, k


def test_jax_initialized_vae_gives_the_same_recon():
    """A Flax-initialised VAE through the bridge: the same reconstruction
    (atol 5e-5) with the same normals, which pins the transposed
    convolutions' kernel flip and the NHWC flatten of the fc layers."""
    _, jv, params, tv = _flax_modules()[1]
    x = np.random.default_rng(3).uniform(0, 255, (2, 64, 64, 3)).astype(np.float32)
    key = jax.random.key(9)
    recon, _, mu, _ = jv.apply({"params": params}, x, key)
    eps = np.array(jax.random.normal(key, mu.shape))
    tv.load_state_dict(module_state_dict(params, transposed=VAE_TRANSPOSED), strict=True)
    got = tv(torch.from_numpy(x), torch.from_numpy(eps))[0]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(recon), atol=5e-5)
    # without the flip the transposed convolutions compute something else
    unflipped = module_state_dict(params)
    for i in range(5):
        unflipped[f"dec{i}.weight"] = torch.from_numpy(np.ascontiguousarray(
            np.asarray(params[f"dec{i}"]["kernel"]).transpose(2, 3, 0, 1)))
    tv.load_state_dict(unflipped, strict=True)
    bad = tv(torch.from_numpy(x), torch.from_numpy(eps))[0]
    assert np.abs(bad.detach().numpy() - np.asarray(recon)).max() > 1e-2


# the modules of the AL loop, its strategies, COCO, the native decoder, the
# trainer, data parallelism, the CIFAR demo, the drawing and the selection
# experiments, each of which must import on its own
AL_LOOP_MODULES = (
    "cli.config", "cli.driver", "cli.main", "cli.train", "convert.torchvision_import",
    "data.batching", "data.coco", "data.loader", "data.masks", "data.pool", "data.records",
    "data.synthetic", "data.transforms", "data.voc", "engine.checkpoint", "engine.coco_eval",
    "engine.evaluate", "engine.voc_eval", "models.init", "models.lossnet",
    "models.mobilenetv3", "models.retinanet", "models.vae", "native",
    "strategies.ll4al", "strategies.random_strategy", "strategies.ssm", "strategies.vaal",
    "parallel", "parallel.mesh", "cifar", "cifar.data", "cifar.driver", "cifar.resnet",
    "utils", "utils.viz", "experiments", "experiments.scoring_deviation",
    "experiments.consistency_separation", "experiments.selection_effectiveness",
    "experiments.selection_effectiveness_hard")


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
    # scoring, training, the fused backbone, the AL loop and its strategies,
    # RetinaNet and MobileNetV3
    assert len(loaded) >= 60
    assert {f"cald_tpu_torch.{m}" for m in AL_LOOP_MODULES} <= loaded


@pytest.mark.parametrize("script", ["precision_split"])
def test_card_scripts_import_no_jax_and_refuse_without_cuda(script):
    """The root script that runs the port's experiment on the card imports
    neither JAX nor the JAX package, and exit non-zero without a CUDA
    device unless told ``--device cpu``."""
    root = Path(__file__).resolve().parent.parent
    code = (f"import sys\nimport {script}\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', "
            "'cald_tpu')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(root / f"{script}.py")],
                         capture_output=True, text=True, timeout=120, cwd=root)
    assert out.returncode != 0 and "--device cpu" in out.stderr


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


def test_learnability_repeat_imports_no_jax_and_refuses_without_cuda():
    """learnability_repeat.py, run on the card, imports neither JAX nor the
    JAX package (with chip_smoke.py, which it drives), and without a CUDA
    device exits non-zero before any run."""
    root = Path(__file__).resolve().parent.parent
    code = ("import sys\n"
            "import learnability_repeat, chip_smoke\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'cald_tpu')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(root / "learnability_repeat.py"), "--runs", "1"],
                         capture_output=True, text=True, timeout=120, cwd=root)
    assert out.returncode != 0 and "runs passed" not in out.stdout
