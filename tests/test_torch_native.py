"""The port's native JPEG decoder (``cald_tpu_torch.native``,
``csrc/dataloader.cc``) and the loader's fused fast path, on the CPU.

The library is built with g++ into a temporary directory, never into the
shared ``cald_tpu_torch/build/``: the suite runs under several workers, and
a library there would switch every other test's JPEG loader to the native
path. Both packages' library paths are patched to that build inside each
test only. Without libjpeg's headers the tests that need the library skip
with that reason."""

import os
from pathlib import Path

import numpy as np
import pytest

import cald_tpu.native as jnative
from cald_tpu.data.batching import Canvas as JCanvas
from cald_tpu.data.batching import default_canvases as jdefault_canvases
from cald_tpu.data.loader import BatchLoader as JBatchLoader
from cald_tpu_torch import native
from cald_tpu_torch.data import loader as tloader
from cald_tpu_torch.data.batching import Canvas, default_canvases, resize_image
from cald_tpu_torch.data.coco import get_coco
from cald_tpu_torch.data.synthetic import make_coco
from cald_tpu_torch.data.voc import get_voc2007
from tests.fixtures import make_voc

REPO = Path(__file__).resolve().parent.parent
BATCH_FIELDS = ("images", "valid_hw", "scale", "boxes", "labels", "box_valid", "image_idx")


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The decoder built into a temporary directory."""
    out = tmp_path_factory.mktemp("native") / "libcald_data.so"
    try:
        return native.build(out)
    except RuntimeError as e:
        if "jpeglib.h" in str(e) or "-ljpeg" in str(e):
            pytest.skip(f"libjpeg's headers or library are missing: {e}")
        raise


@pytest.fixture
def lib(built, monkeypatch):
    """Both packages' decoders pointed at the temporary build."""
    monkeypatch.setattr(native, "library_path", lambda: built)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(jnative, "_LIB_PATH", str(built))
    monkeypatch.setattr(jnative, "_lib", None)
    assert native.available() and jnative.available()
    return built


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    return make_voc(tmp_path_factory.mktemp("voc_native"), num_images=4,
                    size_range=((50, 90), (50, 90)))


def test_source_is_the_jax_packages_copy():
    assert (REPO / "cald_tpu_torch/csrc/dataloader.cc").read_bytes() == (
        REPO / "native/dataloader.cc").read_bytes()
    assert native.SOURCE == REPO / "cald_tpu_torch/csrc/dataloader.cc"


def test_build_is_keyed_by_the_source_and_reused(built):
    """The default library's name carries the source's hash; a build that
    exists is returned without compiling again."""
    import hashlib

    digest = hashlib.sha256(native.SOURCE.read_bytes()).hexdigest()[:16]
    assert native.library_path() == native.BUILD_DIR / f"libcald_data_{digest}.so"
    mtime = os.stat(built).st_mtime_ns
    assert native.build(built) == built and os.stat(built).st_mtime_ns == mtime
    assert not [p for p in built.parent.iterdir() if p != built]   # no temporary left


def test_failed_build_raises_with_the_compiler_message(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cc"
    bad.write_text("int main( {\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="building the JPEG decoder failed") as e:
        native.build(tmp_path / "out" / "lib.so")
    assert "bad.cc" in str(e.value)
    assert not (tmp_path / "out" / "lib.so").exists()
    assert not list((tmp_path / "out").iterdir())


def test_not_available_until_built(tmp_path, monkeypatch, voc_root):
    """No library: ``available()`` is False and JPEGs go through Pillow."""
    monkeypatch.setattr(native, "library_path", lambda: tmp_path / "missing.so")
    monkeypatch.setattr(native, "_lib", None)
    assert not native.available()
    ds = get_voc2007(voc_root, "trainval")
    from PIL import Image

    with Image.open(ds.record(0).image_path) as im:
        want = np.asarray(im.convert("RGB"), np.uint8)
    np.testing.assert_array_equal(tloader.decode_image(ds.record(0).image_path), want)


def test_decode_is_pillow_bit_for_bit(lib, voc_root):
    from PIL import Image

    ds = get_voc2007(voc_root, "trainval")
    for i in range(len(ds)):
        path = ds.record(i).image_path
        with Image.open(path) as im:
            want = np.asarray(im.convert("RGB"), np.uint8)
        got = native.decode(path)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tloader.decode_image(path), want)
        np.testing.assert_array_equal(got, jnative.decode(path))


def test_image_size_reads_the_header(lib, voc_root):
    ds = get_voc2007(voc_root, "trainval")
    for i in range(len(ds)):
        rec = ds.record(i)
        assert native.image_size(rec.image_path) == (rec.width, rec.height)
    with pytest.raises(IOError, match="cald_image_size failed"):
        native.image_size(str(Path(voc_root) / "missing.jpg"))


def test_decode_resize_into_close_to_the_pillow_resize(lib, voc_root):
    """The C++ bilinear resize against Pillow's (another filter support):
    mean |diff| < 2.0, as tests/test_native.py allows; the canvas beyond
    the image stays 0; a canvas it does not fit is an error."""
    rec = get_voc2007(voc_root, "trainval").record(2)
    scale = 1.3
    rh, rw = int(round(rec.height * scale)), int(round(rec.width * scale))
    want = resize_image(native.decode(rec.image_path), rh, rw)
    canvas = np.zeros((rh + 8, rw + 8, 3), np.float32)
    assert native.decode_resize_into(rec.image_path, canvas, scale) == (rh, rw)
    assert float(np.abs(canvas[:rh, :rw] - want).mean()) < 2.0
    assert canvas[rh:].sum() == 0 and canvas[:, rw:].sum() == 0
    with pytest.raises(IOError, match="cald_decode_resize failed"):
        native.decode_resize_into(rec.image_path, np.zeros((8, 8, 3), np.float32), scale)
    with pytest.raises(ValueError, match="float32"):
        native.decode_resize_into(rec.image_path, np.zeros((8, 8, 3), np.float64), scale)


@pytest.fixture(scope="module")
def coco_jpg(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco_native")
    make_coco(root, num_images=6, hw=[(60, 80), (80, 60), (70, 70)], num_classes=3, seed=4)
    return get_coco(str(root), "train")


@pytest.mark.parametrize("canvases", ["default", "square"])
def test_fast_path_matches_the_jax_fast_path(lib, coco_jpg, monkeypatch, canvases):
    """Batches without a transform: the port's fused path equals the JAX
    package's fused path field for field (one library, the same arithmetic),
    and both are within mean |diff| < 2.0 of the port's Pillow path, with
    equal sizes, scales and boxes."""
    canv = {"default": (default_canvases(96, 128), jdefault_canvases(96, 128)),
            "square": ((Canvas(128, 128),), (JCanvas(128, 128),))}[canvases]
    kw = dict(min_size=96, max_size=128, max_boxes=8, num_workers=2)
    batches = [[0, 1], [2, 3, 4], [5]]
    calls = []
    monkeypatch.setattr(native, "decode_resize_into",
                        lambda *a, f=native.decode_resize_into: calls.append(1) or f(*a))
    fast = list(tloader.BatchLoader(coco_jpg, batches, canvases=canv[0], **kw))
    assert len(calls) == 6
    jfast = list(JBatchLoader(coco_jpg, batches, canvases=canv[1], **kw))
    monkeypatch.setattr(native, "available", lambda: False)
    slow = list(tloader.BatchLoader(coco_jpg, batches, canvases=canv[0], **kw))
    assert len(calls) == 6
    for a, b, c in zip(fast, jfast, slow, strict=True):
        for f in BATCH_FIELDS:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
        np.testing.assert_array_equal(a.valid_hw, c.valid_hw)
        np.testing.assert_allclose(a.scale, c.scale, rtol=1e-6)
        np.testing.assert_allclose(a.boxes, c.boxes, rtol=1e-5)
        assert float(np.abs(a.images - c.images).mean()) < 2.0


def test_transform_or_other_formats_take_the_pillow_path(lib, coco_jpg, tmp_path):
    """A host transform, or a member that is not a JPEG, keeps the batch on
    the decode-then-resize path."""
    kw = dict(canvases=default_canvases(96, 128), min_size=96, max_size=128, max_boxes=8)
    loader = tloader.BatchLoader(coco_jpg, [[0]], transform=lambda im, bx, rng: (im, bx), **kw)
    assert loader._build_native([0], [coco_jpg.record(0)]) is None
    npy = tmp_path / "npy"
    make_coco(npy, num_images=2, hw=(60, 80), seed=4, image_format="npy")
    ds = get_coco(str(npy), "train")
    plain = tloader.BatchLoader(ds, [[0, 1]], **kw)
    assert plain._build_native([0, 1], [ds.record(0), ds.record(1)]) is None
    assert tloader.BatchLoader(coco_jpg, [[0]], **kw)._build_native(
        [0], [coco_jpg.record(0)]) is not None
