"""The native decoder's device route (``cald_tpu_torch/native/nvjpeg.py``,
``csrc/jpeg_decode.cu``) on the CPU: the resize kernel's plain version, the
loader's device route on CPU tensors, and what the route does where it
cannot run.

The card's half (nvJPEG against Pillow, the kernel against its plain
version) is in ``tests/test_torch_cuda.py``. Here the decoded pixels come
from the libjpeg library (``csrc/dataloader.cc``), built into a temporary
directory as ``tests/test_torch_native.py`` builds it, and both packages'
library paths point at that build inside each test only.

Tolerances: the plain resize and the loader's device route on the CPU are
held to the C++ fused path bit for bit (the same float32 operations in the
same order on the same pixels); sizes, scales, boxes and labels exactly.
"""

import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import cald_tpu.native as jnative
from cald_tpu.data.batching import default_canvases as jdefault_canvases
from cald_tpu.data.loader import BatchLoader as JBatchLoader
from cald_tpu_torch import native
from cald_tpu_torch.data import loader as tloader
from cald_tpu_torch.data.batching import Canvas, default_canvases, images_tensor
from cald_tpu_torch.data.coco import get_coco
from cald_tpu_torch.data.synthetic import make_coco, make_voc
from cald_tpu_torch.data.voc import get_voc2007
from cald_tpu_torch.native import nvjpeg
from cald_tpu_torch.ops import cuda_build

BATCH_FIELDS = ("images", "valid_hw", "scale", "boxes", "labels", "box_valid", "image_idx")


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    out = tmp_path_factory.mktemp("native_dev") / "libcald_data.so"
    try:
        return native.build(out)
    except RuntimeError as e:
        if "jpeglib.h" in str(e) or "-ljpeg" in str(e):
            pytest.skip(f"libjpeg's headers or library are missing: {e}")
        raise


@pytest.fixture
def lib(built, monkeypatch):
    monkeypatch.setattr(native, "library_path", lambda: built)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(jnative, "_LIB_PATH", str(built))
    monkeypatch.setattr(jnative, "_lib", None)
    assert native.available() and jnative.available()
    return built


def _jpeg(path: Path, h: int, w: int, seed: int, mode: str = "RGB", subsampling: int = 2):
    from PIL import Image

    rng = np.random.default_rng(seed)
    shape = (h, w, 3) if mode == "RGB" else (h, w)
    # smooth content plus noise, so the resize's taps differ from one another
    yy, xx = np.mgrid[:h, :w]
    base = (yy * 7 + xx * 3) % 256
    img = np.clip(base.reshape(h, w, *([1] if mode == "RGB" else []))
                  + rng.integers(-40, 40, shape), 0, 255).astype(np.uint8)
    Image.fromarray(img, mode).save(path, quality=90, subsampling=subsampling)
    return str(path)


# (h, w), scale, canvas margin: odd sizes, down- and upscales, scales whose
# first and last samples hit the clamps, 1-pixel sides, a canvas larger than
# the image
CASES = [((37, 51), 0.37, (0, 0)), ((37, 51), 2.7, (5, 9)), ((3, 97), 4.0, (0, 3)),
         ((120, 7), 0.5, (11, 0)), ((1, 1), 3.0, (2, 2)), ((2, 3), 1.0, (0, 0)),
         ((91, 64), 1.3, (40, 33)), ((64, 91), 0.1, (1, 1)), ((50, 50), 1.0, (7, 0))]


@pytest.mark.parametrize("hw, scale, margin", CASES)
def test_plain_resize_is_the_cpp_fused_path_bit_for_bit(lib, tmp_path, hw, scale, margin):
    """``resize_into_canvas_plain`` on the libjpeg-decoded pixels equals the
    JAX package's ``decode_resize_into`` (``native/dataloader.cc``), zeros
    beyond the image included."""
    path = _jpeg(tmp_path / "im.jpg", *hw, seed=hw[0] * 100 + hw[1])
    rh, rw = nvjpeg.output_size(*hw, scale)
    ch, cw = rh + margin[0], rw + margin[1]
    want = np.full((ch, cw, 3), 0, np.float32)
    assert jnative.decode_resize_into(path, want, scale) == (rh, rw)
    pixels = torch.from_numpy(native.decode(path).reshape(-1))
    meta = torch.tensor([[0, hw[0], hw[1], 3, rh, rw]], dtype=torch.int64)
    canvas = torch.full((1, ch, cw, 3), -1.0)
    got = nvjpeg.resize_into_canvas(pixels, meta, canvas)
    assert got is canvas
    np.testing.assert_array_equal(canvas[0].numpy().view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("hw, scale", [((37, 51), 0.63), ((20, 33), 1.9)])
def test_plain_resize_of_a_grayscale_image_repeats_its_luma(lib, tmp_path, hw, scale):
    """A grayscale JPEG: nvJPEG hands the kernel its luma (one channel);
    libjpeg decodes it to RGB by repeating the luma. Both canvases agree bit
    for bit."""
    from PIL import Image

    path = _jpeg(tmp_path / "gray.jpg", *hw, seed=5, mode="L")
    with Image.open(path) as im:
        luma = np.array(im, np.uint8)
    rh, rw = nvjpeg.output_size(*hw, scale)
    want = np.zeros((rh + 2, rw + 1, 3), np.float32)
    jnative.decode_resize_into(path, want, scale)
    meta = torch.tensor([[0, hw[0], hw[1], 1, rh, rw]], dtype=torch.int64)
    canvas = nvjpeg.resize_into_canvas(torch.from_numpy(luma.reshape(-1)), meta,
                                       torch.empty((1, rh + 2, rw + 1, 3)))
    np.testing.assert_array_equal(canvas[0].numpy().view(np.uint32), want.view(np.uint32))


def test_plain_resize_takes_a_batch_at_offsets(lib, tmp_path):
    """Several images laid one after another at aligned offsets in one
    buffer, each into its own slot of the canvas."""
    shapes = [(30, 41), (17, 9), (41, 30)]
    paths = [_jpeg(tmp_path / f"{i}.jpg", *hw, seed=i) for i, hw in enumerate(shapes)]
    scales = [0.9, 2.2, 0.45]
    canvas_hw = (64, 64)
    meta, total = nvjpeg.batch_meta([(*hw, 3) for hw in shapes], scales, canvas_hw, paths,
                                    align=256)
    assert (meta[:, 0] % 256 == 0).all() and total >= meta[-1, 0] + 41 * 30 * 3
    pixels = np.zeros(total, np.uint8)
    for p, o in zip(paths, meta[:, 0]):
        im = native.decode(p).reshape(-1)
        pixels[o:o + im.size] = im
    canvas = nvjpeg.resize_into_canvas(torch.from_numpy(pixels), torch.from_numpy(meta),
                                       torch.empty((3, *canvas_hw, 3)))
    for i, (p, s) in enumerate(zip(paths, scales)):
        want = np.zeros((*canvas_hw, 3), np.float32)
        assert jnative.decode_resize_into(p, want, s) == tuple(meta[i, 4:6])
        np.testing.assert_array_equal(canvas[i].numpy(), want)


def test_batch_meta_refuses_an_image_the_canvas_does_not_hold(tmp_path):
    with pytest.raises(IOError, match="does not fit"):
        nvjpeg.batch_meta([(40, 50, 3)], [1.0], (40, 49), ["a.jpg"])
    meta, _ = nvjpeg.batch_meta([(40, 50, 3)], [1.0], (40, 50), ["a.jpg"])
    assert meta[0].tolist() == [0, 40, 50, 3, 40, 50]


def test_kernel_wrapper_checks_its_arguments():
    pixels = torch.zeros(12, dtype=torch.uint8)
    canvas = torch.zeros((1, 4, 4, 3))
    ok = torch.tensor([[0, 2, 2, 3, 4, 4]])
    with pytest.raises(ValueError, match="canvas"):
        nvjpeg.resize_into_canvas(pixels, ok, torch.zeros((1, 4, 4, 3), dtype=torch.float64))
    with pytest.raises(ValueError, match="pixels"):
        nvjpeg.resize_into_canvas(pixels.float(), ok, canvas)
    with pytest.raises(ValueError, match="meta must be"):
        nvjpeg.resize_into_canvas(pixels, ok.int(), canvas)
    for bad in ([0, 2, 3, 3, 4, 4], [0, 2, 2, 2, 4, 4], [0, 2, 2, 3, 5, 4], [1, 2, 2, 3, 4, 4]):
        with pytest.raises(ValueError, match="out of range"):
            nvjpeg.resize_into_canvas(pixels, torch.tensor([bad]), canvas)
    assert nvjpeg.resize_into_canvas.launches == 0      # the plain version launches nothing


@pytest.fixture(scope="module")
def coco_jpg(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco_dev")
    make_coco(root, num_images=7, hw=[(60, 80), (80, 60), (70, 70), (37, 91)], num_classes=3,
              seed=6)
    return get_coco(str(root), "train")


@pytest.mark.parametrize("canvases", ["default", "square"])
def test_loader_device_route_on_the_cpu_is_the_libjpeg_fused_path(lib, coco_jpg, canvases):
    """``_build_device`` with a CPU device (libjpeg's pixels, the plain
    resize) gives the batches of the libjpeg fused path, and of the JAX
    package's: images bit for bit, every other field exactly."""
    canv = {"default": (default_canvases(96, 128), jdefault_canvases(96, 128)),
            "square": ((Canvas(128, 128),), None)}[canvases]
    kw = dict(min_size=96, max_size=128, max_boxes=8, num_workers=2)
    batches = [[0, 1], [2, 3, 4], [5, 6]]
    loader = tloader.BatchLoader(coco_jpg, batches, canvases=canv[0], device="cpu", **kw)
    fused = list(loader)
    for n, idxs in enumerate(batches):
        records = [coco_jpg.record(i) for i in idxs]
        dev = loader._build_device(idxs, records)
        assert isinstance(dev.images, torch.Tensor) and dev.images.dtype == torch.float32
        for f in BATCH_FIELDS:
            got = getattr(dev, f)
            got = got.numpy() if isinstance(got, torch.Tensor) else got
            want = getattr(fused[n], f)
            assert got.dtype == want.dtype and got.shape == want.shape, f
            np.testing.assert_array_equal(got, want, err_msg=f)
    if canv[1] is not None:
        jfused = list(JBatchLoader(coco_jpg, batches, canvases=canv[1], **kw))
        for a, b in zip(fused, jfused, strict=True):
            for f in BATCH_FIELDS:
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def test_device_route_needs_the_libjpeg_library_on_the_cpu(tmp_path, monkeypatch, coco_jpg):
    monkeypatch.setattr(native, "library_path", lambda: tmp_path / "missing.so")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="build"):
        native.decode_resize_batch([coco_jpg.record(0).image_path], [1.0], (96, 128), "cpu")


def test_images_tensor_takes_arrays_and_tensors():
    a = np.arange(24, dtype=np.float64).reshape(1, 2, 4, 3)
    t = images_tensor(a, "cpu")
    assert t.dtype == torch.float32 and np.array_equal(t.numpy(), a)
    c = torch.arange(24, dtype=torch.float32).reshape(1, 2, 4, 3)
    assert images_tensor(c, "cpu") is c


def _no_pillow(monkeypatch) -> list:
    from PIL import Image

    opened = []
    real = Image.open
    monkeypatch.setattr(Image, "open", lambda *a, **k: opened.append(a) or real(*a, **k))
    return opened


def test_cuda_loader_without_cuda_raises_before_any_decode(monkeypatch, coco_jpg):
    """A CUDA loader on a machine without CUDA raises at construction: no
    batch is decoded, by Pillow or otherwise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opened = _no_pillow(monkeypatch)
    for dev in ("cuda", "cuda:0", torch.device("cuda")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tloader.BatchLoader(coco_jpg, [[0, 1]], canvases=default_canvases(96, 128),
                                min_size=96, max_size=128, max_boxes=8, device=dev)
    assert opened == []


def _fake_nvcc(tmp_path, monkeypatch, rc: int = 1) -> Path:
    """A stand-in ``nvcc`` under a fake CUDA_HOME that prints its arguments
    and a compiler error and exits ``rc``; the build directory moved to
    ``tmp_path``."""
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text("#!/bin/sh\necho \"nvcc args: $*\" >&2\n"
                    "echo 'jpeg_decode.cu(1): error: identifier \"nvjpegDecode\" is undefined' >&2\n"
                    f"exit {rc}\n")
    nvcc.chmod(0o755)
    import torch.utils.cpp_extension as cpp

    monkeypatch.setattr(cpp, "CUDA_HOME", str(home))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    return home


def test_failed_build_raises_with_the_compiler_message(tmp_path, monkeypatch):
    """A failed ``jpeg_decode.cu`` build raises ``RuntimeError`` with nvcc's
    own output; the build links nvJPEG with the toolkit's run path and
    leaves no library behind."""
    home = _fake_nvcc(tmp_path, monkeypatch)
    for entry in (nvjpeg.NvJpeg(), nvjpeg.ResizeIntoCanvasKernel()):
        with pytest.raises(RuntimeError, match="building jpeg_decode.cu failed") as e:
            entry.load()
        msg = str(e.value)
        assert 'identifier "nvjpegDecode" is undefined' in msg
        assert "-lnvjpeg" in msg and f"-L{home}/lib64" in msg and "sm_90a" in msg
    assert not list((tmp_path / "build").iterdir())


def test_cuda_loader_raises_on_a_failed_build_and_never_reaches_pillow(tmp_path, monkeypatch,
                                                                       coco_jpg):
    """On a CUDA device a batch without a transform goes to the device
    route; when its library does not build, the loader raises the build's
    error instead of decoding with Pillow."""
    _fake_nvcc(tmp_path, monkeypatch)
    monkeypatch.setattr(nvjpeg, "nvjpeg", nvjpeg.NvJpeg())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    opened = _no_pillow(monkeypatch)
    for workers in (0, 2):
        loader = tloader.BatchLoader(coco_jpg, [[0, 1], [2]], canvases=default_canvases(96, 128),
                                     min_size=96, max_size=128, max_boxes=8, device="cuda",
                                     num_workers=workers)
        assert loader.device == torch.device("cuda", 0)
        with pytest.raises(RuntimeError, match="building jpeg_decode.cu failed"):
            list(loader)
    assert opened == []


class _FakeNvJpegLib:
    """The library's two nvJPEG entry points as a stand-in: the header probe
    rejects data that does not start with a JPEG marker, as nvJPEG does."""

    def cald_jpeg_info(self, data, n, w, h, c):
        return nvjpeg.REJECTED if data[:2] != b"\xff\xd8" else 0

    def cald_jpeg_decode(self, *args):
        raise AssertionError("a rejected file is never decoded")


def test_rejected_counts_a_corrupt_file_and_pillow_takes_it(tmp_path, monkeypatch):
    """A file the device route rejects raises ``IOError`` from
    ``native.decode``, is counted in ``native.rejected`` once, and goes to
    Pillow in ``decode_image``, which raises on a corrupt file as the JAX
    loader's does."""
    from PIL import UnidentifiedImageError

    fake = nvjpeg.NvJpeg()
    fake._lib = _FakeNvJpegLib()
    monkeypatch.setattr(nvjpeg, "nvjpeg", fake)
    monkeypatch.setattr(native, "rejected", 0)
    bad = tmp_path / "corrupt.jpg"
    bad.write_bytes(b"not a jpeg at all" * 10)
    with pytest.raises(nvjpeg.JpegRejected, match="rejected"):
        native.decode(str(bad), "cuda:0")
    assert native.rejected == 1
    opened = _no_pillow(monkeypatch)
    with pytest.raises(UnidentifiedImageError):
        tloader.decode_image(str(bad), torch.device("cuda", 0))
    assert native.rejected == 2 and len(opened) == 1
    with pytest.raises(nvjpeg.JpegRejected):
        native.image_size(str(bad), "cuda:0")
    assert native.rejected == 2            # only decodes that go to Pillow count


def test_rejected_count_loses_nothing_across_threads(tmp_path, monkeypatch):
    """``native.rejected`` is incremented under a lock from the loader's
    threads."""
    import sys

    fake = nvjpeg.NvJpeg()
    fake._lib = _FakeNvJpegLib()
    monkeypatch.setattr(nvjpeg, "nvjpeg", fake)
    monkeypatch.setattr(native, "rejected", 0)
    bad = tmp_path / "corrupt.jpg"
    bad.write_bytes(b"\x00" * 64)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work():
        for _ in range(50):
            with pytest.raises(IOError):
                native.decode(str(bad), "cuda:0")
    try:
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert native.rejected == 400


def test_cpu_loader_is_unchanged(lib, monkeypatch, tmp_path):
    """Without a device, or with a CPU one, the loader takes the libjpeg
    fused path as before (never the device route)."""
    root = make_voc(tmp_path / "voc", num_images=3, size_range=((50, 70), (50, 70)))
    ds = get_voc2007(root, "trainval")
    monkeypatch.setattr(tloader.BatchLoader, "_build_device",
                        lambda *a: pytest.fail("the device route on a CPU loader"))
    kw = dict(canvases=default_canvases(96, 128), min_size=96, max_size=128, max_boxes=4,
              num_workers=0)
    for dev in (None, "cpu"):
        (batch,) = tloader.BatchLoader(ds, [[0, 1, 2]], device=dev, **kw)
        assert isinstance(batch.images, np.ndarray)


def test_loader_keeps_a_bounded_number_of_batches_in_flight(monkeypatch):
    """The producer submits at most ``num_workers + prefetch`` batches
    beyond its queue, so a slow consumer never has the whole epoch decoded
    ahead of it (a device-route batch holds its canvas on the card); the
    order stays the batches' own."""
    import time

    built, consumed, ahead = [], [0], []
    lock = threading.Lock()

    def build(self, n, idxs):
        with lock:
            built.append(n)
            ahead.append(len(built) - consumed[0])
        return n

    monkeypatch.setattr(tloader.BatchLoader, "_build", build)
    loader = tloader.BatchLoader(None, [[i] for i in range(60)], canvases=(Canvas(8, 8),),
                                 min_size=8, max_size=8, max_boxes=1, num_workers=3,
                                 prefetch=2)
    got = []
    for n in loader:
        time.sleep(0.002)
        got.append(n)
        with lock:
            consumed[0] += 1
    assert got == list(range(60))
    assert max(ahead) <= 3 + 2 + 2 + 1, max(ahead)
