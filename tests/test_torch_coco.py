"""The port's COCO slice (``data/coco.py``, ``data/masks.py``,
``data/transforms.py``'s target flip and normalizer, ``make_coco``,
``engine/coco_eval.py``, ``evaluate(kind="coco")`` and the COCO branch of
``cli.driver``) held against the JAX package on the same inputs on the CPU:
records, masks and keypoints exactly, the 12 COCO stats to 1e-12 (and
against tests/coco_naive_oracle.py and the committed fixtures), the 81-class
postprocess past its candidate cap, evaluation of the tiny detector with
bridged weights, and the port's ``al_loop`` on a tiny COCO tree."""

import hashlib
import json

import jax
import numpy as np
import pytest
import torch

from cald_tpu import native
from cald_tpu.data import masks as jmasks
from cald_tpu.data import transforms as jtransforms
from cald_tpu.data.batching import default_canvases as jdefault_canvases
from cald_tpu.data.coco import get_coco as jget_coco
from cald_tpu.data.loader import BatchLoader as JBatchLoader
from cald_tpu.data.pool import ALPoolState as JPool
from cald_tpu.data.synthetic import make_coco as jmake_coco
from cald_tpu.engine.coco_eval import coco_evaluate_detections as jcoco_eval
from cald_tpu.engine.evaluate import evaluate as jevaluate
from cald_tpu.engine.evaluate import run_inference as jrun_inference
from cald_tpu.models.roi_heads import postprocess_detections as jpostprocess
from cald_tpu.strategies.random_strategy import random_select as jrandom_select
from cald_tpu_torch import native as tnative
from cald_tpu_torch.cli import config, driver
from cald_tpu_torch.data import masks, transforms
from cald_tpu_torch.data.batching import default_canvases
from cald_tpu_torch.data.coco import COCO_CLASSES, CocoDataset, get_coco
from cald_tpu_torch.data.loader import BatchLoader
from cald_tpu_torch.data.synthetic import make_coco
from cald_tpu_torch.engine.coco_eval import coco_evaluate_detections
from cald_tpu_torch.engine.evaluate import evaluate, run_inference
from cald_tpu_torch.models.roi_heads import postprocess_detections
from tests.coco_naive_oracle import naive_coco_stats
from tests.test_coco_crosscheck import FIXTURE_PATH, SEEDS, _random_scene
from tests.test_masks import encode_compressed_rle
from tests.torch_helpers import tiny_models, to_np

QUIET = lambda *_: None  # noqa: E731
RECORD_FIELDS = ("boxes", "labels", "difficult", "area", "iscrowd")


@pytest.fixture
def pil_decode(monkeypatch):
    """Both loaders decode JPEGs with Pillow (their native decoders, where
    built, are another codec)."""
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)


def _hand_tree(root):
    """A hand-written instances json over 4 images (sparse image and
    category ids): a crowd annotation with a compressed RLE, a degenerate
    box, boxes crossing and lying outside the image, an uncompressed RLE,
    person keypoints, a missing ``area``, an image with only a crowd, an
    image with nothing, and an annotation of an unknown image."""
    rle = encode_compressed_rle([5, 10, 585]).decode()
    kps = np.zeros((17, 3))
    kps[1] = [4, 5, 2]
    kps[6] = [9, 12, 1]
    anns = [
        dict(id=1, image_id=7, category_id=5, bbox=[2.0, 3.0, 10.0, 8.0], area=80.0,
             iscrowd=0, segmentation=[[2, 3, 12, 3, 12, 11, 2, 11]],
             keypoints=kps.reshape(-1).tolist()),
        dict(id=2, image_id=7, category_id=90, bbox=[-4.0, 5.0, 10.0, 30.0], area=300.0,
             iscrowd=0, segmentation={"counts": [30, 20, 550], "size": [20, 30]}),
        dict(id=3, image_id=7, category_id=1, bbox=[5.0, 5.0, 0.0, 4.0], area=0.0,
             iscrowd=0, segmentation=[]),
        dict(id=4, image_id=7, category_id=1, bbox=[1.0, 1.0, 6.0, 6.0], area=36.0,
             iscrowd=1, segmentation={"counts": rle, "size": [20, 30]}),
        dict(id=5, image_id=7, category_id=1, bbox=[40.0, 2.0, 5.0, 5.0], area=25.0,
             iscrowd=0, segmentation=[]),
        dict(id=6, image_id=3, category_id=1, bbox=[20.0, 10.0, 15.0, 20.0], iscrowd=0,
             segmentation=[[20, 10, 35, 10, 27, 30]]),
        dict(id=7, image_id=42, category_id=5, bbox=[0.0, 0.0, 4.0, 4.0], area=16.0,
             iscrowd=1, segmentation={"counts": [0, 16, 1184], "size": [40, 30]}),
        dict(id=8, image_id=999, category_id=5, bbox=[0.0, 0.0, 4.0, 4.0], area=16.0,
             iscrowd=0),
    ]
    data = {"images": [dict(id=7, file_name="a.jpg", width=30, height=20),
                       dict(id=3, file_name="b.jpg", width=36, height=32),
                       dict(id=42, file_name="c.jpg", width=30, height=40),
                       dict(id=100, file_name="d.jpg", width=16, height=16)],
            "annotations": anns,
            "categories": [dict(id=90, name="toothbrush"), dict(id=1, name="person"),
                           dict(id=5, name="airplane")]}
    (root / "annotations").mkdir(parents=True)
    for split in ("train2017", "val2017"):
        (root / "annotations" / f"instances_{split}.json").write_text(json.dumps(data))
    return str(root)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("coco")
    synth = base / "synth"
    for split, n, seed in (("train", 6, 1), ("val", 4, 2)):
        jmake_coco(synth, num_images=n, hw=(50, 60), num_classes=3, seed=seed, split=split)
    return {"hand": _hand_tree(base / "hand"), "synthetic": str(synth)}


@pytest.mark.parametrize("tree", ["hand", "synthetic"])
@pytest.mark.parametrize("split", ["train", "val"])
def test_dataset_matches_jax(trees, tree, split):
    """Index, ids (train drops images without a usable box), class names,
    records, masks, keypoints and aspect ratios equal the JAX package's."""
    got, want = get_coco(trees[tree], split), jget_coco(trees[tree], split)
    assert got.ids == want.ids and len(got) == len(want) > 0
    assert got.class_names == want.class_names and got.num_classes == want.num_classes
    assert got.index.label_to_cat == want.index.label_to_cat
    assert got.index.cat_to_label == want.index.cat_to_label
    np.testing.assert_array_equal(got.aspect_ratios(), want.aspect_ratios())
    for i in range(len(got)):
        a, b = got.record(i), want.record(i)
        assert (a.image_id, a.image_path, a.width, a.height) == (
            b.image_id, b.image_path, b.width, b.height)
        for f in RECORD_FIELDS:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
            assert getattr(a, f).dtype == getattr(b, f).dtype, f
        np.testing.assert_array_equal(got.masks_for(i), want.masks_for(i))
        np.testing.assert_array_equal(got.keypoints_for(i), want.keypoints_for(i))
        assert got.masks_for(i).shape[0] == len(a.boxes) == got.keypoints_for(i).shape[0]
    if tree == "hand":
        # the crowd-only image 42 is dropped for training, the empty 100 too
        assert got.ids == ([3, 7] if split == "train" else [3, 7, 42, 100])
        assert got.class_names == ("__background__", "person", "airplane", "toothbrush")


def test_make_coco_matches_jax(tmp_path):
    """The same seed writes the JAX generator's json and JPEGs byte for byte;
    ``image_format="npy"`` the pixels before encoding, under ``.npy`` names;
    a sequence of sizes is taken image by image."""
    jmake_coco(tmp_path / "jax", num_images=3, seed=5)
    make_coco(tmp_path / "jpg", num_images=3, seed=5)
    make_coco(tmp_path / "npy", num_images=3, seed=5, image_format="npy")
    ann = "annotations/instances_train2017.json"
    want = (tmp_path / "jax" / ann).read_text()
    assert (tmp_path / "jpg" / ann).read_text() == want
    assert (tmp_path / "npy" / ann).read_text() == want.replace(".jpg", ".npy")
    for n in range(3):
        name = f"train2017/img{n:04d}"
        assert (tmp_path / "jpg" / f"{name}.jpg").read_bytes() == (
            tmp_path / "jax" / f"{name}.jpg").read_bytes()
        assert np.load(tmp_path / "npy" / f"{name}.npy").shape == (50, 60, 3)
    make_coco(tmp_path / "mixed", num_images=4, hw=[(30, 40), (40, 30)], num_classes=80,
              image_format="npy", max_objects=8, box_size=(5.0, 20.0))
    ds = get_coco(str(tmp_path / "mixed"), "train")
    assert [(r.height, r.width) for r in map(ds.record, range(4))] == [(30, 40), (40, 30)] * 2
    assert len(ds.class_names) == 81 == len(COCO_CLASSES)
    with pytest.raises(ValueError, match="image_format"):
        make_coco(tmp_path / "bad", image_format="png")


def _rle_roundtrip(m):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(5):
        h, w = int(rng.integers(3, 20)), int(rng.integers(3, 20))
        runs, left = [], h * w
        while left:
            runs.append(int(rng.integers(1, left + 1)))
            left -= runs[-1]
        out.append(m.decode_compressed_rle(encode_compressed_rle(runs), h, w))
    return out


# tests/test_masks.py's cases, each run through both packages
MASK_CASES = {
    "counts": lambda m: m.decode_rle_counts([1, 2, 3], 2, 3),
    "compressed": _rle_roundtrip,
    "compressed-str": lambda m: m.segmentation_to_mask(
        {"counts": encode_compressed_rle([3, 4, 5]).decode(), "size": [3, 4]}, 3, 4),
    "uncompressed": lambda m: m.segmentation_to_mask({"counts": [2, 2, 8], "size": [3, 4]}, 3, 4),
    "rectangle": lambda m: m.rasterize_polygon([2, 1, 6, 1, 6, 4, 2, 4], 6, 8),
    "triangle": lambda m: m.rasterize_polygon([0, 0, 100, 0, 0, 100], 100, 100),
    "slanted": lambda m: m.rasterize_polygon([3.3, 1.7, 17.9, 6.2, 9.1, 14.8, 1.2, 9.5], 16, 20),
    "union": lambda m: m.segmentation_to_mask(
        [[0, 0, 3, 0, 3, 3, 0, 3], [5, 5, 8, 5, 8, 8, 5, 8]], 10, 10),
    "stack": lambda m: m.convert_coco_poly_to_mask(
        [[[0, 0, 2, 0, 2, 2, 0, 2]], [[1, 1, 3, 1, 3, 3, 1, 3]]], 4, 4),
    "empty": lambda m: m.convert_coco_poly_to_mask([], 4, 4),
    "degenerate": lambda m: m.rasterize_polygon([1, 1, 2, 2], 4, 4),
}


@pytest.mark.parametrize("case", list(MASK_CASES))
def test_masks_match_jax(case):
    got, want = (MASK_CASES[case](m) for m in (masks, jmasks))
    if case != "compressed":
        got, want = [got], [want]
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_masks_reject_bad_runs_like_jax():
    for m in (masks, jmasks):
        with pytest.raises(ValueError, match="RLE runs sum to 3"):
            m.decode_rle_counts([1, 2], 2, 3)


def test_transforms_match_jax(rng):
    """The keypoint flip, the dict-target flip (drawing the same coin flips
    from the same generator) and the normalizer, on NumPy and on a tensor."""
    kps = rng.uniform(0, 50, (3, 17, 3)).astype(np.float32)
    kps[..., 2] = rng.integers(0, 3, (3, 17))
    np.testing.assert_array_equal(transforms.flip_coco_person_keypoints(kps, 64),
                                  jtransforms.flip_coco_person_keypoints(kps, 64))
    img = rng.uniform(0, 255, (6, 9, 3)).astype(np.float32)
    target = {"boxes": np.asarray([[0, 0, 4, 5], [2, 1, 9, 6]], np.float32),
              "masks": rng.integers(0, 2, (2, 6, 9)).astype(np.uint8), "keypoints": kps[:2]}
    g1, g2 = np.random.default_rng(3), np.random.default_rng(3)
    for p in (0.5, 0.5, 0.5, 1.0, 0.0):
        a_img, a = transforms.random_horizontal_flip_target(img, target, g1, p=p)
        b_img, b = jtransforms.random_horizontal_flip_target(img, target, g2, p=p)
        np.testing.assert_array_equal(a_img, b_img)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    want = jtransforms.normalize_image(img)
    np.testing.assert_allclose(transforms.normalize_image(img), want, rtol=0, atol=1e-6)
    got = transforms.normalize_image(torch.from_numpy(img), torch.from_numpy(
        transforms.IMAGENET_MEAN), torch.from_numpy(transforms.IMAGENET_STD))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(transforms.IMAGENET_MEAN, jtransforms.IMAGENET_MEAN)
    np.testing.assert_array_equal(transforms.IMAGENET_STD, jtransforms.IMAGENET_STD)


def _eval_both(dataset, results, classwise=True):
    lines = {"got": [], "want": []}
    got = coco_evaluate_detections(results, dataset, classwise=classwise,
                                   print_fn=lines["got"].append)
    want = jcoco_eval(results, dataset, classwise=classwise, print_fn=lines["want"].append)
    return got, want, lines


@pytest.mark.parametrize("seed", SEEDS)
def test_coco_eval_matches_jax_oracle_and_fixtures(seed):
    """tests/test_coco_crosscheck.py's randomized scenes (crowds, area-range
    boundaries, duplicates, empty images): the 12 stats equal the JAX
    evaluator's, the naive oracle's and the committed fixture's to 1e-12;
    the printed summary and the classwise lines are the JAX evaluator's."""
    dataset, results = _random_scene(np.random.default_rng(seed))
    got, want, lines = _eval_both(dataset, results)
    naive = naive_coco_stats(dataset, results)
    with open(FIXTURE_PATH) as f:
        fixture = json.load(f)[str(seed)]
    assert set(fixture) == set(naive) == set(got) - {"per_class_ap"}
    for k in fixture:
        for other in (want[k], naive[k], fixture[k]):
            assert abs(got[k] - other) <= 1e-12, (k, got[k], other)
    np.testing.assert_array_equal(list(got["per_class_ap"].values()),
                                  list(want["per_class_ap"].values()))
    assert lines["got"] == lines["want"] and len(lines["got"]) == 12 + 1 + 2


@pytest.mark.parametrize("seed", [10, 11, 12])
def test_coco_eval_matches_jax_at_81_classes(seed):
    """Scenes over COCO's 81 classes with more images: every stat and line
    equal to the JAX evaluator's (classwise off and on)."""
    dataset, results = _random_scene(np.random.default_rng(seed), num_images=10,
                                     num_classes=81, max_gt=12, max_det=40)
    for classwise in (False, True):
        got, want, lines = _eval_both(dataset, results, classwise)
        assert lines["got"] == lines["want"]
        for k, v in want.items():
            if k != "per_class_ap":
                assert abs(got[k] - v) <= 1e-12, (k, got[k], v)


def test_postprocess_81_classes_past_the_candidate_cap(rng):
    """The 81-class postprocess with ~16 classes of every proposal above
    0.05: far more candidates than ``nms_pre_size`` (2048), so the cap's
    choice shows; slot for slot as JAX's (labels and validity exact)."""
    b, n, c = 2, 1000, 81
    logits = rng.normal(0, 0.3, (b, n, c)).astype(np.float32)
    for i in range(b):
        for j in range(n):
            logits[i, j, 1 + rng.choice(c - 1, 16, replace=False)] += rng.uniform(3.8, 4.4)
    xy = rng.uniform(0, 300, (b, n, 2))
    wh = rng.uniform(8, 120, (b, n, 2))
    props = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    regs = rng.normal(0, 0.2, (b, n, 4 * c)).astype(np.float32)
    valid = rng.uniform(size=(b, n)) > 0.1
    hw = np.array([[400, 400], [320, 380]], np.int32)
    scores = torch.softmax(torch.from_numpy(logits), -1)[..., 1:].numpy()
    assert ((scores > 0.05) & valid[..., None]).sum(axis=(1, 2)).min() > 4 * 2048
    want = jax.jit(jax.vmap(lambda *a: jpostprocess(*a)))(logits, regs, props, valid, hw)
    T = torch.from_numpy
    got = postprocess_detections(T(logits), T(regs), T(props), T(valid), T(hw))
    assert int(np.asarray(want.valid).sum()) == 2 * 100
    for field in ("valid", "labels"):
        np.testing.assert_array_equal(to_np(getattr(got, field)), np.asarray(getattr(want, field)))
    for field, atol in (("boxes", 1e-3), ("scores", 1e-6), ("scores_cls", 1e-6),
                        ("prob_max", 1e-6)):
        np.testing.assert_allclose(to_np(getattr(got, field)), np.asarray(getattr(want, field)),
                                   atol=atol, rtol=0, err_msg=field)


@pytest.fixture(scope="module")
def jpg_tree(tmp_path_factory):
    """A 3-category COCO tree of JPEGs (the JAX generator's) with 96x128 images."""
    root = tmp_path_factory.mktemp("coco_jpg")
    for split, n, seed in (("train", 4, 1), ("val", 6, 2)):
        jmake_coco(root, num_images=n, hw=(96, 128), num_classes=3, seed=seed, split=split)
    return str(root)


def test_evaluate_coco_matches_jax(jpg_tree, pil_decode):
    """``evaluate(kind="coco")`` of the tiny detector with bridged weights
    against the JAX package's: detections at tests/test_golden_parity.py's
    tolerances, then the 12 stats at test_torch_al_loop.py's VOC tolerance."""
    jmodel, variables, tmodel = tiny_models()
    ds = get_coco(jpg_tree, "val")
    batches = [[0, 1, 2], [3, 4, 5]]
    args = dict(min_size=96, max_size=128, max_boxes=8, num_workers=0)
    loader = lambda: BatchLoader(ds, batches, canvases=default_canvases(96, 128), **args)  # noqa: E731
    jloader = lambda: JBatchLoader(ds, batches, canvases=jdefault_canvases(96, 128), **args)  # noqa: E731
    got = run_inference(tmodel, loader(), device="cpu")
    want = jrun_inference(jmodel, variables, jloader())
    assert [r["dataset_index"] for r in got] == [r["dataset_index"] for r in want]
    assert sum(len(r["scores"]) for r in got) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["labels"], np.asarray(b["labels"]))
        np.testing.assert_allclose(a["scores"], b["scores"], atol=1e-3)
        np.testing.assert_allclose(a["boxes"], b["boxes"], atol=1e-2)
    m_got = evaluate(tmodel, loader(), ds, kind="coco", device="cpu", classwise=True,
                     print_fn=QUIET)
    m_want = jevaluate(jmodel, variables, jloader(), ds, kind="coco", classwise=True,
                       print_fn=QUIET)
    assert set(m_got) == set(m_want) and len(m_got) == 13
    for k, v in m_want.items():
        if k != "per_class_ap":
            assert abs(m_got[k] - v) < 1e-6, k
    with pytest.raises(ValueError, match="unknown eval kind"):
        evaluate(tmodel, [], ds, kind="lvis", device="cpu")


@pytest.fixture(scope="module")
def npy_tree(tmp_path_factory):
    """A tiny COCO tree as .npy: 12 training and 4 validation images, both
    orientations, 3 sparse categories."""
    root = tmp_path_factory.mktemp("coco_npy")
    for split, n, seed in (("train", 12, 1), ("val", 4, 2)):
        make_coco(root, num_images=n, hw=[(60, 80), (80, 60)], num_classes=3, seed=seed,
                  split=split, image_format="npy")
    return str(root)


def _cfg(root, **kw):
    base = dict(dataset="coco", data_path=root, model="faster", strategy="cald", tiny=True,
                cycles=2, epochs=1, batch_size=2, init_num=4, budget_num=3, score_batch_size=2,
                workers=2, min_size=96, max_size=128, max_boxes=8, print_freq=100,
                aspect_ratio_group_factor=0, device="cpu")
    base.update(kw)
    return config.ALConfig(**base)


def test_driver_builds_coco(npy_tree):
    """train2017 (images without a usable box dropped) and val2017; the
    model's classes come from the training set, CALD's statistics from
    ``cfg.num_classes`` (81), as in the JAX package."""
    cfg = _cfg(npy_tree).resolve()
    train, test = driver.build_datasets(cfg)
    assert isinstance(train, CocoDataset) and (len(train), len(test)) == (12, 4)
    assert train.img_dir.endswith("train2017") and test.img_dir.endswith("val2017")
    assert (cfg.num_classes, cfg.eval_kind) == (81, "coco")
    model, _ = driver.build_model(cfg, len(train.class_names))
    assert model.cfg.num_classes == 4


@pytest.mark.parametrize("strategy", ["cald", "random"])
def test_al_loop_coco(npy_tree, strategy):
    """Two cycles on the tiny COCO tree: the labeled set grows by the budget
    (CALD: up to ``int(mr * budget)`` when candidates detect nothing), the
    12 COCO stats per cycle; the random picks equal the JAX package's pool
    and random functions with ``al_loop``'s streams."""
    history = driver.al_loop(_cfg(npy_tree, strategy=strategy))
    assert [h["cycle"] for h in history] == [0, 1]
    for h in history:
        assert len(h["eval"]) == 12 and all(np.isfinite(v) for v in h["eval"].values())
    picked = history[0]["labeled"] - 4
    assert 3 <= picked <= int(1.2 * 3) and history[1]["labeled"] == history[0]["labeled"]
    if strategy == "random":
        pool = JPool.initial(12, 4, 0)
        subset = pool.unlabeled.copy()
        pool = pool.select(subset[jrandom_select(len(subset), 3, np.random.default_rng(100))])
        digest = hashlib.sha1(np.sort(pool.labeled).tobytes()).hexdigest()[:12]
        assert [h["labeled_digest"] for h in history] == [digest, digest]
