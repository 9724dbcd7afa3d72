"""The CALD pool-scoring cells: a pool scored the way a user's cycle scores it.

Set-up makes the JPEG tree of the mix and seed, the detector's weights
(``weights.py``, by the plain reference on the device), loads them into the
program's detector, and warms up one score batch of each canvas the pool
uses. The window then scores the pool pass after pass as
``cald_tpu_torch.cli.driver.score_and_select`` does: the driver's scoring
loader (``_loaders``, ``workers`` threads), ``score_pool`` over
``make_cald_score_fn``, then ``cald_select``. The mix's ``loader_route``
says what feeds ``score_pool``: ``device``, the driver's loader as the CLI
builds it on a CUDA device (nvJPEG and K7 into a canvas on the card), or
``staged``, the same batches made once in set-up by the benchmark (Pillow
and the plain reference's resize, ``plainref.canvas``) and held on the
card, which bypasses the loader. A batch lasts from the previous batch's
scores reaching the host to its own doing so. The window closes at the
first batch boundary after ``seconds``; the batches that completed by then
are its work.

Two batches, drawn by the seed uniformly from the whole window whatever its
length, are captured as the window runs them (``capture.py``), every image
slot, and checked after it (``check_score.py``). The JPEG tree and the
staged batches are the benchmark's own inputs: the time to make or find
them is not ``setup_s``.

A traced run hands its metric files (``metrics/<name>.py``) the trace, the
window, the operations, K1's calls, and the shapes a new kernel's bytes
and operations follow from: the configuration (``config``), the reference's
detector configuration (``cfg``) and, for every completed batch, its
``BatchShape`` (``batch_shapes``).
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from harness import check_score, trace as tracing, traffic as traffic_mod, weights
from harness.capture import Capture, SampledBatch


class WindowClosed(Exception):
    pass


class BatchShape(NamedTuple):
    """What one completed score batch ran: its canvas (h, w), its image
    slots, and its detects of each slot (the base and one an augmentation)."""

    canvas: tuple
    slots: int
    detects: int


def _port_model(config: dict, state_dict, device):
    kw = {k: (tuple(tuple(x) if isinstance(x, list) else x for x in v)
              if isinstance(v, list) else v)
          for k, v in config["detector"].items()}
    if config["model"] == "faster":
        from cald_tpu_torch.models.faster_rcnn import FasterRCNN, FasterRCNNConfig
        model = FasterRCNN(FasterRCNNConfig(compute_dtype=config["compute_dtype"], **kw))
    elif config["model"] == "retina":
        from cald_tpu_torch.models.retinanet import RetinaNet, RetinaNetConfig
        model = RetinaNet(RetinaNetConfig(compute_dtype=config["compute_dtype"], **kw))
    else:
        raise ValueError(f"unknown model {config['model']!r}: one of faster, retina")
    model.load_state_dict(state_dict)
    return model.to(device).eval()


class _Timed:
    """The scoring loader as ``score_pool`` sees it: records each batch
    request's time, the loader's wait (``loader_wait``), and the batch, and
    closes the window at the first request after the deadline."""

    def __init__(self, loader, state):
        self.loader, self.state = loader, state

    def __iter__(self):
        st = self.state
        it = iter(self.loader)
        try:
            while True:
                now = time.perf_counter()
                st["requests"].append(now)
                if now >= st["deadline"] or len(st["requests"]) > st["max_batches"]:
                    raise WindowClosed
                st["attempted"] += 1
                batch = next(it, None)
                st["spans"].append((now, time.perf_counter(), "loader_wait"))
                if batch is None:
                    st["attempted"] -= 1
                    st["requests"].pop()
                    return
                st["batch"] = batch
                st["images"].append(len(set(np.asarray(batch.image_idx).tolist())))
                st["canvas"].append(tuple(batch.images.shape[1:3]))
                st["slots"].append(batch.images.shape[0])
                yield batch
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()


def run(cell: dict, config: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device, t_start: float, cache_dir=traffic_mod.CACHE_DIR) -> dict:
    from cald_tpu_torch.augment.suite import expand_aug_string
    from cald_tpu_torch.cli import driver
    from cald_tpu_torch.cli.config import ALConfig
    from cald_tpu_torch.data.batching import (
        create_aspect_ratio_groups, default_canvases, grouped_batch_indices,
    )
    from cald_tpu_torch.data.voc import VOCDataset
    from cald_tpu_torch.strategies.cald import (
        CALDConfig, cald_select, labeled_class_counts, make_cald_score_fn, score_pool,
    )

    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    # ---- set-up
    t_tree = time.perf_counter()
    layout = traffic_mod.build_tree(cell["traffic"], seed, traffic, cache_dir=cache_dir)
    tree_s = time.perf_counter() - t_tree
    ds = VOCDataset(layout["root"], "2007", "trainval")
    pool, labeled = layout["pool"], layout["labeled"]
    cfg = ALConfig(model=config["model"], workers=traffic["workers"], device=str(device),
                   score_batch_size=traffic["batch_size"], augs=traffic["augs"],
                   bp=traffic["base_point"], budget_num=traffic["budget"], seed=seed,
                   min_size=config["min_size"], max_size=config["max_size"]).resolve()
    canvases = default_canvases(cfg.min_size, cfg.max_size)
    group_ids = create_aspect_ratio_groups(ds.aspect_ratios(), cfg.aspect_ratio_group_factor)
    staged, stage_s = None, 0.0
    if traffic["loader_route"] == "staged":
        t_stage = time.perf_counter()
        staged = _stage(ds, grouped_batch_indices(pool, group_ids, cfg.score_batch_size), cfg,
                        device)
        stage_s = time.perf_counter() - t_stage

    def pool_loader(idxs):
        """What feeds ``score_pool`` over ``idxs``: the driver's scoring
        loader, or the staged batches of those images."""
        if staged is None:
            return driver._loaders(cfg, ds, idxs, batch_size=cfg.score_batch_size, train=False,
                                   canvases=canvases, group_ids=group_ids)
        want = set(idxs)
        return [s for s in staged if set(s.image_idx.tolist()) <= want]

    groups = {}
    for i in pool:
        groups.setdefault(int(group_ids[i]), []).append(i)
    first = groups[min(groups)]
    ref = weights.seeded_reference(config, [ds.record(i).image_path for i in first[:2]], seed,
                                   device)
    model = _port_model(config, ref.state_dict(), device)
    ref.cpu()
    ccfg = CALDConfig(aug_names=tuple(expand_aug_string(cfg.augs)), base_point=cfg.bp,
                      mutual_range=cfg.mr)
    score_fn = make_cald_score_fn(driver._scoring_model(cfg, model), ccfg, cfg.num_classes)
    labeled_mean = labeled_class_counts(ds, labeled, cfg.num_classes - 1)
    # warm-up: one batch of every canvas the pool uses, through the loader
    warm = [g[:cfg.score_batch_size] for g in groups.values()]
    for idxs in warm:
        loader = pool_loader(idxs)
        gen = driver.stream_generator(device, seed + 17, 10 ** 6)
        c, corr = score_pool(score_fn, loader, idxs, gen)
        cald_select(c, corr, labeled_mean, min(cfg.budget_num, len(c)), ccfg)
    sync()
    setup_s = time.perf_counter() - t_start - tree_s - stage_s

    # ---- the window
    # the checked batches: ``checked_batches`` of the window's, drawn by the
    # seed (a kept batch that a later one replaces is freed before the call)
    rng = traffic_mod.seed_rng(seed, 3)
    b = cfg.score_batch_size
    n_checked = traffic["checked_batches"]
    samples: list = [None] * n_checked
    positions: list = [None] * n_checked
    capture = Capture(model)
    nonfinite = []
    prof = None
    k1_calls = []
    # a traced run closes its window after ``traced_batches`` batches
    st = {"deadline": 0.0, "requests": [], "spans": [], "images": [], "attempted": 0,
          "canvas": [], "slots": [], "batch": None,
          "max_batches": traffic["traced_batches"] if trace else float("inf")}

    def timed_score(images, valid_hw, draw):
        n = st["attempted"] - 1
        slot = checked_slot(rng, n, n_checked)
        record = slot < n_checked
        if record:
            samples[slot] = None
            state = gen.get_state()
            capture.calls = []
            capture.arm()
        t0 = time.perf_counter()
        try:
            c, corr = score_fn(images, valid_hw, draw)
        finally:
            st["spans"].append((t0, time.perf_counter(), "score_fn"))
            if record:
                capture.disarm()
        nonfinite.append(~(torch.isfinite(c).all() & torch.isfinite(corr).all()))
        if record:
            positions[slot] = n
            samples[slot] = SampledBatch(
                paths=[ds.record(int(i)).image_path for i in st["batch"].image_idx],
                draw_state=state, images=images.clone(), valid_hw=valid_hw.clone(),
                consistency=c.clone(), cls_corrs=corr.clone(), calls=capture.calls)
        return c, corr

    if trace and hasattr(model, "roi_align"):
        k1 = model.roi_align

        def recording_k1(levels, rois, valid, *, spatial_scales, **kw):
            if prof is not None:
                k1_calls.append(([tuple(f.shape) for f in levels], levels[0].element_size(),
                                 rois.clone(), valid.clone(), tuple(spatial_scales)))
            return k1(levels, rois, valid, spatial_scales=spatial_scales, **kw)

        model.roi_align = recording_k1

    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    if trace and cuda:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
    t_mark = time.perf_counter()
    sync()                                      # the trace's clock marker
    t0 = time.perf_counter()
    st["deadline"] = t0 + seconds
    pass_no = 0
    try:
        while True:
            gen = driver.stream_generator(device, seed + 17, pass_no)
            loader = pool_loader(pool)
            c, corr = score_pool(timed_score, _Timed(loader, st), pool, gen)
            t_sel = time.perf_counter()
            cald_select(c, corr, labeled_mean, cfg.budget_num, ccfg)
            st["spans"].append((t_sel, time.perf_counter(), "select"))
            pass_no += 1
    except WindowClosed:
        pass
    t_close = st["requests"][-1]
    sync()
    if prof is not None:
        prof.stop()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    requests = st["requests"]
    latencies = np.diff(requests)                       # one per completed batch
    done = len(latencies)
    images_done = int(sum(st["images"][:done]))
    window_s = t_close - t0
    failed = int(torch.stack(nonfinite).sum()) if nonfinite else 0
    samples = [s for s in samples if s is not None]
    lines = [f"window: {done} batches, {images_done} images in {window_s:.3f} s, "
             f"{pass_no} whole passes; peak memory {peak} bytes, of which the checked "
             f"batches' copies {sum(s.nbytes() for s in samples)} bytes",
             "checked batches (from 0): " + ", ".join(str(x) for x in sorted(
                 p for p in positions if p is not None)) + f" of {done}",
             f"slowest batch: {latencies.max() * 1e3 if done else 0.0:.1f} ms, "
             f"batch {int(latencies.argmax()) if done else -1} (from 0)",
             f"traffic tree: {'found' if layout['cached'] else 'written'} in {tree_s:.3f} s"
             + (f", staged batches made in {stage_s:.3f} s" if staged is not None else "")
             + ", not in setup_s"]
    if samples:
        per_image = [[float(c["dets"].valid.sum(-1).float().mean()) for c in s.calls]
                     for s in samples]
        slots = samples[0].calls[0]["dets"].valid.shape[-1]
        lines.append("valid detections per image of the checked batches: base "
                     + ", ".join(f"{p[0]:.2f}" for p in per_image) + "; augmented "
                     + ", ".join(f"{p[1]:.2f}" for p in per_image) + f" (of {slots} slots)")

    result = {"attempted": st["attempted"], "failed": failed,
              "device_extra": {}, "lines": lines}
    if not trace:
        result["metrics"] = {
            "score_images_per_s": {"value": images_done / window_s, "unit": "images/s"},
            "score_batch_p90_ms": {"value": float(np.percentile(latencies, 90)) * 1e3,
                                   "unit": "ms"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
    else:
        tr = (tracing.read(prof, st["spans"], t_mark) if prof is not None
              else tracing.Trace([], [], None))
        busy = tracing.busy_s(tr.device_ops)
        shapes = [BatchShape(hw, slots, 1 + len(ccfg.aug_names))
                  for hw, slots in zip(st["canvas"][:done], st["slots"][:done])]
        result["traced"] = {
            "trace": tr, "window_s": window_s, "batches": done, "images": images_done,
            "flops": _score_flops(ref.cfg, shapes), "busy_s": busy,
            "config": config, "cfg": ref.cfg, "batch_shapes": shapes,
            "k1_calls": k1_calls,
            "loader_wait_s": [b - a for a, b, n in st["spans"] if n == "loader_wait"],
        }
        result["device_extra"] = {"busy_s": busy, "window_s": window_s}
        result["breakdown"] = tracing.breakdown(tr)
    result["memory_peak_bytes"] = peak

    # ---- the check, once the program's state is freed
    if hasattr(model, "roi_align"):
        model.__dict__.pop("roi_align", None)
    del model, score_fn, loader, capture, prof
    if cuda:
        torch.cuda.empty_cache()
    ref.to(device)
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    readings = []
    try:
        for s in samples:
            try:
                readings.append(check_score.compare(s, ref, config, traffic))
            except (RuntimeError, ValueError, IndexError) as e:
                # what the timed path produced does not even fit the reference
                lines.append(f"the check could not compare a sampled batch: {e!r}")
                readings.append({k: float("inf") for k in check_score.NUMBERS})
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    limits = config["check_limits"]
    if readings:
        ok, worst = check_score.judge(readings, limits)
    else:
        ok, worst = False, {k: float("nan") for k in check_score.NUMBERS}
        lines.append("no sampled batch ran in the window")
    result["correct"] = bool(ok and failed == 0)
    result["checks"] = {k: {"value": worst[k], "limit": limits[k]} for k in check_score.NUMBERS}
    return result


def _stage(ds, batches, cfg, device) -> list:
    """The score batches ``batches`` made by the benchmark on ``device``:
    each canvas decoded by Pillow and resized by the plain reference
    (``plainref.canvas``), with the fields ``score_pool`` reads."""
    from plainref.canvas import batch_canvas

    def one(idxs):
        paths = [ds.record(i).image_path for i in idxs]
        images, hw = batch_canvas(paths, list(range(len(paths))), cfg.min_size, cfg.max_size,
                                  device)
        return SimpleNamespace(images=images, valid_hw=hw.cpu().numpy(),
                               image_idx=np.asarray(idxs, np.int32))

    with ThreadPoolExecutor(max_workers=8) as ex:
        return list(ex.map(one, batches))


def checked_slot(rng, n: int, k: int) -> int:
    """Reservoir sampling of ``k`` items of a stream of unknown length, each
    as likely as any other: the slot that item ``n`` (from 0) takes, or ``k``
    or more where it is not kept."""
    return n if n < k else int(rng.integers(0, n + 1))


def _score_flops(cfg, shapes: list[BatchShape]) -> float:
    """Operations of the completed batches: every detect of every image
    slot (a base detect and one an augmentation), on the batch's canvas."""
    from harness.counting import detect_flops

    per_canvas: dict = {}
    total = 0.0
    for hw, slots, detects in shapes:
        if hw not in per_canvas:
            per_canvas[hw] = detect_flops(cfg, *hw)
        total += per_canvas[hw] * slots * detects
    return total
