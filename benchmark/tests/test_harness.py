"""The harness on the CPU, at the tiny size of ``tiny.py``: the traffic is
the seed's alone, a cell added as files is found by name (and a detector
with a backbone the harness has not seen, with its count, control and
metric, added as files and entries only), the last line
keeps its shape, a broken timed path comes out not correct, and nothing
loads JAX or the JAX package (nor, in the reference, the program)."""

import ast
import hashlib
import importlib.util
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT), str(BENCH / "tests")]

import tiny  # noqa: E402

CELL = "faster_r50fpn_voc.cald_score_staged"
FORBIDDEN = {"jax", "jaxlib", "flax", "cald_tpu"}


def _run(tmp_path, trace=False, seconds=14.0, seed=11, mix="voc07_pool1024_staged"):
    import torch

    from cald_tpu_torch import native

    native.build()                  # the CPU route of the scoring loader
    import run

    spec = run.load_spec()
    return run.run_cell(spec, CELL, seed, seconds, trace, torch.device("cpu"),
                        config=tiny.config(), traffic=tiny.traffic(mix), cache_dir=tmp_path)


def _files(d: Path) -> dict:
    return {p.relative_to(d).as_posix(): p.read_bytes() for p in sorted(d.rglob("*"))
            if p.is_file()}


def test_traffic_is_the_seeds_alone(tmp_path):
    from harness import traffic

    a = traffic.build_tree("tiny", 5, tiny.traffic(), cache_dir=tmp_path / "a")
    b = traffic.build_tree("tiny", 5, tiny.traffic(), cache_dir=tmp_path / "b")
    c = traffic.build_tree("tiny", 6, tiny.traffic(), cache_dir=tmp_path / "c")
    assert not a["cached"] and traffic.build_tree("tiny", 5, tiny.traffic(),
                                                  cache_dir=tmp_path / "a")["cached"]
    fa, fb, fc = (_files(Path(x["root"])) for x in (a, b, c))
    assert fa == fb
    assert fa != fc and sorted(fa) == sorted(fc)

    def work(files):
        """The multisets of image sizes and of box counts: every seed's."""
        xmls = [v for k, v in files.items() if k.endswith(".xml")]
        return (sorted(re.search(rb"<width>(\d+)</width><height>(\d+)", v).groups()
                       for v in xmls), sorted(v.count(b"<object>") for v in xmls))
    assert work(fa) == work(fc)


def test_a_cell_added_as_files_is_found_by_name(tmp_path):
    copy = tmp_path / "benchmark"
    shutil.copytree(BENCH, copy, ignore=shutil.ignore_patterns("cache", "__pycache__"))
    before = {k: hashlib.sha256(v).hexdigest() for k, v in _files(copy).items()}
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    # a configuration, a traffic mix and a per-layer metric, each a new file
    conf = json.loads((BENCH / "configs" / "faster_r50fpn_voc.json").read_text())
    conf["name"] = "faster_r50fpn_voc_b8"
    (copy / "configs" / "faster_r50fpn_voc_b8.json").write_text(json.dumps(conf))
    mix = json.loads((BENCH / "traffic" / "voc07_pool1024.json").read_text())
    mix["batch_size"] = 8
    (copy / "traffic" / "voc07_pool1024_b8.json").write_text(json.dumps(mix))
    (copy / "metrics" / "images_traced.score.py").write_text(
        "def read(run):\n    return run.images\n")
    spec["configs"].append({"name": "faster_r50fpn_voc_b8", "source": conf["source"],
                            "file": "benchmark/configs/faster_r50fpn_voc_b8.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "faster_r50fpn_voc_b8.cald_score_b8",
                              "config": "faster_r50fpn_voc_b8",
                              "traffic": "voc07_pool1024_b8", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "images_traced.score", "unit": "images",
                              "better": "higher", "source": "host_clock", "layer": "device",
                              "moves": "score_images_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    after = {k: hashlib.sha256(v).hexdigest() for k, v in _files(copy).items()}
    assert all(after[k] == v for k, v in before.items())          # no file edited

    mod_spec = importlib.util.spec_from_file_location("run_copy", copy / "run.py")
    run = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(run)
    loaded = run.load_spec()
    cell, config, traffic = run.resolve_cell(loaded, "faster_r50fpn_voc_b8.cald_score_b8")
    assert config["name"] == "faster_r50fpn_voc_b8" and traffic["batch_size"] == 8
    names = [m["name"] for m in run.cell_metrics(loaded, cell["name"], "per_layer")]
    assert "images_traced.score" in names and "k1_roofline.score" not in names
    assert run.load_reader("images_traced.score")(type("Run", (), {"images": 48})) == 48


# a backbone the harness has never seen, as the files a new one brings: its
# reference module, its operation count and a metric reading the traced
# run's shapes. One conv (stride 4), one windowed self-attention through
# ``Product`` with a relative position bias table listed as a seeded leaf,
# and average pools down to stride 32.
TOY_BACKBONE = '''
import torch
import torch.nn.functional as F
from torch import nn

from plainref.models.layers import Conv, Product


class ToyWindow(nn.Module):
    def __init__(self, channels, window, dtype=None):
        super().__init__()
        self.window = window
        self.embed = Conv(3, channels, 4, stride=4, dtype=dtype)
        self.qk = Product(dtype)
        self.av = Product(dtype)
        self.bias_table = nn.Parameter(torch.zeros((2 * window - 1) ** 2))
        ys, xs = torch.meshgrid(torch.arange(window), torch.arange(window), indexing="ij")
        pos = torch.stack([ys.flatten(), xs.flatten()])
        rel = pos[:, :, None] - pos[:, None, :] + window - 1
        self.register_buffer("rel_index", rel[0] * (2 * window - 1) + rel[1],
                             persistent=False)
        self.out_keys = ("c2", "c3", "c4", "c5")
        self.out_channels = (channels,) * 4

    def seeded_leaves(self):
        return [(self.bias_table, "trunc", 0.02)]

    def forward(self, x):
        y = self.embed(x)
        b, c, h, w = y.shape
        s = self.window
        hp, wp = -(-h // s) * s, -(-w // s) * s
        t = F.pad(y, (0, wp - w, 0, hp - h)).reshape(b, c, hp // s, s, wp // s, s)
        t = t.permute(0, 2, 4, 3, 5, 1).reshape(-1, s * s, c)
        scores = self.qk(t, t.transpose(1, 2)) * c ** -0.5
        scores = scores + self.bias_table[self.rel_index].to(scores.dtype)
        out = self.av(scores.softmax(-1), t).reshape(b, hp // s, wp // s, s, s, c)
        out = out.permute(0, 5, 1, 3, 2, 4).reshape(b, c, hp, wp)[:, :, :h, :w]
        maps = [y + out]
        for _ in range(3):
            maps.append(F.avg_pool2d(maps[-1], 2, ceil_mode=True))
        return dict(zip(self.out_keys, maps))


def build(dtype, norm, channels, window):
    return ToyWindow(channels, window, dtype)
'''
TOY_COUNT = '''
def windows(cfg, h, w):
    """(windows, tokens a window, channels) of the attention on an (h, w)
    canvas."""
    c, s = cfg.backbone_args["channels"], cfg.backbone_args["window"]
    ho, wo = (h - 4) // 4 + 1, (w - 4) // 4 + 1
    return -(-ho // s) * -(-wo // s), s * s, c


def backbone_flops(cfg, h, w):
    c = cfg.backbone_args["channels"]
    ho, wo = (h - 4) // 4 + 1, (w - 4) // 4 + 1
    n, t, _ = windows(cfg, h, w)
    total = 2 * 3 * c * 4 * 4 * ho * wo + 2 * 2 * n * t * t * c
    maps = [(c, ho, wo)]
    for _ in range(3):
        ho, wo = -(-ho // 2), -(-wo // 2)
        maps.append((c, ho, wo))
    return total, maps
'''
TOY_METRIC = '''
"""Bytes a score batch of the toy attention's float32 scores, from the
traced run's shapes."""


def read(run):
    from harness.counts.toy_window import windows

    if not run.batch_shapes:
        return None
    total = 0
    for (h, w), slots, detects in run.batch_shapes:
        n, t, _ = windows(run.cfg, h, w)
        total += slots * detects * n * t * t * 4
    return total / len(run.batch_shapes)
'''
TOY_CHECK = '''
import json, sys
from pathlib import Path

copy = Path(sys.argv[1])
sys.path[:0] = [str(copy), str(copy.parent), str(copy / "tests")]
import torch
from torch.utils.flop_counter import FlopCounterMode

import run
import tiny
from harness import control, counting, traffic, weights
from harness.cald_score import BatchShape
from harness.check_score import reference_model
from plainref.models.layers import Conv, Dense

spec = run.load_spec()
cell, config, mix = run.resolve_cell(spec, "faster_toywin_voc.cald_score_staged")
assert cell["config"] == "faster_toywin_voc" and config["detector"]["backbone"] == "toy_window"
assert "toy_scores_bytes.score" in [m["name"] for m in run.cell_metrics(spec, cell["name"],
                                                                        "per_layer")]
ref = reference_model(config, "cpu")
assert type(ref.backbone).__name__ == "ToyWindow" and ref.feat_keys == ("c2", "c3", "c4", "c5")

layout = traffic.build_tree("tiny", 5, tiny.traffic(), cache_dir=Path(sys.argv[2]))
paths = [f"{layout['root']}/VOC2007/JPEGImages/{i:06d}.jpg" for i in layout["pool"][:2]]
a, b, c = (weights.seeded_reference(config, paths, s, "cpu") for s in (41, 41, 2 ** 33 + 7))
sa, sb = a.state_dict(), b.state_dict()
assert all(torch.equal(sa[k], sb[k]) for k in sa)
leaves = [n for n, m in a.named_modules() if isinstance(m, (Conv, Dense))]
named_a, named_c = dict(a.named_parameters()), dict(c.named_parameters())
seeded = [f"{n}.weight" for n in leaves] + ["backbone.bias_table"]
assert all(not torch.equal(named_a[k], named_c[k]) for k in seeded), seeded
assert named_a["backbone.bias_table"].std() > 0.005

H, W = 100, 150
with FlopCounterMode(display=False) as counter, torch.no_grad():
    a.detect(torch.rand(1, H, W, 3) * 255, torch.tensor([[H, W]]))
assert counter.get_total_flops() == counting.detect_flops(a.cfg, H, W)
# RetinaNet on the same backbone takes all its maps but the finest
retina = tiny.config("retina_r50fpn_voc")
retina["detector"].update(backbone="toy_window", fpn_channels=32,
                          backbone_args=config["detector"]["backbone_args"])
r = reference_model(retina, "cpu")
assert r.feat_keys == ("c3", "c4", "c5")
for p in r.parameters():
    torch.nn.init.normal_(p, 0.0, 0.01)
with FlopCounterMode(display=False) as counter, torch.no_grad():
    r.detect(torch.rand(1, H, W, 3) * 255, torch.tensor([[H, W]]))
assert counter.get_total_flops() == counting.detect_flops(r.cfg, H, W)

# the control rounds the attention's own products: on the reference's
# operands, its QK^T and AV differ from the reference's
ctl = control.control_model(a)
calls = {}
for name in ("qk", "av"):
    getattr(a.backbone, name).register_forward_hook(
        lambda m, i, o, name=name: calls.__setitem__(name, (i, o)))
with torch.no_grad():
    a.features(torch.rand(1, 64, 96, 3, generator=torch.Generator().manual_seed(3)) * 255,
               torch.tensor([[64, 96]]))
    for name, (args, want) in calls.items():
        got = getattr(ctl.backbone, name)(*args)
        assert torch.equal(getattr(a.backbone, name)(*args), want), name
        assert (got - want).abs().max() > 1e-3 * want.abs().max(), name

read = run.load_reader("toy_scores_bytes.score")
shapes = [BatchShape((64, 128), 4, 5), BatchShape((128, 64), 4, 5)]
got = read(type("Run", (), {"batch_shapes": shapes, "cfg": a.cfg}))
assert got == 4 * 5 * (4 * 8) * 16 * 16 * 4, got
assert read(type("Run", (), {"batch_shapes": [], "cfg": a.cfg})) is None
print("toy backbone: resolved, built, seeded, counted, controlled")
'''


def test_a_detector_with_a_new_backbone_is_added_as_files_only(tmp_path):
    copy = tmp_path / "benchmark"
    shutil.copytree(BENCH, copy, ignore=shutil.ignore_patterns("cache", "__pycache__"))
    before = {k: hashlib.sha256(v).hexdigest() for k, v in _files(copy).items()}
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    # the backbone's reference module, its operation count, a configuration
    # that names it, a cell and a metric of a new kernel: new files and entries
    (copy / "plainref" / "models" / "backbones" / "toy_window.py").write_text(TOY_BACKBONE)
    (copy / "harness" / "counts" / "toy_window.py").write_text(TOY_COUNT)
    (copy / "metrics" / "toy_scores_bytes.score.py").write_text(TOY_METRIC)
    conf = tiny.config()
    conf["name"] = "faster_toywin_voc"
    conf["detector"].update(backbone="toy_window", backbone_args={"channels": 32, "window": 4},
                            fpn_channels=32)
    (copy / "configs" / "faster_toywin_voc.json").write_text(json.dumps(conf))
    spec["configs"].append({"name": "faster_toywin_voc", "source": conf["source"],
                            "file": "benchmark/configs/faster_toywin_voc.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "faster_toywin_voc.cald_score_staged",
                              "config": "faster_toywin_voc",
                              "traffic": "voc07_pool1024_staged", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "toy_scores_bytes.score", "unit": "bytes",
                              "better": "lower", "source": "host_clock", "layer": "kernels",
                              "moves": "score_images_per_s",
                              "workloads": ["faster_toywin_voc.cald_score_staged"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    after = {k: hashlib.sha256(v).hexdigest() for k, v in _files(copy).items()}
    assert all(after[k] == v for k, v in before.items())          # no file edited
    assert set(after) - set(before) == {
        "plainref/models/backbones/toy_window.py", "harness/counts/toy_window.py",
        "metrics/toy_scores_bytes.score.py", "configs/faster_toywin_voc.json"}

    # the copy's own modules, in a process of their own
    out = subprocess.run([sys.executable, "-c", TOY_CHECK, str(copy), str(tmp_path / "trees")],
                         capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "controlled" in out.stdout


def test_an_unknown_backbone_or_model_is_refused():
    from harness import cald_score, counting
    from harness.check_score import model_config, reference_model

    config = tiny.config()
    config["detector"]["backbone"] = "nonesuch"
    with pytest.raises(ValueError, match=r"backbones/nonesuch\.py"):
        reference_model(config, "cpu")
    with pytest.raises(ValueError, match=r"counts/nonesuch\.py"):
        counting.detect_flops(model_config(config, "float32"), 64, 64)
    config = tiny.config()
    config["model"] = "mask"
    for build in (lambda: model_config(config, "float32"), lambda: reference_model(config, "cpu"),
                  lambda: cald_score._port_model(config, {}, "cpu")):
        with pytest.raises(ValueError, match="unknown model 'mask'"):
            build()


def test_a_parameter_no_family_covers_stops_the_seeding():
    import torch

    from harness import weights
    from harness.check_score import reference_model

    ref = reference_model(tiny.config(), "cpu")
    ref.backbone.stray = torch.nn.Parameter(torch.zeros(3))
    with pytest.raises(ValueError, match=r"backbone\.stray"):
        weights.random_init_(ref, 5)


@pytest.mark.parametrize("mix", ["voc07_pool1024_staged", "voc07_pool1024"])
def test_last_line_shape_and_a_sound_run(mix, tmp_path):
    out = _run(tmp_path, mix=mix)
    r = out["result"]
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {"score_images_per_s", "score_batch_p90_ms", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in r["metrics"].values())
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(r["checks"]) == {"canvas_gap", "pyramid_rel", "head_rel", "det_mismatch",
                                "aug_gap", "score_gap"}
    json.dumps(r, allow_nan=False)

    traced = _run(tmp_path, True, mix=mix)["result"]
    assert list(traced) == ["correct", "attempted", "failed", "metrics", "device",
                            "breakdown", "checks"]
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}
    # on the CPU no device operation is traced: the per-layer readers that
    # read the device's trace give nothing
    assert set(traced["metrics"]) <= {"loader_wait_ms.score", "mfu.score"}


def test_the_checked_batches_are_drawn_from_the_whole_window():
    from harness.cald_score import checked_slot
    from harness.traffic import seed_rng

    n, k, seeds = 200, 2, 400
    kept = []
    for seed in range(seeds):
        rng = seed_rng(2 ** 40 + seed, 3)
        slots = [None] * k
        for i in range(n):
            j = checked_slot(rng, i, k)
            if j < k:
                slots[j] = i
        assert len(set(slots)) == k
        kept += slots
    # every position as likely as any other: each quarter of the window
    # holds about a quarter of the kept batches
    quarters = [sum(1 for i in kept if q * n // 4 <= i < (q + 1) * n // 4) for q in range(4)]
    assert all(abs(c - len(kept) / 4) < 0.2 * len(kept) / 4 for c in quarters), quarters


def _broken(monkeypatch, kind: str):
    import cald_tpu_torch.strategies.cald as cald

    if kind == "answer":
        real = cald.cald_consistency
        monkeypatch.setattr(cald, "cald_consistency", lambda *a, **k: real(*a, **k) + 0.25)
    elif kind == "half_batch":
        real = cald.make_cald_score_fn

        def make(model, cfg, num_classes):
            fn = real(model, cfg, num_classes)

            def score(images, valid_hw, draw):
                h = images.shape[0] // 2
                c, corr = fn(images[:h], valid_hw[:h], draw)
                return c.repeat(2), corr.repeat(2, 1)
            return score
        monkeypatch.setattr(cald, "make_cald_score_fn", make)


@pytest.mark.parametrize("kind", ["answer", "half_batch"])
def test_a_broken_timed_path_is_not_correct(kind, tmp_path, monkeypatch):
    _broken(monkeypatch, kind)
    assert _run(tmp_path)["result"]["correct"] is False


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_benchmark_file_imports_jax_and_the_reference_not_the_program():
    for path in BENCH.rglob("*.py"):
        assert not (_imports(path) & FORBIDDEN), path
    for path in (BENCH / "plainref").rglob("*.py"):
        assert "cald_tpu_torch" not in _imports(path), path
    for path in BENCH.rglob("*.py"):
        if path != Path(__file__).resolve():
            text = path.read_text()
            assert "BENCH_r0" not in text and "bench.py" not in text, path


def test_a_run_and_the_reference_load_no_jax(tmp_path):
    code = f"""
import sys
sys.path[:0] = [{str(BENCH)!r}, {str(ROOT)!r}, {str(BENCH / 'tests')!r}]
import harness.check_score, harness.control, plainref.canvas
assert not [m for m in sys.modules if m.split('.')[0] == 'cald_tpu_torch'], 'reference'
import test_harness
from pathlib import Path
test_harness._run(Path({str(tmp_path)!r}), seconds=4.0)
import run
print(run.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
