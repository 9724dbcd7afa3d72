"""The harness on the CPU, at the tiny size of ``tiny.py``: the traffic is
the seed's alone, a cell added as files is found by name, the last line
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
