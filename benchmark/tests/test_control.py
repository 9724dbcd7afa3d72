"""The correctness control (``harness/control.py``) fails the limits, for
every configuration of ``BENCHMARK.json``.

On the CPU at the tiny size of ``tiny.py``; on a card (marked ``cuda``) at
the cells' own sizes on three seeds, printing each seed's readings (run
with ``-s``). Run as a script on the card, it prints the control's
readings, the upper readings the limits were set from:

    python benchmark/tests/test_control.py <config> <traffic> <seed>...
"""

import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT), str(BENCH / "tests")]

import tiny  # noqa: E402

# every configuration of the benchmark, by name: its file
CONFIGS = {c["name"]: c["file"]
           for c in json.loads((ROOT / "BENCHMARK.json").read_text())["configs"]}
SEEDS = (4100000001, 4100000002, 4100000003)


def _readings(config, traffic_name, traffic, seed, device, **kw):
    from harness import control

    return control.readings(config, traffic_name, traffic, seed, device, **kw)


def _config(name: str) -> dict:
    return json.loads((ROOT / CONFIGS[name]).read_text())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_control_fails_on_cpu(name, tmp_path):
    import torch

    from harness.check_score import judge

    config = tiny.config(name)
    r = _readings(config, "tiny", tiny.traffic(), 7, torch.device("cpu"), cache_dir=tmp_path)
    ok, _ = judge([r], config["check_limits"])
    assert not ok, r


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_control_fails_on_card(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from harness.check_score import judge

    config = _config(name)
    with open(BENCH / "traffic" / "voc07_pool1024.json") as f:
        traffic = json.load(f)
    for seed in SEEDS:
        r = _readings(config, "voc07_pool1024", traffic, seed, torch.device("cuda"))
        print(json.dumps({"control": name, "seed": seed, **r}), flush=True)
        ok, _ = judge([r], config["check_limits"])
        assert not ok, (seed, r)


if __name__ == "__main__":
    import torch

    name, traffic_name, *seeds = sys.argv[1:]
    config = _config(name)
    with open(BENCH / "traffic" / f"{traffic_name}.json") as f:
        traffic = json.load(f)
    for s in seeds:
        r = _readings(config, traffic_name, traffic, int(s), torch.device("cuda"))
        print(json.dumps({"control": name, "seed": int(s), **r}), flush=True)
