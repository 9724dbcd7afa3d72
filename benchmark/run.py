"""Run one benchmark cell of ``cald_tpu_torch`` once.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA cards. The
cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``configs/<name>.json``) and a traffic mix (``traffic/<name>.json``); the
mix's ``kind`` names the module of ``harness/`` that drives it. With
``--trace 0`` the last line of standard output carries the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics, each read by
``metrics/<name>.py`` from a ``torch.profiler`` trace of a shorter window.
Every number the correctness check compared is printed beside its limit,
as the last lines of standard error and under ``checks`` in the result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# the modules JAX would bring, compared by whole top-level name: the port,
# cald_tpu_torch, begins with the JAX package's name but is not it
FORBIDDEN = ("jax", "jaxlib", "flax", "cald_tpu")


def load_spec() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell_metrics(spec: dict, cell: str, section: str) -> list[dict]:
    """The metrics of ``section`` that ``cell`` reports."""
    return [m for m in spec[section] if cell in m.get("workloads", [cell])]


def load_reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not readable"


def resolve_cell(spec: dict, cell_name: str) -> tuple[dict, dict, dict]:
    """(cell, configuration, traffic mix) of a cell, found by name."""
    cell = next(w for w in spec["workloads"] if w["name"] == cell_name)
    conf_entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    with open(ROOT / conf_entry["file"]) as f:
        config = json.load(f)
    with open(BENCH / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    return cell, config, traffic


def run_cell(spec: dict, cell_name: str, seed: int, seconds: float, trace: bool, device,
             config=None, traffic=None, **kw) -> dict:
    """One run of a cell on ``device``: the result object the last line
    prints, and ``lines`` for the lines before it. ``config`` and
    ``traffic`` replace the cell's files (the CPU tests' tiny sizes)."""
    import torch

    cell, cell_config, cell_traffic = resolve_cell(spec, cell_name)
    config = cell_config if config is None else config
    traffic = cell_traffic if traffic is None else traffic
    driver = importlib.import_module(f"harness.{traffic['kind']}")
    out = driver.run(cell, config, traffic, seed, seconds, trace, device, T_START, **kw)
    if not trace:
        names = [m["name"] for m in cell_metrics(spec, cell_name, "end_to_end")]
        metrics = {k: out["metrics"][k] for k in names if k in out["metrics"]}
    else:
        run = types.SimpleNamespace(**out["traced"])
        metrics = {}
        for m in cell_metrics(spec, cell_name, "per_layer"):
            value = load_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                         "kind": (torch.cuda.get_device_name(device)
                                  if device.type == "cuda" else "cpu"),
                         "count": cell["chips"],
                         "memory_peak_bytes": out["memory_peak_bytes"],
                         **out["device_extra"]}}
    if trace:
        result["breakdown"] = out["breakdown"]
    # a reading that is not finite (a batch that does not fit the reference)
    # prints as text, so that the line stays strict JSON
    result["checks"] = {k: {"value": v["value"] if math.isfinite(v["value"]) else
                            str(v["value"]), "limit": v["limit"]}
                        for k, v in out["checks"].items()}
    return {"result": result, "lines": out["lines"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    sys.path[:0] = [str(BENCH), str(ROOT)]
    # build and kernel caches at fixed paths inside the checkout
    for var in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR"):
        os.environ.setdefault(var, str(BENCH / "cache" / var.lower()))
    spec = load_spec()
    cell = next((w for w in spec["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    print(f"card: {card_line()}", flush=True)
    out = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace), device)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {', '.join(bad)}: the benchmark may load none of "
              f"{', '.join(FORBIDDEN)}", file=sys.stderr)
        return 3
    for line in out["lines"]:
        print(line, flush=True)
    result = out["result"]
    print(json.dumps(result, allow_nan=False), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
