"""``BENCHMARK.json`` keeps the benchmark's contract: names, units and
keys, the metrics each cell reports, and the files each entry names."""

import json
import re
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_and_paths():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= len(SPEC["paths"]) <= 16 and all(PATH.fullmatch(p) for p in SPEC["paths"])
    assert len(SPEC["command"]) <= 32 and all(_line(w) for w in SPEC["command"])
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_entries_names_units_and_keys():
    for section, keys in KEYS.items():
        names = [e["name"] for e in SPEC[section]]
        assert len(names) == len(set(names)), section
        for e in SPEC[section]:
            extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
            assert keys <= set(e) <= keys | extra, (section, e["name"])
            assert NAME.fullmatch(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.fullmatch(e["unit"]) and e["better"] in ("lower", "higher")
                assert e["source"] in SOURCES
            for k in ("why", "layer", "source"):
                if k in e and section != "end_to_end":
                    assert _line(e[k]), (e["name"], k)
    for c in SPEC["configs"]:
        assert len(c["reduced"]) <= 16 and all(NAME.fullmatch(k) for k in c["reduced"])
        assert c["file"].startswith(tuple(p + "/" for p in SPEC["paths"]))
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for w in SPEC["workloads"]:
        assert NAME.fullmatch(w["config"]) and NAME.fullmatch(w["traffic"])
        assert w["chips"] in (1, 4)
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {c["name"] for c in SPEC["configs"]} == {w["config"] for w in SPEC["workloads"]}


def test_bounds():
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m["name"]
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def test_every_per_layer_metric_moves_a_metric_its_cells_report():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    layers = {}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        assert (BENCH / "metrics" / f"{m['name']}.py").exists(), m["name"]
        for w in SPEC["workloads"]:
            if _reports(m, w["name"]):
                assert _reports(e2e[m["moves"]], w["name"]), (m["name"], w["name"])
        layers.setdefault(m["layer"], []).append(m["name"])
    for w in SPEC["workloads"]:
        reported = [m["name"] for m in SPEC["end_to_end"] if _reports(m, w["name"])]
        assert "setup_s" in reported and len(reported) >= 2, w["name"]
        assert any(_reports(m, w["name"]) for m in SPEC["per_layer"]), w["name"]


def test_at_most_a_quarter_of_the_cells_on_four_chips():
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)
