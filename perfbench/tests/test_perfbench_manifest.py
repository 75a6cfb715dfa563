"""`BENCHMARK.json` against the benchmark's contract, and every name in it
against the files that the harness finds by that name."""
import json
import math
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def reporters(metric):
    return set(metric.get("workloads", CELLS))


def test_top_level_keys_and_paths():
    assert set(MANIFEST) == KEYS
    assert MANIFEST["paths"] == ["perfbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51 and isinstance(MANIFEST["run_seconds"], int)
    for word in MANIFEST["command"][1:]:
        if "/" in word:
            assert word.startswith("perfbench/") and ".." not in word
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("entry", MANIFEST["configs"] + MANIFEST["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
        assert entry["source"] in SOURCES
    for key in entry.get("reduced", []):
        assert NAME.match(key)
    for text in (entry.get("why"), entry.get("layer"), entry.get("source")):
        if text is not None:
            assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_names_unique_and_configs_used():
    for group in (MANIFEST["configs"], MANIFEST["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_four_card_cells_within_a_quarter():
    four = [w for w in MANIFEST["workloads"] if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) for w in MANIFEST["workloads"])
    assert len(four) <= max(1, math.floor(len(CELLS) / 4))


def test_bounds():
    assert any(m["name"] == "setup_s" for m in MANIFEST["end_to_end"])
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_moves_reported_where_the_metric_is():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e
        assert reporters(m) <= reporters(e2e[m["moves"]]), m["name"]
        assert set(m.get("workloads", [])) <= set(CELLS)


def test_layers_named_alike():
    layers = {m["layer"] for m in MANIFEST["per_layer"]}
    perf = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert f"`{layer}`" in perf, layer


def test_every_cell_reports_enough():
    for cell in CELLS:
        e2e = [m["name"] for m in MANIFEST["end_to_end"] if cell in reporters(m)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(cell in reporters(m) for m in MANIFEST["per_layer"])


def test_files_found_by_name():
    from perfbench.yardstick import spec

    for c in MANIFEST["configs"]:
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).is_file()
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert set(c["reduced"]) == set(cfg["reduced"])
    for name in CELLS:
        cell = spec.load_cell(name)
        assert cell.traffic["trees_per_fit"] >= 1
        assert "http" in cell.traffic["trees_per_fit_source"], name
        assert int(cell.traffic.get("world", 1)) == cell.chips
        assert (BENCH / "paths" / f"{cell.traffic['path']}.py").is_file()
        assert (BENCH / "traffic" / f"{cell.config['generator']}.py").is_file()
        assert {"cuts_mismatch", "bins_mismatch", "leaf_gap", "margin_gap"} <= set(cell.limits)
    for m in METRICS:
        assert hasattr(spec.load_metric(m["name"]), "read"), m["name"]


def test_file_names_from_name_characters():
    for path in BENCH.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
