"""Loading a cell by name: its `BENCHMARK.json` entry, the configuration's
file, the traffic mix's file and the cell's own file, merged into one
`CellSpec`. Nothing here knows a cell, a configuration or a mix by name."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
MANIFEST = ROOT / "BENCHMARK.json"


@dataclasses.dataclass
class CellSpec:
    name: str
    chips: int
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json, overlaid by the cell's "traffic" key
    limits: dict  # the cell's correctness limits, by compared number
    judge: dict  # the cell's settings of the comparison (`reference.judge.judge`)
    end_to_end: list  # the manifest's end-to-end metrics this cell reports
    per_layer: list  # the manifest's per-layer metrics this cell reports


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, manifest: dict | None = None) -> CellSpec:
    manifest = manifest if manifest is not None else load_json(MANIFEST)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    entry = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = load_json(ROOT / configs[entry["config"]]["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{entry['traffic']}.json")
    own = load_json(BENCH_DIR / "workloads" / f"{name}.json")
    traffic = {**traffic, **own.get("traffic", {})}
    return CellSpec(
        name=name,
        chips=int(entry["chips"]),
        config=config,
        traffic=traffic,
        limits=own["limits"],
        judge=own.get("judge", {}),
        end_to_end=[m for m in manifest["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in manifest["per_layer"] if _reports(m, name)],
    )


def load_module(path: Path, name: str | None = None):
    """Import a file of this folder by its path: metric and path files are
    named from a metric's characters, which may hold dots."""
    mod_name = name or f"perfbench_file_{path.stem.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_metric(name: str):
    return load_module(BENCH_DIR / "metrics" / f"{name}.py", f"perfbench_metric_{name}")


def load_generator(name: str):
    return load_module(BENCH_DIR / "traffic" / f"{name}.py", f"perfbench_traffic_{name}")


def load_path(name: str):
    import importlib

    return importlib.import_module(f"perfbench.paths.{name}")
