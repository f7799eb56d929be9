"""`BENCHMARK.json` and the files it names, found by name and checked.

A cell is found by its name; its configuration is `configs/<config>.json`,
its traffic `traffic/<traffic>.json`, each per-layer metric's reader
`metrics/<metric>.py`, and the configuration's reference
`reference/<reference>.py`, all under the benchmark's folder. Adding a
cell, a configuration, a mix or a metric is adding files and entries;
nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Dict, List

BENCH = Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


class SpecError(ValueError):
    pass


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def names(bench: Dict) -> List[str]:
    """Every name the contract restricts: cells, configurations, metrics,
    a cell's config and traffic, each key in `reduced`."""
    out = []
    for c in bench["configs"]:
        out += [c["name"]] + list(c["reduced"])
    for w in bench["workloads"]:
        out += [w["name"], w["config"], w["traffic"]]
    out += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    return out


def reports(bench: Dict, cell: str) -> List[str]:
    """The end-to-end metrics cell `cell` reports."""
    return [m["name"] for m in bench["end_to_end"]
            if cell in m.get("workloads", [w["name"]
                                           for w in bench["workloads"]])]


def per_layer_of(bench: Dict, cell: str) -> List[Dict]:
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [w["name"]
                                           for w in bench["workloads"]])]


def validate(bench: Dict, root: Path) -> None:
    """Refuse a benchmark whose names, units, files or metric links break
    the rules the harness relies on."""
    bench_dir = root / bench["paths"][0]
    for n in names(bench):
        if not NAME.match(n):
            raise SpecError(f"name {n!r}: letters, digits, _ . - only, at "
                            f"most 64, not starting with . or -")
    for m in bench["end_to_end"] + bench["per_layer"]:
        if not UNIT.match(m["unit"]):
            raise SpecError(f"metric {m['name']}: unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            raise SpecError(f"metric {m['name']}: better {m['better']!r}")
        if m["source"] not in SOURCES:
            raise SpecError(f"metric {m['name']}: source {m['source']!r}")
    e2e = {m["name"] for m in bench["end_to_end"]}
    if "setup_s" not in e2e:
        raise SpecError("no setup_s among the end-to-end metrics")
    configs = {c["name"]: c for c in bench["configs"]}
    cells = {w["name"]: w for w in bench["workloads"]}
    for c in configs.values():
        f = root / c["file"]
        if not f.is_file():
            raise SpecError(f"configuration {c['name']}: no file {f}")
        conf = load_json(f)
        if not (bench_dir / "reference" / f"{conf['reference']}.py").is_file():
            raise SpecError(f"configuration {c['name']}: no reference "
                            f"{conf['reference']}")
    for w in cells.values():
        if w["config"] not in configs:
            raise SpecError(f"cell {w['name']}: no configuration "
                            f"{w['config']}")
        if not (bench_dir / "traffic" / f"{w['traffic']}.json").is_file():
            raise SpecError(f"cell {w['name']}: no traffic {w['traffic']}")
        got = reports(bench, w["name"])
        if "setup_s" not in got or len(got) < 2:
            raise SpecError(f"cell {w['name']} reports {got}: setup_s and "
                            f"at least one other end-to-end metric")
        if not per_layer_of(bench, w["name"]):
            raise SpecError(f"cell {w['name']} reports no per-layer metric")
    for m in bench["per_layer"]:
        if m["moves"] not in e2e:
            raise SpecError(f"per-layer metric {m['name']} moves "
                            f"{m['moves']!r}, not an end-to-end metric")
        for cell in m.get("workloads", cells):
            if cell not in cells:
                raise SpecError(f"per-layer metric {m['name']}: no cell "
                                f"{cell}")
            if m["moves"] not in reports(bench, cell):
                raise SpecError(
                    f"per-layer metric {m['name']} moves {m['moves']}, "
                    f"which cell {cell} does not report")
        if not (bench_dir / "metrics" / f"{m['name']}.py").is_file():
            raise SpecError(f"per-layer metric {m['name']}: no reader")


def find_cell(bench: Dict, root: Path, name: str) -> Dict:
    """The cell's entry with its configuration's file and its traffic mix
    loaded: {"cell", "config", "conf", "mix"}."""
    validate(bench, root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SpecError(f"no cell {name!r}; cells: {sorted(cells)}")
    cell = cells[name]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    bench_dir = root / bench["paths"][0]
    return {"cell": cell, "config": config,
            "conf": load_json(root / config["file"]),
            "mix": load_json(bench_dir / "traffic" / f"{cell['traffic']}.json")}


def reader(root: Path, bench: Dict, metric: str):
    """The `read(ctx)` function of a per-layer metric's reader."""
    path = root / bench["paths"][0] / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + re.sub(r"\W", "_", metric), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
