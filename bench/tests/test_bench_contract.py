"""What the benchmark promises about itself: no module under it loads JAX
or the JAX package (and the references load nothing of the program), every
name and unit in BENCHMARK.json keeps to the contract's characters, and a
new cell, configuration, mix or per-layer metric is added by adding files
only."""
import ast
import json
from pathlib import Path

import pytest
import torch

from bench.harness import spec
from bench.tests import tiny

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[2]
SOURCES = sorted((ROOT / "bench").rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]
        elif (isinstance(node, ast.Call) and node.args
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_sources_are_found():
    names = {p.name for p in SOURCES}
    assert {"run.py", "traffic.py", "counts.py", "dense.py",
            "kernel.k1_roofline.py"} <= names


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_import(path):
    """Whole top-level names: `repro_torch` is not `repro`."""
    bad = set(_imports(path)) & FORBIDDEN
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize(
    "path", sorted((ROOT / "bench" / "reference").rglob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in set(_imports(path))
    assert not {"bench"} & set(_imports(path))


def test_benchmark_names_and_units():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for n in spec.names(bench):
        assert spec.NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert spec.UNIT.match(m["unit"]), m["unit"]
    spec.validate(bench, ROOT)


def test_every_cell_reports_what_the_contract_asks():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        got = spec.reports(bench, w["name"])
        assert "setup_s" in got and len(got) >= 2
        assert spec.per_layer_of(bench, w["name"])


READER = '''"""Test metric: the number of window conversations."""


def read(ctx):
    return float(len(ctx["window"].shapes))
'''


def test_a_cell_of_new_files_is_found_validated_and_run(tmp_path):
    root = tiny.copy_root(tmp_path, metric=("test.window_conversations",
                                            READER))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    found = spec.find_cell(bench, root, "tiny.mix")
    assert found["conf"]["model"]["name"] == "tiny-dense"
    assert found["mix"]["rate_conv_per_s"] == tiny.TINY_MIX["rate_conv_per_s"]
    out = tiny.run_tiny(root, seconds=0.5, trace=True)
    assert out["correct"]
    got = out["metrics"]["test.window_conversations"]
    assert got["value"] == out["attempted"] and got["unit"] == "count"


def test_a_metric_moving_what_its_cell_does_not_report_is_refused(tmp_path):
    root = tiny.copy_root(tmp_path, metric=("test.window_conversations",
                                            READER), moves="ttfet_p95_s")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    spec.validate(bench, root)
    e2e = next(m for m in bench["end_to_end"] if m["name"] == "ttfet_p95_s")
    e2e["workloads"] = [w["name"] for w in bench["workloads"]
                        if w["name"] != "tiny.mix"]
    with pytest.raises(spec.SpecError, match="does not report"):
        spec.validate(bench, root)


def test_a_cell_without_its_files_is_refused(tmp_path):
    root = tiny.copy_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    (root / "bench/traffic/tiny-mix.json").unlink()
    with pytest.raises(spec.SpecError, match="no traffic"):
        spec.find_cell(bench, root, "tiny.mix")
    bench["workloads"][-1]["name"] = "tiny mix"
    with pytest.raises(spec.SpecError, match="name"):
        spec.validate(bench, root)
