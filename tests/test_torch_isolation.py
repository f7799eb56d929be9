"""The port stands alone: no module of `src/repro_torch` and not
`chip_smoke.py` imports JAX or the JAX package `repro` (it keeps its own
copies of the numpy-only modules it needs), and importing the serving
entry points pulls neither into the process."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _bad(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


def test_port_sources_are_found():
    names = {p.name for p in FILES}
    assert {"replica.py", "server.py", "decode_attention.py",
            "prefill_attention.py", "wkv6.py", "rglru.py", "recurrent.py",
            "recurrentgemma_9b.py", "chip_smoke.py", "baselines.py",
            "simulator.py", "gateway.py", "driver.py", "encdec.py",
            "internvl2_26b.py", "whisper_small.py", "shapes.py",
            "sharding.py", "mesh.py", "specs.py", "dryrun.py", "reprobe.py",
            "train.py"} <= names
    assert len(FILES) > 25


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    bad = [(ln, m) for ln, m in _imports(path) if _bad(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_entry_points_import_without_jax_or_repro():
    code = ("import sys\n"
            "import repro_torch.engine, repro_torch.launch.serve\n"
            "import repro_torch.kernels.ops, repro_torch.traces\n"
            "import repro_torch.cluster, repro_torch.serve, repro_torch.chaos\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.train\n"
            "import repro_torch.launch.specs, repro_torch.launch.reprobe\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       env={"PYTHONPATH": str(ROOT / "src"),
                            "PATH": "/usr/bin:/bin"},
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
