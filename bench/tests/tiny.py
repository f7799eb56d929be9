"""A tiny cell for the CPU tests: a copy of the benchmark under a
temporary root with one more configuration, mix and cell, run through the
harness on the CPU at a size a test can hold (the harness's look for a
card is skipped; everything after it runs)."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

from bench.harness import spec

ROOT = Path(__file__).resolve().parents[2]

TINY_MODEL = {
    "name": "tiny-dense", "family": "dense", "n_layers": 4, "d_model": 64,
    "n_heads": 4, "n_kv_heads": 2, "head_dim": 16, "d_ff": 128,
    "vocab_size": 500, "activation": "silu", "gated_mlp": True,
    "norm": "rmsnorm", "block_pattern": ["attn_global"], "qk_norm": True,
    "rope_theta": 10000.0, "tie_embeddings": False, "dtype": "float32"}

TINY_CONF = {
    "name": "tiny-dense", "source": "test", "reduced": [], "assumed": [],
    "model": TINY_MODEL,
    "deployment": {"roles": ["prefill", "decode", "decode"],
                   "n_slots": {"prefill": 1, "decode": 4}, "max_ctx": 512},
    "engine": {"attention_impl": "cuda", "cuda_graphs": True,
               "link_bw_bytes_s": 25e9, "max_decode_chunk": 32,
               "rotation": True, "rotation_min_chunk": 16,
               "strict_accounting": False},
    "reference": "dense",
    "check": {"min_served_tokens": 400, "max_conversations": 10,
              "max_miss_share": 0.01}}

TINY_MIX = {
    "arrival": "poisson", "rate_conv_per_s": 40.0, "n_conversations": 40,
    "shape_seed": 0, "fill_s": 0.05,
    "generator": {"first_input_median": 96.0, "first_input_max": 200,
                  "append_median": 16.0, "append_max": 48,
                  "output_median": 6.0, "output_max": 24,
                  "mean_turns": 3.0, "max_turns": 5, "tool_mean_s": 0.02},
    "serving": {"scheduler": "conserve", "prefix_pool_tokens": 0,
                "kv_cache_dtype": ""}}


def copy_root(tmp: Path, conf=None, mix=None, metric=None, cell="tiny.mix",
              moves="turn_ttft_p95_s") -> Path:
    """A checkout-like root under `tmp`: BENCHMARK.json and the benchmark's
    folder, plus a tiny configuration, mix, cell and (optionally) one more
    per-layer metric with its reader's source — all as new files."""
    root = tmp / "root"
    shutil.copytree(ROOT / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (root / "bench/configs/tiny-dense.json").write_text(
        json.dumps(conf or TINY_CONF))
    (root / "bench/traffic/tiny-mix.json").write_text(json.dumps(mix or TINY_MIX))
    bench["configs"].append({"name": "tiny-dense", "source": "test",
                             "file": "bench/configs/tiny-dense.json",
                             "reduced": [], "why": "CPU test"})
    bench["workloads"].append({"name": cell, "config": "tiny-dense",
                               "traffic": "tiny-mix", "chips": 1,
                               "why": "CPU test"})
    for m in bench["per_layer"]:
        if m["layer"] in ("server and scheduler", "replica", "programs"):
            m["workloads"].append(cell)
    if metric is not None:
        name, source = metric
        (root / f"bench/metrics/{name}.py").write_text(source)
        bench["per_layer"].append({"name": name, "unit": "count",
                                   "better": "higher",
                                   "source": "program_counter",
                                   "layer": "test", "moves": moves,
                                   "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


def run_tiny(root: Path, seed: int = 1234567, seconds: float = 1.0,
             trace: bool = False, cell: str = "tiny.mix"):
    from bench import run
    bench = json.loads((root / "BENCHMARK.json").read_text())
    found = spec.find_cell(bench, root, cell)
    return run.run(found, bench, seed, seconds, trace, "cpu", root=root)
