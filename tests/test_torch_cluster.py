"""The port's copies of the numpy-only serving modules: the paper's
baselines, the cluster simulator, the live gateway and the chaos harness.

Each copy's text equals its JAX-package file with `repro.` rewritten to
`repro_torch.` on import lines, apart from an explicit list of lines, each
with its reason. The port's simulator gives summaries and per-conversation
records exactly equal to the reference's for the four evaluated systems;
its chaos run equals the reference's on one seeded schedule; the launcher's
`--sim` modes print the reference's lines; and one policy class drives the
port's simulator and the port's engine."""
import dataclasses
import importlib
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import make_scheduler  # noqa: E402
from torch_support import one_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"

COPIED = ["core/baselines.py",
          "cluster/__init__.py", "cluster/hardware.py",
          "cluster/simulator.py", "cluster/deployment.py",
          "cluster/elastic.py",
          "serve/__init__.py", "serve/gateway.py", "serve/client.py",
          "chaos/__init__.py", "chaos/schedule.py", "chaos/invariants.py",
          "chaos/driver.py", "train/data.py", "configs/shapes.py"]

# (reference lines removed, port lines added) per file, beyond the import
# rewrite, each with its reason.
NO_TPU = "no number taken on or for a TPU goes into the port"
ALLOWED = {
    "cluster/hardware.py": (
        ["Two model families:",
         "  * `TPUv5eTier` — the TPU adaptation (197 TFLOP/s bf16, 819 GB/s "
         "HBM,",
         "    ~50 GB/s/link ICI) used by the roofline analysis and the "
         "heterogeneous",
         "    mapping on TPU tiers (DESIGN.md §3).",
         "",
         'TPU_V5E = HardwareTier(name="TPUv5e", peak_flops=197e12, '
         "hbm_bw=819e9,",
         "                       hbm_bytes=16e9, link_bw=50e9, tdp_w=220.0, "
         "idle_w=55.0)",
         "TPU_V5E_CAPPED = TPU_V5E.capped(150.0)"],
        ["One model family:"],
        NO_TPU),
    "cluster/__init__.py": (
        ["from .hardware import (A40, A40_CAPPED, TPU_V5E, TPU_V5E_CAPPED, "
         "HardwareTier,",
         "                       NodeCostModel, ServedModelProfile)"],
        ["from .hardware import (A40, A40_CAPPED, HardwareTier, "
         "NodeCostModel,",
         "                       ServedModelProfile)"],
        NO_TPU),
    "cluster/simulator.py": (
        ["*placement* decision to a `repro.core.Scheduler` through the "
         "observable",
         "`ClusterView` only. The same scheduler classes drive the real JAX "
         "engine",
         "(`repro.engine`), so policy code is exercised identically at both "
         "scales."],
        ["*placement* decision to a `repro_torch.core.Scheduler` through the "
         "observable",
         "`ClusterView` only. The same scheduler classes drive the port's "
         "engine",
         "(`repro_torch.engine`), so policy code is exercised identically at "
         "both scales."],
        "the docstring names the port's package and engine"),
    "serve/gateway.py": (
        ["(`repro.core.events`) whose hooks fire from the runtime's own "
         "transition"],
        ["(`repro_torch.core.events`) whose hooks fire from the runtime's "
         "own transition"],
        "the docstring names the port's package"),
}

_IMPORT = re.compile(r"^(\s*)(from|import) repro\.")


def _rewrite_imports(text):
    return [_IMPORT.sub(r"\1\2 repro_torch.", ln) for ln in text.splitlines()]


def _line_diff(ref_lines, port_lines):
    import difflib
    removed, added = [], []
    sm = difflib.SequenceMatcher(a=ref_lines, b=port_lines, autojunk=False)
    for op, i1, i2, j1, j2 in sm.get_opcodes():
        if op != "equal":
            removed += ref_lines[i1:i2]
            added += port_lines[j1:j2]
    return removed, added


@pytest.mark.parametrize("rel", COPIED)
def test_copy_equals_reference_but_for_listed_lines(rel):
    ref = _rewrite_imports((REF / rel).read_text())
    port = (PORT / rel).read_text().splitlines()
    removed, added, _reason = ALLOWED.get(rel, ([], [], None))
    assert _line_diff(ref, port) == (removed, added)


def test_core_exports_the_baselines():
    from repro_torch.core import (SCHEDULERS, AMPDScheduler,
                                  CollocatedScheduler, FullDisaggScheduler)
    assert {"collocated", "full_disagg", "ampd"} <= set(SCHEDULERS)
    assert isinstance(make_scheduler("ampd"), AMPDScheduler)
    assert isinstance(make_scheduler("collocated"), CollocatedScheduler)
    assert isinstance(make_scheduler("full_disagg"), FullDisaggScheduler)
    import repro_torch.cluster as cl
    assert not any("TPU" in n for n in dir(cl))


def _dump(x):
    """Exact, NaN-safe comparison form (floats by repr)."""
    return json.dumps(x, sort_keys=True, default=str)


def _pkg(name):
    return {m: importlib.import_module(f"{name}.{m}")
            for m in ("cluster", "traces", "core.metrics", "chaos",
                      "core")}


@pytest.mark.parametrize("system",
                         ["conserve", "ampd", "full_disagg", "collocated"])
def test_paper_deployment_equals_reference_exactly(system):
    out = []
    for name in ("repro", "repro_torch"):
        m = _pkg(name)
        trace = m["traces"].generate_trace(
            40, 1.634, m["traces"].TraceConfig(seed=17))
        sim = m["cluster"].paper_deployment(system)
        recs = sim.serve(trace)
        out.append((m["core.metrics"].summarize(recs),
                    [dataclasses.asdict(r) for r in recs],
                    sorted((k, n.energy_j) for k, n in sim.nodes.items())))
    assert len(out[1][1]) == 40
    assert _dump(out[1][0]) == _dump(out[0][0])
    assert _dump(out[1][1]) == _dump(out[0][1])
    assert _dump(out[1][2]) == _dump(out[0][2])


def _sim_chaos(name, n_convs=12, seed=20260807):
    """The chaos soak's simulator half, built from one package only."""
    m = _pkg(name)
    ch, tr = m["chaos"], m["traces"]
    deadline = 6.0

    def mk(**kw):
        return m["cluster"].build_cluster(
            m["core"].make_scheduler("conserve"), n_prefill=1, n_decode=3,
            strict_accounting=True, **kw)

    schedule = ch.generate_chaos_schedule(
        seed + 1, [1, 2, 3], kill_frac_range=(0.06, 0.12),
        rejoin_delay_frac_range=(0.08, 0.14),
        slowdown_start_range=(0.28, 0.36), slowdown_len_range=(0.18, 0.28),
        slowdown_factor_range=(8.0, 12.0), transfer_frac_range=(0.15, 0.55))
    half = n_convs // 2
    first = ch.apply_tool_timeouts(
        tr.make_scenario("shared_preamble_fleet", half, seed=2,
                         scale="paper")
        + tr.make_scenario("pareto_burst", n_convs - half, seed=7,
                           scale="paper", cid_offset=1000,
                           arrival_offset_s=0.05),
        schedule, deadline)
    w2 = tr.make_scenario("pareto_burst", 3, seed=13, scale="paper",
                          cid_offset=9000)
    w3 = tr.make_scenario("pareto_burst", 3, seed=17, scale="paper",
                          cid_offset=9500)
    everyone = first + w2 + w3
    base_recs = mk().serve(everyone)
    span = max(t.last_token_s for r in base_recs for t in r.turns)
    base_counts = {(r.cid, i): t.n_output_tokens
                   for r in base_recs for i, t in enumerate(r.turns)}
    sim = mk(tool_deadline_s=deadline, tool_timeout_action="evict",
             quarantine_k=3.0, quarantine_window=2)
    ch.arm_schedule(sim, schedule, span)
    res = ch.run_chaos(sim, first, schedule, span, second_wave=w2,
                       quarantine_wave=w3)
    counts = {k: sum(v) for k, v in res.gateway.streams.items()}
    evidence = ch.check_chaos_invariants(
        res.records, res.gateway, res.monitor, schedule, everyone,
        base_counts, streams=counts, require_quarantine=False)
    sim.check_accounting()
    recs = sorted((dataclasses.asdict(r) for r in res.records),
                  key=lambda r: r["cid"])
    return schedule.digest, res.gateway.streams, recs, evidence


def test_sim_chaos_run_equals_reference():
    ref = _sim_chaos("repro")
    port = _sim_chaos("repro_torch")
    assert port[0] == ref[0]
    assert port[1] == ref[1] and len(port[1]) > 12
    assert _dump(port[2]) == _dump(ref[2])
    assert _dump(port[3]) == _dump(ref[3])
    assert port[3]["n_failures"] >= 1 and port[3]["n_joins"] >= 1


@pytest.mark.parametrize("flags", [
    ["--sim"],
    ["--sim", "--scheduler", "ampd"],
    ["--sim", "--scenario", "pareto_burst", "--seed", "3"],
    ["--sim", "--scheduler", "full_disagg", "--gateway"],
], ids=lambda f: "_".join(x.lstrip("-") for x in f))
def test_launcher_sim_prints_the_reference_lines(flags):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    outs = []
    for mod in ("repro.launch.serve", "repro_torch.launch.serve"):
        r = subprocess.run([sys.executable, "-m", mod, *flags], cwd=ROOT,
                           env=env, capture_output=True, text=True,
                           timeout=120)
        assert r.returncode == 0, r.stderr
        outs.append(r.stdout)
    assert "ttfet_p95" in outs[1]
    assert outs[1] == outs[0]


def test_launcher_refuses_the_mesh_mode(monkeypatch, capsys):
    """The launcher no longer refuses the mode without --engine or --sim:
    it dry-runs prefill_32k and decode_32k on the production mesh and
    prints each per-device memory record (here on the meta device, on the
    reduced config with the shapes cut: the published prefill_32k takes
    minutes to trace on a CPU). --device cpu is refused."""
    import torch.distributed as dist
    from repro_torch.configs import ShapeSpec, get_reduced, shapes
    from repro_torch.launch import specs
    from repro_torch.launch.serve import main
    monkeypatch.setitem(shapes.SHAPES, "prefill_32k",
                        ShapeSpec("prefill_32k", 64, 32, "prefill"))
    monkeypatch.setitem(shapes.SHAPES, "decode_32k",
                        ShapeSpec("decode_32k", 128, 32, "decode"))
    monkeypatch.setattr(specs, "get_config", get_reduced)
    main(["--arch", "qwen3-0.6b", "--device", "meta"])
    out = capsys.readouterr().out
    for name in ("prefill_32k", "decode_32k"):
        assert f"{name}: traced OK on (16, 16); {{'argument_bytes'" in out
    assert not dist.is_initialized()
    with pytest.raises(SystemExit):
        main(["--arch", "qwen3-0.6b", "--device", "cpu"])


def test_same_policy_class_drives_sim_and_engine():
    """tests/test_system.py's cross-layer contract on the port: one
    scheduler implementation serves the port's simulator and the port's
    engine, each completing with exactly one transfer a conversation."""
    from repro_torch.cluster import paper_deployment
    from repro_torch.configs import get_reduced
    from repro_torch.core.conserve import ConServeScheduler
    from repro_torch.engine import EngineServer, ReplicaEngine
    from repro_torch.models import build_model
    from repro_torch.traces import TraceConfig, generate_trace

    tc = TraceConfig(first_input_median=60, first_input_sigma=0.2,
                     first_input_max=120, append_median=12,
                     append_sigma=0.3, append_max=24, output_median=5,
                     output_sigma=0.4, output_max=10, mean_turns=2.0,
                     max_turns=3, tool_mean_s=0.01)
    trace = generate_trace(4, 5.0, cfg=tc)

    sim = paper_deployment("conserve")
    sim.submit(trace).run()
    sim_recs = sim.results()

    cfg = get_reduced("qwen3-0.6b")
    params = build_model(cfg).init(0, "cpu")
    reps = [ReplicaEngine(cfg, params, n_slots=6, max_ctx=256, replica_id=0,
                          role="prefill"),
            ReplicaEngine(cfg, params, n_slots=6, max_ctx=256, replica_id=1),
            ReplicaEngine(cfg, params, n_slots=6, max_ctx=256, replica_id=2)]
    srv = EngineServer(make_scheduler("conserve"), reps)
    eng_recs = srv.serve(trace)

    assert type(sim.sched) is type(srv.sched) is ConServeScheduler
    assert len(sim_recs) == len(eng_recs) == 4
    assert all(r.n_kv_transfers == 1 for r in sim_recs)
    assert all(r.n_kv_transfers == 1 for r in eng_recs)
    assert all(r.n_remote_turns == 0 for r in sim_recs + eng_recs)


@pytest.mark.parametrize("flags,want", [
    (["--scheduler", "collocated"], "kv_transfers_per_conv: 0.0000"),
    (["--scheduler", "full_disagg", "--scenario", "pareto_burst",
      "--gateway"], "gateway: 3 submitted, 3 done, 0 shed"),
], ids=["collocated", "full_disagg_scenario_gateway"])
def test_launcher_engine_modes_serve_on_cpu(capsys, flags, want):
    """`--engine` builds three mixed replicas for collocated and serves a
    named scenario live through the gateway."""
    from repro_torch.launch.serve import main
    main(["--engine", "--device", "cpu", "--n-conversations", "3",
          "--slots", "4", *flags])
    assert want in capsys.readouterr().out
