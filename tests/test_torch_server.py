"""The port's serving loop (`repro_torch.engine.EngineServer` + ConServe):
the golden-trace summary read exactly from tests/golden, per-(cid, turn)
token streams equal to the JAX package's `EngineServer` on one trace with
converted weights, the one-shot KV transfer under strict accounting, the
stream invariants across rotation and prefill modes, the launcher, and the
port's copy of the trace generator."""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.core import make_scheduler as jax_make_scheduler  # noqa: E402
from repro.engine import EngineServer as JaxServer  # noqa: E402
from repro.engine import ReplicaEngine as JaxReplica  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.traces import TraceConfig as JaxTraceConfig  # noqa: E402
from repro.traces import generate_trace as jax_generate_trace  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core import make_scheduler  # noqa: E402
from repro_torch.core.metrics import summarize  # noqa: E402
from repro_torch.engine import EngineServer, ReplicaEngine  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.traces import TraceConfig, generate_trace  # noqa: E402

GOLDEN = Path(__file__).parent / "golden" / "decode_golden_trace.json"
SMALL = dict(seed=3, first_input_median=40, first_input_sigma=0.3,
             first_input_max=60, append_median=10, append_sigma=0.3,
             append_max=20, output_median=5, output_sigma=0.5, output_max=8,
             mean_turns=2.0, max_turns=3, tool_mean_s=0.01)


@pytest.fixture(scope="module")
def qwen():
    cfg = get_reduced("qwen3-0.6b")
    return cfg, build_model(cfg).init(0, "cpu")


def _streams(srv):
    return {k: [int(t) for t in v] for k, v in srv.sampled_tokens.items()}


def test_golden_trace_summary_matches_exactly(qwen):
    """tests/test_golden_trace.py's setup on the port: one mixed replica,
    packed arrivals, zero tool time. The summary does not depend on token
    content, so it must equal the checked-in golden file exactly."""
    cfg, params = qwen
    rep = ReplicaEngine(cfg, params, n_slots=8, max_ctx=256, replica_id=0,
                        role="mixed")
    srv = EngineServer(make_scheduler("conserve"), [rep], decode_mode="fused",
                       record_tokens=True, strict_accounting=True)
    finish_order = []
    orig = srv._finish_turn

    def spy(task, t):
        finish_order.append([task.conv.cid, task.turn_idx])
        return orig(task, t)

    srv._finish_turn = spy
    trace_cfg = TraceConfig(seed=7, first_input_median=40,
                            first_input_sigma=0.3, first_input_max=80,
                            append_median=10, append_sigma=0.3,
                            append_max=20, output_median=6,
                            output_sigma=0.8, output_max=20, mean_turns=2.0,
                            max_turns=3, tool_mean_s=0.0)
    trace = generate_trace(5, 1e9, cfg=trace_cfg,
                           arrival_process="saturation")
    recs = {r.cid: r for r in srv.serve(trace)}
    summary = {
        "finish_order": finish_order,
        "conversations": {
            str(cid): {
                "turn_output_tokens": [t.n_output_tokens
                                       for t in recs[cid].turns],
                "turn_order": [t.turn_idx for t in recs[cid].turns],
                "n_kv_transfers": recs[cid].n_kv_transfers,
                "n_remote_turns": recs[cid].n_remote_turns,
            } for cid in sorted(recs)},
        "stream_lengths": {f"{cid}:{turn}": len(toks) for (cid, turn), toks
                           in sorted(srv.sampled_tokens.items())},
    }
    assert summary == json.loads(GOLDEN.read_text())


def test_streams_equal_jax_engine_server_on_converted_weights():
    """1 prefiller + 1 decoder under ConServe, the same trace, weights
    converted from the JAX params in this process: every (cid, turn) token
    stream of the port equals the JAX server's."""
    jcfg = jax_reduced("qwen3-0.6b")
    jp = jax_build(jcfg).init(jax.random.PRNGKey(0))
    cfg = get_reduced("qwen3-0.6b")
    lm = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu")

    jreps = [JaxReplica(jcfg, jp, n_slots=4, max_ctx=256, replica_id=0,
                        role="prefill"),
             JaxReplica(jcfg, jp, n_slots=4, max_ctx=256, replica_id=1)]
    jsrv = JaxServer(jax_make_scheduler("conserve"), jreps,
                     record_tokens=True, strict_accounting=True)
    jsrv.serve(jax_generate_trace(4, 3.0, cfg=JaxTraceConfig(**SMALL)))

    reps = [ReplicaEngine(cfg, lm, n_slots=4, max_ctx=256, replica_id=0,
                          role="prefill"),
            ReplicaEngine(cfg, lm, n_slots=4, max_ctx=256, replica_id=1)]
    srv = EngineServer(make_scheduler("conserve"), reps, record_tokens=True,
                       strict_accounting=True)
    recs = srv.serve(generate_trace(4, 3.0, cfg=TraceConfig(**SMALL)))
    assert len(recs) == 4 and len(srv.sampled_tokens) >= 4
    assert _streams(srv) == _streams(jsrv)
    assert srv.n_transfers == jsrv.n_transfers == 4


def test_conserve_end_to_end_one_shot_transfer(qwen):
    cfg, params = qwen
    tc = TraceConfig(first_input_median=60, first_input_sigma=0.3,
                     first_input_max=150, append_median=16, append_sigma=0.4,
                     append_max=40, output_median=6, output_sigma=0.5,
                     output_max=12, mean_turns=2.5, max_turns=4,
                     tool_mean_s=0.02)
    reps = [ReplicaEngine(cfg, params, n_slots=8, max_ctx=512, replica_id=i,
                          role="prefill" if i == 0 else "decode")
            for i in range(3)]
    srv = EngineServer(make_scheduler("conserve"), reps,
                       strict_accounting=True)
    s = summarize(srv.serve(generate_trace(6, 3.0, cfg=tc)))
    assert s["n_conversations"] == 6
    assert s["kv_transfers_per_conv"] == 1.0
    assert srv.n_transfers == 6
    for r in reps:
        assert not r.kv.active.any() and r.kv.active_kv_tokens == 0
        assert r.n_decode_tokens > 0 or r.role == "prefill"
    for st in srv.states.values():
        assert st.active_conversations == 0


@pytest.mark.parametrize("knob", ["rotation", "prefill_mode", "decode_mode"])
def test_streams_invariant_across_serving_knobs(qwen, knob):
    """Chunk cuts, the prefill path and the decode path decide when work
    runs, never what it computes."""
    cfg, params = qwen
    trace_cfg = TraceConfig(**SMALL)
    alt = {"rotation": {"rotation": False},
           "prefill_mode": {"prefill_mode": "reference"},
           "decode_mode": {"decode_mode": "reference"}}[knob]
    out = []
    for kw in ({}, alt):
        reps = [ReplicaEngine(cfg, params, n_slots=3, max_ctx=256,
                              replica_id=i,
                              role="prefill" if i == 0 else "decode")
                for i in range(2)]
        srv = EngineServer(make_scheduler("conserve"), reps,
                           record_tokens=True, strict_accounting=True, **kw)
        srv.serve(generate_trace(5, 4.0, cfg=trace_cfg))
        out.append(_streams(srv))
    assert out[0] == out[1]


def test_generate_trace_equals_jax_for_a_seed():
    a = jax_generate_trace(12, 2.0, cfg=JaxTraceConfig(seed=11))
    b = generate_trace(12, 2.0, cfg=TraceConfig(seed=11))
    assert [dataclasses.asdict(c) for c in a] == \
        [dataclasses.asdict(c) for c in b]


def test_launcher_engine_mode_serves_on_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--engine", "--device", "cpu", "--n-conversations", "3",
          "--slots", "4"])
    out = capsys.readouterr().out
    assert "kv_transfers_per_conv: 1.0000" in out


def test_launcher_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from repro_torch.launch.serve import main
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--engine", "--n-conversations", "1"])
