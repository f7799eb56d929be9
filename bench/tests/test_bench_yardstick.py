"""The frozen yardstick: the traffic generator against the program's, the
percentile arithmetic against the program's, the operation and byte
counts against hand sums, and the client's view of a served run against
the server's own records."""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from bench.harness import counts, profile, stats, traffic
from bench.tests import tiny

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[2]
MIXES = sorted((ROOT / "bench" / "traffic").glob("*.json"))


@pytest.mark.parametrize("mix", MIXES, ids=lambda p: p.stem)
def test_generator_draws_as_trace_config(mix):
    from repro_torch.traces import TraceConfig, generate_trace
    p = json.loads(mix.read_text())
    n = 60
    ours = traffic.draw_trace(n, p["rate_conv_per_s"], p["generator"],
                              p["shape_seed"])
    theirs = generate_trace(n, p["rate_conv_per_s"],
                            TraceConfig(seed=p["shape_seed"],
                                        **p["generator"]))
    for a, b in zip(ours, theirs):
        assert a.arrival_s == b.arrival_s
        assert a.turns == [(t.append_tokens, t.output_tokens, t.tool_time_s)
                           for t in b.turns]
        assert (a.preamble_id, a.preamble_tokens) == (b.preamble_id,
                                                      b.preamble_tokens)


def test_defaults_are_trace_config_defaults():
    from repro_torch.traces import TraceConfig
    tc = TraceConfig()
    assert traffic.GENERATOR_DEFAULTS == {
        k: getattr(tc, k) for k in traffic.GENERATOR_DEFAULTS}


def test_cut_ends_at_the_last_turn_that_fits():
    s = traffic.Shape(0, 0.0, [(100, 10, 1.0), (50, 5, 2.0), (80, 20, 3.0),
                               (10, 1, 0.0)])
    cut, was = traffic.cut_to_ctx(s, 170)
    assert was and cut.turns == [(100, 10, 1.0), (50, 5, 0.0)]
    same, was = traffic.cut_to_ctx(s, 276)
    assert not was and same.turns == s.turns
    with pytest.raises(ValueError):
        traffic.cut_to_ctx(s, 100)


def test_every_seed_serves_the_same_work():
    """The traffic does not depend on the run seed (it makes the tokens
    and the weights): the same shapes at the same arrivals, cut alike."""
    for mix in MIXES:
        p = json.loads(mix.read_text())
        a, cut = traffic.build(p, 32768)
        b, _ = traffic.build(p, 32768)
        assert [(s.arrival_s, s.turns) for s in a] == [
            (s.arrival_s, s.turns) for s in b]
        assert all(s.context_after(len(s.turns) - 1) <= 32768 for s in a)
        assert cut == sum(len(s.turns) < len(t.turns) for s, t in zip(
            a, traffic.draw_trace(p["n_conversations"],
                                  p["rate_conv_per_s"], p["generator"],
                                  p["shape_seed"])))


def test_percentiles_are_the_programs():
    from repro_torch.core import metrics
    xs = list(np.random.default_rng(0).lognormal(size=37))
    assert stats.p95(xs) == metrics.p95(xs)
    assert stats.gmean(xs) == metrics.gmean(xs)


M = {"n_layers": 2, "d_model": 8, "n_heads": 4, "n_kv_heads": 2,
     "head_dim": 2, "d_ff": 16, "vocab_size": 10, "gated_mlp": True,
     "qk_norm": True, "dtype": "bfloat16"}


def test_counts_against_hand_sums():
    # layer matrices: q 8x8, k 8x4, v 8x4, o 8x8, MLP 3 x 8x16
    assert counts.layer_matmul_params(M) == 64 + 32 + 32 + 64 + 384
    # weights: 2 layers x (576 + 2 norms of 8 + 2 qk scales of 2), final
    # norm 8, tied head 10 x 8; 2 bytes each
    assert counts.weight_bytes(M) == 2 * (2 * (576 + 16 + 4) + 8 + 80)
    # KV: 2 layers x 2 heads x 2 dims x K,V x 2 bytes
    assert counts.kv_bytes_per_token(M) == 32
    # K2 at s = 3: 6 causal pairs x 4 heads x (2 + 2 mults x 2 dims) FLOPs
    assert counts.k2_flops(M, 3) == 6 * 4 * 2 * 2 * 2
    # q, o: 3 x 4 x 2; k, v: 3 x 2 x 2; 2 bytes
    assert counts.k2_bytes(M, 3) == 2 * (24 + 24 + 12 + 12)
    # K1, slots of 5 and 7 keys: 12 keys x 4 heads x 2 dims x 4
    assert counts.k1_flops(M, [5, 7]) == 12 * 4 * 2 * 4
    # 12 rows of K and V (2 heads x 2 dims, 2 bytes), q and o of each slot
    assert counts.k1_bytes(M, [5, 7]) == 12 * 2 * 4 * 2 + 2 * (2 * 8 * 2)
    # prefill of 3: matrices 2 layers x 3 tokens x 2 x 576, K2 in both
    # layers, the head once at 2 x 8 x 10
    assert counts.prefill_flops(M, 3) == 2 * 3 * 2 * 576 + 2 * 192 + 160
    f, b = counts.decode_step_counts(M, [5, 7])
    assert f == 2 * (2 * 2 * 576 + 160) + 2 * 384
    # the weights once, both layers' K1 bytes, a new K/V row per slot
    assert b == counts.weight_bytes(M) + 2 * (192 + 64) + 2 * 32
    pk = {"bf16_flops": 10.0, "hbm_bytes_s": 100.0}
    assert counts.bound_s(50.0, 100.0, pk) == 5.0
    assert counts.bound_s(5.0, 1000.0, pk) == 10.0


def test_live_steps_of_a_ragged_chunk():
    steps = list(counts.live_steps(np.array([10, 20, 30]),
                                   np.array([True, False, True]),
                                   np.array([2, 4, 3])))
    assert steps == [[11, 31], [12, 32], [33]]


def test_a_calls_device_time_is_the_union_of_its_kernels():
    """Overlapping kernels count once, the gaps inside a call not at all,
    and a kernel outside every range of that name not at all."""
    tr = profile.Trace(
        window_s=1.0,
        kernels=[("k1", 0.10, 0.14), ("k2", 0.12, 0.16), ("k3", 0.20, 0.21),
                 ("k4", 0.40, 0.45), ("k5", 0.60, 0.62)],
        ranges=[("bench.decode", 0.09, 0.25), ("bench.prefill", 0.39, 0.50)])
    n, s = tr.calls_busy_s("decode")
    assert n == 1 and s == pytest.approx(0.07)
    n, s = tr.calls_busy_s("prefill")
    assert n == 1 and s == pytest.approx(0.05)
    assert tr.calls_busy_s("append") == (0, 0.0)
    assert tr.busy_s() == pytest.approx(0.06 + 0.01 + 0.05 + 0.02)


def test_client_view_equals_server_records(tmp_path, monkeypatch):
    """The end-to-end latencies the benchmark reads from the token stream
    equal the ones the server records for the same conversations. One
    difference is by design: the client's first turn is runnable when the
    conversation arrives (its wait, prefill and transfer count), where the
    server's record starts it once the turn is ready to decode."""
    from bench.harness import drive
    seen = {}
    real = drive.serve

    def spy(srv, reps, shapes, *a, **kw):
        w = real(srv, reps, shapes, *a, **kw)
        srv.run_pending()   # the records' last finish events
        client = a[3]
        seen["pairs"] = [(client.timeline(s), srv.records[s.cid])
                         for s in w.shapes if client.finished(s)]
        return w
    monkeypatch.setattr(drive, "serve", spy)
    root = tiny.copy_root(tmp_path)
    out = tiny.run_tiny(root, seconds=0.5)
    assert out["correct"] and seen["pairs"]
    for mine, rec in seen["pairs"]:
        assert len(mine["turns"]) == len(rec.turns)
        assert mine["turns"][0]["arrival_s"] == rec.arrival_s
        for i, (a, b) in enumerate(zip(mine["turns"], rec.turns)):
            if i:
                assert a["arrival_s"] == pytest.approx(b.arrival_s, abs=1e-9)
            assert a["first_token_s"] == pytest.approx(b.first_token_s,
                                                       abs=1e-9)
            assert a["last_token_s"] == pytest.approx(b.last_token_s,
                                                      abs=1e-9)
    ours = stats.conversation_metrics([p[0] for p in seen["pairs"]])
    from repro_torch.core.metrics import summarize
    theirs = summarize([p[1] for p in seen["pairs"]])
    assert ours["ttfet_p95_s"] == pytest.approx(theirs["ttfet_p95"])
    assert ours["last_tbt_p95_ms"] == pytest.approx(
        1e3 * theirs["last_tbt_p95"])


def test_shape_is_plain_data():
    s = traffic.Shape(3, 1.5, [(10, 2, 0.5), (4, 1, 0.0)])
    assert s.output_tokens == 3 and s.context_after(1) == 17
    assert dataclasses.replace(s, cid=4).turns == s.turns


def test_profiled_sub_window_holds_a_decode_call(tmp_path, monkeypatch):
    """A profiled sub-window that a run of prefills and appends would fill
    lasts on until it holds PROFILE_DECODES whole decode calls, so the
    decode readers always find more than one chunk to read."""
    from bench import run
    from bench.harness import drive
    seen = {}
    real = drive.serve

    def spy(*a, **kw):
        w = real(*a, **kw)
        seen["n"] = dict(a[7].n_profiled)
        seen["profile_s"] = w.profile_s
        return w
    monkeypatch.setattr(drive, "serve", spy)
    monkeypatch.setattr(run, "PROFILE_S", 0.0)
    root = tiny.copy_root(tmp_path)
    out = tiny.run_tiny(root, seconds=0.5, trace=True)
    assert out["correct"] and seen["profile_s"] > 0
    assert seen["n"].get("prefill", 0) >= 1
    assert seen["n"].get("decode", 0) >= run.PROFILE_DECODES
