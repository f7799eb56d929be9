"""The port's serving engine on rwkv6-3b: fixed-size state leaves in the
slot cache, the exact-length prefill rule, and ConServe end to end.

Mirrors of tests/test_prefill_jit.py (exact length), tests/test_engine.py
(oracle rollout, multi-turn append, transfer), tests/test_decode_fused.py
(ragged chunk vs per-token replay), tests/test_prefix_pool.py (pool on/off)
and the stream check of tests/test_torch_server.py, on
`get_reduced("rwkv6-3b")` weights converted from the JAX params in this
process. Across frameworks greedy tokens and per-(cid, turn) streams must be
equal; within the port, the fast and reference paths and the pool on/off
paths must leave byte-identical state."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.core import make_scheduler as jax_make_scheduler  # noqa: E402
from repro.engine import EngineServer as JaxServer  # noqa: E402
from repro.engine import ReplicaEngine as JaxReplica  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models.model import merge_decode_cache as jax_merge  # noqa: E402
from repro.traces import TraceConfig as JaxTraceConfig  # noqa: E402
from repro.traces import generate_trace as jax_generate_trace  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core import make_scheduler  # noqa: E402
from repro_torch.core.metrics import summarize  # noqa: E402
from repro_torch.engine import EngineServer, ReplicaEngine  # noqa: E402
from repro_torch.engine.kvcache import leaves, prefix_hash  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.traces import TraceConfig, generate_trace  # noqa: E402
from torch_support import one_thread  # noqa: E402,F401

SMALL = dict(seed=5, first_input_median=30, first_input_sigma=0.3,
             first_input_max=50, append_median=8, append_sigma=0.3,
             append_max=16, output_median=4, output_sigma=0.5, output_max=6,
             mean_turns=2.0, max_turns=3, tool_mean_s=0.01)


@pytest.fixture(scope="module")
def rwkv():
    jcfg = jax_reduced("rwkv6-3b")
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = get_reduced("rwkv6-3b")
    lm = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu")
    return cfg, lm, jm, jp, jcfg


def _engine(rwkv, **kw):
    kw.setdefault("n_slots", 3)
    kw.setdefault("max_ctx", 128)
    return ReplicaEngine(rwkv[0], rwkv[1], **kw)


def jax_oracle(jm, jp, vocab, prompt, n_steps):
    """The JAX model's own rollout (tests/test_engine.py::oracle_rollout)."""
    lg, caches = jm.prefill(jp, jnp.asarray(prompt)[None])
    toks = [int(jnp.argmax(lg[0, :vocab]))]
    pos = len(prompt)
    for _ in range(n_steps):
        lg, ups = jm.decode_step(jp, jnp.asarray([toks[-1]]), caches,
                                 jnp.asarray([pos]))
        caches = jax_merge(caches, ups)
        pos += 1
        toks.append(int(jnp.argmax(lg[0, :vocab])))
    return toks


def _state_equal(a, b):
    np.testing.assert_array_equal(a.kv.lengths, b.kv.lengths)
    for (pa, x), (pb, y) in zip(leaves(a.kv.caches), leaves(b.kv.caches)):
        assert pa == pb and torch.equal(x, y), pa


def _row(eng, slot):
    return [t.clone() for _, t in leaves(eng.kv.export_slot_full(slot))]


def _decode(eng, slot, tok, n):
    nt = np.zeros(eng.kv.n_slots, np.int32)
    em = np.zeros(eng.kv.n_slots, bool)
    nt[slot], em[slot] = int(tok), True
    seq, _ = eng.decode_steps(nt, em, n)
    return [int(x) for x in seq[:, slot]]


@pytest.mark.parametrize("mode", ["jit", "reference"])
def test_exact_length_prefill_in_both_modes(rwkv, mode):
    """tests/test_prefill_jit.py::test_exact_prefill_families_fall_back_to_
    reference: 21 tokens run as 21 (never a 32-bucket), in both prefill
    modes, and nothing is compiled on the CPU."""
    eng = _engine(rwkv, prefill_mode=mode)
    seen = []
    orig = eng.model.prefill

    def spy(params, tokens, **kw):
        seen.append(tuple(tokens.shape))
        return orig(params, tokens, **kw)

    eng.model.prefill = spy
    s = eng.kv.acquire()
    eng.prefill_conversation(s, np.arange(5, 26, dtype=np.int32))
    eng.append_prefill(s, np.arange(40, 47, dtype=np.int32))
    assert seen == [(1, 21), (1, 7)]
    assert int(eng.kv.lengths[s]) == 28
    assert eng.exact_prefill and eng.compile_s == 0.0


@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_engine_matches_jax_oracle(rwkv, impl):
    cfg, lm, jm, jp, _ = rwkv
    eng = _engine(rwkv, attention_impl=impl)
    s = eng.kv.acquire()
    prompt = np.arange(11, 48, dtype=np.int32)
    tok, _ = eng.prefill_conversation(s, prompt)
    assert [int(tok)] + _decode(eng, s, tok, 6) == \
        jax_oracle(jm, jp, cfg.vocab_size, prompt, 6)


def test_multiturn_append_matches_jax_full_prefill(rwkv):
    cfg, lm, jm, jp, _ = rwkv
    eng = _engine(rwkv)
    s = eng.kv.acquire()
    t1 = np.arange(5, 30, dtype=np.int32)
    app = np.arange(100, 117, dtype=np.int32)
    eng.prefill_conversation(s, t1)
    tok2, _ = eng.append_prefill(s, app)
    lg, _ = jm.prefill(jp, jnp.asarray(np.concatenate([t1, app]))[None])
    assert int(tok2) == int(jnp.argmax(lg[0, :cfg.vocab_size]))
    assert int(eng.kv.lengths[s]) == 42


@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_fast_and_reference_prefill_leave_byte_identical_state(rwkv, impl):
    """Turn-1 + two appends + a decode chunk: identical tokens and
    byte-identical state, and the fast path never reads the full-buffer
    view."""
    out, engs, calls = {}, {}, {}
    for mode in ("jit", "reference"):
        eng = engs[mode] = _engine(rwkv, prefill_mode=mode,
                                   attention_impl=impl)
        calls[mode] = 0
        orig = eng.kv.export_slot_full

        def spy(slot, mode=mode, orig=orig):
            calls[mode] += 1
            return orig(slot)

        eng.kv.export_slot_full = spy
        s = eng.kv.acquire()
        t1, _ = eng.prefill_conversation(s, np.arange(5, 50, dtype=np.int32))
        t2, _ = eng.append_prefill(s, np.arange(100, 131, dtype=np.int32))
        t3, _ = eng.append_prefill(s, np.arange(200, 215, dtype=np.int32))
        out[mode] = [int(t1), int(t2), int(t3)] + _decode(eng, s, t3, 3)
    assert out["jit"] == out["reference"]
    _state_equal(engs["jit"], engs["reference"])
    assert calls == {"jit": 0, "reference": 2}


def test_ragged_chunk_matches_per_token_replay_frozen_rows_identical(rwkv):
    """tests/test_decode_fused.py: a ragged chunk (3 and 7 steps) equals the
    per-token reference path, every state row byte-identical, and the idle
    third slot's state is untouched."""
    def two(eng):
        s0, s1, idle = (eng.kv.acquire() for _ in range(3))
        t0, _ = eng.prefill_conversation(s0, np.arange(11, 48,
                                                       dtype=np.int32))
        t1, _ = eng.prefill_conversation(s1, np.arange(100, 111,
                                                       dtype=np.int32))
        eng.prefill_conversation(idle, np.arange(60, 90, dtype=np.int32))
        nt = np.zeros(3, np.int32)
        em = np.zeros(3, bool)
        nt[s0], nt[s1] = int(t0), int(t1)
        em[s0] = em[s1] = True
        return (s0, s1, idle), nt, em

    fus, ref = _engine(rwkv), _engine(rwkv)
    (s0, s1, idle), nt_f, em = two(fus)
    _, nt_r, _ = two(ref)
    before = _row(fus, idle)
    rem = np.zeros(3, np.int32)
    rem[s0], rem[s1] = 3, 7
    seq, _ = fus.decode_steps(nt_f, em, rem)
    ref_toks = {s0: [], s1: []}
    for i in range(7):
        mask = em & (i < rem)
        sampled, _ = ref.decode_step_all_reference(nt_r, mask)
        for s in np.flatnonzero(mask):
            ref_toks[s].append(int(sampled[s]))
            nt_r[s] = int(sampled[s])
    assert {s: [int(t) for t in seq[:rem[s], s]] for s in (s0, s1)} \
        == ref_toks
    _state_equal(fus, ref)
    assert all(torch.equal(a, b) for a, b in zip(before, _row(fus, idle)))


def test_decode_overflow_guard_holds_for_state_models(rwkv):
    """The state does not grow, but the slot's max_ctx guard stays as in
    the reference."""
    eng = _engine(rwkv, max_ctx=64)
    s = eng.kv.acquire()
    tok, _ = eng.prefill_conversation(s, np.arange(1, 61, dtype=np.int32))
    with pytest.raises(RuntimeError, match=rf"slot {s} at length 60"):
        _decode(eng, s, tok, 8)
    assert len(_decode(eng, s, tok, 4)) == 4
    assert int(eng.kv.lengths[s]) == 64


def test_kv_transfer_between_replicas_preserves_tokens(rwkv):
    """The exported package is a copy of the slot's fixed-size state (its
    size does not depend on the length) and survives the slot's reuse."""
    cfg, lm, jm, jp, _ = rwkv
    a = _engine(rwkv, replica_id=0, role="prefill")
    b = _engine(rwkv, replica_id=1)
    prompt = np.arange(3, 40, dtype=np.int32)
    sa = a.kv.acquire()
    tok, _ = a.prefill_conversation(sa, prompt)
    pkg = a.kv.export_slot(sa)
    a.kv.release(sa)
    a.prefill_conversation(a.kv.acquire(), np.arange(200, 260,
                                                     dtype=np.int32))
    assert pkg["length"] == 37
    assert b.kv.nbytes_of(pkg) == cfg.state_bytes_fixed() == 2 * 4608
    sb = b.kv.acquire()
    b.kv.import_slot(sb, pkg)
    assert [int(tok)] + _decode(b, sb, tok, 5) == \
        jax_oracle(jm, jp, cfg.vocab_size, prompt, 5)


@pytest.mark.parametrize("mode", ["jit", "reference"])
def test_pool_on_off_streams_and_state_identical(rwkv, mode):
    """The pool stores the state after the preamble (before the delta
    touches the slot), so pool hits and misses give the same tokens and
    the same state bytes."""
    pre = np.arange(1, 40, dtype=np.int32)
    convs = [np.concatenate([pre, np.arange(300 + 20 * i, 310 + 20 * i,
                                            dtype=np.int32)])
             for i in range(3)]
    engs = {p: _engine(rwkv, prefill_mode=mode, prefix_pool_tokens=p)
            for p in (0, 512)}
    toks = {p: [int(eng.prefill_conversation(eng.kv.acquire(), c,
                                             prefix_len=len(pre))[0])
                for c in convs] for p, eng in engs.items()}
    assert toks[0] == toks[512]
    _state_equal(engs[0], engs[512])
    assert engs[512].n_pooled_prefix_tokens == 2 * len(pre)
    assert engs[512].prefix_pool.contains(prefix_hash(pre))
    pooled = engs[512].prefix_pool.get(prefix_hash(pre)).caches
    solo = _engine(rwkv)
    s = solo.kv.acquire()
    solo.prefill_conversation(s, pre)
    for (pa, x), (pb, y) in zip(leaves(pooled),
                                leaves(solo.kv.export_slot_full(s))):
        assert pa == pb and torch.equal(x, y)


def test_streams_equal_jax_engine_server_on_converted_weights(rwkv):
    """1 prefiller + 1 decoder under ConServe with strict accounting on the
    same trace: every (cid, turn) stream of the port equals the JAX
    server's, with one state transfer per conversation."""
    cfg, lm, jm, jp, jcfg = rwkv
    jreps = [JaxReplica(jcfg, jp, n_slots=3, max_ctx=128, replica_id=0,
                        role="prefill"),
             JaxReplica(jcfg, jp, n_slots=3, max_ctx=128, replica_id=1)]
    jsrv = JaxServer(jax_make_scheduler("conserve"), jreps,
                     record_tokens=True, strict_accounting=True)
    jsrv.serve(jax_generate_trace(3, 3.0, cfg=JaxTraceConfig(**SMALL)))

    reps = [_engine(rwkv, replica_id=0, role="prefill"),
            _engine(rwkv, replica_id=1)]
    srv = EngineServer(make_scheduler("conserve"), reps, record_tokens=True,
                       strict_accounting=True)
    s = summarize(srv.serve(generate_trace(3, 3.0, cfg=TraceConfig(**SMALL))))
    streams = {k: [int(t) for t in v] for k, v in srv.sampled_tokens.items()}
    jstreams = {k: [int(t) for t in v]
                for k, v in jsrv.sampled_tokens.items()}
    assert s["n_conversations"] == 3 and len(streams) >= 3
    assert streams == jstreams
    assert s["kv_transfers_per_conv"] == 1.0
    assert srv.n_transfers == jsrv.n_transfers == 3
    assert srv.transfer_bytes == 3 * cfg.state_bytes_fixed()


def test_launcher_serves_rwkv_on_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--engine", "--arch", "rwkv6-3b", "--device", "cpu",
          "--n-conversations", "2", "--slots", "4"])
    assert "kv_transfers_per_conv: 1.0000" in capsys.readouterr().out
