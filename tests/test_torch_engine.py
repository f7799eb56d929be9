"""The port's serving engine (`repro_torch.engine`): slot cache + replica.

Mirrors of tests/test_engine.py, tests/test_decode_fused.py,
tests/test_prefill_jit.py and the engine half of tests/test_prefix_pool.py,
on weights converted from the JAX package in this process. Across
frameworks greedy tokens must be equal; within the port its fast path and
its reference path must leave byte-identical caches. Also the two index
faults where a line-by-line translation of the JAX code goes wrong in torch
(a KV write one past a full slot; an idle slot longer than the trimmed
decode read) and the refused prefill write past the buffer."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.engine.kvcache import prefix_hash as jax_prefix_hash  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models.model import merge_decode_cache as jax_merge  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.engine import ReplicaEngine, bucket_len  # noqa: E402
from repro_torch.engine.kvcache import (fold_prefill, leaves,  # noqa: E402
                                        prefix_hash)
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from torch_support import one_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def qwen():
    jcfg = jax_reduced("qwen3-0.6b")
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = get_reduced("qwen3-0.6b")
    lm = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu")
    return cfg, lm, jm, jp


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


def _engine(qwen, **kw):
    cfg, lm = qwen[0], qwen[1]
    kw.setdefault("n_slots", 4)
    kw.setdefault("max_ctx", 256)
    return ReplicaEngine(cfg, lm, **kw)


def _prefill_two(qwen, **kw):
    eng = _engine(qwen, **kw)
    n = eng.kv.n_slots
    s0, s1 = eng.kv.acquire(), eng.kv.acquire()
    t0, _ = eng.prefill_conversation(s0, np.arange(11, 48, dtype=np.int32))
    t1, _ = eng.prefill_conversation(s1, np.arange(100, 111, dtype=np.int32))
    nt = np.zeros(n, np.int32)
    em = np.zeros(n, bool)
    nt[s0], nt[s1] = int(t0), int(t1)
    em[s0] = em[s1] = True
    return eng, (s0, s1), nt, em


def _cache_equal(a, b, atol=0.0):
    np.testing.assert_array_equal(a.kv.lengths, b.kv.lengths)
    for (pa, x), (pb, y) in zip(leaves(a.kv.caches), leaves(b.kv.caches)):
        assert pa == pb
        if atol == 0.0:
            assert torch.equal(x, y), pa
        else:
            np.testing.assert_allclose(x.float().numpy(), y.float().numpy(),
                                       atol=atol)


def _row(eng, slot):
    return [t.clone() for _, t in leaves(eng.kv.export_slot_full(slot))]


# --------------------------------------------------------------------------- #
# tests/test_engine.py mirrors, against the JAX model's rollout
# --------------------------------------------------------------------------- #
def test_bucket_len():
    assert bucket_len(1) == 32 and bucket_len(33) == 64
    assert bucket_len(4096) == 4096 and bucket_len(5000) == 8192


@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_engine_matches_jax_oracle(qwen, impl):
    cfg, lm, jm, jp = qwen
    eng = _engine(qwen, attention_impl=impl)
    slot = eng.kv.acquire()
    prompt = np.arange(11, 48, dtype=np.int32)  # 37 -> bucket 64 (padded)
    tok, _ = eng.prefill_conversation(slot, prompt)
    got = [int(tok)]
    for _ in range(6):
        nt = np.zeros(4, np.int32)
        em = np.zeros(4, bool)
        nt[slot], em[slot] = got[-1], True
        sampled, _ = eng.decode_step_all(nt, em)
        got.append(int(sampled[slot]))
    assert got == jax_oracle(jm, jp, cfg.vocab_size, prompt, 6)


def test_engine_multiturn_append_matches_jax_full_prefill(qwen):
    cfg, lm, jm, jp = qwen
    eng = _engine(qwen, n_slots=2)
    slot = eng.kv.acquire()
    t1 = np.arange(5, 30, dtype=np.int32)
    append = np.arange(100, 117, dtype=np.int32)
    eng.prefill_conversation(slot, t1)
    tok2, _ = eng.append_prefill(slot, append)
    lg, _ = jm.prefill(jp, jnp.asarray(np.concatenate([t1, append]))[None])
    assert int(tok2) == int(jnp.argmax(lg[0, :cfg.vocab_size]))
    assert int(eng.kv.lengths[slot]) == 42


def test_kv_transfer_between_replicas_preserves_tokens(qwen):
    cfg, lm, jm, jp = qwen
    a = _engine(qwen, n_slots=2, replica_id=0, role="prefill")
    b = _engine(qwen, n_slots=2, replica_id=1)
    prompt = np.arange(3, 40, dtype=np.int32)
    sa = a.kv.acquire()
    tok, _ = a.prefill_conversation(sa, prompt)
    pkg = a.kv.export_slot(sa)
    a.kv.release(sa)
    # the package is a copy: reusing the source slot cannot change it
    a.prefill_conversation(a.kv.acquire(), np.arange(200, 260,
                                                     dtype=np.int32))
    assert b.kv.nbytes_of(pkg) == 2 * cfg.n_layers * 37 * cfg.n_kv_heads \
        * cfg.head_dim * 4
    sb = b.kv.acquire()
    b.kv.import_slot(sb, pkg)
    got = [int(tok)]
    for _ in range(5):
        nt = np.zeros(2, np.int32)
        em = np.zeros(2, bool)
        nt[sb], em[sb] = got[-1], True
        sampled, _ = b.decode_step_all(nt, em)
        got.append(int(sampled[sb]))
    assert got == jax_oracle(jm, jp, cfg.vocab_size, prompt, 5)


def test_slot_exhaustion_raises(qwen):
    eng = _engine(qwen, n_slots=2, max_ctx=64, replica_id=7)
    eng.kv.acquire()
    eng.kv.acquire()
    with pytest.raises(RuntimeError, match="no free KV slots on replica 7"):
        eng.kv.acquire()


def test_prefix_hash_is_byte_identical_to_reference():
    for toks in ([1, 2, 3], list(range(500)), [151_935, 0]):
        assert prefix_hash(toks) == jax_prefix_hash(toks)


# --------------------------------------------------------------------------- #
# tests/test_decode_fused.py mirrors
# --------------------------------------------------------------------------- #
def test_chunk_matches_reference_tokens_and_cache(qwen):
    ref, (s0, s1), nt_r, em = _prefill_two(qwen)
    fus, _, nt_f, _ = _prefill_two(qwen)
    ref_toks = {s0: [], s1: []}
    for _ in range(6):
        sampled, _ = ref.decode_step_all_reference(nt_r, em)
        for s in (s0, s1):
            ref_toks[s].append(int(sampled[s]))
            nt_r[s] = int(sampled[s])
    seq, _ = fus.decode_steps(nt_f, em, 6)
    assert {s: [int(t) for t in seq[:, s]] for s in (s0, s1)} == ref_toks
    _cache_equal(ref, fus, atol=1e-5)


def test_multi_step_equals_repeated_single_step(qwen):
    a, (s0, s1), nt_a, em = _prefill_two(qwen)
    b, _, nt_b, _ = _prefill_two(qwen)
    seq_multi, _ = a.decode_steps(nt_a, em, 5)
    for i in range(5):
        seq, _ = b.decode_steps(nt_b, em, 1)
        for s in (s0, s1):
            assert int(seq_multi[i, s]) == int(seq[0, s])
            nt_b[s] = int(seq[0, s])
    _cache_equal(a, b)


def test_ragged_chunk_matches_per_token_replay_frozen_rows_identical(qwen):
    fus, (s0, s1), nt_f, em = _prefill_two(qwen)
    ref, _, nt_r, _ = _prefill_two(qwen)
    rem = np.zeros(fus.kv.n_slots, np.int32)
    rem[s0], rem[s1] = 3, 7
    seq, _ = fus.decode_steps(nt_f, em, rem)
    assert seq.shape[0] == 7
    ref_toks = {s0: [], s1: []}
    for i in range(7):
        mask = em & (i < rem)
        sampled, _ = ref.decode_step_all_reference(nt_r, mask)
        for s in np.flatnonzero(mask):
            ref_toks[s].append(int(sampled[s]))
            nt_r[s] = int(sampled[s])
    assert {s: [int(t) for t in seq[:rem[s], s]] for s in (s0, s1)} \
        == ref_toks
    _cache_equal(fus, ref, atol=1e-5)


def test_decode_chunk_does_not_touch_inactive_slots(qwen):
    eng, (s0, s1), nt, em = _prefill_two(qwen)
    em[s1] = False
    before = _row(eng, s1)
    eng.decode_steps(nt, em, 4)
    assert int(eng.kv.lengths[s1]) == 11
    assert all(torch.equal(a, b) for a, b in zip(before, _row(eng, s1)))


def test_decode_steps_overflow_names_offending_slot(qwen):
    eng, (s0, s1), nt, em = _prefill_two(qwen, max_ctx=64)
    eng.kv.lengths[s1] = 62
    rem = np.zeros(eng.kv.n_slots, np.int32)
    rem[s0], rem[s1] = 4, 4
    with pytest.raises(RuntimeError, match=rf"slot {s1} at length 62"):
        eng.decode_steps(nt, em, rem)
    rem[s1] = 2
    eng.decode_steps(nt, em, rem)
    assert int(eng.kv.lengths[s1]) == 64


def test_decode_steps_rejects_bad_remaining(qwen):
    eng, (s0, s1), nt, em = _prefill_two(qwen)
    rem = np.zeros(eng.kv.n_slots, np.int32)
    rem[s0] = 3
    with pytest.raises(ValueError, match=rf"slot\(s\) \[{s1}\]"):
        eng.decode_steps(nt, em, rem)
    rem[s1] = 40
    with pytest.raises(ValueError, match=rf"slot {s1} remaining 40"):
        eng.decode_steps(nt, em, rem)


# --------------------------------------------------------------------------- #
# F1: KV writes that JAX drops out of range and torch would not
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_f1_full_slot_idles_while_a_neighbour_decodes(qwen, impl):
    """A slot filled to exactly max_ctx (the overflow guard allows it) sits
    idle while another slot decodes: its fold index would be one past the
    buffer. Nothing raises, and its row stays byte-identical."""
    eng, (s0, s1), nt, em = _prefill_two(qwen, max_ctx=64,
                                         attention_impl=impl)
    rem = np.zeros(eng.kv.n_slots, np.int32)
    rem[s0], rem[s1] = 4, 53
    with pytest.raises(ValueError):  # 53 > the largest chunk: two calls
        eng.decode_steps(nt, em, rem)
    rem[s1] = 32
    eng.decode_steps(nt, em, rem)
    rem[s0], rem[s1] = 4, 21
    eng.decode_steps(nt, em, rem)
    assert int(eng.kv.lengths[s1]) == 64  # exactly full
    em[s1] = False
    before = _row(eng, s1)
    eng.decode_steps(nt, em, 5)
    eng.decode_step_all_reference(nt, em)
    assert int(eng.kv.lengths[s1]) == 64
    assert all(torch.equal(a, b) for a, b in zip(before, _row(eng, s1)))


@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_f1_idle_slot_longer_than_the_trimmed_read(qwen, impl):
    """The chunk's ctx bucket is sized from the emitting slots only, so an
    idle slot longer than it lies past the trimmed read. The busy slot's
    tokens equal a replica where it runs alone, and the idle row is
    untouched."""
    cfg, lm, jm, jp = qwen
    prompt = np.arange(7, 20, dtype=np.int32)
    alone = _engine(qwen, n_slots=2, max_ctx=512, attention_impl=impl)
    s = alone.kv.acquire()
    t, _ = alone.prefill_conversation(s, prompt)
    nt = np.zeros(2, np.int32)
    em = np.zeros(2, bool)
    nt[s], em[s] = int(t), True
    want = [int(t)] + [int(x) for x in alone.decode_steps(nt, em, 6)[0][:, s]]

    eng = _engine(qwen, n_slots=2, max_ctx=512, attention_impl=impl)
    busy, idle = eng.kv.acquire(), eng.kv.acquire()
    eng.prefill_conversation(idle, np.arange(300, 500, dtype=np.int32))
    t, _ = eng.prefill_conversation(busy, prompt)
    before = _row(eng, idle)
    nt = np.zeros(2, np.int32)
    em = np.zeros(2, bool)
    nt[busy], em[busy] = int(t), True
    got = [int(t)] + [int(x) for x in eng.decode_steps(nt, em, 6)[0][:, busy]]
    assert got == want == jax_oracle(jm, jp, cfg.vocab_size, prompt, 6)
    assert int(eng.kv.lengths[idle]) == 200
    assert all(torch.equal(a, b) for a, b in zip(before, _row(eng, idle)))


# --------------------------------------------------------------------------- #
# tests/test_prefill_jit.py mirrors (F2 included)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_fast_and_reference_prefill_leave_byte_identical_caches(qwen, impl):
    """Turn-1 + two appends (the prefix crosses a ctx bucket): identical
    tokens, byte-identical caches, and the fast path never reads the
    full-buffer view."""
    engs = {m: _engine(qwen, n_slots=2, prefill_mode=m, attention_impl=impl)
            for m in ("jit", "reference")}
    calls = {m: 0 for m in engs}
    out = {}
    for m, eng in engs.items():
        orig = eng.kv.export_slot_full

        def spy(slot, m=m, orig=orig):
            calls[m] += 1
            return orig(slot)

        eng.kv.export_slot_full = spy
        slot = eng.kv.acquire()
        t1, _ = eng.prefill_conversation(slot, np.arange(5, 50,
                                                         dtype=np.int32))
        t2, _ = eng.append_prefill(slot, np.arange(100, 131, dtype=np.int32))
        t3, _ = eng.append_prefill(slot, np.arange(200, 215, dtype=np.int32))
        out[m] = (int(t1), int(t2), int(t3))
    assert out["jit"] == out["reference"]
    _cache_equal(engs["jit"], engs["reference"])
    assert calls == {"jit": 0, "reference": 2}


def test_attention_impls_agree_through_prefill_append_decode(qwen):
    def roll(impl):
        eng = _engine(qwen, n_slots=2, attention_impl=impl)
        s = eng.kv.acquire()
        t, _ = eng.prefill_conversation(s, np.arange(3, 45, dtype=np.int32))
        toks = [int(t)]
        t2, _ = eng.append_prefill(s, np.arange(80, 95, dtype=np.int32))
        toks.append(int(t2))
        nt = np.zeros(2, np.int32)
        em = np.zeros(2, bool)
        nt[s], em[s] = toks[-1], True
        seq, _ = eng.decode_steps(nt, em, 3)
        toks += [int(x) for x in seq[:, s]]
        nt[s] = toks[-1]
        samp, _ = eng.decode_step_all_reference(nt, em)
        return toks + [int(samp[s])]

    assert roll("torch") == roll("cuda")


def test_prefill_overflow_names_slot(qwen):
    for mode in ("jit", "reference"):
        eng = _engine(qwen, n_slots=2, max_ctx=64, prefill_mode=mode)
        s = eng.kv.acquire()
        eng.prefill_conversation(s, np.arange(11, 51, dtype=np.int32))
        with pytest.raises(RuntimeError, match=rf"slot {s} at length 40"):
            eng.append_prefill(s, np.arange(30, dtype=np.int32))
        with pytest.raises(RuntimeError, match="prefill overflow"):
            eng.prefill_conversation(eng.kv.acquire(),
                                     np.arange(70, dtype=np.int32))


def test_f2_append_near_full_slot_pads_exact_not_clamped(qwen):
    """prev 40 + append 20 fits max_ctx 64 but the 32-bucket does not: the
    append runs at its exact length and the decode through it matches the
    JAX full-prefill rollout, in both prefill modes."""
    cfg, lm, jm, jp = qwen
    t1 = np.arange(5, 45, dtype=np.int32)
    app = np.arange(100, 120, dtype=np.int32)
    want = jax_oracle(jm, jp, cfg.vocab_size, np.concatenate([t1, app]), 3)
    for mode in ("jit", "reference"):
        eng = _engine(qwen, n_slots=2, max_ctx=64, prefill_mode=mode)
        s = eng.kv.acquire()
        eng.prefill_conversation(s, t1)
        tok, _ = eng.append_prefill(s, app)
        got = [int(tok)]
        nt = np.zeros(2, np.int32)
        em = np.zeros(2, bool)
        em[s] = True
        for _ in range(3):
            nt[s] = got[-1]
            seq, _ = eng.decode_steps(nt, em, 1)
            got.append(int(seq[0, s]))
        assert got == want, mode


def test_f2_fold_prefill_refuses_a_write_past_the_buffer(qwen):
    eng = _engine(qwen, n_slots=2, max_ctx=64)
    new = {"groups": {"p0": {n: torch.ones(2, 1, 32, 4, 16)
                             for n in ("k", "v")}}}
    before = [t.clone() for _, t in leaves(eng.kv.caches)]
    with pytest.raises(RuntimeError, match=r"rows \[40, 72\) of slot 1"):
        fold_prefill(eng.kv.caches, new, 1, 40)
    assert all(torch.equal(a, b) for a, (_, b) in
               zip(before, leaves(eng.kv.caches)))


# --------------------------------------------------------------------------- #
# shared-preamble split and the prefix pool (tests/test_prefix_pool.py)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("mode", ["jit", "reference"])
def test_pool_on_off_streams_and_caches_identical(qwen, mode):
    pre = np.arange(1, 70, dtype=np.int32)
    convs = [np.concatenate([pre, np.arange(300 + 20 * i, 310 + 20 * i,
                                            dtype=np.int32)])
             for i in range(3)]
    engs = {p: _engine(qwen, n_slots=4, prefill_mode=mode,
                       prefix_pool_tokens=p) for p in (0, 512)}
    toks = {}
    for p, eng in engs.items():
        toks[p] = [int(eng.prefill_conversation(eng.kv.acquire(), c,
                                                prefix_len=len(pre))[0])
                   for c in convs]
    assert toks[0] == toks[512]
    # live rows are byte-identical (beyond the live length a pool hit holds
    # the pool's zero mask where a miss holds its bucket padding)
    np.testing.assert_array_equal(engs[0].kv.lengths, engs[512].kv.lengths)
    for s in range(3):
        n = int(engs[0].kv.lengths[s])
        for a, b in zip(_row(engs[0], s), _row(engs[512], s)):
            assert torch.equal(a[:, :, :n], b[:, :, :n])
    assert engs[512].n_pooled_prefix_tokens == 2 * len(pre)
    assert engs[512].prefix_pool.contains(prefix_hash(pre))
