"""The encoder-decoder on the port: whisper-small (the audio conv frontend a
stub — the model takes precomputed frame embeddings — a bidirectional
encoder over them, and decoder layers with cross-attention to its output).

The config and the full-width parameter count equal the reference's
(Python ints, each part on the meta device). On reduced weights converted
from the JAX params in this process, with seeded (numpy) frames and the
reduced config's frontend_len set to its encoder_seq (the reference's
reduction sends 8 frames to a 16-row cross cache, F16): prefill logits, the
self and cross cache leaves, a decode step, three decode steps and an
append, each against the JAX model within LOGIT_TOL (float32) and against
the port's own full prefill as tests/test_models.py:24-61.

Five reference faults the port designs out, each shown on both packages:
F13 (the JAX engine's decode fold raises on an encoder-decoder), F14 (its
slot length counts the frames), F15 (its padded prefill unembeds the last
pad position), F16 (a frame count other than encoder_seq: half the cross
rows stay zero) and F17 (non-causal `online_attention` lets the zero rows
that pad its keys to a whole chunk into the softmax: tested against a plain
softmax at Skv = 600 and 1500, with parity to the reference at Skv <= 512).

The engine: `nbytes_of` a transfer is the cross rows plus the self rows,
the cross rows stay byte-identical through an append and a decode chunk,
the decode chunk's body reads nothing back to the host, and the ConServe
streams (strict accounting) equal a JAX model-level greedy rollout on the
same weights: each (cid, turn)'s context from the port server's journal
(`_journal_context`), prefilled at exact length, then decoded for the
turn's output length. The JAX engine cannot be the oracle (F13)."""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.engine import ReplicaEngine as JaxReplica  # noqa: E402
from repro.models import attention as jatt  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models.model import merge_decode_cache as jax_merge  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.core import make_scheduler  # noqa: E402
from repro_torch.core.runtime import ConversationJournal  # noqa: E402
from repro_torch.engine import EngineServer, ReplicaEngine  # noqa: E402
from repro_torch.engine.kvcache import cross, leaves  # noqa: E402
from repro_torch.models import attention as tatt  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import (params_from_numpy,  # noqa: E402
                                        params_to_numpy)
from repro_torch.models.encdec import EncDec  # noqa: E402
from repro_torch.models.model import merge_decode_cache  # noqa: E402
from repro_torch.traces import TraceConfig, generate_trace  # noqa: E402
from torch_support import NoHostRead, one_thread  # noqa: E402,F401

ARCH = "whisper-small"
LOGIT_TOL = 1e-4  # float32, as tests/test_torch_dense.py
ATT_TOL = 1e-5
FULL_PARAMS = 278_051_328  # the reference skeleton, Python ints
# each part of it: the embedding and the unembedding, the encoder stack,
# the decoder stack (with cross-attention); the two final norms 768 each
PARTS = {"embed": 39_911_424, "unembed": 39_911_424, "encoder": 84_953_088,
         "decoder": 113_273_856}
SMALL = dict(seed=5, first_input_median=30, first_input_sigma=0.3,
             first_input_max=50, append_median=8, append_sigma=0.3,
             append_max=16, output_median=4, output_sigma=0.5, output_max=6,
             mean_turns=2.0, max_turns=3, tool_mean_s=0.01)


def _as_config(cls, cfg):
    """`cfg` rebuilt field by field as a `cls`."""
    return cls(**{f.name: getattr(cfg, f.name)
                  for f in dataclasses.fields(cfg)})


def _convert(**over):
    jcfg, cfg = jax_reduced(ARCH).scaled(**over), get_reduced(ARCH).scaled(
        **over)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    lm = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu")
    return jcfg, jm, jp, cfg, build_model(cfg), lm


@pytest.fixture(scope="module")
def pair():
    """The reduced model with as many frames as cross rows (F16)."""
    return _convert(frontend_len=get_reduced(ARCH).encoder_seq)


def _err(j, t):
    return float(np.max(np.abs(np.asarray(j, np.float32)
                               - t.float().numpy())))


def _tokens(seed, shape, vocab=512):
    return np.random.RandomState(seed).randint(0, vocab, shape).astype(
        np.int32)


def _frames(seed, cfg, batch=2, n=None):
    """Seeded stub frame embeddings (batch, n or encoder_seq, d_model)."""
    return (np.random.RandomState(seed).standard_normal(
        (batch, n or cfg.encoder_seq, cfg.d_model)) * 0.5).astype(np.float32)


# --------------------------------------------------------------------------- #
# config and weights
# --------------------------------------------------------------------------- #
def test_config_matches_reference():
    a, b = jax_config(ARCH), get_config(ARCH)
    assert _as_config(type(a), b) == a
    assert b.is_encoder_decoder and (b.encoder_seq, b.frontend_len) == (
        1500, 1500)
    assert a.kv_bytes_per_token() == b.kv_bytes_per_token() == 36_864
    assert a.param_count() == b.param_count()
    assert a.padded_vocab == b.padded_vocab
    assert b.torch_dtype == torch.bfloat16


def test_full_width_counts_the_reference_skeleton():
    """The full-width model on the meta device holds the reference
    skeleton's parameters, counted with Python ints, part by part; the
    sinusoidal table is a buffer, no parameter."""
    m = EncDec(get_config(ARCH), "meta")
    count = lambda mod: sum(math.prod(p.shape)  # noqa: E731
                            for p in mod.parameters())
    got = {"embed": count(m.embed), "unembed": count(m.unembed),
           "encoder": count(m.encoder), "decoder": count(m.decoder)}
    assert got == PARTS
    skel = jax_build(jax_config(ARCH)).skeleton()
    want = sum(math.prod(leaf.shape)
               for leaf in jax.tree_util.tree_leaves(skel))
    assert count(m) == want == FULL_PARAMS
    assert tuple(m.pos_table.shape) == (40_960, 768)
    assert "pos_table" not in dict(m.named_parameters())


def test_params_round_trip(pair):
    """The encoder-decoder tree converts leaf by leaf (encoder, enc_norm,
    decoder with cross and lnx), and a stray leaf raises, naming it."""
    jcfg, jm, jp, cfg, m, lm = pair
    tree = jax.tree_util.tree_map(np.asarray, jp)
    back = params_to_numpy(lm)
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(back)
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)
    assert "q_scale" not in back["decoder"]["cross"]
    back["decoder"]["cross"]["stray"] = back["decoder"]["cross"]["wq"]
    with pytest.raises(ValueError, match="stray"):
        params_from_numpy(back, cfg, "cpu")


# --------------------------------------------------------------------------- #
# the model against the JAX model (tests/test_models.py:24-61)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_prefill_logits_and_cross_kv_match_jax(pair, impl):
    """Logits, the self rows and the cross rows (the encoder's K/V for
    each decoder layer) within LOGIT_TOL of the JAX model's."""
    jcfg, jm, jp, cfg, m, lm = pair
    toks, fe = _tokens(0, (2, 20)), _frames(1, cfg)
    lj, cj = jm.prefill(jp, jnp.asarray(toks), frontend_embeds=jnp.asarray(fe))
    lt, ct = m.prefill(lm, torch.from_numpy(toks),
                       frontend_embeds=torch.from_numpy(fe),
                       attention_impl=impl)
    assert tuple(lt.shape) == (2, cfg.padded_vocab)
    assert _err(lj, lt) < LOGIT_TOL
    assert tuple(ct["cross"]["k"].shape) == (
        cfg.n_layers, 2, cfg.encoder_seq, cfg.n_kv_heads, cfg.head_dim)
    assert tuple(ct["self"]["v"].shape) == (
        cfg.n_layers, 2, 20, cfg.n_kv_heads, cfg.head_dim)
    for sec in ("self", "cross"):
        for n in ("k", "v"):
            assert _err(cj[sec][n], ct[sec][n]) < LOGIT_TOL


def test_decode_and_append_match_full_prefill(pair):
    """decode-matches-full-prefill and append-matches-full, on the port and
    against the JAX model; the append reuses the cached cross rows and
    returns none."""
    jcfg, jm, jp, cfg, m, lm = pair
    toks, fe = _tokens(2, (2, 17)), _frames(3, cfg)
    T = torch.from_numpy
    jfe = jnp.asarray(fe)
    full = m.prefill(lm, T(toks), frontend_embeds=T(fe))[0]
    _, c = m.prefill(lm, T(toks[:, :-1]), frontend_embeds=T(fe))
    pos = np.full(2, 16, np.int32)
    dec, up = m.decode_step(lm, T(toks[:, -1]), c, T(pos))
    assert set(up) == {"self"}
    assert float((full - dec).abs().max()) < 2e-4
    _, jc = jm.prefill(jp, jnp.asarray(toks[:, :-1]), frontend_embeds=jfe)
    assert _err(jm.decode_step(jp, jnp.asarray(toks[:, -1]), jc,
                               jnp.asarray(pos))[0], dec) < LOGIT_TOL
    _, c1 = m.prefill(lm, T(toks[:, :8]), frontend_embeds=T(fe))
    app, c2 = m.prefill(lm, T(toks[:, 8:]), caches=c1, start_pos=8)
    assert set(c2) == {"self"}
    assert float((full - app).abs().max()) < 2e-4
    _, jc1 = jm.prefill(jp, jnp.asarray(toks[:, :8]), frontend_embeds=jfe)
    assert _err(jm.prefill(jp, jnp.asarray(toks[:, 8:]), caches=jc1,
                           start_pos=8)[0], app) < LOGIT_TOL


def test_three_step_decode_matches_full_and_jax(pair):
    """Three decode steps folded by `merge_decode_cache` (the cross rows
    kept): every step's logits and greedy token equal the JAX rollout's,
    and the last step the full prefill's."""
    jcfg, jm, jp, cfg, m, lm = pair
    toks, fe = _tokens(4, (2, 16)), _frames(5, cfg)
    T = torch.from_numpy
    full = m.prefill(lm, T(toks), frontend_embeds=T(fe))[0]
    _, c = m.prefill(lm, T(toks[:, :-3]), frontend_embeds=T(fe))
    _, jc = jm.prefill(jp, jnp.asarray(toks[:, :-3]),
                       frontend_embeds=jnp.asarray(fe))
    cross_k = c["cross"]["k"]
    for i in range(3):
        p = np.full(2, 13 + i, np.int32)
        lt, up = m.decode_step(lm, T(toks[:, -3 + i]), c, T(p))
        lj, jup = jm.decode_step(jp, jnp.asarray(toks[:, -3 + i]), jc,
                                 jnp.asarray(p))
        assert _err(lj, lt) < LOGIT_TOL
        np.testing.assert_array_equal(
            np.argmax(np.asarray(lj)[:, :cfg.vocab_size], -1),
            lt[:, :cfg.vocab_size].argmax(-1).numpy())
        c, jc = merge_decode_cache(c, up), jax_merge(jc, jup)
    assert c["cross"]["k"] is cross_k
    assert float((full - lt).abs().max()) < 3e-4


# --------------------------------------------------------------------------- #
# F17: the non-causal online softmax and its pad keys
# --------------------------------------------------------------------------- #
def _plain_attention(q, k, v):
    s = np.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, v)


@pytest.mark.parametrize("skv", [300, 512, 600, 1500])
def test_f17_noncausal_online_attention_masks_its_pad_keys(skv):
    """The port's non-causal `online_attention` equals a plain softmax at
    any Skv; the reference's does only where Skv is a multiple of its
    512-key chunk or below it, and is off by more than 1e-3 at 600 and
    1500 (its zero pad keys enter the denominator). Where the reference is
    right, the two agree."""
    rs = np.random.RandomState(skv)
    q = rs.standard_normal((1, 3, 2, 16)).astype(np.float32)
    k = rs.standard_normal((1, skv, 2, 16)).astype(np.float32)
    v = rs.standard_normal((1, skv, 2, 16)).astype(np.float32)
    want = _plain_attention(q, k, v)
    T = torch.from_numpy
    got = tatt.online_attention(T(q), T(k), T(v), torch.arange(3),
                                torch.arange(skv), causal=False)
    assert float(np.abs(got.numpy() - want).max()) < ATT_TOL
    ref = np.asarray(jatt.online_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.arange(3),
        jnp.arange(skv), causal=False))
    if skv <= 512:
        assert float(np.abs(ref - want).max()) < ATT_TOL
        assert float(np.abs(ref - got.numpy()).max()) < ATT_TOL
    else:
        assert float(np.abs(ref - want).max()) > 1e-3


# --------------------------------------------------------------------------- #
# the engine: F13-F16, the cache tree, the programs
# --------------------------------------------------------------------------- #
def _engine(pair, n_slots=3, max_ctx=128, **kw):
    jcfg, jm, jp, cfg, m, lm = pair
    return ReplicaEngine(cfg, lm, n_slots=n_slots, max_ctx=max_ctx, **kw)


def _one_frame_set(cfg, seed=6, n=None):
    return torch.from_numpy(_frames(seed, cfg, batch=1, n=n))


def test_f13_jax_engine_decode_raises_the_port_serves():
    """The reference's engine folds decode updates over a tree with "cross"
    while its decode returns "self" only, and raises on the first fused
    decode; the port's fold skips the cross rows and decodes."""
    jcfg, jm, jp, cfg, m, lm = _convert()
    jrep = JaxReplica(jcfg, jp, n_slots=2, max_ctx=64)
    s = jrep.kv.acquire()
    fe = _frames(6, jcfg, batch=1, n=jcfg.frontend_len)
    t, _ = jrep.prefill_conversation(s, _tokens(7, 11), jnp.asarray(fe))
    nt, em = np.zeros(2, np.int32), np.zeros(2, bool)
    nt[s], em[s] = int(t), True
    with pytest.raises(ValueError, match="cross"):
        jrep.decode_steps(nt, em, 2)
    pcfg = cfg.scaled(frontend_len=cfg.encoder_seq)
    eng = ReplicaEngine(pcfg, lm, n_slots=2, max_ctx=64)
    s = eng.kv.acquire()
    t, _ = eng.prefill_conversation(s, _tokens(7, 11), _one_frame_set(pcfg))
    nt[s] = int(t)
    seq, _ = eng.decode_steps(nt, em, 2)
    assert seq.shape == (2, 2) and int(eng.kv.lengths[s]) == 13


def test_f14_slot_length_counts_decoder_positions(pair):
    """The port's slot holds the decoder's tokens only; the reference's
    length counts the frames too (8 + 11 at the reduced width, 1500 +
    true_len at full width, which its room check then refuses at max_ctx
    1024)."""
    jcfg, jm, jp, cfg, m, lm = pair
    eng = _engine(pair)
    s = eng.kv.acquire()
    eng.prefill_conversation(s, _tokens(7, 11), _one_frame_set(cfg))
    assert int(eng.kv.lengths[s]) == 11
    jcfg8 = jax_reduced(ARCH)
    jrep = JaxReplica(jcfg8, jax_build(jcfg8).init(jax.random.PRNGKey(0)),
                      n_slots=2, max_ctx=64)
    js = jrep.kv.acquire()
    jrep.prefill_conversation(js, _tokens(7, 11), jnp.asarray(
        _frames(6, jcfg8, batch=1, n=jcfg8.frontend_len)))
    assert int(jrep.kv.lengths[js]) == jcfg8.frontend_len + 11


def test_f15_padded_prefill_takes_the_last_live_position(pair):
    """A prefill padded to its bucket gives the exact-length prefill's
    logits at `logits_at` in the port; the reference's encoder-decoder
    ignores `logits_at` and unembeds the last pad position."""
    jcfg, jm, jp, cfg, m, lm = pair
    toks = _tokens(8, (1, 11))
    padded = np.zeros((1, 16), np.int32)
    padded[:, :11] = toks
    fe = _frames(9, cfg, batch=1)
    T = torch.from_numpy
    exact = m.prefill(lm, T(toks), frontend_embeds=T(fe))[0]
    pad = m.prefill(lm, T(padded), frontend_embeds=T(fe), logits_at=10)[0]
    assert float((exact - pad).abs().max()) < 2e-4
    jexact = jm.prefill(jp, jnp.asarray(toks), frontend_embeds=jnp.asarray(fe))
    jpad = jm.prefill(jp, jnp.asarray(padded), frontend_embeds=jnp.asarray(fe),
                      logits_at=10)
    assert float(jnp.max(jnp.abs(jexact[0] - jpad[0]))) > 1e-2
    eng = _engine(pair)
    s = eng.kv.acquire()
    tok, _ = eng.prefill_conversation(s, toks[0], T(fe))
    assert int(tok) == int(exact[0, :cfg.vocab_size].argmax())


def test_f16_frame_count_must_be_encoder_seq():
    """The reference's reduced config sends frontend_len = 8 frames into a
    16-row cross cache, whose other 8 rows stay zero and are attended (no
    length mask); the port's replica refuses any frame count other than
    encoder_seq, naming both, and a turn-1 without frames."""
    jcfg, jm, jp, cfg, m, lm = _convert()
    assert (cfg.frontend_len, cfg.encoder_seq) == (8, 16)
    jrep = JaxReplica(jcfg, jp, n_slots=2, max_ctx=64)
    js = jrep.kv.acquire()
    jrep.prefill_conversation(js, _tokens(7, 11), jnp.asarray(
        _frames(6, jcfg, batch=1, n=8)))
    ck = np.asarray(jrep.kv.caches["cross"]["k"])[:, js]
    assert not ck[:, 8:].any() and ck[:, :8].any()
    eng = ReplicaEngine(cfg, lm, n_slots=2, max_ctx=64)
    s = eng.kv.acquire()
    with pytest.raises(ValueError, match="16 frame embeddings, got 8"):
        eng.prefill_conversation(s, _tokens(7, 11),
                                 _one_frame_set(cfg, n=8))
    with pytest.raises(ValueError, match="got None"):
        eng.prefill_conversation(s, _tokens(7, 11))


def test_transfer_bytes_are_cross_rows_plus_self_rows(pair):
    """`export_slot` copies the cross rows whole and the self rows up to
    the slot's length; `nbytes_of` counts both, and `import_slot` installs
    both on another replica."""
    jcfg, jm, jp, cfg, m, lm = pair
    a, b = _engine(pair), _engine(pair)
    s = a.kv.acquire()
    a.prefill_conversation(s, _tokens(10, 23), _one_frame_set(cfg))
    pkg = a.kv.export_slot(s)
    isz = cfg.torch_dtype.itemsize
    cross_b = 2 * cfg.n_layers * cfg.encoder_seq * cfg.n_kv_heads * \
        cfg.head_dim * isz
    assert a.kv.nbytes_of(pkg) == cross_b + 23 * cfg.kv_bytes_per_token()
    d = b.kv.acquire()
    b.kv.import_slot(d, pkg)
    assert int(b.kv.lengths[d]) == 23
    for (p, x), (_, y) in zip(leaves(a.kv.caches), leaves(b.kv.caches)):
        n = x.shape[2] if cross(p) else 23
        assert torch.equal(x[:, s, :n], y[:, d, :n])


def test_cross_rows_untouched_by_append_and_decode(pair):
    """An append and a ragged decode chunk write the self rows at the
    slot's length and leave every cross row byte-identical; a second slot's
    turn-1 replaces only its own cross rows."""
    jcfg, jm, jp, cfg, m, lm = pair
    eng = _engine(pair)
    s = eng.kv.acquire()
    t, _ = eng.prefill_conversation(s, _tokens(11, 19), _one_frame_set(cfg))
    snap = lambda: [x.clone() for p, x in leaves(eng.kv.caches)  # noqa: E731
                    if cross(p)]
    before = snap()
    t, _ = eng.append_prefill(s, _tokens(12, 7))
    nt, em = np.zeros(3, np.int32), np.zeros(3, bool)
    nt[s], em[s] = int(t), True
    eng.decode_steps(nt, em, 5)
    assert int(eng.kv.lengths[s]) == 31
    assert all(torch.equal(x, y) for x, y in zip(before, snap()))
    s2 = eng.kv.acquire()
    eng.prefill_conversation(s2, _tokens(13, 9), _one_frame_set(cfg, seed=7))
    after = snap()
    for x, y in zip(before, after):
        assert torch.equal(x[:, s], y[:, s])
        assert not torch.equal(x[:, s2], y[:, s2])


def test_decode_body_reads_nothing_back(pair):
    """The decode chunk's body (what a CUDA graph captures) runs with the
    host reading nothing: the encoder-decoder's sinusoidal row is gathered
    by device index and its cross rows read as they are."""
    eng = _engine(pair, n_slots=4, max_ctx=64)
    cfg = eng.cfg
    nt, em = np.zeros(4, np.int32), np.zeros(4, bool)
    for i, n in enumerate((23, 9)):
        s = eng.kv.acquire()
        t, _ = eng.prefill_conversation(s, _tokens(14 + i, n),
                                        _one_frame_set(cfg, seed=i))
        nt[s], em[s] = int(t), True
    rem = np.where(em, 4, 0).astype(np.int32)
    prog = eng._get_fused(4, 64)
    prog.load(np.concatenate([nt, eng.kv.lengths, em, rem, [0]]))
    with NoHostRead():
        prog.run_eager()
    assert eng.warmup_prefill() == 0.0 and not eng._prefill


def test_prefill_modes_agree(pair):
    """The eager fast path (bucketed, logits at the last live position)
    and `prefill_mode="reference"` give the same tokens and caches over a
    turn-1 and an append."""
    jcfg, jm, jp, cfg, m, lm = pair
    out = []
    for mode in ("jit", "reference"):
        eng = _engine(pair, prefill_mode=mode)
        s = eng.kv.acquire()
        t1, _ = eng.prefill_conversation(s, _tokens(16, 21),
                                         _one_frame_set(cfg))
        t2, _ = eng.append_prefill(s, _tokens(17, 6))
        out.append(([int(t1), int(t2)],
                    [x.clone() for _, x in leaves(eng.kv.caches)]))
    assert out[0][0] == out[1][0]
    assert all(torch.allclose(x, y, atol=1e-6)
               for x, y in zip(out[0][1], out[1][1]))


# --------------------------------------------------------------------------- #
# served through EngineServer under ConServe, against a JAX rollout
# --------------------------------------------------------------------------- #
def test_streams_equal_jax_model_rollout(pair):
    """1 prefiller + 1 decoder under ConServe with strict accounting: one
    transfer a conversation of the cross rows plus kv_bytes_per_token x its
    first input, and every (cid, turn) stream equals the JAX model's greedy
    rollout of that turn: its context (`_journal_context` over the streams
    of the turns before it) prefilled at exact length with the server's
    frames, then decoded one token at a time."""
    jcfg, jm, jp, cfg, m, lm = pair
    n = 5
    reps = [_engine(pair, replica_id=0, role="prefill"),
            _engine(pair, replica_id=1)]
    srv = EngineServer(make_scheduler("conserve"), reps, record_tokens=True,
                       strict_accounting=True)
    trace = generate_trace(n, 3.0, cfg=TraceConfig(**SMALL))
    recs = srv.serve(trace)
    streams = {k: [int(t) for t in v] for k, v in srv.sampled_tokens.items()}
    assert len(recs) == n and any(turn > 0 for _, turn in streams)
    assert srv.n_transfers == n
    cross_b = 2 * cfg.n_layers * cfg.encoder_seq * cfg.n_kv_heads * \
        cfg.head_dim * cfg.torch_dtype.itemsize
    assert srv.transfer_bytes == n * cross_b + cfg.kv_bytes_per_token() * \
        sum(c.first_input_len for c in trace)
    convs = {c.cid: c for c in trace}
    fe = jnp.zeros((1, cfg.encoder_seq, cfg.d_model), jnp.float32)
    rows = 128  # the self rows padded to one length: one decode compile

    @jax.jit
    def decode(token, cache, pos):
        """The JAX model's decode step at `pos` over the padded self rows
        (masked at pos), its new K/V written at row pos."""
        lens = jnp.full((1,), pos, jnp.int32)
        lg, up = jm.decode_step(jp, token, cache, lens, kv_lens=lens)
        grown = {n: jax.lax.dynamic_update_slice_in_dim(
            t, up["self"][n].astype(t.dtype), pos, axis=2)
            for n, t in cache["self"].items()}
        return lg, {"self": grown, "cross": cache["cross"]}

    for (cid, turn), stream in sorted(streams.items()):
        srv.journal = ConversationJournal()
        for t in range(turn):
            srv.journal.record(cid, t, streams[(cid, t)])
        ctx = srv._journal_context(convs[cid], turn)
        logits, cache = jm.prefill(jp, jnp.asarray(ctx)[None],
                                   frontend_embeds=fe)
        cache = {"self": {n: jnp.pad(t, ((0, 0), (0, 0),
                                         (0, rows - t.shape[2]), (0, 0),
                                         (0, 0)))
                          for n, t in cache["self"].items()},
                 "cross": cache["cross"]}
        want = [int(jnp.argmax(logits[0, :cfg.vocab_size]))]
        for i in range(len(stream) - 1):
            lg, cache = decode(jnp.asarray([want[-1]], jnp.int32), cache,
                               jnp.int32(len(ctx) + i))
            want.append(int(jnp.argmax(lg[0, :cfg.vocab_size])))
        assert stream == want, (cid, turn)
