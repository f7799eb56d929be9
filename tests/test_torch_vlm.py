"""The vision frontend on the port: internvl2-26b (InternLM2 backbone,
InternViT stub — the model takes precomputed patch embeddings).

The config and the full-width parameter count (Python ints, from the LM on
the meta device) equal the reference's. On reduced weights converted from
the JAX params in this process, with seeded (numpy) patch embeddings: the
prefill's logits and caches (the frontend's rows first), a decode step,
three decode steps and an append, each against the JAX model within
LOGIT_TOL (float32) and against the port's own full prefill as in
tests/test_models.py:24-61. The replica: a slot's length is n_front +
true_len, `warmup_prefill` keys its turn-1 programs (pad_to, n_front), and
a graph-free replica's programs give the eager reference path's tokens and
caches. ConServe: the (cid, turn) streams of the port's `EngineServer`
equal the JAX `EngineServer`'s on the same trace, one transfer a
conversation of 196,608 B a position at full width (here the reduced
model's kv_bytes_per_token x (n_front + its length))."""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.core import make_scheduler as jax_make_scheduler  # noqa: E402
from repro.engine import EngineServer as JaxServer  # noqa: E402
from repro.engine import ReplicaEngine as JaxReplica  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models.model import merge_decode_cache as jax_merge  # noqa: E402
from repro.traces import TraceConfig as JaxTraceConfig  # noqa: E402
from repro.traces import generate_trace as jax_generate_trace  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.core import make_scheduler  # noqa: E402
from repro_torch.engine import EngineServer, ReplicaEngine  # noqa: E402
from repro_torch.engine.kvcache import leaves  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import (params_from_numpy,  # noqa: E402
                                        params_to_numpy)
from repro_torch.models.model import merge_decode_cache  # noqa: E402
from repro_torch.models.transformer import LM  # noqa: E402
from repro_torch.traces import TraceConfig, generate_trace  # noqa: E402
from torch_support import one_thread  # noqa: E402,F401

ARCH = "internvl2-26b"
LOGIT_TOL = 1e-4  # float32, as tests/test_torch_dense.py
FULL_PARAMS = 19_862_722_560  # the reference skeleton, Python ints
PARAM_COUNT = 19_861_254_144  # the reference's `param_count()` (F8)
SMALL = dict(seed=5, first_input_median=30, first_input_sigma=0.3,
             first_input_max=50, append_median=8, append_sigma=0.3,
             append_max=16, output_median=4, output_sigma=0.5, output_max=6,
             mean_turns=2.0, max_turns=3, tool_mean_s=0.01)


@pytest.fixture(scope="module")
def pair():
    jcfg, cfg = jax_reduced(ARCH), get_reduced(ARCH)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    lm = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu")
    return jcfg, jm, jp, cfg, build_model(cfg), lm


def _as_config(cls, cfg):
    """`cfg` rebuilt field by field as a `cls`."""
    return cls(**{f.name: getattr(cfg, f.name)
                  for f in dataclasses.fields(cfg)})


def _err(j, t):
    return float(np.max(np.abs(np.asarray(j, np.float32)
                               - t.float().numpy())))


def _tokens(seed, shape, vocab=512):
    return np.random.RandomState(seed).randint(0, vocab, shape).astype(
        np.int32)


def _patches(seed, cfg, batch=2):
    """Seeded stub patch embeddings (batch, frontend_len, d_model)."""
    return (np.random.RandomState(seed).standard_normal(
        (batch, cfg.frontend_len, cfg.d_model)) * 0.5).astype(np.float32)


# --------------------------------------------------------------------------- #
# config and weights
# --------------------------------------------------------------------------- #
def test_config_matches_reference():
    a, b = jax_config(ARCH), get_config(ARCH)
    assert _as_config(type(a), b) == a
    assert (b.frontend, b.frontend_len) == ("vision", 256)
    assert a.kv_bytes_per_token() == b.kv_bytes_per_token() == 196_608
    assert a.param_count() == b.param_count() == PARAM_COUNT
    assert a.padded_vocab == b.padded_vocab
    assert b.torch_dtype == torch.bfloat16
    assert get_reduced(ARCH).torch_dtype == torch.float32


def test_full_width_lm_counts_the_reference_skeleton():
    """The full-width LM on the meta device (no memory) holds as many
    parameters as the reference's skeleton, counted with Python ints; the
    vision stub holds none."""
    lm = LM(get_config(ARCH), "meta")
    got = sum(math.prod(p.shape) for p in lm.parameters())
    skel = jax_build(jax_config(ARCH)).skeleton()
    want = sum(math.prod(leaf.shape)
               for leaf in jax.tree_util.tree_leaves(skel))
    assert got == want == FULL_PARAMS


def test_params_round_trip(pair):
    jcfg, jm, jp, cfg, m, lm = pair
    tree = jax.tree_util.tree_map(np.asarray, jp)
    back = params_to_numpy(lm)
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(back)
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------- #
# the model against the JAX model (tests/test_models.py:24-61)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_prefill_with_patches_matches_jax(pair, impl):
    """Logits at the last text position and every cache leaf — the
    frontend's F rows, then the tokens' — within LOGIT_TOL of the JAX
    model's; the frontend's rows are dropped from the hidden states."""
    jcfg, jm, jp, cfg, m, lm = pair
    toks, fe = _tokens(0, (2, 20)), _patches(1, cfg)
    lj, cj = jm.prefill(jp, jnp.asarray(toks), frontend_embeds=jnp.asarray(fe))
    lt, ct = m.prefill(lm, torch.from_numpy(toks),
                       frontend_embeds=torch.from_numpy(fe),
                       attention_impl=impl)
    assert tuple(lt.shape) == (2, cfg.padded_vocab)
    assert _err(lj, lt) < LOGIT_TOL
    k = ct["groups"]["p0"]["k"]
    assert k.shape[2] == cfg.frontend_len + 20
    for a, b in zip(jax.tree_util.tree_leaves(cj),
                    jax.tree_util.tree_leaves(ct)):
        assert _err(a, b) < LOGIT_TOL
    # a logits_at past the frontend picks the text position
    l5, _ = m.prefill(lm, torch.from_numpy(toks),
                      frontend_embeds=torch.from_numpy(fe), logits_at=5)
    l6, _ = m.prefill(lm, torch.from_numpy(toks[:, :6]),
                      frontend_embeds=torch.from_numpy(fe))
    assert float((l5 - l6).abs().max()) < 2e-4


def test_decode_and_append_match_full_prefill(pair):
    """decode-matches-full-prefill and append-matches-full with the
    frontend at positions 0..F-1, on the port and against the JAX model."""
    jcfg, jm, jp, cfg, m, lm = pair
    toks, fe = _tokens(2, (2, 17)), _patches(3, cfg)
    F = cfg.frontend_len
    T = torch.from_numpy
    jfe = jnp.asarray(fe)
    full = m.prefill(lm, T(toks), frontend_embeds=T(fe))[0]
    _, c = m.prefill(lm, T(toks[:, :-1]), frontend_embeds=T(fe))
    pos = np.full(2, F + 16, np.int32)
    dec = m.decode_step(lm, T(toks[:, -1]), c, T(pos))[0]
    assert float((full - dec).abs().max()) < 2e-4
    _, jc = jm.prefill(jp, jnp.asarray(toks[:, :-1]), frontend_embeds=jfe)
    assert _err(jm.decode_step(jp, jnp.asarray(toks[:, -1]), jc,
                               jnp.asarray(pos))[0], dec) < LOGIT_TOL
    _, c1 = m.prefill(lm, T(toks[:, :8]), frontend_embeds=T(fe))
    app = m.prefill(lm, T(toks[:, 8:]), caches=c1, start_pos=F + 8)[0]
    assert float((full - app).abs().max()) < 2e-4
    _, jc1 = jm.prefill(jp, jnp.asarray(toks[:, :8]), frontend_embeds=jfe)
    assert _err(jm.prefill(jp, jnp.asarray(toks[:, 8:]), caches=jc1,
                           start_pos=F + 8)[0], app) < LOGIT_TOL


def test_three_step_decode_matches_full_and_jax(pair):
    """Three decode steps folded by `merge_decode_cache` after a prefill
    with patches: every step's logits and greedy token equal the JAX
    rollout's, and the last step the full prefill's."""
    jcfg, jm, jp, cfg, m, lm = pair
    toks, fe = _tokens(4, (2, 16)), _patches(5, cfg)
    F = cfg.frontend_len
    T = torch.from_numpy
    full = m.prefill(lm, T(toks), frontend_embeds=T(fe))[0]
    _, c = m.prefill(lm, T(toks[:, :-3]), frontend_embeds=T(fe))
    _, jc = jm.prefill(jp, jnp.asarray(toks[:, :-3]),
                       frontend_embeds=jnp.asarray(fe))
    for i in range(3):
        p = np.full(2, F + 13 + i, np.int32)
        lt, up = m.decode_step(lm, T(toks[:, -3 + i]), c, T(p))
        lj, jup = jm.decode_step(jp, jnp.asarray(toks[:, -3 + i]), jc,
                                 jnp.asarray(p))
        assert _err(lj, lt) < LOGIT_TOL
        np.testing.assert_array_equal(
            np.argmax(np.asarray(lj)[:, :cfg.vocab_size], -1),
            lt[:, :cfg.vocab_size].argmax(-1).numpy())
        c, jc = merge_decode_cache(c, up), jax_merge(jc, jup)
    assert float((full - lt).abs().max()) < 3e-4


# --------------------------------------------------------------------------- #
# the replica
# --------------------------------------------------------------------------- #
def _snapshot(eng):
    return [t.clone() for _, t in leaves(eng.kv.caches)]


def test_slot_length_counts_the_frontend(pair):
    """A turn-1 prefill with F patches leaves the slot at F + true_len, as
    the reference's, and its first token is the model's exact-length
    prefill's; an append and a decode chunk go on from there."""
    jcfg, jm, jp, cfg, m, lm = pair
    fe = torch.from_numpy(_patches(6, cfg, batch=1))
    toks = _tokens(7, 11)
    eng = ReplicaEngine(cfg, lm, n_slots=2, max_ctx=128)
    s = eng.kv.acquire()
    tok, _ = eng.prefill_conversation(s, toks, fe)
    assert int(eng.kv.lengths[s]) == cfg.frontend_len + 11
    want = m.prefill(lm, torch.from_numpy(toks)[None], frontend_embeds=fe)[0]
    assert int(tok) == int(want[0, :cfg.vocab_size].argmax())
    jrep = JaxReplica(jcfg, jp, n_slots=2, max_ctx=128)
    js = jrep.kv.acquire()
    jtok, _ = jrep.prefill_conversation(js, toks, jnp.asarray(fe.numpy()))
    assert int(jrep.kv.lengths[js]) == int(eng.kv.lengths[s])
    assert int(jtok) == int(tok)
    eng.append_prefill(s, _tokens(8, 5))
    assert int(eng.kv.lengths[s]) == cfg.frontend_len + 16
    nt, em = np.zeros(2, np.int32), np.zeros(2, bool)
    nt[s], em[s] = 3, True
    eng.decode_steps(nt, em, 4)
    assert int(eng.kv.lengths[s]) == cfg.frontend_len + 20


def test_warmup_prefill_keys_pad_to_and_n_front(pair):
    """`warmup_prefill` builds one turn-1 program per (length bucket,
    frontend_len) whose bucket fits beside the patches; a served prefill
    then charges no build and reads its patches from the program's static
    input; a prefill without patches is another program."""
    jcfg, jm, jp, cfg, m, lm = pair
    F = cfg.frontend_len
    eng = ReplicaEngine(cfg, lm, n_slots=2, max_ctx=64)
    assert eng.warmup_prefill() > 0
    assert set(eng._prefill) == {(32, F)}  # 64 + 8 would not fit
    assert ("prefill", 32, F) in eng.programs()
    before = eng.compile_s
    s = eng.kv.acquire()
    fe = torch.from_numpy(_patches(9, cfg, batch=1))
    tok, _ = eng.prefill_conversation(s, _tokens(10, 20), fe)
    assert eng.compile_s == before
    assert torch.equal(eng._frontend_in[("prefill", 32, F)], fe)
    ref = ReplicaEngine(cfg, lm, n_slots=2, max_ctx=64,
                        prefill_mode="reference")
    rs = ref.kv.acquire()
    rtok, _ = ref.prefill_conversation(rs, _tokens(10, 20), fe)
    assert int(rtok) == int(tok)
    assert all(torch.equal(a, b) for a, b in zip(_snapshot(eng),
                                                 _snapshot(ref)))
    eng.kv.release(s)
    s = eng.kv.acquire()
    eng.prefill_conversation(s, _tokens(11, 20))
    assert (32, 0) in eng._prefill and int(eng.kv.lengths[s]) == 20


def test_prefix_split_refuses_patches(pair):
    jcfg, jm, jp, cfg, m, lm = pair
    eng = ReplicaEngine(cfg, lm, n_slots=2, max_ctx=128)
    s = eng.kv.acquire()
    with pytest.raises(ValueError, match="frontend"):
        eng.prefill_conversation(s, _tokens(12, 20),
                                 torch.from_numpy(_patches(0, cfg, 1)),
                                 prefix_len=8)


# --------------------------------------------------------------------------- #
# served through EngineServer under ConServe, against the JAX engine
# --------------------------------------------------------------------------- #
def test_streams_equal_jax_engine_server(pair):
    """1 prefiller + 1 decoder under ConServe with strict accounting on the
    same trace: every (cid, turn) stream of the port equals the JAX
    server's, with one transfer per conversation of kv_bytes_per_token x
    (frontend_len + its first input)."""
    jcfg, jm, jp, cfg, m, lm = pair
    n = 5
    jreps = [JaxReplica(jcfg, jp, n_slots=3, max_ctx=128, replica_id=0,
                        role="prefill"),
             JaxReplica(jcfg, jp, n_slots=3, max_ctx=128, replica_id=1)]
    jsrv = JaxServer(jax_make_scheduler("conserve"), jreps,
                     record_tokens=True, strict_accounting=True)
    jsrv.serve(jax_generate_trace(n, 3.0, cfg=JaxTraceConfig(**SMALL)))
    reps = [ReplicaEngine(cfg, lm, n_slots=3, max_ctx=128, replica_id=0,
                          role="prefill"),
            ReplicaEngine(cfg, lm, n_slots=3, max_ctx=128, replica_id=1)]
    srv = EngineServer(make_scheduler("conserve"), reps, record_tokens=True,
                       strict_accounting=True)
    trace = generate_trace(n, 3.0, cfg=TraceConfig(**SMALL))
    recs = srv.serve(trace)
    streams = {k: [int(t) for t in v] for k, v in srv.sampled_tokens.items()}
    jstreams = {k: [int(t) for t in v]
                for k, v in jsrv.sampled_tokens.items()}
    assert len(recs) == n and any(turn > 0 for _, turn in streams)
    assert streams == jstreams
    assert srv.n_transfers == jsrv.n_transfers == n
    firsts = sum(c.first_input_len for c in trace)
    assert srv.transfer_bytes == jsrv.transfer_bytes == \
        cfg.kv_bytes_per_token() * (n * cfg.frontend_len + firsts)
