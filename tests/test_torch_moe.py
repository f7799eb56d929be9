"""MLA and MoE on the port: deepseek-v2-lite-16b (MLA attention, 64 routed
experts top-6 + 2 shared) and llama4-scout-17b-a16e (global GQA at G = 5,
16 experts top-1 + 1 shared).

Inputs come from numpy seeds and the reference side runs on JAX on the
CPU. `apply_moe` is held against `repro.models.moe.apply_moe` on the same
router and experts, dropless and at cf 0.25 (the reference's
`test_moe_capacity_drops_tokens`): the chosen experts, the kept mask and
the output (within 1e-5). A routing flip between the two packages is
reported with the router's top-K margin at the flipped token, never hidden.
MLA's expanded prefill, its append against a padded slot prefix and its
absorbed decode are held against the reference's layer. On reduced weights
converted from the JAX params in this process (cf = E/K, dropless, as
`reduced_config` sets it): the forward, decode and append against a full
prefill, the 3-step decode of tests/test_models.py (logits within 1e-4 of
the JAX model's), the MLA cache's compression and a full-width deepseek
transfer's bytes (31,104 a token in bf16), a ConServe run whose streams
equal the JAX engine's (dropless, and deepseek at the published cf 1.25,
where dead decode lanes and a prefill bucket's pad rows take capacity in
both engines alike), the weights' round trip with the router kept float32
in a bf16 model, each full-width LM on the meta device counting the
reference skeleton's parameters, the MoE and MLA program bodies reading
nothing back to the host, and the plain K1/K2 against the Pallas kernels
at llama4-scout's heads (40 over 8 of 128, G = 5)."""
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
from repro.kernels.decode_attention import flash_decode_attention as pallas_decode  # noqa: E402
from repro.kernels.prefill_attention import flash_prefill_attention as pallas_prefill  # noqa: E402
from repro.models import attention as jatt  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.model import merge_decode_cache as jax_merge  # noqa: E402
from repro.traces import TraceConfig as JaxTraceConfig  # noqa: E402
from repro.traces import generate_trace as jax_generate_trace  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.core import make_scheduler  # noqa: E402
from repro_torch.engine import EngineServer, ReplicaEngine  # noqa: E402
from repro_torch.engine.kvcache import SlotKVCache, leaves  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as tatt  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.convert import (params_from_numpy,  # noqa: E402
                                        params_to_numpy)
from repro_torch.models.model import merge_decode_cache  # noqa: E402
from repro_torch.models.transformer import LM  # noqa: E402
from repro_torch.traces import TraceConfig, generate_trace  # noqa: E402
from torch_support import NoHostRead, one_thread  # noqa: E402,F401

LOGIT_TOL = 1e-4
MOE_TOL = 1e-5
ATT_TOL = 2e-5  # float32, tests/test_kernels.py
ARCHS = ("deepseek-v2-lite-16b", "llama4-scout-17b-a16e")
# the Python-int counts of the reference's full-width skeletons
FULL_PARAMS = {"deepseek-v2-lite-16b": 16_210_311_168,
               "llama4-scout-17b-a16e": 107_771_827_200}
SMALL = dict(seed=5, first_input_median=30, first_input_sigma=0.3,
             first_input_max=50, append_median=8, append_sigma=0.3,
             append_max=16, output_median=4, output_sigma=0.5, output_max=6,
             mean_turns=2.0, max_turns=3, tool_mean_s=0.01)


def _as_config(cls, cfg):
    return cls(**{f.name: getattr(cfg, f.name)
                  for f in dataclasses.fields(cfg)})


def _convert(arch, **over):
    jcfg = jax_reduced(arch).scaled(**over)
    cfg = get_reduced(arch).scaled(**over)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    lm = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu")
    return jcfg, jm, jp, cfg, build_model(cfg), lm


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return _convert(request.param)


def _err(j, t):
    return float(np.max(np.abs(np.asarray(j, np.float32)
                               - t.float().numpy())))


def _tokens(seed, shape, vocab=512):
    return np.random.RandomState(seed).randint(0, vocab, shape).astype(
        np.int32)


_JAX = {}


def jax_prefill(pair, toks):
    """The JAX model's prefill of `toks`, made once per (model, tokens)."""
    jcfg, jm, jp = pair[:3]
    key = (id(jp), toks.tobytes(), toks.shape)
    if key not in _JAX:
        _JAX[key] = jm.prefill(jp, jnp.asarray(toks))
    return _JAX[key]


# --------------------------------------------------------------------------- #
# apply_moe against the reference's
# --------------------------------------------------------------------------- #
def _jax_routing(params, cfg, x, group_size):
    """The reference's routing, as the first lines of its `apply_moe`
    compute it (which returns only the output): (probs, eidx, keep)."""
    B, S, _ = x.shape
    xg, _, _ = jmoe._group_tokens(x, min(group_size, B * S))
    G, n, _ = xg.shape
    E, K = cfg.n_experts, cfg.top_k
    cap = max(1, int(-(-n * K * cfg.capacity_factor // E)))
    probs = jax.nn.softmax(xg.astype(jnp.float32) @ params["router"], -1)
    _, eidx = jax.lax.top_k(probs, K)
    oh = jax.nn.one_hot(eidx, E, dtype=jnp.int32)
    flat = oh.reshape(G, n * K, E)
    pos = ((jnp.cumsum(flat, 1) - flat).reshape(G, n, K, E) * oh).sum(-1)
    return np.asarray(probs), np.asarray(eidx), np.asarray(pos < cap)


def _sorted_probs(probs, i, k):
    """The router's k largest probabilities at the token of flat index i of
    (G, n), in descending order: how near a tie its choice was."""
    return np.sort(probs.reshape(-1, probs.shape[-1])[i])[::-1][:k].tolist()


@pytest.mark.parametrize("arch,cf,group_size", [
    ("deepseek-v2-lite-16b", None, 1024), ("llama4-scout-17b-a16e", None, 1024),
    ("llama4-scout-17b-a16e", 0.25, 16), ("deepseek-v2-lite-16b", 0.25, 16),
    ("deepseek-v2-lite-16b", 1.25, 24)],
    ids=["deepseek-dropless", "llama4-dropless", "llama4-cf0.25",
         "deepseek-cf0.25", "deepseek-cf1.25-ragged-group"])
def test_apply_moe_matches_reference(arch, cf, group_size):
    """The same router and experts through both packages' `apply_moe`:
    equal chosen experts and kept mask, outputs within 1e-5. cf None is
    the reduced config's dropless E/K; cf 0.25 drops (the reference's
    `test_moe_capacity_drops_tokens`: llama4-scout, groups of 16); a group
    of 24 over 64 tokens pads the last group."""
    from repro.models.layers import init_params as jax_init
    jcfg = jax_reduced(arch)
    if cf is not None:
        jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
    cfg = _as_config(type(get_reduced(arch)), jcfg)
    jp = jax_init(jmoe.moe_skeleton(jcfg), jax.random.PRNGKey(1))
    moe = tmoe.MoE(cfg, "cpu")
    for n, t in moe.named_parameters():
        src = jp
        for part in n.split("."):
            src = src[part]
        t.data.copy_(torch.from_numpy(np.array(src)))
    assert moe.router.dtype == torch.float32
    x = np.random.RandomState(2).standard_normal((2, 32, cfg.d_model)) \
        .astype(np.float32)
    want = jmoe.apply_moe(jp, jcfg, jnp.asarray(x), group_size=group_size)
    got = tmoe.apply_moe(moe, cfg, torch.from_numpy(x), group_size=group_size)

    probs, j_eidx, j_keep = _jax_routing(jp, jcfg, jnp.asarray(x), group_size)
    xg, _ = tmoe.group_tokens(torch.from_numpy(x), min(group_size, 64))
    _, t_eidx, _, t_keep = tmoe.route(moe, cfg, xg)
    # the tokens, not the zero rows that pad the last group: a pad row's
    # router probabilities are all equal, its places come after every
    # token's, and nothing reads it back, so how a tie is broken there
    # (JAX and torch differ) reaches no output
    N = x.shape[0] * x.shape[1]
    j_eidx, j_keep = (a.reshape(-1, cfg.top_k)[:N] for a in (j_eidx, j_keep))
    t_eidx, t_keep = (a.reshape(-1, cfg.top_k)[:N] for a in (t_eidx, t_keep))
    flips = np.flatnonzero((j_eidx != t_eidx.numpy()).any(-1))
    assert flips.size == 0, (
        f"routing flips at tokens {flips.tolist()}: the router's largest "
        f"probabilities there "
        f"{[_sorted_probs(probs, i, cfg.top_k + 1) for i in flips]}")
    np.testing.assert_array_equal(j_keep, t_keep.numpy())
    if cf == 0.25:
        assert not j_keep.all()  # the case does drop
    assert tuple(got.shape) == x.shape and torch.isfinite(got).all()
    assert _err(want, got) < MOE_TOL


# --------------------------------------------------------------------------- #
# MLA's layer against the reference's
# --------------------------------------------------------------------------- #
def test_mla_prefill_append_and_absorbed_decode_match_reference():
    """One MLA layer of the reduced deepseek: a fresh 24-token prefill, an
    append of 8 against a slot prefix padded past its live rows (kv_lens,
    prefix_start=0), and the absorbed decode against a ragged cache, each
    against the reference's `mla_prefill` / `mla_decode` on the same
    weights and inputs."""
    from repro.models.layers import init_params as jax_init
    jcfg = jax_reduced("deepseek-v2-lite-16b")
    cfg = get_reduced("deepseek-v2-lite-16b")
    jp = jax_init(jatt.attn_skeleton(jcfg, "attn_mla"), jax.random.PRNGKey(3))
    attn = tatt.MLA(cfg, "cpu")
    for n, t in attn.named_parameters():
        t.data.copy_(torch.from_numpy(np.array(jp[n])))
    rs = np.random.RandomState(4)
    x = rs.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    T, J = torch.from_numpy, jnp.asarray
    jo, jc = jatt.mla_prefill(jp, jcfg, J(x), 0)
    to, tc = tatt.mla_prefill(attn, cfg, T(x), 0)
    assert _err(jo, to) < LOGIT_TOL
    for n in ("ckv", "krope"):
        assert _err(jc[n], tc[n]) < LOGIT_TOL

    # append: the slot buffer holds 24 rows of which 17 and 24 are live
    lens = np.array([17, 24], np.int32)
    xa = rs.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    jo, _ = jatt.mla_prefill(jp, jcfg, J(xa), 24, prefix_kv=jc,
                             kv_lens=J(lens), prefix_start=0)
    to, _ = tatt.mla_prefill(attn, cfg, T(xa), 24, prefix_kv=tc,
                             kv_lens=T(lens), prefix_start=0)
    assert _err(jo, to) < LOGIT_TOL

    x1 = rs.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    jo, ju = jatt.mla_decode(jp, jcfg, J(x1), J(lens), jc, kv_lens=J(lens),
                             ctx_limit=20)
    to, tu = tatt.mla_decode(attn, cfg, T(x1), T(lens), tc, kv_lens=T(lens),
                             ctx_limit=20)
    assert _err(jo, to) < LOGIT_TOL
    for n in ("ckv", "krope"):
        assert _err(ju[n], tu[n]) < LOGIT_TOL


# --------------------------------------------------------------------------- #
# the reduced models against the JAX model
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_forward_smoke_matches_jax(pair, impl):
    """Prefill and one decode step, finite, of the reference's shapes and
    within LOGIT_TOL of its logits and caches."""
    jcfg, jm, jp, cfg, m, lm = pair
    toks = _tokens(0, (2, 24))
    lj, cj = jax_prefill(pair, toks)
    lt, ct = m.prefill(lm, torch.from_numpy(toks), attention_impl=impl)
    assert tuple(lt.shape) == (2, cfg.padded_vocab)
    assert torch.isfinite(lt).all()
    assert _err(lj, lt) < LOGIT_TOL
    for a, b in zip(jax.tree_util.tree_leaves(cj),
                    jax.tree_util.tree_leaves(ct)):
        assert _err(a, b) < LOGIT_TOL
    pos = np.full(2, 24, np.int32)
    key = ("decode", id(jp))
    if key not in _JAX:
        _JAX[key] = jm.decode_step(jp, jnp.asarray(toks[:, -1]), cj,
                                   jnp.asarray(pos))[0]
    lt, _ = m.decode_step(lm, torch.from_numpy(toks[:, -1]), ct,
                          torch.from_numpy(pos), attention_impl=impl)
    assert torch.isfinite(lt).all()
    assert _err(_JAX[key], lt) < LOGIT_TOL


def test_decode_and_append_match_full_prefill(pair):
    """tests/test_models.py's decode-matches-full-prefill and
    append-matches-full, on the port, each against the JAX logits too."""
    jcfg, jm, jp, cfg, m, lm = pair
    toks = _tokens(2, (2, 16))
    T = torch.from_numpy
    full = m.prefill(lm, T(toks))[0]
    assert _err(jax_prefill(pair, toks)[0], full) < LOGIT_TOL
    _, c = m.prefill(lm, T(toks[:, :-1]))
    pos = np.full(2, 15, np.int32)
    dec = m.decode_step(lm, T(toks[:, -1]), c, T(pos))[0]
    assert float((full - dec).abs().max()) < 2e-4
    _, c1 = m.prefill(lm, T(toks[:, :8]))
    app = m.prefill(lm, T(toks[:, 8:]), caches=c1, start_pos=8)[0]
    assert float((full - app).abs().max()) < 2e-4
    _, jc1 = jax_prefill(pair, toks[:, :8])
    assert _err(jm.prefill(jp, jnp.asarray(toks[:, 8:]), caches=jc1,
                           start_pos=8)[0], app) < LOGIT_TOL


def test_three_step_decode_matches_full_and_jax(pair):
    """tests/test_models.py::test_multi_step_decode_consistency on the
    port, the steps folded by `merge_decode_cache`; every step's logits and
    greedy token equal the JAX rollout's."""
    jcfg, jm, jp, cfg, m, lm = pair
    toks = _tokens(2, (2, 16))
    T = torch.from_numpy
    full = m.prefill(lm, T(toks))[0]
    _, c = m.prefill(lm, T(toks[:, :-3]))
    _, jc = jax_prefill(pair, toks[:, :-3])
    for i, pos in enumerate(range(13, 16)):
        p = np.full(2, pos, np.int32)
        lt, up = m.decode_step(lm, T(toks[:, -3 + i]), c, T(p))
        lj, jup = jm.decode_step(jp, jnp.asarray(toks[:, -3 + i]), jc,
                                 jnp.asarray(p))
        assert _err(lj, lt) < LOGIT_TOL
        np.testing.assert_array_equal(
            np.argmax(np.asarray(lj)[:, :cfg.vocab_size], -1),
            lt[:, :cfg.vocab_size].argmax(-1).numpy())
        c, jc = merge_decode_cache(c, up), jax_merge(jc, jup)
    assert float((full - lt).abs().max()) < 3e-4


def test_mla_cache_is_compressed_and_a_transfer_moves_the_latent():
    """tests/test_models.py::test_mla_cache_is_compressed on the port, and
    a full-width deepseek slot's transfer package: 27 x (512 + 64) x 2 =
    31,104 bytes a token in bf16, the config's kv_bytes_per_token."""
    cfg = get_reduced("deepseek-v2-lite-16b")
    m = build_model(cfg)
    _, caches = m.prefill(m.init(0, "cpu"), torch.from_numpy(_tokens(
        1, (1, 8))))
    names = {p[-1] for p, _ in leaves(caches)}
    assert names == {"ckv", "krope"}
    per_tok = cfg.kv_lora_rank + cfg.qk_rope_dim
    assert per_tok < 2 * cfg.n_heads * (cfg.qk_nope_dim + cfg.qk_rope_dim) / 3

    full = get_config("deepseek-v2-lite-16b")
    assert full.kv_bytes_per_token() == 31_104
    kv = SlotKVCache(build_model(full), 2, 16, device="cpu")
    s = kv.acquire()
    kv.lengths[s] = 11
    assert kv.nbytes_of(kv.export_slot(s)) == 31_104 * 11


# --------------------------------------------------------------------------- #
# served through EngineServer under ConServe, against the JAX engine
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch,cf", [
    ("deepseek-v2-lite-16b", None), ("llama4-scout-17b-a16e", None),
    ("deepseek-v2-lite-16b", 1.25)],
    ids=["deepseek-dropless", "llama4-dropless", "deepseek-cf1.25"])
def test_streams_equal_jax_engine_server(arch, cf):
    """1 prefiller + 1 decoder under ConServe with strict accounting on the
    same trace: every (cid, turn) stream of the port equals the JAX
    server's, with one transfer per conversation. At the published cf 1.25
    tokens are dropped, and the dead lanes and pad rows that take capacity
    are the same in both engines."""
    over = {} if cf is None else {"capacity_factor": cf}
    jcfg, jm, jp, cfg, m, lm = _convert(arch, **over)
    jreps = [JaxReplica(jcfg, jp, n_slots=3, max_ctx=128, replica_id=0,
                        role="prefill"),
             JaxReplica(jcfg, jp, n_slots=3, max_ctx=128, replica_id=1)]
    jsrv = JaxServer(jax_make_scheduler("conserve"), jreps,
                     record_tokens=True, strict_accounting=True)
    jsrv.serve(jax_generate_trace(3, 3.0, cfg=JaxTraceConfig(**SMALL)))
    reps = [ReplicaEngine(cfg, lm, n_slots=3, max_ctx=128, replica_id=0,
                          role="prefill"),
            ReplicaEngine(cfg, lm, n_slots=3, max_ctx=128, replica_id=1)]
    srv = EngineServer(make_scheduler("conserve"), reps, record_tokens=True,
                       strict_accounting=True)
    recs = srv.serve(generate_trace(3, 3.0, cfg=TraceConfig(**SMALL)))
    streams = {k: [int(t) for t in v] for k, v in srv.sampled_tokens.items()}
    jstreams = {k: [int(t) for t in v]
                for k, v in jsrv.sampled_tokens.items()}
    assert len(recs) == 3 and len(streams) >= 3
    assert streams == jstreams
    assert srv.n_transfers == jsrv.n_transfers == 3


# --------------------------------------------------------------------------- #
# weights and full-width counts
# --------------------------------------------------------------------------- #
def test_params_round_trip_and_router_stays_float32(pair):
    """The converted tree round-trips leaf by leaf, the MoE's shared MLP
    nested under it; in a bf16 model every leaf is bf16 but the router,
    which stays float32; a stray leaf in the nested MLP raises, naming
    it."""
    jcfg, jm, jp, cfg, m, lm = pair
    tree = jax.tree_util.tree_map(np.asarray, jp)
    back = params_to_numpy(lm)
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(back)
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)
    bf = params_from_numpy(back, cfg.scaled(dtype="bfloat16"), "cpu")
    dts = {n: p.dtype for n, p in bf.named_parameters()}
    assert all(dt == (torch.float32 if n.endswith(".router")
                      else torch.bfloat16) for n, dt in dts.items())
    assert sum(n.endswith(".moe.router") for n in dts) == cfg.n_layers
    np.testing.assert_array_equal(
        bf.blocks[0].moe.router.numpy(), back["groups"]["p0"]["moe"]
        ["router"][0])
    back["groups"]["p0"]["moe"]["shared"]["stray"] = \
        back["groups"]["p0"]["moe"]["shared"]["wi"]
    with pytest.raises(ValueError, match="shared.*stray"):
        params_from_numpy(back, cfg, "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_lm_counts_the_reference_skeleton(arch):
    """The full-width LM on the meta device (no memory) holds as many
    parameters as the reference's skeleton, counted with Python ints, and
    its config is the reference's field for field."""
    cfg = get_config(arch)
    assert _as_config(type(jax_config(arch)), cfg) == jax_config(arch)
    lm = LM(cfg, "meta")
    got = sum(math.prod(p.shape) for p in lm.parameters())
    skel = jax_build(jax_config(arch)).skeleton()
    want = sum(math.prod(leaf.shape)
               for leaf in jax.tree_util.tree_leaves(skel))
    assert got == want == FULL_PARAMS[arch]
    assert cfg.kv_bytes_per_token() == jax_config(arch).kv_bytes_per_token()


# --------------------------------------------------------------------------- #
# program bodies: nothing read back to the host
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_and_mla_bodies_read_nothing_back(arch):
    """At the published cf 1.25 (drops), the decode chunk's body, a turn-1
    prefill's and an append's run with the host reading nothing (the ops a
    CUDA graph cannot capture raise), and so do `apply_moe` and MLA's
    decode alone."""
    cfg = get_reduced(arch).scaled(capacity_factor=1.25)
    eng = ReplicaEngine(cfg, build_model(cfg).init(0, "cpu"), n_slots=4,
                        max_ctx=64)
    nt = np.zeros(4, np.int32)
    em = np.zeros(4, bool)
    for i, n in enumerate((23, 9)):
        s = eng.kv.acquire()
        t, _ = eng.prefill_conversation(s, np.arange(5 + i, 5 + i + n,
                                                     dtype=np.int32))
        nt[s], em[s] = int(t), True
    rem = np.where(em, 4, 0).astype(np.int32)
    free = eng.kv.acquire()
    toks = np.arange(3, 30, dtype=np.int32)
    runs = [(eng._get_fused(4, 64),
             np.concatenate([nt, eng.kv.lengths, em, rem, [0]])),
            (eng._get_prefill(32), eng._prefill_host(free, toks, 32, 0)),
            (eng._get_append(32, 64),
             eng._prefill_host(0, toks, 32, int(eng.kv.lengths[0])))]
    for prog, host in runs:
        prog.load(host)
        with NoHostRead():
            prog.run_eager()
    block = eng.params.blocks[0]
    with NoHostRead():
        tmoe.apply_moe(block.moe, cfg, torch.randn(3, 5, cfg.d_model))


# --------------------------------------------------------------------------- #
# the card kernels' plain versions at llama4-scout's heads (G = 5)
# --------------------------------------------------------------------------- #
def test_plain_attention_matches_pallas_at_g5():
    """A two-layer llama4-scout at (H, Hkv, D) = (40, 8, 128): a 64-token
    prefill and a ragged decode step through the port's plain K2 and K1
    (`attention_impl="cuda"` on CPU tensors) against the reference with
    Pallas in interpret mode; and the kernels alone, plain against Pallas
    on the same inputs."""
    H, Hkv, D = 40, 8, 128
    jcfg, jm, jp, cfg, m, lm = _convert(
        "llama4-scout-17b-a16e", n_layers=2, n_heads=H, n_kv_heads=Hkv,
        head_dim=D, d_model=128, d_ff=128, d_expert=32, vocab_size=256)
    toks = _tokens(4, (2, 64), vocab=256)
    lj, jc = jm.prefill(jp, jnp.asarray(toks), attention_impl="pallas")
    lt, c = m.prefill(lm, torch.from_numpy(toks), attention_impl="cuda")
    assert _err(lj, lt) < LOGIT_TOL
    lens = np.array([40, 63], np.int32)
    lj, _ = jm.decode_step(jp, jnp.asarray(toks[:, 5]), jc, jnp.asarray(lens),
                           attention_impl="pallas", kv_lens=jnp.asarray(lens),
                           ctx_limit=64)
    lt, _ = m.decode_step(lm, torch.from_numpy(toks[:, 5]), c,
                          torch.from_numpy(lens), attention_impl="cuda",
                          kv_lens=torch.from_numpy(lens), ctx_limit=64)
    assert _err(lj, lt) < LOGIT_TOL

    rs = np.random.RandomState(5)
    r = lambda *s: (rs.standard_normal(s) * 0.6).astype(np.float32)  # noqa: E731
    q, k, v = r(1, 64, H, D), r(1, 64, Hkv, D), r(1, 64, Hkv, D)
    G = H // Hkv
    want = pallas_prefill(*(jnp.asarray(x).transpose(0, 2, 1, 3)
                            for x in (q, np.repeat(k, G, 2),
                                      np.repeat(v, G, 2))))
    got = ops.prefill_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    assert _err(jnp.transpose(want, (0, 2, 1, 3)), got) < ATT_TOL
    qd, kc, vc = r(3, H, D), r(3, 256, Hkv, D), r(3, 256, Hkv, D)
    lens = np.array([1, 130, 256], np.int32)
    want = pallas_decode(jnp.asarray(qd), jnp.asarray(kc), jnp.asarray(vc),
                         jnp.asarray(lens))
    got = ops.decode_attention(*(torch.from_numpy(x) for x in (qd, kc, vc,
                                                               lens)))
    assert _err(want, got) < ATT_TOL
