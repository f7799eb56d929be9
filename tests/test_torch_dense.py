"""The reference's dense family on the port: olmo-1b (nonparametric
LayerNorm, tied), stablelm-12b (LayerNorm with qk-norm, untied),
nemotron-4-15b (squared-ReLU MLP without a gate, LayerNorm) and gemma3-12b
(five local layers to one global, `rope_theta_local`, qk-norm, tanh gelu).

On reduced weights converted from the JAX params in this process: the
forward smoke of tests/test_configs_smoke.py and the decode-matches-full,
append-matches-full and 3-step decode of tests/test_models.py, each held
against the JAX model's logits within 1e-4 (float32, as
tests/test_torch_model.py); a ConServe run through `EngineServer` whose
(cid, turn) streams equal the JAX engine's (gemma3's window widened to 256
so the slots of max_ctx 128 fit it, F5; first inputs of at most 50 tokens,
so no prefill has F7's ragged chunk). The reduced configs have head_dim 16
and four heads, so a two-layer config `scaled` to each new head geometry
(H, Hkv, D) = (32, 8, 160), (48, 8, 128), (16, 8, 240) holds the port's
plain attention, which the card's K1 and K2 are checked against, to the
reference with `attention_impl="pallas"` (interpret mode) in prefill and
decode. Each full-width model, built on the meta device, counts the
parameters of the reference's skeleton as Python ints (F10: the
reference's `n_params()` wraps in int32)."""
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
from repro.models import build_model as jax_build  # noqa: E402
from repro.models.model import merge_decode_cache as jax_merge  # noqa: E402
from repro.traces import TraceConfig as JaxTraceConfig  # noqa: E402
from repro.traces import generate_trace as jax_generate_trace  # noqa: E402
from repro_torch.configs import NOT_PORTED, get_config, get_reduced  # noqa: E402
from repro_torch.core import make_scheduler  # noqa: E402
from repro_torch.engine import EngineServer, ReplicaEngine  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import (params_from_numpy,  # noqa: E402
                                        params_to_numpy)
from repro_torch.models.model import merge_decode_cache  # noqa: E402
from repro_torch.models.transformer import LM  # noqa: E402
from repro_torch.traces import TraceConfig, generate_trace  # noqa: E402
from torch_support import one_thread  # noqa: E402,F401

LOGIT_TOL = 1e-4
ATT_TOL = 2e-5  # float32, tests/test_kernels.py
ARCHS = ("olmo-1b", "stablelm-12b", "nemotron-4-15b", "gemma3-12b")
# gemma3's reduced window (64) widened past the slots' max_ctx (F5)
WIDE = {"gemma3-12b": {"window": 256}}
# the Python-int counts of the reference's full-width skeletons
FULL_PARAMS = {"olmo-1b": 1_177_026_560, "stablelm-12b": 12_142_937_600,
               "nemotron-4-15b": 15_628_376_064,
               "gemma3-12b": 12_630_493_440}
# (H, Hkv, D) of the card's new K1/K2 instances
GEOMETRIES = {"stablelm-12b": (32, 8, 160), "nemotron-4-15b": (48, 8, 128),
              "gemma3-12b": (16, 8, 240)}
SMALL = dict(seed=5, first_input_median=30, first_input_sigma=0.3,
             first_input_max=50, append_median=8, append_sigma=0.3,
             append_max=16, output_median=4, output_sigma=0.5, output_max=6,
             mean_turns=2.0, max_turns=3, tool_mean_s=0.01)


def _convert(arch, **over):
    jcfg = jax_reduced(arch).scaled(**over)
    cfg = get_reduced(arch).scaled(**over)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    lm = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu")
    return jcfg, jm, jp, cfg, build_model(cfg), lm


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return _convert(request.param, **WIDE.get(request.param, {}))


def _err(j, t):
    return float(np.max(np.abs(np.asarray(j, np.float32)
                               - t.float().numpy())))


def _tokens(seed, shape, vocab=512):
    return np.random.RandomState(seed).randint(0, vocab, shape).astype(
        np.int32)


_JAX = {}


def jax_prefill(pair, toks):
    """The JAX model's prefill of `toks`, made once per (model, tokens): the
    reference's scan compiles anew on every call, so the tests share it."""
    jcfg, jm, jp = pair[:3]
    key = (id(jp), toks.tobytes(), toks.shape)
    if key not in _JAX:
        _JAX[key] = jm.prefill(jp, jnp.asarray(toks))
    return _JAX[key]


# --------------------------------------------------------------------------- #
# configs, layers and weights
# --------------------------------------------------------------------------- #
def _as_config(cls, cfg):
    """`cfg` rebuilt field by field as a `cls` (the two packages'
    ModelConfig dataclasses have the same fields)."""
    return cls(**{f.name: getattr(cfg, f.name)
                  for f in dataclasses.fields(cfg)})


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    a, b = jax_config(arch), get_config(arch)
    assert _as_config(type(a), b) == a
    assert a.kv_bytes_per_token() == b.kv_bytes_per_token()
    assert a.param_count() == b.param_count()
    assert a.padded_vocab == b.padded_vocab
    assert b.torch_dtype == torch.bfloat16
    assert get_reduced(arch).torch_dtype == torch.float32


def test_registry_keeps_only_the_four_still_missing():
    """Since the vision frontend and the encoder-decoder were ported,
    nothing is missing: `NOT_PORTED` is empty and every architecture of
    the reference's registry resolves to the reference's config."""
    from repro.configs import ALL_ARCHS as JAX_ARCHS
    from repro_torch.configs import ALL_ARCHS
    assert NOT_PORTED == ()
    assert set(ALL_ARCHS) == set(JAX_ARCHS) and len(ALL_ARCHS) == 11
    for arch in JAX_ARCHS:
        assert _as_config(type(jax_config(arch)), get_config(arch)) == \
            jax_config(arch)


@pytest.mark.parametrize("arch,what", [
    ("deepseek-v2-lite-16b", "MLA"), ("llama4-scout-17b-a16e", "MoE"),
    ("whisper-small", "is_encoder_decoder"), ("internvl2-26b", "frontend")])
def test_check_ported_still_refuses(arch, what):
    """MLA, MoE, the encoder-decoder and the vision frontend, each refused
    until it was ported, now build from the reference's reduced config:
    the latent cache or the MoE in every block; whisper's encoder and
    decoder stacks with a "cross" cache section beside "self"; internvl2's
    dense LM. Combinations still not ported stay refused, by name."""
    from repro_torch.models.config import ModelConfig
    cfg = _as_config(ModelConfig, jax_reduced(arch))
    lm = build_model(cfg).init(0, "cpu")
    if what in ("MLA", "MoE"):
        assert all(hasattr(b, "moe") and not hasattr(b, "mlp")
                   for b in lm.blocks)
        assert (what == "MLA") == hasattr(lm.blocks[0].attn, "w_uk")
        return
    cache = build_model(cfg).init_cache(2, 32, "cpu")
    if what == "is_encoder_decoder":
        assert len(lm.encoder) == cfg.n_encoder_layers
        assert set(cache) == {"self", "cross"}
        assert tuple(cache["cross"]["k"].shape) == (
            cfg.n_layers, 2, cfg.encoder_seq, cfg.n_kv_heads, cfg.head_dim)
        with pytest.raises(NotImplementedError, match="gated_mlp"):
            build_model(cfg.scaled(gated_mlp=True))
    else:
        assert cfg.frontend == "vision" and set(cache) == {"groups"}
        with pytest.raises(NotImplementedError, match="vision frontend"):
            build_model(cfg.scaled(block_pattern=("attn_local",) * 5
                                   + ("attn_global",)))


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_lm_counts_the_reference_skeleton(arch):
    """The full-width LM on the meta device (no memory) holds as many
    parameters as the reference's skeleton, counted with Python ints."""
    lm = LM(get_config(arch), "meta")
    got = sum(math.prod(p.shape) for p in lm.parameters())
    skel = jax_build(jax_config(arch)).skeleton()
    want = sum(math.prod(leaf.shape)
               for leaf in jax.tree_util.tree_leaves(skel))
    assert got == want == FULL_PARAMS[arch]


def test_layers_match_reference():
    """nonparametric_ln and squared ReLU, as the reference's layers."""
    from repro.models import layers as jlayers
    from repro_torch.models import layers as tlayers
    x = np.random.RandomState(0).standard_normal((2, 5, 64)).astype(
        np.float32) * 3
    assert _err(jlayers.nonparametric_ln(jnp.asarray(x)),
                tlayers.nonparametric_ln(torch.from_numpy(x))) < 1e-5
    cfg = jax_reduced("nemotron-4-15b")
    assert _err(jlayers.activation(cfg, jnp.asarray(x)),
                tlayers.ACTIVATIONS["squared_relu"](torch.from_numpy(x))) \
        < 1e-5


def test_params_round_trip_and_absent_leaves(pair):
    """The converted tree round-trips leaf by leaf — olmo's norms and
    nemotron's MLP without wg hold no leaf on either side — and a leaf on
    one side only raises, naming it."""
    jcfg, jm, jp, cfg, m, lm = pair
    tree = jax.tree_util.tree_map(np.asarray, jp)
    back = params_to_numpy(lm)
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(back)
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)
    mlp = back["groups"]["p0"]["mlp"]
    assert ("wg" in mlp) == cfg.gated_mlp
    assert bool(back["final_norm"]) == (cfg.norm != "nonparametric_ln")
    extra = jax.tree_util.tree_map(lambda a: a, back)
    extra["groups"]["p0"]["mlp"]["stray"] = mlp["wi"]
    with pytest.raises(ValueError, match="stray"):
        params_from_numpy(extra, cfg, "cpu")
    del back["groups"]["p0"]["mlp"]["wi"]
    with pytest.raises(ValueError, match="wi"):
        params_from_numpy(back, cfg, "cpu")


# --------------------------------------------------------------------------- #
# forward parity and the model invariants of tests/test_models.py
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_forward_smoke_matches_jax(pair, impl):
    """tests/test_configs_smoke.py's forward: prefill and one decode step,
    finite, of the reference's shapes and within LOGIT_TOL of its logits."""
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
    lj = _JAX[key]
    lt, _ = m.decode_step(lm, torch.from_numpy(toks[:, -1]), ct,
                          torch.from_numpy(pos), attention_impl=impl)
    assert torch.isfinite(lt).all()
    assert _err(lj, lt) < LOGIT_TOL


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
    _, jc = jax_prefill(pair, toks[:, :-1])
    assert _err(jm.decode_step(jp, jnp.asarray(toks[:, -1]), jc,
                               jnp.asarray(pos))[0], dec) < LOGIT_TOL
    _, c1 = m.prefill(lm, T(toks[:, :8]))
    app = m.prefill(lm, T(toks[:, 8:]), caches=c1, start_pos=8)[0]
    assert float((full - app).abs().max()) < 2e-4
    _, jc1 = jax_prefill(pair, toks[:, :8])
    assert _err(jm.prefill(jp, jnp.asarray(toks[:, 8:]), caches=jc1,
                           start_pos=8)[0], app) < LOGIT_TOL


def test_three_step_decode_matches_full_and_jax(pair):
    """tests/test_models.py's 3-step decode consistency, the steps folded by
    `merge_decode_cache`; every step's logits and greedy token equal the
    JAX rollout's."""
    jcfg, jm, jp, cfg, m, lm = pair
    toks = _tokens(2, (2, 16))
    T = torch.from_numpy
    full = m.prefill(lm, T(toks))[0]
    assert _err(jax_prefill(pair, toks)[0], full) < LOGIT_TOL
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


def test_gemma3_window_and_local_theta_past_the_window():
    """gemma3 at its reduced window of 64: a 100-token prefill and a decode
    step past the window against the JAX model — the local layers mask by
    the window and rotate by `rope_theta_local`, the global one by
    `rope_theta`."""
    jcfg, jm, jp, cfg, m, lm = _convert("gemma3-12b")
    assert cfg.window == 64 and cfg.rope_theta != cfg.rope_theta_local
    toks = _tokens(3, (1, 100))
    lj, jc = jm.prefill(jp, jnp.asarray(toks))
    lt, c = m.prefill(lm, torch.from_numpy(toks))
    assert _err(lj, lt) < LOGIT_TOL
    pos = np.array([100], np.int32)
    lj, _ = jm.decode_step(jp, jnp.asarray(toks[:, -1]), jc,
                           jnp.asarray(pos))
    lt, _ = m.decode_step(lm, torch.from_numpy(toks[:, -1]), c,
                          torch.from_numpy(pos))
    assert _err(lj, lt) < LOGIT_TOL


# --------------------------------------------------------------------------- #
# served through EngineServer under ConServe, against the JAX engine
# --------------------------------------------------------------------------- #
def test_streams_equal_jax_engine_server(pair):
    """1 prefiller + 1 decoder under ConServe with strict accounting on the
    same trace: every (cid, turn) stream of the port equals the JAX
    server's, with one transfer per conversation."""
    jcfg, jm, jp, cfg, m, lm = pair
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
# the card kernels' plain versions at the real head geometries
# --------------------------------------------------------------------------- #
def _geometry(arch):
    H, Hkv, D = GEOMETRIES[arch]
    over = dict(n_layers=2, n_heads=H, n_kv_heads=Hkv, head_dim=D,
                d_model=128, d_ff=128, vocab_size=256)
    if arch == "gemma3-12b":  # its global layer, alone: K1 and K2 reach it
        over.update(block_pattern=("attn_global",), window=0)
    return _convert(arch, **over)


@pytest.mark.parametrize("arch", sorted(GEOMETRIES))
def test_plain_attention_matches_pallas_at_the_head_geometry(arch):
    """A two-layer model at (H, Hkv, D) of the full width: a 64-token
    prefill and a ragged decode step through the port's plain K2 and K1
    (`attention_impl="cuda"` on CPU tensors) against the reference's Pallas
    kernels in interpret mode; and the kernels alone, plain against Pallas
    on the same inputs."""
    jcfg, jm, jp, cfg, m, lm = _geometry(arch)
    toks = _tokens(4, (2, 64), vocab=256)
    lj, jc = jm.prefill(jp, jnp.asarray(toks), attention_impl="pallas")
    lt, c = m.prefill(lm, torch.from_numpy(toks), attention_impl="cuda")
    assert _err(lj, lt) < LOGIT_TOL
    lens = np.array([40, 63], np.int32)
    kw = dict(kv_lens=lens, ctx_limit=64)
    lj, _ = jm.decode_step(jp, jnp.asarray(toks[:, 5]), jc, jnp.asarray(lens),
                           attention_impl="pallas",
                           **{k: jnp.asarray(v) if k == "kv_lens" else v
                              for k, v in kw.items()})
    lt, _ = m.decode_step(lm, torch.from_numpy(toks[:, 5]), c,
                          torch.from_numpy(lens), attention_impl="cuda",
                          kv_lens=torch.from_numpy(lens), ctx_limit=64)
    assert _err(lj, lt) < LOGIT_TOL

    H, Hkv, D = GEOMETRIES[arch]
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
