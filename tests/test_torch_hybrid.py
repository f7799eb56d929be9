"""The port's recurrentgemma-9b (Griffin hybrid: RG-LRU, RG-LRU, local
attention) against the JAX package's: sliding-window attention, the gelu
gated MLP, the `groups`/`rem` tree, and the model's logits.

Model: `get_reduced("recurrentgemma-9b")` (3 layers — one repetition of the
pattern, no remainder — d_model 64, 4 query heads and 1 KV head of 16,
window 64, lru_width 64, float32) and the same at 5 layers (a remainder of
two RG-LRU layers under "rem"), on weights converted from the JAX params
made in this process (the reference's init folds a salted hash into each
key). Sequences run past the window. Logits and caches agree within 1e-4
and greedy tokens are equal, under both `attention_impl`s ("cuda" runs the
RG-LRU recurrence in K4's plain version here; "torch" in the log-depth
scan). Inputs are made with numpy from a seed and handed to both sides."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.models import attention as jatt  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.model import merge_decode_cache as jax_merge  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.models import attention as tatt  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.convert import (params_from_numpy,  # noqa: E402
                                        params_to_numpy)
from repro_torch.models.model import merge_decode_cache  # noqa: E402
from repro_torch.models.transformer import LM, layer_places  # noqa: E402
from torch_support import one_thread  # noqa: E402,F401

LOGIT_TOL = 1e-4
ATT_TOL = 1e-5
IMPLS = ("torch", "cuda")
ARCH = "recurrentgemma-9b"


def _err(j, t):
    return float(np.max(np.abs(np.asarray(j, np.float32)
                               - t.float().numpy())))


def _randn(seed, shape, sc=1.0):
    return (np.random.RandomState(seed).standard_normal(shape) * sc).astype(
        np.float32)


def _tokens(seed, shape, vocab=512):
    return np.random.RandomState(seed).randint(0, vocab, shape).astype(
        np.int32)


# --------------------------------------------------------------------------- #
# config and layers
# --------------------------------------------------------------------------- #
def test_config_matches_reference():
    a, b = jax_config(ARCH), get_config(ARCH)
    assert a.kv_bytes_per_token() == b.kv_bytes_per_token() == 0
    assert a.state_bytes_fixed() == b.state_bytes_fixed()
    assert a.param_count() == b.param_count()
    assert a.pattern_groups() == b.pattern_groups() == (
        ("rglru", "rglru", "attn_local"), 12, ("rglru", "rglru"))
    assert b.torch_dtype == torch.bfloat16 and b.window == 2048
    r = get_reduced(ARCH)
    assert (r.n_layers, r.window, r.lru_width, r.n_kv_heads) == (3, 64, 64, 1)


def test_full_width_parameters_and_state_match_reference_skeleton():
    """The full-width module tree on the meta device: the reference
    skeleton's leaf count (about 10.44 B; the analytical `param_count`,
    9.57 B, leaves out the gates' two W x W matrices in each of the 26
    RG-LRU layers — ROADMAP queue 3, F8), the layers' places in the tree,
    and the per-slot cache: 26 RG-LRU states of 4096 fp32 + 3 x 4096 bf16
    (1,064,960 B) and 12 local K/V of 1 head of 256 per row."""
    cfg = get_config(ARCH)
    lm = LM(cfg, torch.device("meta"))
    n = sum(p.numel() for p in lm.parameters())
    assert n == jax_build(jax_config(ARCH)).n_params()
    assert 10.4e9 < n < 10.5e9
    gates = 26 * 2 * 4096 * 4096
    assert gates <= n - cfg.param_count() < gates + 10**6
    places = layer_places(cfg)
    assert len(places) == 38 and places[2] == ("groups", "p2", 0)
    assert places[36:] == [("rem", "p0", None), ("rem", "p1", None)]
    cache = build_model(cfg).init_cache(1, 1024, device="meta")
    nb = lambda node: sum(t.numel() * t.element_size()  # noqa: E731
                          for t in node.values())
    state = sum(nb(cache["groups"][p]) for p in ("p0", "p1")) + sum(
        nb(v) for v in cache["rem"].values())
    assert state == 1_064_960
    assert nb(cache["groups"]["p2"]) == 12 * 2 * 1024 * 256 * 2


def test_gelu_is_the_tanh_form_and_the_mlp_dispatches_on_it():
    """jax.nn.gelu defaults to approximate=True; torch's default is the erf
    form, about 1e-3 away."""
    x = _randn(0, (3, 7, 64), 2.0)
    assert _err(jax.nn.gelu(jnp.asarray(x)),
                tlayers.gelu(torch.from_numpy(x))) < 1e-6
    erf = torch.nn.functional.gelu(torch.from_numpy(x))
    assert float((erf - tlayers.gelu(torch.from_numpy(x))).abs().max()) > 1e-4
    jcfg, cfg = jax_reduced(ARCH), get_reduced(ARCH)
    w = {n: _randn(i + 1, s, 0.2) for i, (n, s) in enumerate(
        (("wi", (64, 128)), ("wg", (64, 128)), ("wo", (128, 64))))}
    mlp = tlayers.MLP(cfg, "cpu")
    for n, a in w.items():
        getattr(mlp, n).data.copy_(torch.from_numpy(a))
    want = jlayers.apply_mlp({n: jnp.asarray(a) for n, a in w.items()}, jcfg,
                             jnp.asarray(x))
    assert _err(want, tlayers.apply_mlp(mlp, cfg, torch.from_numpy(x))) < 1e-5


@pytest.mark.parametrize("S,window", [(40, 64), (64, 64), (200, 64),
                                      (256, 96), (512, 64)])
def test_local_attention_matches_jax(S, window):
    """The chunked sliding-window prefill against the reference's, and
    against its windowed online-softmax attention, where the reference's
    chunks fit (S <= 256 or S % 256 == 0)."""
    q, k, v = (_randn(i, (2, S, 4, 16)) for i in range(3))
    want = jatt.local_attention(*(jnp.asarray(a) for a in (q, k, v)), 0,
                                window)
    got = tatt.local_attention(*(torch.from_numpy(a) for a in (q, k, v)), 0,
                               window)
    assert _err(want, got) < ATT_TOL
    pos = torch.arange(S)
    ref = tatt.online_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                pos, pos, causal=True, window=window)
    assert float((ref - got).abs().max()) < ATT_TOL


def test_f7_reference_local_attention_shifts_a_ragged_last_chunk():
    """F7 (ROADMAP queue 3): at S = 300 the reference's `local_attention`
    pads only the left of k/v, so `dynamic_slice` clamps the last (padded)
    chunk's start and its keys no longer sit at the positions the mask
    assumes — it disagrees with its own windowed online attention. The
    port's pads both sides and agrees with it."""
    S, window = 300, 64
    q, k, v = (_randn(10 + i, (1, S, 2, 16)) for i in range(3))
    pos = np.arange(S)
    oracle = jatt.online_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                   jnp.asarray(pos), jnp.asarray(pos),
                                   causal=True, window=window)
    ref = jatt.local_attention(*(jnp.asarray(a) for a in (q, k, v)), 0,
                               window)
    got = tatt.local_attention(*(torch.from_numpy(a) for a in (q, k, v)), 0,
                               window)
    assert _err(oracle, got) < ATT_TOL
    assert float(jnp.max(jnp.abs(ref - oracle))) > 0.1
    assert _err(ref[:, :256], got[:, :256]) < ATT_TOL  # the full chunk


@pytest.mark.parametrize("pos", [5, 70, [3, 100, 64]])
def test_decode_attention_window_mask_matches_jax(pos):
    """Cache row idx is visible only if idx > pos - window; per-sequence
    positions and lengths."""
    B = 3
    q1 = _randn(0, (B, 1, 4, 16))
    kc, vc = _randn(1, (B, 120, 1, 16)), _randn(2, (B, 120, 1, 16))
    kn, vn = _randn(3, (B, 1, 1, 16)), _randn(4, (B, 1, 1, 16))
    lens = np.array([5, 100, 64], np.int32)
    p = np.asarray(pos, np.int32)
    want = jatt.decode_attention(*(jnp.asarray(a) for a in (q1, kc, vc, kn,
                                                            vn)),
                                 kv_lens=jnp.asarray(lens), window=64,
                                 pos=jnp.asarray(p))
    got = tatt.decode_attention(*(torch.from_numpy(a) for a in (q1, kc, vc,
                                                                kn, vn)),
                                kv_lens=torch.from_numpy(lens), window=64,
                                pos=torch.from_numpy(p))
    assert _err(want, got) < ATT_TOL


def test_other_hybrid_variants_still_raise():
    cfg = get_reduced(ARCH)
    for over in ({"qk_norm": True}, {"tie_embeddings": True},
                 {"activation": "silu"}, {"norm": "layernorm"},
                 {"block_pattern": ("rglru", "attn_local")},
                 {"block_pattern": ("rglru", "rglru", "attn_global")},
                 {"n_experts": 4, "top_k": 2, "d_expert": 32}):
        with pytest.raises(NotImplementedError, match="not ported"):
            build_model(cfg.scaled(**over)).init(0, "cpu")


# --------------------------------------------------------------------------- #
# the model on converted weights
# --------------------------------------------------------------------------- #
def _pair(**over):
    jcfg = jax_reduced(ARCH).scaled(**over)
    cfg = get_reduced(ARCH).scaled(**over)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    lm = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu")
    return jm, jp, cfg, build_model(cfg), lm


# 3 layers: one repetition, no remainder. 5 layers: a remainder of two
# RG-LRU layers, and local layers rotating with rope_theta_local != rope_theta
VARIANTS = {"3L": dict(n_layers=3),
            "5L_rem_theta": dict(n_layers=5, rope_theta_local=500.0,
                                 rope_theta=1e6)}


@pytest.fixture(scope="module", params=list(VARIANTS))
def pair(request):
    return _pair(**VARIANTS[request.param])


def _tree_err(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    return max(_err(x, y) for x, y in zip(la, lb))


def _to_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


def _same_layout(jtree, ttree):
    assert jax.tree_util.tree_structure(jtree) == \
        jax.tree_util.tree_structure(ttree)
    for a, b in zip(jax.tree_util.tree_leaves(jtree),
                    jax.tree_util.tree_leaves(ttree)):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")


def test_params_round_trip_and_cache_layout(pair):
    """params_to_numpy gives back the JAX tree bit for bit; init_cache
    equals `lm_cache_skeleton` in structure, shapes and dtypes, below and
    above the window (a local cache is min(ctx, window) long)."""
    jm, jp, cfg, m, lm = pair
    tree = jax.tree_util.tree_map(np.asarray, jp)
    back = params_to_numpy(lm)
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(back)
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)
    assert set(back["groups"]["p0"]) == {"ln1", "ln2", "rglru", "mlp"}
    assert set(back["groups"]["p2"]) == {"ln1", "ln2", "attn", "mlp"}
    assert ("rem" in back) == (cfg.n_layers == 5)
    for ctx in (48, 100):
        _same_layout(jm.init_cache(3, ctx), m.init_cache(3, ctx, "cpu"))
    assert m.init_cache(3, 100, "cpu")["groups"]["p2"]["k"].shape[2] == 64


_PREFIX = {}


def _prefix(pair):
    """The JAX prefill of 80 tokens (past the window of 64) that the tests
    below share, made once per model."""
    key = id(pair[1])
    if key not in _PREFIX:
        jm, jp = pair[0], pair[1]
        toks = _tokens(0, (2, 110))
        _PREFIX[key] = (toks, *jm.prefill(jp, jnp.asarray(toks[:, :80])))
    return _PREFIX[key]


def test_prefill_logits_and_caches_match_jax_past_the_window(pair):
    jm, jp, cfg, m, lm = pair
    toks, lj, cj = _prefix(pair)
    for impl in IMPLS:
        lt, ct = m.prefill(lm, torch.from_numpy(toks[:, :80]),
                           attention_impl=impl)
        assert _err(lj, lt) < LOGIT_TOL, impl
        assert _tree_err(cj, ct) < LOGIT_TOL, impl
        _same_layout(cj, ct)
        np.testing.assert_array_equal(np.argmax(np.asarray(lj), -1),
                                      lt.argmax(-1).numpy())


def test_append_prefill_matches_jax(pair):
    """An append of 30 tokens after 80 (past the window), in both prefix
    layouts: contiguous history, and the engine's slot buffer (prefix at
    position 0, right-padded to 128, masked by kv_lens). It also matches
    the port's one-shot prefill of all 110."""
    jm, jp, cfg, m, lm = pair
    toks, _, c1 = _prefix(pair)
    lj, cj = jm.prefill(jp, jnp.asarray(toks[:, 80:]), caches=c1,
                        start_pos=80)

    def pad(path, a):
        names = [str(getattr(p, "key", p)) for p in path]
        if names[-1] not in ("k", "v"):
            return np.asarray(a)
        w = [(0, 0)] * a.ndim
        w[2 if names[0] == "groups" else 1] = (0, 128 - 80)
        return np.pad(np.asarray(a), w)

    lens = np.array([80, 80], np.int32)
    lj2, _ = jm.prefill(jp, jnp.asarray(toks[:, 80:]),
                        caches=jax.tree_util.tree_map_with_path(
                            lambda p, a: jnp.asarray(pad(p, a)), c1),
                        start_pos=80, kv_lens=jnp.asarray(lens),
                        prefix_start=0)
    for impl in IMPLS:
        lt_full, _ = m.prefill(lm, torch.from_numpy(toks),
                               attention_impl=impl)
        _, t1 = m.prefill(lm, torch.from_numpy(toks[:, :80]),
                          attention_impl=impl)
        lt, ct = m.prefill(lm, torch.from_numpy(toks[:, 80:]), caches=t1,
                           start_pos=80, attention_impl=impl)
        assert _err(lj, lt) < LOGIT_TOL, impl
        assert float((lt_full - lt).abs().max()) < 2e-4, impl
        assert _tree_err(cj, ct) < LOGIT_TOL, impl
        tpad = jax.tree_util.tree_map_with_path(
            lambda p, t: torch.from_numpy(pad(p, t.numpy())), t1)
        lt2, _ = m.prefill(lm, torch.from_numpy(toks[:, 80:]), caches=tpad,
                           start_pos=80, kv_lens=torch.from_numpy(lens),
                           prefix_start=0, attention_impl=impl)
        assert _err(lj2, lt2) < LOGIT_TOL and _err(lj, lt2) < 2e-4, impl


@pytest.mark.parametrize("impl", IMPLS)
def test_rollout_past_the_window_matches_jax(pair, impl):
    """After the 80-token prefill, decode steps at positions 80-82 folded by
    merge_decode_cache (the local K/V grow past the window and the window
    mask hides their oldest rows; states are replaced): logits and updates
    within 1e-4 at every step, the same greedy tokens."""
    jm, jp, cfg, m, lm = pair
    toks, lj, cj = _prefix(pair)
    lt, ct = m.prefill(lm, torch.from_numpy(toks[:, :80]),
                       attention_impl=impl)
    tj = np.argmax(np.asarray(lj)[:, :cfg.vocab_size], -1).astype(np.int32)
    tt = lt[:, :cfg.vocab_size].argmax(-1).to(torch.int32)
    for pos in range(80, 83):
        lj, uj = jm.decode_step(jp, jnp.asarray(tj), cj,
                                jnp.full((2,), pos, jnp.int32))
        lt, ut = m.decode_step(lm, tt, ct, torch.full((2,), pos),
                               attention_impl=impl)
        assert _err(lj, lt) < LOGIT_TOL
        assert _tree_err(uj, ut) < LOGIT_TOL
        cj, ct = jax_merge(cj, uj), merge_decode_cache(ct, ut)
        tj = np.argmax(np.asarray(lj)[:, :cfg.vocab_size], -1).astype(
            np.int32)
        tt = lt[:, :cfg.vocab_size].argmax(-1).to(torch.int32)
        np.testing.assert_array_equal(tj, tt.numpy())
    assert ct["groups"]["p2"]["k"].shape[2] == 83


def test_decode_step_with_kv_lens_and_ctx_limit_matches_jax(pair):
    """The engine's decode call: per-sequence positions and kv_lens over a
    cache, the read trimmed to ctx_limit."""
    jm, jp, cfg, m, lm = pair
    toks, _, cj = _prefix(pair)
    lens = np.array([80, 80], np.int32)
    lj, uj = jm.decode_step(jp, jnp.asarray(toks[:, 0]), cj,
                            jnp.asarray(lens), kv_lens=jnp.asarray(lens))
    for impl in IMPLS:
        _, ct = m.prefill(lm, torch.from_numpy(toks[:, :80]),
                          attention_impl=impl)
        lt, ut = m.decode_step(lm, torch.from_numpy(toks[:, 0]), ct,
                               torch.from_numpy(lens),
                               kv_lens=torch.from_numpy(lens), ctx_limit=128,
                               attention_impl=impl)
        assert _err(lj, lt) < LOGIT_TOL and _tree_err(uj, ut) < LOGIT_TOL


def test_rope_theta_local_is_the_local_layers_theta():
    """A local layer rotates with rope_theta_local, a global one with
    rope_theta (the reference's rule): changing rope_theta alone moves
    nothing in this model (all its attention is local), changing
    rope_theta_local moves the logits. The 5-layer variant above holds
    rope_theta_local != rope_theta against JAX."""
    cfg = get_reduced(ARCH)
    lm = build_model(cfg).init(0, "cpu")
    toks = torch.from_numpy(_tokens(4, (1, 70)))
    base, _ = build_model(cfg).prefill(lm, toks)
    same, _ = build_model(cfg.scaled(rope_theta=1e6)).prefill(lm, toks)
    moved, _ = build_model(cfg.scaled(rope_theta_local=500.0)).prefill(lm,
                                                                        toks)
    assert torch.equal(base, same)
    assert float((moved - base).abs().max()) > 1e-3
    assert tatt._theta_window(cfg, "attn_local") == (10_000.0, 64)
    assert tatt._theta_window(cfg.scaled(rope_theta=7.0),
                              "attn_global") == (7.0, 0)
