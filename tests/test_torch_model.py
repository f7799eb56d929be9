"""The port's model (`repro_torch.models`) against the JAX package's on the
same weights: the JAX params are converted leaf by leaf in this process
(the reference's init folds a salted `hash(path)` into each key, so its
weights differ between processes). Logits agree within 1e-4 in float32 and
greedy tokens are equal, for both attention impls ("cuda" runs the kernels'
plain versions here, on CPU tensors). Configs: the reduced qwen3 (G = 1) and
the same with two KV heads (G = 2)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import attention as jatt  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.model import merge_decode_cache as jax_merge  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.models import attention as tatt  # noqa: E402
from repro_torch.models import build_model, layers as tlayers  # noqa: E402
from repro_torch.models.convert import (params_from_numpy,  # noqa: E402
                                        params_to_numpy)
from repro_torch.models.model import merge_decode_cache  # noqa: E402

LOGIT_TOL = 1e-4
IMPLS = ("torch", "cuda")
VARIANTS = {"g1": {}, "g2": {"n_kv_heads": 2}}


def _pair(variant):
    jcfg = jax_reduced("qwen3-0.6b").scaled(**VARIANTS[variant])
    cfg = get_reduced("qwen3-0.6b").scaled(**VARIANTS[variant])
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jcfg, jm, jp, cfg, build_model(cfg), params_from_numpy(tree, cfg,
                                                                   "cpu")


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def pair(request):
    return _pair(request.param)


def _err(j, t):
    return float(np.max(np.abs(np.asarray(j, np.float32)
                               - t.float().numpy())))


def _tokens(seed, shape, vocab=512):
    return np.random.RandomState(seed).randint(0, vocab, shape).astype(
        np.int32)


# --------------------------------------------------------------------------- #
# config / layers
# --------------------------------------------------------------------------- #
def test_config_matches_reference():
    from repro.configs import get_config as jget
    for arch in ("qwen3-0.6b",):
        a, b = jget(arch), get_config(arch)
        assert a.kv_bytes_per_token() == b.kv_bytes_per_token()
        assert a.state_bytes_fixed() == b.state_bytes_fixed()
        assert a.param_count() == b.param_count()
        assert a.padded_vocab == b.padded_vocab == 152_064
        assert b.torch_dtype == torch.bfloat16
        assert get_reduced(arch).torch_dtype == torch.float32


def test_unported_arch_raises_keyerror():
    with pytest.raises(KeyError, match="not ported"):
        get_config("gemma3-12b")
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-model")


def test_f3_layer_details_match_reference():
    """(1 + scale) RMSNorm and qk-norm, split-half RoPE, sqrt(d) embed."""
    x = np.random.RandomState(0).standard_normal((2, 5, 3, 16)).astype(
        np.float32)
    sc = np.random.RandomState(1).standard_normal(16).astype(np.float32)
    pos = np.arange(4, 9, dtype=np.int32)
    T = torch.from_numpy
    assert _err(jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(sc)),
                tlayers.rmsnorm(T(x), T(sc))) < 1e-5
    assert _err(jatt._qk_norm(jnp.asarray(x), jnp.asarray(sc)),
                tatt._qk_norm(T(x), T(sc))) < 1e-5
    assert _err(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6),
                tlayers.apply_rope(T(x), T(pos), 1e6)) < 1e-5
    assert _err(jatt.rope_single(jnp.asarray(x[:, :1]), jnp.asarray(pos[:2]),
                                 1e6),
                tatt.rope_single(T(x[:, :1]), T(pos[:2]), 1e6)) < 1e-5


def test_init_is_seeded_and_follows_the_reference_scheme():
    cfg = get_reduced("qwen3-0.6b")
    a = build_model(cfg).init(3, "cpu")
    b = build_model(cfg).init(3, "cpu")
    c = build_model(cfg).init(4, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                 b.parameters()))
    assert not torch.equal(a.blocks[0].attn.wq, c.blocks[0].attn.wq)
    assert torch.equal(a.blocks[1].ln1.scale, torch.ones(cfg.d_model))
    assert torch.equal(a.blocks[0].attn.q_scale, torch.ones(cfg.head_dim))
    wi = a.blocks[0].mlp.wi
    assert abs(float(wi.std()) - 1 / np.sqrt(cfg.d_model)) < 0.01
    assert not any(p.requires_grad for p in a.parameters())


def test_entry_points_default_to_cuda_and_refuse_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = get_reduced("qwen3-0.6b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg).init(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg).init_cache(2, 64)


# --------------------------------------------------------------------------- #
# weights and caches in the reference's layout
# --------------------------------------------------------------------------- #
def test_params_round_trip(pair):
    jcfg, jm, jp, cfg, m, lm = pair
    tree = jax.tree_util.tree_map(np.asarray, jp)
    back = params_to_numpy(lm)
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(back)
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)


def test_init_cache_layout_matches_reference(pair):
    jcfg, jm, jp, cfg, m, lm = pair
    jc = jm.init_cache(3, 64)
    tc = m.init_cache(3, 64, device="cpu")
    assert jax.tree_util.tree_structure(jc) == \
        jax.tree_util.tree_structure(tc)
    for a, b in zip(jax.tree_util.tree_leaves(jc),
                    jax.tree_util.tree_leaves(tc)):
        assert tuple(a.shape) == tuple(b.shape)


# --------------------------------------------------------------------------- #
# forward parity
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_logits_and_cache_match_jax(pair, impl):
    jcfg, jm, jp, cfg, m, lm = pair
    toks = _tokens(0, (2, 37))
    lj, cj = jm.prefill(jp, jnp.asarray(toks))
    lt, ct = m.prefill(lm, torch.from_numpy(toks), attention_impl=impl)
    assert _err(lj, lt) < LOGIT_TOL
    for a, b in zip(jax.tree_util.tree_leaves(cj),
                    jax.tree_util.tree_leaves(ct)):
        assert _err(a, b) < LOGIT_TOL
    np.testing.assert_array_equal(np.argmax(np.asarray(lj), -1),
                                  lt.argmax(-1).numpy())


@pytest.mark.parametrize("impl", IMPLS)
def test_padded_append_prefill_with_kv_lens_matches_jax(pair, impl):
    """Engine-mode append: the prefix buffer starts at 0, is right-padded
    past each sequence's live length, and kv_lens masks the padding; the
    token batch is padded and logits are gathered at the last live row."""
    jcfg, jm, jp, cfg, m, lm = pair
    prefix = _tokens(1, (1, 64))
    _, jcache = jm.prefill(jp, jnp.asarray(prefix))
    tcache = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                    jcache)
    prev = 41
    app = np.zeros((1, 32), np.int32)
    app[0, :19] = _tokens(2, 19)
    kw = dict(start_pos=prev, prefix_start=0, logits_at=18)
    lj, nj = jm.prefill(jp, jnp.asarray(app), caches=jcache,
                        kv_lens=jnp.asarray([prev]), **kw)
    lt, nt = m.prefill(lm, torch.from_numpy(app), caches=tcache,
                       kv_lens=torch.tensor([prev]), attention_impl=impl,
                       **kw)
    assert _err(lj, lt) < LOGIT_TOL
    for a, b in zip(jax.tree_util.tree_leaves(nj),
                    jax.tree_util.tree_leaves(nt)):
        assert _err(a, b) < LOGIT_TOL


@pytest.mark.parametrize("impl", IMPLS)
def test_decode_step_logits_match_jax(pair, impl):
    """Ragged kv_lens over a shared buffer, trimmed by ctx_limit, with one
    slot longer than the trimmed read (its lanes are garbage-in in both
    frameworks, but must still agree)."""
    jcfg, jm, jp, cfg, m, lm = pair
    _, jcache = jm.prefill(jp, jnp.asarray(_tokens(3, (3, 96))))
    tcache = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                    jcache)
    lens = np.array([5, 60, 90], np.int32)
    tok = _tokens(4, 3)
    lj, uj = jm.decode_step(jp, jnp.asarray(tok), jcache, jnp.asarray(lens),
                            kv_lens=jnp.asarray(lens), ctx_limit=64)
    lt, ut = m.decode_step(lm, torch.from_numpy(tok), tcache,
                           torch.from_numpy(lens),
                           kv_lens=torch.from_numpy(lens), ctx_limit=64,
                           attention_impl=impl)
    assert _err(lj, lt) < LOGIT_TOL
    for a, b in zip(jax.tree_util.tree_leaves(uj),
                    jax.tree_util.tree_leaves(ut)):
        assert _err(a, b) < LOGIT_TOL


def test_rollout_with_merge_matches_jax(pair):
    """prefill -> 4 decode steps folded by merge_decode_cache: same greedy
    tokens as the reference's rollout, logits within tolerance."""
    jcfg, jm, jp, cfg, m, lm = pair
    prompt = _tokens(5, (1, 21))
    lj, cj = jm.prefill(jp, jnp.asarray(prompt))
    lt, ct = m.prefill(lm, torch.from_numpy(prompt))
    tj, tt = [int(jnp.argmax(lj[0]))], [int(lt[0].argmax())]
    for pos in range(21, 25):
        lj, uj = jm.decode_step(jp, jnp.asarray([tj[-1]]), cj,
                                jnp.asarray([pos]))
        lt, ut = m.decode_step(lm, torch.tensor([tt[-1]]), ct,
                               torch.tensor([pos]))
        assert _err(lj, lt) < LOGIT_TOL
        cj, ct = jax_merge(cj, uj), merge_decode_cache(ct, ut)
        tj.append(int(jnp.argmax(lj[0, :cfg.vocab_size])))
        tt.append(int(lt[0, :cfg.vocab_size].argmax()))
    assert tj == tt
    assert ct["groups"]["p0"]["k"].shape[2] == 25


# --------------------------------------------------------------------------- #
# attention pieces
# --------------------------------------------------------------------------- #
def test_online_attention_with_kv_valid_matches_jax():
    rs = np.random.RandomState(0)
    q = rs.standard_normal((2, 40, 4, 16)).astype(np.float32)
    k = rs.standard_normal((2, 100, 4, 16)).astype(np.float32)
    v = rs.standard_normal((2, 100, 4, 16)).astype(np.float32)
    qp = np.arange(60, 100, dtype=np.int32)
    kp = np.arange(100, dtype=np.int32)
    valid = np.ones((2, 100), bool)
    valid[0, 30:60] = False
    T = torch.from_numpy
    for kw in ({"window": 0}, {"window": 24}):
        want = jatt.online_attention(*(jnp.asarray(x) for x in (q, k, v, qp,
                                                                kp)),
                                     kv_valid=jnp.asarray(valid), q_chunk=16,
                                     kv_chunk=32, **kw)
        got = tatt.online_attention(T(q), T(k), T(v), T(qp), T(kp),
                                    kv_valid=T(valid), q_chunk=16,
                                    kv_chunk=32, **kw)
        assert _err(want, got) < 2e-5


def test_quantized_kv_round_trip_matches_jax():
    cfg = get_reduced("qwen3-0.6b").scaled(kv_cache_dtype="int8")
    jcfg = jax_reduced("qwen3-0.6b").scaled(kv_cache_dtype="int8")
    x = np.random.RandomState(0).standard_normal((2, 3, 4, 16)).astype(
        np.float32) * 3
    qj = jatt.quantize_kv(jnp.asarray(x), jcfg)
    qt = tatt.quantize_kv(torch.from_numpy(x), cfg)
    assert qt.dtype == torch.int8
    np.testing.assert_array_equal(np.asarray(qj), qt.numpy())
    assert _err(jatt.dequantize_kv(qj, jcfg),
                tatt.dequantize_kv(qt, cfg)) == 0.0


def test_unported_layer_kinds_raise():
    cfg = get_reduced("qwen3-0.6b").scaled(block_pattern=("attn_local",),
                                           window=16)
    with pytest.raises(NotImplementedError, match="not ported"):
        build_model(cfg).init(0, "cpu")
