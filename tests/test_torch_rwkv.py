"""The port's RWKV6 family against the JAX package's: the WKV recurrence
(K3's plain version and the chunked model path) and the rwkv6-3b model.

WKV6: on the CPU, `ops.wkv6` takes K3's plain version (the step recurrence
of `kernels/ref.py`); it and the port's `wkv6_chunked` are held against the
JAX `wkv6_ref`, the Pallas `wkv6_pallas` in interpret mode and the JAX
`wkv6_chunked`, on the shapes and at the 5e-5 of tests/test_kernels.py.
K3 itself is held against its plain version on a card
(tests/test_torch_gpu.py).

Model: `get_reduced("rwkv6-3b")` (2 layers, d_model 64, head size 16,
float32) on weights converted from the JAX params in this process (the
reference's init folds a salted hash into each key). Logits agree within
1e-4 and greedy tokens are equal, under both `attention_impl`s ("cuda"
runs the WKV in K3's plain version here; "torch" in `wkv6_chunked`).
Inputs are made with numpy from a seed and handed to both sides."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.rwkv6_kernel import wkv6_pallas  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.model import merge_decode_cache as jax_merge  # noqa: E402
from repro.models.recurrent import wkv6_chunked as jax_chunked  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import build_model, layers as tlayers  # noqa: E402
from repro_torch.models.convert import (params_from_numpy,  # noqa: E402
                                        params_to_numpy)
from repro_torch.models.model import merge_decode_cache  # noqa: E402
from repro_torch.models.recurrent import wkv6_chunked  # noqa: E402
from repro_torch.models.transformer import LM  # noqa: E402
from torch_support import one_thread  # noqa: E402,F401

WKV_TOL = 5e-5
LOGIT_TOL = 1e-4
IMPLS = ("torch", "cuda")


def _err(j, t):
    return float(np.max(np.abs(np.asarray(j, np.float32)
                               - t.float().numpy())))


def _wkv_inputs(seed, B, S, H, hs):
    """tests/test_kernels.py's distributions: r, k, v ~ 0.5 N; logw =
    -exp(0.5 N); u ~ 0.3 N; state ~ 0.2 N."""
    rs = np.random.RandomState(seed)

    def n(shape, sc):
        return (rs.standard_normal(shape) * sc).astype(np.float32)

    r, k, v = (n((B, S, H, hs), 0.5) for _ in range(3))
    logw = -np.exp(n((B, S, H, hs), 0.5))
    return r, k, v, logw, n((H, hs), 0.3), n((B, H, hs, hs), 0.2)


def _both(arrs):
    return ([jnp.asarray(a) for a in arrs],
            [torch.from_numpy(a) for a in arrs])


# --------------------------------------------------------------------------- #
# WKV6: K3's plain version and the chunked model path
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("B,S,H,hs", [(1, 64, 2, 16), (2, 128, 3, 16),
                                      (1, 256, 2, 32), (2, 64, 1, 64)])
@pytest.mark.parametrize("chunk", [16, 32])
def test_wkv6_plain_and_chunked_match_jax_sweep(B, S, H, hs, chunk):
    j, t = _both(_wkv_inputs(0, B, S, H, hs))
    want = {"ref": jref.wkv6_ref(*j),
            "pallas": wkv6_pallas(*j, chunk=chunk),
            "chunked": jax_chunked(*j, chunk=chunk)}
    got = {"plain": ops.wkv6(*t, impl="cuda"),
           "chunked": wkv6_chunked(*t, chunk=chunk)}
    for (wn, (yw, sw)) in want.items():
        for gn, (yg, sg) in got.items():
            assert yg.dtype == torch.float32 and yg.shape == (B, S, H, hs)
            assert _err(yw, yg) < WKV_TOL, (wn, gn)
            assert _err(sw, sg) < WKV_TOL, (wn, gn)


def test_wkv6_three_way_with_an_uneven_chunk():
    """tests/test_kernels.py's three-way case: the step oracle, the Pallas
    kernel (chunk 32) and the chunked path at chunk 24 — in both
    packages."""
    j, t = _both(_wkv_inputs(1, 2, 96, 2, 16))
    want = [jref.wkv6_ref(*j), wkv6_pallas(*j, chunk=32),
            jax_chunked(*j, chunk=24)]
    got = [ref.wkv6_ref(*t), ops.wkv6(*t, impl="torch"),
           wkv6_chunked(*t, chunk=24)]
    for yw, sw in want:
        for yg, sg in got:
            assert _err(yw, yg) < WKV_TOL
            assert _err(sw, sg) < WKV_TOL


def test_wkv6_chunked_pads_a_ragged_tail():
    """S = 37 over chunks of 16: the pad steps get k = 0 and logw = 0, so
    the state carries through them unchanged."""
    j, t = _both(_wkv_inputs(2, 2, 37, 3, 16))
    yw, sw = jref.wkv6_ref(*j)
    yc, sc = jax_chunked(*j, chunk=16)
    for y, s in (wkv6_chunked(*t, chunk=16), ops.wkv6(*t)):
        assert _err(yw, y) < WKV_TOL and _err(sw, s) < WKV_TOL
        assert _err(yc, y) < WKV_TOL and _err(sc, s) < WKV_TOL


def test_wkv6_plain_widens_bf16_inputs_exactly():
    """bf16 r, k, v go through the plain version as their exact fp32
    values: the result equals the fp32 call on the rounded inputs."""
    r, k, v, logw, u, s0 = (torch.from_numpy(a) for a in
                            _wkv_inputs(3, 1, 20, 2, 16))
    rb, kb, vb = (x.to(torch.bfloat16) for x in (r, k, v))
    a = ops.wkv6(rb, kb, vb, logw, u, s0)
    b = ops.wkv6(rb.float(), kb.float(), vb.float(), logw, u, s0)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# --------------------------------------------------------------------------- #
# config and layers
# --------------------------------------------------------------------------- #
def test_config_matches_reference():
    a, b = jax_config("rwkv6-3b"), get_config("rwkv6-3b")
    assert a.kv_bytes_per_token() == b.kv_bytes_per_token() == 0
    assert a.state_bytes_fixed() == b.state_bytes_fixed() == 32 * 665_600
    assert a.param_count() == b.param_count()
    assert a.padded_vocab == b.padded_vocab == 65_536
    assert b.torch_dtype == torch.bfloat16
    assert get_reduced("rwkv6-3b").rwkv_head_size == 16


def test_full_width_parameters_match_reference_skeleton():
    """The full-width module tree on the meta device: the reference
    skeleton's leaf count (about 3.07 B), and the per-slot state of
    665,600 B per layer."""
    cfg = get_config("rwkv6-3b")
    lm = LM(cfg, torch.device("meta"))
    n = sum(p.numel() for p in lm.parameters())
    assert n == jax_build(jax_config("rwkv6-3b")).n_params()
    assert 3.0e9 < n < 3.1e9
    cache = build_model(cfg).init_cache(1, 8, device="meta")
    nbytes = sum(t.numel() * t.element_size()
                 for t in cache["groups"]["p0"].values())
    assert nbytes == 32 * 665_600


def test_f3_layernorm_and_embed_match_reference():
    """Scale-only fp32 LayerNorm (eps 1e-5), and the sqrt(d) embedding
    scale kept for RWKV."""
    x = np.random.RandomState(0).standard_normal((2, 5, 64)).astype(
        np.float32) * 3 + 1
    sc = np.random.RandomState(1).standard_normal(64).astype(np.float32)
    assert _err(jlayers.layernorm(jnp.asarray(x), jnp.asarray(sc)),
                tlayers.layernorm(torch.from_numpy(x),
                                  torch.from_numpy(sc))) < 1e-5
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert tlayers.layernorm(xb, torch.from_numpy(sc)).dtype == torch.bfloat16
    cfg = get_reduced("rwkv6-3b")
    w = np.random.RandomState(2).standard_normal((512, 64)).astype(np.float32)
    toks = np.array([[3, 7, 511]], np.int32)
    assert _err(jlayers.embed({"w": jnp.asarray(w)}, jax_reduced("rwkv6-3b"),
                              jnp.asarray(toks)),
                tlayers.embed(torch.from_numpy(w), cfg,
                              torch.from_numpy(toks).long())) < 1e-5


# --------------------------------------------------------------------------- #
# the model on converted weights
# --------------------------------------------------------------------------- #
def _pair(**over):
    jcfg = jax_reduced("rwkv6-3b").scaled(**over)
    cfg = get_reduced("rwkv6-3b").scaled(**over)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    lm = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu")
    return jm, jp, cfg, build_model(cfg), lm


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _tokens(seed, shape, vocab=512):
    return np.random.RandomState(seed).randint(0, vocab, shape).astype(
        np.int32)


def _tree_err(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    return max(_err(x, y) for x, y in zip(la, lb))


def _to_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


def test_params_round_trip_and_cache_layout(pair):
    jm, jp, cfg, m, lm = pair
    tree = jax.tree_util.tree_map(np.asarray, jp)
    back = params_to_numpy(lm)
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(back)
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)
    assert set(back["groups"]["p0"]) == {"ln1", "ln2", "tmix", "cmix"}
    assert back["unembed"]["w"].shape == (64, 512)
    jc, tc = jm.init_cache(3, 64), m.init_cache(3, 64, device="cpu")
    assert jax.tree_util.tree_structure(jc) == \
        jax.tree_util.tree_structure(tc)
    for a, b in zip(jax.tree_util.tree_leaves(jc),
                    jax.tree_util.tree_leaves(tc)):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_logits_and_state_match_jax(pair, impl):
    jm, jp, cfg, m, lm = pair
    toks = _tokens(0, (2, 37))
    lj, cj = jm.prefill(jp, jnp.asarray(toks))
    lt, ct = m.prefill(lm, torch.from_numpy(toks), attention_impl=impl)
    assert _err(lj, lt) < LOGIT_TOL
    assert _tree_err(cj, ct) < LOGIT_TOL
    np.testing.assert_array_equal(np.argmax(np.asarray(lj), -1),
                                  lt.argmax(-1).numpy())


@pytest.mark.parametrize("impl", IMPLS)
def test_append_prefill_continues_the_state(pair, impl):
    """tests/test_models.py::test_append_prefill_matches_full: the state
    after 8 tokens carries the next 9, and the result matches JAX's (and
    the one-shot prefill)."""
    jm, jp, cfg, m, lm = pair
    toks = _tokens(1, (2, 17))
    lj_full, _ = jm.prefill(jp, jnp.asarray(toks))
    _, c1 = jm.prefill(jp, jnp.asarray(toks[:, :8]))
    lj, cj = jm.prefill(jp, jnp.asarray(toks[:, 8:]), caches=c1, start_pos=8)
    _, t1 = m.prefill(lm, torch.from_numpy(toks[:, :8]), attention_impl=impl)
    lt, ct = m.prefill(lm, torch.from_numpy(toks[:, 8:]), caches=t1,
                       start_pos=8, attention_impl=impl)
    assert _err(lj, lt) < LOGIT_TOL
    assert _err(lj_full, lt) < 2e-4
    assert _tree_err(cj, ct) < LOGIT_TOL


@pytest.mark.parametrize("impl", IMPLS)
def test_decode_step_matches_jax(pair, impl):
    """tests/test_models.py::test_decode_matches_full_prefill on the
    port's own state."""
    jm, jp, cfg, m, lm = pair
    toks = _tokens(2, (2, 17))
    lj_full, _ = jm.prefill(jp, jnp.asarray(toks))
    _, cj = jm.prefill(jp, jnp.asarray(toks[:, :-1]))
    lj, uj = jm.decode_step(jp, jnp.asarray(toks[:, -1]), cj,
                            jnp.full((2,), 16, jnp.int32))
    _, ct = m.prefill(lm, torch.from_numpy(toks[:, :-1]), attention_impl=impl)
    pos = torch.full((2,), 16, dtype=torch.int32)
    lt, ut = m.decode_step(lm, torch.from_numpy(toks[:, -1]), ct, pos,
                           kv_lens=pos, ctx_limit=64, attention_impl=impl)
    assert _err(lj, lt) < LOGIT_TOL
    assert _err(lj_full, lt) < 2e-4
    assert _tree_err(uj, ut) < LOGIT_TOL


@pytest.mark.parametrize("impl", IMPLS)
def test_three_step_rollout_matches_jax(pair, impl):
    """tests/test_models.py::test_multi_step_decode_consistency plus greedy
    feedback: prefill 13 tokens, three steps folded by merge_decode_cache
    (states replaced), same greedy tokens as the JAX rollout."""
    jm, jp, cfg, m, lm = pair
    toks = _tokens(3, (1, 13))
    lj, cj = jm.prefill(jp, jnp.asarray(toks))
    lt, ct = m.prefill(lm, torch.from_numpy(toks), attention_impl=impl)
    tj, tt = [int(jnp.argmax(lj[0, :cfg.vocab_size]))], \
        [int(lt[0, :cfg.vocab_size].argmax())]
    for pos in range(13, 16):
        lj, uj = jm.decode_step(jp, jnp.asarray([tj[-1]]), cj,
                                jnp.asarray([pos]))
        lt, ut = m.decode_step(lm, torch.tensor([tt[-1]]), ct,
                               torch.tensor([pos]), attention_impl=impl)
        assert _err(lj, lt) < LOGIT_TOL
        cj, ct = jax_merge(cj, uj), merge_decode_cache(ct, ut)
        tj.append(int(jnp.argmax(lj[0, :cfg.vocab_size])))
        tt.append(int(lt[0, :cfg.vocab_size].argmax()))
    assert tj == tt
    assert _tree_err(cj, ct) < LOGIT_TOL


def test_state_is_constant_size(pair):
    """tests/test_models.py::test_rwkv_state_is_constant_size: O(1) state
    whatever the context, in the prefill's output and in the slot cache."""
    jm, jp, cfg, m, lm = pair
    toks = torch.from_numpy(_tokens(4, (1, 32)))
    size = lambda tree: sum(t.numel() for t in  # noqa: E731
                            tree["groups"]["p0"].values())
    _, c8 = m.prefill(lm, toks[:, :8])
    _, c32 = m.prefill(lm, toks)
    assert size(c8) == size(c32)
    assert size(m.init_cache(1, 64, "cpu")) == size(
        m.init_cache(1, 1024, "cpu")) == size(c8)


def test_pad_heads_variant_matches_jax():
    """tests/test_perf_variants.py::test_rwkv_pad_heads_consistency: 4 live
    heads padded to 6; the dead heads add nothing (their r is zeroed)."""
    jm, jp, cfg, m, lm = _pair(rwkv_pad_heads_to=6)
    toks = _tokens(5, (2, 17))
    lj_full, _ = jm.prefill(jp, jnp.asarray(toks))
    _, cj = jm.prefill(jp, jnp.asarray(toks[:, :-1]))
    lj, _ = jm.decode_step(jp, jnp.asarray(toks[:, -1]), cj,
                           jnp.full((2,), 16, jnp.int32))
    for impl in IMPLS:
        lt_full, _ = m.prefill(lm, torch.from_numpy(toks),
                               attention_impl=impl)
        _, ct = m.prefill(lm, torch.from_numpy(toks[:, :-1]),
                          attention_impl=impl)
        assert tuple(ct["groups"]["p0"]["s"].shape) == (2, 2, 6, 16, 16)
        lt, _ = m.decode_step(lm, torch.from_numpy(toks[:, -1]), ct,
                              torch.full((2,), 16, dtype=torch.int32))
        assert _err(lj_full, lt_full) < LOGIT_TOL
        assert _err(lj, lt) < LOGIT_TOL
        assert _err(lj_full, lt) < 2e-4
        assert bool(torch.isfinite(lt_full).all())


def test_f6_pad_below_live_heads_keeps_cache_and_model_in_step():
    """F6: with 0 < rwkv_pad_heads_to < n_heads the reference's cache
    skeleton takes the pad (2 heads) while its model takes max(pad, nh) (4
    heads). The port sizes its cache from the model's rule, so a prefilled
    state fits the slot cache."""
    jcfg = jax_reduced("rwkv6-3b").scaled(rwkv_pad_heads_to=2)
    assert jax_build(jcfg).init_cache(1, 8)["groups"]["p0"]["s"].shape[2] == 2
    cfg = get_reduced("rwkv6-3b").scaled(rwkv_pad_heads_to=2)
    m = build_model(cfg)
    lm = m.init(0, "cpu")
    _, ct = m.prefill(lm, torch.from_numpy(_tokens(6, (1, 9))))
    cache = m.init_cache(1, 8, "cpu")
    assert cache["groups"]["p0"]["s"].shape == ct["groups"]["p0"]["s"].shape
    assert cache["groups"]["p0"]["s"].shape[2] == 4


def test_other_recurrent_and_mixed_configs_still_raise():
    cfg = get_reduced("rwkv6-3b")
    for over in ({"norm": "rmsnorm"}, {"tie_embeddings": True},
                 {"block_pattern": ("rwkv6", "attn_global")},
                 {"block_pattern": ("rglru",)}):
        with pytest.raises(NotImplementedError, match="not ported"):
            build_model(cfg.scaled(**over)).init(0, "cpu")
