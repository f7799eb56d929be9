"""The quantized decode tail (`kv_cache_dtype="int8"`: every growing
attention row stored as int8 and read as int8 x `kv_quant_scale`) on the
port, held to the JAX package.

- `decode_step` against the JAX `decode_step` on the same converted
  reduced weights and the same quantized prefilled cache (the counterpart of
  tests/test_perf_variants.py::test_int8_kv_decode_close_to_bf16): logits
  within 2e-5 (deepseek and gemma3: 1e-4, their families' fp32 gap) and
  the returned rows int8 and equal byte for byte, for GQA (qwen3-0.6b),
  MLA's latent and rope key (deepseek-v2-lite-16b) and local layers
  (gemma3-12b).
- The reference's three faults on this path, each shown on the JAX package
  and absent in the port (ROADMAP queue 3): F23, the prefill's rows cast
  into the int8 cache without the scale or rounding; F24, the append
  attending to its int8 prefix as raw integers; F25, `kv_bytes_per_token`
  counting the model's dtype.
- K1's plain version on an int8 cache against the Pallas kernel (interpret
  mode on the CPU) on the dequantized rows, at (H, Hkv, D) = (16, 8, 128)
  (qwen3-0.6b) and (48, 8, 128) (nemotron-4-15b); and `gqa_decode` under
  "cuda" handing the kernel's entry point the int8 cache itself.
- ConServe on the port's engine with an int8 cache, on the launcher's
  engine trace, against the JAX engine's streams with F23 and F24 repaired
  on its module functions in this process only (no file of the JAX package
  changes); the same with one decoder killed, both engines on the same
  trigger and the same fixed step clock, so the replayed int8 contexts
  are held to the reference's replay; then on the port alone, rotation on
  against off, pool on against off, and failure replay against
  failure-free where the kill did not reach (a replayed int8 context is
  not the failure-free one, F26).
- The replica's programs: no host read in an int8 body, and the warm-up
  passes leave an int8 cache byte-identical.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.engine.replica as jax_replica_mod  # noqa: E402
import repro_torch.engine.kvcache as kvcache_mod  # noqa: E402
import repro.models.blocks as jax_blocks  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.core import make_scheduler as jax_make_scheduler  # noqa: E402
from repro.engine import EngineServer as JaxServer  # noqa: E402
from repro.engine import ReplicaEngine as JaxReplica  # noqa: E402
from repro.kernels.decode_attention import flash_decode_attention as pallas_decode  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import attention as jatt  # noqa: E402
from repro.traces import TraceConfig as JaxTraceConfig  # noqa: E402
from repro.traces import generate_trace as jax_generate_trace  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.chaos.triggers import FailWhen, FixedStepClock  # noqa: E402
from repro_torch.core import make_scheduler  # noqa: E402
from repro_torch.engine import EngineServer, ReplicaEngine  # noqa: E402
from repro_torch.engine.kvcache import growing, leaves  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.serve import engine_trace  # noqa: E402
from repro_torch.models import attention as tatt  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import (params_from_numpy,  # noqa: E402
                                        params_to_numpy)
from repro_torch.models.transformer import stack_layers  # noqa: E402
from repro_torch.traces import make_scenario  # noqa: E402
from torch_support import NoHostRead, one_thread  # noqa: E402,F401

INT8 = {"kv_cache_dtype": "int8"}
LOGIT_TOL = 2e-5
# deepseek's and gemma3's logits against the JAX model: their families'
# tolerance (tests/test_torch_moe.py, tests/test_torch_dense.py), see
# test_int8_decode_step_matches_jax
FAMILY_LOGIT_TOL = 1e-4
ATT_TOL = 2e-5
GROW = ("k", "v", "ckv", "krope")
N_CONV = 3  # conversations of the launcher's engine trace


def _pair(arch):
    """(jcfg, jax model, jax params, cfg, port model, port params): the
    reduced config with an int8 cache, the port's weights converted from
    the JAX package's in this process (F4)."""
    jcfg = jax_reduced(arch).scaled(**INT8)
    cfg = get_reduced(arch).scaled(**INT8)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    lm = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg,
                           "cpu")
    return jcfg, jm, jp, cfg, build_model(cfg), lm


@pytest.fixture(scope="module")
def qwen():
    """The int8 qwen3-0.6b pair on the port's seeded weights converted into
    the JAX tree: the same in every process, where the JAX package's init
    is drawn anew in each (F4). The served streams are compared byte for
    byte, and an int8 cache makes them sensitive to the last bits of a
    row: the two packages' fp32 rows agree to ~1e-6, not bit for bit, and
    one that lands that close to a rounding tie of int8 x scale rounds to
    neighbouring integers in the two, which a greedy near-tie downstream
    can turn into another token. On fixed weights the comparison is one
    outcome, not a draw."""
    cfg = get_reduced("qwen3-0.6b").scaled(**INT8)
    jcfg = jax_reduced("qwen3-0.6b").scaled(**INT8)
    lm = build_model(cfg).init(0, "cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(lm))
    return jcfg, jax_build(jcfg), jp, cfg, build_model(cfg), lm


def _flat(tree, path=()):
    """{path: numpy} of a nested dict of arrays or tensors."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, path + (k,)))
        else:
            out[path + (k,)] = (v.numpy() if torch.is_tensor(v)
                                else np.asarray(v))
    return out


def _tree(tree, fn, path=()):
    return {k: (_tree(v, fn, path + (k,)) if isinstance(v, dict)
                else fn(path + (k,), v)) for k, v in tree.items()}


def _jax_quantized(tree, jcfg):
    """The reference test's quantized prefilled cache: its growing leaves
    through the JAX `quantize_kv`."""
    return _tree(tree, lambda p, x: jatt.quantize_kv(x, jcfg)
                 if p[-1] in GROW else x)


def _to_torch(tree):
    return _tree(tree, lambda _, x: torch.from_numpy(np.array(x)))


def _tokens(vocab, shape, seed=1):
    return np.random.RandomState(seed).randint(0, vocab, size=shape).astype(
        np.int32)


# --------------------------------------------------------------------------- #
# decode_step against the JAX package's
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-v2-lite-16b",
                                  "gemma3-12b"])
def test_int8_decode_step_matches_jax(arch, monkeypatch):
    """The new rows are equal byte for byte but where the float row sits
    within 1e-3 of a rounding tie of int8 x scale: there the two packages'
    fp32 rows (equal to ~1e-6, not bit for bit, past the first layers) may
    round to neighbouring integers, and only there may the bytes differ,
    by one. The logits are within LOGIT_TOL (2e-5) for qwen3 and within
    FAMILY_LOGIT_TOL (1e-4, the tolerance of the MoE and dense families'
    tests against the JAX model) for deepseek and gemma3, whose decode
    steps part from the JAX package's by fp32 rounding alone by more than
    2e-5 on some of the reference's per-process draws (F4), with or
    without the int8 cache. Worst max |dlogit| measured, int8 step /
    model-dtype step on the same weights and the unquantized cache:
    qwen3 5.48e-6 / 3.99e-6 (PYTHONHASHSEED 0-39), deepseek 7.84e-5 /
    3.21e-5 (0-95; above 2e-5 on 10 and 6 draws), gemma3 3.81e-5 /
    2.51e-5 (0-39; above 2e-5 on 9 and 4 draws)."""
    jcfg, jm, jp, cfg, m, lm = _pair(arch)
    toks = _tokens(cfg.vocab_size, (2, 24))
    _, c0 = jm.prefill(jp, jnp.asarray(toks[:, :-1]))
    c1 = _jax_quantized(c0, jcfg)
    pos = jnp.full((2,), 23, jnp.int32)
    lg_j, up_j = jm.decode_step(jp, jnp.asarray(toks[:, -1]), c1, pos)
    ties = []  # per quantize_kv call of the port's decode, in layer order
    quantize = tatt.quantize_kv

    def spy(x, cfg_):
        r = x.float() / cfg_.kv_quant_scale
        ties.append((r - r.floor() - 0.5).abs() < 1e-3)
        return quantize(x, cfg_)
    monkeypatch.setattr(tatt, "quantize_kv", spy)
    lg_t, up_t = m.decode_step(lm, torch.from_numpy(toks[:, -1]),
                               _to_torch(c1), torch.full((2,), 23))
    tol = LOGIT_TOL if arch == "qwen3-0.6b" else FAMILY_LOGIT_TOL
    assert np.abs(lg_t.numpy() - np.asarray(lg_j)).max() < tol
    names = ("ckv", "krope") if cfg.uses_mla else ("k", "v")
    near = _flat(stack_layers(cfg, [dict(zip(names, ties[i:i + 2]))
                                    for i in range(0, len(ties), 2)]))
    want, got = _flat(up_j), _flat(up_t)
    assert set(got) == set(want)
    rows = [p for p in got if p[-1] in GROW]
    assert rows and set(rows) == set(near)
    for p in rows:
        assert got[p].dtype == np.int8 and want[p].dtype == np.int8, p
        diff = got[p].astype(np.int32) - want[p].astype(np.int32)
        assert np.abs(diff).max() <= 1, p
        assert not (diff != 0)[~near[p]].any(), p


# --------------------------------------------------------------------------- #
# F23, F24, F25: each on the JAX package, and absent in the port
# --------------------------------------------------------------------------- #
def test_f23_prefill_fold_quantizes_the_rows(qwen, monkeypatch):
    """A 37-token turn-1 into slot 0 of a 2 x 128 replica. The JAX
    engine's fold casts the prefill's float rows to int8 — truncated toward
    0, no scale — so most bytes are not `quantize_kv`'s; the port's fold
    writes `quantize_kv` of the rows it is handed, byte for byte, and
    those rows are the JAX prefill's to 1e-5."""
    jcfg, jm, jp, cfg, m, lm = qwen
    toks = _tokens(cfg.vocab_size, (37,), seed=2)
    _, c = jm.prefill(jp, jnp.asarray(toks[None]))
    rows = np.asarray(c["groups"]["p0"]["k"])[:, 0]  # (G, 37, Hkv, hd)
    want = np.asarray(jatt.quantize_kv(jnp.asarray(rows), jcfg))
    jrep = JaxReplica(jcfg, jp, n_slots=2, max_ctx=128)
    jrep.prefill_conversation(jrep.kv.acquire(), toks)
    jax_rows = np.asarray(jrep.kv.caches["groups"]["p0"]["k"])[:, 0, :37]
    assert jax_rows.dtype == np.int8
    near_int = np.abs(rows - np.round(rows)) < 1e-4
    assert not ((jax_rows != np.trunc(rows)) & ~near_int).any()  # a cast
    assert (jax_rows != want).mean() > 0.5
    assert (jax_rows == 0).mean() > 0.2
    folded = {}
    stored = kvcache_mod.stored

    def spy(path, leaf, new, cfg_):
        folded[path] = new  # the last fold's rows: the prefill's
        return stored(path, leaf, new, cfg_)
    monkeypatch.setattr(kvcache_mod, "stored", spy)
    rep = ReplicaEngine(cfg, lm, n_slots=2, max_ctx=128)
    rep.prefill_conversation(rep.kv.acquire(), toks)
    got = rep.kv.caches["groups"]["p0"]["k"][:, 0, :37]
    assert got.dtype == torch.int8
    x = folded[("groups", "p0", "k")][:, 0, :37]
    np.testing.assert_array_equal(got.numpy(),
                                  tatt.quantize_kv(x, cfg).numpy())
    assert np.abs(x.numpy() - rows).max() < 1e-5


def test_folds_take_no_unquantized_rows_without_the_config(qwen):
    """The rule's guards: a prefill fold of float rows into the int8 cache
    without the model's config (which holds the scale) raises, and so does
    a decode fold of float rows; int8 rows fold like for like."""
    _, _, _, cfg, m, lm = qwen
    caches = m.init_cache(2, 64, device="cpu")
    _, new = m.prefill(lm, torch.from_numpy(_tokens(cfg.vocab_size, (1, 9))))
    with pytest.raises(ValueError, match="config"):
        kvcache_mod.fold_prefill(caches, new, 0, 0)
    kvcache_mod.fold_prefill(caches, new, 0, 0, cfg)
    rows = kvcache_mod.slice_slot_prefix(caches, 0, 9)
    kvcache_mod.fold_prefill(caches, rows, 1, 0)  # int8: no config needed
    assert all(torch.equal(a[:, 0, :9], a[:, 1, :9])
               for p, a in leaves(caches))
    up = _tree(new, lambda _, x: x[:, :, :1].expand(-1, 2, -1, -1, -1))
    with pytest.raises(ValueError, match="quantize"):
        kvcache_mod.fold_decode_step(caches, up,
                                     torch.zeros(2, dtype=torch.long),
                                     torch.ones(2, dtype=torch.bool))


def test_f24_append_reads_the_prefix_dequantized(qwen):
    """A 10-token append against a quantized 37-token prefix. The JAX
    append attends to the int8 rows as raw integers (20x the values): its
    logits are far from the same append over the dequantized prefix. The
    port's append equals that append byte for byte, and the JAX package's
    over the dequantized prefix within 2e-5."""
    jcfg, jm, jp, cfg, m, lm = qwen
    toks = _tokens(cfg.vocab_size, (1, 47), seed=3)
    _, c = jm.prefill(jp, jnp.asarray(toks[:, :37]))
    cq = _jax_quantized(c, jcfg)
    cd = _tree(cq, lambda p, x: jatt.dequantize_kv(x, jcfg)
               if p[-1] in GROW else x)
    new = jnp.asarray(toks[:, 37:])
    lg_raw, _ = jm.prefill(jp, new, caches=cq, start_pos=37)
    lg_deq, _ = jm.prefill(jp, new, caches=cd, start_pos=37)
    spread = float(jnp.abs(lg_deq).max())
    assert float(jnp.abs(lg_raw - lg_deq).max()) > 0.1 * spread
    t_new = torch.from_numpy(toks[:, 37:])
    got, rows = m.prefill(lm, t_new, caches=_to_torch(cq), start_pos=37)
    over_deq, rows_d = m.prefill(lm, t_new, caches=_to_torch(cd),
                                 start_pos=37)
    assert torch.equal(got, over_deq)
    for (p, a), (_, b) in zip(leaves(rows), leaves(rows_d)):
        assert torch.equal(a, b), p
    assert np.abs(got.numpy() - np.asarray(lg_deq)).max() < LOGIT_TOL


def test_f25_kv_bytes_per_token_counts_the_cache_dtype(qwen):
    """qwen3-0.6b as published (bf16): the port's int8 cache appends
    57,344 B a token, half the model dtype's 114,688; the JAX package
    counts 114,688 for both. deepseek-v2-lite-16b's latent halves too. An
    exported int8 slot's `nbytes_of` is kv_bytes_per_token x its length."""
    for arch in ("qwen3-0.6b", "deepseek-v2-lite-16b"):
        full, q = get_config(arch), get_config(arch).scaled(**INT8)
        assert 2 * q.kv_bytes_per_token() == full.kv_bytes_per_token()
        jfull = jax_config(arch)
        assert jfull.scaled(**INT8).kv_bytes_per_token() == \
            jfull.kv_bytes_per_token() == full.kv_bytes_per_token()
    assert get_config("qwen3-0.6b").scaled(**INT8).kv_bytes_per_token() \
        == 57_344
    _, _, _, cfg, _, lm = qwen
    rep = ReplicaEngine(cfg, lm, n_slots=2, max_ctx=128)
    s = rep.kv.acquire()
    rep.prefill_conversation(s, _tokens(cfg.vocab_size, (37,)))
    pkg = rep.kv.export_slot(s)
    assert pkg["length"] == 37
    assert rep.kv.nbytes_of(pkg) == 37 * cfg.kv_bytes_per_token()
    assert cfg.kv_bytes_per_token() * 4 == \
        get_reduced("qwen3-0.6b").kv_bytes_per_token()  # float32 -> int8


# --------------------------------------------------------------------------- #
# K1 on an int8 cache
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("H,Hkv", [(16, 8), (48, 8)])
def test_plain_k1_int8_matches_pallas_on_dequantized_rows(H, Hkv):
    """ops.decode_attention's plain version (`impl="cuda"` on CPU tensors)
    on an int8 cache and its scale against the Pallas kernel on the
    dequantized rows, float32, at D = 128."""
    D, S, scale = 128, 256, 0.05
    rs = np.random.RandomState(H)
    q = rs.standard_normal((3, H, D)).astype(np.float32)
    kc, vc = (rs.randint(-127, 128, size=(3, S, Hkv, D)).astype(np.int8)
              for _ in range(2))
    lens = np.array([1, 130, 256], np.int32)
    deq = [(x.astype(np.float32) * np.float32(scale)) for x in (kc, vc)]
    want = pallas_decode(jnp.asarray(q), *(jnp.asarray(x) for x in deq),
                         jnp.asarray(lens))
    got = ops.decode_attention(*(torch.from_numpy(x)
                                 for x in (q, kc, vc, lens)),
                               kv_scale=scale)
    assert np.abs(np.asarray(want) - got.numpy()).max() < ATT_TOL
    # the new token as a second branch, and the model's dequantize_kv
    kn, vn = (torch.from_numpy(rs.standard_normal((3, Hkv, D))
                               .astype(np.float32)) for _ in range(2))
    cfg = get_reduced("qwen3-0.6b").scaled(**INT8)
    two = ops.decode_attention(*(torch.from_numpy(x)
                                 for x in (q, kc, vc, lens)),
                               k_new=kn, v_new=vn, kv_scale=scale)
    ref = ops.decode_attention(
        torch.from_numpy(q), tatt.dequantize_kv(torch.from_numpy(kc), cfg),
        tatt.dequantize_kv(torch.from_numpy(vc), cfg), torch.from_numpy(lens),
        k_new=kn, v_new=vn)
    assert torch.equal(two, ref)


def test_gqa_decode_hands_k1_the_int8_cache(qwen, monkeypatch):
    """Under attention_impl="cuda" the kernel's entry point receives the
    trimmed int8 cache itself and the scale — no dequantized copy — and
    its output is the plain version's."""
    _, _, _, cfg, m, lm = qwen
    seen = []
    real = ops.flash_decode_attention

    def kernel(q, k, v, lengths, k_new=None, v_new=None, kv_scale=None):
        seen.append((k.dtype, v.dtype, k.shape[1], kv_scale))
        return ops.decode_attention_plain(q, k, v, lengths, k_new, v_new,
                                          kv_scale)
    monkeypatch.setattr(ops, "_use_kernel", lambda x, impl: impl == "cuda")
    monkeypatch.setattr(ops, "flash_decode_attention", kernel)
    toks = _tokens(cfg.vocab_size, (2, 24))
    _, c = m.prefill(lm, torch.from_numpy(toks[:, :-1]))
    caches = _tree(c, lambda p, x: tatt.quantize_kv(x, cfg)
                   if p[-1] in GROW else x)
    lens = torch.full((2,), 23)
    args = (lm, torch.from_numpy(toks[:, -1]), caches, lens)
    lg_c, up_c = m.decode_step(*args, kv_lens=lens, ctx_limit=23,
                               attention_impl="cuda")
    assert seen and all(s == (torch.int8, torch.int8, 23, cfg.kv_quant_scale)
                        for s in seen)
    assert len(seen) == cfg.n_layers
    monkeypatch.setattr(ops, "flash_decode_attention", real)
    lg_t, up_t = m.decode_step(*args, kv_lens=lens, ctx_limit=23,
                               attention_impl="torch")
    assert np.abs(lg_c.numpy() - lg_t.numpy()).max() < LOGIT_TOL
    for (p, a), (_, b) in zip(leaves(up_c), leaves(up_t)):
        assert torch.equal(a, b), p


# --------------------------------------------------------------------------- #
# served streams
# --------------------------------------------------------------------------- #
def _jax_trace():
    """The port's launcher engine trace (`launch.serve.engine_trace`), made
    by the JAX package's own generator."""
    tc = JaxTraceConfig(first_input_median=150, first_input_max=500,
                        append_median=24, append_max=64, output_median=10,
                        output_max=32, mean_turns=3.0, max_turns=6,
                        tool_mean_s=0.05)
    return jax_generate_trace(N_CONV, 2.0, cfg=tc)


def _repair_jax(monkeypatch, jcfg):
    """F23 and F24 repaired on the JAX package's module functions, in this
    process only: the replica's prefill fold quantizes float rows bound for
    an int8 leaf, and the blocks' prefills read a quantized prefix through
    `dequantize_kv`."""
    fold = jax_replica_mod.fold_prefill

    def quantizing_fold(caches, new, slot, offset, grouped, growing_):
        new = jax.tree_util.tree_map(
            lambda leaf, n: (jatt.quantize_kv(n, jcfg)
                             if leaf.dtype == jnp.int8 and n.dtype != jnp.int8
                             else n), caches, new)
        return fold(caches, new, slot, offset, grouped, growing_)
    monkeypatch.setattr(jax_replica_mod, "fold_prefill", quantizing_fold)
    for name in ("gqa_prefill", "mla_prefill"):
        real = getattr(jax_blocks, name)

        def read_dequantized(*a, real=real, **kw):
            if kw.get("prefix_kv") is not None:
                kw["prefix_kv"] = {k: jatt.dequantize_kv(x, jcfg)
                                   for k, x in kw["prefix_kv"].items()}
            return real(*a, **kw)
        monkeypatch.setattr(jax_blocks, name, read_dequantized)


def _replicas(cfg, lm, pool=0):
    return [ReplicaEngine(cfg, lm, n_slots=4, max_ctx=1024, replica_id=i,
                          role=r, prefix_pool_tokens=pool)
            for i, r in enumerate(("prefill", "decode", "decode"))]


def _streams(srv):
    return {k: [int(t) for t in v] for k, v in srv.sampled_tokens.items()}


@pytest.fixture(scope="module")
def served(qwen):
    """The port's failure-free ConServe run of the engine trace."""
    _, _, _, cfg, _, lm = qwen
    srv = EngineServer(make_scheduler("conserve"), _replicas(cfg, lm),
                       record_tokens=True, strict_accounting=True)
    recs = srv.serve(engine_trace(N_CONV))
    assert len(recs) == N_CONV and srv.n_transfers == N_CONV
    srv.check_accounting()
    return _streams(srv), srv


def test_served_streams_equal_repaired_jax_engine(qwen, served,
                                                  monkeypatch):
    """ConServe, 1 prefiller + 2 decoders of 4 x 1024 slots, strict
    accounting: the port's int8 streams equal the JAX engine's with F23
    and F24 repaired, one transfer a conversation of 57,344 / 4 B a
    token on both sides' byte count (the reduced model is float32)."""
    jcfg, _, jp, cfg, _, _ = qwen
    _repair_jax(monkeypatch, jcfg)
    jreps = [JaxReplica(jcfg, jp, n_slots=4, max_ctx=1024, replica_id=i,
                        role=r)
             for i, r in enumerate(("prefill", "decode", "decode"))]
    jsrv = JaxServer(jax_make_scheduler("conserve"), jreps,
                     record_tokens=True, strict_accounting=True)
    assert len(jsrv.serve(_jax_trace())) == N_CONV
    streams, srv = served
    assert len(streams) > N_CONV
    assert streams == _streams(jsrv)
    assert srv.n_transfers == jsrv.n_transfers == N_CONV
    first = sum(c.first_input_len for c in engine_trace(N_CONV))
    assert srv.transfer_bytes == first * cfg.kv_bytes_per_token()


def test_served_rotation_off_equals_on(qwen, served):
    _, _, _, cfg, _, lm = qwen
    srv = EngineServer(make_scheduler("conserve"), _replicas(cfg, lm),
                       record_tokens=True, strict_accounting=True,
                       rotation=False)
    assert len(srv.serve(engine_trace(N_CONV))) == N_CONV
    assert _streams(srv) == served[0]


class _Killed(FailWhen, EngineServer):
    """The port's engine with the structural kill trigger."""


class _PortClocked(FailWhen, FixedStepClock, EngineServer):
    pass


class _JaxClocked(FailWhen, FixedStepClock, JaxServer):
    pass


def test_served_failure_replay_equals_repaired_jax_engine(qwen,
                                                          monkeypatch):
    """The decoder of conversation 1 killed as it enters the decode of a
    later turn, on the port's engine and on the JAX engine with F23 and
    F24 repaired, both on the fixed step clock, so the kill lands at the
    same logical moment with the same work in flight. Both replay the
    journal by one prefill of each recovered context into the int8 cache:
    the streams, the recoveries and the replayed prefill tokens are
    equal, which holds the replayed part of every int8 stream to the
    reference's replay."""
    jcfg, _, jp, cfg, _, lm = qwen
    _repair_jax(monkeypatch, jcfg)
    kill = dict(victim_cid=1, min_turn=1, record_tokens=True,
                strict_accounting=True)
    srv = _PortClocked(make_scheduler("conserve"), _replicas(cfg, lm),
                       **kill)
    recs = srv.serve(engine_trace(N_CONV))
    jreps = [JaxReplica(jcfg, jp, n_slots=4, max_ctx=1024, replica_id=i,
                        role=r)
             for i, r in enumerate(("prefill", "decode", "decode"))]
    jsrv = _JaxClocked(jax_make_scheduler("conserve"), jreps, **kill)
    jrecs = jsrv.serve(_jax_trace())
    assert len(recs) == len(jrecs) == N_CONV
    srv.check_accounting()
    jsrv.check_accounting()
    assert srv.n_recoveries == jsrv.n_recoveries >= 1
    assert srv.killed == jsrv.killed
    replayed = {i: s.replayed_prefill_tokens for i, s in srv.states.items()}
    assert sum(replayed.values()) > 0
    assert replayed == {i: s.replayed_prefill_tokens
                        for i, s in jsrv.states.items()}
    assert ([r.recovered for r in recs] == [r.recovered for r in jrecs])
    assert _streams(srv) == _streams(jsrv)


def test_served_failure_replay_keeps_what_the_kill_did_not_touch(qwen,
                                                                 served):
    """The decoder of conversation 1 killed as it enters the decode of a
    later turn (`FailWhen`). Under an int8 cache the
    journaled replay does not give the failure-free streams back: it
    prefills a recovered conversation's context in one turn-1 prefill,
    whose rows attend to one another in full precision, where the
    failure-free run's decoded rows were computed reading the quantized
    cache (the reference replays by the same prefill; ROADMAP queue 3).
    What the kill did not touch stays byte for byte: every stream of a
    conversation that was not recovered, and every turn a recovered one
    finished before the kill."""
    _, _, _, cfg, _, lm = qwen
    srv = _Killed(make_scheduler("conserve"), _replicas(cfg, lm),
                  record_tokens=True, strict_accounting=True, victim_cid=1,
                  min_turn=1)
    recs = srv.serve(engine_trace(N_CONV))
    assert len(recs) == N_CONV and srv.n_recoveries >= 1
    srv.check_accounting()
    t_kill = srv.killed[3]
    got, want = _streams(srv), served[0]
    assert set(got) == set(want)
    kept = [(r.cid, t.turn_idx) for r in recs for t in r.turns
            if not r.recovered or t.last_token_s <= t_kill]
    assert any(r.recovered for r in recs) and kept
    for key in kept:
        assert got[key] == want[key], key


def test_served_pool_on_equals_off(qwen):
    """`shared_preamble_fleet` at engine scale with an int8 cache: the
    pooled int8 rows folded into a hit's slot give the streams of no
    pool, and the prefiller's pool was hit."""
    _, _, _, cfg, _, lm = qwen
    out = {}
    for pool in (0, 1024):
        srv = EngineServer(make_scheduler("conserve"),
                           _replicas(cfg, lm, pool), record_tokens=True,
                           strict_accounting=True)
        assert len(srv.serve(make_scenario("shared_preamble_fleet", 5,
                                           seed=0, scale="engine"))) == 5
        out[pool] = srv
    assert out[1024].states[0].pooled_prefix_hits > 0
    assert _streams(out[1024]) == _streams(out[0])


# --------------------------------------------------------------------------- #
# the replica's programs
# --------------------------------------------------------------------------- #
def test_int8_programs_read_nothing_back_and_warmup_leaves_the_cache(qwen):
    """An int8 replica's decode, turn-1 and append bodies run with the host
    reading nothing (quantize and dequantize are elementwise ops in the
    body), and its warm-up passes leave every cache byte as they found
    it."""
    _, _, _, cfg, _, lm = qwen
    eng = ReplicaEngine(cfg, lm, n_slots=4, max_ctx=64)
    nt = np.zeros(4, np.int32)
    em = np.zeros(4, bool)
    for i, n in enumerate((23, 9)):
        s = eng.kv.acquire()
        t, _ = eng.prefill_conversation(s, np.arange(5 + i, 5 + i + n,
                                                     dtype=np.int32))
        nt[s], em[s] = int(t), True
    assert all(t.dtype == torch.int8 for p, t in leaves(eng.kv.caches)
               if growing(p))
    before = [t.clone() for _, t in leaves(eng.kv.caches)]
    eng.warmup_decode(chunks=(1, 8), ctx_limits=(64,))
    eng.warmup_prefill(lengths=(32,), ctx_limits=(64,))
    assert all(torch.equal(a, b)
               for a, (_, b) in zip(before, leaves(eng.kv.caches)))
    free = eng.kv.acquire()
    toks = np.arange(3, 20, dtype=np.int32)
    rem = np.where(em, 4, 0).astype(np.int32)
    runs = [(eng._get_fused(4, 64),
             np.concatenate([nt, eng.kv.lengths, em, rem, [0]])),
            (eng._get_prefill(32), eng._prefill_host(free, toks, 32, 0)),
            (eng._get_append(32, 64),
             eng._prefill_host(0, toks, 32, int(eng.kv.lengths[0])))]
    for prog, host in runs:
        prog.load(host)
        with NoHostRead():
            prog.run_eager()
