"""The port's attention kernels against the JAX package's.

On the CPU the dispatch in `repro_torch.kernels.ops` takes each kernel's
plain PyTorch version (the tensors lie on the CPU); those plain versions are
held here against the JAX oracles (`repro.kernels.ref`) on the sweep shapes
of tests/test_kernels.py, against the Pallas kernels in interpret mode on a
few shapes, and against the JAX model's two-branch decode attention. The
CUDA kernels themselves are compared with the plain versions on a card by
the `gpu`-marked tests of tests/test_torch_gpu.py. K2's append instance has no JAX
counterpart (the JAX package attends appends in jnp ops): its plain version
is held byte for byte against the online-softmax path that the model ran
for every append before the kernel. Inputs are made with numpy from a seed
and handed to both sides. Tolerances as in tests/test_kernels.py: 2e-5 in
float32, 2e-2 in bfloat16.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import flash_decode_attention as pallas_decode  # noqa: E402
from repro.kernels.prefill_attention import flash_prefill_attention as pallas_prefill  # noqa: E402
from repro.models.attention import decode_attention as j_two_branch  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import decode_attention as k1_module  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_plain, flash_decode_attention, plan_decode_splits)
from repro_torch.kernels.prefill_attention import (  # noqa: E402
    append_attention_plain, flash_append_attention, flash_prefill_attention,
    prefill_attention_plain)
from torch_support import one_thread  # noqa: E402,F401

TOLS = {"float32": 2e-5, "bfloat16": 2e-2}
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _rand(seed, shape, scale=0.6):
    return (np.random.RandomState(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _both(arr, dtype):
    jdt, tdt = DT[dtype]
    return jnp.asarray(arr).astype(jdt), torch.from_numpy(arr).to(tdt)


def _err(j, t):
    return float(np.max(np.abs(np.asarray(j, np.float32)
                               - t.float().numpy())))


# --------------------------------------------------------------------------- #
# K2 (prefill) plain version
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("B,S,H,D", [(1, 128, 2, 64), (2, 256, 4, 64),
                                     (1, 512, 2, 128), (3, 128, 1, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 96])
def test_prefill_plain_matches_jax_ref_sweep(B, S, H, D, dtype, window):
    (qj, qt), (kj, kt), (vj, vt) = (_both(_rand(i, (B, S, H, D)), dtype)
                                    for i in range(3))
    want = jref.causal_attention_ref(qj, kj, vj, window=window)
    got = ops.prefill_attention(qt, kt, vt, window=window, impl="cuda")
    assert got.dtype == DT[dtype][1] and got.shape == (B, S, H, D)
    assert _err(want, got) < TOLS[dtype]


@pytest.mark.parametrize("S,H,Hkv,D,window", [(200, 4, 2, 16, 0),
                                              (77, 8, 2, 32, 0),
                                              (130, 4, 1, 64, 96)])
def test_prefill_plain_gqa_matches_jax_ref_on_expanded_heads(S, H, Hkv, D,
                                                             window):
    """The port reads KV head h // G itself; the JAX ref gets the
    `_repeat_kv`-expanded copy. Ragged S (no tile multiple) included."""
    q = _rand(0, (2, S, H, D))
    k, v = _rand(1, (2, S, Hkv, D)), _rand(2, (2, S, Hkv, D))
    rep = lambda x: np.repeat(x, H // Hkv, axis=2)  # noqa: E731
    want = jref.causal_attention_ref(jnp.asarray(q), jnp.asarray(rep(k)),
                                     jnp.asarray(rep(v)), window=window)
    got = prefill_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), window=window)
    assert _err(want, got) < TOLS["float32"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 96])
def test_prefill_plain_matches_pallas_interpret(dtype, window):
    B, S, H, D = 1, 256, 2, 64
    (qj, qt), (kj, kt), (vj, vt) = (_both(_rand(10 + i, (B, S, H, D)), dtype)
                                    for i in range(3))
    t = lambda x: x.transpose(0, 2, 1, 3)  # noqa: E731
    want = t(pallas_prefill(t(qj), t(kj), t(vj), window=window, block_q=64,
                            block_k=64))
    got = ops.prefill_attention(qt, kt, vt, window=window, impl="torch")
    assert _err(want, got) < TOLS[dtype]


# --------------------------------------------------------------------------- #
# K1 (decode) plain version
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("B,S,H,Hkv,D", [(2, 256, 8, 2, 64), (1, 512, 4, 4, 64),
                                         (4, 128, 16, 2, 32),
                                         (2, 1024, 8, 1, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_jax_ref_sweep(B, S, H, Hkv, D, dtype):
    qj, qt = _both(_rand(0, (B, H, D)), dtype)
    kj, kt = _both(_rand(1, (B, S, Hkv, D)), dtype)
    vj, vt = _both(_rand(2, (B, S, Hkv, D)), dtype)
    lens = np.random.RandomState(3).randint(1, S + 1, B).astype(np.int32)
    want = jref.decode_attention_ref(qj, kj, vj, jnp.asarray(lens))
    got = ops.decode_attention(qt, kt, vt, torch.from_numpy(lens),
                               impl="cuda")
    assert got.dtype == DT[dtype][1]
    assert _err(want, got) < TOLS[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_pallas_interpret(dtype):
    B, S, H, Hkv, D = 2, 256, 8, 2, 64
    qj, qt = _both(_rand(20, (B, H, D)), dtype)
    kj, kt = _both(_rand(21, (B, S, Hkv, D)), dtype)
    vj, vt = _both(_rand(22, (B, S, Hkv, D)), dtype)
    lens = np.array([1, 200], np.int32)
    want = pallas_decode(qj, kj, vj, jnp.asarray(lens), block_k=128)
    got = decode_attention_plain(qt, kt, vt, torch.from_numpy(lens))
    assert _err(want, got) < TOLS[dtype]


@pytest.mark.parametrize("H,Hkv,D", [(4, 4, 16), (4, 2, 16), (16, 8, 128)])
def test_decode_plain_new_token_branch_matches_jax_two_branch(H, Hkv, D):
    """The kernel's second branch (the fresh token) against the JAX model's
    two-branch `decode_attention`, with ragged lengths including an idle
    slot longer than the trimmed read (clamped to S)."""
    B, S = 4, 64
    q = _rand(0, (B, 1, H, D))
    k, v = _rand(1, (B, S, Hkv, D)), _rand(2, (B, S, Hkv, D))
    kn, vn = _rand(3, (B, 1, Hkv, D)), _rand(4, (B, 1, Hkv, D))
    lens = np.array([1, S, 17, 3 * S], np.int32)
    want = j_two_branch(*(jnp.asarray(x) for x in (q, k, v, kn, vn)),
                        kv_lens=jnp.asarray(lens))
    T = torch.from_numpy
    got = ops.decode_attention(T(q[:, 0]), T(k), T(v), T(lens), impl="cuda",
                               k_new=T(kn[:, 0]), v_new=T(vn[:, 0]))
    assert _err(want[:, 0], got) < TOLS["float32"]


def test_decode_plain_reads_a_strided_trimmed_view():
    """The engine hands K1 a cache view trimmed to a ctx bucket (batch
    stride of the full buffer); the result equals the contiguous copy's."""
    B, L, S, H, Hkv, D = 3, 128, 64, 4, 2, 16
    kb, vb = torch.from_numpy(_rand(1, (B, L, Hkv, D))), torch.from_numpy(
        _rand(2, (B, L, Hkv, D)))
    q = torch.from_numpy(_rand(0, (B, H, D)))
    lens = torch.tensor([5, 64, 100], dtype=torch.int32)
    a = ops.decode_attention(q, kb[:, :S], vb[:, :S], lens)
    b = ops.decode_attention(q, kb[:, :S].contiguous(),
                             vb[:, :S].contiguous(), lens)
    assert torch.equal(a, b)


def test_empty_rows_normalise_to_zero_not_nan():
    q = torch.ones(1, 2, 16)
    k = v = torch.ones(1, 8, 2, 16)
    out = decode_attention_plain(q, k, v, torch.zeros(1, dtype=torch.int32))
    assert torch.equal(out, torch.zeros_like(out))


# --------------------------------------------------------------------------- #
# K1's split planner (pure Python: the wrapper launches what it plans)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("B,Hkv,S,D", [(16, 8, 64, 128), (16, 8, 256, 128),
                                       (16, 8, 1024, 128), (1, 8, 1024, 128),
                                       (1, 8, 0, 128), (1, 1, 1, 16),
                                       (64, 8, 1024, 128), (3, 2, 517, 64),
                                       (2, 1, 300, 32), (16, 1, 64, 16)])
def test_decode_split_plan_covers_the_keys(B, Hkv, S, D):
    """At least one split; the splits cover the S + 1 key positions (the
    cache, then the new token) with none empty at the full length; never
    more splits than key chunks, so no split is shorter than one."""
    n, length = plan_decode_splits(B, Hkv, S, D)
    assert n >= 1 and length >= 1
    assert n * length >= S + 1
    assert (n - 1) * length < S + 1
    assert n <= max(1, -(-(S + 1) // k1_module.key_chunk(D)))
    assert n == 1 or length >= k1_module.key_chunk(D)


def test_decode_split_plan_depends_on_shapes_only():
    """The planner takes the shapes (and the cache's element size) and
    nothing else, gives the same plan for the same shapes, and splits the
    served shape (16 slots x 8 KV heads at a 256 ctx bucket) into more
    than B * Hkv blocks, an int8 cache's into fewer splits of twice the
    keys at G <= 4 (a 16-byte piece holds 16 of its values) and by the
    kernel's narrower pieces at G = 5-8 (8 values) and 16 (4); the wrapper
    never reads the lengths back on the host."""
    import inspect
    assert list(inspect.signature(plan_decode_splits).parameters) == [
        "B", "Hkv", "S", "D", "kv_itemsize", "G"]
    plans = {plan_decode_splits(16, 8, 256, 128) for _ in range(3)}
    assert len(plans) == 1
    n, length = plans.pop()
    assert n > 1
    assert plan_decode_splits(1, 8, 1024, 128)[0] > n
    assert plan_decode_splits(16, 8, 256, 128, 4) == (n, length)
    assert plan_decode_splits(16, 8, 256, 128, 1) == (2, 129)
    assert plan_decode_splits(16, 8, 256, 128, 1, 2) == (2, 129)
    assert [k1_module.key_chunk(128, 1, G) for G in (1, 4, 5, 8, 16)] == [
        128, 128, 64, 64, 32]
    assert plan_decode_splits(16, 8, 256, 128, 1, 5) == (4, 65)
    assert plan_decode_splits(16, 8, 256, 128, 1, 16) == (5, 52)
    for G in (1, 2, 4, 5, 6, 8, 16):
        assert plan_decode_splits(16, 8, 256, 128, 2, G) == (n, length)
    src = inspect.getsource(flash_decode_attention)
    for host_read in (".item(", ".cpu(", ".tolist(", ".numpy("):
        assert host_read not in src


# --------------------------------------------------------------------------- #
# dispatch rules
# --------------------------------------------------------------------------- #
def test_max_len_without_lengths_raises():
    q = torch.zeros(1, 2, 16)
    k = v = torch.zeros(1, 256, 2, 16)
    with pytest.raises(ValueError, match="max_len < S requires lengths"):
        ops.decode_attention(q, k, v, None, max_len=100)


def test_max_len_trims_to_a_multiple_of_128():
    B, S, H, D = 2, 512, 2, 16
    q = torch.from_numpy(_rand(0, (B, H, D)))
    k, v = (torch.from_numpy(_rand(i, (B, S, H, D))) for i in (1, 2))
    lens = torch.tensor([3, 100], dtype=torch.int32)
    a = ops.decode_attention(q, k, v, lens, max_len=100)
    b = ops.decode_attention(q, k[:, :128], v[:, :128], lens)
    assert torch.equal(a, b)


def test_unknown_impl_raises():
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="impl"):
        ops.prefill_attention(q, q, q, impl="pallas")


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches on CUDA tensors or raises; it never computes on
    the CPU itself (ops sends CPU tensors to the plain versions)."""
    q = torch.zeros(1, 2, 16)
    k = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_decode_attention(q, k, k, torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_prefill_attention(k, k, k)
    assert flash_decode_attention.launches == 0
    assert flash_prefill_attention.launches == 0


def test_plain_versions_match_ref_module():
    """`kernels.ref` mirrors the JAX oracles; the plain K1 without a new
    token equals `ref.decode_attention_ref` where every row has a key."""
    B, S, H, Hkv, D = 2, 64, 4, 2, 16
    q = torch.from_numpy(_rand(0, (B, H, D)))
    k, v = (torch.from_numpy(_rand(i, (B, S, Hkv, D))) for i in (1, 2))
    lens = torch.tensor([9, 64], dtype=torch.int32)
    a = decode_attention_plain(q, k, v, lens)
    b = ref.decode_attention_ref(q, k, v, lens)
    assert float((a - b).abs().max()) < TOLS["float32"]


# --------------------------------------------------------------------------- #
# K2's append instance: its plain version is the path every append took
# before the kernel
# --------------------------------------------------------------------------- #
def _append_inputs(B, S, P, H, Hkv, D, dtype=torch.bfloat16):
    q = torch.from_numpy(_rand(30, (B, S, H, D))).to(dtype)
    pk, pv = (torch.from_numpy(_rand(31 + i, (B, P, Hkv, D))).to(dtype)
              for i in range(2))
    kn, vn = (torch.from_numpy(_rand(33 + i, (B, S, Hkv, D))).to(dtype)
              for i in range(2))
    return q, pk, pv, kn, vn


@pytest.mark.parametrize("B,S,P,H,Hkv,D,lens", [
    (1, 15, 128, 4, 2, 16, [77]), (2, 33, 512, 4, 4, 16, [0, 512]),
    (2, 64, 1024, 6, 1, 32, [1, 600])])
def test_append_plain_is_the_online_softmax_path(B, S, P, H, Hkv, D, lens):
    """`ops.append_attention` on CPU tensors under "cuda" takes the plain
    version, whose bytes are those of the online-softmax path written out
    as the model ran it for every append before the kernel: heads
    expanded, the prefix padded to whole PREFIX_KV_CHUNK chunks with
    masked rows, the queries at the slot's length."""
    from repro_torch.models.attention import (PAD_POS, PREFIX_KV_CHUNK,
                                              online_attention)
    q, pk, pv, kn, vn = _append_inputs(B, S, P, H, Hkv, D)
    kv_lens = torch.tensor(lens, dtype=torch.int32)
    got = ops.append_attention(q, pk, pv, kn, vn, kv_lens, impl="cuda")
    start = max(lens)
    pos = start + torch.arange(S)
    pad = (-P) % PREFIX_KV_CHUNK
    kv_pos = torch.cat([torch.arange(P), torch.full((pad,), PAD_POS), pos])

    def keys(prefix, new):
        prefix = torch.nn.functional.pad(
            prefix.repeat_interleave(H // Hkv, 2), (0, 0, 0, 0, 0, pad))
        return torch.cat([prefix, new.repeat_interleave(H // Hkv, 2)], 1)
    valid = torch.cat([torch.arange(P + pad)[None] < kv_lens[:, None],
                       torch.ones(B, S, dtype=torch.bool)], 1)
    want = online_attention(q, keys(pk, kn), keys(pv, vn), pos, kv_pos,
                            causal=True, kv_valid=valid,
                            kv_chunk=PREFIX_KV_CHUNK)
    assert torch.equal(got, want)
    assert flash_append_attention.launches == 0


def test_append_plain_bucket_equals_whole_buffer():
    """The prefix trimmed to its ctx bucket and the whole buffer, whose rows
    past the live length hold other bytes, give the same bytes."""
    q, pk, pv, kn, vn = _append_inputs(1, 20, 2048, 4, 2, 16)
    lens = torch.tensor([300], dtype=torch.int32)
    whole = append_attention_plain(q, pk, pv, kn, vn, lens)
    bucket = append_attention_plain(q, pk[:, :512].clone(),
                                    pv[:, :512].clone(), kn, vn, lens)
    assert torch.equal(whole, bucket)


def test_append_under_cuda_on_cpu_routes_to_ops_with_todays_bytes(
        monkeypatch):
    """A bf16 global layer's append against a slot's prefix under "cuda" on
    CPU tensors calls `ops.append_attention` (the kernel's router) once and
    gives the bytes of the "torch" impl, which never calls it; an int8
    prefix, a local layer and a contiguous history stay off it."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import attention as A
    from repro_torch.models.config import ATTN_GLOBAL, ATTN_LOCAL
    from repro_torch.models.layers import init_params
    cfg = get_reduced("qwen3-0.6b").scaled(dtype="bfloat16", window=64)
    attn = init_params(A.Attention(cfg, "cpu"), 0)
    x = torch.from_numpy(_rand(40, (1, 24, cfg.d_model))).to(torch.bfloat16)
    pk, pv = (torch.from_numpy(_rand(41 + i, (1, 128, cfg.n_kv_heads,
                                              cfg.head_dim)))
              .to(torch.bfloat16) for i in range(2))
    lens = torch.tensor([50], dtype=torch.int32)
    calls = []
    route = ops.append_attention
    monkeypatch.setattr(ops, "append_attention",
                        lambda *a, **kw: calls.append(1) or route(*a, **kw))

    def run(impl, kind=ATTN_GLOBAL, prefix=(pk, pv), prefix_start=0,
            cfg=cfg):
        return A.gqa_prefill(attn, cfg, kind, x, lens,
                             prefix_kv=dict(zip("kv", prefix)),
                             kv_lens=lens, prefix_start=prefix_start,
                             attention_impl=impl)[0]
    want = run("torch")
    assert not calls
    assert torch.equal(run("cuda"), want)
    assert len(calls) == 1
    run("cuda", kind=ATTN_LOCAL)
    run("cuda", prefix_start=None)
    q8 = cfg.scaled(kv_cache_dtype="int8")
    run("cuda", prefix=[A.quantize_kv(t, q8) for t in (pk, pv)], cfg=q8)
    assert len(calls) == 1


def test_append_wrapper_refuses_cpu_tensors():
    q, pk, pv, kn, vn = _append_inputs(1, 4, 64, 4, 2, 16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_append_attention(q, pk, pv, kn, vn,
                               torch.ones(1, dtype=torch.int32))
    assert flash_append_attention.launches == 0
