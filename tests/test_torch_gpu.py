"""The port's CUDA kernels and its engine on a card. Every test here is
marked `gpu` and skips on a machine without one; on a card run

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

(`--noconftest`: the repository's conftest imports JAX, which a card-only
machine need not have; nothing here imports JAX or the JAX package). The
attention kernels are held against their plain versions (float32 with TF32
off: 2e-5; bfloat16: 2e-2). K1 (`csrc/decode_attention.cu`, replacing the
Pallas `flash_decode_attention`) is bound by the bytes of the cache it
reads; it splits each (sequence, KV head)'s keys across blocks, planned
from the shapes alone, and merges the splits in a second pass — so its
cases cover rows with no key, len == S, idle slots longer than the trimmed
read, B = 1 at S = 1024 (many splits), B = 16 at S = 64 (one split, no
combine), every group size at D = 128 and 16, the dense family's heads (D =
160 and 240, whose rows leave lanes idle, and G = 6), an int8 cache at D =
128 and every G (read as int8 x scale, against the plain version that
dequantizes first; a head dim without an int8 instance raises) and a
CUDA-graph replay against the eager call (not done yet: a persistent
grid). K2
(`csrc/prefill_attention.cu`, replacing the Pallas
`flash_prefill_attention`) is bound by bytes up to S of ~900 at
qwen3-0.6b's heads; in bf16 it runs on the tensor cores (`mma.sync` fed by
`ldmatrix`, K/V tiles streamed by `cp.async`), so its cases cover ragged S
around the 64-row tiles, window 96, G in {1, 2, 6, 8} and D in {16, 64,
128, 160, 240} (D = 240 in 32-key tiles; not done yet: `wgmma` and TMA);
fp32 keeps the CUDA-core kernel. K2's append instance (an append's
queries against the slot's prefix, rows past kv_lens masked, then the new
keys causally; bf16, G query heads packed as rows of one tile, the prefix
cut into ranges of APPEND_SPLIT rows merged by a combine pass) is held
against its plain version in fp32 at every D and G in {1, 2, 5, 6}, at S
of 1, 15 and 512, with live lengths 0, 1, 777, exactly one range and 1,500
in one launch, and at the served length (512 on 16,000 rows), within 1% of
the largest output, on inputs where a fault moves an output by O(1) (a
peaked softmax, the rows at each live length the best keys of a query);
a prefix gathered to its ctx bucket gives the bytes of the slot's view of
the whole buffer, and a graph replay with the lengths changed equals the
eager call. K3
(`csrc/wkv6.cu`) is chunk-parallel: chunks of 8 tokens run at once, one
warp each, the state is carried over them, and a block takes its chunks in
passes; it is held against the step recurrence within 5e-5 of the
result's magnitude (both widen bf16 inputs exactly and accumulate in fp32;
only the order of the sums differs, and a long prefill whose decay is near
1 grows the state) at the chunk and pass edges, each head size, under
slow, default and strong decay (the full-width init's |cum logw| of
10^2-10^3 per 64 tokens) and on strided views. K4 (`csrc/rglru.cu`) is a
blocked scan of up to 16 segments a tile; it is held against the step recurrence
within 1e-5 (fp32) and 1e-5 of the result's magnitude (bf16 inputs,
widened exactly) at its segment and tile edges, W not a multiple of 32,
and every mix of input dtypes. Each launch is counted, a CUDA-graph replay
of K1, K2, K3 and K4 equals the eager call bit for bit, the reduced
models served through the kernels give the same greedy tokens as the torch
paths, and nemotron-4-15b at full width and two layers serves through them.
The replica's programs (`engine/programs.py`, one CUDA graph per
bucket key): graph against eager for each family in fp32 — tokens and
caches byte-identical through a ragged chunk, a slot joining, an append and
a bucket captured after a kill and rejoin — the launches each replay
counts, the cache unchanged by a capture, the refusal of a moved tensor,
and graphed prefill and appends against the reference path byte for
byte, and for an int8 cache with every eager K1 call handed the int8
rows; whisper-small's decode chunk (its cross-attention and its
sinusoidal row in the graph) and internvl2-26b's turn-1 prefill with its
patch embeddings (in the program's static input), graph against eager.
The prefix pool's hit (a fold of the pooled rows, then the append graph
its miss replays): for four families, in fp32 the tokens and live rows of
a graphed hit, an eager hit and a miss byte-identical, in bf16 the tokens
equal; and on qwen3-0.6b the hit replays that one append graph, with no K2
launch. A kernel launch whose input requires grad raises (no kernel has a
backward), and the reduced model's training step launches no kernel."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.engine import ReplicaEngine  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_plain, flash_decode_attention, plan_decode_splits)
from repro_torch.kernels.prefill_attention import (  # noqa: E402
    APPEND_SPLIT, HEAD_DIMS, append_attention_plain, flash_append_attention,
    flash_prefill_attention, prefill_attention_plain)
from repro_torch.kernels.rglru import rglru_cuda, rglru_plain  # noqa: E402
from repro_torch.kernels.wkv6 import wkv6_cuda, wkv6_plain  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

TOLS = {"float32": 2e-5, "bfloat16": 2e-2}
WKV_RTOL = 5e-5
RGLRU_TOL = 1e-5  # tests/test_kernels.py::test_rglru_sweep


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(dev, dtype, seed, shape):
    x = np.random.RandomState(seed).standard_normal(shape) * 0.6
    return torch.from_numpy(x.astype(np.float32)).to(dev, getattr(torch,
                                                                  dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,Hkv,D", [(4, 4, 16), (16, 8, 128), (8, 1, 64),
                                     (16, 1, 32),
                                     # G = 1, 2, 4, 8, 16 at D = 128 and 16
                                     (8, 8, 128), (8, 2, 128), (16, 2, 128),
                                     (16, 1, 128), (4, 2, 16), (8, 2, 16),
                                     (8, 1, 16), (16, 1, 16),
                                     # the dense family's heads: stablelm,
                                     # nemotron (G = 6), gemma3, olmo
                                     (32, 8, 160), (48, 8, 128),
                                     (16, 8, 240), (16, 16, 128),
                                     (12, 2, 160), (16, 2, 240),
                                     # llama4-scout's heads (G = 5, the
                                     # first odd G above 1), and G = 5 at
                                     # D = 16, 160 and 240
                                     (40, 8, 128), (5, 1, 16), (10, 2, 160),
                                     (5, 1, 240),
                                     # whisper-small's (G = 1 at D = 64)
                                     (12, 12, 64)])
def test_cuda_decode_kernel_matches_plain(cuda, dtype, H, Hkv, D):
    """Ragged lengths 1, S, and longer than the trimmed read; the cache is a
    strided view of a longer buffer; the new token rides as a second
    branch."""
    B, L, S = 5, 512, 256
    q = _rand(cuda, dtype, 0, (B, H, D))
    kb, vb = (_rand(cuda, dtype, i, (B, L, Hkv, D)) for i in (1, 2))
    kn, vn = (_rand(cuda, dtype, i, (B, Hkv, D)) for i in (3, 4))
    lens = torch.tensor([1, S, 3, 400, 130], dtype=torch.int32, device=cuda)
    before = flash_decode_attention.launches
    got = ops.decode_attention(q, kb[:, :S], vb[:, :S], lens, k_new=kn,
                               v_new=vn)
    want = decode_attention_plain(q, kb[:, :S], vb[:, :S], lens, kn, vn)
    no_new = ops.decode_attention(q, kb[:, :S], vb[:, :S], lens)
    torch.cuda.synchronize()
    assert flash_decode_attention.launches == before + 2
    assert float((got.float() - want.float()).abs().max()) < TOLS[dtype]
    want_nn = decode_attention_plain(q, kb[:, :S], vb[:, :S], lens)
    assert float((no_new.float() - want_nn.float()).abs().max()) \
        < TOLS[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,L,S,lens", [
    (1, 1024, 1024, [1024]),          # one sequence: many splits, len == S
    (1, 1024, 1024, [517]),
    (16, 128, 64, [0, 64, 1, 63, 100, 33, 2, 64, 17, 0, 5, 40, 128, 9, 31,
                   32]),              # 16 slots at the 64 bucket: one split
    (3, 512, 256, [0, 256, 400])])    # an empty row, len == S, an idle slot
def test_cuda_decode_kernel_split_shapes(cuda, dtype, B, L, S, lens):
    """qwen3-0.6b's heads (16 over 8, D = 128) at the split planner's edge
    cases, with and without the new token. A row with len == 0 and no new
    token is exactly 0; with the new token it is that token's v."""
    H, Hkv, D = 16, 8, 128
    q = _rand(cuda, dtype, 0, (B, H, D))
    kb, vb = (_rand(cuda, dtype, i, (B, L, Hkv, D)) for i in (1, 2))
    kn, vn = (_rand(cuda, dtype, i, (B, Hkv, D)) for i in (3, 4))
    k, v = kb[:, :S], vb[:, :S]
    lens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    if B == 1:
        assert plan_decode_splits(B, Hkv, S, D)[0] > 1
    got = flash_decode_attention(q, k, v, lens, kn, vn)
    no_new = flash_decode_attention(q, k, v, lens)
    want = decode_attention_plain(q, k, v, lens, kn, vn)
    want_nn = decode_attention_plain(q, k, v, lens)
    torch.cuda.synchronize()
    assert float((got.float() - want.float()).abs().max()) < TOLS[dtype]
    assert float((no_new.float() - want_nn.float()).abs().max()) \
        < TOLS[dtype]
    empty = lens == 0
    assert torch.equal(no_new[empty], torch.zeros_like(no_new[empty]))
    assert not torch.isnan(no_new).any() and not torch.isnan(got).any()
    new_only = vn.repeat_interleave(H // Hkv, dim=1)[empty]
    assert float((got[empty].float() - new_only.float()).abs().max()
                 if empty.any() else 0.0) < TOLS[dtype]


def _int8(dev, seed, shape, scale):
    """An int8 cache of the values a quantized cache holds: N(0, 0.6)
    rows through `quantize_kv`'s round(x / scale), clamped to 127."""
    x = np.random.RandomState(seed).standard_normal(shape) * 0.6 / scale
    return torch.from_numpy(np.clip(np.round(x), -127, 127).astype(
        np.int8)).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,Hkv", [(16, 8), (16, 16), (40, 8), (48, 8),
                                   (32, 4), (64, 8), (16, 1)])
@pytest.mark.parametrize("B,L,S,lens", [
    (5, 512, 256, [1, 256, 3, 400, 130]),   # an idle slot past the read
    (1, 1024, 1024, [517]),                 # many splits
    (3, 512, 256, [0, 256, 400])])          # an empty row
def test_cuda_decode_kernel_int8_cache(cuda, dtype, H, Hkv, B, L, S, lens):
    """K1 reading an int8 cache (int8 x 0.05) at D = 128 and every G, with
    and without the new token (in q's dtype), against the plain version,
    which dequantizes first."""
    D, scale = 128, 0.05
    q = _rand(cuda, dtype, 0, (B, H, D))
    kb, vb = (_int8(cuda, i, (B, L, Hkv, D), scale) for i in (1, 2))
    kn, vn = (_rand(cuda, dtype, i, (B, Hkv, D)) for i in (3, 4))
    k, v = kb[:, :S], vb[:, :S]
    lens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    got = flash_decode_attention(q, k, v, lens, kn, vn, kv_scale=scale)
    no_new = ops.decode_attention(q, k, v, lens, kv_scale=scale)
    want = decode_attention_plain(q, k, v, lens, kn, vn, scale)
    want_nn = decode_attention_plain(q, k, v, lens, kv_scale=scale)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype
    assert float((got.float() - want.float()).abs().max()) < TOLS[dtype]
    assert float((no_new.float() - want_nn.float()).abs().max()) \
        < TOLS[dtype]
    empty = lens == 0
    assert torch.equal(no_new[empty], torch.zeros_like(no_new[empty]))


@pytest.mark.gpu
def test_cuda_decode_kernel_int8_refuses_what_it_does_not_take(cuda):
    """An int8 cache at a head dim without an int8 instance raises (no
    quiet dequantize-and-call); so does an int8 cache without its scale,
    or a scale with a float cache."""
    one = torch.ones(1, dtype=torch.int32, device=cuda)
    q = torch.zeros(1, 4, 64, device=cuda)
    k = torch.zeros(1, 8, 2, 64, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="int8 cache"):
        ops.decode_attention(q, k, k, one, kv_scale=0.05)
    q = torch.zeros(1, 4, 128, device=cuda)
    k = torch.zeros(1, 8, 2, 128, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="kv_scale"):
        flash_decode_attention(q, k, k, one)
    with pytest.raises(ValueError, match="kv_scale"):
        flash_decode_attention(q, k.float(), k.float(), one, kv_scale=0.05)


@pytest.mark.gpu
def test_int8_engine_graph_equals_eager_and_feeds_k1_int8(cuda, monkeypatch):
    """Reduced qwen3-0.6b in fp32 with an int8 cache and K1's int8 head
    dim (128): a ragged chunk and an append through the CUDA graphs
    against the same bodies run eagerly, tokens and caches byte-identical,
    and every K1 call of the eager bodies is handed the int8 cache
    itself."""
    from repro_torch.engine.kvcache import leaves
    cfg = get_reduced("qwen3-0.6b").scaled(kv_cache_dtype="int8",
                                           head_dim=128)
    params = build_model(cfg).init(0, cuda)
    seen = []
    real = ops.flash_decode_attention

    def spy(q, k, v, *a, **kw):
        seen.append(k.dtype)
        return real(q, k, v, *a, **kw)
    out = {}
    for graphs in (False, True):
        eng = ReplicaEngine(cfg, params, n_slots=4, max_ctx=256,
                            cuda_graphs=graphs)
        if not graphs:
            monkeypatch.setattr(ops, "flash_decode_attention", spy)
        nt = np.zeros(4, np.int32)
        em = np.zeros(4, bool)
        for i, n in enumerate((37, 90, 5)):
            s = eng.kv.acquire()
            nt[s] = int(eng.prefill_conversation(
                s, np.arange(3 + i, 3 + i + n, dtype=np.int32) % 500)[0])
            em[s] = True
        seq, _ = eng.decode_steps(nt, em, np.array([7, 3, 5, 0], np.int32))
        tok, _ = eng.append_prefill(0, np.arange(10, dtype=np.int32))
        monkeypatch.setattr(ops, "flash_decode_attention", real)
        out[graphs] = (seq, int(tok), [t.clone() for _, t in
                                       leaves(eng.kv.caches)])
    assert seen and set(seen) == {torch.int8}
    assert np.array_equal(out[False][0], out[True][0])
    assert out[False][1] == out[True][1]
    assert all(torch.equal(a, b) for a, b in zip(out[False][2],
                                                 out[True][2]))


@pytest.mark.gpu
def test_cuda_decode_kernel_graph_replay_equals_eager(cuda):
    """A K1 call captured in a CUDA graph and replayed gives the eager
    call's bits, and reads the lengths at replay time: nothing about them
    was fixed on the host when the launch was captured."""
    B, L, S, H, Hkv, D = 16, 1024, 256, 16, 8, 128
    q = _rand(cuda, "bfloat16", 0, (B, H, D))
    kb, vb = (_rand(cuda, "bfloat16", i, (B, L, Hkv, D)) for i in (1, 2))
    kn, vn = (_rand(cuda, "bfloat16", i, (B, Hkv, D)) for i in (3, 4))
    lens = torch.arange(B, dtype=torch.int32, device=cuda) * 17 % (S + 40)
    call = lambda: flash_decode_attention(  # noqa: E731
        q, kb[:, :S], vb[:, :S], lens, kn, vn)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call()
    for new_lens in (lens.clone(), (S - lens).clamp(min=0)):
        lens.copy_(new_lens)
        graph.replay()
        eager = call()
        torch.cuda.synchronize()
        assert torch.equal(captured, eager)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,H,Hkv,D,window", [
    (64, 4, 4, 16, 0), (200, 16, 8, 128, 0), (256, 4, 2, 64, 96),
    (33, 2, 1, 32, 0),
    # ragged S around the 64-row tiles at qwen3-0.6b's heads
    (1, 16, 8, 128, 0), (15, 16, 8, 128, 0), (16, 16, 8, 128, 0),
    (17, 16, 8, 128, 0), (63, 16, 8, 128, 0), (64, 16, 8, 128, 0),
    (65, 16, 8, 128, 0), (256, 16, 8, 128, 0), (512, 16, 8, 128, 0),
    (1024, 16, 8, 128, 0),
    # window 96, G = 1 / 2 / 8, D = 16 / 64 / 128
    (512, 16, 8, 128, 96), (200, 8, 8, 16, 96), (300, 8, 8, 64, 0),
    (256, 16, 2, 64, 0), (130, 8, 1, 16, 0), (65, 16, 2, 128, 96),
    # the dense family's heads (stablelm D = 160, nemotron G = 6, gemma3
    # D = 240 in 32-key tiles, olmo G = 1), ragged around their tiles
    (200, 32, 8, 160, 0), (512, 32, 8, 160, 0), (65, 32, 8, 160, 96),
    (1, 32, 8, 160, 0), (200, 48, 8, 128, 0), (1024, 48, 8, 128, 0),
    (200, 16, 8, 240, 0), (1024, 16, 8, 240, 0), (31, 16, 8, 240, 0),
    (33, 16, 8, 240, 0), (300, 16, 8, 240, 96), (256, 16, 16, 128, 0),
    # whisper-small's decoder (12 / 12 x 64), ragged around its tiles
    (150, 12, 12, 64, 0), (256, 12, 12, 64, 0), (65, 12, 12, 64, 0),
    # llama4-scout's heads (G = 5), ragged around the tiles
    (1, 40, 8, 128, 0), (65, 40, 8, 128, 0), (200, 40, 8, 128, 0),
    (512, 40, 8, 128, 0), (300, 40, 8, 128, 96)])
def test_cuda_prefill_kernel_matches_plain(cuda, dtype, S, H, Hkv, D, window):
    q = _rand(cuda, dtype, 0, (2, S, H, D))
    k, v = (_rand(cuda, dtype, i, (2, S, Hkv, D)) for i in (1, 2))
    before = flash_prefill_attention.launches
    got = ops.prefill_attention(q, k, v, window=window)
    want = prefill_attention_plain(q, k, v, window=window)
    torch.cuda.synchronize()
    assert flash_prefill_attention.launches == before + 1
    assert float((got.float() - want.float()).abs().max()) < TOLS[dtype]


# K2's append instance: five sequences a launch, whose live prefix lengths
# are 0, 1, one not a multiple of the 64-key tile, one exactly on a range
# boundary and one across it, in a buffer of two ranges
APPEND_LENS = (0, 1, 777, APPEND_SPLIT, 1500)
APPEND_P = 2 * APPEND_SPLIT
# max|kernel - plain| over max|plain|, the plain version in fp32 on the
# kernel's bf16 inputs: rounding the output to bf16 costs at most 1/256 of
# an output's size, rounding P to bf16 before P·V at most 1/512
APPEND_RTOL = 1e-2


def _append_inputs(dev, seed, lens, S, P, H, Hkv, D):
    """bf16 inputs of K2's append instance on which its faults show. q is 8
    times the keys' scale, so a query's scores spread by ~3 and its output
    lies near one v row, O(1): a range skipped or the new keys dropped
    moves the outputs whose best keys were there. At each sequence's live
    length L, row L - 1 is made the best key of query 0's first head and
    row L (where the buffer has one) that of the last query's last head, so
    a row too few or too many moves an output by O(1)."""
    B, G = len(lens), H // Hkv
    q = _rand(dev, "bfloat16", seed, (B, S, H, D)) * 8
    pk, pv, kn, vn = (_rand(dev, "bfloat16", seed + 1 + i, shape)
                      for i, shape in enumerate([(B, P, Hkv, D)] * 2
                                                + [(B, S, Hkv, D)] * 2))
    gamma = 1.3 / math.sqrt(D)  # a score of ~30 against the spread's ~3
    for b, L in enumerate(lens):
        if L >= 1:
            pk[b, L - 1, 0] = gamma * q[b, 0, 0]
        if L < P:
            pk[b, L, Hkv - 1] = gamma * q[b, S - 1, H - 1]
    return q, pk, pv, kn, vn


def _append_rel_err(got, q, pk, pv, kn, vn, lens):
    """max|got - plain| / max|plain|, the plain version in fp32."""
    want = append_attention_plain(q.float(), pk.float(), pv.float(),
                                  kn.float(), vn.float(), lens)
    return float((got.float() - want).abs().max() / want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 15, 512])
@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("G", [1, 2, 5, 6])
def test_cuda_append_kernel_matches_plain(cuda, G, D, S):
    inputs = _append_inputs(cuda, 50, APPEND_LENS, S, APPEND_P, 2 * G, 2, D)
    lens = torch.tensor(APPEND_LENS, dtype=torch.int32, device=cuda)
    before = flash_append_attention.launches
    got = ops.append_attention(*inputs, lens)
    torch.cuda.synchronize()
    assert flash_append_attention.launches == before + 1
    assert _append_rel_err(got, *inputs, lens) < APPEND_RTOL


@pytest.mark.gpu
@pytest.mark.parametrize("H,Hkv,D", [(16, 8, 128), (48, 8, 128)])
def test_cuda_append_kernel_matches_plain_at_the_served_length(cuda, H, Hkv,
                                                               D):
    """The served shape: 512 new tokens on 16,000 live rows of a 16,384-row
    bucket, 16 ranges merged."""
    inputs = _append_inputs(cuda, 55, (16000,), 512, 16384, H, Hkv, D)
    lens = torch.tensor([16000], dtype=torch.int32, device=cuda)
    got = flash_append_attention(*inputs, lens)
    assert _append_rel_err(got, *inputs, lens) < APPEND_RTOL


@pytest.mark.gpu
@pytest.mark.parametrize("H,Hkv,D", [(16, 8, 128), (48, 8, 128),
                                     (16, 8, 240)])
@pytest.mark.parametrize("live", [1500, 2048])
def test_cuda_append_kernel_bucket_equals_whole_buffer(cuda, H, Hkv, D,
                                                       live):
    """A slot's prefix gathered to its ctx bucket (2048 rows) and the same
    slot's view of the whole 8192-row buffer of four slots give the same
    bytes, rows past the live length holding other values."""
    q, _, _, kn, vn = _append_inputs(cuda, 60, (1,), 512, 1, H, Hkv, D)
    buf_k, buf_v = (_rand(cuda, "bfloat16", i, (4, 8192, Hkv, D))
                    for i in (61, 62))
    lens = torch.tensor([live], dtype=torch.int32, device=cuda)
    whole = flash_append_attention(q, buf_k[2:3], buf_v[2:3], kn, vn, lens)
    bucket = flash_append_attention(q, buf_k[2:3, :2048].contiguous(),
                                    buf_v[2:3, :2048].contiguous(), kn, vn,
                                    lens)
    torch.cuda.synchronize()
    assert torch.equal(whole, bucket)


@pytest.mark.gpu
def test_cuda_append_kernel_graph_replay_equals_eager(cuda):
    """The graph reads kv_lens on the device: replays with the lengths
    rolled between them equal eager calls bit for bit."""
    q, pk, pv, kn, vn = _append_inputs(cuda, 70, APPEND_LENS, 300,
                                       APPEND_P, 16, 8, 128)
    lens = torch.tensor(APPEND_LENS, dtype=torch.int32, device=cuda)
    _graph_replay_equals_eager(
        (q, pk, pv, kn, vn, lens),
        lambda: (flash_append_attention(q, pk, pv, kn, vn, lens),))


@pytest.mark.gpu
def test_cuda_append_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q, pk, pv, kn, vn = _append_inputs(cuda, 80, (1,), 8, 64, 4, 2, 16)
    one = torch.ones(1, dtype=torch.int32, device=cuda)
    f32 = [t.float() for t in (q, pk, pv, kn, vn)]
    with pytest.raises(ValueError, match="bfloat16"):
        flash_append_attention(*f32, one)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_append_attention(q, pk, pv, kn, vn, one.cpu())
    q48, p48, n48 = (torch.zeros(1, n, h, 48, device=cuda,
                                 dtype=torch.bfloat16)
                     for n, h in ((8, 4), (64, 2), (8, 2)))
    with pytest.raises(ValueError, match="head_dim"):
        flash_append_attention(q48, p48, p48, n48, n48, one)
    with pytest.raises(ValueError, match="multiple"):
        flash_append_attention(q[:, :, :3].contiguous(), pk, pv, kn, vn, one)
    with pytest.raises(ValueError, match="k_new"):
        flash_append_attention(q, pk, pv, kn[:, :4], vn[:, :4], one)
    with pytest.raises(ValueError, match="contiguous"):
        flash_append_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                               pk, pv, kn, vn, one)
    with pytest.raises(ValueError, match="strides"):
        flash_append_attention(q, pk.transpose(1, 2).contiguous()
                               .transpose(1, 2), pv, kn, vn, one)
    with pytest.raises(ValueError, match="kv_lens"):
        flash_append_attention(q, pk, pv, kn, vn, one.repeat(2))


@pytest.mark.gpu
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 4, 48, device=cuda)  # head_dim 48
    k = torch.zeros(1, 8, 4, 48, device=cuda)
    one = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_decode_attention(q, k, k, one)
    q = torch.zeros(1, 3, 128, device=cuda)  # G = 3: not instantiated
    k = torch.zeros(1, 8, 1, 128, device=cuda)
    with pytest.raises(ValueError, match="H/Hkv"):
        flash_decode_attention(q, k, k, one)
    q = torch.zeros(1, 16, 240, device=cuda)  # G = 16 at D = 240
    k = torch.zeros(1, 8, 1, 240, device=cuda)
    with pytest.raises(ValueError, match="not instantiated"):
        flash_decode_attention(q, k, k, one)
    with pytest.raises(ValueError, match="head_dim"):
        flash_prefill_attention(*(torch.zeros(1, 8, 2, 48, device=cuda),) * 3)
    with pytest.raises(ValueError, match="dtypes"):
        flash_prefill_attention(*(torch.zeros(1, 8, 2, 16, device=cuda,
                                              dtype=torch.float16),) * 3)


@pytest.mark.gpu
def test_engine_kernels_match_torch_path_and_count_launches(cuda):
    """The reduced model on the card: prefill, append and a ragged decode
    chunk through the kernels give the torch path's greedy tokens, and both
    kernels were launched."""
    cfg = get_reduced("qwen3-0.6b").scaled(n_kv_heads=2)
    params = build_model(cfg).init(0, cuda)

    def roll(impl):
        eng = ReplicaEngine(cfg, params, n_slots=3, max_ctx=256,
                            attention_impl=impl)
        idle = eng.kv.acquire()
        eng.prefill_conversation(idle, np.arange(1, 150, dtype=np.int32))
        s = eng.kv.acquire()
        t, _ = eng.prefill_conversation(s, np.arange(7, 44, dtype=np.int32))
        t2, _ = eng.append_prefill(s, np.arange(60, 75, dtype=np.int32))
        nt = np.zeros(3, np.int32)
        em = np.zeros(3, bool)
        nt[s], em[s] = int(t2), True
        seq, _ = eng.decode_steps(nt, em, 5)
        return [int(t), int(t2)] + [int(x) for x in seq[:, s]]

    ops.reset_launch_counts()
    want = roll("torch")
    assert ops.launch_counts() == {"decode_attention": 0,
                                   "prefill_attention": 0,
                                   "append_attention": 0, "wkv6": 0,
                                   "rglru": 0}
    assert roll("cuda") == want
    counts = ops.launch_counts()
    # the chunk of 5 replays its bucket's graph, which runs 8 steps
    assert counts["decode_attention"] == 8 * cfg.n_layers
    assert counts["prefill_attention"] == 2 * cfg.n_layers
    assert counts["wkv6"] == 0


def _wkv_inputs(dev, dtype, seed, B, S, H, hs, slow_decay=False,
                strong_decay=False):
    rs = np.random.RandomState(seed)
    n = lambda shape, sc: torch.from_numpy(  # noqa: E731
        (rs.standard_normal(shape) * sc).astype(np.float32)).to(dev)
    r, k, v = (n((B, S, H, hs), 0.5).to(getattr(torch, dtype))
               for _ in range(3))
    # decay e^{-e^{x}}: x around -4 keeps it within a few % of 1; x around
    # 1.5 gives |cum logw| of ~330 per 64 tokens, as rwkv6-3b's full-width
    # init does (10^2-10^3)
    shift = -4.0 if slow_decay else (1.5 if strong_decay else 0.0)
    logw = -torch.exp(n((B, S, H, hs), 0.5) + shift)
    return r, k, v, logw, n((H, hs), 0.3), n((B, H, hs, hs), 0.2)


def _wkv_err(got, want):
    return max(float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
               for g, w in zip(got, want))


# K3 takes its tokens in chunks of 8 (`kC` in csrc/wkv6.cu) and its chunks in
# passes of as many as a block's shared memory holds: 4 (fp32) or 5 (bf16)
# at hs = 64, 7 or 10 at hs = 32, 12 at hs = 16
WKV_CHUNK = 8


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,hs,decay", [
    (1, 1, 40, 64, "default"), (1, 24, 4, 16, "default"),
    (2, 77, 3, 32, "default"), (1, 150, 40, 64, "default"),
    (1, 512, 40, 64, "slow"),
    # the full-width init's decays at the chunk and pass edges (33, 41, 57,
    # 81 and 97 are one token past a pass of the dtype's and head size's
    # chunk count), each head size
    (2, 1, 5, 64, "strong"), (2, WKV_CHUNK - 1, 5, 64, "strong"),
    (2, WKV_CHUNK + 1, 5, 64, "strong"), (2, 33, 5, 64, "strong"),
    (2, 41, 5, 64, "strong"), (2, 81, 5, 64, "strong"),
    (2, 300, 5, 64, "strong"), (2, 512, 5, 64, "strong"),
    (2, 1, 5, 16, "strong"), (2, WKV_CHUNK + 1, 5, 16, "strong"),
    (2, 97, 5, 16, "strong"), (2, 129, 5, 16, "strong"),
    (2, 512, 5, 16, "strong"), (2, WKV_CHUNK - 1, 5, 32, "strong"),
    (2, 57, 5, 32, "strong"), (2, 81, 5, 32, "strong"),
    (2, 129, 5, 32, "strong"), (2, 512, 5, 32, "strong")])
def test_cuda_wkv6_kernel_matches_plain(cuda, dtype, B, S, H, hs, decay):
    args = _wkv_inputs(cuda, dtype, 0, B, S, H, hs,
                       slow_decay=decay == "slow",
                       strong_decay=decay == "strong")
    before = wkv6_cuda.launches
    got = ops.wkv6(*args)
    want = wkv6_plain(*args)
    torch.cuda.synchronize()
    assert wkv6_cuda.launches == before + 1
    assert got[0].dtype == torch.float32 and got[0].shape == (B, S, H, hs)
    assert _wkv_err(got, want) < WKV_RTOL


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_wkv6_rows_off_16_byte_alignment(cuda, dtype):
    """r, k, v, logw one element past a 16-byte boundary: the kernel stages
    them element by element instead of in 16-byte pieces, with the same
    result as the plain version."""
    args = _wkv_inputs(cuda, dtype, 5, 1, 45, 4, 32, strong_decay=True)

    def shifted(x):
        flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        out = flat[1:].view(x.shape)
        out.copy_(x)
        return out

    moved = [shifted(x) for x in args[:4]]
    assert moved[0].data_ptr() % 16 != 0
    got = wkv6_cuda(*moved, *args[4:])
    assert _wkv_err(got, wkv6_plain(*args)) < WKV_RTOL


def _graph_replay_equals_eager(inputs, call):
    """Capture `call()` in a CUDA graph, copy new values into `inputs` and
    replay: the captured outputs equal a fresh eager call's bit for bit (the
    kernels sum in a fixed order and read nothing back to the host)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call()
    for _ in range(2):
        for x in inputs:
            x.copy_(x.roll(1, -1))  # new values of the same distribution
        graph.replay()
        eager = call()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(captured, eager))


@pytest.mark.gpu
def test_cuda_wkv6_graph_replay_equals_eager(cuda):
    r, k, v, logw, u, s0 = _wkv_inputs(cuda, "bfloat16", 6, 1, 150, 40, 64)
    _graph_replay_equals_eager(
        (r, k, v, logw, u, s0), lambda: wkv6_cuda(r, k, v, logw, u, s0))


@pytest.mark.gpu
def test_cuda_rglru_graph_replay_equals_eager(cuda):
    la, b, h0 = _rglru_inputs(cuda, "float32", 7, 1, 150, 4096)
    _graph_replay_equals_eager((la, b, h0), lambda: rglru_cuda(la, b, h0))


@pytest.mark.gpu
@pytest.mark.parametrize("S,hs,strong", [(33, 32, False), (300, 64, True)])
def test_cuda_wkv6_reads_strided_views(cuda, S, hs, strong):
    """r, k, v as head slices of wider tensors (hs axis contiguous, other
    strides free) give the contiguous copies' result exactly, within the
    tolerance of the plain version, under strong decay too."""
    r, k, v, logw, u, s0 = _wkv_inputs(cuda, "bfloat16", 1, 2, S, 6, hs,
                                       strong_decay=strong)
    wide = [torch.cat([x, x], dim=2)[:, :, 3:9] for x in (r, k, v, logw)]
    assert not wide[0].is_contiguous()
    a = ops.wkv6(*wide, u, s0)
    b = ops.wkv6(*(x.contiguous() for x in wide), u, s0)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert _wkv_err(a, wkv6_plain(*wide, u, s0)) < WKV_RTOL


@pytest.mark.gpu
def test_cuda_wkv6_refuses_what_the_kernel_does_not_take(cuda):
    r, k, v, logw, u, s0 = _wkv_inputs(cuda, "float32", 2, 1, 4, 2, 16)
    with pytest.raises(ValueError, match="head size"):
        wkv6_cuda(*(torch.zeros(1, 4, 2, 48, device=cuda),) * 4,
                  torch.zeros(2, 48, device=cuda),
                  torch.zeros(1, 2, 48, 48, device=cuda))
    with pytest.raises(ValueError, match="float32"):
        wkv6_cuda(r, k, v, logw.to(torch.bfloat16), u, s0)
    with pytest.raises(ValueError, match="hs axis"):
        wkv6_cuda(r.transpose(2, 3).contiguous().transpose(2, 3), k, v,
                  logw, u, s0)


@pytest.mark.gpu
def test_rwkv_engine_kernel_matches_torch_path_and_counts_launches(cuda):
    """The reduced rwkv6-3b on the card: turn-1 prefill, an append and a
    decode chunk give the same greedy tokens through K3 as through
    `wkv6_chunked`, and K3 ran once per layer per prefill."""
    cfg = get_reduced("rwkv6-3b")
    params = build_model(cfg).init(0, cuda)

    def roll(impl):
        eng = ReplicaEngine(cfg, params, n_slots=2, max_ctx=256,
                            attention_impl=impl)
        s = eng.kv.acquire()
        t, _ = eng.prefill_conversation(s, np.arange(7, 44, dtype=np.int32))
        t2, _ = eng.append_prefill(s, np.arange(60, 75, dtype=np.int32))
        nt = np.zeros(2, np.int32)
        em = np.zeros(2, bool)
        nt[s], em[s] = int(t2), True
        seq, _ = eng.decode_steps(nt, em, 5)
        return [int(t), int(t2)] + [int(x) for x in seq[:, s]]

    ops.reset_launch_counts()
    want = roll("torch")
    assert ops.launch_counts()["wkv6"] == 0
    assert roll("cuda") == want
    counts = ops.launch_counts()
    assert counts == {"decode_attention": 0, "prefill_attention": 0,
                      "append_attention": 0, "wkv6": 2 * cfg.n_layers,
                      "rglru": 0}


def _rglru_inputs(dev, dtype, seed, B, S, W):
    """tests/test_kernels.py's distributions: log_a = -exp(0.3 N) (decay in
    (0, 1)), b ~ 0.5 N, h0 ~ 0.2 N; log_a and b in `dtype`."""
    rs = np.random.RandomState(seed)
    n = lambda shape, sc: torch.from_numpy(  # noqa: E731
        (rs.standard_normal(shape) * sc).astype(np.float32)).to(dev)
    dt = getattr(torch, dtype)
    return (-torch.exp(n((B, S, W), 0.3))).to(dt), n((B, S, W), 0.5).to(dt), \
        n((B, W), 0.2)


# K4 splits a tile of up to 16 x 16 steps evenly over up to 16 segments
RGLRU_SEG_LEN = 16


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,b_dtype", [
    ("float32", "float32"), ("bfloat16", "bfloat16"),
    ("float32", "bfloat16"), ("bfloat16", "float32")])
@pytest.mark.parametrize("B,S,W", [
    (1, 1, 4096), (1, 24, 4096), (1, 150, 4096), (1, 512, 4096),
    (2, 200, 2560), (3, 37, 100),
    # one step short of a full segment, one past a full tile, W not a
    # multiple of 32
    (1, RGLRU_SEG_LEN - 1, 2560), (1, 16 * RGLRU_SEG_LEN + 1, 2560),
    (1, 1, 4095), (1, 24, 4095), (1, 16 * RGLRU_SEG_LEN + 1, 4095),
    (1, 512, 4095)])
def test_cuda_rglru_kernel_matches_plain(cuda, dtype, b_dtype, B, S, W):
    """S = 1, the served shapes, the segment and tile edges, W that are not
    a multiple of the block, every mix of input dtypes."""
    la = _rglru_inputs(cuda, dtype, 0, B, S, W)[0]
    _, b, h0 = _rglru_inputs(cuda, b_dtype, 0, B, S, W)
    before = rglru_cuda.launches
    got = ops.rglru_scan(la, b, h0)
    want = rglru_plain(la, b, h0)
    torch.cuda.synchronize()
    assert rglru_cuda.launches == before + 1
    assert got[0].dtype == torch.float32 and got[0].shape == (B, S, W)
    assert got[1].shape == (B, W)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) < RGLRU_TOL * max(
            1.0, float(w.abs().max()))


@pytest.mark.gpu
def test_cuda_rglru_mixed_input_dtypes(cuda):
    la, _, h0 = _rglru_inputs(cuda, "float32", 1, 2, 40, 96)
    b = _rglru_inputs(cuda, "bfloat16", 2, 2, 40, 96)[1]
    got, want = rglru_cuda(la, b, h0), rglru_plain(la, b, h0)
    assert max(float((g - w).abs().max()) for g, w in zip(got, want)) \
        < RGLRU_TOL


@pytest.mark.gpu
def test_cuda_rglru_refuses_what_the_kernel_does_not_take(cuda):
    la, b, h0 = _rglru_inputs(cuda, "float32", 3, 1, 8, 64)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        rglru_cuda(la.half(), b, h0)
    with pytest.raises(ValueError, match="h0 must be float32"):
        rglru_cuda(la, b, h0.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        rglru_cuda(la.transpose(1, 2).contiguous().transpose(1, 2), b, h0)
    with pytest.raises(ValueError, match="S >= 1"):
        rglru_cuda(la[:, :0], b[:, :0], h0)
    with pytest.raises(ValueError, match=r"\(B, S, W\)"):
        rglru_cuda(la[0], b[0], h0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        rglru_cuda(la.cpu(), b.cpu(), h0.cpu())


@pytest.mark.gpu
def test_recurrentgemma_engine_kernel_matches_torch_path_and_counts(cuda):
    """The reduced recurrentgemma-9b on the card (window widened to 256,
    slots of 256): turn-1 prefill, an append and a decode chunk give the
    same greedy tokens through K4 as through the log-depth scan; K4 ran
    once per RG-LRU layer per prefill, and K1/K2 never (every attention
    layer is local)."""
    cfg = get_reduced("recurrentgemma-9b").scaled(window=256)
    params = build_model(cfg).init(0, cuda)

    def roll(impl):
        eng = ReplicaEngine(cfg, params, n_slots=2, max_ctx=256,
                            attention_impl=impl)
        s = eng.kv.acquire()
        t, _ = eng.prefill_conversation(s, np.arange(7, 120, dtype=np.int32))
        t2, _ = eng.append_prefill(s, np.arange(60, 75, dtype=np.int32))
        nt = np.zeros(2, np.int32)
        em = np.zeros(2, bool)
        nt[s], em[s] = int(t2), True
        seq, _ = eng.decode_steps(nt, em, 5)
        return [int(t), int(t2)] + [int(x) for x in seq[:, s]]

    ops.reset_launch_counts()
    want = roll("torch")
    assert ops.launch_counts()["rglru"] == 0
    assert roll("cuda") == want
    assert ops.launch_counts() == {"decode_attention": 0,
                                   "prefill_attention": 0,
                                   "append_attention": 0, "wkv6": 0,
                                   "rglru": 2 * 2}


# --------------------------------------------------------------------------- #
# the paper's baselines and the failure contract, served through K1 and K2
# --------------------------------------------------------------------------- #
GPU_ROLES = {"conserve": ("prefill", "decode", "decode"),
             "full_disagg": ("prefill", "decode", "decode"),
             "ampd": ("prefill", "decode", "decode"),
             "collocated": ("mixed", "mixed", "mixed")}


def _gpu_serve(device, system, server_cls=None, server_kw=None, cfg=None,
               **sched_kw):
    from repro_torch.core import make_scheduler
    from repro_torch.engine import EngineServer
    from repro_torch.traces import TraceConfig, generate_trace
    cfg = cfg or get_reduced("qwen3-0.6b")
    params = build_model(cfg).init(0, device)
    reps = [ReplicaEngine(cfg, params, n_slots=8, max_ctx=512, replica_id=i,
                          role=r, attention_impl="cuda")
            for i, r in enumerate(GPU_ROLES[system])]
    srv = (server_cls or EngineServer)(
        make_scheduler(system, **sched_kw), reps, record_tokens=True,
        strict_accounting=True, **(server_kw or {}))
    tc = TraceConfig(seed=5, first_input_median=60, first_input_sigma=0.3,
                     first_input_max=120, append_median=16,
                     append_sigma=0.4, append_max=40, output_median=6,
                     output_sigma=0.5, output_max=12, mean_turns=3.0,
                     max_turns=4, tool_mean_s=0.01)
    ops.reset_launch_counts()
    recs = srv.serve(generate_trace(6, 3.0, cfg=tc))
    counts = ops.launch_counts()
    assert len(recs) == 6
    if device.type == "cuda":
        assert counts["decode_attention"] > 0
        assert counts["prefill_attention"] > 0
    srv.check_accounting()
    for r in reps:
        assert not r.kv.active.any() and r.kv.active_kv_tokens == 0
    streams = {k: [int(t) for t in v] for k, v in srv.sampled_tokens.items()}
    return srv, recs, streams


@pytest.mark.gpu
@pytest.mark.parametrize("system", ["collocated", "full_disagg", "ampd"])
def test_baselines_serve_through_the_kernels(cuda, system):
    """Each baseline completes through K1 and K2 with its transfer counts
    (collocated none, full_disagg and AMPD at a wrong-prediction rate of
    0.5 remote turns, two transfers each), and in fp32 its streams equal
    ConServe's: where a turn is prefilled never changes what it computes."""
    base, base_recs, base_streams = _gpu_serve(cuda, "conserve")
    kw = {"wrong_prediction_rate": 0.5} if system == "ampd" else {}
    srv, recs, streams = _gpu_serve(cuda, system, **kw)
    remote = sum(r.n_remote_turns for r in recs)
    if system == "collocated":
        assert srv.n_transfers == 0 and remote == 0
    else:
        assert remote > 0
        assert srv.n_transfers == len(recs) + 2 * remote > base.n_transfers
    assert base.n_transfers == len(base_recs)
    assert streams == base_streams


@pytest.mark.gpu
def test_nemotron_full_width_reduced_depth_serves_through_the_kernels(cuda):
    """nemotron-4-15b at its published widths — 48 query heads over 8 KV
    heads of 128 (K1 at G = 6), d_ff 24,576 without a gate, a vocabulary of
    256,000 — cut to 2 layers, bf16, under ConServe with strict accounting:
    every conversation completes with one KV transfer, K1 launches a
    multiple of the layers, K2 once a layer for each turn-1 prefill."""
    from repro_torch.configs import get_config
    cfg = get_config("nemotron-4-15b").scaled(n_layers=2)
    srv, recs, streams = _gpu_serve(cuda, "conserve", cfg=cfg)
    counts = ops.launch_counts()
    assert srv.n_transfers == len(recs) == 6
    assert counts["decode_attention"] % cfg.n_layers == 0
    assert counts["prefill_attention"] == cfg.n_layers * len(recs)
    assert counts["wkv6"] == counts["rglru"] == 0
    assert all(len(v) > 0 for v in streams.values())


@pytest.mark.gpu
@pytest.mark.parametrize("rejoin", [False, True])
def test_fp32_failure_replay_is_byte_identical(cuda, rejoin):
    """Decoder 1 killed as it begins decoding a turn >= 1 (so the replay
    re-prefills completed turns in one prefill), and with `rejoin` brought
    back cold 0.05 logical s later: every stream equals the failure-free
    run's byte for byte. On the fixed step clock the card's recovery
    bookkeeping (the kill, each record's recoveries, transfers and
    recovery latencies, each replica's replayed prefill tokens and
    lifecycle) equals the same run's on the CPU, which
    tests/test_torch_fault_recovery.py holds against the JAX engine."""
    from repro_torch.chaos.triggers import FailWhen, FixedStepClock
    from repro_torch.core.signals import NODE_ACTIVE
    from repro_torch.engine import EngineServer

    class Killed(FailWhen, FixedStepClock, EngineServer):
        pass

    def bookkeeping(srv, recs):
        return dict(
            records={r.cid: (r.recovered, r.n_kv_transfers,
                             list(r.recovery_latency_s)) for r in recs},
            nodes={i: (s.alive, s.lifecycle, s.replayed_prefill_tokens)
                   for i, s in srv.states.items()},
            n_recoveries=srv.n_recoveries, killed=srv.killed,
            at_rejoin=srv.at_rejoin)

    kill = dict(victim_node=1, min_turn=1,
                rejoin_after_s=0.05 if rejoin else None)
    _, _, want = _gpu_serve(cuda, "conserve")
    srv, recs, got = _gpu_serve(cuda, "conserve", server_cls=Killed,
                                server_kw=kill)
    assert srv.killed is not None and srv.n_recoveries >= 1
    assert srv.records[srv.killed[0]].recovered
    assert got == want
    if rejoin:
        st = srv.states[1]
        assert st.alive and st.lifecycle == NODE_ACTIVE
        assert srv.at_rejoin["kv"] == srv.at_rejoin["slots"] == 0
    cpu = _gpu_serve(torch.device("cpu"), "conserve", server_cls=Killed,
                     server_kw=kill)
    assert bookkeeping(srv, recs) == bookkeeping(*cpu[:2])


# --------------------------------------------------------------------------- #
# the replica's compiled programs: one CUDA graph per bucket key
# --------------------------------------------------------------------------- #
GRAPH_ARCHS = {"qwen3-0.6b": {}, "rwkv6-3b": {},
               "recurrentgemma-9b": {"window": 256}, "stablelm-12b": {},
               "gemma3-12b": {"window": 256},
               # at the published cf 1.25: the MoE drops tokens in the graph
               "deepseek-v2-lite-16b": {"capacity_factor": 1.25},
               "llama4-scout-17b-a16e": {"capacity_factor": 1.25}}


def _caches(eng):
    from repro_torch.engine.kvcache import leaves
    return [t.clone() for _, t in leaves(eng.kv.caches)]


def _put(eng, saved, lengths):
    from repro_torch.engine.kvcache import leaves
    for (_, t), s in zip(leaves(eng.kv.caches), saved):
        t.copy_(s)
    eng.kv.lengths[:] = lengths


def _graph_engine(cuda, arch, **kw):
    cfg = get_reduced(arch).scaled(**GRAPH_ARCHS[arch])
    params = build_model(cfg).init(0, cuda)
    return ReplicaEngine(cfg, params, n_slots=4, max_ctx=256,
                         attention_impl="cuda", **kw)


def _script(eng):
    """Prefills, a ragged chunk, a slot joining between chunks, a second
    chunk, a kill (every slot invalidated, the cache kept) and a rejoin
    whose chunk lands in a bucket not captured before. Returns the tokens
    and the cache after each step."""
    out = []
    nt = np.zeros(4, np.int32)
    em = np.zeros(4, bool)
    for n in (37, 90):
        s = eng.kv.acquire()
        nt[s], em[s] = int(eng.prefill_conversation(
            s, np.arange(3 + n, 3 + 2 * n, dtype=np.int32))[0]), True
    rem = np.where(em, [7, 3, 0, 0], 0).astype(np.int32)
    seq, _ = eng.decode_steps(nt, em, rem)
    out.append((seq, _caches(eng)))
    nt[em] = seq[rem[em] - 1, np.flatnonzero(em)]
    s = eng.kv.acquire()  # joins between the two chunks
    t, _ = eng.prefill_conversation(s, np.arange(200, 230, dtype=np.int32))
    nt[s], em[s] = int(t), True
    t2, _ = eng.append_prefill(0, np.arange(60, 75, dtype=np.int32))
    nt[0] = int(t2)
    seq, _ = eng.decode_steps(nt, em, 4)
    out.append((seq, _caches(eng)))
    eng.kv.invalidate_all()  # the server's kill; the rejoin keeps the cache
    s = eng.kv.acquire()
    t, _ = eng.prefill_conversation(s, np.arange(9, 180, dtype=np.int32))
    nt[:], em[:] = 0, False
    nt[s], em[s] = int(t), True
    seq, _ = eng.decode_steps(nt, em, 2)
    out.append((seq, _caches(eng)))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("arch", list(GRAPH_ARCHS))
def test_graphs_equal_eager_tokens_and_caches(cuda, arch):
    """fp32, TF32 off: the same script through the CUDA graphs and through
    the same bodies run eagerly (`cuda_graphs=False`) gives the same tokens
    and byte-identical caches — a ragged chunk, a slot joining between
    chunks (the split-chunk contract), an append, and a bucket captured
    after a kill and rejoin."""
    graph = _script(_graph_engine(cuda, arch))
    eager = _script(_graph_engine(cuda, arch, cuda_graphs=False))
    for (sg, cg), (se, ce) in zip(graph, eager):
        np.testing.assert_array_equal(sg, se)
        assert all(torch.equal(a, b) for a, b in zip(cg, ce))


@pytest.mark.gpu
def test_cuda_prefill_kernel_graph_replay_equals_eager(cuda):
    q = _rand(cuda, "bfloat16", 8, (1, 200, 16, 128))
    k, v = (_rand(cuda, "bfloat16", i, (1, 200, 8, 128)) for i in (9, 10))
    _graph_replay_equals_eager((q, k, v),
                               lambda: (flash_prefill_attention(q, k, v),))


@pytest.mark.gpu
def test_program_launch_counts_per_replay(cuda):
    """A capture records what each port kernel's wrapper counted; each
    replay adds exactly that, and the build (warm-up pass and capture)
    counts nothing. qwen's bf16 decode graph of 8 steps holds 8 K1 launches
    a layer, its turn-1 graph one K2 launch a layer, its append graph one
    launch of K2's append instance a layer and no K2 launch."""
    cfg = get_reduced("qwen3-0.6b").scaled(dtype="bfloat16")
    eng = ReplicaEngine(cfg, build_model(cfg).init(0, cuda), n_slots=4,
                        max_ctx=256, attention_impl="cuda")
    L = eng.cfg.n_layers
    ops.reset_launch_counts()
    eng.warmup_decode(chunks=(8,), ctx_limits=(64,))
    eng.warmup_prefill(lengths=(64,), ctx_limits=(64,))
    assert sum(ops.launch_counts().values()) == 0
    assert eng._fused[(8, 64)].launches == {"decode_attention": 8 * L}
    assert eng._prefill[(64, 0)].launches == {"prefill_attention": L}
    assert eng._append[(64, 64)].launches == {"append_attention": L}
    s = eng.kv.acquire()
    t, _ = eng.prefill_conversation(s, np.arange(5, 50, dtype=np.int32))
    nt = np.zeros(4, np.int32)
    em = np.zeros(4, bool)
    nt[s], em[s] = int(t), True
    eng.decode_steps(nt, em, 5)  # bucket 8: the graph runs 8 steps
    eng.append_prefill(s, np.arange(70, 80, dtype=np.int32))
    assert ops.launch_counts() == {"decode_attention": 8 * L,
                                   "prefill_attention": L,
                                   "append_attention": L, "wkv6": 0,
                                   "rglru": 0}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", list(GRAPH_ARCHS))
def test_capture_leaves_the_cache_byte_identical(cuda, arch):
    """Building a program runs one warm-up pass before the capture (decode
    with every lane frozen; a prefill with its slot saved and restored):
    live slots keep every byte."""
    eng = _graph_engine(cuda, arch)
    for n in (37, 120):
        eng.prefill_conversation(eng.kv.acquire(),
                                 np.arange(n, 2 * n, dtype=np.int32))
    before = _caches(eng)
    eng.warmup_decode(chunks=(1, 8), ctx_limits=(64, 256))
    eng.warmup_prefill(lengths=(32, 128), ctx_limits=(64, 256))
    assert all(p.graph is not None for p in eng.programs().values())
    assert all(torch.equal(a, b) for a, b in zip(before, _caches(eng)))


@pytest.mark.gpu
def test_capture_runs_with_the_cycle_collector_off(cuda):
    """F12: a dead replica's programs wait in reference cycles, and the
    cycle collector destroying their graphs while a stream captures voids
    the capture (seen on the card: "operation not permitted when stream
    is capturing (function reset)"). The collector is off during every
    capture and on again after it; the warm-up pass runs with it on."""
    import gc
    eng = _graph_engine(cuda, "qwen3-0.6b")
    seen = []
    step = eng.model.decode_step

    def spy(*a, **kw):
        seen.append((torch.cuda.is_current_stream_capturing(),
                     gc.isenabled()))
        return step(*a, **kw)

    eng.model.decode_step = spy
    eng.warmup_decode(chunks=(1, 8), ctx_limits=(64,))
    assert (False, True) in seen and (True, False) in seen
    assert not any(capturing and on for capturing, on in seen)
    assert gc.isenabled()
    assert all(p.graph is not None for p in eng.programs().values())


@pytest.mark.gpu
def test_replay_refuses_a_moved_tensor(cuda):
    """A graph replays fixed addresses: a cache leaf or a weight that moved
    since the capture raises, naming it, before anything runs."""
    eng = _graph_engine(cuda, "qwen3-0.6b")
    s = eng.kv.acquire()
    t, _ = eng.prefill_conversation(s, np.arange(5, 40, dtype=np.int32))
    nt = np.zeros(4, np.int32)
    em = np.zeros(4, bool)
    nt[s], em[s] = int(t), True
    eng.decode_steps(nt, em, 2)
    leaf = eng.kv.caches["groups"]["p0"]
    leaf["k"] = leaf["k"].clone()
    with pytest.raises(RuntimeError, match=r"cache groups/p0/k moved"):
        eng.decode_steps(nt, em, 2)
    eng2 = _graph_engine(cuda, "qwen3-0.6b")
    s = eng2.kv.acquire()
    eng2.prefill_conversation(s, np.arange(5, 40, dtype=np.int32))
    w = eng2.params.blocks[0].mlp.wi
    w.data = w.data.clone()
    with pytest.raises(RuntimeError, match=r"weight blocks.0.mlp.wi moved"):
        eng2.prefill_conversation(eng2.kv.acquire(),
                                  np.arange(5, 40, dtype=np.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("impl,dtype", [
    pytest.param("cuda", "float32", id="cuda"),
    pytest.param("torch", "float32", id="torch"),
    pytest.param("cuda", "bfloat16", id="cuda-bfloat16")])
def test_fast_and_reference_prefill_caches_byte_identical(cuda, impl, dtype):
    """tests/test_torch_engine.py's CPU case on the card: a turn-1 prefill
    and two appends (the prefix crossing a ctx bucket) through the graphed
    programs and through `prefill_mode="reference"` give the same tokens
    and byte-identical caches (fp32 with TF32 off; and bf16 under "cuda",
    whose appends run K2's append instance on the gathered ctx bucket in
    the graphs and on the slot's whole buffer in the reference path)."""
    cfg = get_reduced("qwen3-0.6b").scaled(dtype=dtype)
    params = build_model(cfg).init(0, cuda)
    out, caches = {}, {}
    for mode in ("jit", "reference"):
        ops.reset_launch_counts()
        eng = ReplicaEngine(cfg, params, n_slots=2, max_ctx=256,
                            prefill_mode=mode, attention_impl=impl)
        slot = eng.kv.acquire()
        t1, _ = eng.prefill_conversation(slot, np.arange(5, 50,
                                                         dtype=np.int32))
        t2, _ = eng.append_prefill(slot, np.arange(100, 131, dtype=np.int32))
        t3, _ = eng.append_prefill(slot, np.arange(200, 215, dtype=np.int32))
        out[mode] = (int(t1), int(t2), int(t3))
        caches[mode] = _caches(eng)
        if dtype == "bfloat16":  # each append, one launch a layer
            assert ops.launch_counts()["append_attention"] == 2 * cfg.n_layers
    assert out["jit"] == out["reference"]
    diffs = [[float((x - y).abs().max()) for x, y in zip(a, b)]
             for a, b in zip(caches["jit"], caches["reference"])]
    assert all(torch.equal(a, b) for a, b in zip(caches["jit"],
                                                 caches["reference"])), diffs


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",
                                  "llama4-scout-17b-a16e"])
def test_moe_body_in_a_cuda_graph_equals_eager(cuda, dtype, arch):
    """The MoE of a decode step (16 slots, one token each) at the published
    cf 1.25, where capacity drops tokens: captured in a CUDA graph and
    replayed on new inputs, it gives the eager call's bytes."""
    from repro_torch.models.layers import init_params
    from repro_torch.models.moe import MoE, apply_moe, route
    cfg = get_reduced(arch).scaled(capacity_factor=1.25, n_experts=8,
                                   dtype=dtype)
    moe = init_params(MoE(cfg, cuda), 0)
    x = _rand(cuda, dtype, 11, (16, 1, cfg.d_model))
    assert not bool(route(moe, cfg, x.reshape(1, 16, -1))[3].all())
    static = x.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        apply_moe(moe, cfg, static)  # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = apply_moe(moe, cfg, static)
    for seed in (12, 13):
        x = _rand(cuda, dtype, seed, (16, 1, cfg.d_model))
        static.copy_(x)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, apply_moe(moe, cfg, x))


def _frames(dev, cfg, seed):
    """Seeded stub frontend embeddings (1, F, d_model): an encoder-decoder's
    encoder_seq frames, a vision model's frontend_len patches."""
    n = cfg.encoder_seq if cfg.is_encoder_decoder else cfg.frontend_len
    return _rand(dev, cfg.dtype, seed, (1, n, cfg.d_model))


@pytest.mark.gpu
def test_encdec_decode_chunk_graph_equals_eager(cuda):
    """Reduced whisper-small in fp32 (TF32 off; frontend_len set to its
    encoder_seq, F16): two slots prefilled (eagerly, as every
    encoder-decoder prefill), then a ragged decode chunk, an append and a
    second chunk through the CUDA graphs and through the same bodies run
    eagerly: tokens and caches, cross rows included, byte-identical."""
    cfg = get_reduced("whisper-small")
    cfg = cfg.scaled(frontend_len=cfg.encoder_seq)
    params = build_model(cfg).init(0, cuda)
    out = []
    for graphs in (True, False):
        eng = ReplicaEngine(cfg, params, n_slots=4, max_ctx=256,
                            attention_impl="cuda", cuda_graphs=graphs)
        nt, em = np.zeros(4, np.int32), np.zeros(4, bool)
        for i, n in enumerate((37, 90)):
            s = eng.kv.acquire()
            nt[s], em[s] = int(eng.prefill_conversation(
                s, np.arange(3 + n, 3 + 2 * n, dtype=np.int32),
                _frames(cuda, cfg, i))[0]), True
        rem = np.where(em, [7, 3, 0, 0], 0).astype(np.int32)
        seq1, _ = eng.decode_steps(nt, em, rem)
        nt[0] = int(eng.append_prefill(0, np.arange(60, 75,
                                                    dtype=np.int32))[0])
        seq2, _ = eng.decode_steps(nt, em, 4)
        out.append((seq1, seq2, _caches(eng), eng.programs()))
    (g1, g2, gc, gp), (e1, e2, ec, _) = out
    assert any(k[0] == "decode" and p.graph is not None
               for k, p in gp.items())
    assert not any(k[0] != "decode" for k in gp)  # prefills stay eager
    np.testing.assert_array_equal(g1, e1)
    np.testing.assert_array_equal(g2, e2)
    assert all(torch.equal(a, b) for a, b in zip(gc, ec))


@pytest.mark.gpu
def test_vlm_prefill_with_patches_graph_equals_eager(cuda):
    """Reduced internvl2-26b in fp32 (TF32 off): turn-1 prefills with
    their patch embeddings through the (pad_to, n_front) program's graph —
    the patches copied into its static input — and through the same body
    run eagerly, then an append and a decode chunk: tokens and caches
    byte-identical, and the slot holds n_front + true_len."""
    cfg = get_reduced("internvl2-26b")
    params = build_model(cfg).init(0, cuda)
    out = []
    for graphs in (True, False):
        eng = ReplicaEngine(cfg, params, n_slots=4, max_ctx=256,
                            attention_impl="cuda", cuda_graphs=graphs)
        nt, em = np.zeros(4, np.int32), np.zeros(4, bool)
        for i, n in enumerate((37, 20)):  # both in the 64 bucket
            s = eng.kv.acquire()
            nt[s], em[s] = int(eng.prefill_conversation(
                s, np.arange(3 + n, 3 + 2 * n, dtype=np.int32),
                _frames(cuda, cfg, i))[0]), True
            assert int(eng.kv.lengths[s]) == cfg.frontend_len + n
        nt[0] = int(eng.append_prefill(0, np.arange(60, 75,
                                                    dtype=np.int32))[0])
        seq, _ = eng.decode_steps(nt, em, 4)
        out.append((nt.copy(), seq, _caches(eng), eng.programs()))
    (gt, gs, gc, gp), (et, es, ec, _) = out
    assert gp[("prefill", 64, cfg.frontend_len)].graph is not None
    np.testing.assert_array_equal(gt, et)
    np.testing.assert_array_equal(gs, es)
    assert all(torch.equal(a, b) for a, b in zip(gc, ec))


@pytest.mark.gpu
def test_kernel_launch_with_grad_raises(cuda):
    """No kernel has a backward: each wrapper in `ops` refuses a launch
    whose input requires grad while grad mode is on (its output would cut
    the gradient), before launching and counting; under no_grad the same
    call launches, and the reduced model's training step launches none."""
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step
    q = torch.zeros(1, 64, 4, 16, device=cuda, requires_grad=True)
    ops.reset_launch_counts()
    with pytest.raises(RuntimeError, match="prefill_attention.*backward"):
        ops.prefill_attention(q, q.detach(), q.detach(), impl="cuda")
    lens = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="decode_attention"):
        ops.decode_attention(q[:, 0], q.detach(), q.detach(), lens,
                             impl="cuda")
    assert not any(ops.launch_counts().values())
    with torch.no_grad():
        ops.prefill_attention(q, q, q, impl="cuda")
    assert ops.launch_counts()["prefill_attention"] == 1
    cfg = get_reduced("olmo-1b")
    model = build_model(cfg)
    params = model.init(0, cuda)
    toks = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 64))
    ops.reset_launch_counts()
    _, _, m = make_train_step(model, AdamWConfig())(
        params, adamw_init(params), {"tokens": toks, "labels": toks})
    assert np.isfinite(float(m["loss"]))
    assert not any(ops.launch_counts().values())


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["decode_32k", "train_4k"])
def test_rank0_of_a_reduced_cell_on_the_card(cuda, shape, monkeypatch):
    """The dry run's card path (`launch.dryrun.run_on_card`): rank 0 of the
    16x16 mesh under torch's fake process group, on reduced qwen3-0.6b with
    the shapes cut, runs on CUDA tensors. Its argument bytes equal the meta
    estimate's exactly; its measured peak holds at least the arguments and
    is printed beside arguments + temp; its output is finite."""
    import torch.distributed as dist
    from repro_torch.configs import ShapeSpec, shapes
    from repro_torch.launch.dryrun import measure, run_on_card
    from repro_torch.launch.mesh import make_production_mesh, world
    from repro_torch.launch.specs import build_cell
    monkeypatch.setitem(shapes.SHAPES, "decode_32k",
                        ShapeSpec("decode_32k", 512, 32, "decode"))
    monkeypatch.setitem(shapes.SHAPES, "train_4k",
                        ShapeSpec("train_4k", 128, 32, "train"))
    cfg = get_reduced("qwen3-0.6b").scaled(dtype="bfloat16")
    with world(256):
        _, est = measure(*build_cell("qwen3-0.6b", shape,
                                     make_production_mesh(device="meta"),
                                     cfg=cfg))
        out, dev = run_on_card("qwen3-0.6b", shape, False, cfg)
        mem = est["memory"]
        assert dev["argument_bytes"] == mem["argument_bytes"]
        assert dev["measured_peak_bytes"] >= mem["argument_bytes"]
        print(f"{shape}: measured peak {dev['measured_peak_bytes']} B, "
              f"estimate {mem['argument_bytes'] + mem['temp_bytes']} B")
        res = out[0] if shape == "decode_32k" else out[2]["loss"]
        assert torch.isfinite(res.to_local().float()).all()
        del out, res
    assert not dist.is_initialized()


# --------------------------------------------------------------------------- #
# the prefix pool's hit through the append program's graph
# --------------------------------------------------------------------------- #
POOL_ARCHS = {"qwen3-0.6b": {}, "gemma3-12b": {"window": 256},
              "deepseek-v2-lite-16b": {}, "rwkv6-3b": {}}
POOL_PRE = 69  # preamble tokens: ctx bucket 128


def _pool_fleet(vocab, deltas=(10, 23, 31)):
    """One shared preamble and a delta each."""
    rng = np.random.RandomState(7)
    pre = rng.randint(0, vocab, size=POOL_PRE).astype(np.int32)
    return [np.concatenate([pre, rng.randint(0, vocab, size=n)
                            .astype(np.int32)]) for n in deltas]


def _pool_run(cuda, arch, dtype, pool, **kw):
    """Three conversations sharing one preamble, each kept in its slot.
    Returns the tokens, each slot's live rows (growing leaves to the slot's
    length, fixed states whole) and the replica."""
    from repro_torch.engine.kvcache import growing, leaves
    cfg = get_reduced(arch).scaled(dtype=dtype, **POOL_ARCHS[arch])
    eng = ReplicaEngine(cfg, build_model(cfg).init(0, cuda), n_slots=4,
                        max_ctx=256, attention_impl="cuda",
                        prefix_pool_tokens=pool, **kw)
    toks = [int(eng.prefill_conversation(eng.kv.acquire(), c,
                                         prefix_len=POOL_PRE)[0])
            for c in _pool_fleet(cfg.vocab_size)]
    rows = []
    for s in range(3):
        n = int(eng.kv.lengths[s])
        rows += [t[:, :, :n].clone() if growing(p) else t.clone()
                 for p, t in leaves(eng.kv.export_slot_full(s))]
    return toks, rows, eng


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", list(POOL_ARCHS))
def test_pool_hit_graph_equals_miss(cuda, arch, dtype):
    """A hit folds the pooled rows and replays the append graph its miss
    replays (rwkv6: both eager): three conversations sharing a preamble
    give the same tokens graphed with the pool (one miss, two hits), eager
    with the pool and graphed without it; in fp32 every live row — K/V,
    MLA's latent rows, RWKV6's states — is byte-identical."""
    miss = _pool_run(cuda, arch, dtype, 0)
    graph = _pool_run(cuda, arch, dtype, 4 * POOL_PRE)
    eager = _pool_run(cuda, arch, dtype, 4 * POOL_PRE, cuda_graphs=False)
    assert graph[2].prefix_pool.total_hits == 2
    assert eager[2].prefix_pool.total_hits == 2
    assert graph[0] == eager[0] == miss[0]
    if dtype == "float32":
        for a, b, c in zip(miss[1], graph[1], eager[1]):
            assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.gpu
def test_pool_hit_replays_the_append_graph(cuda, monkeypatch):
    """qwen3-0.6b: the miss replays the turn-1 graph (one K2 launch a
    layer) and then the append graph; the hit replays that same append
    graph and nothing else — its launches exactly, no K2 — and builds
    nothing."""
    from repro_torch.engine.programs import Program
    cfg = get_reduced("qwen3-0.6b")
    eng = ReplicaEngine(cfg, build_model(cfg).init(0, cuda), n_slots=4,
                        max_ctx=256, attention_impl="cuda",
                        prefix_pool_tokens=4 * POOL_PRE)
    replayed = []
    replay = Program.replay

    def spy(prog, bound):
        replayed.append(prog)
        return replay(prog, bound)
    monkeypatch.setattr(Program, "replay", spy)
    miss, hit = _pool_fleet(cfg.vocab_size, (10, 10))
    ops.reset_launch_counts()
    eng.prefill_conversation(eng.kv.acquire(), miss, prefix_len=POOL_PRE)
    assert [p.key for p in replayed] == [("prefill", 128, 0),
                                         ("append", 32, 128)]
    assert ops.launch_counts()["prefill_attention"] == cfg.n_layers
    append = replayed[-1]
    replayed.clear()
    ops.reset_launch_counts()
    compile_s = eng.compile_s
    eng.prefill_conversation(eng.kv.acquire(), hit, prefix_len=POOL_PRE)
    assert eng.prefix_pool.total_hits == 1
    assert replayed == [append] and append.launches == {}
    assert not any(ops.launch_counts().values())
    assert eng.compile_s == compile_s
