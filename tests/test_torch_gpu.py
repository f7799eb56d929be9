"""The port's CUDA kernels and its engine on a card. Every test here is
marked `gpu` and skips on a machine without one; on a card run

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

(`--noconftest`: the repository's conftest imports JAX, which a card-only
machine need not have; nothing here imports JAX or the JAX package). The
kernels are held against their plain versions (float32 with TF32 off: 2e-5;
bfloat16: 2e-2), each launch is counted, and the reduced model served
through the kernels gives the same greedy tokens as the torch path."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.engine import ReplicaEngine  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_plain, flash_decode_attention)
from repro_torch.kernels.prefill_attention import (  # noqa: E402
    flash_prefill_attention, prefill_attention_plain)
from repro_torch.models import build_model  # noqa: E402

TOLS = {"float32": 2e-5, "bfloat16": 2e-2}


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
                                     (16, 1, 32)])
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
@pytest.mark.parametrize("S,H,Hkv,D,window", [(64, 4, 4, 16, 0),
                                              (200, 16, 8, 128, 0),
                                              (256, 4, 2, 64, 96),
                                              (33, 2, 1, 32, 0)])
def test_cuda_prefill_kernel_matches_plain(cuda, dtype, S, H, Hkv, D, window):
    q = _rand(cuda, dtype, 0, (2, S, H, D))
    k, v = (_rand(cuda, dtype, i, (2, S, Hkv, D)) for i in (1, 2))
    before = flash_prefill_attention.launches
    got = ops.prefill_attention(q, k, v, window=window)
    want = prefill_attention_plain(q, k, v, window=window)
    torch.cuda.synchronize()
    assert flash_prefill_attention.launches == before + 1
    assert float((got.float() - want.float()).abs().max()) < TOLS[dtype]


@pytest.mark.gpu
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 4, 48, device=cuda)  # head_dim 48
    k = torch.zeros(1, 8, 4, 48, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_decode_attention(q, k, k, torch.ones(1, dtype=torch.int32,
                                                   device=cuda))
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
                                   "prefill_attention": 0}
    assert roll("cuda") == want
    counts = ops.launch_counts()
    assert counts["decode_attention"] == 5 * cfg.n_layers
    assert counts["prefill_attention"] == 2 * cfg.n_layers
