"""The plain references against the port's model on the CPU, at reduced
sizes of both configurations' blocks: a prefill, then decode steps through
the cache, against the reference's one forward over the whole sequence.
Both read the same weights (the benchmark's, handed to the program without
a copy), in float32."""
import copy

import pytest
import torch

from bench.harness import system, weights
from bench.reference import dense
from bench.tests.tiny import TINY_MODEL

torch.set_num_threads(1)

QWEN_LIKE = dict(TINY_MODEL, name="qwen-like", rope_theta=1_000_000.0,
                 tie_embeddings=True)
NEMOTRON_LIKE = dict(TINY_MODEL, name="nemotron-like", n_heads=6,
                     n_kv_heads=1, activation="squared_relu",
                     gated_mlp=False, norm="layernorm", qk_norm=False,
                     tie_embeddings=False)


def _served_logits(m, w, tokens, n_prefill):
    """The port's logits: a prefill of the first n_prefill tokens, then one
    decode step per remaining token, each reading the cache."""
    from repro_torch.models import build_model
    from repro_torch.models.model import merge_decode_cache
    cfg = system.model_config(m)
    lm = system.hand_over(cfg, w)
    model = build_model(cfg)
    logits, caches = model.prefill(lm, tokens[None, :n_prefill])
    out = [logits[0]]
    for t in range(n_prefill, len(tokens) - 1):
        lg, up = model.decode_step(lm, tokens[t:t + 1], caches, t)
        caches = merge_decode_cache(caches, up)
        out.append(lg[0])
    return torch.stack(out)[:, : m["vocab_size"]].float()


@pytest.mark.parametrize("m", [QWEN_LIKE, NEMOTRON_LIKE],
                         ids=lambda m: m["name"])
def test_reference_matches_prefill_then_decode(m):
    w = weights.make(m, 20260001, "cpu")
    tokens = torch.randint(0, m["vocab_size"], (40,),
                           generator=torch.Generator().manual_seed(3))
    served = _served_logits(m, w, tokens, 24)
    ref = dense.logits_at(w, m, tokens, range(23, 39), "cpu", block=7)
    # float32 on both sides; the orders of the sums differ (blocks, online
    # softmax), which moves logits of unit scale by ~1e-6
    assert ref.shape == served.shape
    assert torch.allclose(served, ref, atol=2e-4, rtol=0), (
        (served - ref).abs().max())


def test_reference_sees_a_changed_weight():
    """The comparison is not blind: one changed norm scale moves it."""
    m = QWEN_LIKE
    w = weights.make(m, 7, "cpu")
    tokens = torch.arange(30) % m["vocab_size"]
    served = _served_logits(m, w, tokens, 20)
    w2 = copy.copy(w)
    w2["blocks.1.ln2.scale"] = w["blocks.1.ln2.scale"] + 0.5
    ref = dense.logits_at(w2, m, tokens, range(19, 29), "cpu")
    assert (served - ref).abs().max() > 1e-2


def test_row_blocks_do_not_change_logits():
    m = NEMOTRON_LIKE
    w = weights.make(m, 11, "cpu")
    tokens = torch.arange(45) % m["vocab_size"]
    a = dense.logits_at(w, m, tokens, range(45), "cpu")
    b = dense.logits_at(w, m, tokens, range(45), "cpu", block=4, rows=7)
    assert torch.allclose(a, b, atol=1e-5)


def test_block_size_does_not_change_attention():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(37, 6, 16, generator=g)
    k = torch.randn(37, 2, 16, generator=g)
    v = torch.randn(37, 2, 16, generator=g)
    a = dense.attention(q, k, v, 5)
    b = dense.attention(q, k, v, 64)
    # the plain formula, head by head
    kk = k.repeat_interleave(3, dim=1)
    vv = v.repeat_interleave(3, dim=1)
    s = torch.einsum("qhd,khd->hqk", q, kk) / 4.0
    s = s.masked_fill(torch.ones(37, 37).triu(1).bool(), float("-inf"))
    c = torch.einsum("hqk,khd->qhd", s.softmax(-1), vv)
    assert torch.allclose(a, b, atol=1e-6) and torch.allclose(a, c, atol=1e-5)


def test_weights_are_views_of_one_seeded_buffer():
    m = NEMOTRON_LIKE
    w1 = weights.make(m, 99, "cpu")
    w2 = weights.make(m, 99, "cpu")
    w3 = weights.make(m, 100, "cpu")
    assert all(torch.equal(w1[n], w2[n]) for n in w1)
    assert not torch.equal(w1["blocks.0.attn.wq"], w3["blocks.0.attn.wq"])
    ptr = w1["embed.w"].untyped_storage().data_ptr()
    assert all(t.untyped_storage().data_ptr() == ptr for t in w1.values())
    assert torch.allclose(w1["final_norm.scale"].mean(), torch.tensor(1.0),
                          atol=0.1)   # layernorm scales sit near 1
