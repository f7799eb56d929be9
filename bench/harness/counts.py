"""Operations and bytes that the served work needs, counted from shapes,
and the table of peaks they are held against.

The rule (as the kernel table of PERF.md has it): each input byte read
once and each output byte written once, whatever a kernel reads again;
each slot's live length, never its bucket; a causal prefill counts the
key-query pairs at or below the diagonal. A roofline bound is the larger
of operations over the peak rate and bytes over the peak bandwidth.

`m` is a configuration's "model" block (the port's field names).
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

# Published dense peaks of one card (NVIDIA's data sheet, SXM part, at its
# 700 W limit): bf16 tensor-core FLOP/s, float32 FLOP/s outside the tensor
# cores, and HBM bandwidth in bytes/s.
PEAKS = {"NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12,
                                   "fp32_flops": 67e12,
                                   "hbm_bytes_s": 3.35e12}}

DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4, "int8": 1}


def peaks(kind: str) -> Dict[str, float]:
    if kind not in PEAKS:
        raise KeyError(f"no peaks for device {kind!r}: add its data sheet's "
                       f"numbers to PEAKS")
    return PEAKS[kind]


def layer_matmul_params(m: Dict) -> int:
    """Weights a token multiplies in one dense layer: q, k, v, o and the
    MLP (two matrices, three when gated)."""
    d, h, hkv, hd, f = (m["d_model"], m["n_heads"], m["n_kv_heads"],
                        m["head_dim"], m["d_ff"])
    attn = d * h * hd + 2 * d * hkv * hd + h * hd * d
    mlp = (3 if m.get("gated_mlp", True) else 2) * d * f
    return attn + mlp


def weight_bytes(m: Dict) -> int:
    """Bytes of the weights a decode step reads: every layer's matrices and
    norms, the final norm and the output head (the tied table once)."""
    b = DTYPE_BYTES[m["dtype"]]
    d, L = m["d_model"], m["n_layers"]
    per_layer = layer_matmul_params(m) + 2 * d
    if m.get("qk_norm"):
        per_layer += 2 * m["head_dim"]
    return b * (L * per_layer + d + d * m["vocab_size"])


def kv_bytes_per_token(m: Dict) -> int:
    kv = m.get("kv_cache_dtype") or m["dtype"]
    return (2 * m["n_layers"] * m["n_kv_heads"] * m["head_dim"]
            * DTYPE_BYTES[kv])


# ----- K2: causal prefill attention, one layer --------------------------------
def k2_flops(m: Dict, s: int) -> float:
    """QK^T and PV over the s(s+1)/2 causal pairs, every head."""
    return 2.0 * m["n_heads"] * m["head_dim"] * s * (s + 1)


def k2_bytes(m: Dict, s: int) -> float:
    """q, k, v read and o written once, in the model's dtype."""
    b = DTYPE_BYTES[m["dtype"]]
    return float(b * s * m["head_dim"]
                 * (2 * m["n_heads"] + 2 * m["n_kv_heads"]))


# ----- K1: decode attention, one layer, one step ------------------------------
def k1_flops(m: Dict, live: Iterable[int]) -> float:
    """Each live slot's query against its n live keys (the new one
    included): QK^T and PV, every head."""
    return sum(4.0 * m["n_heads"] * m["head_dim"] * n for n in live)


def k1_bytes(m: Dict, live: Iterable[int]) -> float:
    """Each live slot's n K and V rows at the cache's dtype, its query read
    and its output written in the model's dtype."""
    kv = DTYPE_BYTES[m.get("kv_cache_dtype") or m["dtype"]]
    b = DTYPE_BYTES[m["dtype"]]
    hd, h, hkv = m["head_dim"], m["n_heads"], m["n_kv_heads"]
    return float(sum(2 * n * hkv * hd * kv + 2 * h * hd * b for n in live))


def live_steps(lengths, emit, rem):
    """The live lengths of each step of a ragged decode chunk: slot i,
    emitting, runs rem[i] steps from its length; at step s it attends
    lengths[i] + s + 1 keys."""
    n = int(max(rem[i] for i in range(len(emit)) if emit[i])) \
        if any(emit) else 0
    for s in range(n):
        yield [int(lengths[i]) + s + 1 for i in range(len(emit))
               if emit[i] and s < rem[i]]


# ----- whole model -------------------------------------------------------------
def prefill_flops(m: Dict, s: int) -> float:
    """A fresh prefill of s tokens: the layers' matrices for every token,
    causal attention in every layer, the output head at the last
    position."""
    return (2.0 * s * m["n_layers"] * layer_matmul_params(m)
            + m["n_layers"] * k2_flops(m, s)
            + 2.0 * m["d_model"] * m["vocab_size"])


def decode_step_counts(m: Dict, live: Iterable[int]) -> Tuple[float, float]:
    """(FLOPs, bytes) of one decode step over the live slots, each with n
    live keys after its new token: the matrices and the output head per
    slot, attention in every layer; the weights read once, each slot's K/V
    rows read and its new row written."""
    live = list(live)
    L = m["n_layers"]
    flops = (len(live) * (2.0 * L * layer_matmul_params(m)
                          + 2.0 * m["d_model"] * m["vocab_size"])
             + L * k1_flops(m, live))
    nbytes = (weight_bytes(m) + L * k1_bytes(m, live)
              + len(live) * kv_bytes_per_token(m))
    return flops, float(nbytes)


def bound_s(flops: float, nbytes: float, pk: Dict[str, float],
            flops_key: str = "bf16_flops") -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / pk[flops_key], nbytes / pk["hbm_bytes_s"])
