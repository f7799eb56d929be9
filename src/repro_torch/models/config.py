"""Model configuration for every architecture family the framework serves.

A single frozen dataclass describes dense transformers, GQA/MLA attention,
MoE, SSM (RWKV6), hybrid (RG-LRU + local attention), encoder-decoder, and
stub-frontend (audio/vlm) models. `repro_torch/configs/<arch>.py`
instantiates one per ported architecture. Shape data only: the one tensor
library it touches is torch, for the dtype and its itemsize.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

# Layer kinds used in `block_pattern`.
ATTN_GLOBAL = "attn_global"
ATTN_LOCAL = "attn_local"
ATTN_MLA = "attn_mla"
RGLRU = "rglru"
RWKV6 = "rwkv6"

FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # one of FAMILIES
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0  # 0 -> d_model // n_heads
    activation: str = "silu"  # silu | gelu | squared_relu
    norm: str = "rmsnorm"  # rmsnorm | layernorm | nonparametric_ln
    gated_mlp: bool = True  # SwiGLU-style gate

    # Attention layout. `block_pattern` is a repeating per-layer pattern; the
    # model tiles it across n_layers (remainder layers take pattern[:rem]).
    block_pattern: Tuple[str, ...] = (ATTN_GLOBAL,)
    window: int = 0  # local-attention window (tokens)
    rope_theta: float = 10_000.0
    rope_theta_local: float = 10_000.0  # theta for sliding-window layers
    qk_norm: bool = False

    # MoE (0 experts -> dense MLP everywhere).
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_expert: int = 0  # per-expert hidden dim; 0 -> d_ff
    capacity_factor: float = 1.25
    moe_every: int = 1  # MoE layer every k-th layer (1 = all layers)

    # MLA (DeepSeek-style) — active when kv_lora_rank > 0.
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # Recurrent families.
    rwkv_head_size: int = 64
    lru_width: int = 0  # 0 -> d_model
    conv1d_width: int = 4  # RG-LRU temporal conv width

    # Encoder-decoder (whisper).
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 1500  # whisper 30s @ 50Hz after conv stub

    # Stub frontend: "none" | "audio" | "vision". Frontend embeddings are
    # provided precomputed via input_specs (the stub), shape (B, F, d_model).
    frontend: str = "none"
    frontend_len: int = 0

    max_seq: int = 131_072
    dtype: str = "bfloat16"
    tie_embeddings: bool = False

    # ----- performance variants (§Perf hillclimbs; defaults = paper-faithful
    # baseline) -----------------------------------------------------------
    # custom-VJP flash attention: backward recomputes attention instead of
    # letting scan save per-chunk online-softmax carriers (train memory).
    flash_vjp: bool = False
    # quantized KV cache for the decode tail ("" = same as dtype).
    kv_cache_dtype: str = ""
    kv_quant_scale: float = 0.05
    # pad RWKV heads so the head axis TP-shards without resharding
    # collectives (e.g. 40 heads -> 48 under 16-way TP).
    rwkv_pad_heads_to: int = 0
    # measurement-mode flags (depth probes): Python-unroll the layer scan and
    # run attention as one full block so XLA cost analysis counts every FLOP
    # (its loop bodies are otherwise counted once; see benchmarks/roofline.py)
    unroll_layers: bool = False
    attn_block_full: bool = False
    # remat granularity for training: "group" (paper-faithful baseline,
    # checkpoints at layer-scan boundaries) or "layer" (checkpoint every
    # block — backward holds one layer's activations, not a whole group's).
    remat_granularity: str = "group"

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))
        if self.d_expert == 0 and self.n_experts:
            object.__setattr__(self, "d_expert", self.d_ff)
        if self.lru_width == 0:
            object.__setattr__(self, "lru_width", self.d_model)

    # ----- derived properties -------------------------------------------------
    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def padded_vocab(self) -> int:
        """Embedding-table vocab padded to a multiple of 256 so the vocab dim
        shards evenly under 16-way TP (and stays MXU-aligned). Logits beyond
        vocab_size are padding; the engine masks them at sampling."""
        return -(-self.vocab_size // 256) * 256

    @property
    def attention_free(self) -> bool:
        return all(k in (RWKV6, RGLRU) for k in self.block_pattern)

    @property
    def uses_mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def sub_quadratic(self) -> bool:
        """True when decode-side state does not grow linearly *unboundedly*
        with context for the majority of layers (SSM / hybrid / mostly-local
        attention). Governs long_500k eligibility."""
        kinds = self.layer_kinds()
        n_full = sum(1 for k in kinds if k in (ATTN_GLOBAL, ATTN_MLA))
        return n_full == 0 or (self.window > 0 and n_full <= len(kinds) // 4)

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer kind sequence, tiling block_pattern across n_layers."""
        pat = self.block_pattern
        reps = -(-self.n_layers // len(pat))
        return tuple((pat * reps)[: self.n_layers])

    def pattern_groups(self) -> Tuple[Tuple[str, ...], int, Tuple[str, ...]]:
        """(pattern, n_full_groups, remainder_kinds) for grouped layer scan."""
        pat = self.block_pattern
        n_groups = self.n_layers // len(pat)
        rem = tuple(pat[: self.n_layers - n_groups * len(pat)])
        return pat, n_groups, rem

    # ----- KV/state bookkeeping ------------------------------------------------
    def kv_bytes_per_token(self) -> int:
        """Bytes of decoder-side cache state appended per token (all layers).
        Used by the serving engine's occupancy signal and provisioning."""
        itemsize = self.torch_dtype.itemsize
        total = 0
        for kind in self.layer_kinds():
            if kind == ATTN_GLOBAL:
                total += 2 * self.n_kv_heads * self.head_dim * itemsize
            elif kind == ATTN_LOCAL:
                # Windowed cache amortizes to 0 growth once full; count 0 here
                # (bounded state accounted in state_bytes_fixed).
                total += 0
            elif kind == ATTN_MLA:
                total += (self.kv_lora_rank + self.qk_rope_dim) * itemsize
            # rwkv6 / rglru carry O(1) state -> 0 growth
        return total

    def state_bytes_fixed(self) -> int:
        """Per-conversation state that does NOT grow with context."""
        itemsize = self.torch_dtype.itemsize
        total = 0
        for kind in self.layer_kinds():
            if kind == ATTN_LOCAL:
                total += 2 * self.window * self.n_kv_heads * self.head_dim * itemsize
            elif kind == RWKV6:
                n_heads = self.d_model // self.rwkv_head_size
                total += n_heads * self.rwkv_head_size ** 2 * 4  # fp32 state
                total += 2 * self.d_model * itemsize  # token-shift
            elif kind == RGLRU:
                total += self.lru_width * 4
                total += self.conv1d_width * self.lru_width * itemsize
        return total

    def param_count(self) -> int:
        """Analytical parameter count (matches init_params within ties)."""
        d, hd = self.d_model, self.head_dim
        n = 0
        n += self.vocab_size * d  # embed
        if not self.tie_embeddings:
            n += d * self.vocab_size
        for kind in self.layer_kinds():
            n += 2 * d  # two norms (rmsnorm scales); nonparam LN contributes ~0
            if kind in (ATTN_GLOBAL, ATTN_LOCAL):
                n += d * self.n_heads * hd  # wq
                n += 2 * d * self.n_kv_heads * hd  # wk, wv
                n += self.n_heads * hd * d  # wo
            elif kind == ATTN_MLA:
                qd = self.qk_nope_dim + self.qk_rope_dim
                if self.q_lora_rank:
                    n += d * self.q_lora_rank + self.q_lora_rank * self.n_heads * qd
                else:
                    n += d * self.n_heads * qd
                n += d * (self.kv_lora_rank + self.qk_rope_dim)
                n += self.kv_lora_rank * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
                n += self.n_heads * self.v_head_dim * d
            elif kind == RWKV6:
                n += 4 * d * d + 2 * d * d  # r,k,v,o,g + decay/bonus approx
            elif kind == RGLRU:
                w = self.lru_width
                n += 2 * d * w + w * d + 2 * w + self.conv1d_width * w
            # MLP / MoE
            if self.n_experts and kind not in (RWKV6,):
                fe = self.d_expert
                n += d * self.n_experts  # router
                mul = 3 if self.gated_mlp else 2
                n += self.n_experts * mul * d * fe
                n += self.n_shared_experts * mul * d * self.d_ff
            else:
                mul = 3 if self.gated_mlp else 2
                n += mul * d * self.d_ff
        if self.is_encoder_decoder:
            for _ in range(self.n_encoder_layers):
                n += d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
                mul = 3 if self.gated_mlp else 2
                n += mul * d * self.d_ff + 2 * d
            # decoder cross-attention (one per decoder layer)
            n += self.n_layers * (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                                  + self.n_heads * hd * d + d)
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: shared + top_k experts only)."""
        if not self.n_experts:
            return self.param_count()
        d, fe = self.d_model, self.d_expert
        mul = 3 if self.gated_mlp else 2
        per_layer_all = self.n_experts * mul * d * fe
        per_layer_active = self.top_k * mul * d * fe
        n_moe_layers = sum(1 for i, k in enumerate(self.layer_kinds())
                           if k != RWKV6 and (i % self.moe_every == 0))
        return self.param_count() - n_moe_layers * (per_layer_all - per_layer_active)

    def scaled(self, **overrides) -> "ModelConfig":
        """Return a reduced copy (used for smoke tests / CPU engine runs)."""
        return dataclasses.replace(self, **overrides)


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Family-preserving reduction for CPU smoke tests: same layer kinds and
    code paths, tiny dims."""
    pat = cfg.block_pattern
    # keep at least one full pattern repetition (plus remainder behaviour)
    n_layers = max(len(pat), 2)
    kw = dict(
        n_layers=n_layers,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads else 0,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        max_seq=512,
        window=min(cfg.window, 64) if cfg.window else 0,
        frontend_len=min(cfg.frontend_len, 8) if cfg.frontend_len else 0,
        encoder_seq=16,
        n_encoder_layers=2 if cfg.is_encoder_decoder else 0,
        dtype="float32",
    )
    if cfg.n_experts:
        # dropless capacity (cf = E/K) so prefill/decode token grouping cannot
        # change results via capacity drops — keeps consistency tests exact.
        top_k = min(cfg.top_k, 2)
        kw.update(n_experts=4, top_k=top_k, d_expert=32,
                  n_shared_experts=min(cfg.n_shared_experts, 1),
                  capacity_factor=4.0 / top_k)
    if cfg.uses_mla:
        kw.update(kv_lora_rank=32, q_lora_rank=0, qk_nope_dim=16,
                  qk_rope_dim=8, v_head_dim=16)
    if RWKV6 in pat:
        kw.update(rwkv_head_size=16)
    if RGLRU in pat:
        kw.update(lru_width=64)
    return cfg.scaled(**kw)
