"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H (GQA kv=16) per-expert
d_ff=1408, vocab=102400, MoE 64 routed top-6 + 2 shared — MLA kv_lora=512.
[arXiv:2405.04434; hf]

Fidelity note: the real model keeps layer 0 dense; we run MoE in all 27
layers to keep the layer-scan homogeneous (recorded in DESIGN.md)."""
from repro_torch.models.config import ATTN_MLA, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,              # per-expert hidden dim
    vocab_size=102_400,
    activation="silu",
    norm="rmsnorm",
    block_pattern=(ATTN_MLA,),
    n_experts=64,
    top_k=6,
    n_shared_experts=2,
    d_expert=1408,
    kv_lora_rank=512,
    q_lora_rank=0,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    rope_theta=10_000.0,
)
