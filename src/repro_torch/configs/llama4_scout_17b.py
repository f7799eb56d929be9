"""llama4-scout-17b-a16e [moe]: 48L d_model=5120 40H (GQA kv=8) d_ff=8192,
MoE 16 experts top-1 + 1 shared expert, vocab=202048 — early-fusion
multimodal in the original; assigned as text backbone.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from repro_torch.models.config import ATTN_GLOBAL, ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202_048,
    activation="silu",
    norm="rmsnorm",
    block_pattern=(ATTN_GLOBAL,),
    n_experts=16,
    top_k=1,
    n_shared_experts=1,
    d_expert=8192,
    rope_theta=500_000.0,
)
