"""gemma3-12b [dense]: 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144 — 5:1 local:global sliding-window attention, 128k context.
[hf:google/gemma-3-1b-pt family; unverified]"""
from repro_torch.models.config import ATTN_GLOBAL, ATTN_LOCAL, ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=240,
    d_ff=15360,
    vocab_size=262_144,
    activation="gelu",
    norm="rmsnorm",
    block_pattern=(ATTN_LOCAL,) * 5 + (ATTN_GLOBAL,),
    window=1024,
    rope_theta=1_000_000.0,
    rope_theta_local=10_000.0,
    qk_norm=True,
    max_seq=131_072,
)
