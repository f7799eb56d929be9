"""qwen3-0.6b — the paper's served model (ConServe evaluation backbone).
28L d_model=1024 16H (GQA kv=8) head_dim=128 d_ff=3072 vocab=151936."""
from repro_torch.models.config import ATTN_GLOBAL, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151_936,
    activation="silu",
    norm="rmsnorm",
    block_pattern=(ATTN_GLOBAL,),
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)
