"""nemotron-4-15b [dense]: 32L d_model=6144 48H (GQA kv=8) d_ff=24576
vocab=256000 — squared-ReLU MLP, not gated. [arXiv:2402.16819; unverified]"""
from repro_torch.models.config import ATTN_GLOBAL, ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=256_000,
    activation="squared_relu",
    gated_mlp=False,
    norm="layernorm",
    block_pattern=(ATTN_GLOBAL,),
    rope_theta=10_000.0,
)
