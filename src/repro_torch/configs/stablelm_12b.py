"""stablelm-12b [dense]: 40L d_model=5120 32H (GQA kv=8) d_ff=13824
vocab=100352. [hf:stabilityai/stablelm-2-1_6b family; hf]"""
from repro_torch.models.config import ATTN_GLOBAL, ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=160,
    d_ff=13824,
    vocab_size=100_352,
    activation="silu",
    norm="layernorm",
    block_pattern=(ATTN_GLOBAL,),
    qk_norm=True,
    rope_theta=10_000.0,
)
