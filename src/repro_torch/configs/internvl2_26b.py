"""internvl2-26b [vlm]: 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553 — InternViT frontend is a STUB (input_specs supplies patch
embeddings), InternLM2 backbone. [arXiv:2404.16821; hf]"""
from repro_torch.models.config import ATTN_GLOBAL, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92_553,
    activation="silu",
    norm="rmsnorm",
    block_pattern=(ATTN_GLOBAL,),
    rope_theta=1_000_000.0,
    frontend="vision",
    frontend_len=256,  # one 448px tile after pixel-unshuffle
)
