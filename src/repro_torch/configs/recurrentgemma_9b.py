"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (GQA kv=1 = MQA)
d_ff=12288 vocab=256000 — RG-LRU + local attention, pattern 2 recurrent :
1 attention (Griffin). 38 = 12x3 + 2 -> two trailing RG-LRU layers.
[arXiv:2402.19427; unverified]"""
from repro_torch.models.config import ATTN_LOCAL, RGLRU, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256_000,
    activation="gelu",
    norm="rmsnorm",
    block_pattern=(RGLRU, RGLRU, ATTN_LOCAL),
    window=2048,
    lru_width=4096,
    conv1d_width=4,
    rope_theta=10_000.0,
    max_seq=1_048_576,
)
