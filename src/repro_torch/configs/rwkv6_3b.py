"""rwkv6-3b [ssm]: 32L d_model=2560 (attention-free) d_ff=8960 vocab=65536 —
Finch, data-dependent decay. O(1) decode state. [arXiv:2404.05892; hf]"""
from repro_torch.models.config import RWKV6, ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    head_dim=64,
    d_ff=8960,
    vocab_size=65_536,
    norm="layernorm",
    block_pattern=(RWKV6,),
    rwkv_head_size=64,
    max_seq=1_048_576,
)
