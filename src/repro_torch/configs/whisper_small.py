"""whisper-small [audio]: enc-dec, 12L decoder d_model=768 12H (kv=12)
d_ff=3072 vocab=51865 — conv frontend is a STUB (input_specs supplies frame
embeddings for the 12L encoder). [arXiv:2212.04356; unverified]"""
from repro_torch.models.config import ATTN_GLOBAL, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51_865,
    activation="gelu",
    gated_mlp=False,
    norm="layernorm",
    block_pattern=(ATTN_GLOBAL,),
    is_encoder_decoder=True,
    n_encoder_layers=12,
    encoder_seq=1500,
    frontend="audio",
    frontend_len=1500,
    max_seq=40_960,
)
