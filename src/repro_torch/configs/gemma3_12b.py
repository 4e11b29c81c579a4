"""Gemma-3-12B: 5 local (w=1024) : 1 global pattern, 128k context, 256k vocab.

[hf:google/gemma-3-1b-pt family; unverified]
"""
from repro_torch.config import GLOBAL_ATTN, ModelConfig, SWA_ATTN

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    d_ff=15360,
    vocab_size=262144,
    head_dim=256,
    layer_pattern=(SWA_ATTN, SWA_ATTN, SWA_ATTN, SWA_ATTN, SWA_ATTN,
                   GLOBAL_ATTN),
    window_size=1024,
    norm="rmsnorm",
    act="gelu",
    glu=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    logit_softcap=30.0,
)
