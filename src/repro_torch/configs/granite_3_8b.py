"""Granite-3.0-8B base: dense GQA llama-style.

[hf:ibm-granite family; hf]
"""
from repro_torch.config import FULL_ATTN, ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=12800,
    vocab_size=49155,
    head_dim=128,
    layer_pattern=(FULL_ATTN,),
    norm="rmsnorm",
    act="silu",
    glu=True,
    tie_embeddings=True,
)
