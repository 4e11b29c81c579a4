"""H2O-Danube3-4B: llama+mistral mix with sliding-window attention.

[arXiv:2401.16818; unverified]
"""
from repro_torch.config import ModelConfig, SWA_ATTN

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    head_dim=120,
    layer_pattern=(SWA_ATTN,),
    window_size=4096,
    norm="rmsnorm",
    act="silu",
    glu=True,
)
