"""gemma-7b — 28L d_model=3072 16H (MHA kv=16) d_ff=24576 vocab=256000.

GeGLU, head_dim=256, tied embeddings, embedding scaling. [arXiv:2403.08295; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    rope_theta=10000.0,
    attn_pattern=("global",),
    mlp_act="gelu",            # GeGLU
    norm="rmsnorm",
    tie_embeddings=True,
    embedding_scale=True,
    source="arXiv:2403.08295; hf:google/gemma-7b",
)
