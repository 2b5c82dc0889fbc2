"""starcoder2-15b — 40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152.

GQA, RoPE, plain-GELU MLP, LayerNorm, biases. [arXiv:2402.19173; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    rope_theta=100000.0,
    attn_pattern=("global",),
    qkv_bias=True,
    mlp_act="gelu_mlp",        # plain 2-matrix GELU MLP
    norm="layernorm",
    tie_embeddings=False,
    source="arXiv:2402.19173; hf:bigcode/starcoder2-15b",
)
