"""zamba2-1.2b — 38L d_model=2048 hybrid Mamba2 + shared attention, vocab=32000.

Mamba2 backbone (ssm_state=64) with a single SHARED attention+MLP block
(32H kv=32, d_ff=8192) applied every 6 SSM layers. [arXiv:2411.15242; hf]
"""
from repro_torch.configs.base import HybridConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    rope_theta=10000.0,
    attn_pattern=("global",),
    mlp_act="gelu_mlp",
    norm="rmsnorm",
    tie_embeddings=True,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk_size=256),
    hybrid=HybridConfig(attn_every=6, shared_attn_d_ff=8192),
    source="arXiv:2411.15242; hf:Zyphra/Zamba2-1.2B",
)
