"""olmoe-1b-7b — 16L d_model=2048 16H (kv=16) vocab=50304, MoE 64 experts top-8.

64 experts, top-8 token-choice routing, d_ff_expert=1024, SwiGLU experts.
[arXiv:2409.02060; hf]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1024,                 # = d_ff_expert (all layers MoE)
    vocab_size=50304,
    rope_theta=10000.0,
    attn_pattern=("global",),
    mlp_act="silu",
    norm="rmsnorm",
    tie_embeddings=False,
    moe=MoEConfig(
        num_experts=64,
        top_k=8,
        d_ff_expert=1024,
        num_shared_experts=0,
        capacity_factor=1.25,
    ),
    source="arXiv:2409.02060; hf:allenai/OLMoE-1B-7B-0924",
)
