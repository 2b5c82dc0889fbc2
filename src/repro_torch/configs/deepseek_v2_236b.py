"""deepseek-v2-236b — 60L d_model=5120 128H vocab=102400, MLA + MoE 160e top-6.

MLA with kv_lora_rank=512 (q_lora_rank=1536, qk nope/rope head dims 128/64,
v_head_dim=128); MoE: 2 shared + 160 routed experts, top-6, d_ff_expert=1536;
first layer dense with d_ff=12288. [arXiv:2405.04434; hf]
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,          # MLA: kv heads == heads after up-projection
    d_ff=12288,                # dense layers (layer 0)
    vocab_size=102400,
    rope_theta=10000.0,
    attn_pattern=("global",),
    mlp_act="silu",
    norm="rmsnorm",
    tie_embeddings=False,
    mla=MLAConfig(
        kv_lora_rank=512,
        q_lora_rank=1536,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        num_experts=160,
        top_k=6,
        d_ff_expert=1536,
        num_shared_experts=2,
        d_ff_shared=1536,
        capacity_factor=1.25,
        moe_start_layer=1,     # layer 0 is dense in DeepSeek-V2
        moe_every=1,
    ),
    source="arXiv:2405.04434; hf:deepseek-ai/DeepSeek-V2",
)
