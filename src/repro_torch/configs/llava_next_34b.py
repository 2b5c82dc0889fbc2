"""llava-next-34b — 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.

VLM: Yi-34B-like language backbone; anyres vision tower is a STUB — input_specs
provides precomputed patch embeddings (batch, num_image_tokens, d_model).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
"""
from repro_torch.configs.base import ModelConfig, VLMConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    rope_theta=5000000.0,
    attn_pattern=("global",),
    mlp_act="silu",
    norm="rmsnorm",
    tie_embeddings=False,
    vlm=VLMConfig(num_image_tokens=576, frontend="stub"),
    source="hf:llava-hf/llava-v1.6-34b-hf; unverified",
)
