"""whisper-base — enc-dec, 6L each, d_model=512 8H d_ff=2048 vocab=51865.

Conv frontend is a STUB: input_specs provides precomputed frame embeddings
(batch, frames, d_model).  Sinusoidal-free simplification: learned positions
replaced by RoPE-free absolute embeddings in this backbone reproduction.
[arXiv:2212.04356; unverified]
"""
from repro_torch.configs.base import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,              # decoder layers
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    attn_pattern=("global",),
    mlp_act="gelu_mlp",
    norm="layernorm",
    tie_embeddings=True,
    encdec=EncDecConfig(encoder_layers=6, frontend="stub"),
    source="arXiv:2212.04356; hf:openai/whisper-base; unverified",
)
