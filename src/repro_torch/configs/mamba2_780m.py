"""mamba2-780m — 48L d_model=1536 attention-free, vocab=50280, ssm_state=128.

SSD (state-space duality) blocks: expand=2 (d_inner=3072), head_dim=64
(48 ssm heads), chunked matmul scan. [arXiv:2405.21060; unverified]
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,               # attention-free
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    attn_pattern=(),
    norm="rmsnorm",
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk_size=256),
    source="arXiv:2405.21060; hf:state-spaces/mamba2-780m; unverified",
)
