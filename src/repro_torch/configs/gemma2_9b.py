"""gemma2-9b — 42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000.

Local+global alternating attention, attention/final logit softcaps, GeGLU,
sandwich (post) norms, tied embeddings.  [arXiv:2408.00118; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    rope_theta=10000.0,
    sliding_window=4096,
    attn_pattern=("local", "global"),
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    mlp_act="gelu",            # GeGLU
    norm="rmsnorm",
    post_norm=True,
    tie_embeddings=True,
    embedding_scale=True,
    source="arXiv:2408.00118; hf:google/gemma-2-9b",
)
