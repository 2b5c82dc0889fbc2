"""Configuration dataclasses for the KrylovLR framework.

Counterpart of ``repro.configs.base``, field for field and default for
default: the port keeps its own copy so that it imports nothing of
``repro``.  Every assigned architecture is expressed as a ``ModelConfig``;
the training / serving / dry-run drivers consume ``RunConfig`` which
composes the model with mesh, optimizer, data and fault-tolerance
settings.  Configs are plain frozen dataclasses so they hash, repr and
serialize (``to_dict``) trivially.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple


def _asdict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj):
        return {f.name: _asdict(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_asdict(x) for x in obj]
    return obj


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block settings (token-choice top-k routing)."""

    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01
    # layers [moe_start, num_layers) use MoE every `moe_every` layers
    moe_start_layer: int = 0
    moe_every: int = 1


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention settings."""

    kv_lora_rank: int
    q_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block settings."""

    d_state: int
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 256
    n_groups: int = 1


@dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style hybrid: SSM backbone with a SHARED attention block woven in."""

    attn_every: int = 6          # apply the shared attn+mlp block every N ssm layers
    shared_attn_d_ff: int = 8192


@dataclass(frozen=True)
class EncDecConfig:
    """Whisper-style encoder-decoder settings (frontend is a stub)."""

    encoder_layers: int = 6
    # the conv frontend is stubbed: input_specs() provides precomputed frame
    # embeddings of shape (batch, frames, d_model)
    frontend: str = "stub"


@dataclass(frozen=True)
class VLMConfig:
    """LLaVA-style VLM settings (vision tower is a stub)."""

    num_image_tokens: int = 576   # anyres base tile -> stubbed patch embeddings
    frontend: str = "stub"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | vlm | audio | ssm | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None           # default: d_model // num_heads
    # --- attention ---
    rope_theta: float = 10000.0
    partial_rotary_factor: float = 1.0
    sliding_window: Optional[int] = None
    # pattern of layer attention kinds, tiled over depth, e.g. ("local","global")
    attn_pattern: Tuple[str, ...] = ("global",)
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    qkv_bias: bool = False
    # --- mlp / norm / embedding ---
    mlp_act: str = "silu"          # silu -> SwiGLU, gelu -> GeGLU, gelu_mlp -> plain
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    post_norm: bool = False        # gemma2 sandwich norms
    tie_embeddings: bool = True
    embedding_scale: bool = False  # gemma: scale embeddings by sqrt(d_model)
    # --- sub-configs ---
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    vlm: Optional[VLMConfig] = None
    # --- attention / loss memory knobs (hillclimb levers; see §Perf) ---
    attn_impl: str = "auto"        # full | chunked | online | auto
    q_chunk: int = 1024            # query/kv-chunk size for chunked/online
    ce_chunk: int = 1024           # seq-chunk for the cross-entropy/LM head
    cache_update: str = "blend"    # blend | dus (decode-bandwidth lever)
    # pin the residual stream to batch sharding at every block boundary —
    # without this GSPMD may silently replicate activations over "data"
    # inside attention (observed: 16x logits blow-up; see §Perf)
    pin_activations: bool = False
    # --- numerics ---
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    remat_policy: str = "nothing"  # nothing | dots | none  (hillclimb knob)
    source: str = ""               # provenance of the config

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    def to_dict(self) -> dict:
        return _asdict(self)

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        small: dict[str, Any] = dict(
            num_layers=min(self.num_layers, 2),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(4, max(1, self.num_kv_heads * 4 // max(self.num_heads, 1))),
            head_dim=32,
            d_ff=256,
            vocab_size=512,
        )
        if self.moe is not None:
            small["moe"] = dataclasses.replace(
                self.moe, num_experts=4, top_k=2, d_ff_expert=64,
                num_shared_experts=min(self.moe.num_shared_experts, 1), d_ff_shared=64)
        if self.mla is not None:
            small["mla"] = MLAConfig(kv_lora_rank=32, q_lora_rank=48,
                                     qk_nope_head_dim=16, qk_rope_head_dim=16,
                                     v_head_dim=32)
            small["head_dim"] = None
        if self.ssm is not None:
            small["ssm"] = dataclasses.replace(self.ssm, d_state=16, head_dim=16,
                                               chunk_size=32)
        if self.hybrid is not None:
            small["hybrid"] = dataclasses.replace(self.hybrid, attn_every=2,
                                                  shared_attn_d_ff=256)
        if self.encdec is not None:
            small["encdec"] = dataclasses.replace(self.encdec, encoder_layers=2)
        if self.vlm is not None:
            small["vlm"] = dataclasses.replace(self.vlm, num_image_tokens=8)
        if self.sliding_window is not None:
            small["sliding_window"] = 16
        small["dtype"] = "float32"
        small["param_dtype"] = "float32"
        small.update(overrides)
        return dataclasses.replace(self, **small)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


@dataclass(frozen=True)
class FsvdConfig:
    """Settings for the paper's technique inside the framework."""

    max_iters: int = 64            # k in Alg 1/2
    breakdown_eps: float = 1e-8    # epsilon in Alg 1/3
    reorth: int = 2                # CGS passes (2 = "twice is enough")
    # gradient compression
    compress_gradients: bool = False
    compression_rank: int = 8
    compression_min_dim: int = 256   # only compress 2D grads with min(m,n) >= this
    error_feedback: bool = True
    # telemetry
    rank_telemetry: bool = False
    rank_telemetry_every: int = 100


@dataclass(frozen=True)
class OptimConfig:
    name: str = "adamw"
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    schedule: str = "cosine"       # cosine | linear | constant


@dataclass(frozen=True)
class CheckpointConfig:
    directory: str = "/tmp/krylovlr_ckpt"
    every_steps: int = 50
    keep: int = 3
    async_write: bool = True


@dataclass(frozen=True)
class RuntimeConfig:
    nan_guard: bool = True
    max_nan_skips: int = 10
    straggler_zscore: float = 3.0
    straggler_window: int = 50
    log_every: int = 10


@dataclass(frozen=True)
class MeshConfig:
    multi_pod: bool = False
    # overridable for tests / elastic runs; None -> production shape
    shape: Optional[Tuple[int, ...]] = None
    axes: Optional[Tuple[str, ...]] = None


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    mesh: MeshConfig = field(default_factory=MeshConfig)
    fsvd: FsvdConfig = field(default_factory=FsvdConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)
    seed: int = 0

    def to_dict(self) -> dict:
        return _asdict(self)
