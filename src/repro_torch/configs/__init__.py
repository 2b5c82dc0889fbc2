"""Configuration dataclasses of the port (counterpart of ``repro.configs``).

The base dataclasses and the paper's RSL configuration.  The registry of
model files (``ARCHS``, ``get_arch``, ``cell_applicable``) comes with the
training stack (``ROADMAP.md`` Queue 1 item 7).
"""
from repro_torch.configs.base import (
    CheckpointConfig,
    EncDecConfig,
    FsvdConfig,
    HybridConfig,
    MeshConfig,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    OptimConfig,
    RunConfig,
    RuntimeConfig,
    ShapeConfig,
    SHAPES,
    SSMConfig,
    VLMConfig,
)
from repro_torch.configs.paper_rsl import CONFIG, CONFIG_100M, RSLConfig

__all__ = [
    "SHAPES", "ModelConfig", "MoEConfig", "MLAConfig", "SSMConfig",
    "HybridConfig", "EncDecConfig", "VLMConfig", "ShapeConfig",
    "FsvdConfig", "OptimConfig", "CheckpointConfig", "RuntimeConfig",
    "MeshConfig", "RunConfig", "RSLConfig", "CONFIG", "CONFIG_100M",
]
