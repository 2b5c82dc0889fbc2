"""Configuration of the port (counterpart of ``repro.configs``).

The base dataclasses, the paper's RSL configuration, the ten model files
and their registry: every assigned architecture is selectable by id
(``ARCHS``, ``get_arch``), every input-shape cell by name (``SHAPES``,
``get_shape``), and ``cell_applicable`` says which (arch, shape) cells
run.  Each model file is a copy of the reference's, ``source`` included.
"""
from __future__ import annotations

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

from repro_torch.configs.gemma2_9b import CONFIG as _gemma2_9b
from repro_torch.configs.gemma_7b import CONFIG as _gemma_7b
from repro_torch.configs.stablelm_1_6b import CONFIG as _stablelm_1_6b
from repro_torch.configs.starcoder2_15b import CONFIG as _starcoder2_15b
from repro_torch.configs.olmoe_1b_7b import CONFIG as _olmoe_1b_7b
from repro_torch.configs.deepseek_v2_236b import CONFIG as _deepseek_v2_236b
from repro_torch.configs.llava_next_34b import CONFIG as _llava_next_34b
from repro_torch.configs.whisper_base import CONFIG as _whisper_base
from repro_torch.configs.mamba2_780m import CONFIG as _mamba2_780m
from repro_torch.configs.zamba2_1_2b import CONFIG as _zamba2_1_2b

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in [
        _gemma2_9b,
        _gemma_7b,
        _stablelm_1_6b,
        _starcoder2_15b,
        _olmoe_1b_7b,
        _deepseek_v2_236b,
        _llava_next_34b,
        _whisper_base,
        _mamba2_780m,
        _zamba2_1_2b,
    ]
}

# Shape-cell applicability.  long_500k requires sub-quadratic sequence
# mixing -> SSM / hybrid only.
SUBQUADRATIC = {"mamba2-780m", "zamba2-1.2b"}


def cell_applicable(arch: str, shape: str) -> tuple[bool, str]:
    """Return (applicable, reason-if-not) for an (arch, shape) cell."""
    if shape == "long_500k" and arch not in SUBQUADRATIC:
        return False, ("long_500k needs sub-quadratic attention; "
                       f"{arch} has full/global attention layers")
    return True, ""


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; available: {sorted(SHAPES)}")
    return SHAPES[name]


__all__ = [
    "ARCHS", "SHAPES", "SUBQUADRATIC", "cell_applicable", "get_arch",
    "get_shape", "ModelConfig", "MoEConfig", "MLAConfig", "SSMConfig",
    "HybridConfig", "EncDecConfig", "VLMConfig", "ShapeConfig",
    "FsvdConfig", "OptimConfig", "CheckpointConfig", "RuntimeConfig",
    "MeshConfig", "RunConfig", "RSLConfig", "CONFIG", "CONFIG_100M",
]
