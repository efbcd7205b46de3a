"""Architecture registry: the 10 assigned configs (+ reduced smoke variants).

``get(arch_id)`` / ``get_reduced(arch_id)`` are what the launcher's ``--arch``
flag resolves through.
"""

from __future__ import annotations

from repro_torch.configs import (deepseek_v2_236b, gemma_2b, minicpm3_4b,
                           minitron_8b, phi35_moe_42b, qwen2_vl_7b,
                           recurrentgemma_9b, rwkv6_1b6, smollm_360m,
                           whisper_tiny)
from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig

_MODULES = {
    "qwen2-vl-7b": qwen2_vl_7b,
    "phi3.5-moe-42b": phi35_moe_42b,
    "gemma-2b": gemma_2b,
    "smollm-360m": smollm_360m,
    "whisper-tiny": whisper_tiny,
    "rwkv6-1.6b": rwkv6_1b6,
    "minicpm3-4b": minicpm3_4b,
    "minitron-8b": minitron_8b,
    "deepseek-v2-236b": deepseek_v2_236b,
    "recurrentgemma-9b": recurrentgemma_9b,
}

ARCH_IDS = tuple(_MODULES)


def get(arch_id: str) -> ModelConfig:
    return _MODULES[arch_id].CONFIG


def get_reduced(arch_id: str) -> ModelConfig:
    return _MODULES[arch_id].REDUCED


def is_subquadratic(cfg: ModelConfig) -> bool:
    """True when the arch supports long_500k (SSM / hybrid local-attention)."""
    return cfg.family in ("ssm", "hybrid")


def shape_supported(cfg: ModelConfig, shape: InputShape) -> bool:
    """The DESIGN.md §4 shape-skip policy (long_500k needs sub-quadratic)."""
    if shape.name == "long_500k":
        return is_subquadratic(cfg)
    return True


__all__ = ["ARCH_IDS", "get", "get_reduced", "is_subquadratic",
           "shape_supported", "INPUT_SHAPES", "InputShape", "ModelConfig"]
