"""Architecture registry and the paper's workloads (counterpart of
``repro.configs``).

``get_config(arch_id)`` returns the shape-only ``ModelConfig`` of every
architecture in ``ARCH_IDS``; the ten modules are data copied from the
reference, field for field.  ``paper_logreg`` holds the paper's convex
workloads; ``shapes`` the dry-run's four input shapes and their abstract
inputs (``meta`` tensors).
"""
from importlib import import_module
from typing import List

from ..models.config import ModelConfig

_MODULES = {
    "zamba2-2.7b": "zamba2_2p7b",
    "starcoder2-15b": "starcoder2_15b",
    "yi-34b": "yi_34b",
    "hubert-xlarge": "hubert_xlarge",
    "mamba2-780m": "mamba2_780m",
    "nemotron-4-15b": "nemotron4_15b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2p7b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "qwen2.5-32b": "qwen2p5_32b",
    "qwen2-vl-72b": "qwen2_vl_72b",
}

ARCH_IDS: List[str] = list(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise ValueError(f"unknown arch {arch_id!r}; options: {ARCH_IDS}")
    cfg = import_module(f".{_MODULES[arch_id]}", __name__).get_config()
    cfg.validate()
    return cfg


from .shapes import SHAPES, InputShape, applicable, input_specs  # noqa: E402

__all__ = ["ARCH_IDS", "get_config", "SHAPES", "InputShape", "applicable",
           "input_specs"]
