"""The four input shapes of the dry-run and their abstract inputs
(counterpart of ``repro.configs.shapes``).

  train_4k       seq=  4,096  global_batch=256  (training)
  prefill_32k    seq= 32,768  global_batch= 32  (inference-prefill)
  decode_32k     seq= 32,768  global_batch=128  (inference-decode: ONE new
                                                  token vs a seq-long cache)
  long_500k      seq=524,288  global_batch=  1  (long-context decode;
                                                  sub-quadratic attention
                                                  required -> sliding-window
                                                  ring cache / SSM state)

``input_specs`` returns tensors on the ``meta`` device (shape and dtype,
no storage) where the reference returns ``ShapeDtypeStruct``s: the
sharding planner reads their shapes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..models.config import ModelConfig
from ..models.transformer import make_cache

__all__ = ["InputShape", "SHAPES", "applicable", "decode_window",
           "cache_len", "uses_ring", "input_specs"]


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq: int
    global_batch: int
    kind: str  # train | prefill | decode | decode_long


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode_long"),
}


def applicable(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    """Whether (arch, shape) runs, and the reason when skipped."""
    if shape.kind in ("decode", "decode_long") and not cfg.has_decode:
        return False, "encoder-only: no decode step (DESIGN.md §6)"
    return True, ""


def decode_window(cfg: ModelConfig, shape: InputShape) -> Optional[int]:
    """Attention window used for the decode shapes.

    long_500k requires sub-quadratic attention: SSM archs carry no cache at
    all; attention archs run the sliding-window variant (ring cache of
    ``long_context_window``).  decode_32k keeps native behaviour."""
    if shape.kind == "decode_long" and cfg.family != "ssm":
        return (cfg.sliding_window if cfg.sliding_window
                else cfg.long_context_window)
    return cfg.sliding_window


def cache_len(cfg: ModelConfig, shape: InputShape) -> int:
    if shape.kind == "decode_long" and cfg.family != "ssm":
        return int(decode_window(cfg, shape))
    return shape.seq


def uses_ring(cfg: ModelConfig, shape: InputShape) -> bool:
    return shape.kind == "decode_long" and cfg.family != "ssm"


def _spec(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, object]:
    """Abstract inputs (``meta`` tensors) for the step the shape runs."""
    B, S = shape.global_batch, shape.seq
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        batch: Dict[str, object] = {}
        if cfg.embed_inputs:
            batch["embeds"] = _spec((B, S, cfg.d_model), cfg.cdtype)
        else:
            batch["tokens"] = _spec((B, S), i32)
        if cfg.rope == "mrope":
            batch["positions"] = _spec((3, B, S), i32)
        if shape.kind == "train":
            batch["targets"] = _spec((B, S), i32)
        return {"batch": batch}

    # decode shapes: ONE new token against a cache
    cache = make_cache(cfg, B, cache_len(cfg, shape),
                       ring=uses_ring(cfg, shape), device="meta")
    return {"cache": cache, "token": _spec((B, 1), i32),
            "pos": _spec((), i32)}
