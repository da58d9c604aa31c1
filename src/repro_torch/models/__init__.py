"""Model substrate (counterpart of ``repro.models``): configs, layers,
attention and the dense transformer with its serving entry points, and
the SSD scans of ``models.ssm`` (the oracles of the SSD kernel).

``loss_fn`` is the trainers' loss over a ``Transformer`` or the
reference-layout parameter tree (``param_tree``).  Not ported yet:
``param_specs`` (the dry-run's abstract shapes, item 15), and the MoE,
SSM (the Mamba2 block), hybrid, audio, VLM and MLA paths (item 14c).
"""
from .config import ModelConfig
from .transformer import (Transformer, decode_step, forward, init_params,
                          loss_fn, make_cache, param_tree, prefill)

__all__ = ["ModelConfig", "Transformer", "decode_step", "forward",
           "init_params", "loss_fn", "make_cache", "param_tree", "prefill"]
