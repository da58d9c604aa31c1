"""Model substrate (counterpart of ``repro.models``): configs, layers,
attention (GQA and MLA), the MoE layer (``moe``), the Mamba2 block and
its SSD scans (``ssm``), and the transformer of all six families (dense,
moe, ssm, hybrid, and the audio and VLM frontends on embeddings) with
its serving entry points.

``loss_fn`` is the trainers' loss over a ``Transformer`` or the
reference-layout parameter tree (``param_tree``); ``param_specs`` is that
tree on the ``meta`` device (shapes only, for the sharding planner).
"""
from .config import ModelConfig
from .transformer import (Transformer, decode_step, forward, init_params,
                          loss_fn, make_cache, param_specs, param_tree,
                          prefill)

__all__ = ["ModelConfig", "Transformer", "decode_step", "forward",
           "init_params", "loss_fn", "make_cache", "param_specs",
           "param_tree", "prefill"]
