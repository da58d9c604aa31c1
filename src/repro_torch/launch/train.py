"""Model presets of the asynchronous training driver (the ``PRESETS`` of
``repro.launch.train``; the trainer itself is ROADMAP queue A item 14c).
``launch.serve`` takes its ``--preset`` models from here, as the
reference's does."""
from __future__ import annotations

from ..models.config import ModelConfig

__all__ = ["PRESETS"]

PRESETS = {
    # ~103M params: the end-to-end driver scale
    "100m": ModelConfig(name="lm-100m", n_layers=12, d_model=768, n_heads=12,
                        n_kv_heads=4, head_dim=64, d_ff=2048, vocab=8192,
                        q_chunk=256),
    "25m": ModelConfig(name="lm-25m", n_layers=8, d_model=384, n_heads=8,
                       n_kv_heads=4, head_dim=48, d_ff=1024, vocab=4096,
                       q_chunk=256),
    "moe-tiny": ModelConfig(name="moe-tiny", family="moe", n_layers=6,
                            d_model=384, n_heads=8, n_kv_heads=8, head_dim=48,
                            d_ff=512, n_experts=8, top_k=2, moe_ff=512,
                            shared_ff=512, vocab=4096, q_chunk=256),
}
