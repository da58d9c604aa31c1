"""yi-34b [dense]: llama-architecture GQA.  60L d_model=7168 56H (GQA kv=8)
d_ff=20480 vocab=64000 [arXiv:2403.04652]."""
from ..models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="yi-34b",
        family="dense",
        source="arXiv:2403.04652",
        n_layers=60,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        head_dim=128,
        d_ff=20480,
        vocab=64000,
        act="silu_glu",
        norm="rmsnorm",
        rope="rope",
        rope_theta=5000000.0,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
    )
