"""zamba2-2.7b [hybrid]: Mamba2 trunk + shared attention blocks.
54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000 ssm_state=64
[arXiv:2411.15242].  Shared attention+MLP block applied every 6 Mamba2
layers (9 invocations of one weight set)."""
from ..models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b",
        family="hybrid",
        source="arXiv:2411.15242",
        n_layers=54,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        head_dim=80,
        d_ff=10240,
        vocab=32000,
        act="silu_glu",
        norm="rmsnorm",
        rope="rope",
        ssm_state=64,
        ssm_expand=2,
        ssm_head_dim=64,
        attn_every=6,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
    )
