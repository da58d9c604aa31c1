"""mamba2-780m [ssm]: SSD (state-space duality), attention-free.
48L d_model=1536 d_ff=0 vocab=50280 ssm_state=128 [arXiv:2405.21060].
expand=2 -> d_inner=3072, head_dim=64 -> 48 SSM heads."""
from ..models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m",
        family="ssm",
        source="arXiv:2405.21060",
        n_layers=48,
        d_model=1536,
        d_ff=0,
        vocab=50280,
        ssm_state=128,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_chunk=256,
        rope="none",
        norm="rmsnorm",
        tie_embeddings=True,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
    )
