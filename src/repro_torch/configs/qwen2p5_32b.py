"""qwen2.5-32b [dense]: GQA with QKV bias.  64L d_model=5120 40H (GQA kv=8)
d_ff=27648 vocab=152064 [hf:Qwen/Qwen2.5-0.5B (family card)]."""
from ..models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-32b",
        family="dense",
        source="hf:Qwen/Qwen2.5-0.5B",
        n_layers=64,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=27648,
        vocab=152064,
        qkv_bias=True,
        act="silu_glu",
        norm="rmsnorm",
        rope="rope",
        rope_theta=1000000.0,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
    )
