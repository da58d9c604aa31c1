"""starcoder2-15b [dense]: GQA + RoPE, LayerNorm, GELU, bias, native 4k
sliding window.  40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152
[arXiv:2402.19173]."""
from ..models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-15b",
        family="dense",
        source="arXiv:2402.19173",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=4,
        head_dim=128,
        d_ff=24576,
        vocab=49152,
        act="gelu",
        norm="layernorm",
        qkv_bias=True,
        mlp_bias=True,
        rope="rope",
        sliding_window=4096,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
    )
