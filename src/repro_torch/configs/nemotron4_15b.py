"""nemotron-4-15b [dense]: GQA + squared-ReLU MLP, huge vocab.
32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000 [arXiv:2402.16819]."""
from ..models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b",
        family="dense",
        source="arXiv:2402.16819",
        n_layers=32,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=24576,
        vocab=256000,
        act="relu2",
        norm="layernorm",
        rope="rope",
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
    )
