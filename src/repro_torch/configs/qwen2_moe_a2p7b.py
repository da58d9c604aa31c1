"""qwen2-moe-a2.7b [moe]: 4 shared + 60 routed experts, top-4.
24L d_model=2048 16H (kv=16) expert d_ff=1408 vocab=151936
[hf:Qwen/Qwen1.5-MoE-A2.7B].  The 4 shared experts are modeled as one fused
shared MLP of intermediate size 4*1408 = 5632 (matching the released
shared-expert intermediate size)."""
from ..models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        source="hf:Qwen/Qwen1.5-MoE-A2.7B",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=1408,
        moe_ff=1408,
        n_experts=60,
        top_k=4,
        shared_ff=5632,
        vocab=151936,
        qkv_bias=True,
        act="silu_glu",
        norm="rmsnorm",
        rope="rope",
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
    )
