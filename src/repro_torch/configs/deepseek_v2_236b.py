"""deepseek-v2-236b [moe]: MLA (kv_lora=512) + 2 shared / 160 routed top-6.
60L d_model=5120 128H expert d_ff=1536 vocab=102400 [arXiv:2405.04434].
MLA: q_lora=1536, rope_head_dim=64, nope=128, v=128; decode uses the
absorbed latent form (cache = 512+64 per token per layer).
Deviation noted in DESIGN.md: the real model's first dense layer is modeled
as MoE for scan homogeneity."""
from ..models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        source="arXiv:2405.04434",
        n_layers=60,
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,
        head_dim=128,
        use_mla=True,
        kv_lora_rank=512,
        q_lora_rank=1536,
        rope_head_dim=64,
        nope_head_dim=128,
        v_head_dim=128,
        d_ff=1536,
        moe_ff=1536,
        n_experts=160,
        top_k=6,
        shared_ff=3072,
        vocab=102400,
        act="silu_glu",
        norm="rmsnorm",
        rope="rope",
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
    )
