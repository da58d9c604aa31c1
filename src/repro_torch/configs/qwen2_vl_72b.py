"""qwen2-vl-72b [vlm]: M-RoPE + dynamic resolution.  80L d_model=8192 64H
(GQA kv=8) d_ff=29568 vocab=152064 [arXiv:2409.12191].

The ViT vision encoder + projector frontend is a STUB per the assignment
carve-out: input_specs() provides precomputed patch embeddings (B, S, 8192)
plus (3, B, S) M-RoPE position grids.  The language backbone (M-RoPE
sections 16/24/24 over head_dim/2 = 64) is fully implemented; text decode
uses the token table."""
from ..models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b",
        family="vlm",
        source="arXiv:2409.12191",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=29568,
        vocab=152064,
        qkv_bias=True,
        act="silu_glu",
        norm="rmsnorm",
        rope="mrope",
        mrope_sections=(16, 24, 24),
        embed_inputs=True,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
    )
