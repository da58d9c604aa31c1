"""hubert-xlarge [audio]: encoder-only transformer backbone (same arch as
wav2vec2).  48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 (masked-unit
prediction classes) [arXiv:2106.07447].

The mel-spectrogram + conv feature extractor frontend is a STUB per the
assignment carve-out: input_specs() provides precomputed frame embeddings of
shape (B, S, 1280).  Encoder-only => no decode step (decode_32k / long_500k
skipped; see DESIGN.md §6)."""
from ..models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge",
        family="audio",
        source="arXiv:2106.07447",
        n_layers=48,
        d_model=1280,
        n_heads=16,
        n_kv_heads=16,
        head_dim=80,
        d_ff=5120,
        vocab=504,
        act="gelu",
        norm="layernorm",
        causal=False,
        has_decode=False,
        embed_inputs=True,
        rope="none",
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
    )
