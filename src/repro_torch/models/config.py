"""Model configuration for all six architecture families (counterpart of
``repro.models.config``).

``ModelConfig`` has the reference's field names and defaults, with one
deliberate deviation: ``attention_impl`` defaults to ``"pallas"``.  In the
port that value means the hand-written Hopper flash-attention kernel
(``kernels.flash_attention``), taken by ``forward`` and ``prefill`` on a
CUDA device; on the CPU the same value takes the kernel's plain PyTorch
version.  This follows ``ExecutionSpec.engine="fused"``: the port's
default is its kernel, and parity tests pass ``attention_impl`` on both
sides.  Dtypes stay strings; ``pdtype`` / ``cdtype`` are torch dtypes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str = "model"
    family: str = "dense"           # dense | moe | ssm | hybrid | audio | vlm
    source: str = ""                # citation for the config

    # trunk
    n_layers: int = 2
    d_model: int = 256
    vocab: int = 32000
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    tie_embeddings: bool = False

    # attention
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 64
    qkv_bias: bool = False
    causal: bool = True             # False => encoder-only (bidirectional)
    rope: str = "rope"              # rope | mrope | none
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, ...] = ()   # splits of head_dim//2 for M-RoPE
    sliding_window: Optional[int] = None   # native window (starcoder2 trains 4k)
    attention_impl: str = "pallas"         # pallas (the CUDA kernel) | chunked | naive
    q_chunk: int = 512

    # MLA (deepseek-v2)
    use_mla: bool = False
    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128

    # mlp
    d_ff: int = 1024
    act: str = "silu_glu"           # silu_glu | gelu | relu2
    mlp_bias: bool = False

    # MoE
    n_experts: int = 0              # routed experts (0 => dense MLP)
    top_k: int = 2
    shared_ff: int = 0              # fused shared-expert intermediate size
    moe_ff: int = 0                 # routed expert intermediate size
    router_aux_coef: float = 0.01
    moe_impl: str = "capacity"      # capacity (bucketed) | dense (oracle)
    capacity_factor: float = 1.25

    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_n_groups: int = 1
    ssm_chunk: int = 256

    # hybrid (zamba2): shared attention+MLP block applied every N layers
    attn_every: int = 0

    # modality frontend stub (audio/vlm): inputs are precomputed embeddings
    embed_inputs: bool = False
    has_decode: bool = True         # False for encoder-only (hubert)

    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    remat: bool = True
    # long-context variant: replace full attention by this sliding window
    long_context_window: int = 8192

    # chunked cross-entropy: compute logits + CE one sequence chunk at a
    # time so the (B, S, V) logits tensor is never materialized (matters for
    # vocab >= 100k: nemotron's 256k vocab at train_4k is 537 GB of f32
    # logits otherwise).  0 = off.
    ce_chunk: int = 0

    # ---- beyond-paper performance knobs (EXPERIMENTS.md §Perf) ----------
    # checkpoint each q-chunk of attention: the backward recomputes scores
    # instead of stacking f32 score chunks across the scan (huge HBM win)
    remat_chunk: bool = False
    # pin activation shardings inside the layer stack: batch over act_dp_axes
    # (and sequence over "model" when seq_shard=True -- megatron-style
    # sequence parallelism for the norm/elementwise segments)
    shard_activations: bool = False
    seq_shard: bool = False
    act_dp_axes: Tuple[str, ...] = ("data",)

    # ---------------------------------------------------------------
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def pdtype(self):
        return DTYPES[self.param_dtype]

    @property
    def cdtype(self):
        return DTYPES[self.compute_dtype]

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: 2 layers, d_model <= 512, <= 4 experts."""
        d = min(self.d_model, 256)
        heads = max(2, min(self.n_heads, 4))
        kv = max(1, min(self.n_kv_heads, heads))
        hd = min(self.head_dim, 64)
        sections = ()
        if self.rope == "mrope":
            # keep three sections summing to head_dim // 2
            half = hd // 2
            sections = (half - 2 * (half // 3), half // 3, half // 3)
        return self.replace(
            name=self.name + "-reduced",
            n_layers=2,
            d_model=d,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=hd,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2),
            moe_ff=min(self.moe_ff, 128) if self.moe_ff else 0,
            shared_ff=min(self.shared_ff, 128) if self.shared_ff else 0,
            kv_lora_rank=min(self.kv_lora_rank, 32),
            rope_head_dim=min(self.rope_head_dim, 16),
            nope_head_dim=min(self.nope_head_dim, 48) if self.use_mla else self.nope_head_dim,
            v_head_dim=min(self.v_head_dim, 64) if self.use_mla else self.v_head_dim,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=min(self.ssm_head_dim, 32),
            ssm_chunk=64,
            attn_every=min(self.attn_every, 2) if self.attn_every else 0,
            mrope_sections=sections,
            q_chunk=64,
            param_dtype="float32",
            compute_dtype="float32",
            long_context_window=256,
        )

    def validate(self) -> None:
        """The reference's consistency checks, raised as ``ValueError`` (the
        reference asserts them)."""
        checks = [(self.n_heads % max(self.n_kv_heads, 1) == 0,
                   "GQA group must divide")]
        if self.rope == "mrope":
            checks.append((sum(self.mrope_sections) == (
                self.rope_head_dim if self.use_mla else self.head_dim) // 2,
                "mrope_sections must sum to half the rotary dim"))
        if self.family in ("ssm", "hybrid"):
            checks.append((self.ssm_state > 0
                           and self.d_inner % self.ssm_head_dim == 0,
                           "SSM state and head split"))
        if self.n_experts:
            checks.append((self.moe_ff > 0 and self.top_k <= self.n_experts,
                           "MoE sizes"))
        if self.family in ("audio", "vlm"):
            checks.append((self.embed_inputs, "frontends take embeddings"))
        if not self.causal:
            checks.append((not self.has_decode,
                           "encoder-only models have no decode step"))
        for ok, what in checks:
            if not ok:
                raise ValueError(f"{self.name}: {what}")
