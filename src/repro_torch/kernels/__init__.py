"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

``dispatch``        -- the device rule (cuda by default, cpu only when asked).
``build``           -- nvcc build of ``csrc/*.cu`` into ctypes-loaded
                       libraries.
``fused_step``      -- the fused per-event steps: policy + prox (PIAG),
                       policy + mix (FedAsync), policy + buffer step
                       (FedBuff); they replace the TPU kernels
                       ``fused_policy_prox_step``, ``fused_policy_mix_step``
                       and ``fused_policy_buff_step`` of
                       ``repro.kernels.fused_step``.
``flash_attention`` -- blocked online-softmax attention with position masks;
                       replaces ``repro.kernels.flash_attention
                       .flash_attention_bhsd``.
``ops``             -- the model-facing GQA fold ``flash_attention``.
"""
