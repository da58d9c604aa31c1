"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

``dispatch``   -- the device rule (cuda by default, cpu only when asked).
``build``      -- nvcc build of ``csrc/*.cu`` into ctypes-loaded libraries.
``fused_step`` -- the fused policy + prox event step (replaces the TPU
                  kernel ``repro.kernels.fused_step.fused_policy_prox_step``).
"""
