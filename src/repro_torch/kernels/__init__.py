"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions
(counterpart of ``repro.kernels``).

``dispatch``        -- the device rule (cuda by default, cpu only when asked).
``build``           -- nvcc build of ``csrc/*.cu`` into ctypes-loaded
                       libraries.
``fused_step``      -- the fused per-event steps: policy + prox (PIAG),
                       policy + mix (FedAsync), policy + buffer step
                       (FedBuff); they replace the TPU kernels
                       ``fused_policy_prox_step``, ``fused_policy_mix_step``
                       and ``fused_policy_buff_step`` of
                       ``repro.kernels.fused_step`` (B1-B3).
``flash_attention`` -- blocked online-softmax attention with position masks;
                       replaces ``repro.kernels.flash_attention
                       .flash_attention_bhsd`` (B6).
``prox_step``       -- the fused prox-gradient update ``prox_step`` (B4).
``rmsnorm``         -- fused RMSNorm (B5).
``ssd_scan``        -- the Mamba2 SSD intra-chunk compute (B7).
``ops``             -- the public entry points: ``flash_attention`` (the GQA
                       fold), ``ssd_scan_pallas`` (B7 plus the cross-chunk
                       combine), ``prox_step``, ``prox_step_tree`` and
                       ``rmsnorm_fused``.
``ref``             -- the plain versions under the names of
                       ``repro.kernels.ref``.

The reference's ``default_interpret`` and ``resolve_interpret`` have no
counterpart: the port has no interpreter, and ``dispatch.resolve_device``
and ``dispatch.kernel_route`` take their place.

The names below load on first use, so that ``import
repro_torch.kernels.dispatch`` (which every entry point does) stays light
and does not import ``core`` back.  Two names differ in kind from the
reference's, where they are functions: ``flash_attention`` and
``prox_step`` are the B6 and B4 modules of those names (importing a
submodule binds its name in the package, so it cannot also be a lazily
bound function).  The entry points are ``ops.flash_attention`` and
``ops.prox_step``.
"""
import importlib

_NAMES = {
    "ops": ("ops", None), "ref": ("ref", None),
    "flash_attention": ("flash_attention", None),
    "prox_step": ("prox_step", None),
    "prox_step_tree": ("ops", "prox_step_tree"),
    "rmsnorm_fused": ("ops", "rmsnorm_fused"),
    "ssd_scan_pallas": ("ops", "ssd_scan_pallas"),
    "fused_policy_prox_step": ("fused_step", "fused_policy_prox_step"),
    "fused_policy_mix_step": ("fused_step", "fused_policy_mix_step"),
    "fused_policy_buff_step": ("fused_step", "fused_policy_buff_step"),
}
__all__ = list(_NAMES)


def __getattr__(name):
    if name in _NAMES:
        module, attr = _NAMES[name]
        mod = importlib.import_module(f".{module}", __name__)
        value = mod if attr is None else getattr(mod, attr)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
