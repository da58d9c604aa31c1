"""The plain PyTorch versions of the kernels under the names of
``repro.kernels.ref`` (each is defined beside its kernel).

``prox_step_ref`` and ``rmsnorm_ref`` are the port's plain versions, the
kernels' own arithmetic: ``prox_step_ref`` computes ``x - gamma*g`` as one
FMA and returns ``x``'s dtype, as the reference's *kernel* does (the
reference's oracle of the same name is unfused and returns float32 for
bfloat16 inputs); ``rmsnorm_ref`` takes ``1 / sqrt`` with IEEE roundings.
"""
from .flash_attention import NEG_INF
from .flash_attention import flash_attention_bhsd_ref as flash_attention_ref
from .prox_step import prox_step_ref
from .rmsnorm import rmsnorm_ref
from .ssd_scan import ssd_intra_ref

__all__ = ["NEG_INF", "prox_step_ref", "flash_attention_ref",
           "ssd_intra_ref", "rmsnorm_ref"]
