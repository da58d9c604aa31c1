"""Both sides of the FLOP parity of ``repro_torch.launch.dryrun`` (imported
by the ``test_torch_dryrun*`` files; not collected).

The reference's count is ``repro.launch.hlo_cost.analyze_hlo`` over the
optimized HLO of its step, lowered in this process on one CPU device with
``jax.jit(step).lower(...).compile()``.  ``repro.launch.dryrun`` and
``repro.launch.perf_probe`` are never imported here: at import they set
``XLA_FLAGS`` to 512 host devices, which would leak into every later test
of the worker.  The port's count is ``op_cost`` over ``dryrun.make_step``
on ``meta`` tensors.  Both sides take the chunked attention and one
worker.

Two products the reference counts and the port does not, both of the
Mamba2 trunk's training step (ROADMAP queue C):

* ``ssd_chunked``'s ``einsum("bcsh,bcshn,bcshp->bchpn", w, B, x)``: both
  contract ``w`` first with the operand of the smaller last dim (``N``
  or ``P``), an elementwise product; the gradient with respect to ``w``
  then sums that dim away.  XLA emits that sum as a ``dot_general``
  (batch b, c, s, h), which the reference counts; torch's autograd of the
  product is ``mul`` + ``sum``, which ``op_cost`` counts as 0, as the
  reference counts elementwise ops.  ``2 Bt S H min(N, P)`` a Mamba2
  layer;
* a hybrid group's recompute: the reference's remat re-runs the group's
  scan of Mamba2 layers whole, the last layer's ``out_proj`` too, whose
  output nothing in the backward pass reads; torch's non-reentrant
  checkpoint stops recomputing once the tensors the backward needs are
  back, so it never computes that product.  ``2 Bt S d_inner d_model`` a
  group.
"""
import jax
import jax.numpy as jnp

import repro.configs as jconfigs
from repro.configs.shapes import InputShape as JShape
from repro.configs.shapes import decode_window, uses_ring
from repro.launch import steps as jsteps
from repro.launch.hlo_cost import analyze_hlo
from repro.models import param_specs as j_param_specs
from repro_torch import configs as tconfigs
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import dryrun, op_cost


def configs(arch: str, reduced: bool, knobs=None):
    """Both packages' configs of ``arch`` (reduced or not), with the
    fields of ``knobs`` replaced in both."""
    j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    j, t = (j.reduced(), t.reduced()) if reduced else (j, t)
    return (j.replace(**knobs), t.replace(**knobs)) if knobs else (j, t)


def reference_hlo(arch: str, kind: str, seq: int, batch: int,
                  reduced: bool = True, knobs=None) -> str:
    cfg = configs(arch, reduced, knobs)[0]
    shape = JShape("parity", seq, batch, kind)
    specs = jconfigs.input_specs(cfg, shape)
    scalar = jax.ShapeDtypeStruct((), jnp.int32)
    if kind == "train":
        trainer = jsteps.make_trainer(cfg, n_workers=1)
        lowered = jax.jit(trainer.train_step).lower(
            trainer.state_specs(), specs["batch"], scalar)
    elif kind == "prefill":
        lowered = jax.jit(jsteps.make_prefill_step(cfg)).lower(
            j_param_specs(cfg), specs["batch"])
    else:
        step = jsteps.make_serve_step(cfg, window=decode_window(cfg, shape),
                                      ring=uses_ring(cfg, shape))
        lowered = jax.jit(step).lower(j_param_specs(cfg), specs["cache"],
                                      specs["token"], scalar)
    return lowered.compile().as_text()


def reference_flops(arch: str, kind: str, seq: int, batch: int,
                    reduced: bool = True, knobs=None) -> float:
    return analyze_hlo(reference_hlo(arch, kind, seq, batch, reduced,
                                     knobs)).flops


def port_trace(arch: str, kind: str, seq: int, batch: int,
               reduced: bool = True, knobs=None) -> op_cost.OpTrace:
    cfg = configs(arch, reduced, knobs)[1]
    mesh = dryrun.abstract_mesh((1, 1))
    step = dryrun.make_step(cfg, InputShape("parity", seq, batch, kind),
                            mesh)
    with mesh:
        return op_cost.trace(step.run)


def ssm_training_gap(arch: str, seq: int, batch: int,
                     reduced: bool = True) -> int:
    """The FLOPs the reference counts and the port does not in one
    training step (the module docstring); 0 but for the Mamba2 trunks."""
    cfg = configs(arch, reduced)[1]
    if cfg.family not in ("ssm", "hybrid"):
        return 0
    d_inner = cfg.ssm_expand * cfg.d_model
    heads = d_inner // cfg.ssm_head_dim
    tokens = batch * seq
    gap = cfg.n_layers * 2 * tokens * heads * min(cfg.ssm_state,
                                                  cfg.ssm_head_dim)
    if cfg.family == "hybrid":
        gap += cfg.n_layers // cfg.attn_every * 2 * tokens * d_inner \
            * cfg.d_model
    return gap
