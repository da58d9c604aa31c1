"""The fused per-event kernels of the solver inner loops (counterpart of
``repro.kernels.fused_step``).

One solver event is a window-sum gather from the circular cumulative-sum
buffer, the policy's step-size select, the push of the new cumulative sum,
and the update of the iterate:

* :func:`fused_policy_prox_step` -- PIAG/BCD, ``prox(x - gamma*g, gamma)``;
* :func:`fused_policy_mix_step` -- FedAsync, ``x + gamma*(xc - x)``;
* :func:`fused_policy_buff_step` -- FedBuff, ``delta += gamma*(xc - xw)``,
  ``x += agg*scale*delta``, ``delta *= (1 - agg)``.

On the card each runs as ONE launch of a hand-written CUDA kernel in
``csrc/fused_step.cu`` for all B cells (one thread block per cell, the cell
axis taking the place of the reference's ``vmap``).  On the CPU each
wrapper runs its ``*_ref`` twin, the same function in plain PyTorch ops,
composed from the real ``core.stepsize`` functions and the ``core.prox``
operators.

The step-size state is updated IN PLACE on both routes (the kernel touches
two buffer slots per cell instead of copying the (B, H) buffer); the
wrappers return ``(gamma, state, ...)`` as the reference does, with
``state`` holding the updated tensors.  The reference's compiled program
contracts the federated mix, delta accumulate and buffered apply into
FMAs; both routes compute them as ``fma32``.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.prox import Box, ElasticNet, GroupL2, L1, L2Squared, ProxOp, Zero
from ..core.stepsize import StepsizeState, _push, f32, fma32, window_sum
from .dispatch import current_stream_handle, kernel_route

__all__ = ["select_gamma", "select_gamma_total", "as_policy_params", "fused_leaf",
           "fused_policy_prox_step", "fused_policy_prox_step_ref",
           "fused_policy_mix_step", "fused_policy_mix_step_ref",
           "fused_policy_buff_step", "fused_policy_buff_step_ref",
           "boundary_bytes", "boundary_bytes_mix", "boundary_bytes_buff",
           "prox_code"]

# per cell: k, total, clipped read and written; tau; the four policy
# params; the pushed buffer slot
_STATE_BYTES = 4 * 3 * 2 + 4 + 4 * 4 + 4


def boundary_bytes(horizon: int, n: int, cells: int = 1,
                   reads_slot: int | None = None) -> int:
    """Bytes one ``fused_policy_prox_step`` launch must move for ``cells``
    cells of width ``n``: each input read once, each output written once.

    The state is updated in place, so of the ``(cells, horizon)`` buffer
    only the slots an event touches count: one write per cell, and one read
    per cell whose window starts after the first event (``reads_slot``
    cells; all cells when not given).  Every element is 4 bytes.
    """
    del horizon  # the in-place kernel never moves the whole buffer
    return _event_bytes(n, cells, reads_slot, vectors_in=2, vectors_out=1)


def boundary_bytes_mix(n: int, cells: int = 1,
                       reads_slot: int | None = None) -> int:
    """Bytes one ``fused_policy_mix_step`` launch must move: the state as
    in :func:`boundary_bytes`, plus ``x`` and ``xc`` read and ``x_new``
    written (float32, width ``n``) per cell."""
    return _event_bytes(n, cells, reads_slot, vectors_in=2, vectors_out=1)


def boundary_bytes_buff(n: int, cells: int = 1,
                        reads_slot: int | None = None) -> int:
    """Bytes one ``fused_policy_buff_step`` launch must move: the state as
    in :func:`boundary_bytes`, the ``agg`` flag, plus ``x``, ``xc``, ``xw``
    and ``delta`` read and ``x_new`` and ``delta_new`` written per cell."""
    return _event_bytes(n, cells, reads_slot, vectors_in=4, vectors_out=2,
                        scalars_in=1)


def _event_bytes(n, cells, reads_slot, vectors_in, vectors_out,
                 scalars_in=0) -> int:
    reads = cells if reads_slot is None else int(reads_slot)
    per_cell = (_STATE_BYTES + 4 + 4 * scalars_in
                + 4 * n * (vectors_in + vectors_out))  # + gamma out
    return cells * per_cell + 4 * reads


def select_gamma(policy_id, gamma_prime, c0, c1, ws, tau) -> torch.Tensor:
    """The six policy branches (ids: 0 fixed_like, 1 naive, 2 adaptive1,
    3 adaptive2, 4 hinge, 5 poly) as a ``where`` chain, each the branch
    expression of ``sweep.policies.ParamPolicy``."""
    return select_gamma_total(policy_id, gamma_prime, c0, c1, ws, tau,
                              None)[0]


def select_gamma_total(policy_id, gamma_prime, c0, c1, ws, tau, total,
                       fma_push: bool = False):
    """``(gamma, new_total)``: :func:`select_gamma` plus the pushed sum.

    The reference's compiled program contracts ``a * b + c`` into one FMA
    where the expression is visible to the compiler; the port computes those
    sums with ``fma32``.  That always holds for the hinge denominator
    ``c0 * max(t - c1, 0) + 1``.  For the push of a product-form gamma
    (adaptive1, hinge, poly: ``total + a * b``) it holds only where the
    policy is a compile-time constant -- a solo run of a concrete policy --
    and the port asks for it with ``fma_push=True``; with runtime
    ``PolicyParams`` (a sweep) the gamma passes through a select first and
    the push is ``total + gamma``.  ``total=None`` skips the push."""
    t = torch.as_tensor(tau, device=ws.device).to(torch.float32)
    zero = torch.zeros_like(ws)
    ones = torch.ones_like(t)
    g_fixed = torch.broadcast_to(c0, ws.shape)
    g_naive = gamma_prime / (t + c0)
    budget = torch.clamp(gamma_prime - ws, min=0.0)
    g_ad1 = c0 * budget
    cand = gamma_prime / (t + 1.0)
    g_ad2 = torch.where(cand <= gamma_prime - ws, cand, zero)
    hinge = torch.where(t <= c1, ones,
                        1.0 / fma32(c0, torch.clamp(t - c1, min=0.0), ones))
    poly = torch.pow(t + 1.0, -c0)
    gamma = torch.where(
        policy_id == 0, g_fixed, torch.where(
            policy_id == 1, g_naive, torch.where(
                policy_id == 2, g_ad1, torch.where(
                    policy_id == 3, g_ad2, torch.where(
                        policy_id == 4, gamma_prime * hinge,
                        gamma_prime * poly))))).to(torch.float32)
    if total is None:
        return gamma, None
    if not fma_push:
        return gamma, total + gamma
    a = torch.where(policy_id == 2, c0, gamma_prime)
    b = torch.where(policy_id == 2, budget,
                    torch.where(policy_id == 4, hinge, poly))
    product = (policy_id != 0) & (policy_id != 1) & (policy_id != 3)
    return gamma, torch.where(product, fma32(a, b, total), total + gamma)


def as_policy_params(policy, device=None):
    """``PolicyParams`` for any policy the fused engine can run; a loud
    ``TypeError`` for stateful policies (``AdaptiveLipschitz``)."""
    from ..sweep.policies import ParamPolicy, policy_params
    if isinstance(policy, ParamPolicy):
        return policy.params
    return policy_params(policy, device)


def fused_leaf(tree, what: str) -> torch.Tensor:
    """The single 1-D tensor the fused kernel moves as the iterate; a
    list/tuple of leaves or a tensor of another rank is refused loudly."""
    leaves = list(tree) if isinstance(tree, (list, tuple)) else [tree]
    if len(leaves) != 1 or not isinstance(leaves[0], torch.Tensor) \
            or leaves[0].ndim != 1:
        raise ValueError(
            f"engine='fused' requires the {what} to be a single 1-D array "
            f"leaf; got {len(leaves)} leaves with shapes "
            f"{[tuple(getattr(l, 'shape', ())) for l in leaves]} "
            "-- use engine='scan'")
    return leaves[0]


def prox_code(prox: ProxOp):
    """``(kind, p0, p1)`` of a prox operator for the kernel's static switch."""
    if isinstance(prox, Zero):
        return 0, 0.0, 0.0
    if isinstance(prox, L1):
        return 1, prox.lam, 0.0
    if isinstance(prox, L2Squared):
        return 2, prox.lam, 0.0
    if isinstance(prox, ElasticNet):
        return 3, prox.lam1, prox.lam2
    if isinstance(prox, Box):
        return 4, prox.lo, prox.hi
    if isinstance(prox, GroupL2):
        return 5, prox.lam, 0.0
    raise TypeError(f"the fused kernel has no prox op {type(prox).__name__}")


def _policy_update(params, state: StepsizeState, tau: torch.Tensor,
                   fma_push: bool) -> torch.Tensor:
    """The prologue all three plain versions share: window sum, policy
    select and push, written into ``state``'s tensors in place; returns
    gamma (B,)."""
    ws, clip = window_sum(state, tau)
    gamma, new_total = select_gamma_total(
        params.policy_id, params.gamma_prime, params.c0, params.c1, ws, tau,
        state.total, fma_push)
    new = _push(state, gamma, clip, new_total)
    for old, upd in zip(state, new):
        old.copy_(upd)
    return gamma


def fused_policy_prox_step_ref(params, prox: ProxOp, state: StepsizeState,
                               tau: torch.Tensor, x: torch.Tensor,
                               g: torch.Tensor, fma_push: bool = False):
    """Plain PyTorch version: ``policy.step`` + ``prox(x - gamma*g, gamma)``
    over (B,) cells, updating ``state`` in place like the kernel."""
    gamma = _policy_update(params, state, tau, fma_push)
    x_new = prox.prox(x - gamma.unsqueeze(-1) * g, gamma)
    return gamma, state, x_new


def fused_policy_mix_step_ref(params, state: StepsizeState,
                              tau: torch.Tensor, x: torch.Tensor,
                              xc: torch.Tensor, fma_push: bool = False):
    """Plain PyTorch version: ``policy.step`` + the FedAsync mix
    ``x + gamma*(xc - x)`` (contracted, as the reference computes it) over
    (B,) cells, updating ``state`` in place like the kernel."""
    gamma = _policy_update(params, state, tau, fma_push)
    return gamma, state, fma32(gamma.unsqueeze(-1), xc - x, x)


def fused_policy_buff_step_ref(params, state: StepsizeState,
                               tau: torch.Tensor, x: torch.Tensor,
                               xc: torch.Tensor, xw: torch.Tensor,
                               delta: torch.Tensor, agg: torch.Tensor,
                               scale, fma_push: bool = False):
    """Plain PyTorch version of one FedBuff event over (B,) cells:
    ``delta += gamma*(xc - xw)``; ``x += (agg*scale)*delta``;
    ``delta *= (1 - agg)``, the first two contracted as the reference
    computes them.  ``scale`` is rounded to float32 first.  Returns
    ``(gamma, state, x_new, delta_new)``; ``state`` is updated in place."""
    gamma = _policy_update(params, state, tau, fma_push)
    d_acc = fma32(gamma.unsqueeze(-1), xc - xw, delta)
    step = (agg * f32(scale, agg)).unsqueeze(-1)
    x_new = fma32(step, d_acc, x)
    return gamma, state, x_new, (1.0 - agg).unsqueeze(-1) * d_acc


_ARGTYPES = {
    # name: (pointer args, trailing int/float args)
    "fused_policy_prox_step_launch": (13, "iiiiffi"),
    "fused_policy_mix_step_launch": (13, "iiii"),
    "fused_policy_buff_step_launch": (17, "iiifi"),
    "fused_step_floor_launch": (0, "i"),
}

_I32, _F32 = torch.int32, torch.float32
# what each launch reads, in the launcher's order: (name, dtype, shape),
# shape 0 = (B,), 1 = (B, H), 2 = (B, d)
_STATE_SPEC = (("policy_id", _I32, 0), ("gamma_prime", _F32, 0),
               ("c0", _F32, 0), ("c1", _F32, 0), ("tau", _I32, 0),
               ("k", _I32, 0), ("total", _F32, 0), ("cumbuf", _F32, 1),
               ("clipped", _I32, 0))
_PROX_SPEC = _STATE_SPEC + (("x", _F32, 2), ("g", _F32, 2))
_MIX_SPEC = _STATE_SPEC + (("x", _F32, 2), ("xc", _F32, 2))
_BUFF_SPEC = _STATE_SPEC + (("agg", _F32, 0), ("x", _F32, 2),
                            ("xc", _F32, 2), ("xw", _F32, 2),
                            ("delta", _F32, 2))

_FNS: dict = {}


def _fns() -> dict:
    """The launchers of the built library, by name, with their C types
    (built and bound at the first launch)."""
    if not _FNS:
        from .build import load
        lib = load("fused_step").lib
        codes = {"i": ctypes.c_int, "f": ctypes.c_float}
        fns = {}
        for name, (n_ptr, tail) in _ARGTYPES.items():
            fn = fns[name] = getattr(lib, name)
            fn.argtypes = ([ctypes.c_void_p] * n_ptr
                           + [codes[c] for c in tail] + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        err = fns["error_string"] = lib.fused_step_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _FNS.update(fns)
    return _FNS


def _card_pointers(kernel: str, spec, tensors, B: int, d: int,
                   H: int) -> list:
    """Raise unless each of a launch's tensors (on one card, as
    ``kernel_route`` found) is the contiguous dtype and shape the kernel
    reads (``spec``: (B,) params, tau and state scalars, (B, H) buffer,
    (B, d) vectors); return their data pointers in order."""
    shapes = ((B,), (B, H), (B, d))
    ptrs = []
    for (name, dtype, s), t in zip(spec, tensors):
        shape = shapes[s]
        if t.dtype is not dtype or t.shape != shape or not t.is_contiguous():
            raise ValueError(
                f"{kernel}: {name} must be a contiguous {dtype} tensor of "
                f"shape {shape}; got {t.dtype} {tuple(t.shape)} "
                f"contiguous={t.is_contiguous()}")
        ptrs.append(t.data_ptr())
    return ptrs


def _launch(kernel: str, dev: int, *args) -> None:
    """Call ``<kernel>_launch`` on device ``dev``'s current stream; raise on
    its code."""
    fns = _fns()
    fn = fns[f"{kernel}_launch"]
    if dev == torch.cuda.current_device():
        code = fn(*args, current_stream_handle(dev))
    else:
        with torch.cuda.device(dev):
            code = fn(*args, current_stream_handle(dev))
    if code != 0:
        raise RuntimeError(
            f"{kernel} launch failed: "
            f"{fns['error_string'](code).decode()} ({code})")


def fused_policy_prox_step(params, prox: ProxOp, state: StepsizeState,
                           tau: torch.Tensor, x: torch.Tensor,
                           g: torch.Tensor, fma_push: bool = False):
    """One fused PIAG/BCD event for B cells.

    ``params``: ``PolicyParams`` of (B,) tensors; ``state``: (B,)-batched
    ``StepsizeState`` (updated in place); ``tau``: (B,) int32; ``x``, ``g``:
    (B, d) float32; ``fma_push`` as in :func:`select_gamma_total`.
    Returns ``(gamma (B,), state, x_new (B, d))``.  CUDA
    tensors launch the kernel (one block per cell); CPU tensors run
    :func:`fused_policy_prox_step_ref`.
    """
    tensors = (*params, tau, *state, x, g)
    if kernel_route(*tensors) == "plain":
        return fused_policy_prox_step_ref(params, prox, state, tau, x, g,
                                          fma_push)
    B, d = x.shape
    H = state.horizon
    kind, p0, p1 = prox_code(prox)
    ptrs = _card_pointers("fused_policy_prox_step", _PROX_SPEC, tensors, B,
                          d, H)
    x_new = torch.empty_like(x)
    gamma = torch.empty((B,), dtype=_F32, device=x.device)
    _launch("fused_policy_prox_step", x.get_device(), *ptrs,
            x_new.data_ptr(), gamma.data_ptr(), B, d, H, kind, p0, p1,
            int(fma_push))
    fused_policy_prox_step.launches += 1
    return gamma, state, x_new


def fused_policy_mix_step(params, state: StepsizeState, tau: torch.Tensor,
                          x: torch.Tensor, xc: torch.Tensor,
                          fma_push: bool = False):
    """One fused FedAsync server event for B cells: ``policy.step`` + the
    mix ``x + gamma*(xc - x)``.

    Arguments as in :func:`fused_policy_prox_step`, with ``xc`` (B, d) the
    uploaded client models.  Returns ``(gamma (B,), state, x_new (B, d))``.
    CUDA tensors launch the kernel (one block per cell); CPU tensors run
    :func:`fused_policy_mix_step_ref`.
    """
    tensors = (*params, tau, *state, x, xc)
    if kernel_route(*tensors) == "plain":
        return fused_policy_mix_step_ref(params, state, tau, x, xc, fma_push)
    B, d = x.shape
    H = state.horizon
    ptrs = _card_pointers("fused_policy_mix_step", _MIX_SPEC, tensors, B, d,
                          H)
    x_new = torch.empty_like(x)
    gamma = torch.empty((B,), dtype=_F32, device=x.device)
    _launch("fused_policy_mix_step", x.get_device(), *ptrs, x_new.data_ptr(),
            gamma.data_ptr(), B, d, H, int(fma_push))
    fused_policy_mix_step.launches += 1
    return gamma, state, x_new


def fused_policy_buff_step(params, state: StepsizeState, tau: torch.Tensor,
                           x: torch.Tensor, xc: torch.Tensor,
                           xw: torch.Tensor, delta: torch.Tensor,
                           agg: torch.Tensor, scale, fma_push: bool = False):
    """One fused FedBuff server event for B cells: ``policy.step``, then
    ``delta += gamma*(xc - xw)``, ``x += agg*scale*delta`` and
    ``delta *= (1 - agg)``.

    ``xw`` (B, d) are the models the uploading clients read, ``delta``
    (B, d) the buffered deltas, ``agg`` (B,) float32 the 0/1 aggregation
    flags and ``scale = eta / buffer_size`` a number, rounded to float32
    before any use.  Returns ``(gamma (B,), state, x_new, delta_new)``.
    CUDA tensors launch the kernel (one block per cell); CPU tensors run
    :func:`fused_policy_buff_step_ref`.
    """
    tensors = (*params, tau, *state, agg, x, xc, xw, delta)
    if kernel_route(*tensors) == "plain":
        return fused_policy_buff_step_ref(params, state, tau, x, xc, xw,
                                          delta, agg, scale, fma_push)
    B, d = x.shape
    H = state.horizon
    ptrs = _card_pointers("fused_policy_buff_step", _BUFF_SPEC, tensors, B,
                          d, H)
    x_new = torch.empty_like(x)
    delta_new = torch.empty_like(delta)
    gamma = torch.empty((B,), dtype=_F32, device=x.device)
    # the c_float argument rounds scale to float32, as np.float32 would
    _launch("fused_policy_buff_step", x.get_device(), *ptrs,
            x_new.data_ptr(), delta_new.data_ptr(), gamma.data_ptr(), B, d,
            H, float(scale), int(fma_push))
    fused_policy_buff_step.launches += 1
    return gamma, state, x_new, delta_new


def _launch_floor(B: int) -> None:
    """Launch the empty kernel with B1's grid (``B`` blocks of 256 threads)
    on the current card's current stream: the launch floor the event
    kernels are timed against (measurement code only; it counts
    nothing)."""
    _launch("fused_step_floor", torch.cuda.current_device(), B)


# kernel launches since the last reset (the wrappers count only launches)
fused_policy_prox_step.launches = 0
fused_policy_mix_step.launches = 0
fused_policy_buff_step.launches = 0
