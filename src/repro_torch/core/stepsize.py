"""Delay-adaptive step-size policies (Wu et al., 2022) on torch tensors.

Counterpart of ``repro.core.stepsize``.  The general principle (Eq. 8)

    0 <= gamma_k <= max(0, gamma' - sum_{t=k-tau_k}^{k-1} gamma_t)

and the same eight concrete policies (fixed, Sun-Deng, Davis, naive,
adaptive1, adaptive2, hinge, poly) plus ``AdaptiveLipschitz``.  The window
sum comes from a circular buffer of cumulative sums: ``buf[(j-1) % H]``
stores ``S_j = sum_{t<j} gamma_t`` so ``window_sum(k, tau) = S_k - S_{k-tau}``;
delays beyond ``H - 1`` are clipped and counted.

Arithmetic is float32 throughout and follows the reference expression by
expression: Python-float policy constants enter as float32 scalars (JAX's
weak typing), the fixed family's per-step constant is computed in float64
and rounded once, and where the reference's compiled program fuses
``a * b + c`` into one FMA the port rounds it once too (``fma32``).
Policies are functional on a ``StepsizeState`` whose leaves may carry
leading cell axes (``init_state(batch_shape=...)``).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import ClassVar, NamedTuple, Tuple

import numpy as np
import torch

from ..kernels.dispatch import resolve_device

DEFAULT_HORIZON = 4096


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (>= 1)."""
    return 1 << (max(int(n), 1) - 1).bit_length()


def auto_horizon(tau_bar: int, slack: int = 1) -> int:
    """Smallest power-of-two buffer representing every observed delay with
    ``slack`` headroom (the largest representable delay is ``H - 1``)."""
    if slack < 1:
        raise ValueError(f"auto-horizon slack must be >= 1, got {slack}")
    return max(2, next_pow2(int(tau_bar) + int(slack)))


class StepsizeState(NamedTuple):
    """Policy carry.

    k:        iteration counter (int32, batch shape).
    total:    S_k, the sum of all step-sizes so far (float32, batch shape).
    cumbuf:   circular buffer, ``cumbuf[..., (j-1) % H] = S_j`` (float32).
    clipped:  number of delays that exceeded the horizon (int32).
    """

    k: torch.Tensor
    total: torch.Tensor
    cumbuf: torch.Tensor
    clipped: torch.Tensor

    @property
    def horizon(self) -> int:
        return int(self.cumbuf.shape[-1])


def init_state(horizon: int = DEFAULT_HORIZON,
               batch_shape: Tuple[int, ...] = (),
               device=None) -> StepsizeState:
    """Fresh policy state; ``batch_shape`` prepends cell dimensions."""
    dev = resolve_device(device)
    shape = tuple(batch_shape)
    return StepsizeState(
        k=torch.zeros(shape, dtype=torch.int32, device=dev),
        total=torch.zeros(shape, dtype=torch.float32, device=dev),
        cumbuf=torch.zeros(shape + (int(horizon),), dtype=torch.float32,
                           device=dev),
        clipped=torch.zeros(shape, dtype=torch.int32, device=dev),
    )


def f32(value, like: torch.Tensor) -> torch.Tensor:
    """A Python number as a float32 scalar tensor on ``like``'s device (the
    rounding JAX applies to a weakly typed constant).  A tensor, not a
    Python scalar, because PyTorch divides by a Python scalar as a multiply
    by its reciprocal on CUDA, which rounds differently."""
    return torch.full((), float(np.float32(value)), dtype=torch.float32,
                      device=like.device)


def _as_tau(tau, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(tau, dtype=torch.int32, device=like.device)


def window_sum(state: StepsizeState, tau) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sum_{t=k-tau}^{k-1} gamma_t, was_clipped)``.

    ``tau`` is clipped to ``[0, min(k, H-1)]``: at ``tau = H`` the read slot
    ``(k - tau - 1) % H`` would collide with the slot just written with
    ``S_k``, so the cap is ``H - 1`` and the overflow is flagged.
    """
    H = state.horizon
    k = state.k
    tau = _as_tau(tau, k)
    cap = torch.clamp(k, max=H - 1)
    tau_c = torch.minimum(torch.clamp(tau, min=0), cap)
    was_clipped = (tau > cap).to(torch.int32)
    j = k - tau_c
    slot = ((j - 1) % H).to(torch.int64)
    s_read = torch.gather(state.cumbuf, -1, slot.unsqueeze(-1)).squeeze(-1)
    s_j = torch.where(j <= 0, torch.zeros_like(s_read), s_read)
    return state.total - s_j, was_clipped


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded ONCE to float32, a correctly rounded FMA, the way
    the reference's compiled program contracts it (and ``__fmaf_rn`` in the
    CUDA kernels).

    The float32 product is exact in float64.  The float64 sum is rounded to
    odd (TwoSum gives its error; an inexact sum with an even last bit steps
    one ulp toward the exact value), and a float64 rounded to odd rounds to
    float32 exactly as the exact value would, since 53 >= 24 + 2 bits."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)
    even = (s.view(torch.int64) & 1) == 0
    step = (err != 0) & even & torch.isfinite(s)
    toward = torch.copysign(torch.full_like(s, float("inf")), err)
    return torch.where(step, torch.nextafter(s, toward), s).float()


def _push(state: StepsizeState, gamma: torch.Tensor,
          was_clipped: torch.Tensor,
          new_total: torch.Tensor | None = None) -> StepsizeState:
    """Append ``S_{k+1} = total + gamma`` (or the caller's ``new_total``,
    where the reference contracts the sum into an FMA) at slot ``k % H``."""
    H = state.horizon
    if new_total is None:
        new_total = state.total + gamma
    slot = (state.k % H).to(torch.int64).unsqueeze(-1)
    cumbuf = state.cumbuf.scatter(-1, slot, new_total.unsqueeze(-1))
    return StepsizeState(k=state.k + 1, total=new_total, cumbuf=cumbuf,
                         clipped=state.clipped + was_clipped)


def _tau_f32(tau, like: torch.Tensor) -> torch.Tensor:
    return _as_tau(tau, like).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class StepsizePolicy:
    """Base class.  ``gamma_prime`` is gamma' = h/L (or h/Lhat for BCD)."""

    gamma_prime: float

    # True on policies whose gamma consumes the window sum; only those
    # report clipped delays from ``run``
    uses_window: ClassVar[bool] = False

    def init(self, horizon: int = DEFAULT_HORIZON, batch_shape=(),
             device=None) -> StepsizeState:
        return init_state(horizon, batch_shape, device)

    def _gamma_total(self, state: StepsizeState, tau):
        """``(gamma, was_clipped, new_total)``; ``new_total`` is None when it
        is the plain sum ``total + gamma``.  Families whose gamma is a
        product a * b return ``fma32(a, b, total)``: the reference's
        compiled program contracts the push of such a gamma into an FMA."""
        raise NotImplementedError

    def step(self, state: StepsizeState, tau) -> Tuple[torch.Tensor, StepsizeState]:
        """Consume the observed delay ``tau_k`` and emit ``gamma_k``."""
        gamma, was_clipped, new_total = self._gamma_total(state, tau)
        gamma = gamma.to(torch.float32).expand(state.k.shape)
        return gamma, _push(state, gamma, was_clipped, new_total)

    def run(self, taus, device=None) -> torch.Tensor:
        """The step-size sequence for a delay trace, with the buffer sized
        from the trace's own largest delay; clipped delays (``tau > k``) are
        reported through a ``RuntimeWarning``."""
        taus = torch.as_tensor(np.asarray(taus), dtype=torch.int32)
        state = self.init(_run_horizon(taus), device=device)
        gammas = []
        for tau in taus.to(state.k.device):
            g, state = self.step(state, tau)
            gammas.append(g)
        if self.uses_window:
            _warn_clipped(state, type(self).__name__)
        return torch.stack(gammas) if gammas else \
            torch.zeros((0,), dtype=torch.float32, device=state.k.device)


def _full(value: float, state: StepsizeState) -> torch.Tensor:
    return f32(value, state.total).expand(state.total.shape)


@dataclasses.dataclass(frozen=True)
class FixedStepSize(StepsizePolicy):
    """gamma_k = gamma' / (tau_bound + 1).  Requires the worst-case bound."""

    tau_bound: int = 0

    def _gamma_total(self, state, tau):
        _, clip = window_sum(state, tau)  # keep the buffer diagnostics uniform
        return _full(self.gamma_prime / (self.tau_bound + 1), state), clip, None


@dataclasses.dataclass(frozen=True)
class SunDengFixed(StepsizePolicy):
    """gamma_k = h/(L (tau + 1/2)) per [Sun et al. '19; Deng et al. '20]."""

    tau_bound: int = 0

    def _gamma_total(self, state, tau):
        _, clip = window_sum(state, tau)
        return _full(self.gamma_prime / (self.tau_bound + 0.5), state), clip, None


@dataclasses.dataclass(frozen=True)
class DavisFixed(StepsizePolicy):
    """Async-BCD baseline gamma_k = h / (Lhat + 2 L tau / sqrt(m)) [Davis'16]."""

    tau_bound: int = 0
    ratio: float = 2.0

    def _gamma_total(self, state, tau):
        _, clip = window_sum(state, tau)
        g = self.gamma_prime / (1.0 + self.ratio * self.tau_bound)
        return _full(g, state), clip, None


@dataclasses.dataclass(frozen=True)
class NaiveAdaptive(StepsizePolicy):
    """The failing natural extension gamma_k = c/(tau_k + b)  (Eq. 7)."""

    b: float = 1.0

    def _gamma_total(self, state, tau):
        _, clip = window_sum(state, tau)
        t = _tau_f32(tau, state.k)
        return f32(self.gamma_prime, t) / (t + f32(self.b, t)), clip, None


@dataclasses.dataclass(frozen=True)
class Adaptive1(StepsizePolicy):
    """Eq. (13): gamma_k = alpha * max(gamma' - window_sum, 0)."""

    alpha: float = 0.9
    uses_window: ClassVar[bool] = True

    def _gamma_total(self, state, tau):
        ws, clip = window_sum(state, tau)
        budget = torch.clamp(f32(self.gamma_prime, ws) - ws, min=0.0)
        alpha = f32(self.alpha, ws)
        return alpha * budget, clip, fma32(alpha, budget, state.total)


@dataclasses.dataclass(frozen=True)
class Adaptive2(StepsizePolicy):
    """Eq. (14): gamma'/(tau_k+1) gated by the remaining window budget."""

    uses_window: ClassVar[bool] = True

    def _gamma_total(self, state, tau):
        ws, clip = window_sum(state, tau)
        t = _tau_f32(tau, state.k)
        gp = f32(self.gamma_prime, ws)
        cand = gp / (t + 1.0)
        gamma = torch.where(cand <= gp - ws, cand, torch.zeros_like(cand))
        return gamma, clip, None


@dataclasses.dataclass(frozen=True)
class HingeWeight(StepsizePolicy):
    """FedAsync hinge staleness weight [Xie et al. '19]:
    gamma' * s(tau), s = 1 for tau <= b, else 1 / (a (tau - b) + 1)."""

    a: float = 10.0
    b: float = 4.0

    def _gamma_total(self, state, tau):
        _, clip = window_sum(state, tau)
        t = _tau_f32(tau, state.k)
        b = f32(self.b, t)
        ones = torch.ones_like(t)
        s = torch.where(t <= b, ones, 1.0 / fma32(
            f32(self.a, t), torch.clamp(t - b, min=0.0), ones))
        gp = f32(self.gamma_prime, t)
        return gp * s, clip, fma32(gp, s, state.total)


@dataclasses.dataclass(frozen=True)
class PolyWeight(StepsizePolicy):
    """FedAsync polynomial staleness weight gamma' * (tau_k + 1)^(-a)."""

    a: float = 0.5

    def _gamma_total(self, state, tau):
        _, clip = window_sum(state, tau)
        t = _tau_f32(tau, state.k)
        gp = f32(self.gamma_prime, t)
        p = torch.pow(t + 1.0, -f32(self.a, t))
        return gp * p, clip, fma32(gp, p, state.total)


class LipschitzState(NamedTuple):
    """StepsizeState extended with an on-line curvature estimate."""

    ss: StepsizeState
    L_est: torch.Tensor
    have_prev: torch.Tensor


@dataclasses.dataclass(frozen=True)
class AdaptiveLipschitz(StepsizePolicy):
    """Beyond the paper (its §5 future work): gamma' = h / L_est with L_est a
    running max of secant curvature samples, under the Eq. (8) budget.

    Stateful, so it has no ``PolicyParams`` form: the fused engine and the
    sweeps reject it loudly."""

    h: float = 0.9
    alpha: float = 0.9
    decay: float = 1.0
    uses_window: ClassVar[bool] = True

    def init(self, horizon: int = DEFAULT_HORIZON, batch_shape=(),
             device=None) -> LipschitzState:
        ss = init_state(horizon, batch_shape, device)
        L0 = f32(self.h / max(self.gamma_prime, 1e-30), ss.total)
        return LipschitzState(ss=ss, L_est=L0.expand(ss.total.shape).clone(),
                              have_prev=torch.zeros_like(ss.k, dtype=torch.bool))

    def observe_curvature(self, state: LipschitzState, dg_norm, dx_norm
                          ) -> LipschitzState:
        """Feed ||g_k - g_{k-1}|| and ||x_k - x_{k-1}||."""
        eps = f32(1e-30, state.L_est)
        sec = torch.where(dx_norm > eps, dg_norm / torch.maximum(dx_norm, eps),
                          torch.zeros_like(dg_norm))
        L_new = torch.maximum(state.L_est * f32(self.decay, eps), sec)
        return state._replace(L_est=torch.maximum(L_new, eps),
                              have_prev=torch.ones_like(state.have_prev))

    def step(self, state: LipschitzState, tau):  # type: ignore[override]
        gp = f32(self.h, state.L_est) / state.L_est
        ws, clip = window_sum(state.ss, tau)
        alpha = f32(self.alpha, ws)
        budget = torch.clamp(gp - ws, min=0.0)
        gamma = alpha * budget
        return gamma, state._replace(ss=_push(
            state.ss, gamma, clip, fma32(alpha, budget, state.ss.total)))

    def run(self, taus, device=None) -> torch.Tensor:
        taus = torch.as_tensor(np.asarray(taus), dtype=torch.int32)
        state = self.init(_run_horizon(taus), device=device)
        gammas = []
        for tau in taus.to(state.L_est.device):
            g, state = self.step(state, tau)
            gammas.append(g)
        _warn_clipped(state, type(self).__name__)
        return torch.stack(gammas)


def _run_horizon(taus: torch.Tensor) -> int:
    """``auto_horizon`` of the trace's own largest delay."""
    tau_max = int(taus.max()) if taus.numel() else 0
    return auto_horizon(max(tau_max, 0))


def _warn_clipped(state, name: str) -> None:
    n = int(clipped_count(state))
    if n:
        warnings.warn(
            f"{name}.run: {n} event(s) carried a delay exceeding the "
            f"available history (tau > min(k, H - 1)); their window sums "
            f"were clamped to the full recorded sum",
            RuntimeWarning, stacklevel=3)


def clipped_count(state) -> torch.Tensor:
    """The horizon-clip counter of a final ``StepsizeState`` or
    ``LipschitzState``."""
    if isinstance(state, LipschitzState):
        state = state.ss
    return state.clipped


def clip_delta(old, new) -> torch.Tensor:
    """Per-event clip flag of the transition ``old -> new``."""
    return clipped_count(new) - clipped_count(old)


POLICIES = {
    "fixed": FixedStepSize,
    "constant": FixedStepSize,   # tau_bound=0 -> gamma_k = gamma'
    "sun_deng": SunDengFixed,
    "davis": DavisFixed,
    "naive": NaiveAdaptive,
    "adaptive1": Adaptive1,
    "adaptive2": Adaptive2,
    "adaptive_lipschitz": AdaptiveLipschitz,
    "hinge": HingeWeight,
    "poly": PolyWeight,
}


def make_policy(name: str, gamma_prime: float, **kwargs) -> StepsizePolicy:
    try:
        cls = POLICIES[name]
    except KeyError as e:
        raise ValueError(f"unknown step-size policy {name!r}; options: {sorted(POLICIES)}") from e
    return cls(gamma_prime=gamma_prime, **kwargs)
