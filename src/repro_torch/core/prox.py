"""Proximal operators for P(x) = f(x) + R(x) (counterpart of
``repro.core.prox``).

Each ``ProxOp`` has ``value(x) = R(x)`` and ``prox(x, gamma) = argmin_y
R(y) + ||y - x||^2 / (2 gamma)`` in closed form.  The iterate is one 1-D
leaf: ``x`` is ``(d,)`` or ``(..., d)`` with leading cell axes, ``gamma``
has the leading shape (one step-size per cell), ``value`` reduces over the
last axis, and ``GroupL2`` treats each cell's leaf as one group.  Python
constants enter as float32, as they do in the reference.
"""
from __future__ import annotations

import dataclasses

import torch

from .stepsize import f32


def _per_cell(gamma, x: torch.Tensor) -> torch.Tensor:
    """``gamma`` (leading shape of ``x``) broadcast against ``x``."""
    g = torch.as_tensor(gamma, dtype=torch.float32, device=x.device)
    return g.reshape(g.shape + (1,) * (x.ndim - g.ndim))


def _soft(v: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.sign(v) * torch.clamp(torch.abs(v) - t, min=0.0)


@dataclasses.dataclass(frozen=True)
class ProxOp:
    def value(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def prox(self, x: torch.Tensor, gamma) -> torch.Tensor:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Zero(ProxOp):
    """R = 0 (smooth problems)."""

    def value(self, x):
        return torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)

    def prox(self, x, gamma):
        return x


@dataclasses.dataclass(frozen=True)
class L1(ProxOp):
    """R(x) = lam * ||x||_1; prox = soft threshold."""

    lam: float = 1e-4

    def value(self, x):
        return f32(self.lam, x) * torch.sum(torch.abs(x), dim=-1)

    def prox(self, x, gamma):
        return _soft(x, _per_cell(gamma, x) * f32(self.lam, x))


@dataclasses.dataclass(frozen=True)
class L2Squared(ProxOp):
    """R(x) = (lam/2)||x||^2; prox = shrink by 1/(1 + gamma lam)."""

    lam: float = 1e-4

    def value(self, x):
        return 0.5 * f32(self.lam, x) * torch.sum(torch.square(x), dim=-1)

    def prox(self, x, gamma):
        return x / (1.0 + _per_cell(gamma, x) * f32(self.lam, x))


@dataclasses.dataclass(frozen=True)
class ElasticNet(ProxOp):
    """R(x) = lam1 ||x||_1 + (lam2/2)||x||^2."""

    lam1: float = 1e-4
    lam2: float = 1e-4

    def value(self, x):
        return (f32(self.lam1, x) * torch.sum(torch.abs(x), dim=-1)
                + 0.5 * f32(self.lam2, x) * torch.sum(torch.square(x), dim=-1))

    def prox(self, x, gamma):
        g = _per_cell(gamma, x)
        t = g * f32(self.lam1, x)
        s = 1.0 + g * f32(self.lam2, x)
        return _soft(x, t) / s


@dataclasses.dataclass(frozen=True)
class Box(ProxOp):
    """Indicator of the box [lo, hi]^d; prox = projection (clip)."""

    lo: float = -1.0
    hi: float = 1.0

    def value(self, x):
        viol = torch.sum(torch.clamp(f32(self.lo, x) - x, min=0.0)
                         + torch.clamp(x - f32(self.hi, x), min=0.0), dim=-1)
        return torch.where(viol > 0, torch.full_like(viol, float("inf")),
                           torch.zeros_like(viol))

    def prox(self, x, gamma):
        del gamma  # projection is step-size independent
        return torch.clamp(x, f32(self.lo, x), f32(self.hi, x))


@dataclasses.dataclass(frozen=True)
class GroupL2(ProxOp):
    """R(x) = lam * ||x||_2 per cell leaf (block soft-threshold)."""

    lam: float = 1e-4

    def value(self, x):
        return f32(self.lam, x) * torch.linalg.vector_norm(x, dim=-1)

    def prox(self, x, gamma):
        t = _per_cell(gamma, x) * f32(self.lam, x)
        n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        scale = torch.clamp(1.0 - t / torch.clamp(n, min=1e-30), min=0.0)
        return scale * x


PROX_OPS = {
    "none": Zero,
    "l1": L1,
    "l2": L2Squared,
    "elastic_net": ElasticNet,
    "box": Box,
    "group_l2": GroupL2,
}


def make_prox(name: str, **kwargs) -> ProxOp:
    try:
        cls = PROX_OPS[name]
    except KeyError as e:
        raise ValueError(f"unknown prox {name!r}; options: {sorted(PROX_OPS)}") from e
    return cls(**kwargs)
