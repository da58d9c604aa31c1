"""Benchmark problems (counterpart of ``repro.core.problems``):
l1-regularized logistic regression (the paper's §4 workload, rcv1-like
sparse and MNIST-like dense synthetic data) and the lasso.

The data generators are the reference's numpy code verbatim, so the same
seed gives bitwise-equal data; the arrays then move to the device as
float32 tensors.  Every function of an iterate accepts ``(d,)`` or
``(B, d)`` (one row per cell) and returns one value per row.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..kernels.dispatch import resolve_device
from .stepsize import f32


def worker_rms_smoothness(A: np.ndarray, n_workers: int, denom_scale: float,
                          shift: float = 0.0) -> float:
    """RMS of per-shard smoothness constants over an n-way contiguous sample
    split: L_i = lambda_max(A_i^T A_i) / (denom_scale * N_i) + shift."""
    n = n_workers
    N = (A.shape[0] // n) * n
    shards = A[:N].reshape(n, -1, A.shape[1])
    Ls = [power_iteration_sq(shards[i]) / (denom_scale * shards[i].shape[0]) + shift
          for i in range(n)]
    return float(np.sqrt(np.mean(np.square(Ls))))


def power_iteration_sq(A: np.ndarray, iters: int = 200, seed: int = 0) -> float:
    """lambda_max(A^T A) via power iteration."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(A.shape[1],))
    v /= np.linalg.norm(v)
    lam = 0.0
    for _ in range(iters):
        w = A.T @ (A @ v)
        lam = float(np.linalg.norm(w))
        if lam == 0.0:
            return 0.0
        v = w / lam
    return lam


def _logaddexp0(v: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(v)), the reference's ``logaddexp(0, v)``."""
    return torch.logaddexp(torch.zeros_like(v), v)


@dataclasses.dataclass(frozen=True, eq=False)
class LogRegProblem:
    """f(x) = (1/N) sum_i log(1 + exp(-b_i a_i^T x)) + (lam2/2)||x||^2,
    R(x) = lam1 ||x||_1."""

    A: torch.Tensor          # (N, d) float32
    b: torch.Tensor          # (N,) in {-1, +1}
    lam1: float
    lam2: float
    L: float                 # sqrt((1/n) sum L_i^2) over the worker split
    Lhat: float              # coordinate-wise block smoothness
    n_workers: int

    @property
    def dim(self) -> int:
        return int(self.A.shape[1])

    def f(self, x: torch.Tensor) -> torch.Tensor:
        z = self.b * (x @ self.A.T)
        return (torch.mean(_logaddexp0(-z), dim=-1)
                + 0.5 * f32(self.lam2, x) * torch.sum(x * x, dim=-1))

    def grad_f(self, x: torch.Tensor) -> torch.Tensor:
        z = self.b * (x @ self.A.T)
        s = -self.b * torch.sigmoid(-z)
        return s @ self.A / self.A.shape[0] + f32(self.lam2, x) * x

    def worker_slices(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """n contiguous equal shards -> (n, N/n, d), (n, N/n) views."""
        n = self.n_workers
        N = (self.A.shape[0] // n) * n
        return (self.A[:N].reshape(n, -1, self.A.shape[1]),
                self.b[:N].reshape(n, -1))

    def worker_loss(self, x: torch.Tensor, Aw: torch.Tensor,
                    bw: torch.Tensor) -> torch.Tensor:
        """f_i on shard i at full-objective scale."""
        z = bw * (x @ Aw.T)
        return (torch.mean(_logaddexp0(-z), dim=-1)
                + 0.5 * f32(self.lam2, x) * torch.sum(x * x, dim=-1))

    def worker_grads(self):
        """``grad_fn(xw (B, d), w (B,)) -> (B, d)``: the gradient of f_{w_b}
        at ``xw_b`` for every cell b, in closed form.

        The shared ``(W, n_per, d)`` shards are never gathered per cell:
        one product of every cell's iterate with all samples gives each
        cell's logits on every shard, the cell's own shard is selected, and
        its sample weights (zero elsewhere) go back through one product
        with all samples."""
        Aw, bw = self.worker_slices()
        W, n_per, d = Aw.shape
        A2 = Aw.reshape(W * n_per, d)
        lam2 = self.lam2

        def grad(xw: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
            B = xw.shape[0]
            cells = torch.arange(B, device=xw.device)
            w = w.to(torch.int64)
            z_all = (xw @ A2.T).view(B, W, n_per)
            bsel = bw[w]                              # (B, n_per) labels
            z = bsel * z_all[cells, w]
            s = -bsel * torch.sigmoid(-z) / n_per     # d mean-loss / d logit
            weights = torch.zeros_like(z_all)
            weights[cells, w] = s
            return weights.view(B, W * n_per) @ A2 + f32(lam2, xw) * xw

        return grad

    def P(self, x: torch.Tensor) -> torch.Tensor:
        return self.f(x) + f32(self.lam1, x) * torch.sum(torch.abs(x), dim=-1)

    def full_smoothness(self) -> float:
        """Smoothness of the full f: lambda_max(A^T A)/(4N) + lam2."""
        A = self.A.cpu().numpy()
        return float(power_iteration_sq(A) / (4.0 * A.shape[0]) + self.lam2)


def make_logreg(
    n_samples: int = 2000,
    dim: int = 200,
    n_workers: int = 10,
    sparse_like: bool = True,
    lam1: float = 1e-5,
    lam2: float = 1e-4,
    seed: int = 0,
    device=None,
) -> LogRegProblem:
    """Synthetic classification data: ``sparse_like=True`` mimics rcv1
    (~5% dense, l2-normalized rows), ``False`` mimics MNIST (dense, bounded
    features).  The numpy draw is the reference's, bit for bit."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    x_star = rng.normal(size=(dim,)) / np.sqrt(dim)
    if sparse_like:
        density = 0.05
        mask = rng.random((n_samples, dim)) < density
        A = rng.normal(size=(n_samples, dim)) * mask
        norms = np.linalg.norm(A, axis=1, keepdims=True)
        A = A / np.maximum(norms, 1e-12)  # rcv1 rows are l2-normalized
    else:
        A = np.abs(rng.normal(size=(n_samples, dim))) * (rng.random((n_samples, dim)) < 0.25)
        A = A / max(np.abs(A).max(), 1e-12)
    logits = A @ x_star + 0.3 * rng.normal(size=(n_samples,))
    b = np.where(logits >= 0, 1.0, -1.0)

    L = worker_rms_smoothness(A, n_workers, denom_scale=4.0, shift=lam2)
    col_sq = (A * A).sum(axis=0)
    Lhat = float(col_sq.max() / (4.0 * n_samples) + lam2)

    return LogRegProblem(
        A=torch.from_numpy(A.astype(np.float32)).to(dev),
        b=torch.from_numpy(b.astype(np.float32)).to(dev),
        lam1=lam1, lam2=lam2, L=L, Lhat=Lhat, n_workers=n_workers,
    )


@dataclasses.dataclass(frozen=True, eq=False)
class LassoProblem:
    """f(x) = (1/2N) ||A x - y||^2, R(x) = lam1 ||x||_1."""

    A: torch.Tensor          # (N, d)
    y: torch.Tensor          # (N,)
    lam1: float
    L: float
    n_workers: int

    @property
    def dim(self) -> int:
        return int(self.A.shape[1])

    def f(self, x):
        r = x @ self.A.T - self.y
        return 0.5 * torch.mean(r * r, dim=-1)

    def grad_f(self, x):
        return (x @ self.A.T - self.y) @ self.A / self.A.shape[0]

    def worker_slices(self):
        n = self.n_workers
        N = (self.A.shape[0] // n) * n
        return (self.A[:N].reshape(n, -1, self.A.shape[1]),
                self.y[:N].reshape(n, -1))

    def worker_loss(self, x, Aw, yw):
        r = x @ Aw.T - yw
        return 0.5 * torch.mean(r * r, dim=-1)

    def P(self, x):
        return self.f(x) + f32(self.lam1, x) * torch.sum(torch.abs(x), dim=-1)

    def full_smoothness(self) -> float:
        A = self.A.cpu().numpy()
        return float(power_iteration_sq(A) / A.shape[0])


def make_lasso(
    n_samples: int = 1000,
    dim: int = 100,
    n_workers: int = 10,
    density: float = 0.1,
    lam1: float = 1e-3,
    noise: float = 0.01,
    seed: int = 0,
    device=None,
) -> LassoProblem:
    """Sparse-ground-truth least squares y = A x* + noise (reference numpy
    draw, bit for bit)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n_samples, dim)) / np.sqrt(n_samples)
    x_star = np.where(rng.random(dim) < density, rng.normal(size=dim), 0.0)
    y = A @ x_star + noise * rng.normal(size=n_samples)

    L = worker_rms_smoothness(A, n_workers, denom_scale=1.0)
    return LassoProblem(A=torch.from_numpy(A.astype(np.float32)).to(dev),
                        y=torch.from_numpy(y.astype(np.float32)).to(dev),
                        lam1=lam1, L=L, n_workers=n_workers)


def solve_centralized(problem, prox, iters: int = 3000):
    """Reference minimizer of P = f + R by FISTA on the full data with
    lr = 1/L_full.  Returns ``(x_star, P_trace)``."""
    lr = 1.0 / problem.full_smoothness()
    dev = problem.A.device
    x = torch.zeros((problem.dim,), dtype=torch.float32, device=dev)
    z = x.clone()
    t = torch.ones((), dtype=torch.float32, device=dev)
    lr_t = f32(lr, x)
    objs = []
    for _ in range(iters):
        g = problem.grad_f(z)
        x_new = prox.prox(z - lr_t * g, lr_t)
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        z = x_new + ((t - 1.0) / t_new) * (x_new - x)
        x, t = x_new, t_new
        objs.append(problem.P(x_new))
    return x, torch.stack(objs)
