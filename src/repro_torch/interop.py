"""Carry the reference's state into the port.

Each function takes arrays from ``repro`` as numpy (``np.asarray`` of a
JAX array) and returns the port's object with its tensors on ``device``,
so a test can hand both packages identical state: a problem's data and
constants, an iterate, a step-size state, policy parameters, an event
trace, the federated state -- client models given as plain numbers,
pre-sampled client rounds, federated traces (host or device columns) and
a federated result's leaves -- a model's parameters, and a trainer's
state (parameters and delay-adaptive optimizer).
"""
from __future__ import annotations

import numpy as np
import torch

from .core.engine import EventTrace, WorkerModel
from .core.pytree import tree_map
from .core.problems import LogRegProblem
from .federated.events import (ClientModel, ClientRounds, FederatedTrace,
                               FederatedTraceArrays)
from .federated.server import FedResult
from .core.stepsize import StepsizeState
from .kernels.dispatch import resolve_device
from .sweep.policies import PolicyParams

__all__ = ["logreg_problem", "iterate", "stepsize_state", "policy_params",
           "event_trace", "client_models", "client_rounds",
           "federated_trace", "federated_trace_arrays", "fed_result",
           "model_params", "model_tree", "train_state"]


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=dtype, copy=True)).to(
        resolve_device(device))


def logreg_problem(A, b, lam1: float, lam2: float, L: float, Lhat: float,
                   n_workers: int, device=None) -> LogRegProblem:
    """A ``LogRegProblem`` from the reference problem's ``A``, ``b``,
    ``lam1``, ``lam2``, ``L``, ``Lhat`` and ``n_workers``."""
    return LogRegProblem(A=_tensor(A, np.float32, device),
                         b=_tensor(b, np.float32, device),
                         lam1=float(lam1), lam2=float(lam2), L=float(L),
                         Lhat=float(Lhat), n_workers=int(n_workers))


def iterate(x0, device=None) -> torch.Tensor:
    """The iterate ``x0`` as a float32 tensor."""
    return _tensor(x0, np.float32, device)


def stepsize_state(k, total, cumbuf, clipped, device=None) -> StepsizeState:
    """A ``StepsizeState`` from the reference state's four leaves."""
    return StepsizeState(k=_tensor(k, np.int32, device),
                         total=_tensor(total, np.float32, device),
                         cumbuf=_tensor(cumbuf, np.float32, device),
                         clipped=_tensor(clipped, np.int32, device))


def policy_params(policy_id, gamma_prime, c0, c1, device=None) -> PolicyParams:
    """``PolicyParams`` from the reference's four fields."""
    return PolicyParams(policy_id=_tensor(policy_id, np.int32, device),
                        gamma_prime=_tensor(gamma_prime, np.float32, device),
                        c0=_tensor(c0, np.float32, device),
                        c1=_tensor(c1, np.float32, device))


def event_trace(worker, tau, t_wall, tau_max=None, read_at=None) -> EventTrace:
    """An ``EventTrace`` (host arrays) from a reference trace's ``worker``,
    ``tau`` and ``t_wall``; ``tau_max`` defaults to ``tau`` (the
    shared-memory form) and ``read_at`` to ``k - tau``."""
    worker = np.asarray(worker, np.int32)
    tau = np.asarray(tau, np.int32)
    tau_max = tau.copy() if tau_max is None else np.asarray(tau_max, np.int32)
    if read_at is None:
        read_at = (np.arange(tau.shape[0]) - tau).astype(np.int32)
    return EventTrace(worker, np.asarray(read_at, np.int32), tau, tau_max,
                      np.asarray(t_wall, np.float64))


def client_models(clients) -> list:
    """The port's ``ClientModel`` list from clients given as plain numbers:
    one mapping per client with the reference's fields (``compute`` and
    ``upload`` as mappings of ``mean``, ``sigma``, ``p_straggle``,
    ``straggle_x``; ``local_epochs``, ``p_dropout``, ``rejoin_after``) --
    ``dataclasses.asdict`` of a reference client has this form."""
    def worker(m):
        return WorkerModel(mean=float(m["mean"]), sigma=float(m["sigma"]),
                           p_straggle=float(m["p_straggle"]),
                           straggle_x=float(m["straggle_x"]))
    return [ClientModel(compute=worker(c["compute"]),
                        upload=worker(c["upload"]),
                        local_epochs=int(c["local_epochs"]),
                        p_dropout=float(c["p_dropout"]),
                        rejoin_after=float(c["rejoin_after"]))
            for c in clients]


def client_rounds(drop_u, duration) -> ClientRounds:
    """``ClientRounds`` (host float32 arrays) from the reference's two
    leaves."""
    return ClientRounds(np.array(drop_u, np.float32, copy=True),
                        np.array(duration, np.float32, copy=True))


_FED_COLS = (("client", np.int32), ("read_at", np.int32), ("tau", np.int32),
             ("aggregate", np.int32), ("version", np.int32),
             ("local_steps", np.int32))


def federated_trace(client, read_at, tau, aggregate, version, local_steps,
                    t_wall) -> FederatedTrace:
    """A ``FederatedTrace`` (host arrays) from a reference trace's seven
    columns."""
    cols = [np.asarray(a, dt) for a, (_, dt) in zip(
        (client, read_at, tau, aggregate, version, local_steps), _FED_COLS)]
    return FederatedTrace(*cols, np.asarray(t_wall, np.float64))


def federated_trace_arrays(client, read_at, tau, aggregate, version,
                           local_steps, t_wall, n_uploads, exhausted,
                           device=None) -> FederatedTraceArrays:
    """``FederatedTraceArrays`` (tensors on ``device``) from the
    reference's nine leaves."""
    cols = [_tensor(a, dt, device) for a, (_, dt) in zip(
        (client, read_at, tau, aggregate, version, local_steps), _FED_COLS)]
    return FederatedTraceArrays(*cols, _tensor(t_wall, np.float32, device),
                                _tensor(n_uploads, np.int32, device),
                                _tensor(exhausted, np.bool_, device))


def fed_result(x, objective, weights, taus, versions, clipped,
               device=None) -> FedResult:
    """A ``FedResult`` from the reference result's first six leaves."""
    return FedResult(x=_tensor(x, np.float32, device),
                     objective=_tensor(objective, np.float32, device),
                     weights=_tensor(weights, np.float32, device),
                     taus=_tensor(taus, np.int32, device),
                     versions=_tensor(versions, np.int32, device),
                     clipped=_tensor(clipped, np.int32, device))


def model_params(params_np, cfg, device=None):
    """The port's ``models.Transformer`` holding the reference's
    parameters.

    ``params_np`` is the reference's parameter tree (``init_params`` of
    ``repro.models``) with numpy leaves (``np.asarray`` of each JAX
    array; bfloat16 leaves may stay ``ml_dtypes`` arrays): ``embed``,
    ``final_norm`` and ``layers`` with every leaf stacked on a leading L
    axis.  Layer ``i`` takes slice ``i`` of each leaf; layouts are the
    reference's, so nothing is transposed.  Values pass through float32,
    which holds bfloat16 and float16 exactly, and land in ``cfg``'s param
    dtype.  Raises on a missing, extra or misshapen leaf."""
    from .models.transformer import Transformer
    dev = resolve_device(device)
    with torch.no_grad():
        model = Transformer(cfg, None, dev)

        def put(dst, src, where: str, index=None):
            if set(dst.keys()) != set(src.keys()):
                raise ValueError(f"{where}: leaves {sorted(src)} do not match "
                                 f"the port's {sorted(dst.keys())}")
            for name, p in dst.items():
                a = np.asarray(src[name]).astype(np.float32)
                if index is not None:
                    a = a[index]
                if a.shape != tuple(p.shape):
                    raise ValueError(f"{where}.{name}: shape {a.shape}, the "
                                     f"port expects {tuple(p.shape)}")
                p.copy_(torch.from_numpy(np.ascontiguousarray(a)).to(
                    device=dev, dtype=p.dtype))

        if set(params_np) != {"embed", "layers", "final_norm"}:
            raise ValueError(f"parameter tree has {sorted(params_np)}; the "
                             "dense trunk takes embed, layers, final_norm")
        put(model.embed, params_np["embed"], "embed")
        put(model.final_norm, params_np["final_norm"], "final_norm")
        layers = params_np["layers"]
        if set(layers) != {"ln1", "attn", "ln2", "mlp"}:
            raise ValueError(f"layers has {sorted(layers)}; a dense layer is "
                             "ln1, attn, ln2, mlp")
        for i, layer in enumerate(model.layers):
            for part in ("ln1", "attn", "ln2", "mlp"):
                put(getattr(layer, part), layers[part], f"layers.{part}", i)
    return model


def model_tree(model) -> dict:
    """The inverse of :func:`model_params`: a ``models.Transformer``'s
    parameters as the reference's tree of float32 numpy leaves (``embed``,
    ``final_norm``, and ``layers`` stacked on a leading L axis)."""
    tree = {"embed": {}, "final_norm": {}, "layers": {}}
    for part in ("embed", "final_norm"):
        for name, p in getattr(model, part).items():
            tree[part][name] = p.detach().float().cpu().numpy()
    for part in ("ln1", "attn", "ln2", "mlp"):
        tree["layers"][part] = {
            name: np.stack([getattr(layer, part)[name].detach().float()
                            .cpu().numpy() for layer in model.layers])
            for name in getattr(model.layers[0], part)}
    return tree


def _float_tree(tree, device):
    """A tree of numpy (or JAX) leaves as float32 tensors on ``device``."""
    return tree_map(lambda a: _tensor(a, np.float32, device), tree)


def train_state(jax_state, cfg, device=None):
    """The port's ``launch.steps.TrainState`` from the reference's.

    ``jax_state`` is a reference ``TrainState`` (or anything with its
    ``params`` and ``opt`` fields) whose leaves are arrays: ``params`` go
    through :func:`model_params` into the port's reference-layout tree
    (``models.param_tree``); ``opt`` is a ``DelayAdaptiveState`` whose
    ``step``, ``ss`` (``StepsizeState``), ``worker_stamp`` and inner
    optimizer state (AdamW's ``count``/``mu``/``nu``, Momentum's ``mu``,
    or SGD's empty tuple) become the port's."""
    from .launch.steps import TrainState
    from .models.transformer import param_tree
    from .optim.optimizers import AdamState, DelayAdaptiveState, MomentumState
    dev = resolve_device(device)
    params_np = tree_map(np.asarray, jax_state.params)
    params = param_tree(model_params(params_np, cfg, device=dev))
    opt = jax_state.opt
    inner = opt.inner
    fields = getattr(inner, "_fields", None)
    if fields == ("count", "mu", "nu"):
        inner = AdamState(count=_tensor(inner.count, np.int32, dev),
                          mu=_float_tree(inner.mu, dev),
                          nu=_float_tree(inner.nu, dev))
    elif fields == ("mu",):
        inner = MomentumState(mu=_float_tree(inner.mu, dev))
    elif inner == () or inner is None:
        inner = ()
    else:
        raise ValueError(f"unknown inner optimizer state {type(inner)}")
    ss = opt.ss
    return TrainState(params=params, opt=DelayAdaptiveState(
        step=_tensor(opt.step, np.int32, dev),
        ss=stepsize_state(ss.k, ss.total, ss.cumbuf, ss.clipped, device=dev),
        inner=inner,
        worker_stamp=_tensor(opt.worker_stamp, np.int32, dev)))

