"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
nvcc per source, all started together), holds each against its plain
PyTorch version on the card, and drives the port's main paths:

* ``repro_torch.api.run`` for PIAG, FedAsync and FedBuff (batched, default
  engine) at the paper's MNIST shape, through kernels B1-B3;
* serving qwen2.5-32b at full width and depth (64 layers, bfloat16,
  random weights from the port's initializer on the card) through
  ``launch.serve.generate`` and ``serving.ContinuousBatcher``, whose
  prefill runs the flash-attention kernel B6.

Each phase prints one line; any failure raises and the script exits
non-zero.  The last three lines are the kernels' JSON, the card's name and
power limit, and ``{"ok": true, "device": ...}``.  Exits non-zero without
a result when no CUDA device is present.
"""
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: no CUDA device available; nothing was run")

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch import api, interop  # noqa: E402
from repro_torch.analysis import (best_fixed_vs_adaptive,  # noqa: E402
                                  time_to_tolerance)
from repro_torch.core.engine import simulate_parameter_server  # noqa: E402
from repro_torch.core.piag import run_piag_logreg  # noqa: E402
from repro_torch.core.problems import (make_logreg,  # noqa: E402
                                       solve_centralized)
from repro_torch.core.prox import L1, make_prox  # noqa: E402
from repro_torch.core.stepsize import (Adaptive1, FixedStepSize,  # noqa: E402
                                       StepsizeState, make_policy)
from repro_torch.federated import (heterogeneous_clients,  # noqa: E402
                                   run_fedasync_problem, simulate_federated)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels.fused_step import (  # noqa: E402
    boundary_bytes, boundary_bytes_buff, boundary_bytes_mix,
    fused_policy_buff_step, fused_policy_buff_step_ref,
    fused_policy_mix_step, fused_policy_mix_step_ref, fused_policy_prox_step,
    fused_policy_prox_step_ref)
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import forward, init_params, prefill  # noqa: E402
from repro_torch.serving import ContinuousBatcher, Request  # noqa: E402
from repro_torch.sweep.policies import POLICY_IDS, PolicyParams  # noqa: E402
from repro_torch.sweep.runners import fed_bucket_races  # noqa: E402

DEV = torch.device("cuda")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3, NVIDIA data sheet
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 dense tensor cores
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/fused_step.cu"
FA_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
REPLACES = "src/repro/kernels/fused_step.py:209"
REPLACES_MIX = "src/repro/kernels/fused_step.py:240"
REPLACES_BUFF = "src/repro/kernels/fused_step.py:279"
REPLACES_FA = "src/repro/kernels/flash_attention.py:104"
POLICIES = ("adaptive1", "adaptive2", "fixed", "naive", "hinge", "poly")
PROXES = (("none", {}), ("l1", dict(lam=1e-2)), ("l2", dict(lam=1e-2)),
          ("elastic_net", dict(lam1=1e-2, lam2=1e-2)),
          ("box", dict(lo=-0.5, hi=0.5)), ("group_l2", dict(lam=1.0)))
# envelopes: gamma of hinge/poly (powf vs torch.pow) in float32 ulps of
# the value; x_new of hinge/poly/group_l2 relative to the largest |x_new|
GAMMA_ULP_ENVELOPE = 4
X_REL_ENVELOPE = 1e-5
OBJ_REL_ENVELOPE = 1e-5        # objective, relative to the initial value
FED_POLICIES = ("hinge", "poly", "constant")
# B6 envelopes: float32 within 1e-5 of max|out|; bfloat16 within 2 bf16
# ulps of the plain output plus that float32 envelope (a value that cancels
# near zero has ulps finer than the float32 error of either sum)
FA_REL_ENVELOPE = 1e-5
FA_BF16_ULPS = 2
LOGIT_F32_ENVELOPE = 1e-4      # card vs cpu, float32 model logits
SERVE_ARCH = "qwen2.5-32b"
COUNTERS = (fused_policy_prox_step, fused_policy_mix_step,
            fused_policy_buff_step, fa.flash_attention_bhsd)


def say(tag: str, text: str) -> None:
    print(f"[{tag}] {text}", flush=True)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main_spec(**over):
    ex = dict(backend="batched", record_every=10)
    ex.update(over.pop("execution", {}))
    kw = dict(
        problem=api.ProblemSpec(kind="logreg", params=dict(
            n_samples=60000, dim=784, sparse_like=False, lam1=1e-3,
            lam2=1e-4)),
        solver=api.SolverSpec(name="piag", horizon="auto"),
        topology=api.TopologySpec(kind="standard", n_workers=(10,)),
        policies=api.PolicyGridSpec(names=POLICIES, seeds=(0, 1, 2, 3)),
        execution=api.ExecutionSpec(**ex),
        n_events=2500)
    kw.update(over)
    return api.ExperimentSpec(**kw)


def fed_spec(solver: str, **over):
    """The federated main path: fig5's clients at MNIST's shape, 24 cells
    (hinge, poly, constant x seeds 0-7), 2500 uploads."""
    ex = dict(backend="batched", record_every=10)
    ex.update(over.pop("execution", {}))
    kw = dict(
        problem=api.ProblemSpec(kind="logreg", params=dict(
            n_samples=60000, dim=784, sparse_like=False, lam1=1e-3,
            lam2=1e-4)),
        solver=api.SolverSpec(name=solver, horizon="auto",
                              buffer_size=4 if solver == "fedbuff" else 1,
                              eta=0.4),
        topology=api.TopologySpec(kind="edge", n_workers=(8,), seed=1,
                                  params=dict(spread=4.0, p_straggle=0.05,
                                              p_dropout=0.02)),
        policies=api.PolicyGridSpec(
            names=FED_POLICIES, gamma_prime=0.4, seeds=tuple(range(8)),
            policy_kwargs={"hinge": dict(a=0.5, b=16.0),
                           "poly": dict(a=0.3)}),
        execution=api.ExecutionSpec(**ex),
        n_events=2500)
    kw.update(over)
    return api.ExperimentSpec(**kw)


def reset_counts() -> None:
    for fn in COUNTERS:
        fn.launches = 0


# ------------------------------------------------------------ phases ----

def phase_device() -> str:
    name = card()
    nvcc = subprocess.run([build.nvcc_path(), "--version"],
                          capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    say("1 device", f"{name} | {torch.cuda.get_device_name(0)} x"
        f"{torch.cuda.device_count()} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {nvcc}")
    return name


def phase_build() -> None:
    """Both kernel libraries, one nvcc each, started together."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        fused, flash = pool.map(build.load, ("fused_step", "flash_attention"))
    wall = time.perf_counter() - t0
    for built, src in ((fused, KERNEL_SOURCE), (flash, FA_SOURCE)):
        regs = re.findall(r"Used (\d+) registers", built.ptxas)
        spill = sum(int(n) for n in re.findall(r"(\d+) bytes spill stores",
                                               built.ptxas))
        say("2 build", f"{built.path.name} built in "
            f"{built.build_seconds:.3f} s (0 = reused) from {src}; ptxas: "
            f"{len(regs)} kernels, registers {','.join(regs)}, spill stores "
            f"{spill} bytes")
    say("2 build", f"both libraries in {wall:.3f} s wall (parallel nvcc)")


def _random_case(B, d, H, pid, gen):
    """Inputs for one kernel-vs-plain case; k/tau hit the window edges."""
    edges_k = torch.tensor([0, 1, H - 1, H, H + 5, 3 * H + 7],
                           dtype=torch.int32)
    edges_tau = torch.tensor([0, 1, H - 1, H, H + 5, 2 * H + 3],
                             dtype=torch.int32)
    k = edges_k[torch.randint(0, 6, (B,), generator=gen)]
    tau = torch.where(torch.rand(B, generator=gen) < 0.5,
                      edges_tau[torch.randint(0, 6, (B,), generator=gen)],
                      torch.randint(0, H + 6, (B,), generator=gen,
                                    dtype=torch.int32))
    params = PolicyParams(
        pid.to(torch.int32), torch.rand(B, generator=gen) + 0.5,
        torch.rand(B, generator=gen) * 0.9 + 0.05,
        torch.rand(B, generator=gen) * 5)
    cum = torch.cumsum(torch.rand(B, H, generator=gen), dim=1)
    total = cum[:, -1] + 1.0
    clipped = torch.randint(0, 3, (B,), generator=gen, dtype=torch.int32)
    x = torch.randn(B, d, generator=gen)
    g = torch.randn(B, d, generator=gen)
    state = StepsizeState(k, total, cum, clipped)
    return params, state, tau, x, g


def _to(t):
    return t.to(DEV)


def phase_kernel_vs_plain() -> float:
    """Every (B, d, H) x prox x policy id, three consecutive events from a
    state whose k and tau sit on the window edges.  Exact: k, clipped.
    Bitwise: gamma, total, cumbuf for ids 0-3 and x_new for ids 0-3 under
    every prox but group_l2.  Envelopes elsewhere (module constants)."""
    gen = torch.Generator().manual_seed(0)
    worst = {"bitwise": 0.0, "hinge/poly gamma": 0.0, "hinge/poly x": 0.0,
             "group_l2 x": 0.0}
    cases = 0
    for B in (1, 96):
        for d in (1, 784, 1000, 4097):
            for H in (2, 512, 4096):
                for name, kw in PROXES:
                    prox = make_prox(name, **kw)
                    pid_sets = ([torch.tensor([p]) for p in range(6)]
                                if B == 1 else [torch.arange(B) % 6])
                    for pid in pid_sets:
                        fma_push = bool(cases % 2)
                        params, st, tau, x, g = _random_case(B, d, H, pid, gen)
                        p1 = PolicyParams(*map(_to, params))
                        s1 = StepsizeState(*map(_to, st))
                        s2 = StepsizeState(*(t.clone() for t in s1))
                        tau1, x1, g1 = _to(tau), _to(x), _to(g)
                        x2 = x1
                        for _ in range(3):
                            ga, s1, x1 = fused_policy_prox_step(
                                p1, prox, s1, tau1, x1, g1, fma_push)
                            gb, s2, x2 = fused_policy_prox_step_ref(
                                p1, prox, s2, tau1, x2, g1, fma_push)
                        torch.cuda.synchronize()
                        cases += 1
                        _compare(name, pid.to(DEV), ga, gb, s1, s2, x1, x2,
                                 worst, (B, d, H, name))
    say("3 kernel", f"{cases} cases (B in 1,96; d in 1,784,1000,4097; H in "
        f"2,512,4096; 6 prox ops; policy ids 0-5; k/tau on the window "
        f"edges; 3 events each): k, clipped exact; max abs err "
        + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
        + f" (envelopes: gamma {GAMMA_ULP_ENVELOPE} ulp, x "
        f"{X_REL_ENVELOPE:g} x max|x|)")
    return max(worst.values())


def _compare(name, pid, ga, gb, s1, s2, x1, x2, worst, where):
    if not (torch.equal(s1.k, s2.k) and torch.equal(s1.clipped, s2.clipped)):
        raise AssertionError(f"k/clipped differ at {where}")
    exact = pid <= 3
    bitwise_x = exact.unsqueeze(-1).expand_as(x1) if name != "group_l2" \
        else torch.zeros_like(x1, dtype=torch.bool)
    for a, b in ((ga, gb), (s1.total, s2.total)):
        if not torch.equal(a[exact], b[exact]):
            raise AssertionError(f"gamma/total not bitwise for ids 0-3 at {where}")
    if not torch.equal(s1.cumbuf[exact], s2.cumbuf[exact]):
        raise AssertionError(f"cumbuf not bitwise for ids 0-3 at {where}")
    if not torch.equal(x1[bitwise_x], x2[bitwise_x]):
        raise AssertionError(f"x_new not bitwise at {where}")
    dx = (x1 - x2).abs()
    worst["bitwise"] = max(worst["bitwise"], float(dx[bitwise_x].max())
                           if bitwise_x.any() else 0.0)
    loose = ~exact
    if loose.any():
        dg = (ga - gb).abs()[loose]
        ulp = torch.finfo(torch.float32).eps * gb.abs()[loose]
        if bool((dg > GAMMA_ULP_ENVELOPE * ulp).any()):
            raise AssertionError(f"hinge/poly gamma outside envelope at {where}")
        worst["hinge/poly gamma"] = max(worst["hinge/poly gamma"],
                                        float(dg.max()))
    scale = X_REL_ENVELOPE * max(1.0, float(x2.abs().max()))
    if float(dx.max()) > scale:
        raise AssertionError(f"x_new outside envelope at {where}: {float(dx.max())}")
    key = "group_l2 x" if name == "group_l2" else "hinge/poly x"
    rest = dx[~bitwise_x]
    if rest.numel():
        worst[key] = max(worst[key], float(rest.max()))


def _fed_case(B, d, H, pid, gen):
    """Inputs for one B2/B3 case: the B1 state and policy on the window
    edges, client models, read snapshots, buffered deltas, and 0/1
    aggregation flags."""
    params, state, tau, x, _ = _random_case(B, d, H, pid, gen)
    xc, xw, delta = (torch.randn(B, d, generator=gen) for _ in range(3))
    agg = (torch.rand(B, generator=gen) < 0.5).to(torch.float32)
    return params, state, tau, x, xc, xw, delta, agg


def _check_fed(kind, pid, outs_k, outs_p, worst, where):
    """k, clipped exact; gamma, total, cumbuf of ids 0-3 bitwise; x_new
    (and delta_new) of ids 0-3 bitwise; ids 4-5 within the envelopes."""
    (ga, s1, *v1), (gb, s2, *v2) = outs_k, outs_p
    if not (torch.equal(s1.k, s2.k) and torch.equal(s1.clipped, s2.clipped)):
        raise AssertionError(f"{kind}: k/clipped differ at {where}")
    exact = pid <= 3
    for name, a, b in (("gamma", ga, gb), ("total", s1.total, s2.total),
                       ("cumbuf", s1.cumbuf, s2.cumbuf)):
        if not torch.equal(a[exact], b[exact]):
            raise AssertionError(f"{kind}: {name} not bitwise for ids 0-3 "
                                 f"at {where}")
    loose = ~exact
    if loose.any():
        dg = (ga - gb).abs()[loose]
        ulp = torch.finfo(torch.float32).eps * gb.abs()[loose]
        if bool((dg > GAMMA_ULP_ENVELOPE * ulp).any()):
            raise AssertionError(f"{kind}: hinge/poly gamma outside envelope "
                                 f"at {where}")
        worst["hinge/poly gamma"] = max(worst["hinge/poly gamma"],
                                        float(dg.max()))
    for a, b in zip(v1, v2):
        if not torch.equal(a[exact], b[exact]):
            raise AssertionError(f"{kind}: vectors not bitwise for ids 0-3 "
                                 f"at {where}")
        dx = (a - b).abs()
        if float(dx.max()) > X_REL_ENVELOPE * max(1.0, float(b.abs().max())):
            raise AssertionError(f"{kind}: vectors outside envelope at "
                                 f"{where}: {float(dx.max())}")
        worst["hinge/poly x"] = max(worst["hinge/poly x"], float(dx.max()))


def phase_fed_kernels_vs_plain(main_shape=(24, 784, 256)) -> float:
    """B2 and B3 against their plain versions: B in 1, 24; d in 1, 127,
    784, 4097 and the main path's (B, d, H); H in 2, 64, 4096; k/tau on the
    window edges; all six policy ids; agg at 0 and 1; fma_push both ways;
    three consecutive events each."""
    gen = torch.Generator().manual_seed(2)
    worst = {"hinge/poly gamma": 0.0, "hinge/poly x": 0.0}
    shapes = [(B, d, H) for B in (1, 24) for d in (1, 127, 784, 4097)
              for H in (2, 64, 4096)] + [tuple(main_shape)]
    cases = 0
    for B, d, H in shapes:
        pid_sets = ([torch.tensor([p]) for p in range(6)] if B == 1
                    else [torch.arange(B) % 6])
        for pid in pid_sets:
            for kind in ("mix", "buff"):
                fma_push = bool(cases % 2)
                params, st, tau, x, xc, xw, delta, agg = _fed_case(
                    B, d, H, pid, gen)
                p1 = PolicyParams(*map(_to, params))
                s1 = StepsizeState(*map(_to, st))
                s2 = StepsizeState(*(t.clone() for t in s1))
                tau, x, xc, xw, delta, agg = map(
                    _to, (tau, x, xc, xw, delta, agg))
                xa = xb = x
                da = db = delta
                for _ in range(3):
                    if kind == "mix":
                        ka = fused_policy_mix_step(p1, s1, tau, xa, xc,
                                                   fma_push)
                        kb = fused_policy_mix_step_ref(p1, s2, tau, xb, xc,
                                                       fma_push)
                        xa, xb = ka[2], kb[2]
                    else:
                        ka = fused_policy_buff_step(p1, s1, tau, xa, xc, xw,
                                                    da, agg, 0.1, fma_push)
                        kb = fused_policy_buff_step_ref(p1, s2, tau, xb, xc,
                                                        xw, db, agg, 0.1,
                                                        fma_push)
                        xa, xb, da, db = ka[2], kb[2], ka[3], kb[3]
                    s1, s2 = ka[1], kb[1]
                torch.cuda.synchronize()
                cases += 1
                _check_fed(kind, pid.to(DEV), ka, kb, worst, (kind, B, d, H))
    say("3b fed kernels", f"{cases} cases of B2 (mix) and B3 (buff) (B in "
        f"1,24; d in 1,127,784,4097 and {tuple(main_shape)}; H in 2,64,4096; "
        "policy ids 0-5; agg 0/1; k/tau on the window edges; 3 events "
        "each): k, clipped exact; gamma, total, cumbuf, x_new, delta_new "
        "bitwise for ids 0-3; max abs err "
        + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
        + f" (envelopes: gamma {GAMMA_ULP_ENVELOPE} ulp, x "
        f"{X_REL_ENVELOPE:g} x max|x|)")
    return max(worst.values())


def phase_main_path():
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = api.run(main_spec())
    wall = time.perf_counter() - t0
    launches = fused_policy_prox_step.launches
    if fused_policy_mix_step.launches or fused_policy_buff_step.launches:
        raise AssertionError("the PIAG path launched a federated kernel")
    obj = res.objective
    B, K = len(res), res.n_events
    if launches <= 0 or launches != K * len(res.grid.buckets()):
        raise AssertionError(f"expected one kernel launch per event, got {launches}")
    if tuple(obj.shape) != (B, K // 10) or not bool(torch.isfinite(obj).all()) \
            or not bool(torch.isfinite(res.gammas).all()):
        raise AssertionError("main path output has the wrong shape or is not finite")
    if int(res.clipped.sum()) != 0:
        raise AssertionError("horizon='auto' run clipped a delay")
    obj_h = obj.cpu().numpy()
    names = [c.policy_name for c in res.cells]
    key = [(c.seed, c.topology_name) for c in res.cells]
    reach = []
    for i, n in enumerate(names):
        if n != "adaptive1":
            continue
        j = next(j for j, m in enumerate(names) if m == "fixed" and key[j] == key[i])
        hit = obj_h[i] <= obj_h[j, -1]
        reach.append((np.argmax(hit) + 1) / hit.size if hit.any() else np.inf)
    say("4 main path", f"api.run 96 cells (6 policies x 4 seeds x 4 "
        f"topologies), 60000 x 784 logreg, 10 workers, {K} events, H="
        f"{res.horizon} (tau_bar={res.tau_bar}), record_every=10, engine="
        f"{res.spec.execution.engine}: wall {wall:.3f} s (resolve + build "
        f"included), dispatch {res.elapsed_s:.3f} s, "
        f"{B * K / res.elapsed_s:.1f} cell-events/s, peak "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, kernel "
        f"launches {launches}; adaptive1 reaches fixed's final objective in "
        f"{sum(np.isfinite(reach))}/{len(reach)} (seed, topology) pairs, "
        f"median {np.median(reach):.3f} of the events")
    return res, launches


def phase_scan_vs_fused() -> None:
    """16 cells at full size: both engines on the card, bitwise; then a
    small spec on the card against the CPU plain path."""
    sub = dict(policies=api.PolicyGridSpec(
        names=("adaptive1", "adaptive2", "fixed", "naive"), seeds=(0,)))
    r_f = api.run(main_spec(**sub, execution=dict(engine="fused")))
    r_s = api.run(main_spec(**sub, execution=dict(engine="scan")))
    for f in ("taus", "clipped", "gammas"):
        if not torch.equal(getattr(r_f, f), getattr(r_s, f)):
            raise AssertionError(f"scan vs fused: {f} not bitwise")
    rel = float(((r_f.objective - r_s.objective).abs()
                 / r_s.objective[:, :1].abs()).max())
    if rel > OBJ_REL_ENVELOPE:
        raise AssertionError(f"scan vs fused objective rel diff {rel}")
    small = dict(problem=api.ProblemSpec(kind="logreg", params=dict(
        n_samples=1200, dim=784, sparse_like=False, lam1=1e-3, lam2=1e-4)),
        n_events=300)
    r_gpu = api.run(main_spec(**small))
    r_cpu = api.run(main_spec(**small, execution=dict(device="cpu")))
    exact = torch.tensor([c.policy_name in ("adaptive1", "adaptive2",
                                            "fixed", "naive")
                          for c in r_cpu.cells])
    for f in ("taus", "clipped"):
        if not torch.equal(getattr(r_gpu, f).cpu(), getattr(r_cpu, f)):
            raise AssertionError(f"card vs cpu: {f} differ")
    if not torch.equal(r_gpu.gammas.cpu()[exact], r_cpu.gammas[exact]):
        raise AssertionError("card vs cpu: gammas of ids 0-3 not bitwise")
    rel_small = float(((r_gpu.objective.cpu() - r_cpu.objective).abs()
                       / r_cpu.objective[:, :1].abs()).max())
    if rel_small > OBJ_REL_ENVELOPE:
        raise AssertionError(f"card vs cpu objective rel diff {rel_small}")
    say("5 scan vs fused", f"16 cells at 60000 x 784, 2500 events: fused "
        f"{r_f.elapsed_s:.3f} s, scan {r_s.elapsed_s:.3f} s; taus, clipped, "
        f"gammas bitwise; objective max rel diff {rel:.3g} (envelope "
        f"{OBJ_REL_ENVELOPE:g}) | card vs cpu plain path, 96 cells at "
        f"1200 x 784, 300 events: taus, clipped, gammas (ids 0-3) bitwise, "
        f"objective max rel diff {rel_small:.3g}")


def phase_headline() -> None:
    prob = make_logreg(1200, 150, n_workers=8, seed=0, device=DEV)
    trace = simulate_parameter_server(8, 2500, seed=3)
    gp = 0.99 / prob.L
    prox = L1(lam=prob.lam1)
    res_a = run_piag_logreg(prob, trace, Adaptive1(gamma_prime=gp), prox)
    res_f = run_piag_logreg(prob, trace, FixedStepSize(
        gamma_prime=gp, tau_bound=trace.max_delay()), prox)
    target = float(res_f.objective[-1])
    obj_a = res_a.objective.cpu().numpy()
    it_a = int(np.argmax(obj_a <= target))
    if not (obj_a[-1] <= target + 1e-9 and 0 < it_a < 0.6 * trace.n_events):
        raise AssertionError(f"headline failed: event {it_a}")
    say("6 headline", f"adaptive1 reaches fixed's final objective {target:.6f}"
        f" at event {it_a} of {trace.n_events} "
        f"({it_a / trace.n_events:.3f} < 0.6)")


def phase_fed_main_path(solver: str):
    """api.run of the federated main path; every count set to 0 just
    before, read just after: one B2 (fedasync) or B3 (fedbuff) launch per
    upload per bucket, and no other kernel."""
    mine, others = ((fused_policy_mix_step, (fused_policy_prox_step,
                                             fused_policy_buff_step))
                    if solver == "fedasync" else
                    (fused_policy_buff_step, (fused_policy_prox_step,
                                              fused_policy_mix_step)))
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    fed_bucket_races.seconds = 0.0
    t0 = time.perf_counter()
    res = api.run(fed_spec(solver))
    wall = time.perf_counter() - t0
    race = fed_bucket_races.seconds
    launches = mine.launches
    stray = sum(fn.launches for fn in others)
    B, K = len(res), res.n_events
    if launches <= 0 or launches != K * len(res.grid.buckets()) or stray:
        raise AssertionError(
            f"{solver}: expected one kernel launch per upload per bucket, got "
            f"{launches} (+{stray} of other kernels)")
    obj = res.objective
    if tuple(obj.shape) != (B, K // 10) or not bool(torch.isfinite(obj).all()) \
            or not bool(torch.isfinite(res.gammas).all()):
        raise AssertionError(f"{solver}: output has the wrong shape or is not "
                             "finite")
    if int(res.clipped.sum()) != 0:
        raise AssertionError(f"{solver}: horizon='auto' run clipped a delay")
    if not bool((obj[:, -1] < obj[:, 0]).all()):
        raise AssertionError(f"{solver}: a cell's objective did not decrease")
    final = {p: float(np.mean([float(obj[i, -1]) for i, c in
                               enumerate(res.cells) if c.policy_name == p]))
             for p in FED_POLICIES}
    # one window: wall = resolve (problem build, the buckets' event race,
    # which sizes H and which the servers then reuse) + dispatch (the
    # server loops over the race's rows)
    say(f"10 {solver}", f"api.run 24 cells (hinge, poly, constant x seeds "
        f"0-7), 60000 x 784 logreg, 8 edge clients, {K} uploads"
        + (", |R|=4, eta=0.4" if solver == "fedbuff" else "")
        + f", H={res.horizon}, record_every=10, engine="
        f"{res.spec.execution.engine}: wall {wall:.3f} s = resolve "
        f"{wall - res.elapsed_s:.3f} s (event race {race:.3f} s, problem "
        f"build and rest {wall - res.elapsed_s - race:.3f} s) + server "
        f"dispatch {res.elapsed_s:.3f} s; {B * K / wall:.1f} cell-uploads/s "
        f"end to end, {B * K / res.elapsed_s:.1f} in the dispatch; peak "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, kernel "
        f"launches {launches}; objective {float(obj[0, 0]):.6f} -> mean "
        "final " + ", ".join(f"{p} {v:.6f}" for p, v in final.items()))
    return res, launches


def _fed_compare(a, b, where: str) -> float:
    """Integer leaves and the constant policy's weights bitwise, hinge/poly
    weights within the ulp envelope; returns the objective's max relative
    difference (checked against its envelope)."""
    a_raw, b_raw = a.raw, b.raw
    for f in ("taus", "versions", "clipped"):
        if not torch.equal(getattr(a_raw, f).cpu(), getattr(b_raw, f).cpu()):
            raise AssertionError(f"{where}: {f} not bitwise")
    const = torch.tensor([c.policy_name == "constant" for c in a.cells])
    ga, gb = a.gammas.cpu(), b.gammas.cpu()
    if not torch.equal(ga[const], gb[const]):
        raise AssertionError(f"{where}: constant weights not bitwise")
    ulp = torch.finfo(torch.float32).eps * gb.abs()
    if bool(((ga - gb).abs() > GAMMA_ULP_ENVELOPE * ulp).any()):
        raise AssertionError(f"{where}: weights outside the envelope")
    oa, ob = a.objective.cpu(), b.objective.cpu()
    rel = float(((oa - ob).abs() / ob[:, :1].abs()).max())
    if rel > OBJ_REL_ENVELOPE:
        raise AssertionError(f"{where}: objective rel diff {rel}")
    return rel


def phase_fed_scan_vs_fused() -> None:
    """Both servers, 24 cells at 60000 x 784 (500 uploads): the scan engine
    against the fused one on the card; then 24 cells at 1200 x 784 (200
    uploads) on the card against the CPU plain path."""
    parts = []
    for solver in ("fedasync", "fedbuff"):
        r_f = api.run(fed_spec(solver, n_events=500,
                               execution=dict(engine="fused")))
        r_s = api.run(fed_spec(solver, n_events=500,
                               execution=dict(engine="scan")))
        rel = _fed_compare(r_f, r_s, f"{solver} scan vs fused")
        small = dict(problem=api.ProblemSpec(kind="logreg", params=dict(
            n_samples=1200, dim=784, sparse_like=False, lam1=1e-3,
            lam2=1e-4)), n_events=200)
        r_gpu = api.run(fed_spec(solver, **small))
        r_cpu = api.run(fed_spec(solver, **small,
                                 execution=dict(device="cpu")))
        rel_small = _fed_compare(r_gpu, r_cpu, f"{solver} card vs cpu")
        parts.append(f"{solver}: fused {r_f.elapsed_s:.3f} s, scan "
                     f"{r_s.elapsed_s:.3f} s, objective max rel diff "
                     f"{rel:.3g}; card vs cpu objective {rel_small:.3g}")
    say("11 fed scan vs fused", "24 cells at 60000 x 784, 500 uploads, and "
        "card vs cpu plain path at 1200 x 784, 200 uploads: taus, versions, "
        "clipped and the constant weights bitwise, hinge/poly weights within "
        f"{GAMMA_ULP_ENVELOPE} ulp, objective envelope {OBJ_REL_ENVELOPE:g}"
        " | " + " | ".join(parts))


def phase_fig5() -> None:
    """fig5's headline at its own sizes on the card: 500 x 50 logreg, 8
    clients, 3000 uploads, the legacy trace of seed 1, local_lr 0.5/L."""
    bench = json.load(open(os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "BENCH_fig5_federated.json")))
    prob = make_logreg(500, 50, n_workers=8, seed=0, device=DEV)
    prox = L1(lam=prob.lam1)
    _, objs = solve_centralized(prob, prox, iters=3000)
    p_star = float(objs[-1])
    gap0 = float(prob.P(torch.zeros(prob.dim, device=DEV))) - p_star
    clients = heterogeneous_clients(8, spread=4.0, seed=1, p_straggle=0.05,
                                    p_dropout=0.02)
    trace = simulate_federated(8, 3000, clients, seed=1)
    tau_max = trace.max_delay()
    alpha = 0.4
    fixed = {"fixed_taubound": alpha / (tau_max + 1),
             "fixed_taubound_sqrt": alpha / float(np.sqrt(tau_max + 1)),
             "fixed_taubound_x4": 4 * alpha / (tau_max + 1)}
    pols = {"hinge": make_policy("hinge", alpha, a=0.5, b=16.0),
            "poly": make_policy("poly", alpha, a=0.3),
            **{n: make_policy("constant", g) for n, g in fixed.items()}}
    hits = {}
    for name, pol in pols.items():
        res = run_fedasync_problem(prob, trace, pol, prox,
                                   local_lr=0.5 / prob.L, horizon="auto")
        hits[name] = int(time_to_tolerance(res.objective, 0.2 * gap0,
                                           p_star=p_star))
    gap = best_fixed_vs_adaptive(hits, fixed=set(fixed),
                                 adaptive={"hinge", "poly"})
    best_a, best_f = gap["best_adaptive"], gap["best_fixed"]
    if not (0 <= best_a and (best_f < 0 or best_a < best_f)):
        raise AssertionError(f"fig5 headline failed: adaptive {best_a}, "
                             f"fixed {best_f}")
    say("12 fig5", f"uploads to 0.2 x the initial gap (tau_max {tau_max}): "
        + ", ".join(f"{n} {h}" for n, h in hits.items())
        + f"; best adaptive {best_a} < best fixed {best_f} (reference "
        f"BENCH_fig5_federated.json: {bench['best_adaptive_events']} vs "
        f"{bench['best_fixed_events']})")


def _time_launches(fn, n: int) -> float:
    """Milliseconds per call of ``fn`` over ``n`` back-to-back calls."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _reps(fn, seconds: float = 0.5) -> int:
    """Warm ``fn`` twice; a repetition count that takes about ``seconds``."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return int(max(3, seconds / max(time.perf_counter() - t0, 1e-6)))


def _time_kernel(kernel, plain):
    """``(graph_ms, eager_ms, eager_ms_after, plain_ms)`` per call: the
    kernel replayed from a CUDA graph of up to 100 launches, eager before
    and after the graph, and the plain version eager.  Counts are sized to
    about half a second per loop (at most 2000 eager launches, 200 plain
    calls, 20 graph replays)."""
    n = min(2000, _reps(kernel))
    n_plain = min(200, _reps(plain))
    eager_ms = _time_launches(kernel, n)
    plain_ms = _time_launches(plain, n_plain)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            kernel()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    per_graph = min(100, max(1, n // 20))
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            kernel()
    graph.replay()
    torch.cuda.synchronize()
    graph_ms = _time_launches(graph.replay,
                              max(2, min(20, n // per_graph))) / per_graph
    eager_ms2 = _time_launches(kernel, n)
    return graph_ms, eager_ms, eager_ms2, plain_ms


def phase_fed_timing(kind: str, horizon: int, name: str,
                     max_err: float) -> dict:
    """B2 (``kind='mix'``) or B3 (``'buff'``) at the federated main path's
    shape (24 cells x 784, its H), against its plain version, then timed."""
    B, d = 24, 784
    gen = torch.Generator().manual_seed(3)
    pid = torch.tensor([POLICY_IDS[p] for p in ("hinge", "poly")]
                       + [POLICY_IDS["fixed_like"]]).repeat(B // 3)
    params, st, tau, x, xc, xw, delta, agg = _fed_case(B, d, horizon, pid,
                                                       gen)
    st = st._replace(k=st.k + 4 * horizon)
    params = PolicyParams(*map(_to, params))
    state = StepsizeState(*map(_to, st))
    tau, x, xc, xw, delta, agg = map(_to, (tau, x, xc, xw, delta, agg))
    scale = 0.1
    if kind == "mix":
        fn, ref = fused_policy_mix_step, fused_policy_mix_step_ref
        args = (tau, x, xc)
        nbytes_of, ops = boundary_bytes_mix, B * d * 3
    else:
        fn, ref = fused_policy_buff_step, fused_policy_buff_step_ref
        args = (tau, x, xc, xw, delta, agg, scale)
        nbytes_of, ops = boundary_bytes_buff, B * d * 7
    s1 = StepsizeState(*(t.clone() for t in state))
    s2 = StepsizeState(*(t.clone() for t in state))
    ka, kb = fn(params, s1, *args), ref(params, s2, *args)
    torch.cuda.synchronize()
    worst = {"hinge/poly gamma": 0.0, "hinge/poly x": 0.0}
    _check_fed(kind, params.policy_id, ka, kb, worst, (kind, B, d, horizon))
    max_err = max(max_err, *worst.values())
    cap = torch.clamp(state.k, max=horizon - 1)
    reads = int(((state.k - torch.minimum(tau.clamp(min=0), cap)) > 0).sum())
    nbytes = nbytes_of(d, cells=B, reads_slot=reads)
    bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
    bound_by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S \
        else "operations"
    graph_ms, eager_ms, eager_ms2, plain_ms = _time_kernel(
        lambda: fn(params, state, *args), lambda: ref(params, state, *args))
    label = {"mix": "fused_policy_mix_step (B2)",
             "buff": "fused_policy_buff_step (B3)"}[kind]
    say(f"13 timing {kind}", f"{label} at ({B}, {d}), H={horizon} (kernel "
        f"vs plain here: ids 0-3 bitwise, max abs err "
        f"{max(worst.values()):.3g}): {graph_ms * 1e3:.3f} us/launch "
        f"replayed from a CUDA graph, {eager_ms * 1e3:.3f} / "
        f"{eager_ms2 * 1e3:.3f} us/launch eager (before / after the graph); "
        f"plain version {plain_ms * 1e3:.3f} us; bound "
        f"{bound_ms * 1e3:.4f} us ({nbytes} bytes at "
        f"{HBM_BYTES_PER_S / 1e12:g} TB/s, {ops} ops at "
        f"{F32_OPS_PER_S / 1e12:g} TFLOP/s: {bound_by}); no single PyTorch "
        f"call computes this function; card {name}")
    return dict(ms=graph_ms, eager_ms=eager_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, max_abs_err=max_err)


def phase_timing(horizon: int, name: str, max_err: float) -> dict:
    B, d = 96, 784
    gen = torch.Generator().manual_seed(1)
    pid = torch.tensor([POLICY_IDS[{"fixed": "fixed_like"}.get(p, p)]
                        for p in POLICIES]).repeat(B // len(POLICIES))
    params, st, tau, x, g = _random_case(B, d, horizon, pid, gen)
    st = st._replace(k=st.k + 4 * horizon)  # a run well past its start
    params = PolicyParams(*map(_to, params))
    state = StepsizeState(*map(_to, st))
    tau, x, g = _to(tau), _to(x), _to(g)
    prox = L1(lam=1e-3)
    # the kernel against its plain version at exactly the main path's shape
    s1 = StepsizeState(*(t.clone() for t in state))
    s2 = StepsizeState(*(t.clone() for t in state))
    x1 = x2 = x
    for _ in range(3):
        ga, s1, x1 = fused_policy_prox_step(params, prox, s1, tau, x1, g)
        gb, s2, x2 = fused_policy_prox_step_ref(params, prox, s2, tau, x2, g)
    torch.cuda.synchronize()
    worst = {"bitwise": 0.0, "hinge/poly gamma": 0.0, "hinge/poly x": 0.0,
             "group_l2 x": 0.0}
    _compare("l1", params.policy_id, ga, gb, s1, s2, x1, x2, worst,
             (B, d, horizon, "l1"))
    max_err = max(max_err, *worst.values())
    cap = torch.clamp(state.k, max=horizon - 1)
    reads = int(((state.k - torch.minimum(tau.clamp(min=0), cap)) > 0).sum())
    nbytes = boundary_bytes(horizon, d, cells=B, reads_slot=reads)
    ops = B * d * 4  # x - gamma*g (2), soft threshold (2) per element
    bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
    bound_by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S \
        else "operations"

    def kernel():
        fused_policy_prox_step(params, prox, state, tau, x, g)

    def plain():
        fused_policy_prox_step_ref(params, prox, state, tau, x, g)

    graph_ms, eager_ms, eager_ms2, plain_ms = _time_kernel(kernel, plain)
    say("7 timing", f"fused_policy_prox_step at ({B}, {d}), H={horizon}, "
        f"l1 (kernel vs plain here: ids 0-3 bitwise, max abs err "
        f"{max(worst.values()):.3g}): {graph_ms * 1e3:.3f} us/launch "
        f"replayed from a CUDA graph, "
        f"{eager_ms * 1e3:.3f} / {eager_ms2 * 1e3:.3f} us/launch eager "
        f"(before / after the graph); plain version {plain_ms * 1e3:.3f} us;"
        f" bound {bound_ms * 1e3:.4f} us ({nbytes} bytes at "
        f"{HBM_BYTES_PER_S / 1e12:g} TB/s, {ops} ops at "
        f"{F32_OPS_PER_S / 1e12:g} TFLOP/s: {bound_by}); no single PyTorch "
        f"call computes this function; card {name}")
    return dict(ms=graph_ms, eager_ms=eager_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, max_abs_err=max_err)


def phase_profile(tag: str, run, what: str) -> None:
    """Profile one call of ``run`` (after a warm one): wall, device busy
    and idle share, and the top device ops by time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run()  # warm: problem memo, caching allocator
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            us = ev.time_range.end - ev.time_range.start
            by_name[ev.name] = by_name.get(ev.name, 0.0) + us
    if not by_name:
        say(tag, f"{what}: wall {wall:.3f} s; the profiler recorded no "
            "device events, device busy share not measured")
        return
    busy = sum(by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    say(tag, f"{what}: wall {wall:.3f} s, device "
        f"busy {busy:.3f} s ({busy / wall:.3f}), idle share "
        f"{1 - busy / wall:.3f}; top device ops (s): "
        + "; ".join(f"{n[:60]} {us / 1e6:.4f}" for n, us in top))


# ------------------------------------------------- B6 and serving ----

def _fa_check(got, want) -> float:
    """Max abs error of the kernel against its plain version; raises
    outside the envelope (module constants)."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    env = FA_REL_ENVELOPE * max(float(w.abs().max()), 1e-30)
    if want.dtype == torch.bfloat16:
        _, e = torch.frexp(w.abs())
        env = env + FA_BF16_ULPS * torch.ldexp(torch.ones_like(w), e - 8)
    if bool((err > env).any()):
        raise AssertionError(f"B6 outside its envelope: max err "
                             f"{float(err.max())}")
    return float(err.max()) if err.numel() else 0.0


def phase_fa_vs_plain() -> float:
    """B6 against its plain version: bf16 and f32; d 48, 64, 128; causal,
    bidirectional, window 9; G 1 and 5 query heads per KV head folded into
    rows (positions tiled G times, as ``kernels.ops`` folds them); Sq/Sk
    from 1, 17, 64, 300, 2048; ring holes (kpos -1) in every third case."""
    gen = torch.Generator().manual_seed(6)
    shapes = [(1, 1), (17, 17), (64, 64), (300, 300), (2048, 2048),
              (1, 2048), (17, 300), (300, 2048), (64, 17)]
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    cases = 0
    before = fa.flash_attention_bhsd.launches
    for dtype in (torch.float32, torch.bfloat16):
        for d in (48, 64, 128):
            for causal, window in ((True, None), (False, None), (True, 9)):
                for G in (1, 5):
                    for Sq, Sk in shapes:
                        BH = 2
                        q = torch.randn(BH, G * Sq, d, generator=gen)
                        k, v = (torch.randn(BH, Sk, d, generator=gen)
                                for _ in range(2))
                        q, k, v = (t.to(dtype).to(DEV) for t in (q, k, v))
                        qp = (torch.arange(Sq, dtype=torch.int32)
                              + (Sk - Sq)).repeat(G).to(DEV)
                        kp = torch.arange(Sk, dtype=torch.int32)
                        if cases % 3 == 2:
                            kp = torch.where(torch.arange(Sk) % 3 == 0, -1,
                                             kp).to(torch.int32)
                        kp = kp.to(DEV)
                        kw = dict(causal=causal, window=window,
                                  scale=d ** -0.5)
                        got = fa.flash_attention_bhsd(q, k, v, qp, kp, **kw)
                        want = fa.flash_attention_bhsd_ref(q, k, v, qp, kp,
                                                           **kw)
                        torch.cuda.synchronize()
                        worst[dtype] = max(worst[dtype], _fa_check(got, want))
                        cases += 1
    launches = fa.flash_attention_bhsd.launches - before
    if launches != cases:
        raise AssertionError(f"B6: {launches} launches for {cases} cases")
    say("16 B6 kernel", f"{cases} cases (bf16 and f32; d 48, 64, 128; "
        "causal, bidirectional, window 9; G 1 and 5 heads folded into rows; "
        f"(Sq, Sk) in {shapes}; ring holes in every third case): max abs err"
        f" f32 {worst[torch.float32]:.3g}, bf16 {worst[torch.bfloat16]:.3g}"
        f" (envelopes: f32 {FA_REL_ENVELOPE:g} x max|out|; bf16 "
        f"{FA_BF16_ULPS} bf16 ulps of the plain output + that)")
    return max(worst.values())


def attention_work(BH: int, d: int, qpos, kpos, *, causal: bool,
                   window: Optional[int], itemsize: int) -> Tuple[int, int]:
    """``(bytes, flops)`` one call must move and do on these positions:
    q, k, v and the positions read once and out written once; 4 d flops
    (QK^T and PV) per visible (query, key) pair -- the pairs this run's
    positions make visible, not the full Sq x Sk."""
    qp = np.asarray(qpos.cpu() if torch.is_tensor(qpos) else qpos, np.int64)
    kp = np.asarray(kpos.cpu() if torch.is_tensor(kpos) else kpos, np.int64)
    keys = np.sort(kp[kp >= 0])
    live = qp[qp >= 0]
    hi = (np.searchsorted(keys, live, side="right") if causal
          else np.full(live.shape, keys.size))
    lo = (np.searchsorted(keys, live - window, side="right")
          if window is not None else np.zeros(live.shape, np.int64))
    pairs = int(np.clip(hi - lo, 0, None).sum())
    nbytes = (itemsize * BH * d * (2 * qp.size + 2 * kp.size)
              + 4 * (qp.size + kp.size))
    return nbytes, 4 * d * pairs * BH


def phase_fa_timing(name: str, B: int, S: int, max_err: float) -> dict:
    """B6 at a serving shape of qwen2.5-32b (40 heads over 8 KV heads,
    head dim 128, bf16, causal): kernel vs plain there, then the kernel
    graph-replayed and eager, the plain version, SDPA (the library call,
    never used by the port) and the bound."""
    cfg = get_config(SERVE_ARCH)
    H, KV, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // KV
    gen = torch.Generator(device=DEV).manual_seed(S)
    q = torch.randn(B * KV, G * S, d, generator=gen, device=DEV,
                    dtype=torch.bfloat16)
    k, v = (torch.randn(B * KV, S, d, generator=gen, device=DEV,
                        dtype=torch.bfloat16) for _ in range(2))
    pos = torch.arange(S, dtype=torch.int32, device=DEV)
    qpos = pos.repeat(G)
    scale = d ** -0.5

    def kernel():
        return fa.flash_attention_bhsd(q, k, v, qpos, pos, causal=True,
                                       scale=scale)

    def plain():
        with torch.no_grad():
            return fa.flash_attention_bhsd_ref(q, k, v, qpos, pos,
                                               causal=True, scale=scale)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = _fa_check(got, want)
    del got, want
    graph_ms, eager_ms, _, plain_ms = _time_kernel(kernel, plain)
    torch.cuda.empty_cache()
    # SDPA on the unfolded layout: (B, H, S, d) queries over (B, KV, S, d)
    qs = q.reshape(B, KV, G, S, d).reshape(B, H, S, d)
    ks, vs = k.reshape(B, KV, S, d), v.reshape(B, KV, S, d)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_out = sdpa(qs, ks, vs, is_causal=True, scale=scale, enable_gqa=True)
    lib_err = float((lib_out.float().reshape(B * KV, G * S, d)
                     - kernel().float()).abs().max())

    def library():
        return sdpa(qs, ks, vs, is_causal=True, scale=scale, enable_gqa=True)

    library_ms = _time_launches(library, min(2000, _reps(library)))
    nbytes, flops = attention_work(B * KV, d, qpos, pos, causal=True,
                                   window=None, itemsize=2)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_OPS_PER_S
    bound_ms = max(t_bytes, t_ops) * 1e3
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    say(f"17 B6 timing S={S}", f"flash_attention_bhsd at q ({B * KV}, "
        f"{G * S}, {d}), k/v ({B * KV}, {S}, {d}) bf16 causal (batch {B}, "
        f"prompt {S}; kernel vs plain here max abs err {err:.3g}): "
        f"{graph_ms * 1e3:.3f} us/launch replayed from a CUDA graph, "
        f"{eager_ms * 1e3:.3f} us eager; plain version {plain_ms * 1e3:.3f}"
        f" us; SDPA {library_ms * 1e3:.3f} us (max abs diff to the kernel "
        f"{lib_err:.3g}); bound {bound_ms * 1e3:.4f} us ({nbytes} bytes at "
        f"{HBM_BYTES_PER_S / 1e12:g} TB/s, {flops} flops at "
        f"{BF16_OPS_PER_S / 1e12:g} TFLOP/s: {bound_by}); "
        f"{flops / (graph_ms * 1e9):.1f} TFLOP/s achieved; card {name}")
    return dict(ms=graph_ms, eager_ms=eager_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                max_abs_err=max(max_err, err))


def phase_card_vs_cpu() -> None:
    """qwen2.5-32b.reduced() in float32, the same parameters on both
    devices through ``interop``: greedy ``generate`` on the card (B6) and
    on the CPU (its plain version)."""
    cfg = get_config(SERVE_ARCH).reduced()
    cpu = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = interop.model_params(interop.model_tree(cpu), cfg, device=DEV)
    toks = torch.randint(0, cfg.vocab, (2, 40),
                         generator=torch.Generator().manual_seed(1))
    reset_counts()
    lg, _ = prefill(card, cfg, {"tokens": toks.to(DEV)})
    launches = fa.flash_attention_bhsd.launches
    lc, _ = prefill(cpu, cfg, {"tokens": toks})
    fg, _ = forward(card, cfg, {"tokens": toks.to(DEV)})
    fc, _ = forward(cpu, cfg, {"tokens": toks})
    diff = max(float((lg.cpu() - lc).abs().max()),
               float((fg.cpu() - fc).abs().max()))
    if launches != cfg.n_layers or diff > LOGIT_F32_ENVELOPE:
        raise AssertionError(f"card vs cpu: {launches} B6 launches, logits "
                             f"differ by {diff}")
    og, _ = generate(cfg, card, toks.to(DEV), 16)
    oc, _ = generate(cfg, cpu, toks, 16)
    same = torch.equal(og.cpu(), oc)
    if not same:
        raise AssertionError("card vs cpu: greedy tokens differ")
    say("18 card vs cpu", f"{cfg.name} (f32, {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, attention_impl {cfg.attention_impl}), params "
        f"carried by interop: prefill and forward logits max abs diff "
        f"{diff:.3g} (envelope {LOGIT_F32_ENVELOPE:g}), B6 launches per "
        f"prefill {launches}; greedy generate 2 x (40 + 16) tokens equal: "
        f"{same}")


def phase_serve_model(name: str):
    """The full qwen2.5-32b on the card from the port's initializer."""
    cfg = get_config(SERVE_ARCH)
    if (cfg.n_layers, cfg.d_model, cfg.param_dtype, cfg.attention_impl) != \
            (64, 5120, "bfloat16", "pallas"):
        raise AssertionError(f"unexpected serving config {cfg}")
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                        device=DEV)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    torch.cuda.empty_cache()
    say("19 model", f"{cfg.name}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} KV heads,"
        f" d_ff {cfg.d_ff}, vocab {cfg.vocab}, bf16: {n} params "
        f"({n * 2 / 1e9:.2f} GB) initialized on the card in "
        f"{time.perf_counter() - t0:.3f} s; allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB; card {name}")
    return cfg, model


def phase_generate(tag: str, cfg, model, batch: int, prompt: int,
                   gen: int) -> int:
    """``generate`` with every count set to 0 just before and read just
    after: one B6 launch per layer for the one prefill, no other kernel."""
    prompts = torch.randint(0, cfg.vocab, (batch, prompt),
                            generator=torch.Generator(device=DEV)
                            .manual_seed(prompt), device=DEV,
                            dtype=torch.int32)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out, stats = generate(cfg, model, prompts, gen)
    launches = fa.flash_attention_bhsd.launches
    stray = sum(fn.launches for fn in COUNTERS[:3])
    if launches != cfg.n_layers or stray:
        raise AssertionError(f"{tag}: {launches} B6 launches for one "
                             f"prefill (+{stray} of other kernels)")
    new = out[:, prompt:]
    if tuple(out.shape) != (batch, prompt + gen) or \
            not torch.equal(out[:, :prompt], prompts) or \
            bool(((new < 0) | (new >= cfg.vocab)).any()):
        raise AssertionError(f"{tag}: bad output {tuple(out.shape)}")
    say(tag, f"generate {cfg.name} batch {batch}, prompt {prompt}, gen "
        f"{gen}: prefill {stats['prefill_s']:.3f} s "
        f"({batch * prompt / stats['prefill_s']:.1f} tok/s), decode "
        f"{stats['decode_s']:.3f} s ({stats['tok_per_s']:.2f} tok/s, "
        f"{stats['decode_s'] / gen * 1e3:.2f} ms/step), B6 launches per "
        f"prefill {launches}, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def phase_logits_finite(cfg, model) -> None:
    toks = torch.randint(0, cfg.vocab, (2, 64), device=DEV,
                         generator=torch.Generator(device=DEV).manual_seed(9))
    logits, cache = prefill(model, cfg, {"tokens": toks})
    if tuple(logits.shape) != (2, 1, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()) or \
            tuple(cache["k"].shape) != (cfg.n_layers, 2, 64, cfg.n_kv_heads,
                                        cfg.head_dim):
        raise AssertionError("prefill logits or cache malformed")
    say("22 logits", f"prefill (2, 64): logits {tuple(logits.shape)} finite, "
        f"|logit| max {float(logits.float().abs().max()):.3f}, cache k "
        f"{tuple(cache['k'].shape)}")


def phase_batcher(cfg, model) -> None:
    """8 requests (prompts 32-1024, max_new 8-32) through 4 slots of 2048;
    each greedy output equals a single-request generate of it."""
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, int(
        rng.integers(32, 1025))).astype(np.int32),
        max_new=int(rng.integers(8, 33))) for i in range(8)]
    cb = ContinuousBatcher(cfg, model, max_slots=4, max_len=2048)
    reset_counts()
    for r in reqs:
        cb.submit(r)
    stats = cb.run_until_idle()
    launches = fa.flash_attention_bhsd.launches
    if stats["completed"] != 8 or launches != 8 * cfg.n_layers:
        raise AssertionError(f"batcher: {stats}, B6 launches {launches}")
    ttft = np.array([r.t_first_token - r.arrived_at for r in reqs])
    for r in reqs:
        out, _ = generate(cfg, model, r.prompt[None, :], r.max_new)
        if not np.array_equal(out[0, len(r.prompt):].cpu().numpy(),
                              r.output):
            raise AssertionError(f"batcher request {r.rid} differs from "
                                 "single-request generate")
    say("21 batcher", f"ContinuousBatcher {cfg.name}, 4 slots x 2048: "
        f"completed {stats['completed']}, tokens {stats['tokens']}, ticks "
        f"{stats['ticks']}, wall {stats['wall_s']:.3f} s, "
        f"{stats['tok_per_s']:.2f} tok/s; time to first token median "
        f"{np.median(ttft):.3f} s, max {ttft.max():.3f} s; prompts "
        f"{sorted(len(r.prompt) for r in reqs)}, max_new "
        f"{[r.max_new for r in reqs]}; B6 launches {launches} (8 prefills); "
        "every output equals its single-request generate")


def main() -> None:
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = phase_device()
    phase_build()
    # the PIAG and federated paths (B1-B3)
    max_err = phase_kernel_vs_plain()
    fed_err = phase_fed_kernels_vs_plain()
    res, launches = phase_main_path()
    horizon = res.horizon
    del res
    phase_scan_vs_fused()
    phase_headline()
    timing = phase_timing(horizon, name, max_err)
    phase_profile("8 profile", lambda: api.run(main_spec(n_events=200)),
                  "api.run PIAG 200 events x 96 cells (resolve included)")
    fed = {}
    for solver in ("fedasync", "fedbuff"):
        r, n = phase_fed_main_path(solver)
        fed[solver] = (r.horizon, n)
        del r
    phase_fed_scan_vs_fused()
    phase_fig5()
    t_mix = phase_fed_timing("mix", fed["fedasync"][0], name, fed_err)
    t_buff = phase_fed_timing("buff", fed["fedbuff"][0], name, fed_err)
    phase_profile("14 fed profile",
                  lambda: api.run(fed_spec("fedasync", n_events=200)),
                  "api.run FedAsync 200 uploads x 24 cells (resolve "
                  "included)")
    # the serving path (B6): the kernel alone first, then the full model
    fa_err = phase_fa_vs_plain()
    t_fa = phase_fa_timing(name, 4, 64, fa_err)
    t_fa_long = phase_fa_timing(name, 1, 8192, fa_err)
    t_fa["max_abs_err"] = max(t_fa["max_abs_err"], t_fa_long["max_abs_err"])
    phase_card_vs_cpu()
    torch.cuda.empty_cache()
    cfg, model = phase_serve_model(name)
    fa_launches = phase_generate("20 generate a", cfg, model, 4, 64, 32)
    phase_generate("20 generate b", cfg, model, 1, 8192, 8)
    phase_batcher(cfg, model)
    phase_logits_finite(cfg, model)
    phase_profile("23 serve profile",
                  lambda: generate(cfg, model, torch.randint(
                      0, cfg.vocab, (4, 64), device=DEV,
                      generator=torch.Generator(device=DEV).manual_seed(3)),
                      32),
                  f"generate {cfg.name} batch 4, prompt 64, gen 32 (one "
                  "prefill and 32 decode steps)")
    rows = [("fused_policy_prox_step", KERNEL_SOURCE, REPLACES, launches,
             timing),
            ("fused_policy_mix_step", KERNEL_SOURCE, REPLACES_MIX,
             fed["fedasync"][1], t_mix),
            ("fused_policy_buff_step", KERNEL_SOURCE, REPLACES_BUFF,
             fed["fedbuff"][1], t_buff),
            ("flash_attention_bhsd", FA_SOURCE, REPLACES_FA, fa_launches,
             t_fa)]
    kernels = {"kernels": [dict(
        name=kname, route="cuda", source=src, replaces=rep,
        launches=n, max_abs_err=t["max_abs_err"], ms=t["ms"],
        eager_ms=t["eager_ms"], plain_ms=t["plain_ms"],
        bound_ms=t["bound_ms"], bound_by=t["bound_by"],
        library_ms=t.get("library_ms"))
        for kname, src, rep, n, t in rows]}
    say("24 kernels", f"smoke finished in {time.perf_counter() - t0:.1f} s")
    print(json.dumps(kernels), flush=True)
    print(card(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
