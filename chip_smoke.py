"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
nvcc per source, all started together), holds each against its plain
PyTorch version on the card, and drives the port's main paths:

* ``repro_torch.api.run`` for PIAG, Async-BCD (m 20 blocks), FedAsync and
  FedBuff (batched, default engine) at the paper's MNIST shape, through
  kernels B1-B3, and each of the four with the in-loop telemetry on;
* the sharded backend (``api.run(backend="sharded")``, ``sweep.shard``)
  for all four solvers on meshes of the card (once, listed twice, and
  with a data axis of 2), the 512-cell mega grid and the
  ``launch.sweep`` CLI, each row launching B1-B3 on its card (S1-S4);
* fault injection (``repro_torch.faults``: the reference's threefry bits
  drawn on the card, the guarded step of all four solvers under
  ``engine='scan'``, fig_faults's chaos figure) and checkpointed resume
  (``api.run(spec, resume=dir)``, which reruns B1-B3 on the unfinished
  bucket only);
* ``repro_torch.staticcheck`` (SC): the kernel-dispatch lint of
  ``src/repro_torch`` and its six fixtures (F1-F3's counterparts among
  them), the op-trace contracts of all four solvers at scan level and as
  the batched and one-device sharded programs at mnist-96's problem
  shapes (one B1, B2 or B3 launch an event or upload in every fused
  trace), and cache-key completeness at the reference's tiny spec;
* ``repro_torch.kernels.ops`` (``prox_step``, ``prox_step_tree``,
  ``rmsnorm_fused``, ``ssd_scan_pallas``) at ``benchmarks/kernel_bench.py``'s
  shapes and at full model width (one qwen2.5-32b layer's parameters, a
  qwen2.5-32b prefill's activations, one mamba2-780m layer's SSD on an
  8192-token prompt), through kernels B4, B5 and B7;
* serving qwen2.5-32b at full width and depth (64 layers, bfloat16,
  random weights from the port's initializer on the card) through
  ``launch.serve.generate`` and ``serving.ContinuousBatcher``, whose
  prefill runs the flash-attention kernel B6 on its tensor-core route
  (float32 and bf16 at d 48 take its SIMT route, swept in phase 16);
  then, with it freed, mamba2-780m (48 Mamba2 layers, no kernel: the
  block calls the SSD scan in torch ops, as the reference's does) and
  qwen2-moe-a2.7b (24 layers, 60 experts, capacity dispatch; B6 in every
  prefill) at full width and depth the same way (M1, M2), and both
  families' reduced configs card against CPU (M3); then zamba2-2.7b (the
  hybrid trunk, all 54 layers; B6 at d 80 on its SIMT route for the
  shared block, N1), deepseek-v2-236b (MLA + 160 experts, 4 of 60
  layers; B6 at q/k 192 over v 128, N2), qwen2-vl-72b (8 of 80 layers;
  text and an image batch of embeddings with M-RoPE grids, N3) and
  hubert-xlarge (the 48-layer encoder over frame embeddings, N4), and
  the four reduced configs card against CPU with the full head dims
  (N5); phase 17b holds B6's SIMT instances at d 80 and 192 over 128
  against their plain version at those models' prefill shapes;
* the federated trainer ``launch.train_federated``: CI's convex run, 400
  uploads through B2 and with ``buffer_size=4`` through B3, card against
  CPU (FT1), and the 25m transformer preset's host loop (FT2, no kernel).

* training: ``launch.train.run_training`` and ``launch.train_bcd`` on the
  100m preset at full width and depth (TR1, TR3), card against CPU at a
  tiny config (TR2), the threaded ``PIAGServer`` and ``SharedMemoryBCD``
  on real threads with a stream each (RT1, RT2), their crash and respawn
  contract (RT3), and ``run_piag_lipschitz`` (L1); no hand-written kernel
  runs there.  ``python3 chip_smoke.py --only-training`` runs these alone
  and prints no result.

Each phase prints one line; any failure raises and the script exits
non-zero.  The last three lines are the kernels' JSON, the card's name and
power limit, and ``{"ok": true, "device": ...}``.  Exits non-zero without
a result when no CUDA device is present.
"""
import contextlib
import dataclasses
import io
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
from repro_torch.core.bcd import run_bcd_logreg  # noqa: E402
from repro_torch.core.engine import (heterogeneous_workers,  # noqa: E402
                                     simulate_parameter_server,
                                     simulate_shared_memory, trace_scan)
from repro_torch.core.piag import (run_piag_lipschitz,  # noqa: E402
                                   run_piag_logreg)
from repro_torch.core.runtime import (PIAGServer,  # noqa: E402
                                      SharedMemoryBCD, WorkerCrash)
from repro_torch.core.theory import check_principle  # noqa: E402
from repro_torch.core.problems import (make_logreg,  # noqa: E402
                                       solve_centralized)
from repro_torch.core.prox import L1, make_prox  # noqa: E402
from repro_torch.core.stepsize import (Adaptive1, Adaptive2,  # noqa: E402
                                       DavisFixed, FixedStepSize,
                                       StepsizeState, SunDengFixed,
                                       make_policy)
from repro_torch.faults import (FAULT_PRESETS, FaultSpec,  # noqa: E402
                                FaultState, summarize_faults)
from repro_torch.faults import inject as finj  # noqa: E402
from repro_torch.federated import (heterogeneous_clients,  # noqa: E402
                                   run_fedasync_problem, simulate_federated)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import prox_step as px  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402
from repro_torch.kernels.fused_step import (  # noqa: E402
    boundary_bytes, boundary_bytes_buff, boundary_bytes_mix,
    fused_policy_buff_step, fused_policy_buff_step_ref,
    fused_policy_mix_step, fused_policy_mix_step_ref, fused_policy_prox_step,
    fused_policy_prox_step_ref, _launch_floor)
from repro_torch.launch import sweep as tsweep  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch import train_bcd as tbcd  # noqa: E402
from repro_torch.launch import train_federated as tfed  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.data import EmbedStream  # noqa: E402
from repro_torch.models import (decode_step, forward,  # noqa: E402
                                init_params, prefill)
from repro_torch.models.ssm import ssd_chunked  # noqa: E402
from repro_torch.models.transformer import (Layer,  # noqa: E402
                                            Transformer)
from repro_torch.serving import ContinuousBatcher, Request  # noqa: E402
from repro_torch.sweep.policies import POLICY_IDS, PolicyParams  # noqa: E402
from repro_torch.sweep.cache import clear_program_cache  # noqa: E402
from repro_torch.sweep.grid import make_grid  # noqa: E402
from repro_torch.sweep.runners import fed_bucket_races  # noqa: E402
from repro_torch.mesh import cell_mesh, grid_mesh  # noqa: E402
from repro_torch.staticcheck import cachekey as sc_cachekey  # noqa: E402
from repro_torch.staticcheck import contracts as sc_contracts  # noqa: E402
from repro_torch.staticcheck import lint as sc_lint  # noqa: E402

DEV = torch.device("cuda")
CARD = torch.device("cuda", 0)  # the card of the sharded phases' meshes
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3, NVIDIA data sheet
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
TF32_OPS_PER_S = 495e12        # H100 SXM TF32 dense tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 dense tensor cores
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/fused_step.cu"
FA_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
REPLACES = "src/repro/kernels/fused_step.py:209"
REPLACES_MIX = "src/repro/kernels/fused_step.py:240"
REPLACES_BUFF = "src/repro/kernels/fused_step.py:279"
REPLACES_FA = "src/repro/kernels/flash_attention.py:104"
PROX_SOURCE = "src/repro_torch/kernels/csrc/prox_step.cu"
RMS_SOURCE = "src/repro_torch/kernels/csrc/rmsnorm.cu"
SSD_SOURCE = "src/repro_torch/kernels/csrc/ssd_scan.cu"
REPLACES_PROX = "src/repro/kernels/prox_step.py:60"
REPLACES_RMS = "src/repro/kernels/rmsnorm.py:46"
REPLACES_SSD = "src/repro/kernels/ssd_scan.py:66"
SOURCES = (("fused_step", KERNEL_SOURCE), ("flash_attention", FA_SOURCE),
           ("prox_step", PROX_SOURCE), ("rmsnorm", RMS_SOURCE),
           ("ssd_scan", SSD_SOURCE))
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
# B4 is bitwise to its plain version.  B5: float32 within 8 ulps of each
# element (the row sum runs in another order), bfloat16 within one bf16
# ulp, and bitwise equal on all but 1e-3 of a phase's bfloat16 elements
# (both round once from float32; the model layer's order, cast and then
# scale, differs on about a quarter).  B7: within 1e-5 of max|out| (float32
# sums in other orders), plus one bf16 ulp where the output is bfloat16.
RMS_F32_ULPS = 8
RMS_BF16_UNEQUAL = 1e-3
SSD_REL_ENVELOPE = 1e-5
PROX_L1_FLOPS = 5              # per element: the FMA, |y| - t, max, sign
SERVE_ARCH = "qwen2.5-32b"
SSM_ARCH = "mamba2-780m"
MOE_ARCH = "qwen2-moe-a2.7b"
HYBRID_ARCH = "zamba2-2.7b"
MLA_ARCH = "deepseek-v2-236b"
VLM_ARCH = "qwen2-vl-72b"
AUDIO_ARCH = "hubert-xlarge"
# depth cut where one card cannot hold the model beside an 8192-token
# prefill (deepseek-v2: 3.97 B params a layer; qwen2-vl: 80 layers of
# d_model 8192); widths, heads, experts and vocab are the configs' own
SERVE_DEPTH = {MLA_ARCH: 4, VLM_ARCH: 8}
LONG_PROMPT = 8192             # the serving phases' (b) prompt
ENCODER_SHAPES = ((8, 1500), (1, 8192))   # N4: 30-s clips at 50 Hz; long
FA_NEW_SHAPES = ((4, 64), (1, 8192))      # 17b: (batch, prompt)
COUNTERS = (fused_policy_prox_step, fused_policy_mix_step,
            fused_policy_buff_step, fa.flash_attention_bhsd, px.prox_step,
            rn.rmsnorm, ss.ssd_intra_chunk)


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


def bcd_spec(**over):
    """The Async-BCD main path: mnist-96's grid (6 policies x 4 seeds x 4
    topologies, 10 workers) over m = 20 blocks of 40 coordinates."""
    return main_spec(**{"solver": api.SolverSpec(name="bcd", horizon="auto",
                                                 m=20), **over})


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
    fa.flash_attention_bhsd.launches_tc = 0


def _fa_routes(tag: str, launches: int, tc: bool = True) -> str:
    """Raise unless every B6 launch since the last reset took the
    tensor-core route (``tc``: a bf16 model at d 64 or 128) or every one
    the SIMT route; the counts as text."""
    f = fa.flash_attention_bhsd
    if f.launches != launches or f.launches_tc != (launches if tc else 0):
        raise AssertionError(f"{tag}: {launches} B6 launches expected on the "
                             f"{'tensor-core' if tc else 'SIMT'} route, "
                             f"{f.launches} made, {f.launches_tc} of them "
                             "on the tensor-core route")
    return (f"B6 launches {launches}, all on the "
            f"{'tensor-core' if tc else 'SIMT'} route")


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
    """Every kernel library, one nvcc each, all started together."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        libs = list(pool.map(build.load, [n for n, _ in SOURCES]))
    wall = time.perf_counter() - t0
    for built, (_, src) in zip(libs, SOURCES):
        regs = re.findall(r"Used (\d+) registers", built.ptxas)
        spill = re.findall(r"(\d+) bytes spill stores", built.ptxas)
        say("2 build", f"{built.path.name} built in "
            f"{built.build_seconds:.3f} s (0 = reused) from {src}; ptxas: "
            f"{len(regs)} kernels, registers {','.join(regs)}, spill stores "
            f"{','.join(spill)} bytes")
    say("2 build", f"{len(libs)} libraries in {wall:.3f} s wall (parallel "
        "nvcc)")
    # the wrapper's own guard: it refuses a B6 build whose tensor-core or
    # SIMT instances use local memory (spills)
    lib = fa._lib()
    say("2 build", "B6 tensor-core local memory, bytes per thread by head "
        f"dim: {fa._tc_local_bytes(lib)}; SIMT by (dtype, d, dv): "
        f"{fa._simt_local_bytes(lib)} (the wrapper refuses a build where "
        "any is not 0)")
    b7 = ss.local_bytes(build.load("ssd_scan").ptxas)
    if len(b7) != 7 or any(b7.values()):
        raise AssertionError(f"B7 instances with local memory: {b7}")
    say("2 build", f"B7: {len(b7)} instances, stack and spill bytes "
        f"{sorted(set(b7.values()))} (the wrapper refuses a build where any "
        "is not 0)")


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


def _to_offset(t, offset: int):
    """``t`` on the card as a contiguous view that starts ``offset`` floats
    into its storage: with an odd offset no row is 16-byte aligned, and the
    kernels take their scalar path."""
    flat = torch.empty(t.numel() + offset, dtype=t.dtype, device=DEV)
    flat[offset:].copy_(t.reshape(-1))
    return flat[offset:].view(t.shape)


def phase_kernel_vs_plain() -> float:
    """Every (B, d, H) x prox x policy id, three consecutive events from a
    state whose k and tau sit on the window edges, plus unaligned rows (an
    offset view, the kernel's scalar path) at the main path's width.
    Exact: k, clipped.  Bitwise: gamma, total, cumbuf for ids 0-3 and x_new
    for ids 0-3 under every prox but group_l2.  Envelopes elsewhere
    (module constants)."""
    gen = torch.Generator().manual_seed(0)
    worst = {"bitwise": 0.0, "hinge/poly gamma": 0.0, "hinge/poly x": 0.0,
             "group_l2 x": 0.0}
    cases = 0
    shapes = [(B, d, H, 0) for B in (1, 96) for d in (1, 127, 784, 1000, 4097)
              for H in (2, 512, 4096)]
    shapes += [(96, 784, 512, 1), (96, 784, 4096, 1)]
    for B, d, H, offset in shapes:
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
                tau1 = _to(tau)
                x1, g1 = _to_offset(x, offset), _to_offset(g, offset)
                x2 = x1
                for _ in range(3):
                    ga, s1, x1 = fused_policy_prox_step(
                        p1, prox, s1, tau1, x1, g1, fma_push)
                    gb, s2, x2 = fused_policy_prox_step_ref(
                        p1, prox, s2, tau1, x2, g1, fma_push)
                torch.cuda.synchronize()
                cases += 1
                _compare(name, pid.to(DEV), ga, gb, s1, s2, x1, x2, worst,
                         (B, d, H, offset, name))
    say("3 kernel", f"{cases} cases (B in 1,96; d in 1,127,784,1000,4097; H "
        f"in 2,512,4096; and (96, 784) rows one float off 16-byte alignment "
        f"at H 512, 4096; 6 prox ops; policy ids 0-5; k/tau on the window "
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
    784, 4097 and the main path's (B, d, H); H in 2, 64, 4096; unaligned
    rows (an offset view, the scalar path) at (24, 784); k/tau on the
    window edges; all six policy ids; agg at 0 and 1; fma_push both ways;
    three consecutive events each."""
    gen = torch.Generator().manual_seed(2)
    worst = {"hinge/poly gamma": 0.0, "hinge/poly x": 0.0}
    shapes = [(B, d, H, 0) for B in (1, 24) for d in (1, 127, 784, 4097)
              for H in (2, 64, 4096)] + [(*main_shape, 0), (24, 784, 64, 1),
                                         (24, 784, 4096, 1)]
    cases = 0
    for B, d, H, offset in shapes:
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
                tau, agg = _to(tau), _to(agg)
                x, xc, xw, delta = (_to_offset(v, offset)
                                    for v in (x, xc, xw, delta))
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
                _check_fed(kind, pid.to(DEV), ka, kb, worst,
                           (kind, B, d, H, offset))
    say("3b fed kernels", f"{cases} cases of B2 (mix) and B3 (buff) (B in "
        f"1,24; d in 1,127,784,4097 and {tuple(main_shape)}; H in 2,64,4096; "
        "(24, 784) rows one float off 16-byte alignment at H 64, 4096; "
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


def _time_kernel(kernel, plain=None):
    """``(graph_ms, eager_ms, eager_ms_after, plain_ms)`` per call: the
    kernel replayed from a CUDA graph of up to 100 launches, eager before
    and after the graph, and the plain version eager (None without one).
    Counts are sized to about half a second per loop (at most 2000 eager
    launches, 200 plain calls, 20 graph replays)."""
    n = min(2000, _reps(kernel))
    eager_ms = _time_launches(kernel, n)
    plain_ms = None if plain is None else _time_launches(
        plain, min(200, _reps(plain)))
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


def _floor(B: int) -> dict:
    """The empty kernel of ``fused_step.cu`` with ``B`` blocks of 256 (the
    event kernels' grid), timed as they are: the launch floor."""
    graph_ms, eager_ms, _, _ = _time_kernel(lambda: _launch_floor(B))
    return dict(floor_ms=graph_ms, floor_eager_ms=eager_ms)


def _floor_text(t: dict) -> str:
    return (f"launch floor (empty kernel, same grid) "
            f"{t['floor_ms'] * 1e3:.3f} us replayed, "
            f"{t['floor_eager_ms'] * 1e3:.3f} eager; above it "
            f"{(t['ms'] - t['floor_ms']) * 1e3:.3f} us replayed")


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
    t = dict(ms=graph_ms, eager_ms=eager_ms, plain_ms=plain_ms,
             bound_ms=bound_ms, bound_by=bound_by, max_abs_err=max_err,
             **_floor(B))
    say(f"13 timing {kind}", f"{label} at ({B}, {d}), H={horizon} (kernel "
        f"vs plain here: ids 0-3 bitwise, max abs err "
        f"{max(worst.values()):.3g}): {graph_ms * 1e3:.3f} us/launch "
        f"replayed from a CUDA graph, {eager_ms * 1e3:.3f} / "
        f"{eager_ms2 * 1e3:.3f} us/launch eager (before / after the graph); "
        f"{_floor_text(t)}; plain version {plain_ms * 1e3:.3f} us; bound "
        f"{bound_ms * 1e3:.4f} us ({nbytes} bytes at "
        f"{HBM_BYTES_PER_S / 1e12:g} TB/s, {ops} ops at "
        f"{F32_OPS_PER_S / 1e12:g} TFLOP/s: {bound_by}); no single PyTorch "
        f"call computes this function; card {name}")
    return t


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
    t = dict(ms=graph_ms, eager_ms=eager_ms, plain_ms=plain_ms,
             bound_ms=bound_ms, bound_by=bound_by, max_abs_err=max_err,
             **_floor(B))
    say("7 timing", f"fused_policy_prox_step at ({B}, {d}), H={horizon}, "
        f"l1 (kernel vs plain here: ids 0-3 bitwise, max abs err "
        f"{max(worst.values()):.3g}): {graph_ms * 1e3:.3f} us/launch "
        f"replayed from a CUDA graph, "
        f"{eager_ms * 1e3:.3f} / {eager_ms2 * 1e3:.3f} us/launch eager "
        f"(before / after the graph); {_floor_text(t)}; plain version "
        f"{plain_ms * 1e3:.3f} us; bound {bound_ms * 1e3:.4f} us ({nbytes} "
        f"bytes at {HBM_BYTES_PER_S / 1e12:g} TB/s, {ops} ops at "
        f"{F32_OPS_PER_S / 1e12:g} TFLOP/s: {bound_by}); no single PyTorch "
        f"call computes this function; card {name}")
    return t


LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaLaunchKernelExC")


def _profile(run, warm: bool = True) -> Tuple[float, dict, int]:
    """One profiled call of ``run`` (after a warm one unless ``warm`` is
    false): its wall seconds, the device time of each kernel name, in us,
    and the host's kernel launch calls.  Read from the profiler's raw
    results: building its host-op records took about a minute for a
    serving run of ~100 000 launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if warm:
        run()  # problem memo, caching allocator
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name, launch_calls = {}, 0
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA:
            by_name[ev.name()] = (by_name.get(ev.name(), 0.0)
                                  + ev.duration_ns() / 1e3)
        elif ev.name() in LAUNCH_CALLS:
            launch_calls += 1
    return wall, by_name, launch_calls


def phase_profile(tag: str, run, what: str, warm: bool = True) -> None:
    """Profile one call of ``run`` (after a warm one unless ``warm`` is
    false): wall, device busy and idle share, the host's kernel launch
    calls, and the top device ops by time."""
    wall, by_name, launch_calls = _profile(run, warm)
    if not by_name:
        say(tag, f"{what}: wall {wall:.3f} s; the profiler recorded no "
            "device events, device busy share not measured")
        return
    busy = sum(by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    say(tag, f"{what}: wall {wall:.3f} s, device "
        f"busy {busy:.3f} s ({busy / wall:.3f}), idle share "
        f"{1 - busy / wall:.3f}; {launch_calls} kernel launch calls on the "
        "host; top device ops (s): "
        + "; ".join(f"{n[:60]} {us / 1e6:.4f}" for n, us in top))


# ------------------------------------------ Async-BCD and telemetry ----

def phase_bcd_main_path():
    """api.run of the Async-BCD main path; every count set to 0 just
    before, read just after: one B1 launch per event per bucket on the
    gathered (96, 40) block rows, and no B2 or B3 launch."""
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = api.run(bcd_spec())
    wall = time.perf_counter() - t0
    launches = fused_policy_prox_step.launches
    if fused_policy_mix_step.launches or fused_policy_buff_step.launches:
        raise AssertionError("the BCD path launched a federated kernel")
    B, K = len(res), res.n_events
    if launches <= 0 or launches != K * len(res.grid.buckets()):
        raise AssertionError(f"BCD: expected one B1 launch per event per "
                             f"bucket, got {launches}")
    obj = res.objective
    if tuple(obj.shape) != (B, K // 10) or not bool(torch.isfinite(obj).all()) \
            or not bool(torch.isfinite(res.gammas).all()) \
            or not bool(torch.isfinite(res.x).all()):
        raise AssertionError("BCD output has the wrong shape or is not finite")
    if int(res.clipped.sum()) != 0:
        raise AssertionError("BCD horizon='auto' run clipped a delay")
    if not bool((obj[:, -1] < obj[:, 0]).all()):
        raise AssertionError("BCD: a cell's objective did not decrease")
    blocks = res.extras["blocks"]
    final = {p: float(np.mean([float(obj[i, -1]) for i, c in
                               enumerate(res.cells) if c.policy_name == p]))
             for p in POLICIES}
    say("4b bcd main path", f"api.run 96 cells (6 policies x 4 seeds x 4 "
        f"topologies), 60000 x 784 logreg, 10 workers, m=20 blocks of 40, "
        f"{K} events, H={res.horizon} (tau_bar={res.tau_bar}), record_every"
        f"=10, engine={res.spec.execution.engine}: wall {wall:.3f} s "
        f"(resolve + build included), dispatch {res.elapsed_s:.3f} s, "
        f"{B * K / res.elapsed_s:.1f} cell-events/s, peak "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, B1 launches "
        f"{launches}, blocks recorded {int(blocks.min())}..."
        f"{int(blocks.max())}; objective {float(obj[0, 0]):.6f} -> mean "
        "final " + ", ".join(f"{p} {v:.6f}" for p, v in final.items()))
    return res, launches


def phase_bcd_scan_vs_fused() -> None:
    """16 cells at full size: both engines on the card, bitwise on every
    leaf; then a small spec on the card against the CPU plain path."""
    sub = dict(policies=api.PolicyGridSpec(
        names=("adaptive1", "adaptive2", "fixed", "naive"), seeds=(0,)))
    r_f = api.run(bcd_spec(**sub, execution=dict(engine="fused")))
    r_s = api.run(bcd_spec(**sub, execution=dict(engine="scan")))
    for f in ("x", "objective", "gammas", "taus", "blocks", "clipped"):
        if not torch.equal(getattr(r_f.raw, f), getattr(r_s.raw, f)):
            raise AssertionError(f"BCD scan vs fused: {f} not bitwise")
    small = dict(problem=api.ProblemSpec(kind="logreg", params=dict(
        n_samples=1200, dim=784, sparse_like=False, lam1=1e-3, lam2=1e-4)),
        n_events=300)
    r_gpu = api.run(bcd_spec(**small))
    r_cpu = api.run(bcd_spec(**small, execution=dict(device="cpu")))
    exact = torch.tensor([c.policy_name in ("adaptive1", "adaptive2",
                                            "fixed", "naive")
                          for c in r_cpu.cells])
    for f in ("taus", "clipped", "blocks"):
        if not torch.equal(getattr(r_gpu.raw, f).cpu(), getattr(r_cpu.raw, f)):
            raise AssertionError(f"BCD card vs cpu: {f} differ")
    if not torch.equal(r_gpu.gammas.cpu()[exact], r_cpu.gammas[exact]):
        raise AssertionError("BCD card vs cpu: gammas of ids 0-3 not bitwise")
    rel = float(((r_gpu.objective.cpu() - r_cpu.objective).abs()
                 / r_cpu.objective[:, :1].abs()).max())
    if not rel <= OBJ_REL_ENVELOPE:
        raise AssertionError(f"BCD card vs cpu objective rel diff {rel}")
    say("5b bcd scan vs fused", f"16 cells at 60000 x 784, m=20, 2500 "
        f"events: fused {r_f.elapsed_s:.3f} s, scan {r_s.elapsed_s:.3f} s; "
        f"x, objective, gammas, taus, blocks, clipped bitwise | card vs cpu "
        f"plain path, 96 cells at 1200 x 784, 300 events: taus, blocks, "
        f"clipped, gammas (ids 0-3) bitwise, objective max rel diff "
        f"{rel:.3g} (envelope {OBJ_REL_ENVELOPE:g})")


def phase_fig4() -> None:
    """Paper Fig. 4 at the CPU test's size (tests/test_torch_bcd.py,
    ``test_fig4_comparison_matches_reference``): adaptive1 against the
    Sun-Deng and Davis fixed step-sizes on one shared-memory trace; the
    reference's final objectives put adaptive1 below both there."""
    prob = make_logreg(600, 60, n_workers=8, sparse_like=False, seed=0,
                       device=DEV)
    m = 10
    trace = simulate_shared_memory(8, 800, m, seed=4)
    tb = trace.max_delay()
    lh = prob.block_smoothness(m)
    gp = 0.99 / lh
    ratio = float(2.0 * prob.L / (lh * np.sqrt(m)))
    prox = L1(lam=prob.lam1)
    final = {}
    for name, pol in (("adaptive1", Adaptive1(gamma_prime=gp, alpha=0.9)),
                      ("sun", SunDengFixed(gamma_prime=gp, tau_bound=tb)),
                      ("davis", DavisFixed(gamma_prime=gp, tau_bound=tb,
                                           ratio=ratio))):
        res = run_bcd_logreg(prob, trace, pol, prox, m=m)
        final[name] = float(res.objective[-1])
    if not final["adaptive1"] < min(final["sun"], final["davis"]):
        raise AssertionError(f"fig4: adaptive1 not below the fixed: {final}")
    say("6b fig4", f"Async-BCD 600 x 60, 8 workers, m={m}, 800 events "
        f"(max delay {tb}): final objective adaptive1 "
        f"{final['adaptive1']:.6f}, Sun-Deng fixed {final['sun']:.6f}, "
        f"Davis fixed {final['davis']:.6f}")


def phase_telemetry() -> None:
    """PIAG, BCD, FedAsync and FedBuff at 200 events on the card, with
    telemetry on and off: the solver rows bitwise, each cell's histogram
    summing to its events, the RunRecord well formed; dispatch rates."""
    specs = {"piag": main_spec(n_events=200), "bcd": bcd_spec(n_events=200),
             "fedasync": fed_spec("fedasync", n_events=200),
             "fedbuff": fed_spec("fedbuff", n_events=200)}
    rates = []
    for solver, spec in specs.items():
        on_spec = spec.replace(execution=dataclasses.replace(
            spec.execution, telemetry=True))
        runs = {}
        for tag, sp in (("off", spec), ("on", on_spec), ("off", spec),
                        ("on", on_spec)):
            runs[tag] = api.run(sp)  # the second of each pair is timed
        off, on = runs["off"], runs["on"]
        for f in off.raw._fields:
            if f in ("telemetry", "faults"):
                continue
            if not torch.equal(getattr(off.raw, f), getattr(on.raw, f)):
                raise AssertionError(f"telemetry {solver}: {f} not bitwise")
        tel, rec = on.raw.telemetry, on.telemetry
        B, K = len(on), on.n_events
        if not (bool((tel.hist.sum(dim=1) == K).all())
                and bool((tel.count == K).all())):
            raise AssertionError(f"telemetry {solver}: histogram sums differ "
                                 "from the event count")
        json.loads(rec.to_json())
        if rec.hist_source != "accumulator" or sum(rec.delay_hist) != B * K \
                or rec.n_cells != B or rec.solver != solver \
                or len(rec.fingerprint) != 12 or rec.horizon != on.horizon \
                or rec.clipped["events_clipped"] != int(on.clipped.sum()):
            raise AssertionError(f"telemetry {solver}: malformed RunRecord "
                                 f"{rec}")
        rates.append(f"{solver} {B * K / off.elapsed_s:.1f} off / "
                     f"{B * K / on.elapsed_s:.1f} on "
                     f"({on.elapsed_s / off.elapsed_s:.3f}x the time; tau "
                     f"mean {rec.tau_stats['mean']:.3f}, max "
                     f"{rec.tau_stats['max']}, cache {rec.cache['hits']} "
                     f"hits)")
    say("T telemetry", "rows bitwise on vs off, histograms sum to the "
        "events, RunRecord from the accumulator; dispatch cell-events/s "
        "(second runs): " + "; ".join(rates))


# ---------------------------------------------- faults and resume ----

# the chaos spec of phases F1, F2 and F4
CHAOS = dict(FAULT_PRESETS["chaos"], staleness_cutoff=64)
# benchmarks/fig_faults.py's setting (phase F3)
FIG_FAULTS = dict(p_crash=0.04, p_rejoin=0.15, crash_scale=60.0, seed=0)
# the reference's integers for that setting under jax 0.9.0's partitionable
# threefry: `python -m benchmarks.fig_faults` on the CPU gives
# tau_max_faulted 347 and events to the target 559 / 934 / 1814
# (BENCH_faults.json's 411 and 418 / 574 / 2153 came from the older
# counter layout)
FIG_FAULTS_TAU_MAX = 347
FIG_FAULTS_EVENTS = {"adaptive1": 559, "adaptive2": 934, "fixed_wc": 1814}
# the spike power: the card takes it in float64 and rounds once, the host
# calls the C library's powf (the reference's); they may differ by one
# float32 ulp (ROADMAP queue C)
POW_ULPS = 1


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in float32 ulps between same-signed finite a, b."""
    ia = a.contiguous().view(torch.int32).to(torch.int64)
    ib = b.contiguous().view(torch.int32).to(torch.int64)
    return int((ia - ib).abs().max()) if ia.numel() else 0


def phase_f1_threefry() -> None:
    """mnist-96's fault draws on the card and on the host: the crash,
    spike and code uniforms of 96 cells x 10 workers x 2501 tasks (2500
    events) bitwise, the spike power within POW_ULPS, and the cost of the
    down-mask chain (one (96, 10) step per task) on the card."""
    t_phase = time.perf_counter()
    spec = FaultSpec(**CHAOS)
    seeds = torch.arange(96)
    shape = (10, 2501)
    draws = []
    for dev in (DEV, torch.device("cpu")):
        s = seeds.to(dev)
        k_hit, k_mag = finj.split(finj._key(spec, s, finj._STREAM_SPIKE))
        draws.append({
            "crash": finj.uniform(finj._key(spec, s, finj._STREAM_CRASH),
                                  shape),
            "hit": finj.uniform(k_hit, shape),
            "mag": finj.uniform(k_mag, shape, minval=1e-6, maxval=1.0),
            "codes": finj.update_fault_codes(spec, 2500, s)})
    for name, a in draws[0].items():
        if not torch.equal(a.cpu(), draws[1][name]):
            raise AssertionError(f"F1: {name} draws differ card vs host")
    hit = draws[1]["hit"] < spec.p_spike
    mag = draws[1]["mag"][hit]
    y = float(torch.tensor(-1.0 / spec.spike_tail, dtype=torch.float32))
    p_card = finj._pow(mag.to(DEV), y).cpu()
    p_host = finj._pow(mag, y)
    pow_ulps = _ulps(p_card, p_host)
    if not pow_ulps <= POW_ULPS:
        raise AssertionError(f"F1: spike pow {pow_ulps} ulps apart")
    T = torch.from_numpy(np.random.default_rng(0).lognormal(
        0.0, 0.3, size=(96,) + shape).astype(np.float32))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    down = finj._down_mask(spec, finj._key(spec, seeds.to(DEV),
                                           finj._STREAM_CRASH), shape)
    torch.cuda.synchronize()
    t_chain = time.perf_counter() - t0
    t0 = time.perf_counter()
    Tc = finj.inject_service_times(T.to(DEV), spec, seeds.to(DEV))
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    Th = finj.inject_service_times(T, spec, seeds)
    t_host = time.perf_counter() - t0
    t_ulps = _ulps(Tc.cpu(), Th)
    if not t_ulps <= 2 * POW_ULPS:
        raise AssertionError(f"F1: injected service times {t_ulps} ulps "
                             "apart card vs host")
    say("F1 threefry", f"96 cells x {shape[0]} workers x {shape[1]} tasks: "
        f"crash, spike-hit, spike-magnitude uniforms and 96 x 2500 codes "
        f"bitwise card vs host; {int(hit.sum())} spikes, pow {POW_ULPS}-ulp "
        f"envelope: {int((p_card != p_host).sum())} differ, max {pow_ulps} "
        f"ulp; injected service times max {t_ulps} ulp apart "
        f"({int((Tc.cpu() != Th).sum())} of {Th.numel()} differ); "
        f"down-mask chain on the card {t_chain:.3f} s ({shape[1]} steps, "
        f"{float(down.mean()):.4f} down), whole injection card "
        f"{t_card:.3f} s, host {t_host:.3f} s; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")


def phase_f2_faulted_main_path() -> None:
    """mnist-96's grid under the chaos spec, scan engine, batched, 500
    events: rates, idle share, peak memory, the six counters; two cells
    solo equal to their batched rows."""
    t_phase = time.perf_counter()
    spec = main_spec(n_events=500, faults=FaultSpec(**CHAOS),
                     execution=dict(engine="scan"))
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    res = api.run(spec)
    peak = torch.cuda.max_memory_allocated() / 2**20
    if any(fn.launches for fn in COUNTERS):
        raise AssertionError("F2: the scan engine launched a fused kernel")
    B, K = len(res), res.n_events
    counters = summarize_faults(res.raw.faults)
    if res.telemetry.faults != counters or not counters["injected"] \
            or not counters["dropped"] or not counters["duplicated"]:
        raise AssertionError(f"F2: counters {counters}, ledger "
                             f"{res.telemetry.faults}")
    if not bool(torch.isfinite(res.objective).all()) \
            or not bool(torch.isfinite(res.gammas).all()):
        raise AssertionError("F2: non-finite output under the guard")
    # the profiler's own cost grows with the launches it records, so the
    # idle share is read over the first 100 events of the same spec
    wall, by_name, _ = _profile(lambda: api.run(spec.replace(n_events=100)))
    busy = sum(by_name.values()) / 1e6
    idle = f"{1 - busy / wall:.3f}" if by_name else "not measured"
    pick = [0, B - 1]
    sub = res.grid.subset(np.asarray(pick))
    r = api.resolve(spec)
    solo = api.run_components("piag", "solo", problem=r.problem, grid=sub,
                              prox=r.prox, horizon=res.horizon,
                              record_every=10, engine="scan",
                              faults=FaultSpec(**CHAOS))
    idx = torch.tensor(pick, device=DEV)
    for f in ("taus", "clipped"):
        if not torch.equal(getattr(solo.raw, f), getattr(res.raw, f)[idx]):
            raise AssertionError(f"F2: solo {f} differ from batched")
    for f in FaultState._fields:
        if not torch.equal(getattr(solo.raw.faults, f),
                           getattr(res.raw.faults, f)[idx]):
            raise AssertionError(f"F2: solo counter {f} differs")
    g_ulps = _ulps(solo.gammas, res.gammas[idx])
    say("F2 faulted main path", f"api.run PIAG 96 cells, 60000 x 784, {K} "
        f"events, chaos preset + staleness_cutoff 64, engine=scan, batched: "
        f"dispatch {res.elapsed_s:.3f} s, {B * K / res.elapsed_s:.1f} "
        f"cell-events/s, idle share {idle} (profiled run of 100 events, "
        f"wall {wall:.3f} s), peak {peak:.1f} MiB; counters {counters}; "
        f"cells 0 and {B - 1} "
        f"solo: taus, clipped and counters equal to the batched rows, "
        f"gammas {g_ulps} ulp apart; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")


def _fig_faults_grid(problem, policies, n_events):
    return make_grid(policies=policies, seeds=[0],
                     topologies={"hetero": heterogeneous_workers(
                         problem.n_workers, seed=1)},
                     n_events=n_events)


def phase_f3_fig_faults() -> None:
    """benchmarks/fig_faults.py on the card: the delay regime, then the
    race of adaptive1 / adaptive2 against the fixed step tuned to the
    faulted worst case; its three gates."""
    t_phase = time.perf_counter()
    n_events = 3000
    problem = make_logreg(800, 100, n_workers=8, seed=0, device=DEV)
    prox = L1(lam=problem.lam1)
    gp = 0.99 / problem.L
    chaos = FaultSpec(**FIG_FAULTS)

    def run(policies, faults):
        return api.run_components(
            "piag", "batched", problem=problem,
            grid=_fig_faults_grid(problem, policies, n_events), prox=prox,
            horizon=4096, engine="scan", faults=faults)

    # the delay regime: fig_faults reads it from a throwaway adaptive run,
    # whose taus are its trace's tau_max; the race alone gives them
    probe = _fig_faults_grid(problem, {"probe": Adaptive1(gamma_prime=gp)},
                             n_events)
    T = torch.from_numpy(probe.service_times()).to(DEV)
    tau_bar = float(trace_scan(T).tau_max.float().mean())
    tau_max = int(trace_scan(finj.inject_service_times(
        T, chaos, torch.tensor([0], device=DEV))).tau_max.max())
    spike = tau_max / max(tau_bar, 1.0)
    if tau_max != FIG_FAULTS_TAU_MAX:
        raise AssertionError(f"F3: tau_max_faulted {tau_max}, the reference "
                             f"gives {FIG_FAULTS_TAU_MAX}")
    race = run({"adaptive1": Adaptive1(gamma_prime=gp),
                "adaptive2": Adaptive2(gamma_prime=gp),
                "fixed_wc": FixedStepSize(gamma_prime=gp,
                                          tau_bound=tau_max)}, chaos)
    obj = race.objective.cpu().numpy()
    traces = {c.policy_name: obj[i] for i, c in enumerate(race.cells)}
    finals = {n: float(t[-1]) if np.isfinite(t[-1]) else float("inf")
              for n, t in traces.items()}
    p0 = float(next(iter(traces.values()))[0])
    p_star = min(finals.values())
    target = p_star + 0.2 * (p0 - p_star)

    def hit(t):
        h = np.isfinite(t) & (t <= target)
        return int(np.argmax(h)) if h.any() else None

    hits = {n: hit(t) for n, t in traces.items()}
    diverged = {n: not np.all(np.isfinite(t)) or finals[n] > p0
                for n, t in traces.items()}
    adaptive = [hits[n] for n in ("adaptive1", "adaptive2")
                if hits[n] is not None and not diverged[n]]
    best = min(adaptive) if adaptive else None
    fixed = hits["fixed_wc"]
    gates = {"spike_ge_4x": spike >= 4.0,
             "adaptive_reaches_target": best is not None,
             "fixed_diverges_or_2x_writes": diverged["fixed_wc"]
             or fixed is None or (best is not None and fixed >= 2 * best)}
    if not all(gates.values()):
        raise AssertionError(f"F3: gates {gates}, hits {hits}")
    ratio = f"{fixed / best:.2f}x" if fixed is not None and best else "n/a"
    say("F3 fig_faults", f"logreg 800 x 100, 8 workers, {n_events} events, "
        f"p_crash 0.04 / p_rejoin 0.15 / crash_scale 60: tau_bar "
        f"{tau_bar:.3f}, tau_max_faulted {tau_max} (reference "
        f"{FIG_FAULTS_TAU_MAX}), spike {spike:.2f}x; events to target "
        + ", ".join(f"{n} {hits[n]} (reference {FIG_FAULTS_EVENTS[n]})"
                    for n in FIG_FAULTS_EVENTS)
        + f"; fixed/adaptive writes {ratio}; gates {gates}; counters "
        f"{race.telemetry.faults}; race dispatch {race.elapsed_s:.3f} s; "
        f"phase wall {time.perf_counter() - t_phase:.1f} s")


def phase_f4_other_solvers() -> None:
    """Async-BCD, FedAsync and FedBuff under the chaos spec at the CPU
    tests' size, on the card and on the host: integer leaves and counters
    exact, the objective within OBJ_REL_ENVELOPE of its start."""
    t_phase = time.perf_counter()
    notes = []
    for solver in ("bcd", "fedasync", "fedbuff"):
        fed = solver != "bcd"
        runs = []
        for dev in (DEV, torch.device("cpu")):
            problem = make_logreg(240, 40, n_workers=4, seed=0, device=dev)
            gp = 0.99 / problem.block_smoothness(8) if not fed else 0.6
            if fed:
                grid = make_grid(
                    policies={"hinge": make_policy("hinge", 0.6)},
                    seeds=[0, 1],
                    topologies={"edge": heterogeneous_clients(4, seed=2)},
                    n_events=80)
            else:
                grid = make_grid(
                    policies={"a1": Adaptive1(gamma_prime=gp),
                              "fx": FixedStepSize(gamma_prime=gp,
                                                  tau_bound=40)},
                    seeds=[0, 1],
                    topologies={"hetero": heterogeneous_workers(4, seed=1)},
                    n_events=100)
            kw = {"bcd": dict(m=8), "fedasync": {},
                  "fedbuff": dict(eta=0.5, buffer_size=2)}[solver]
            runs.append(api.run_components(
                solver, "batched", problem=problem, grid=grid,
                prox=L1(lam=problem.lam1), horizon=4096, engine="scan",
                device=str(dev), faults=FaultSpec(**CHAOS), **kw))
        a, b = runs[0].raw, runs[1].raw
        for f in ("taus", "clipped", "blocks", "versions"):
            if f in a._fields and not torch.equal(getattr(a, f).cpu(),
                                                  getattr(b, f)):
                raise AssertionError(f"F4 {solver}: {f} differ card vs host")
        ca, cb = summarize_faults(a.faults), summarize_faults(b.faults)
        if ca != cb:
            raise AssertionError(f"F4 {solver}: counters {ca} vs {cb}")
        rel = float(((a.objective.cpu() - b.objective).abs()
                     / b.objective[:, :1].abs()).max())
        if not rel <= OBJ_REL_ENVELOPE:
            raise AssertionError(f"F4 {solver}: objective rel diff {rel}")
        notes.append(f"{solver} {ca}, objective max rel diff {rel:.3g}, "
                     f"gammas {_ulps(runs[0].gammas.cpu(), runs[1].gammas)}"
                     " ulp")
    say("F4 other solvers", "chaos preset at 240 x 40, 4 workers, scan "
        "engine, card vs host: taus, clipped, blocks/versions and counters "
        "exact; " + "; ".join(notes)
        + f"; phase wall {time.perf_counter() - t_phase:.1f} s")


def _resume_pair(spec, counter, tmp):
    """Run ``spec`` with ``resume=tmp``, delete its second bucket's file,
    run again; the second run's launches of ``counter`` (counts set to 0
    just before it, read just after) and both results."""
    first = api.run(spec, resume=tmp)
    files = sorted(os.listdir(tmp))
    if len(files) != 2:
        raise AssertionError(f"R1: expected two bucket files, got {files}")
    last = max(files, key=lambda f: int(f.rsplit("_b", 1)[1][:-4]))
    os.remove(os.path.join(tmp, last))
    reset_counts()
    again = api.run(spec, resume=tmp)
    n = counter.launches
    for f in first.raw._fields:
        if f in ("telemetry", "faults"):
            continue
        if not torch.equal(getattr(first.raw, f), getattr(again.raw, f)):
            raise AssertionError(f"R1: resumed {f} not bitwise")
    return first, again, n


def phase_r1_resume() -> dict:
    """Resume on the card: PIAG (fused, B1) on mnist-96's problem with
    two buckets (4 and 8 workers), FedAsync (B2) and FedBuff (B3) at a
    small size; the deleted bucket alone is rerun, bitwise; another spec
    into the same directory raises.  Returns each kernel's launches."""
    import tempfile
    t_phase = time.perf_counter()
    out = {}
    # mnist-96's problem (10 workers' shards, the resolve memo's entry)
    # under a grid of two buckets, 4 and 8 workers
    mnist = main_spec().problem
    spec = main_spec(problem=api.ProblemSpec(kind="logreg", params=dict(
        mnist.params, n_workers=10)), topology=api.TopologySpec(
            kind="standard", n_workers=(4, 8)))
    # a fixed horizon: resolve races nothing, the sweep races only the
    # buckets it runs
    small = dict(problem=api.ProblemSpec(kind="logreg", params=dict(
        n_samples=4000, dim=784, sparse_like=False, lam1=1e-3, lam2=1e-4)),
        topology=api.TopologySpec(kind="edge", n_workers=(4, 8), seed=1,
                                  params=dict(spread=4.0, p_straggle=0.05,
                                              p_dropout=0.02)),
        n_events=500)
    notes = []
    for name, sp, counter in (
            ("piag", spec, fused_policy_prox_step),
            ("fedasync", _fixed_h(fed_spec("fedasync", **small)),
             fused_policy_mix_step),
            ("fedbuff", _fixed_h(fed_spec("fedbuff", **small)),
             fused_policy_buff_step)):
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            first, again, n = _resume_pair(sp, counter, tmp)
            wall = time.perf_counter() - t0
            buckets = first.grid.buckets()
            if n != first.n_events * 1 or len(buckets) != 2:
                raise AssertionError(f"R1 {name}: {n} launches for one "
                                     f"unfinished bucket of {first.n_events}"
                                     " events")
            other = sp.replace(n_events=sp.n_events // 2)
            try:
                api.run(other, resume=tmp)
            except ValueError as e:
                if "different spec" not in str(e):
                    raise
            else:
                raise AssertionError(f"R1 {name}: another spec resumed")
        out[name] = n
        notes.append(f"{name} {len(first)} cells in buckets "
                     f"{[b.width for b in buckets]}: dispatch "
                     f"{first.elapsed_s:.3f} s fresh, {again.elapsed_s:.3f} "
                     f"s resumed, launches on the resume {n} (= "
                     f"{first.n_events} x 1 bucket), pair wall {wall:.3f} s")
    say("R1 resume", "rows bitwise after deleting the last bucket file, "
        "another spec refused; " + "; ".join(notes)
        + f"; phase wall {time.perf_counter() - t_phase:.1f} s")
    return out


def _fixed_h(spec):
    return spec.replace(solver=dataclasses.replace(spec.solver,
                                                   horizon=256))


# SC: mnist-96's problem shapes (60 000 x 784 over 10 workers, BCD's m 20,
# its record_every 10) with the events cut to 200: the per-event trace
# repeats, so the cut changes nothing but the trace's length
SC_PROBLEM = sc_contracts.Problem(n_samples=60000, dim=784, n_workers=10,
                                  n_events=200, m=20, horizon=128,
                                  record_every=10)


def phase_sc_staticcheck(device=DEV, pb=SC_PROBLEM) -> dict:
    """SC: ``repro_torch.staticcheck`` on ``device``.  The lint of the
    port's tree (zero findings) and of each fixture (its own rule only);
    the op-trace contracts of the four solvers at scan level and as the
    batched and one-device sharded programs, each fused trace holding one
    B1, B2 or B3 launch an event (upload) on the card; cache-key
    completeness and the retrace budget at the reference's tiny spec.
    Any failure raises.  Returns the fused traces' launches by check."""
    t_phase = time.perf_counter()
    src = os.path.dirname(os.path.dirname(os.path.abspath(
        sc_lint.__file__)))
    findings = sc_lint.lint_paths([src])
    if findings:
        raise AssertionError("SC: the port's tree does not lint clean:\n"
                             + "\n".join(map(str, findings)))
    fixtures = os.path.join(os.path.dirname(sc_lint.__file__), "fixtures")
    per_fixture = {}
    for fname in sorted(os.listdir(fixtures)):
        if not fname.endswith(".py"):
            continue
        rules = {}
        for f in sc_lint.lint_file(os.path.join(fixtures, fname)):
            rules[f.rule] = rules.get(f.rule, 0) + 1
        if len(rules) != 1:
            raise AssertionError(f"SC: fixture {fname} gives {rules}; each "
                                 "must trigger its own rule only")
        per_fixture[fname[:-3]] = rules
    n_files = sum(1 for _ in sc_lint.iter_py([src]))
    say("SC lint", f"{n_files} files of src/repro_torch, 0 findings; "
        "fixtures (rule: findings): " + ", ".join(
            f"{k} {v}" for k, v in per_fixture.items())
        + f" ({time.perf_counter() - t_phase:.2f} s)")

    t0 = time.perf_counter()
    checks = sc_contracts.verify(device=str(device), pb=pb)
    failed = [c for c in checks if not c.ok]
    if failed:
        raise AssertionError("SC contracts failed:\n" + "\n".join(
            f"{c.name}: {c.detail[:1500]}" for c in failed))
    launches = {c.name.rsplit("/", 1)[0]: c.launches for c in checks
                if c.name.endswith("/fused-launches")}
    say("SC contracts", f"{len(checks)}/{len(checks)} ok at scan level and "
        f"as the batched and one-device sharded programs, logreg "
        f"{pb.n_samples} x {pb.dim} over {pb.n_workers} workers, "
        f"{pb.n_events} events, m {pb.m}, record_every {pb.record_every}; "
        "launches of each fused trace: "
        + "; ".join(f"{k} {v}" for k, v in launches.items())
        + f" ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    outcomes = sc_cachekey.check_completeness(str(device))
    counts = {}
    for o in outcomes:
        counts[o.status] = counts.get(o.status, 0) + 1
    violations = [o for o in outcomes if o.violation]
    distinct, errors = sc_cachekey.check_retrace_budget(str(device))
    if violations or errors or sc_cachekey.unregistered_fields():
        raise AssertionError(f"SC cache keys: violations {violations}, "
                             f"budget {errors}")
    skipped = counts.get("skip", 0)
    say("SC cache keys", f"{len(outcomes) - skipped} knobs perturbed, "
        f"{skipped} skipped, 0 unregistered, 0 violations ("
        + ", ".join(f"{v} {k}" for k, v in sorted(counts.items()))
        + f"); retrace budget {distinct} of {sc_cachekey.RETRACE_BUDGET} "
        f"programs ({time.perf_counter() - t0:.1f} s); phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches


# ------------------------------------------------- the sharded backend ----

def _sharded_rows(tag: str, batched, sharded, bitwise: bool) -> float:
    """Raise unless the sharded rows equal the batched rows: integer
    leaves and gammas (weights) exact; every float leaf too when
    ``bitwise``, else the objective within OBJ_REL_ENVELOPE of its
    start.  Returns the objective's largest difference over its start."""
    a, b = batched.raw, sharded.raw
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if not isinstance(x, torch.Tensor):
            continue
        exact = bitwise or not x.dtype.is_floating_point \
            or f in ("gammas", "weights")
        if exact and not torch.equal(x, y):
            raise AssertionError(f"{tag}: sharded {f} differs from batched")
    start = a.objective[:, :1].abs()
    rel = float(((a.objective - b.objective).abs() / start).max())
    if not (rel <= OBJ_REL_ENVELOPE):
        raise AssertionError(f"{tag}: objective {rel:.3g} of its start "
                             "from batched")
    return rel


def _sharded_pair(spec, mesh, counter):
    """(batched result, sharded result on ``mesh``, the sharded run's
    launches of ``counter``: counts set to 0 just before it, read just
    after).  Each result carries ``wall``: its ``api.run`` call, resolve
    included (a batched federated run races its buckets there, a sharded
    one in each row's dispatch)."""
    t0 = time.perf_counter()
    batched = api.run(spec)
    batched.wall = time.perf_counter() - t0
    sharded_spec = spec.replace(execution=dataclasses.replace(
        spec.execution, backend="sharded", mesh=mesh))
    reset_counts()
    t0 = time.perf_counter()
    sharded = api.run(sharded_spec)
    sharded.wall = time.perf_counter() - t0
    return batched, sharded, counter.launches


def _rate(res) -> float:
    return len(res) * res.n_events / res.elapsed_s


def phase_s1_sharded_main_path(devices=None, tag: str = "S1 sharded"):
    """mnist-96 through ``api.run(backend="sharded")`` on a mesh of the
    card alone (or of ``devices``, one row each): one B1 launch an event
    a row; on one device the rows are bitwise the batched run's."""
    t_phase = time.perf_counter()
    devs = [CARD] if devices is None else devices
    mesh = cell_mesh(devs)
    batched, sharded, n = _sharded_pair(main_spec(), mesh,
                                        fused_policy_prox_step)
    K, buckets = sharded.n_events, len(sharded.grid.buckets())
    if n != K * buckets * len(devs):
        raise AssertionError(f"{tag}: {n} B1 launches, expected {K} x "
                             f"{buckets} buckets x {len(devs)} rows")
    rel = _sharded_rows(tag, batched, sharded, bitwise=len(set(devs)) == 1)
    say(tag, f"mnist-96 (96 cells, {K} events) on mesh {mesh.shape} of "
        f"{[str(d) for d in devs]}: rows "
        f"{'bitwise' if len(set(devs)) == 1 else 'integer leaves and gammas exact'}"
        f" to batched (objective {rel:.3g} of its start), B1 launches {n} "
        f"(= {K} events x {buckets} bucket x {len(devs)} row); sharded "
        f"{_rate(sharded):.1f} cell-events/s (dispatch "
        f"{sharded.elapsed_s:.3f} s) vs batched {_rate(batched):.1f} "
        f"({batched.elapsed_s:.3f} s); record devices="
        f"{sharded.telemetry.devices} mesh_shape="
        f"{sharded.telemetry.mesh_shape}; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")
    return n


def phase_s2_sharded_repeated_card() -> dict:
    """mnist-96 at 500 events on a mesh that lists the card twice, as (2,)
    (two rows: twice the B1 launches) and as (1, 2) (one row, a data axis
    of 2: the gradient in two sample halves summed in order)."""
    t_phase = time.perf_counter()
    card0 = [CARD] * 2
    out, notes = {}, []
    for name, mesh, rows in (("(2,)", cell_mesh(card0), 2),
                             ("(1, 2)", grid_mesh((1, 2), card0), 1)):
        batched, sharded, n = _sharded_pair(main_spec(n_events=500), mesh,
                                            fused_policy_prox_step)
        K, buckets = sharded.n_events, len(sharded.grid.buckets())
        if n != K * buckets * rows:
            raise AssertionError(f"S2 {name}: {n} B1 launches, expected "
                                 f"{K * buckets * rows}")
        rel = _sharded_rows(f"S2 {name}", batched, sharded, bitwise=False)
        out[name] = n
        notes.append(f"{name}: B1 launches {n}, objective {rel:.3g} of its "
                     f"start, sharded {_rate(sharded):.1f} vs batched "
                     f"{_rate(batched):.1f} cell-events/s")
    say("S2 sharded x2", "mnist-96, 500 events, the card listed twice; "
        "integer leaves and gammas exact to batched; " + "; ".join(notes)
        + f"; phase wall {time.perf_counter() - t_phase:.1f} s")
    return out


def phase_s3_sharded_other_solvers() -> dict:
    """Async-BCD (mnist-96-bcd), FedAsync and FedBuff (mnist-fed-24) at
    500 events on the (2,) mesh of the card listed twice: rows against
    batched, and the B1, B2 and B3 launches (two rows each)."""
    t_phase = time.perf_counter()
    mesh = cell_mesh([CARD] * 2)
    out, notes = {}, []
    for name, spec, counter in (
            ("bcd", bcd_spec(n_events=500), fused_policy_prox_step),
            ("fedasync", fed_spec("fedasync", n_events=500),
             fused_policy_mix_step),
            ("fedbuff", fed_spec("fedbuff", n_events=500),
             fused_policy_buff_step)):
        batched, sharded, n = _sharded_pair(spec, mesh, counter)
        K, buckets = sharded.n_events, len(sharded.grid.buckets())
        if n != 2 * K * buckets:
            raise AssertionError(f"S3 {name}: {n} launches, expected "
                                 f"{2 * K * buckets}")
        others = sum(c.launches for c in COUNTERS if c is not counter)
        if others:
            raise AssertionError(f"S3 {name}: another event kernel launched")
        rel = _sharded_rows(f"S3 {name}", batched, sharded, bitwise=False)
        out[name] = n
        notes.append(f"{name} {len(sharded)} cells: "
                     f"{counter.__name__} launches {n}, objective {rel:.3g} "
                     f"of its start, sharded {_rate(sharded):.1f} vs batched "
                     f"{_rate(batched):.1f} cell-events/s of dispatch, call "
                     f"wall {sharded.wall:.3f} vs {batched.wall:.3f} s")
    say("S3 sharded solvers", "(2,) mesh of the card; integer leaves and "
        "gammas exact to batched; " + "; ".join(notes)
        + f"; phase wall {time.perf_counter() - t_phase:.1f} s")
    return out


def mega_spec(**ex):
    """``benchmarks/mega_grid.py``'s 512-cell PIAG grid: 480 x 60 logreg,
    4 policies (adaptive1 at alpha 0.9, adaptive2, fixed and Sun-Deng at
    the measured tau-bar) x 16 seeds x 4 standard topologies x widths 4
    and 8, 300 events, horizon from the measured tau-bar."""
    return api.ExperimentSpec(
        problem=api.ProblemSpec(kind="logreg", params=dict(
            n_samples=480, dim=60, seed=0, n_workers=8)),
        solver=api.SolverSpec(name="piag", horizon="auto"),
        topology=api.TopologySpec(kind="standard", n_workers=(4, 8)),
        policies=api.PolicyGridSpec(
            names=("adaptive1", "adaptive2", "fixed", "sun_deng"),
            seeds=tuple(range(16)), policy_kwargs={"adaptive1":
                                                   dict(alpha=0.9)}),
        execution=api.ExecutionSpec(**{"backend": "batched", **ex}),
        n_events=300)


def phase_s4_mega_grid() -> int:
    """The mega grid sharded on the card's (1,) mesh and batched: rows
    bitwise, the rates of warm runs and each one's idle share; then the
    ``launch.sweep --backend sharded`` CLI once.  Returns the sharded
    run's B1 launches."""
    t_phase = time.perf_counter()
    mesh = cell_mesh([CARD])
    specs = {"batched": mega_spec(),
             "sharded": mega_spec(backend="sharded", mesh=mesh)}
    res, idle = {}, {}
    for name, spec in specs.items():
        api.run(spec)  # warm: the problem memo, the programs, the allocator
        reset_counts()
        res[name] = api.run(spec)
        res[name + "_launches"] = fused_policy_prox_step.launches
        # the card's busy share of one more call, resolve included
        wall, busy = _busy_wall(lambda: api.run(spec))
        idle[name] = f"{1 - busy / wall:.3f}" if busy > 0 else "not measured"
    B, K = len(res["sharded"]), res["sharded"].n_events
    buckets = len(res["sharded"].grid.buckets())
    if B != 512 or res["sharded_launches"] != K * buckets:
        raise AssertionError(f"S4: {B} cells, "
                             f"{res['sharded_launches']} B1 launches")
    _sharded_rows("S4 mega", res["batched"], res["sharded"], bitwise=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tsweep.main(["--solver", "piag", "--backend", "sharded", "--seeds",
                     "2", "--events", "200", "--n-workers", "4,8"])
    cli = buf.getvalue().splitlines()
    if not cli or not cli[0].startswith("sweep[piag/sharded]: 48 cells"):
        raise AssertionError(f"S4 CLI printed {cli[:2]}")
    say("S4 mega grid", f"{B} cells (4 policies x 16 seeds x 4 topologies "
        f"x widths 4, 8), 480 x 60 logreg, {K} events, H="
        f"{res['sharded'].horizon} (tau_bar={res['sharded'].tau_bar}): "
        f"sharded (1,) {_rate(res['sharded']):.1f} cell-events/s (dispatch "
        f"{res['sharded'].elapsed_s:.3f} s, idle {idle['sharded']}) vs "
        f"batched {_rate(res['batched']):.1f} ({res['batched'].elapsed_s:.3f}"
        f" s, idle {idle['batched']}); rows bitwise; B1 launches "
        f"{res['sharded_launches']} (= {K} x {buckets} buckets); CLI: "
        f"{cli[0]} | {cli[1]}; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")
    return res["sharded_launches"]


def phases_sharded() -> dict:
    """S1-S4, and S1 across every card where the host has several."""
    t0 = time.perf_counter()
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        say("S0 cards", f"the host has {n_cards} CUDA card: no multi-card "
            "mesh ran; the sharded phases run on meshes of the one card "
            "(listed once or twice)")
    else:
        say("S0 cards", f"the host has {n_cards} CUDA cards: S1 runs on "
            "the first alone and across every card")
    out = {"S1": phase_s1_sharded_main_path()}
    if n_cards >= 2:
        out["S1 all cards"] = phase_s1_sharded_main_path(
            [torch.device("cuda", i) for i in range(n_cards)],
            tag="S1 sharded all cards")
    out["S2"] = phase_s2_sharded_repeated_card()
    out["S3"] = phase_s3_sharded_other_solvers()
    out["S4"] = phase_s4_mega_grid()
    say("S1-S4", f"sharded phases took {time.perf_counter() - t0:.1f} s")
    return out


# -------------------------- training and the threaded runtimes ----

# the trainers' losses card vs CPU, relative to the first loss (float32
# sums in other orders; AdamW maps a near-zero gradient element's
# rounding to an update of up to lr: tests/test_torch_train.py)
TRAIN_LOSS_REL = 1e-4
TRAIN_TINY = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                  head_dim=32, d_ff=256, vocab=512)


def _quiet(fn, *args, **kw):
    """``fn`` with its per-step prints kept off the smoke's output."""
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kw)


def _train_cfg(preset: str, **shape):
    return ttrain.PRESETS[preset].replace(attention_impl="chunked", **shape)


def phase_tr1_train_100m() -> None:
    """``launch.train.run_training`` on the 100m preset at full width and
    depth with the CLI's defaults (batch 8, seq 256, 4 workers, adaptive1,
    lr 3e-3), 60 steps: the loss falls; rates, peak memory, and the idle
    share over 10 profiled steps.  No hand-written kernel runs (training
    takes the chunked attention)."""
    t_phase = time.perf_counter()
    cfg = _train_cfg("100m")
    kw = dict(batch=8, seq=256, policy_name="adaptive1", lr=3e-3,
              n_workers=4, device=DEV)
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    log = _quiet(ttrain.run_training, cfg, steps=60, log_every=10, **kw)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if any(fn.launches for fn in COUNTERS):
        raise AssertionError("TR1: training launched a hand-written kernel")
    losses = [r["loss"] for r in log]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0] - 0.3:
        raise AssertionError(f"TR1: the loss did not fall: {losses}")
    # the loop's wall (the 4 initial gradients come before t0)
    wall = log[-1]["wall_s"]
    steps = log[-1]["step"] + 1
    # the idle share of 10 steps: a 10-step run less a 0-step run (the
    # model's initialization and the 4 initial gradients), both profiled
    w0, b0 = _busy_wall(lambda: _quiet(ttrain.run_training, cfg, steps=0,
                                       **kw))
    w10, b10 = _busy_wall(lambda: _quiet(ttrain.run_training, cfg, steps=10,
                                         log_every=10, **kw))
    busy, wall10 = b10 - b0, w10 - w0
    idle = f"{1 - busy / wall10:.3f}" if busy > 0 else "not measured"
    n_params = sum(p.numel() for p in
                   Transformer(cfg, None, torch.device("meta")).parameters())
    # model FLOPs: a forward is 2 per matmul weight per token (the token
    # table is a gather) plus QK^T and PV over all S x S positions (the
    # chunked attention computes the masked half too); a step is four
    # forwards' worth (forward, remat's second forward, the backward's two)
    B, S = kw["batch"], kw["seq"]
    fwd = (2 * (n_params - cfg.vocab * cfg.d_model) * B * S
           + cfg.n_layers * 4 * B * cfg.n_heads * S * S * cfg.head_dim)
    flops10 = 10 * 4 * fwd + 2 * fwd
    say("TR1 train 100m", f"run_training {cfg.name} ({n_params / 1e6:.1f} M "
        f"params, {cfg.n_layers} layers, d_model {cfg.d_model}, float32, "
        f"attention chunked), batch 8 x seq 256, 4 workers, adaptive1, lr "
        f"3e-3: {steps} steps in {wall:.3f} s, {steps / wall:.3f} steps/s, "
        f"{steps * 8 * 256 / wall:.1f} tokens/s (7 loss evaluations "
        f"included), peak {peak:.3f} GiB; loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} ({', '.join(f'{v:.3f}' for v in losses)}); taus "
        f"{[r['tau'] for r in log]}; 10 profiled steps (2 loss evaluations "
        f"included, the initialization not): wall {wall10:.3f} s, device "
        f"busy {busy:.3f} s, idle share {idle}, {flops10 / 1e12:.2f} model "
        f"TFLOP, "
        + (f"{flops10 / busy / 1e12:.1f}" if busy > 0 else "not measured")
        + f" TFLOP/s of busy time (float32, TF32 off; peak "
        f"{F32_OPS_PER_S / 1e12:.0f}); "
        f"no kernel launches; phase wall {time.perf_counter() - t_phase:.1f} "
        "s")


def _busy_wall(run) -> Tuple[float, float]:
    """Wall seconds of one call of ``run`` and the card's busy seconds in
    it: the sum of the device events of a profile that records the card
    only, read from the profiler's raw results (no host-op records to
    build, which took tens of seconds for a training run)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA)
    return wall, busy / 1e9


def _cpu_init(cfg, generator=None, device=None):
    """The port's initializer drawn on the CPU and moved to ``device``, so
    the card and the CPU start from the same parameters."""
    return init_params(cfg, torch.Generator().manual_seed(0),
                       device="cpu").to(device)


def phase_tr2_train_card_vs_cpu() -> None:
    """``run_training`` and ``run_bcd_training`` at the tiny config of
    ``tests/test_system.py`` on the card and on the CPU from the same
    parameters: taus, blocks exact, gammas bitwise, losses within
    ``TRAIN_LOSS_REL`` of the first."""
    t_phase = time.perf_counter()
    cfg = _train_cfg("25m", name="lm-tiny", **TRAIN_TINY)
    worst = {}
    saved = (ttrain.init_params, tbcd.init_params)
    ttrain.init_params = tbcd.init_params = _cpu_init
    try:
        for name, run in (
                ("train", lambda dev: _quiet(
                    ttrain.run_training, cfg, steps=20, batch=4, seq=64,
                    n_workers=3, log_every=1, device=dev)),
                ("bcd", lambda dev: _quiet(
                    tbcd.run_bcd_training, cfg,
                    Adaptive1(gamma_prime=0.5), steps=20, batch=4, seq=64,
                    m_blocks=4, n_workers=3, log_every=1, device=dev))):
            lc, lh = run(DEV), run("cpu")
            for a, b in zip(lc, lh):
                keys = ("step", "tau", "block") if name == "bcd" else \
                    ("step", "tau")
                if any(a[k] != b[k] for k in keys) or np.float32(
                        a["gamma"]).view(np.int32) != np.float32(
                        b["gamma"]).view(np.int32):
                    raise AssertionError(f"TR2 {name}: card {a} cpu {b}")
            err = max(abs(a["loss"] - b["loss"]) for a, b in zip(lc, lh)) \
                / abs(lh[0]["loss"])
            if not err <= TRAIN_LOSS_REL:
                raise AssertionError(f"TR2 {name}: losses {err:.3e} apart")
            worst[name] = err
    finally:
        ttrain.init_params, tbcd.init_params = saved
    say("TR2 train card vs cpu", f"lm-tiny (2 layers, d_model 128), 20 "
        f"steps each: run_training and run_bcd_training taus and blocks "
        f"exact, gammas bitwise, losses within {worst['train']:.2e} and "
        f"{worst['bcd']:.2e} of the first (envelope {TRAIN_LOSS_REL}); "
        f"phase wall {time.perf_counter() - t_phase:.1f} s")


FED_CI = dict(uploads=400, policy_name="hinge")   # .github/workflows/ci.yml


def phase_ft1_federated_convex() -> dict:
    """FT1: ``launch.train_federated.run_convex_federated`` at CI's settings
    (logreg 500 x 50, 8 clients, 400 uploads, hinge) and with
    ``buffer_size=4``, on the card with every count set to 0 just before
    and read just after (one B2 or B3 launch an upload, no other kernel),
    each held against the same run on the CPU: max_tau, the trace's
    clients, taus and weights equal, p_star and the suboptimality within
    ``OBJ_REL_ENVELOPE`` of the starting objective P(0)."""
    t_phase = time.perf_counter()
    p0 = float(make_logreg(500, 50, n_workers=8, seed=0, device="cpu").P(
        torch.zeros(50)))
    launches, parts = {}, []
    for buf, mine in ((1, fused_policy_mix_step), (4, fused_policy_buff_step)):
        reset_counts()
        card = _quiet(tfed.run_convex_federated, "logreg", buffer_size=buf,
                      device=DEV, **FED_CI)
        n = mine.launches
        stray = sum(fn.launches for fn in COUNTERS) - n
        if n != FED_CI["uploads"] or stray:
            raise AssertionError(f"FT1 buffer {buf}: {n} launches (+{stray} "
                                 "of other kernels)")
        host = _quiet(tfed.run_convex_federated, "logreg", buffer_size=buf,
                      device="cpu", **FED_CI)
        rc, rh = card["result"], host["result"]
        if card["max_tau"] != host["max_tau"] or not np.array_equal(
                card["trace"].client, host["trace"].client):
            raise AssertionError(f"FT1 buffer {buf}: traces differ")
        for f in ("taus", "versions", "weights"):
            if not torch.equal(getattr(rc, f).cpu(), getattr(rh, f)):
                raise AssertionError(f"FT1 buffer {buf}: {f} not equal")
        diff = max(abs(card[k] - host[k]) for k in
                   ("p_star", "final_subopt", "best_subopt"))
        obj = float((rc.objective.cpu() - rh.objective).abs().max())
        if not max(diff, obj) <= OBJ_REL_ENVELOPE * p0:
            raise AssertionError(f"FT1 buffer {buf}: objective {obj}, "
                                 f"suboptimality {diff} apart")
        launches["fedasync" if buf == 1 else "fedbuff"] = n
        parts.append(
            f"buffer {buf}: {'B2' if buf == 1 else 'B3'} launches {n}, "
            f"max_tau {card['max_tau']}, P* {card['p_star']:.6f}, final P-P* "
            f"{card['final_subopt']:.6f} (cpu {host['final_subopt']:.6f}), "
            f"best {card['best_subopt']:.6f}, "
            f"{FED_CI['uploads'] / card['wall_s']:.1f} uploads/s on the "
            f"card ({card['wall_s']:.3f} s; cpu "
            f"{host['wall_s']:.3f} s); objective and suboptimality "
            f"{max(diff, obj) / p0:.3g} of P(0) apart")
    say("FT1 federated convex", "run_convex_federated logreg, 8 clients, "
        "400 uploads, hinge, card vs cpu (clients, taus, versions, weights "
        f"equal; envelope {OBJ_REL_ENVELOPE:g} of P(0) = {p0:.6f}): "
        + " | ".join(parts) + f"; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches


def phase_ft2_federated_transformer() -> None:
    """FT2: ``run_transformer_federated`` on the 25m preset at full width
    and depth (chunked attention), CLI defaults with 30 uploads, 4
    clients, 2 local steps: the loss first and last, uploads/s, peak
    memory, and the idle share of a second, profiled run.  No
    hand-written kernel runs."""
    t_phase = time.perf_counter()
    cfg = _train_cfg("25m")
    kw = dict(uploads=30, n_clients=4, local_steps=2, batch=4, seq=128,
              log_every=5, device=DEV)
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    log = _quiet(tfed.run_transformer_federated, cfg, **kw)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if any(fn.launches for fn in COUNTERS):
        raise AssertionError("FT2: a hand-written kernel launched")
    losses = [r["loss"] for r in log]
    if len(log) != 7 or not all(np.isfinite(losses)):
        raise AssertionError(f"FT2: log {log}")
    # the profile spans the whole call; the idle share is over the upload
    # loop alone (its wall from the log), with the set-up's device time
    # counted as the loop's, so the loop is idle at least that share
    prof_log = []
    wall, busy = _busy_wall(lambda: prof_log.extend(_quiet(
        tfed.run_transformer_federated, cfg, **kw)))
    loop_wall = prof_log[-1]["wall_s"]
    idle = (f"{1 - busy / loop_wall:.3f}" if 0 < busy <= loop_wall
            else "not measured")
    n_params = sum(p.numel() for p in
                   Transformer(cfg, None, torch.device("meta")).parameters())
    say("FT2 federated transformer", f"run_transformer_federated "
        f"{cfg.name} ({n_params / 1e6:.1f} M params, {cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, float32, attention chunked), 4 clients, 30 "
        f"uploads x 2 local SGD steps, batch 4 x 128, hinge: "
        f"{30 / log[-1]['wall_s']:.3f} uploads/s ({log[-1]['wall_s']:.3f} s,"
        f" 7 loss evaluations included), peak {peak:.3f} GiB; loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; gammas "
        f"{[round(r['gamma'], 4) for r in log]}, taus "
        f"{[r['tau'] for r in log]}; profiled run: wall {wall:.3f} s with "
        f"set-up, upload loop {loop_wall:.3f} s, device busy {busy:.3f} s "
        f"with set-up, the loop's idle share at least {idle}; no kernel "
        f"launches; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")


def phase_tr3_bcd_100m() -> None:
    """``run_bcd_training`` on the 100m preset at full width and depth, m
    4 blocks, 3 workers, Adaptive1(gamma' = 0.5) as the reference's test,
    30 steps: finite losses that fall."""
    t_phase = time.perf_counter()
    cfg = _train_cfg("100m")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    log = _quiet(tbcd.run_bcd_training, cfg, Adaptive1(gamma_prime=0.5),
                 steps=30, batch=8, seq=256, m_blocks=4, n_workers=3,
                 log_every=10, device=DEV)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [r["loss"] for r in log]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"TR3: the loss did not fall: {losses}")
    say("TR3 bcd 100m", f"run_bcd_training {cfg.name}, m 4 blocks, 3 "
        f"workers, batch 8 x seq 256: 30 steps in {wall:.3f} s (init "
        f"included), {30 / log[-1]['wall_s']:.3f} steps/s, peak "
        f"{peak:.3f} GiB; loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
        f"blocks {[r['block'] for r in log]}, taus "
        f"{[r['tau'] for r in log]}; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")


def _principle(log, gp: float) -> bool:
    """Eq. (8) on a runtime's log, to the float32 resolution of the
    policy's running sum S_k (the window sums are differences of it: at
    S_k ~ 500 one float32 ulp is 6e-5, above ``check_principle``'s default
    1e-5 gamma')."""
    total = np.float32(np.sum(np.asarray(log.gammas, np.float64)))
    atol = max(1e-5 * max(gp, 1.0), 4.0 * float(np.spacing(total)))
    return check_principle(log.gammas, log.taus, np.float32(gp), atol=atol)


def _tau_profile(taus) -> str:
    t = np.asarray(taus)
    q = np.percentile(t, [50, 90, 99]).tolist()
    return (f"tau max {int(t.max())}, share <= 5 {np.mean(t <= 5):.3f}, "
            f"p50/p90/p99 {q[0]:.0f}/{q[1]:.0f}/{q[2]:.0f}, counts "
            f"{np.bincount(t, minlength=1)[:12].tolist()}")


def _mnist_problem():
    """mnist-96's 60 000 x 784 problem (10 workers' shards), the resolve
    memo's entry (its block smoothness at m = 20 memoized in phase 4b)."""
    return api.resolve(main_spec(n_events=10)).problem


def phase_rt1_piag_server(prob) -> None:
    """The threaded PIAG parameter server (10 worker threads, each on its
    own stream) on mnist-96's problem, 2000 events, adaptive1 and adaptive2:
    Eq. (8) holds on the logs, the objective falls; events/s, the delays,
    the overlap."""
    t_phase = time.perf_counter()
    gp = 0.99 / prob.L
    notes = []
    for name, pol in (("adaptive1", Adaptive1(gamma_prime=gp)),
                      ("adaptive2", Adaptive2(gamma_prime=gp))):
        srv = PIAGServer(prob, pol, L1(lam=prob.lam1), n_workers=10,
                         device=DEV)
        t0 = time.perf_counter()
        log = srv.run(2000)
        wall = time.perf_counter() - t0
        if not _principle(log, gp):
            raise AssertionError(f"RT1 {name}: Eq. (8) violated")
        obj = log.objective
        if not (np.isfinite(obj).all() and obj[-1] < obj[0]):
            raise AssertionError(f"RT1 {name}: objective {obj[0]} -> "
                                 f"{obj[-1]}")
        notes.append(f"{name}: {2000 / wall:.1f} events/s, P {obj[0]:.6f} "
                     f"-> {obj[-1]:.6f}, {_tau_profile(log.taus)}, "
                     f"gradients in flight at once {log.in_flight_max}, "
                     f"crashes {log.crashes}, join failures "
                     f"{log.join_failures}")
    say("RT1 piag server", "PIAGServer 60000 x 784, 10 workers, 2000 "
        "events, Eq. (8) holds on both logs; " + "; ".join(notes)
        + f"; phase wall {time.perf_counter() - t_phase:.1f} s")


def phase_rt2_shared_memory_bcd(prob) -> None:
    """Threaded shared-memory Async-BCD (8 worker threads, m 20) on
    mnist-96's problem, 1500 events, ``examples/async_bcd_lasso.py``'s
    policies: adaptive1 measures the delays, the fixed step-sizes take its
    max; Eq. (8) holds on the adaptive logs (and is reported for the fixed
    ones, which are not built on it: Sun-Deng's gamma'/(tau_bound + 1/2)
    exceeds Eq. (8)'s gamma'/(tau + 1) at tau = tau_bound, and a delay
    past the bound breaks any fixed step-size)."""
    t_phase = time.perf_counter()
    m = 20
    lh = prob.block_smoothness(m)
    gp = 0.99 / lh
    prox = L1(lam=prob.lam1)

    def run(pol):
        # every event recorded: Eq. (8) needs every gamma of a window
        bcd = SharedMemoryBCD(prob, pol, prox, n_workers=8, m_blocks=m,
                              device=DEV)
        t0 = time.perf_counter()
        log = bcd.run(1500)
        return log, time.perf_counter() - t0

    runs = {"adaptive1": run(Adaptive1(gamma_prime=gp))}
    tau_max = max(runs["adaptive1"][0].taus)
    ratio = float(2.0 * prob.L / (lh * np.sqrt(m)))
    runs["adaptive2"] = run(Adaptive2(gamma_prime=gp))
    runs["sun_deng"] = run(SunDengFixed(gamma_prime=gp, tau_bound=tau_max))
    runs["davis"] = run(DavisFixed(gamma_prime=gp, tau_bound=tau_max,
                                   ratio=ratio))
    notes = []
    for name, (log, wall) in runs.items():
        # the adaptive policies hold Eq. (8) at any delay; the fixed ones
        # are not built on it (see the docstring)
        held = _principle(log, gp)
        if name.startswith("adaptive") and not held:
            raise AssertionError(f"RT2 {name}: Eq. (8) violated")
        obj = log.objective
        if len(obj) != 1500 or not np.isfinite(obj).all() \
                or not obj[-1] < obj[0]:
            raise AssertionError(f"RT2 {name}: {len(obj)} rows, objective "
                                 f"{obj[0]} -> {obj[-1]}")
        notes.append(f"{name}: {1500 / wall:.1f} events/s, P {obj[0]:.6f} "
                     f"-> {obj[-1]:.6f}, {_tau_profile(log.taus)}, in "
                     f"flight at once {log.in_flight_max}, Eq. (8) "
                     f"{'holds' if held else 'violated'}")
    say("RT2 shared-memory bcd", f"SharedMemoryBCD 60000 x 784, 8 workers, "
        f"m {m}, 1500 events, gamma' 0.99/Lhat, fixed tau bound {tau_max} "
        "(adaptive1's max); Eq. (8) holds on both adaptive logs; "
        + "; ".join(notes)
        + f"; phase wall {time.perf_counter() - t_phase:.1f} s")


def phase_rt3_runtime_chaos(prob) -> None:
    """On the card: a killed PIAG worker surfaces as ``WorkerCrash`` within
    its heartbeat, and with ``respawn=True`` a killed worker is revived and
    the run completes."""
    t_phase = time.perf_counter()
    pol, prox = Adaptive1(gamma_prime=0.99 / prob.L), L1(lam=prob.lam1)
    calls = {"n": 0}

    def killer(i):
        calls["n"] += 1
        if i == 1 and calls["n"] > 30:
            raise RuntimeError("injected kill")
        return 0.0

    srv = PIAGServer(prob, pol, prox, n_workers=10, worker_sleep=killer,
                     heartbeat=0.5, device=DEV)
    t0 = time.perf_counter()
    try:
        srv.run(2000)
    except WorkerCrash as e:
        surfaced = time.perf_counter() - t0
        if "injected kill" not in str(e.__cause__):
            raise
    else:
        raise AssertionError("RT3: the killed worker went unnoticed")
    killed = {"done": False}

    def kill_once(i):
        if i == 3 and not killed["done"]:
            killed["done"] = True
            raise RuntimeError("transient death")
        return 0.0

    log = PIAGServer(prob, pol, prox, n_workers=10, worker_sleep=kill_once,
                     respawn=True, heartbeat=0.5, device=DEV).run(300)
    if (log.crashes, log.respawns) != (1, 1) or len(log.objective) != 300 \
            or not np.isfinite(log.objective).all():
        raise AssertionError(f"RT3: crashes {log.crashes}, respawns "
                             f"{log.respawns}, {len(log.objective)} rows")
    say("RT3 runtime chaos", f"killed worker raised WorkerCrash after "
        f"{surfaced:.3f} s (heartbeat 0.5 s) with its exception chained; "
        f"respawn revived a killed worker: 300 events, crashes 1, "
        f"respawns 1, tau max {max(log.taus)}; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")


def phase_l1_lipschitz(prob) -> None:
    """``run_piag_lipschitz`` (neither the delay bound nor L) on mnist-96's
    problem and one 10-worker trace of 2500 events: finite, the objective
    falls, L_est never decreases."""
    t_phase = time.perf_counter()
    trace = simulate_parameter_server(10, 2500, seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_piag_lipschitz(prob, trace, L1(lam=prob.lam1), gamma0=1000.0,
                             device=DEV)
    obj = res.objective.cpu().numpy()
    L = res.opt_residual.cpu().numpy()
    wall = time.perf_counter() - t0
    if not (np.isfinite(obj).all() and obj[-1] < obj[0]
            and np.all(np.diff(L) >= 0)):
        raise AssertionError(f"L1: objective {obj[0]} -> {obj[-1]}, L_est "
                             f"{L[0]} -> {L[-1]}")
    say("L1 lipschitz", f"run_piag_lipschitz 60000 x 784, 10 workers, 2500 "
        f"events (max delay {trace.max_delay()}), gamma0 1000: "
        f"{2500 / wall:.1f} events/s, P {obj[0]:.6f} -> {obj[-1]:.6f}, "
        f"L_est {L[0]:.6f} -> {L[-1]:.6f} (the problem's L {prob.L:.6f}), "
        f"clipped {int(res.clipped)}; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")


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
    if bool((~(err <= env)).any()):  # NaN fails too
        raise AssertionError(f"B6 outside its envelope: max err "
                             f"{float(err.max())}")
    return float(err.max()) if err.numel() else 0.0


def phase_fa_vs_plain() -> float:
    """B6 against its plain version over both routes (bf16 d 64 and 128 on
    the tensor cores, f32 and bf16 d 48 on the SIMT kernel): causal,
    bidirectional, window 9; G 1 and 5 query heads per KV head folded into
    rows (positions tiled G times, as ``kernels.ops`` folds them); Sq/Sk
    from 1, 17, 64, 300, 2048; ring holes (kpos -1) in every third case."""
    gen = torch.Generator().manual_seed(6)
    shapes = [(1, 1), (17, 17), (64, 64), (300, 300), (2048, 2048),
              (1, 2048), (17, 300), (300, 2048), (64, 17)]
    worst = {"tc": 0.0, "simt": 0.0}
    cases, per_route = 0, {"tc": 0, "simt": 0}
    reset_counts()
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
                        route = fa.card_route(dtype, d)
                        worst[route] = max(worst[route], _fa_check(got, want))
                        per_route[route] += 1
                        cases += 1
    f = fa.flash_attention_bhsd
    if (f.launches, f.launches_tc) != (cases, per_route["tc"]):
        raise AssertionError(f"B6: {f.launches} launches (tensor-core "
                             f"{f.launches_tc}) for {cases} cases "
                             f"{per_route}")
    say("16 B6 kernel", f"{cases} cases (bf16 and f32; d 48, 64, 128; "
        "causal, bidirectional, window 9; G 1 and 5 heads folded into rows; "
        f"(Sq, Sk) in {shapes}; ring holes in every third case): launches "
        f"tensor-core route {f.launches_tc} (bf16 d 64, 128), SIMT route "
        f"{f.launches - f.launches_tc} (f32; bf16 d 48); max abs err "
        "tensor-core "
        f"{worst['tc']:.3g}, SIMT {worst['simt']:.3g} (envelopes: f32 "
        f"{FA_REL_ENVELOPE:g} x max|out|; bf16 {FA_BF16_ULPS} bf16 ulps of "
        "the plain output + that)")
    return max(worst.values())


def attention_work(BH: int, d: int, qpos, kpos, *, causal: bool,
                   window: Optional[int], itemsize: int,
                   dv: Optional[int] = None) -> Tuple[int, int]:
    """``(bytes, flops)`` one call must move and do on these positions:
    q, k (head dim ``d``), v (``dv``, default ``d``) and the positions
    read once and out (``dv``) written once; 2 (d + dv) flops (QK^T and
    PV) per visible (query, key) pair -- the pairs this run's positions
    make visible, not the full Sq x Sk."""
    dv = d if dv is None else dv
    qp = np.asarray(qpos.cpu() if torch.is_tensor(qpos) else qpos, np.int64)
    kp = np.asarray(kpos.cpu() if torch.is_tensor(kpos) else kpos, np.int64)
    keys = np.sort(kp[kp >= 0])
    live = qp[qp >= 0]
    hi = (np.searchsorted(keys, live, side="right") if causal
          else np.full(live.shape, keys.size))
    lo = (np.searchsorted(keys, live - window, side="right")
          if window is not None else np.zeros(live.shape, np.int64))
    pairs = int(np.clip(hi - lo, 0, None).sum())
    nbytes = (itemsize * BH * (d + dv) * (qp.size + kp.size)
              + 4 * (qp.size + kp.size))
    return nbytes, 2 * (d + dv) * pairs * BH


def _fa_serving_case(arch: str, B: int, S: int):
    """B6's inputs in a bf16 causal prefill of ``arch`` at batch ``B``,
    prompt ``S``: the query heads of each KV head folded into rows, as
    ``kernels.ops`` folds them; returns the dims, the kernel call and its
    plain version on the same card tensors."""
    cfg = get_config(arch)
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

    return (KV, G, d), (q, k, v, qpos, pos, scale), kernel, plain


def _fa_serving_check(tag: str, kernel, plain) -> float:
    """One launch of ``kernel`` on the tensor-core route, held against
    ``plain`` on the same inputs; the max abs error."""
    reset_counts()
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    _fa_routes(tag, 1)
    err = _fa_check(got, want)
    del got, want
    torch.cuda.empty_cache()
    return err


def phase_fa_check(arch: str, shapes) -> float:
    """B6 against its plain version at ``arch``'s prefill shapes ((batch,
    prompt) pairs), each launch on the tensor-core route."""
    worst, parts = 0.0, []
    for B, S in shapes:
        (KV, G, d), _, kernel, plain = _fa_serving_case(arch, B, S)
        err = _fa_serving_check(f"17 B6 check {arch}", kernel, plain)
        worst = max(worst, err)
        parts.append(f"q ({B * KV}, {G * S}, {d}), k/v ({B * KV}, {S}, {d}) "
                     f"(batch {B}, prompt {S}): max abs err {err:.3g}")
    cfg = get_config(arch)
    say(f"17 B6 check {arch}", f"flash_attention_bhsd vs plain at {arch}'s "
        f"prefill ({cfg.n_heads} heads over {cfg.n_kv_heads} KV heads, G "
        f"{cfg.n_heads // cfg.n_kv_heads}, head dim {cfg.head_dim}, bf16 "
        f"causal), one tensor-core launch each: " + "; ".join(parts))
    return worst


def phase_fa_timing(name: str, B: int, S: int, max_err: float) -> dict:
    """B6 at a serving shape of qwen2.5-32b (40 heads over 8 KV heads,
    head dim 128, bf16, causal): kernel vs plain there, then the kernel
    (the tensor-core route) graph-replayed and eager, the plain version,
    SDPA (the library call, never used by the port) and the bound."""
    (KV, G, d), (q, k, v, qpos, pos, scale), kernel, plain = \
        _fa_serving_case(SERVE_ARCH, B, S)
    H = KV * G
    err = _fa_serving_check(f"17 B6 timing S={S}", kernel, plain)
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
    # the split P does a third product: 6 d flops per visible pair
    split_ms = max(t_bytes, 1.5 * t_ops) * 1e3
    say(f"17 B6 timing S={S}", f"flash_attention_bhsd at q ({B * KV}, "
        f"{G * S}, {d}), k/v ({B * KV}, {S}, {d}) bf16 causal (batch {B}, "
        f"prompt {S}; tensor-core kernel vs plain here max abs err "
        f"{err:.3g}): {graph_ms * 1e3:.3f} us/launch replayed from a CUDA "
        f"graph, {eager_ms * 1e3:.3f} us eager; plain version "
        f"{plain_ms * 1e3:.3f} us; SDPA {library_ms * 1e3:.3f} us (max abs "
        f"diff to the kernel {lib_err:.3g}); bound {bound_ms * 1e3:.4f} us "
        f"({nbytes} bytes at {HBM_BYTES_PER_S / 1e12:g} TB/s, {flops} flops "
        f"at {BF16_OPS_PER_S / 1e12:g} TFLOP/s: {bound_by}), with the split "
        f"P's third product {split_ms * 1e3:.4f} us; "
        f"{flops / (graph_ms * 1e9):.1f} TFLOP/s achieved ("
        f"{t_ops * 1e3 / graph_ms:.3f} of the bf16 peak); card {name}")
    return dict(ms=graph_ms, eager_ms=eager_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                max_abs_err=max(max_err, err))


SERVE_EXPECT = {
    SERVE_ARCH: dict(n_layers=64, d_model=5120, param_dtype="bfloat16",
                     attention_impl="pallas"),
    SSM_ARCH: dict(n_layers=48, d_model=1536, ssm_heads=48,
                   param_dtype="bfloat16"),
    MOE_ARCH: dict(n_layers=24, d_model=2048, n_experts=60, top_k=4,
                   head_dim=128, param_dtype="bfloat16",
                   attention_impl="pallas", moe_impl="capacity"),
    HYBRID_ARCH: dict(n_layers=54, attn_every=6, d_model=2560, n_heads=32,
                      head_dim=80, ssm_heads=80, param_dtype="bfloat16",
                      attention_impl="pallas"),
    MLA_ARCH: dict(n_layers=60, d_model=5120, n_heads=128, use_mla=True,
                   kv_lora_rank=512, q_lora_rank=1536, nope_head_dim=128,
                   rope_head_dim=64, v_head_dim=128, n_experts=160, top_k=6,
                   param_dtype="bfloat16", attention_impl="pallas",
                   moe_impl="capacity"),
    VLM_ARCH: dict(n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
                   head_dim=128, rope="mrope", embed_inputs=True,
                   param_dtype="bfloat16", attention_impl="pallas"),
    AUDIO_ARCH: dict(n_layers=48, d_model=1280, n_heads=16, head_dim=80,
                     causal=False, has_decode=False, embed_inputs=True,
                     param_dtype="bfloat16", attention_impl="pallas")}


def _b6_per_prefill(cfg) -> int:
    """B6 launches one prefill (an encoder's forward) makes: one an
    attention layer, one a group of a hybrid (its shared block), none
    without attention."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    return cfg.n_layers


def _b6_route(cfg) -> str:
    """B6's route in a prefill of ``cfg``: by the compute dtype and the
    (q/k, v) head dims (MLA: nope + rope over v)."""
    if cfg.use_mla:
        return fa.card_route(cfg.cdtype, cfg.nope_head_dim
                             + cfg.rope_head_dim, cfg.v_head_dim)
    return fa.card_route(cfg.cdtype, cfg.head_dim)


def _b6_text(tag: str, cfg, launches: int) -> str:
    if cfg.family == "ssm":
        if fa.flash_attention_bhsd.launches or launches:
            raise AssertionError(f"{tag}: B6 launched on an ssm model")
        return "no B6 launch (attention-free)"
    return _fa_routes(tag, launches, tc=_b6_route(cfg) == "tc")


def phase_serve_model(tag: str, arch: str, name: str):
    """The full ``arch`` on the card from the port's initializer (its
    depth cut to ``SERVE_DEPTH`` where one card cannot hold it); the
    memory allocated once it is built."""
    cfg = get_config(arch)
    want = SERVE_EXPECT[arch]
    if {k: getattr(cfg, k) for k in want} != want:
        raise AssertionError(f"unexpected serving config {cfg}")
    cut = ""
    if arch in SERVE_DEPTH:
        cut = (f" (depth cut: n_layers {cfg.n_layers} -> "
               f"{SERVE_DEPTH[arch]})")
        cfg = cfg.replace(n_layers=SERVE_DEPTH[arch])
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                        device=DEV)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    torch.cuda.empty_cache()
    ssm = (f"{cfg.ssm_heads} SSM heads of {cfg.ssm_head_dim}, state "
           f"{cfg.ssm_state}, chunk {cfg.ssm_chunk}")
    attn = (f"MLA {cfg.n_heads} heads, latent {cfg.kv_lora_rank}, q/k "
            f"{cfg.nope_head_dim} + {cfg.rope_head_dim} over v "
            f"{cfg.v_head_dim}" if cfg.use_mla else
            f"{cfg.n_heads} heads over {cfg.n_kv_heads} KV heads of "
            f"{cfg.head_dim}")
    shape = (ssm if cfg.family == "ssm" else
             f"{ssm}; shared attention ({attn}) + MLP d_ff {cfg.d_ff} before "
             f"every {cfg.attn_every} layers" if cfg.family == "hybrid" else
             f"{attn}, {cfg.n_experts} experts (top {cfg.top_k}) of "
             f"{cfg.moe_ff} + shared {cfg.shared_ff}" if cfg.n_experts else
             f"{attn}, d_ff {cfg.d_ff}"
             + (f", M-RoPE {cfg.mrope_sections}" if cfg.rope == "mrope"
                else "")
             + ("" if cfg.causal else ", bidirectional encoder"))
    say(tag, f"{cfg.name}{cut}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{shape}, vocab {cfg.vocab}, bf16: {n} params ({nbytes / 1e9:.2f} "
        f"GB) initialized on the card in {time.perf_counter() - t0:.3f} s; "
        f"allocated {before / 2**30:.2f} GiB before the build, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB after; card "
        f"{name}")
    return cfg, model


def phase_generate(tag: str, cfg, model, batch: int, prompt: int,
                   gen: int, b6_share: bool = False) -> int:
    """``generate`` with every count set to 0 just before and read just
    after: one B6 launch per attention layer for the one prefill, each on
    the tensor-core route, no other kernel.  With ``b6_share`` the same
    prompts' ``prefill`` runs once more under the profiler (after a warm
    call), and the line gives B6's device time in it and its share of
    that prefill's wall."""
    prompts = torch.randint(0, cfg.vocab, (batch, prompt),
                            generator=torch.Generator(device=DEV)
                            .manual_seed(prompt), device=DEV,
                            dtype=torch.int32)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out, stats = generate(cfg, model, prompts, gen)
    launches = fa.flash_attention_bhsd.launches
    stray = sum(fn.launches for fn in COUNTERS
                if fn is not fa.flash_attention_bhsd)
    if launches != _b6_per_prefill(cfg) or stray:
        raise AssertionError(f"{tag}: {launches} B6 launches for one "
                             f"prefill (+{stray} of other kernels)")
    routes = _b6_text(tag, cfg, launches)
    new = out[:, prompt:]
    if tuple(out.shape) != (batch, prompt + gen) or \
            not torch.equal(out[:, :prompt], prompts) or \
            bool(((new < 0) | (new >= cfg.vocab)).any()):
        raise AssertionError(f"{tag}: bad output {tuple(out.shape)}")
    share = ""
    if b6_share:
        wall, by_name, _ = _profile(
            lambda: prefill(model, cfg, {"tokens": prompts}))
        b6 = [us for n, us in by_name.items()
              if "fa_tc_kernel" in n or "flash_attention_kernel" in n]
        share = (f", profiled prefill: wall {wall:.3f} s, B6 device time "
                 f"{sum(b6) / 1e6:.4f} s ({len(b6)} kernel names), a share "
                 f"of {sum(b6) / 1e6 / wall:.3f}" if b6 else
                 ", profiled prefill: no B6 device events recorded, its "
                 "share not measured")
    say(tag, f"generate {cfg.name} batch {batch}, prompt {prompt}, gen "
        f"{gen}: prefill (the first token) {stats['prefill_s']:.3f} s "
        f"({batch * prompt / stats['prefill_s']:.1f} tok/s), decode "
        f"{stats['decode_s']:.3f} s ({stats['tok_per_s']:.2f} tok/s, "
        f"{stats['decode_s'] / gen * 1e3:.2f} ms/step); per prefill: "
        f"{routes}{share}; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def _cache_expect(cfg, B: int, S: int) -> dict:
    """The leaves a prefill of (B, S) tokens must leave in the cache, by
    path, with their shapes."""
    ssm = {"h": (B, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)}
    attn = ({"ckv": (B, S, cfg.kv_lora_rank),
             "krope": (B, S, cfg.rope_head_dim)} if cfg.use_mla else
            {"k": (B, S, cfg.n_kv_heads, cfg.head_dim),
             "v": (B, S, cfg.n_kv_heads, cfg.head_dim)})
    if cfg.family == "ssm":
        return {n: (cfg.n_layers,) + t for n, t in ssm.items()}
    if cfg.family == "hybrid":
        G = cfg.n_layers // cfg.attn_every
        return {**{f"attn.{n}": (G,) + t for n, t in attn.items()},
                **{f"ssm.{n}": (G, cfg.attn_every) + t
                   for n, t in ssm.items()}}
    return {n: (cfg.n_layers,) + t for n, t in attn.items()}


def _at(tree, path: str):
    for key in path.split("."):
        tree = tree[key]
    return tree


def phase_logits_finite(tag: str, cfg, model) -> None:
    toks = torch.randint(0, cfg.vocab, (2, 64), device=DEV,
                         generator=torch.Generator(device=DEV).manual_seed(9))
    logits, cache = prefill(model, cfg, {"tokens": toks})
    want = _cache_expect(cfg, 2, 64)
    if tuple(logits.shape) != (2, 1, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()) or \
            any(tuple(_at(cache, n).shape) != s or
                not bool(torch.isfinite(_at(cache, n)).all())
                for n, s in want.items()):
        raise AssertionError(f"{tag}: prefill logits or cache malformed")
    say(tag, f"prefill (2, 64): logits {tuple(logits.shape)} finite, "
        f"|logit| max {float(logits.float().abs().max()):.3f}, cache "
        + ", ".join(f"{n} {s}" for n, s in want.items()) + " finite")


def phase_batcher(tag: str, cfg, model) -> None:
    """8 requests (prompts 32-1024, max_new 4-16: cut from 8-32 to keep
    the smoke in its time) through 4 slots of 2048; each greedy output
    equals a single-request generate of it."""
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, int(
        rng.integers(32, 1025))).astype(np.int32),
        max_new=int(rng.integers(4, 17))) for i in range(8)]
    cb = ContinuousBatcher(cfg, model, max_slots=4, max_len=2048)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    for r in reqs:
        cb.submit(r)
    stats = cb.run_until_idle()
    launches = fa.flash_attention_bhsd.launches
    if stats["completed"] != 8 or launches != 8 * _b6_per_prefill(cfg):
        raise AssertionError(f"{tag}: {stats}, B6 launches {launches}")
    routes = _b6_text(tag, cfg, launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    ttft = np.array([r.t_first_token - r.arrived_at for r in reqs])
    for r in reqs:
        out, _ = generate(cfg, model, r.prompt[None, :], r.max_new)
        if not np.array_equal(out[0, len(r.prompt):].cpu().numpy(),
                              r.output):
            raise AssertionError(f"{tag}: request {r.rid} differs from "
                                 "single-request generate")
    say(tag, f"ContinuousBatcher {cfg.name}, 4 slots x 2048: "
        f"completed {stats['completed']}, tokens {stats['tokens']}, ticks "
        f"{stats['ticks']}, wall {stats['wall_s']:.3f} s, "
        f"{stats['tok_per_s']:.2f} tok/s; time to first token median "
        f"{np.median(ttft):.3f} s, max {ttft.max():.3f} s; prompts "
        f"{sorted(len(r.prompt) for r in reqs)}, max_new "
        f"{[r.max_new for r in reqs]}; {routes} (8 prefills); peak "
        f"{peak:.2f} GiB; every output equals its single-request generate")


def phase_serve_profile(tag: str, cfg, model) -> None:
    """(a)'s prompt once under the profiler, with 16 decode steps (cut from
    (a)'s 32 to keep the smoke in its time; the steps repeat); (a) itself
    was the warm call."""
    phase_profile(tag, lambda: generate(cfg, model, torch.randint(
        0, cfg.vocab, (4, 64), device=DEV,
        generator=torch.Generator(device=DEV).manual_seed(3)), 16),
        f"generate {cfg.name} batch 4, prompt 64, gen 16 (one prefill and "
        "16 decode steps)", warm=False)


def phases_serve_family(prefix: str, arch: str, name: str,
                        batcher: bool = True) -> int:
    """M1, M2, N1-N3: ``arch`` at full width (and depth but for
    ``SERVE_DEPTH``), (a) batch 4, prompt 64, gen 32, (b) one 8192-token
    prompt (a VLM: an image batch, :func:`phase_vlm_embeds`), (c)
    ``ContinuousBatcher`` where ``batcher``, then a finite prefill and the
    idle share of (a); the model is freed after.  Returns the B6 launches
    of one prefill of (a)."""
    t_phase = time.perf_counter()
    walls = {}

    def step(what, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        walls[what] = time.perf_counter() - t
        return out

    cfg, model = step("model", phase_serve_model, f"{prefix} model", arch,
                      name)
    launches = step("a", phase_generate, f"{prefix} generate a", cfg, model,
                    4, 64, 32)
    if cfg.embed_inputs:
        step("b", phase_vlm_embeds, f"{prefix} embeds b", cfg, model)
    else:
        step("b", phase_generate, f"{prefix} generate b", cfg, model, 1,
             LONG_PROMPT, 8, b6_share=cfg.family != "ssm")
    if batcher:
        step("c", phase_batcher, f"{prefix} batcher", cfg, model)
    step("logits", phase_logits_finite, f"{prefix} logits", cfg, model)
    step("profile", phase_serve_profile, f"{prefix} profile", cfg, model)
    del model
    torch.cuda.empty_cache()
    say(prefix, f"{cfg.name} serving phases took "
        f"{time.perf_counter() - t_phase:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in walls.items())
        + f" s); allocated after freeing the model "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    return launches


def phase_vlm_embeds(tag: str, cfg, model) -> None:
    """A VLM's image path: an ``EmbedStream`` batch of 2 x 1024 positions,
    a 24 x 24 patch grid first and its (3, B, S) M-RoPE grids, prefilled
    into a 1040-token cache (one B6 launch a layer, the counts set to 0
    just before), then 16 greedy text decode steps through the token
    table."""
    B, S, gen = 2, 1024, 16
    batch = EmbedStream(d_model=cfg.d_model, vocab=cfg.vocab, batch=B, seq=S,
                        mrope=True, image_grid=(24, 24),
                        device=DEV).batch_at(0)
    inputs = {n: batch[n] for n in ("embeds", "positions")}
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    logits, cache = prefill(model, cfg, inputs, max_len=S + gen)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    routes = _b6_text(tag, cfg, _b6_per_prefill(cfg))
    tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    out = [tok]
    t0 = time.perf_counter()
    for pos in range(S, S + gen):
        logits, cache = decode_step(model, cfg, cache, tok, pos)
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        out.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    out = torch.cat(out, dim=1)
    if tuple(out.shape) != (B, gen + 1) or \
            bool(((out < 0) | (out >= cfg.vocab)).any()) or \
            not bool(torch.isfinite(logits).all()) or \
            fa.flash_attention_bhsd.launches != _b6_per_prefill(cfg):
        raise AssertionError(f"{tag}: bad output {tuple(out.shape)}")
    say(tag, f"prefill {cfg.name} on embeds (batch {B} x {S}: a 24 x 24 "
        f"image grid of {24 * 24} patches, then text; M-RoPE positions "
        f"{tuple(batch['positions'].shape)}) into a {S + gen}-token cache "
        f"{prefill_s:.3f} s ({B * S / prefill_s:.1f} tok/s); then {gen} "
        f"text decode steps {decode_s:.3f} s ({B * gen / decode_s:.2f} "
        f"tok/s, {decode_s / gen * 1e3:.2f} ms/step); per prefill: "
        f"{routes}; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        "GiB")


def phases_encoder(prefix: str, arch: str, name: str) -> int:
    """N4: an encoder (hubert-xlarge) at full width and depth: ``forward``
    over frame embeddings at batch 8 x 1500 frames (30-s clips at 50 Hz)
    and 1 x 8192 frames, one non-causal B6 launch a layer on its route
    (the counts set to 0 just before each), finite logits; then one
    forward of the first shape under the profiler (its idle share).
    Returns the B6 launches of one forward."""
    t_phase = time.perf_counter()
    cfg, model = phase_serve_model(f"{prefix} model", arch, name)
    per = _b6_per_prefill(cfg)
    batches = {}
    for B, S in ENCODER_SHAPES:
        batch = EmbedStream(d_model=cfg.d_model, vocab=cfg.vocab, batch=B,
                            seq=S, device=DEV).batch_at(0)
        batches[B, S] = {"embeds": batch["embeds"]}
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with torch.inference_mode():
            logits, _ = forward(model, cfg, batches[B, S])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        routes = _b6_text(f"{prefix} forward", cfg, per)
        if tuple(logits.shape) != (B, S, cfg.vocab) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{prefix}: encoder logits malformed")
        say(f"{prefix} forward", f"{cfg.name} forward over {B} x {S} frame "
            f"embeddings (bidirectional): {wall:.3f} s ({B * S / wall:.1f} "
            f"frames/s), logits {tuple(logits.shape)} finite; {routes}; "
            f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del logits
    first = batches[ENCODER_SHAPES[0]]

    def run():
        with torch.inference_mode():
            forward(model, cfg, first)
    phase_profile(f"{prefix} profile", run, f"forward {cfg.name} "
                  f"{' x '.join(map(str, ENCODER_SHAPES[0]))} frames (one B6 "
                  "launch a layer)", warm=False)
    del model, batches, first
    torch.cuda.empty_cache()
    say(prefix, f"{cfg.name} encoder phases took "
        f"{time.perf_counter() - t_phase:.1f} s; allocated after freeing "
        f"the model {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    return per


# B6's new SIMT instances at the prefill shapes of N1, N2 and N4: the arch,
# its (q/k, v) head dims, its KV heads after the fold (G 1: zamba2's and
# hubert's MHA, MLA expanded to KV = H), causal
FA_NEW_CASES = ((HYBRID_ARCH, (80, 80), 32, True),
                (MLA_ARCH, (192, 128), 128, True),
                (AUDIO_ARCH, (80, 80), 16, False))


def _fa_plain_rows(q, k, v, qpos, kpos, rows: int = 16, **kw):
    """The plain version over ``rows`` rows of BH at a time (the float32
    scores of an 8192-token prompt over all 128 MLA heads at once would
    take 34 GB): the same function on the same inputs."""
    with torch.no_grad():
        return torch.cat([fa.flash_attention_bhsd_ref(
            q[i:i + rows], k[i:i + rows], v[i:i + rows], qpos, kpos, **kw)
            for i in range(0, q.shape[0], rows)])


def _fa_new_inputs(KV: int, B: int, S: int, d: int, dv: int, dtype, seed):
    gen = torch.Generator(device=DEV).manual_seed(seed)
    q, k = (torch.randn(B * KV, S, d, generator=gen, device=DEV,
                        dtype=dtype) for _ in range(2))
    v = torch.randn(B * KV, S, dv, generator=gen, device=DEV, dtype=dtype)
    return q, k, v


def phase_fa_new_pairs(name: str) -> Tuple[float, list]:
    """17b: B6's SIMT instances at d 80 and at q/k 192 over v 128 against
    their plain version, float32 and bfloat16, at N1's, N2's and N4's
    prefill shapes ((batch, prompt) (4, 64) and (1, 8192), folded): at
    (4, 64) the arch's own mask, the other one (causal or not), window 9
    and -1 holes in every third key; at (1, 8192) the arch's own mask.
    Every launch on the SIMT route.  Then the bf16 kernel at the
    8192-token shapes timed beside its plain version, SDPA where SDPA
    takes the shape, and its bound (989 TFLOP/s bf16, 2 (d + dv) flops a
    visible pair).  Returns the worst error and the timings."""
    worst, cases, parts = 0.0, 0, []
    reset_counts()
    for arch, (d, dv), KV, causal in FA_NEW_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            errs = []
            for B, S in FA_NEW_SHAPES:
                q, k, v = _fa_new_inputs(KV, B, S, d, dv, dtype, S + d)
                pos = torch.arange(S, dtype=torch.int32, device=DEV)
                holes = torch.where(pos % 3 == 0, -1, pos).to(torch.int32)
                variants = ([(causal, None, pos), (not causal, None, pos),
                             (True, 9, pos), (causal, None, holes)]
                            if (B, S) == FA_NEW_SHAPES[0]
                            else [(causal, None, pos)])
                for c, window, kpos in variants:
                    kw = dict(causal=c, window=window, scale=d ** -0.5)
                    got = fa.flash_attention_bhsd(q, k, v, pos, kpos, **kw)
                    want = _fa_plain_rows(q, k, v, pos, kpos, **kw)
                    torch.cuda.synchronize()
                    errs.append(_fa_check(got, want))
                    cases += 1
                    del got, want
                del q, k, v
                torch.cuda.empty_cache()
            worst = max(worst, max(errs))
            parts.append(f"{arch} ({d}, {dv}) {str(dtype)[6:]} "
                         f"{max(errs):.3g}")
    f = fa.flash_attention_bhsd
    if (f.launches, f.launches_tc) != (cases, 0):
        raise AssertionError(f"17b: {f.launches} launches ({f.launches_tc} "
                             f"tensor-core) for {cases} SIMT cases")
    say("17b B6 new pairs", f"{cases} cases, all on the SIMT route "
        f"(launches {f.launches}, tensor-core {f.launches_tc}): max abs err "
        "by arch, pair and dtype: " + "; ".join(parts) + " (B6's envelopes)")
    timings = []
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for arch, (d, dv), KV, causal in FA_NEW_CASES:
        B, S = FA_NEW_SHAPES[-1]
        q, k, v = _fa_new_inputs(KV, B, S, d, dv, torch.bfloat16, S + d + 1)
        pos = torch.arange(S, dtype=torch.int32, device=DEV)
        kw = dict(causal=causal, scale=d ** -0.5)
        reset_counts()
        got = fa.flash_attention_bhsd(q, k, v, pos, pos, **kw)
        err = _fa_check(got, _fa_plain_rows(q, k, v, pos, pos, **kw))
        _fa_routes(f"17b B6 timing {arch}", 1, tc=False)

        def kernel():
            return fa.flash_attention_bhsd(q, k, v, pos, pos, **kw)

        def plain():
            return _fa_plain_rows(q, k, v, pos, pos, **kw)

        graph_ms, eager_ms, _, plain_ms = _time_kernel(kernel, plain)
        torch.cuda.empty_cache()
        q4, k4, v4 = (t.reshape(B, KV, S, t.shape[-1]) for t in (q, k, v))
        try:
            lib_out = sdpa(q4, k4, v4, is_causal=causal, scale=d ** -0.5)
            lib_err = float((lib_out.reshape(got.shape).float()
                             - got.float()).abs().max())
            del lib_out
            library_ms = _time_launches(
                lambda: sdpa(q4, k4, v4, is_causal=causal, scale=d ** -0.5),
                10)
            lib = (f"SDPA {library_ms * 1e3:.3f} us (max abs diff to the "
                   f"kernel {lib_err:.3g})")
        except RuntimeError as e:   # no SDPA backend takes the shape
            library_ms = None
            lib = f"SDPA refuses the shape ({str(e).splitlines()[0][:80]})"
        nbytes, flops = attention_work(B * KV, d, pos, pos, causal=causal,
                                       window=None, itemsize=2, dv=dv)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_OPS_PER_S
        bound_ms = max(t_bytes, t_ops) * 1e3
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        say(f"17b B6 timing {arch}", f"flash_attention_bhsd SIMT at q/k "
            f"({B * KV}, {S}, {d}), v ({B * KV}, {S}, {dv}) bf16 "
            f"{'causal' if causal else 'bidirectional'} ({arch}'s {S}-token "
            f"prefill, folded; vs plain max abs err {err:.3g}): "
            f"{graph_ms * 1e3:.3f} us/launch replayed from a CUDA graph, "
            f"{eager_ms * 1e3:.3f} us eager; plain version "
            f"{plain_ms * 1e3:.3f} us; {lib}; bound {bound_ms * 1e3:.4f} us "
            f"({nbytes} bytes, {flops} flops at {BF16_OPS_PER_S / 1e12:g} "
            f"TFLOP/s: {bound_by}); {flops / (graph_ms * 1e9):.2f} TFLOP/s "
            f"achieved; card {name}")
        timings.append(dict(arch=arch, dims=[d, dv], shape=[B * KV, S],
                            causal=causal, ms=graph_ms, eager_ms=eager_ms,
                            plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, library_ms=library_ms,
                            max_abs_err=err))
        del q, k, v, got, q4, k4, v4
        torch.cuda.empty_cache()
    return max([worst] + [t["max_abs_err"] for t in timings]), timings



# N5: the reduced configs with the full models' head dims restored, so
# that B6's new instances run inside a model on the card (d 80; MLA's
# nope 128 + rope 64 over v 128)
FULL_HEAD_DIMS = {HYBRID_ARCH: dict(head_dim=80),
                  AUDIO_ARCH: dict(head_dim=80),
                  MLA_ARCH: dict(nope_head_dim=128, rope_head_dim=64,
                                 v_head_dim=128)}


def phase_card_vs_cpu(tag: str, archs, overrides=None) -> None:
    """Each of ``archs``' ``.reduced()`` configs (with ``overrides[arch]``
    replaced) in float32, the same parameters on both devices through
    ``interop``: prefill (logits and cache; an encoder's forward) and
    forward (logits and aux) within ``LOGIT_F32_ENVELOPE``, B6 once a
    prefill per attention layer (a hybrid's group) on its SIMT route
    (float32), and greedy ``generate`` tokens equal where the model
    decodes.  Text models take tokens; the audio and VLM frontends
    ``EmbedStream`` embeddings (with M-RoPE grids for the VLM), and the
    VLM generates from text prompts."""
    parts = []
    for arch in archs:
        cfg = get_config(arch).reduced().replace(
            **(overrides or {}).get(arch, {}))
        cpu = init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
        card = interop.model_params(interop.model_tree(cpu), cfg, device=DEV)
        toks = torch.randint(0, cfg.vocab, (2, 40),
                             generator=torch.Generator().manual_seed(1))
        batch = ({n: t for n, t in EmbedStream(
            d_model=cfg.d_model, vocab=cfg.vocab, batch=2, seq=40,
            mrope=cfg.rope == "mrope", device="cpu").batch_at(0).items()
            if n != "targets"} if cfg.embed_inputs else {"tokens": toks})
        on_card = {n: t.to(DEV) for n, t in batch.items()}
        run = prefill if cfg.has_decode else forward
        reset_counts()
        lg, cg = run(card, cfg, on_card)
        launches = fa.flash_attention_bhsd.launches
        if launches != _b6_per_prefill(cfg) or \
                fa.flash_attention_bhsd.launches_tc:
            raise AssertionError(f"{tag} {arch}: {launches} B6 launches")
        lc, cc = run(cpu, cfg, batch)
        fg, ag = forward(card, cfg, on_card)
        fc, ac = forward(cpu, cfg, batch)
        diffs = [float((lg.cpu() - lc).abs().max()),
                 float((fg.cpu() - fc).abs().max())]
        if cfg.has_decode:
            diffs += [float((a.cpu() - b).abs().max()) for a, b in
                      zip(_leaves(cg), _leaves(cc))]
        diff = max(diffs)
        aux = abs(float(ag) - float(ac))
        if not (diff <= LOGIT_F32_ENVELOPE and aux <= 1e-6):
            raise AssertionError(f"{tag} {arch}: logits differ by {diff}, "
                                 f"aux by {aux}")
        if cfg.has_decode:
            og, _ = generate(cfg, card, toks.to(DEV), 16)
            oc, _ = generate(cfg, cpu, toks, 16)
            if not torch.equal(og.cpu(), oc):
                raise AssertionError(f"{tag} {arch}: greedy tokens differ")
        dims = (f"q/k {cfg.nope_head_dim} + {cfg.rope_head_dim} over v "
                f"{cfg.v_head_dim}" if cfg.use_mla else
                f"head dim {cfg.head_dim}")
        parts.append(f"{cfg.name} ({cfg.n_layers} layers, d_model "
                     f"{cfg.d_model}, {dims}, attention_impl "
                     f"{cfg.attention_impl}, "
                     f"{'embeddings' if cfg.embed_inputs else 'tokens'}):"
                     f" logits{' and cache' if cfg.has_decode else ''} max "
                     f"abs diff {diff:.3g}, aux {aux:.3g}, B6 launches per "
                     f"{'prefill' if cfg.has_decode else 'forward'} "
                     f"{launches}" + (" (SIMT route)" if launches else "")
                     + ("" if cfg.has_decode else ", no decode (encoder)"))
    say(tag, "float32, params carried by interop, prefill and forward "
        f"(envelope {LOGIT_F32_ENVELOPE:g}), greedy generate 2 x (40 + 16) "
        "tokens equal: " + "; ".join(parts))


# ------------------------------------------- B4, B5, B7 and kernels.ops ----

def _bf16_ulp(w: torch.Tensor) -> torch.Tensor:
    """The spacing of bfloat16 numbers at |w| (8 significant bits)."""
    _, e = torch.frexp(w.float().abs())
    return torch.ldexp(torch.ones_like(w, dtype=torch.float32), e - 8)


def _rms_check(got, want, tally: list) -> float:
    """B5's envelope (module constants); returns the max abs error and adds
    a bfloat16 output's count of elements not bitwise equal to the plain
    version's, and its size, to ``tally``."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    env = (RMS_F32_ULPS * torch.finfo(torch.float32).eps * w.abs()
           if want.dtype == torch.float32 else _bf16_ulp(w))
    if bool((~(err <= env)).any()):  # NaN fails too
        raise AssertionError(f"B5 outside its envelope: max err "
                             f"{float(err.max())}")
    if want.dtype == torch.bfloat16:
        tally[0] += int((got != want).sum())
        tally[1] += want.numel()
    return float(err.max())


def _rms_unequal_share(tally: list) -> float:
    """The share of B5's bfloat16 elements that are not bitwise equal to
    the plain version's; raises above ``RMS_BF16_UNEQUAL``."""
    share = tally[0] / max(tally[1], 1)
    if share > RMS_BF16_UNEQUAL:
        raise AssertionError(f"B5 bf16: {tally[0]} of {tally[1]} elements "
                             "not bitwise equal to the plain version")
    return share


def _ssd_check(got, want, what: str) -> float:
    """B7's envelope (module constants); returns the max abs error."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    env = SSD_REL_ENVELOPE * max(float(w.abs().max()), 1e-30)
    if want.dtype == torch.bfloat16:
        env = env + _bf16_ulp(w)
    if bool((~(err <= env)).any()):  # NaN fails too
        raise AssertionError(f"B7 {what} outside its envelope: max err "
                             f"{float(err.max())}")
    return float(err.max())


def phase_prox_vs_plain() -> float:
    """B4 against its plain version, bitwise: none, l1, l2, box; float32
    and bfloat16; the pad-tail sizes and 2^20 + 3, each aligned (the
    16-byte vector path) and as a view one element in (the scalar path);
    gamma as a Python float and as a 0-d tensor on the card."""
    gen = torch.Generator().manual_seed(11)
    sizes = (1, 127, 128, 1023, 1024, 1025, 4097, (1 << 20) + 3)
    gam_dev = torch.tensor(0.29687762, device=DEV)
    before = px.prox_step.launches
    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for kind in px.KINDS:
            for n in sizes:
                x, g = (torch.randn(n + 1, generator=gen).to(dtype).to(DEV)
                        for _ in range(2))
                for gamma in (0.13, gam_dev):
                    for xs, gs in ((x[:n], g[:n]), (x[1:], g[1:])):
                        got = kops.prox_step(xs, gs, gamma, kind=kind,
                                             lam=0.47437608)
                        want = px.prox_step_ref(xs, gs, gamma, kind=kind,
                                                lam=0.47437608)
                        if got.dtype != dtype or not torch.equal(got, want):
                            raise AssertionError(f"B4 not bitwise: {dtype} "
                                                 f"{kind} n={n} {gamma}")
                        cases += 1
    launches = px.prox_step.launches - before
    if launches != cases:
        raise AssertionError(f"B4: {launches} launches for {cases} cases")
    say("K1 B4 kernel", f"{cases} cases (f32 and bf16; none, l1, l2, box; n "
        f"in {sizes}, aligned and one element in; gamma a Python float and "
        "a 0-d tensor on the card): every output bitwise equal to the plain "
        "version")
    return 0.0


def phase_rms_vs_plain() -> float:
    """B5 against its plain version: float32 and bfloat16; D 64, 2048,
    5120, 8192; rows 1, 7, 257, 300 (not multiples of the reference's
    256-row block)."""
    gen = torch.Generator().manual_seed(12)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    tally = [0, 0]
    before = rn.rmsnorm.launches
    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for D in (64, 2048, 5120, 8192):
            for rows in (1, 7, 257, 300):
                xs = (torch.randn(rows, D, generator=gen) * 3).to(dtype).to(DEV)
                sc = (torch.randn(D, generator=gen) + 1).to(dtype).to(DEV)
                got = kops.rmsnorm_fused(xs, sc)
                want = rn.rmsnorm_ref(xs, sc)
                if got.dtype != dtype or got.shape != xs.shape:
                    raise AssertionError("B5 output malformed")
                worst[dtype] = max(worst[dtype],
                                   _rms_check(got, want, tally))
                cases += 1
    launches = rn.rmsnorm.launches - before
    if launches != cases:
        raise AssertionError(f"B5: {launches} launches for {cases} cases")
    share = _rms_unequal_share(tally)
    say("K2 B5 kernel", f"{cases} cases (f32 and bf16; D 64, 2048, 5120, "
        "8192; rows 1, 7, 257, 300): max abs err "
        f"f32 {worst[torch.float32]:.3g}, bf16 {worst[torch.bfloat16]:.3g}; "
        f"bf16 not bitwise equal: {tally[0]} of {tally[1]} ({share:.3g}) "
        f"(envelopes: f32 {RMS_F32_ULPS} ulps of each element, bf16 one bf16"
        f" ulp and at most {RMS_BF16_UNEQUAL:g} not bitwise)")
    return max(worst.values())


def _ssd_inputs(gen, Bt, S, H, P, G, N, x_dtype, h0=False):
    """SSD inputs on the card: x in ``x_dtype``; dt = softplus(normal +
    mamba2's dt_bias spread), A = -linspace(1, 16, H) (mamba2's A_log
    init); B, C, h0 float32."""
    bias = torch.log(torch.expm1(torch.linspace(1e-3, 1e-1, H)))
    out = dict(
        x=torch.randn(Bt, S, H, P, generator=gen).to(x_dtype),
        dt=torch.nn.functional.softplus(
            torch.randn(Bt, S, H, generator=gen) + bias),
        A=-torch.linspace(1.0, 16.0, H),
        B=torch.randn(Bt, S, G, N, generator=gen),
        C=torch.randn(Bt, S, G, N, generator=gen))
    if h0:
        out["h0"] = torch.randn(Bt, H, P, N, generator=gen)
    return {k: v.to(DEV) for k, v in out.items()}


def _ssd_kernel_inputs(inp, chunk: int):
    """The intra-chunk kernel's inputs as ``ssd_scan_pallas`` makes them
    (S a whole number of chunks): x (BC, Q, H, P) in its dtype, dt and
    dA = dt * A (BC, Q, H), B and C (BC, Q, G, N), float32."""
    x, dt, A, B, C = (inp[k] for k in ("x", "dt", "A", "B", "C"))
    Bt, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    Q = min(chunk, S)
    BC = Bt * (S // Q)
    return (x.reshape(BC, Q, H, P), dt.reshape(BC, Q, H).float(),
            (dt.float() * A.float()).reshape(BC, Q, H),
            B.reshape(BC, Q, G, N).float(), C.reshape(BC, Q, G, N).float())


def ssd_intra_work(BC: int, Q: int, H: int, P: int, G: int, N: int,
                   x_itemsize: int) -> Tuple[int, int]:
    """``(bytes, flops)`` one intra-chunk call must move and do at float32
    accuracy on the tensor cores: x, dt, dA, B, C read once and y and the
    state written once (float32); the products in split TF32, each float32
    product three TF32 ones, two where x is bfloat16 (exact in TF32): the
    causal half (diagonal included) of C B^T once per (chunk, group) at
    three, W x per cell and the Q x N x P state product per cell at two or
    three; 2 flops a multiply-add."""
    nbytes = (x_itemsize * BC * Q * H * P + 4 * 2 * BC * Q * H
              + 4 * 2 * BC * Q * G * N + 4 * BC * Q * H * P
              + 4 * BC * H * N * P)
    pairs = Q * (Q + 1) // 2
    by_x = 2 if x_itemsize == 2 else 3
    flops = 2 * (3 * BC * G * pairs * N
                 + by_x * (BC * H * pairs * P + BC * H * Q * N * P))
    return nbytes, flops


def phase_ssd_vs_plain() -> float:
    """B7 against its plain version, and ``ssd_scan_pallas`` (the kernel
    and the host combine) against the port's ``ssd_chunked`` on the card:
    the reference test sweep's dims (chunk 16), kernel_bench's (chunk 128),
    chunk 256 with N 128 and G < H over a ragged sequence with h0, and
    mamba2-780m's heads; x float32 and bfloat16."""
    gen = torch.Generator().manual_seed(13)
    cases = [((2, 40, 4, 8, 2, 16), 16), ((1, 64, 2, 16, 1, 8), 16),
             ((2, 17, 6, 8, 3, 4), 16), ((2, 512, 8, 64, 1, 64), 128),
             ((1, 700, 8, 64, 2, 128), 256), ((1, 1024, 48, 64, 1, 128), 256)]
    worst = 0.0
    before = ss.ssd_intra_chunk.launches
    n_calls = 0
    for dims, chunk in cases:
        for x_dtype in (torch.float32, torch.bfloat16):
            inp = _ssd_inputs(gen, *dims, x_dtype, h0=dims[1] == 700)
            if dims[1] % min(chunk, dims[1]) == 0:
                kin = _ssd_kernel_inputs(inp, chunk)
                y, st = ss.ssd_intra_chunk(*kin)
                y_r, st_r = ss.ssd_intra_chunk_ref(*kin)
                worst = max(worst, _ssd_check(y, y_r, "y"),
                            _ssd_check(st, st_r, "state"))
                n_calls += 1
            y, h = kops.ssd_scan_pallas(**inp, chunk=chunk)
            y2, h2 = ssd_chunked(**inp, chunk=chunk)
            if y.dtype != x_dtype or h.dtype != torch.float32:
                raise AssertionError("ssd_scan_pallas output dtypes")
            worst = max(worst, _ssd_check(y, y2, "scan y"),
                        _ssd_check(h, h2, "scan state"))
            n_calls += 1
    torch.cuda.synchronize()
    launches = ss.ssd_intra_chunk.launches - before
    if launches != n_calls:
        raise AssertionError(f"B7: {launches} launches for {n_calls} calls")
    say("K3 B7 kernel", f"{n_calls} calls ((Bt, S, H, P, G, N), chunk in "
        f"{cases}; x f32 and bf16; h0 on the ragged case): kernel vs plain "
        "and ssd_scan_pallas vs ssd_chunked, y and state max abs err "
        f"{worst:.3g} (envelope {SSD_REL_ENVELOPE:g} x max|out|, + one bf16"
        " ulp for a bf16 y)")
    return worst


def _ops_inputs():
    """The inputs of ``kernels.ops`` at the two shapes of each kernel: (a)
    ``benchmarks/kernel_bench.py``'s, (b) full model width."""
    gen = torch.Generator(device=DEV).manual_seed(14)
    qwen = get_config(SERVE_ARCH)
    mamba = get_config("mamba2-780m")
    layer = Layer(qwen, torch.Generator(device=DEV).manual_seed(15), DEV)
    params = {name: {k: p.detach() for k, p in getattr(layer, name).items()}
              for name in ("ln1", "attn", "ln2", "mlp")}
    grads = {name: {k: torch.randn(p.shape, generator=gen, device=DEV,
                                   dtype=p.dtype) * 1e-2
                    for k, p in leaves.items()}
             for name, leaves in params.items()}
    n = 1 << 20
    return dict(
        prox_a=(torch.randn(n, generator=gen, device=DEV),
                torch.randn(n, generator=gen, device=DEV), 0.1),
        prox_b=(params, grads, torch.tensor(0.05, device=DEV)),
        rms_a=(torch.randn(4096, 2048, generator=gen, device=DEV),
               torch.ones(2048, device=DEV)),
        rms_b=(torch.randn(8192, qwen.d_model, generator=gen, device=DEV,
                           dtype=torch.bfloat16),
               (torch.randn(qwen.d_model, generator=gen, device=DEV) + 1
                ).to(torch.bfloat16)),
        ssd_a=(_ssd_inputs(torch.Generator().manual_seed(16), 2, 512, 8, 64,
                           1, 64, torch.float32), 128),
        ssd_b=(_ssd_inputs(torch.Generator().manual_seed(17), 1, 8192,
                           mamba.ssm_heads, mamba.ssm_head_dim,
                           mamba.ssm_n_groups, mamba.ssm_state,
                           torch.bfloat16), mamba.ssm_chunk))


def _leaves(tree):
    return ([t for v in tree.values() for t in _leaves(v)]
            if isinstance(tree, dict) else [tree])


def phase_kernels_ops(inp) -> dict:
    """``repro_torch.kernels.ops`` at shapes (a) and (b), every count set
    to 0 just before and read just after: one B4 launch for (a) and one
    per leaf of the layer for (b), one B5 and one B7 launch per call, no
    other kernel.  Then each output against its plain version (B4, B5) or
    the model oracle ``ssd_chunked`` (B7) on the same inputs."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = dict(
        prox_a=kops.prox_step(*inp["prox_a"], kind="l1", lam=1e-3),
        prox_b=kops.prox_step_tree(*inp["prox_b"], kind="l1", lam=1e-4),
        rms_a=kops.rmsnorm_fused(*inp["rms_a"]),
        rms_b=kops.rmsnorm_fused(*inp["rms_b"]),
        ssd_a=kops.ssd_scan_pallas(**inp["ssd_a"][0], chunk=inp["ssd_a"][1]),
        ssd_b=kops.ssd_scan_pallas(**inp["ssd_b"][0], chunk=inp["ssd_b"][1]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_leaves = len(_leaves(inp["prox_b"][0]))
    launches = {"B4": px.prox_step.launches, "B5": rn.rmsnorm.launches,
                "B7": ss.ssd_intra_chunk.launches}
    stray = sum(fn.launches for fn in COUNTERS[:4])
    if launches != {"B4": 1 + n_leaves, "B5": 2, "B7": 2} or stray:
        raise AssertionError(f"kernels.ops: launches {launches} (+{stray} "
                             "of other kernels)")
    err = {"B4": 0.0}
    want = px.prox_step_ref(*inp["prox_a"], kind="l1", lam=1e-3)
    if not torch.equal(out["prox_a"], want):
        raise AssertionError("kernels.ops prox_step (a) not bitwise")
    params, grads, gamma = inp["prox_b"]
    for name, leaves in params.items():
        for k, p in leaves.items():
            want = px.prox_step_ref(p, grads[name][k], gamma, kind="l1",
                                    lam=1e-4)
            got = out["prox_b"][name][k]
            if got.dtype != p.dtype or not torch.equal(got, want):
                raise AssertionError(f"prox_step_tree (b) leaf {name}.{k} "
                                     "not bitwise")
            del want
    tally = [0, 0]
    err["B5"] = max(_rms_check(out[k], rn.rmsnorm_ref(*inp[k]), tally)
                    for k in ("rms_a", "rms_b"))
    share = _rms_unequal_share(tally)
    err["B7"] = 0.0
    for k in ("ssd_a", "ssd_b"):
        y, h = out[k]
        args, chunk = inp[k]
        if not (bool(torch.isfinite(y).all()) and bool(
                torch.isfinite(h).all())):
            raise AssertionError(f"ssd_scan_pallas {k}: not finite")
        y2, h2 = ssd_chunked(**args, chunk=chunk)
        err["B7"] = max(err["B7"], _ssd_check(y, y2, f"{k} y"),
                        _ssd_check(h, h2, f"{k} state"))
        del y2, h2
    B, S, H, P = inp["ssd_b"][0]["x"].shape
    G, N = inp["ssd_b"][0]["B"].shape[2:]
    say("K4 kernels.ops", f"prox_step (a) n=2^20 f32 l1; prox_step_tree (b) "
        f"over one qwen2.5-32b layer ({n_leaves} bf16 leaves, "
        f"{sum(t.numel() for t in _leaves(params))} params, gamma a 0-d "
        f"tensor on the card) l1; rmsnorm_fused (a) "
        f"{tuple(inp['rms_a'][0].shape)} f32, (b) "
        f"{tuple(inp['rms_b'][0].shape)} bf16; ssd_scan_pallas (a) (2, 512, "
        f"8, 64; G 1, N 64; chunk 128) f32, (b) mamba2-780m ({B}, {S}, {H}, "
        f"{P}; G {G}, N {N}; chunk {inp['ssd_b'][1]}) bf16 x: "
        f"wall {wall:.3f} s; launches {launches}, others 0; B4 bitwise, "
        f"max abs err B5 {err['B5']:.3g} (bf16 not bitwise equal: "
        f"{share:.3g}), B7 {err['B7']:.3g} (vs ssd_chunked)")
    return dict(launches=launches, err=err)


def _time_row(tag: str, what: str, kernel, plain, nbytes: int, flops: int,
              name: str, library=None, max_err: float = 0.0,
              ops_per_s: float = F32_OPS_PER_S) -> dict:
    """Time ``kernel`` (graph-replayed and eager), ``plain`` and, where
    given, ``library``; the bound from ``nbytes`` and ``flops`` at
    ``ops_per_s`` (float32 outside the tensor cores unless given)."""
    graph_ms, eager_ms, _, plain_ms = _time_kernel(kernel, plain)
    library_ms = (None if library is None else
                  _time_launches(library, min(2000, _reps(library))))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / ops_per_s
    bound_ms = max(t_bytes, t_ops) * 1e3
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    say(tag, f"{what}: {graph_ms * 1e3:.3f} us replayed from a CUDA graph, "
        f"{eager_ms * 1e3:.3f} us eager; plain version "
        f"{plain_ms * 1e3:.3f} us; "
        + ("" if library_ms is None else
           f"library {library_ms * 1e3:.3f} us; ")
        + f"bound {bound_ms * 1e3:.4f} us ({nbytes} bytes at "
        f"{HBM_BYTES_PER_S / 1e12:g} TB/s, {flops} flops at "
        f"{ops_per_s / 1e12:g} TFLOP/s: {bound_by}); card {name}")
    torch.cuda.empty_cache()
    return dict(ms=graph_ms, eager_ms=eager_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                max_abs_err=max_err)


def phase_ops_timing(inp, name: str, errs: dict) -> dict:
    """Each kernel at shapes (a) and (b) against its plain version and
    bound; B5 also against ``F.rms_norm`` (the library call, never used by
    the port); ``ssd_scan_pallas`` whole at (b) against ``ssd_chunked``, so
    that the host combine's share is on record.  Returns the (b) rows."""
    rows = {}
    x, g, gam = inp["prox_a"]
    _time_row("K5 B4 timing a", f"prox_step n={x.numel()} f32 l1",
              lambda: kops.prox_step(x, g, gam, kind="l1", lam=1e-3),
              lambda: px.prox_step_ref(x, g, gam, kind="l1", lam=1e-3),
              3 * 4 * x.numel(), PROX_L1_FLOPS * x.numel(), name)
    params, grads, gam = inp["prox_b"]
    n = sum(t.numel() for t in _leaves(params))
    n_leaves = len(_leaves(params))
    rows["B4"] = _time_row(
        "K5 B4 timing b", f"prox_step_tree over one qwen2.5-32b layer "
        f"({n_leaves} bf16 leaves, {n} params; {n_leaves} launches a call)",
        lambda: kops.prox_step_tree(params, grads, gam, kind="l1", lam=1e-4),
        lambda: {k: {j: px.prox_step_ref(p, grads[k][j], gam, kind="l1",
                                         lam=1e-4) for j, p in v.items()}
                 for k, v in params.items()},
        3 * 2 * n + 4 * n_leaves, PROX_L1_FLOPS * n, name,
        max_err=errs["B4"])
    for key, label in (("rms_a", "a"), ("rms_b", "b")):
        x, sc = inp[key]
        rows_, D = x.shape
        lib_out = torch.nn.functional.rms_norm(x, (D,), weight=sc, eps=1e-6)
        lib_diff = float((lib_out.float() - kops.rmsnorm_fused(x, sc).float()
                          ).abs().max())
        del lib_out
        row = _time_row(
            f"K6 B5 timing {label}", f"rmsnorm_fused ({rows_}, {D}) "
            f"{str(x.dtype)[6:]} (F.rms_norm differs from the kernel by at "
            f"most {lib_diff:.3g})",
            lambda: kops.rmsnorm_fused(x, sc),
            lambda: rn.rmsnorm_ref(x, sc),
            2 * x.element_size() * x.numel() + sc.element_size() * D,
            4 * x.numel() + 4 * rows_, name,
            library=lambda: torch.nn.functional.rms_norm(
                x, (D,), weight=sc, eps=1e-6), max_err=errs["B5"])
    rows["B5"] = row
    for key, label in (("ssd_a", "a"), ("ssd_b", "b")):
        args, chunk = inp[key]
        kin = _ssd_kernel_inputs(args, chunk)
        BC, Q, H, P = kin[0].shape
        G, N = kin[3].shape[2], kin[3].shape[3]
        nbytes, flops = ssd_intra_work(BC, Q, H, P, G, N,
                                       kin[0].element_size())
        row = _time_row(
            f"K7 B7 timing {label}", f"ssd_intra_chunk BC {BC}, Q {Q}, H "
            f"{H}, P {P}, G {G}, N {N}, x {str(kin[0].dtype)[6:]} "
            f"({BC * H} cells; split-TF32 products on the tensor cores)",
            lambda: ss.ssd_intra_chunk(*kin),
            lambda: ss.ssd_intra_chunk_ref(*kin), nbytes, flops, name,
            max_err=errs["B7"], ops_per_s=TF32_OPS_PER_S)
    rows["B7"] = row
    args, chunk = inp["ssd_b"]
    whole = _time_launches(lambda: kops.ssd_scan_pallas(**args, chunk=chunk),
                           5)
    oracle = _time_launches(lambda: ssd_chunked(**args, chunk=chunk), 5)
    say("K8 ssd_scan_pallas b", f"whole scan at (b): {whole * 1e3:.3f} us "
        f"(the kernel {row['eager_ms'] * 1e3:.3f} us eager, so the host "
        f"combine takes {1 - row['eager_ms'] / whole:.3f} of it); "
        f"ssd_chunked (composed torch ops) {oracle * 1e3:.3f} us; card "
        f"{name}")
    torch.cuda.empty_cache()
    return rows


def phases_training() -> None:
    """TR1-TR3 (the trainers at 100m), RT1-RT3 (the threaded runtimes on
    mnist-96's problem) and L1, with their wall time."""
    t_train = time.perf_counter()
    phase_tr1_train_100m()
    phase_tr2_train_card_vs_cpu()
    phase_tr3_bcd_100m()
    torch.cuda.empty_cache()
    prob = _mnist_problem()
    phase_rt1_piag_server(prob)
    phase_rt2_shared_memory_bcd(prob)
    phase_rt3_runtime_chaos(prob)
    phase_l1_lipschitz(prob)
    del prob
    torch.cuda.empty_cache()
    say("TR-L1", f"training, runtime and Lipschitz phases took "
        f"{time.perf_counter() - t_train:.1f} s")


def main() -> None:
    if sys.argv[1:] == ["--only-training"]:
        # the training and runtime phases alone (no kernel is built: none
        # runs there); prints no result line
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        phase_device()
        phases_training()
        return
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
    # Async-BCD (B1 on the gathered block rows) and the telemetry
    res_bcd, bcd_launches = phase_bcd_main_path()
    del res_bcd
    phase_bcd_scan_vs_fused()
    phase_fig4()
    phase_profile("8b bcd profile", lambda: api.run(bcd_spec(n_events=200)),
                  "api.run Async-BCD 200 events x 96 cells (resolve "
                  "included)")
    phase_telemetry()
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
    # faults (scan engine, no kernel) and checkpointed resume (B1-B3 on
    # the unfinished buckets only)
    phase_f1_threefry()
    phase_f2_faulted_main_path()
    phase_f3_fig_faults()
    phase_f4_other_solvers()
    resumed = phase_r1_resume()
    # the static-analysis gate: lint, op-trace contracts, cache keys
    phase_sc_staticcheck()
    # the sharded backend (B1-B3 launched by every row on its card)
    sharded = phases_sharded()
    # training (the trainers take the chunked attention, no kernel) and the
    # threaded runtimes, then the federated trainer (FT1: B2/B3; FT2: no
    # kernel), before the serving phases allocate qwen2.5-32b
    phases_training()
    fed_cli_runs = phase_ft1_federated_convex()
    phase_ft2_federated_transformer()
    torch.cuda.empty_cache()
    # the serving path (B6): the kernel alone first, then the full model
    fa_err = phase_fa_vs_plain()
    t_fa = phase_fa_timing(name, 4, 64, fa_err)
    t_fa_long = phase_fa_timing(name, 1, 8192, fa_err)
    # the MoE prefill's shapes (G 1, the long prompt's 8192 keys)
    moe_fa_err = phase_fa_check(MOE_ARCH, ((4, 64), (1, 8192)))
    # the SIMT instances of the hybrid, MLA and encoder prefills (17b)
    new_fa_err, t_fa_new = phase_fa_new_pairs(name)
    t_fa["max_abs_err"] = max(t_fa["max_abs_err"], t_fa_long["max_abs_err"],
                              moe_fa_err, new_fa_err)
    phase_card_vs_cpu("18 card vs cpu", (SERVE_ARCH,))
    # kernels.ops (B4, B5, B7): the kernels alone, then the entry points at
    # kernel_bench's shapes and full model width, before the model is built
    prox_err = phase_prox_vs_plain()
    rms_err = phase_rms_vs_plain()
    ssd_err = phase_ssd_vs_plain()
    ops_inp = _ops_inputs()
    ops_run = phase_kernels_ops(ops_inp)
    errs = {"B4": prox_err, "B5": max(rms_err, ops_run["err"]["B5"]),
            "B7": max(ssd_err, ops_run["err"]["B7"])}
    t_ops = phase_ops_timing(ops_inp, name, errs)
    del ops_inp
    clear_program_cache()  # the cached sweep programs hold their problems
    torch.cuda.empty_cache()
    cfg, model = phase_serve_model("19 model", SERVE_ARCH, name)
    fa_launches = phase_generate("20 generate a", cfg, model, 4, 64, 32)
    phase_generate("20 generate b", cfg, model, 1, 8192, 8, b6_share=True)
    phase_batcher("21 batcher", cfg, model)
    phase_logits_finite("22 logits", cfg, model)
    phase_serve_profile("23 serve profile", cfg, model)
    # qwen2.5-32b (65.5 GB) is freed before the MoE model (28.6 GB) is built
    del model
    torch.cuda.empty_cache()
    phases_serve_family("M1", SSM_ARCH, name)
    moe_launches = phases_serve_family("M2", MOE_ARCH, name)
    phase_card_vs_cpu("M3 card vs cpu", (SSM_ARCH, MOE_ARCH))
    # the hybrid, MLA, VLM and audio models at full width, one at a time
    # (N1-N4), then their reduced configs card vs CPU (N5)
    t_new = time.perf_counter()
    hybrid_launches = phases_serve_family("N1", HYBRID_ARCH, name)
    mla_launches = phases_serve_family("N2", MLA_ARCH, name, batcher=False)
    vlm_launches = phases_serve_family("N3", VLM_ARCH, name, batcher=False)
    audio_launches = phases_encoder("N4", AUDIO_ARCH, name)
    phase_card_vs_cpu("N5 card vs cpu", (HYBRID_ARCH, MLA_ARCH, VLM_ARCH,
                                         AUDIO_ARCH), FULL_HEAD_DIMS)
    say("N", f"N1-N5 took {time.perf_counter() - t_new:.1f} s")
    timing["launches_by_path"] = {
        "piag": launches, "bcd": bcd_launches, "resume": resumed["piag"],
        "sharded_s1": sharded["S1"], "sharded_s2_2": sharded["S2"]["(2,)"],
        "sharded_s2_1x2": sharded["S2"]["(1, 2)"],
        "sharded_s3_bcd": sharded["S3"]["bcd"],
        "sharded_s4_mega": sharded["S4"]}
    t_mix["launches_by_path"] = {"fedasync": fed["fedasync"][1],
                                 "resume": resumed["fedasync"],
                                 "sharded_s3": sharded["S3"]["fedasync"],
                                 "train_federated": fed_cli_runs["fedasync"]}
    t_buff["launches_by_path"] = {"fedbuff": fed["fedbuff"][1],
                                  "resume": resumed["fedbuff"],
                                  "sharded_s3": sharded["S3"]["fedbuff"],
                                  "train_federated": fed_cli_runs["fedbuff"]}
    t_fa["launches_by_path"] = {SERVE_ARCH: fa_launches,
                                MOE_ARCH: moe_launches,
                                HYBRID_ARCH: hybrid_launches,
                                MLA_ARCH: mla_launches,
                                VLM_ARCH: vlm_launches,
                                AUDIO_ARCH: audio_launches}
    t_fa["instances"] = t_fa_new
    rows = [("fused_policy_prox_step", KERNEL_SOURCE, REPLACES,
             launches + bcd_launches, timing),
            ("fused_policy_mix_step", KERNEL_SOURCE, REPLACES_MIX,
             fed["fedasync"][1], t_mix),
            ("fused_policy_buff_step", KERNEL_SOURCE, REPLACES_BUFF,
             fed["fedbuff"][1], t_buff),
            ("flash_attention_bhsd", FA_SOURCE, REPLACES_FA, fa_launches,
             t_fa),
            ("prox_step", PROX_SOURCE, REPLACES_PROX,
             ops_run["launches"]["B4"], t_ops["B4"]),
            ("rmsnorm", RMS_SOURCE, REPLACES_RMS, ops_run["launches"]["B5"],
             t_ops["B5"]),
            ("ssd_intra_chunk", SSD_SOURCE, REPLACES_SSD,
             ops_run["launches"]["B7"], t_ops["B7"])]
    kernels = {"kernels": [dict(
        name=kname, route="cuda", source=src, replaces=rep,
        launches=n, max_abs_err=t["max_abs_err"], ms=t["ms"],
        eager_ms=t["eager_ms"], plain_ms=t["plain_ms"],
        bound_ms=t["bound_ms"], bound_by=t["bound_by"],
        library_ms=t.get("library_ms"), floor_ms=t.get("floor_ms"),
        **{k: t[k] for k in ("launches_by_path", "instances") if k in t})
        for kname, src, rep, n, t in rows]}
    say("24 kernels", f"smoke finished in {time.perf_counter() - t0:.1f} s")
    print(json.dumps(kernels), flush=True)
    print(card(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
