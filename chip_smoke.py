"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from ``src/repro_torch/kernels/csrc``, holds
it against its plain PyTorch version on the card, drives the port's main
path (``repro_torch.api.run`` for PIAG, batched, default engine) at the
paper's MNIST shape, and times the kernel.  Each phase prints one line;
any failure raises and the script exits non-zero.  The last two lines are
the card's name and power limit, and ``{"ok": true, "device": ...}``.
Exits non-zero without a result when no CUDA device is present.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: no CUDA device available; nothing was run")

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch import api  # noqa: E402
from repro_torch.core.engine import simulate_parameter_server  # noqa: E402
from repro_torch.core.piag import run_piag_logreg  # noqa: E402
from repro_torch.core.problems import make_logreg  # noqa: E402
from repro_torch.core.prox import L1, make_prox  # noqa: E402
from repro_torch.core.stepsize import (Adaptive1, FixedStepSize,  # noqa: E402
                                       StepsizeState)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.fused_step import (  # noqa: E402
    boundary_bytes, fused_policy_prox_step, fused_policy_prox_step_ref)
from repro_torch.sweep.policies import POLICY_IDS, PolicyParams  # noqa: E402

DEV = torch.device("cuda")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3, NVIDIA data sheet
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/fused_step.cu"
REPLACES = "src/repro/kernels/fused_step.py:209"
POLICIES = ("adaptive1", "adaptive2", "fixed", "naive", "hinge", "poly")
PROXES = (("none", {}), ("l1", dict(lam=1e-2)), ("l2", dict(lam=1e-2)),
          ("elastic_net", dict(lam1=1e-2, lam2=1e-2)),
          ("box", dict(lo=-0.5, hi=0.5)), ("group_l2", dict(lam=1.0)))
# envelopes: gamma of hinge/poly (powf vs torch.pow) in float32 ulps of
# the value; x_new of hinge/poly/group_l2 relative to the largest |x_new|
GAMMA_ULP_ENVELOPE = 4
X_REL_ENVELOPE = 1e-5
OBJ_REL_ENVELOPE = 1e-5        # objective, relative to the initial value


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
    built = build.load("fused_step")
    report = " | ".join(line.strip() for line in built.ptxas.splitlines()
                        if "Used" in line or "spill" in line)
    say("2 build", f"{built.path.name} built in {built.build_seconds:.3f} s "
        f"(0 = reused) from {KERNEL_SOURCE}; ptxas: {report}")


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


def phase_main_path():
    fused_policy_prox_step.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = api.run(main_spec())
    wall = time.perf_counter() - t0
    launches = fused_policy_prox_step.launches
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


def _time_launches(fn, n: int) -> float:
    """Milliseconds per call of ``fn`` over ``n`` back-to-back calls."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


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

    for _ in range(20):
        kernel()
        plain()
    torch.cuda.synchronize()
    eager_ms = _time_launches(kernel, 2000)
    plain_ms = _time_launches(plain, 200)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            kernel()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    per_graph = 100
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            kernel()
    graph.replay()
    torch.cuda.synchronize()
    graph_ms = _time_launches(graph.replay, 20) / per_graph
    eager_ms2 = _time_launches(kernel, 2000)
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


def phase_profile() -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    spec = main_spec(n_events=200)
    api.run(spec)  # warm: problem memo, caching allocator
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        api.run(spec)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            us = ev.time_range.end - ev.time_range.start
            by_name[ev.name] = by_name.get(ev.name, 0.0) + us
    if not by_name:
        say("8 profile", f"200 events x 96 cells: wall {wall:.3f} s; the "
            "profiler recorded no device events, device busy share not "
            "measured")
        return
    busy = sum(by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    say("8 profile", f"api.run 200 events x 96 cells (resolve included): "
        f"wall {wall:.3f} s, device busy {busy:.3f} s ({busy / wall:.3f}), "
        f"idle share {1 - busy / wall:.3f}; top kernels (s): "
        + "; ".join(f"{n[:60]} {us / 1e6:.4f}" for n, us in top))


def main() -> None:
    t0 = time.perf_counter()
    name = phase_device()
    phase_build()
    max_err = phase_kernel_vs_plain()
    res, launches = phase_main_path()
    phase_scan_vs_fused()
    phase_headline()
    timing = phase_timing(res.horizon, name, max_err)
    phase_profile()
    kernels = {"kernels": [dict(
        name="fused_policy_prox_step", route="cuda", source=KERNEL_SOURCE,
        replaces=REPLACES, launches=launches,
        max_abs_err=timing["max_abs_err"], ms=timing["ms"],
        eager_ms=timing["eager_ms"], plain_ms=timing["plain_ms"],
        bound_ms=timing["bound_ms"], bound_by=timing["bound_by"],
        library_ms=None)]}
    say("9 kernels", f"smoke finished in {time.perf_counter() - t0:.1f} s")
    print(json.dumps(kernels), flush=True)
    print(card(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
