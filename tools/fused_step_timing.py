"""Time the fused event kernels B1-B3 and the launch floor on the card, and
break one eager call of each wrapper into its host steps; with ``--ssd``
also the SSD intra-chunk kernel B7.

    python3 tools/fused_step_timing.py [--root DIR] [--label NAME] [--paths]
                                       [--ssd]

``--root`` names the tree whose ``src/repro_torch`` and ``chip_smoke.py``
are used (default: the tree holding this tool), so one call can time two
trees on one card, in turns: ``--root`` of an older export, then this
tree, this tree, the export.  At the main paths' shapes (B1: 96 x 784,
H = 256, l1; B2: 24 x 784, H = 256; B3: 24 x 784, H = 64; policy ids
cycling, k well past H) it prints, per kernel:

* the kernel against its plain version once (k, clipped exact, ids 0-3
  bitwise; it fails otherwise);
* us per launch replayed from a CUDA graph and eager, before and after
  the graph, and the plain version eager, all by the tree's own
  ``chip_smoke._time_kernel``;
* in a tree with the current launch path, the host steps of one eager
  call, each timed alone over 2000 calls with ``time.perf_counter`` (the
  launch step launches): ``kernel_route``, ``_card_pointers``, the
  outputs' allocation, the stream handle, the ctypes call.

The empty kernel (``_launch_floor``, with B1's grid and with B3's) is
timed the same way where the tree has it.  With ``--ssd`` it times B7
at the smoke's kernels-ops shapes, (a) ``kernel_bench``'s (Bt 2, S 512, H
8, P 64, G 1, N 64, chunk 128, float32 x) and (b) one mamba2-780m layer
on 8192 tokens (H 48, P 64, G 1, N 128, chunk 256, bfloat16 x), from the
tree's own ``chip_smoke._ssd_inputs`` and ``_ssd_kernel_inputs`` with the
smoke's seeds, each checked against its plain version first (within 1e-5
of max|out|).  With ``--paths`` it then
drives the tree's own smoke phases for the paths these kernels serve:
the builds, PIAG ``api.run`` (phase 4) and its profile (8), FedAsync and
FedBuff ``api.run`` (10) and the FedAsync profile (14).  The last line is
one JSON object with the kernels' numbers, the card's name and power
limit beside them.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 2000


def _args():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=ROOT,
                    help="tree whose src/repro_torch and chip_smoke.py are used")
    ap.add_argument("--label", default=None, help="name printed per line")
    ap.add_argument("--paths", action="store_true",
                    help="also run the tree's smoke phases 4, 8, 10, 14")
    ap.add_argument("--ssd", action="store_true",
                    help="also time B7 at the smoke's shapes (a) and (b)")
    return ap.parse_args()


def host_us(step) -> float:
    """Host microseconds per call of ``step`` (no synchronisation inside
    the loop; the card drains after it)."""
    import torch
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(REPS):
        step()
    us = (time.perf_counter() - t0) / REPS * 1e6
    torch.cuda.synchronize()
    return us


def cases(dev):
    """``{kernel: (wrapper, plain, (params, state), kind, rest)}`` at the
    main paths' shapes: the wrapper and the plain version take ``(params,
    state)``; ``rest`` are their other arguments, in the launch's order."""
    import numpy as np
    import torch
    from repro_torch.core.prox import L1
    from repro_torch.core.stepsize import StepsizeState
    from repro_torch.kernels import fused_step as fs
    from repro_torch.sweep.policies import PolicyParams

    def state_and_params(rng, B, H):
        pid = torch.tensor(np.arange(B) % 6, dtype=torch.int32, device=dev)
        f = dict(dtype=torch.float32, device=dev)
        params = PolicyParams(pid, torch.tensor(rng.random(B) + 0.5, **f),
                              torch.tensor(rng.random(B) * 0.9 + 0.05, **f),
                              torch.tensor(rng.random(B) * 5, **f))
        cum = np.cumsum(rng.random((B, H)), axis=1)
        i = dict(dtype=torch.int32, device=dev)
        k = torch.tensor(rng.integers(4 * H, 5 * H, B), **i)
        state = StepsizeState(k, torch.tensor(cum[:, -1] + 1.0, **f),
                              torch.tensor(cum, **f), torch.zeros(B, **i))
        tau = torch.tensor(rng.integers(0, H + 6, B), **i)
        return params, state, tau

    def vecs(rng, B, d, n):
        return [torch.tensor(rng.normal(size=(B, d)), dtype=torch.float32,
                             device=dev) for _ in range(n)]

    rng = np.random.default_rng(0)
    p1, s1, t1 = state_and_params(rng, 96, 256)
    x1, g1 = vecs(rng, 96, 784, 2)
    prox = L1(lam=1e-3)
    p2, s2, t2 = state_and_params(rng, 24, 256)
    x2, c2 = vecs(rng, 24, 784, 2)
    p3, s3, t3 = state_and_params(rng, 24, 64)
    x3, c3, w3, d3 = vecs(rng, 24, 784, 4)
    a3 = torch.tensor(np.arange(24) % 2, dtype=torch.float32, device=dev)
    return {
        "B1 fused_policy_prox_step (96, 784), H=256": (
            lambda p, s: fs.fused_policy_prox_step(p, prox, s, t1, x1, g1),
            lambda p, s: fs.fused_policy_prox_step_ref(p, prox, s, t1, x1,
                                                       g1),
            (p1, s1), "prox", (prox, t1, x1, g1)),
        "B2 fused_policy_mix_step (24, 784), H=256": (
            lambda p, s: fs.fused_policy_mix_step(p, s, t2, x2, c2),
            lambda p, s: fs.fused_policy_mix_step_ref(p, s, t2, x2, c2),
            (p2, s2), "mix", (t2, x2, c2)),
        "B3 fused_policy_buff_step (24, 784), H=64": (
            lambda p, s: fs.fused_policy_buff_step(p, s, t3, x3, c3, w3, d3,
                                                   a3, 0.1),
            lambda p, s: fs.fused_policy_buff_step_ref(p, s, t3, x3, c3, w3,
                                                       d3, a3, 0.1),
            (p3, s3), "buff", (t3, a3, x3, c3, w3, d3)),
    }


def check(fn, ref, params, state) -> None:
    """One event of the kernel and of its plain version from copies of
    ``state``: k, clipped exact; gamma, total, cumbuf and the vectors of
    ids 0-3 bitwise."""
    import torch
    sa = type(state)(*(t.clone() for t in state))
    sb = type(state)(*(t.clone() for t in state))
    (ga, _, *va), (gb, _, *vb) = fn(params, sa), ref(params, sb)
    torch.cuda.synchronize()
    exact = params.policy_id <= 3
    assert torch.equal(sa.k, sb.k) and torch.equal(sa.clipped, sb.clipped)
    for a, b in [(ga, gb), (sa.total, sb.total), (sa.cumbuf, sb.cumbuf),
                 *zip(va, vb)]:
        assert torch.equal(a[exact], b[exact])


def steps(kind, params, state, extra):
    """``{step: callable}`` of one eager call of the current launch path,
    in its order."""
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import fused_step as fs
    if kind == "prox":
        prox, tau, *vectors = extra
    else:
        tau, *vectors = extra
    x = vectors[-4] if kind == "buff" else vectors[0]
    B, d = x.shape
    H = state.horizon
    name = f"fused_policy_{kind}_step"
    if kind == "prox":
        tail = (B, d, H, *fs.prox_code(prox), 0)
    else:
        tail = (B, d, H, 0) if kind == "mix" else (B, d, H, 0.1, 0)
    tensors = (*params, tau, *state, *vectors)
    n_out = 3 if kind == "buff" else 2

    def alloc():
        outs = [torch.empty_like(x) for _ in range(n_out - 1)]
        return outs + [torch.empty((B,), dtype=torch.float32,
                                   device=x.device)]

    out_ptrs = [t.data_ptr() for t in alloc()]
    spec = {"prox": fs._PROX_SPEC, "mix": fs._MIX_SPEC,
            "buff": fs._BUFF_SPEC}[kind]
    ptrs = fs._card_pointers(name, spec, tensors, B, d, H)
    fn = fs._fns()[f"{name}_launch"]
    idx = x.get_device()

    def stream():
        return (idx == torch.cuda.current_device(),
                dispatch.current_stream_handle(idx))

    raw = stream()[1]
    return {
        "kernel_route": lambda: dispatch.kernel_route(*tensors),
        "_card_pointers": lambda: fs._card_pointers(name, spec, tensors, B,
                                                    d, H),
        "allocate outputs": alloc,
        "current device + stream handle": stream,
        "ctypes call (launch)": lambda: fn(*ptrs, *out_ptrs, *tail, raw),
    }


def _timed(smoke, kernel, plain=None) -> dict:
    """``smoke._time_kernel``'s numbers in us per call."""
    args = (kernel,) if plain is None else (kernel, plain)
    graph, eager, eager_after, plain_ms = smoke._time_kernel(*args)
    row = dict(graph_us=graph * 1e3, eager_us=eager * 1e3,
               eager_after_us=eager_after * 1e3)
    if plain_ms is not None:
        row["plain_us"] = plain_ms * 1e3
    return row


def ssd_rows(smoke, label: str) -> dict:
    """B7 at the smoke's shapes (a) and (b): checked against its plain
    version, then timed by the tree's ``_time_kernel``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan as ss
    mamba = get_config("mamba2-780m")
    shapes = {
        "a": ((2, 512, 8, 64, 1, 64, torch.float32), 128, 16),
        "b": ((1, 8192, mamba.ssm_heads, mamba.ssm_head_dim,
               mamba.ssm_n_groups, mamba.ssm_state, torch.bfloat16),
              mamba.ssm_chunk, 17)}
    rows = {}
    for key, (dims, chunk, seed) in shapes.items():
        inp = smoke._ssd_inputs(torch.Generator().manual_seed(seed), *dims)
        kin = smoke._ssd_kernel_inputs(inp, chunk)
        got, want = ss.ssd_intra_chunk(*kin), ss.ssd_intra_chunk_ref(*kin)
        torch.cuda.synchronize()
        err = 0.0
        for g, w in zip(got, want):
            e = float((g - w).abs().max())
            assert e <= 1e-5 * float(w.abs().max()), (key, e)
            err = max(err, e)
        del got, want
        BC, Q, H, P = kin[0].shape
        name = (f"B7 ssd_intra_chunk ({key}) BC {BC}, Q {Q}, H {H}, P {P}, "
                f"G {kin[3].shape[2]}, N {kin[3].shape[3]}, "
                f"{str(kin[0].dtype)[6:]} x")
        row = _timed(smoke, lambda: ss.ssd_intra_chunk(*kin),
                     lambda: ss.ssd_intra_chunk_ref(*kin))
        row["max_abs_err"] = err
        rows[name] = row
        print(f"[{label}] {name}: {row['graph_us']:.3f} us/launch "
              f"replayed, {row['eager_us']:.3f} / "
              f"{row['eager_after_us']:.3f} eager, plain "
              f"{row['plain_us']:.3f}; max abs err vs plain {err:.3g}",
              flush=True)
        del inp, kin
        torch.cuda.empty_cache()
    return rows


def main() -> None:
    args = _args()
    root = os.path.abspath(args.root)
    sys.path[:0] = [os.path.join(root, "src"), root]
    import torch
    if not torch.cuda.is_available():
        sys.exit("fused_step_timing.py: no CUDA device available")
    import chip_smoke as smoke
    from repro_torch.kernels import fused_step as fs
    label = args.label or os.path.basename(root)
    name = smoke.card()
    dev = torch.device("cuda")
    out = {"label": label, "root": root, "card": name, "kernels": {}}
    print(f"[{label}] {fs.__file__} on {name}", flush=True)
    current = hasattr(fs, "_card_pointers")
    for kname, (fn, ref, (params, state), kind, extra) in cases(dev).items():
        check(fn, ref, params, state)
        row = _timed(smoke, lambda: fn(params, state),
                     lambda: ref(params, state))
        text = (f"[{label}] {kname}: {row['graph_us']:.3f} us/launch "
                f"replayed, {row['eager_us']:.3f} / "
                f"{row['eager_after_us']:.3f} eager (before / after the "
                f"graph), plain {row['plain_us']:.3f}")
        if current:
            br = {step: host_us(call) for step, call in
                  steps(kind, params, state, extra).items()}
            row["host_steps_us"] = br
            row["host_call_us"] = host_us(lambda: fn(params, state))
            text += (f"; host {row['host_call_us']:.3f} us a call = "
                     + ", ".join(f"{s} {v:.3f}" for s, v in br.items())
                     + f" (sum {sum(br.values()):.3f})")
        out["kernels"][kname] = row
        print(text, flush=True)
    if not current:
        print(f"[{label}] no host-step breakdown: this tree predates the "
              "current launch path", flush=True)
    floor = getattr(fs, "_launch_floor", None)
    for B in (96, 24) if floor else ():
        row = _timed(smoke, lambda: floor(B))
        out["kernels"][f"floor, {B} blocks of 256"] = row
        print(f"[{label}] empty kernel, {B} blocks of 256: "
              f"{row['graph_us']:.3f} us/launch replayed, "
              f"{row['eager_us']:.3f} / {row['eager_after_us']:.3f} eager",
              flush=True)
    if args.ssd:
        out["kernels"].update(ssd_rows(smoke, label))
    if args.paths:
        run_paths(smoke)
    print(json.dumps(out), flush=True)


def run_paths(smoke) -> None:
    """The main paths of B1-B3 through the tree's ``chip_smoke`` module, in
    the order and with the arguments of its ``main``."""
    from repro_torch import api
    smoke.phase_build()
    smoke.phase_main_path()
    smoke.phase_profile(
        "8 profile", lambda: api.run(smoke.main_spec(n_events=200)),
        "api.run PIAG 200 events x 96 cells (resolve included)")
    for solver in ("fedasync", "fedbuff"):
        smoke.phase_fed_main_path(solver)
    smoke.phase_profile(
        "14 fed profile",
        lambda: api.run(smoke.fed_spec("fedasync", n_events=200)),
        "api.run FedAsync 200 uploads x 24 cells (resolve included)")


if __name__ == "__main__":
    main()
