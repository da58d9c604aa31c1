"""Build variants of B6's CUDA source and check or time each on the card.

    python3 tools/b6_variants.py ablation      # parts of the work left out
    python3 tools/b6_variants.py spill         # builds that spill
    python3 tools/b6_variants.py simt          # the SIMT kernel's spill

Each variant is ``src/repro_torch/kernels/csrc/flash_attention.cu`` with a
preset's string edits applied (each must find its target).  All
variants are built at once by the port's own ``build.load`` (the sources
in a temporary directory, the libraries in the git-ignored build
directory), bound by the wrapper's ``_bind``, and run one process each, so
a faulty variant cannot disturb the next.  For each the tool prints the
registers and the local memory (spills and stack) of the tensor-core
instances, then one result line:

* a variant named ``abl_*`` leaves out part of the work and computes a
  wrong result on purpose: it is only timed, at the 8192-token folded
  prompt (q (8, 40960, 128), k/v (8, 8192, 128), bf16, causal), eagerly;
* any other is held against the plain version at a 64-token (batch 4),
  a 2048-token and the 8192-token folded prompt (three launches each,
  B6's bf16 envelope), its inputs and a 16 MiB buffer beside them compared
  before and after (a stray store shows there), timed there eagerly, and
  followed by one float32 SIMT launch checked against its plain version.

The preset ``simt`` studies the SIMT kernel instead: for each variant it
prints every SIMT instance's registers (ptxas) and local memory (the
runtime's ``flash_attention_simt_local_bytes``), holds each instance
against the plain version at (2, 300) causal, and times it eagerly at
(32, 2048) causal and at phase 17b's three 8192-token bf16 prefills.

The wrapper refuses a build whose tensor-core instances use local memory;
this tool launches its variants without that check, to study them.
"""
import json
import os
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

SOURCE = (build.CSRC_DIR / "flash_attention.cu").read_text()
_SPLIT = "// p0, p1 (adjacent columns"


def _ss_form(n: int, first: bool) -> str:
    """``wgmma_ss<n>`` (or ``wgmma_ss_first<n>``): S (64 x n) from shared
    memory, for key tiles of n."""
    acc = n // 2
    regs = ", ".join(f"%{i}" for i in range(acc))
    outs = ", ".join(f'"{"=" if first else "+"}f"(d[{i}])' for i in range(acc))
    name = "wgmma_ss_first" if first else "wgmma_ss"
    return (f"template <>\n__device__ __forceinline__ void {name}<{n}>("
            f"float (&d)[{acc}], uint64_t da, uint64_t db) {{\n"
            f'  asm volatile("{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{acc + 2}, '
            f'0;\\n"\n      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16'
            f'.bf16 {{{regs}}}, %{acc}, %{acc + 1}, p, 1, 1, 0, 0;\\n}}\\n"\n'
            f'      : {outs}\n      : "l"(da), "l"(db), "r"({int(not first)}));'
            "\n}\n\n")


KEYS_128 = [(_SPLIT, _ss_form(128, False) + _ss_form(128, True) + _SPLIT),
            ("constexpr int kBK = 64;         // keys per tile\n"
             "constexpr int kStages", "constexpr int kBK = 128;  // keys per "
             "tile\nconstexpr int kStages")]
CAP_128 = [('asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\\n" ::: '
            '"memory");', ""),
           ('asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\\n" ::: '
            '"memory");', ""),
           ("__launch_bounds__(kThreads, 1)\nfa_tc_kernel",
            "__launch_bounds__(512, 1)\nfa_tc_kernel")]
THREAD_WG = [("const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);",
              "const int wg = threadIdx.x / 128;")]
EXP2F = [('asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));',
          "y = exp2f(x);")]
NO_EXP = [("ex2((x - (e < 2 ? mn0 : mn1)) * kLog2e)",
           "((x - (e < 2 ? mn0 : mn1)) * kLog2e)")]
NO_LO = [("""#pragma unroll
  for (int j = 0; j < kBK / 16; ++j)
    wgmma_rs<D>(o, pl[j],
                sw128_desc(va + j * 16 * kRowBytes, kBK * kRowBytes, 1024));
""", "")]
NO_SOFTMAX = [("float& m1, float& l0, float& l1, float& a0, float& a1) {\n",
               "float& m1, float& l0, float& l1, float& a0, float& a1) {\n"
               "  a0 = a1 = 1.f;\n  if (scale != -1.f) return;\n")]
_SIMT_BOUNDS = "__launch_bounds__(kThreads)\nflash_attention_kernel("
SIMT_MIN1 = [(_SIMT_BOUNDS,
              "__launch_bounds__(kThreads, 1)\nflash_attention_kernel(")]
SIMT_MIN2 = [(_SIMT_BOUNDS,
              "__launch_bounds__(kThreads, 2)\nflash_attention_kernel(")]
SIMT_UNROLL4 = [("#pragma unroll 8\n    for (int c = 0; c < DQK; ++c) {",
                 "#pragma unroll 4\n    for (int c = 0; c < DQK; ++c) {")]
PRESETS = {
    "ablation": {"abl_base": [], "abl_no_exp": NO_EXP, "abl_no_lo": NO_LO,
                 "abl_no_softmax": NO_SOFTMAX,
                 "abl_no_softmax_no_lo": NO_SOFTMAX + NO_LO},
    # the committed source, then builds that spill: 128-key tiles (alone,
    # with the per-thread warpgroup index of the earlier form, with
    # exp2f) and 64-key tiles under a 128-register cap
    "spill": {"base": [], "keys128": KEYS_128,
              "keys128_thread_wg": KEYS_128 + THREAD_WG,
              "keys128_exp2f": KEYS_128 + EXP2F,
              "cap128": CAP_128, "cap128_thread_wg": CAP_128 + THREAD_WG},
    # the SIMT kernel: the committed source, a minimum of one and of two
    # blocks a multiprocessor in its launch bounds, and the score loop
    # unrolled by 4 instead of 8
    "simt": {"base": [], "min1": SIMT_MIN1, "min2": SIMT_MIN2,
             "unroll4": SIMT_UNROLL4, "min1_unroll4": SIMT_MIN1 + SIMT_UNROLL4}}
# phase 17b's 8192-token bf16 prefills: (name, (d, dv), BH, causal)
SIMT_17B = (("zamba2", (80, 80), 32, True), ("mla", (192, 128), 128, True),
            ("hubert", (80, 80), 16, False))


def load_variant(name: str, edits, src_dir: str):
    """Write the edited source as ``<src_dir>/b6_<name>.cu`` and build it
    with ``build.load`` (a build of the same text is reused)."""
    src = SOURCE
    for old, new in edits:
        if old not in src:
            raise ValueError(f"{name}: edit target not in the source: {old!r}")
        src = src.replace(old, new)
    with open(os.path.join(src_dir, f"b6_{name}.cu"), "w") as f:
        f.write(src)
    build.CSRC_DIR = type(build.CSRC_DIR)(src_dir)
    return build.load(f"b6_{name}")


def _eager_us(run, n: int) -> float:
    run()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n * 1e3


def _folded(batch: int, prompt: int):
    gen = torch.Generator(device="cuda").manual_seed(prompt)
    q = torch.randn(8 * batch, 5 * prompt, 128, generator=gen,
                    device="cuda").bfloat16()
    k, v = (torch.randn(8 * batch, prompt, 128, generator=gen,
                        device="cuda").bfloat16() for _ in range(2))
    kpos = torch.arange(prompt, dtype=torch.int32, device="cuda")
    return q, k, v, kpos.repeat(5), kpos


def run_one(name: str) -> dict:
    """Check and time the bound variant (``fa._lib`` replaced) in this
    process."""
    out = {}
    shapes = [(1, 8192)] if name.startswith("abl_") else \
        [(4, 64), (1, 2048), (1, 8192)]
    for batch, prompt in shapes:
        q, k, v, qpos, kpos = _folded(batch, prompt)

        def call():
            return fa.flash_attention_bhsd(q, k, v, qpos, kpos, causal=True,
                                           scale=128 ** -0.5)

        row = {}
        if not name.startswith("abl_"):
            keep = [t.clone() for t in (q, k, v)]
            guard = torch.randn(1 << 22, device="cuda")
            guard_keep = guard.clone()
            want = fa.flash_attention_bhsd_ref(q, k, v, qpos, kpos,
                                               causal=True, scale=128 ** -0.5)
            _, e = torch.frexp(want.float().abs())
            env = 1e-5 * float(want.float().abs().max()) + \
                2 * torch.ldexp(torch.ones_like(e, dtype=torch.float32), e - 8)
            errs, outside = [], 0
            for _ in range(3):
                err = (call().float() - want.float()).abs()
                outside += int((~(err <= env)).sum())
                errs.append(float(err.max()))
            row.update(max_abs_err=max(errs), outside=outside, intact=all(
                torch.equal(a, b) for a, b in zip(keep, (q, k, v)))
                and torch.equal(guard, guard_keep))
        row["eager_us"] = _eager_us(call, 10 if prompt > 64 else 100)
        out[f"prompt {prompt}"] = row
    if not name.startswith("abl_"):
        x = torch.randn(2, 300, 64, device="cuda")
        pos = torch.arange(300, dtype=torch.int32, device="cuda")
        out["simt_after_err"] = float((
            fa.flash_attention_bhsd(x, x, x, pos, pos, scale=0.125)
            - fa.flash_attention_bhsd_ref(x, x, x, pos, pos, scale=0.125))
            .abs().max())
    return out


def _simt_env(want: torch.Tensor) -> torch.Tensor:
    """B6's envelopes: float32 1e-5 of max|out|, bf16 2 bf16 ulps more."""
    w = want.float()
    env = 1e-5 * float(w.abs().max())
    if want.dtype == torch.bfloat16:
        _, e = torch.frexp(w.abs())
        env = env + 2 * torch.ldexp(torch.ones_like(w), e - 8)
    return env


def run_simt(name: str) -> dict:
    """Check and time every SIMT instance of the bound variant."""
    out = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dt, d, dv in fa.simt_instances():
        row = {}
        for BH, S, reps in ((2, 300, 0), (32, 2048, 10)):
            q, k = (torch.randn(BH, S, d, generator=gen, device="cuda",
                                dtype=dt) for _ in range(2))
            v = torch.randn(BH, S, dv, generator=gen, device="cuda", dtype=dt)
            pos = torch.arange(S, dtype=torch.int32, device="cuda")

            def call():
                return fa.flash_attention_bhsd(q, k, v, pos, pos,
                                               scale=d ** -0.5)

            if reps == 0:
                want = fa.flash_attention_bhsd_ref(q, k, v, pos, pos,
                                                   scale=d ** -0.5)
                err = (call().float() - want.float()).abs()
                row.update(max_abs_err=float(err.max()),
                           outside=int((~(err <= _simt_env(want))).sum()))
            else:
                row["eager_us_32x2048"] = _eager_us(call, reps)
        out[f"{str(dt)[6:]} ({d}, {dv})"] = row
    for arch, (d, dv), BH, causal in SIMT_17B:
        q, k = (torch.randn(BH, 8192, d, generator=gen, device="cuda",
                            dtype=torch.bfloat16) for _ in range(2))
        v = torch.randn(BH, 8192, dv, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        pos = torch.arange(8192, dtype=torch.int32, device="cuda")
        out[f"17b {arch} eager_us"] = _eager_us(
            lambda: fa.flash_attention_bhsd(q, k, v, pos, pos, causal=causal,
                                            scale=d ** -0.5), 3)
        del q, k, v
    return out


def _simt_registers(ptxas: str) -> dict:
    """ptxas's registers of each SIMT instance, by its mangled template
    arguments (``IfLi64ELi64E`` = float32 at (64, 64))."""
    return dict(re.findall(r"Function properties for \S*flash_attention_"
                           r"kernel(I\w+?E)v\S*\n[^\n]*\n[^\n]*Used (\d+) "
                           r"registers", ptxas))


def main() -> None:
    which = sys.argv[1] if len(sys.argv) > 1 else "ablation"
    todo = PRESETS[which]
    src_dir = tempfile.mkdtemp()
    if len(sys.argv) > 3 and sys.argv[2] == "--one":   # a child process
        name = sys.argv[3]
        lib = fa._bind(load_variant(name, todo[name], src_dir).lib)
        fa._lib = lambda: lib
        run = run_simt if which == "simt" else run_one
        print("RESULT " + json.dumps(run(name)), flush=True)
        return
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card {card}; variants {list(todo)}", flush=True)
    with ThreadPoolExecutor(len(todo)) as pool:
        built = list(pool.map(lambda kv: load_variant(*kv, src_dir),
                              todo.items()))
    for name, b in zip(todo, built):
        if which == "simt":
            child = subprocess.run([sys.executable, __file__, which, "--one",
                                    name], capture_output=True, text=True,
                                   timeout=600)
            line = [s for s in child.stdout.splitlines()
                    if s.startswith("RESULT ")]
            print(f"{name}: SIMT registers {_simt_registers(b.ptxas)}, local "
                  f"bytes {fa._simt_local_bytes(fa._bind(b.lib))}; "
                  + (line[0][7:] if line else f"failed ({child.returncode})"
                     f": {child.stderr[-1500:]}"), flush=True)
            continue
        regs = re.findall(r"Function properties for \S*fa_tc_kernelILi(\d+)"
                          r"EE\S*\n[^\n]*\n[^\n]*Used (\d+) registers",
                          b.ptxas)
        serialized = sorted(set(re.findall(r"\((C75\d\d)\)", b.ptxas)))
        child = subprocess.run([sys.executable, __file__, which, "--one",
                                name], capture_output=True, text=True,
                               timeout=300)
        line = [s for s in child.stdout.splitlines()
                if s.startswith("RESULT ")]
        print(f"{name}: tensor-core registers by d {dict(regs)}, local "
              f"bytes {fa._tc_local_bytes(fa._bind(b.lib))}, wgmma "
              f"serialization warnings {serialized}; "
              + (line[0][7:] if line else f"failed ({child.returncode}): "
                 f"{child.stderr[-1500:]}"), flush=True)


if __name__ == "__main__":
    main()
