"""Build variants of B7's CUDA source and check or time each on the card.

    python3 tools/b7_variants.py ablation      # parts of the work left out
    python3 tools/b7_variants.py tune          # other tile choices

Each variant is ``src/repro_torch/kernels/csrc/ssd_scan.cu`` with a
preset's string edits applied (each must find its target).  All variants
are built at once by the port's own ``build.load`` (the sources in a
temporary directory, the libraries in the git-ignored build directory)
and run one process each, so a faulty variant cannot disturb the next.
For each the tool prints the instances' registers and local memory, then
one result line at the smoke's kernels-ops shapes, (a) BC 8, Q 128, H 8,
P 64, G 1, N 64, float32 x and (b) BC 32, Q 256, H 48, P 64, G 1, N 128,
bfloat16 x (``chip_smoke._ssd_inputs`` with the smoke's seeds):

* a variant named ``abl_*`` leaves out part of the work and computes a
  wrong result on purpose: it is only timed;
* any other is held against the plain version at both shapes (y and the
  state within 1e-5 of max|out|, as the card tests hold the kernel) and
  timed.

Times are eager, microseconds per launch over back-to-back launches
(CUDA events), the median of three loops.  The wrapper's check that no
instance uses local memory is bypassed, so that spilling variants can be
studied; their local bytes are printed.
"""
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import torch  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402

SOURCE = (build.CSRC_DIR / "ssd_scan.cu").read_text()
_BLOCK_SET = "  const int n_win = y_tile ? (s_end + win - 1) / win : 1;\n"

NO_EXP = [("expf(__fsub_rn(ct, cs))", "(__fsub_rn(ct, cs))")]
NO_STRIP_MMA = [("    mma3(cb[nt], ah, al, sB[(8 * nt + g) * kLdK + kk + q],\n"
                 "         sB[(8 * nt + g) * kLdK + kk + q + 4]);\n", "")]
NO_MMA = [("                                    uint32_t b0, uint32_t b1) {\n",
           "                                    uint32_t b0, uint32_t b1) {\n"
           "  d[0] += __uint_as_float(a[0] ^ a[1] ^ a[2] ^ a[3] ^ b0 ^ b1);\n"
           "  return;\n")]
NO_X_LOADS = [("    const float b0 = xval(x0, 8 * nt), b1 = xval(x1, 8 * nt);",
               "    const float b0 = static_cast<float>(nt + g), "
               "b1 = static_cast<float>(nt + q);")]
NO_W = [("  return __fmul_rn(__fmul_rn(cb, expf(__fsub_rn(ct, cs))), d);",
         "  return cb;")]
FAST_EXP = [("cb, expf(__fsub_rn(ct, cs))", "cb, __expf(__fsub_rn(ct, cs))")]
Y_ONLY = [(_BLOCK_SET, _BLOCK_SET + "  if (!y_tile) return;\n")]
STATE_ONLY = [(_BLOCK_SET, _BLOCK_SET + "  if (y_tile) return;\n")]
_KS = "\n  for (int ks = 0; ks < kTile; ks += 8) {\n    const "
UNROLL = {n: [(f"#pragma unroll{_KS}{first}",
               f"#pragma unroll {n}{_KS}{first}")
              for first in ("int lo", "float w_lo")] for n in (1, 2, 4)}
HEADS = {n: [("constexpr int kMaxHeads = 8;",
             f"constexpr int kMaxHeads = {n};")] for n in (1, 4, 12, 16)}
FILL = {n: [("constexpr int kFill = 6;", f"constexpr int kFill = {n};")]
        for n in (3, 4, 12)}
PRESETS = {
    "ablation": {"abl_base": [], "abl_no_exp": NO_EXP,
                 "abl_no_strip_mma": NO_STRIP_MMA, "abl_no_mma": NO_MMA,
                 "abl_y_only": Y_ONLY, "abl_state_only": STATE_ONLY,
                 "abl_no_x_loads": NO_X_LOADS, "abl_no_w": NO_W,
                 "abl_mma_only": NO_X_LOADS + NO_W},
    "tune": {"base": [], "heads1": HEADS[1], "heads4": HEADS[4],
             "heads16": HEADS[16], "fast_exp": FAST_EXP},
    "fill": {"base": [], "heads16_fill3": HEADS[16] + FILL[3],
             "heads12_fill4": HEADS[12] + FILL[4],
             "heads8_fill3": FILL[3], "heads8_fill12": FILL[12]},
    "unroll": {"base": [], "unroll1": UNROLL[1], "unroll2": UNROLL[2],
               "unroll4": UNROLL[4]},
}


def load_variant(name: str, edits, src_dir: str):
    """Write the edited source as ``<src_dir>/b7_<name>.cu`` and build it
    with ``build.load`` (a build of the same text is reused)."""
    src = SOURCE
    for old, new in edits:
        if old not in src:
            raise ValueError(f"{name}: edit target not in the source: {old!r}")
        src = src.replace(old, new)
    with open(os.path.join(src_dir, f"b7_{name}.cu"), "w") as f:
        f.write(src)
    build.CSRC_DIR = type(build.CSRC_DIR)(src_dir)
    return build.load(f"b7_{name}")


def _eager_us(run, n: int) -> float:
    run()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(n):
            run()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n * 1e3)
    return statistics.median(times)


def run_one(name: str) -> dict:
    """Check and time the bound variant (``ss._lib`` replaced) in this
    process."""
    import chip_smoke as smoke
    from repro_torch.configs import get_config
    mamba = get_config("mamba2-780m")
    shapes = {
        "a": ((2, 512, 8, 64, 1, 64, torch.float32), 128, 16, 200),
        "b": ((1, 8192, mamba.ssm_heads, mamba.ssm_head_dim,
               mamba.ssm_n_groups, mamba.ssm_state, torch.bfloat16),
              mamba.ssm_chunk, 17, 20)}
    out = {}
    for key, (dims, chunk, seed, n) in shapes.items():
        inp = smoke._ssd_inputs(torch.Generator().manual_seed(seed), *dims)
        kin = smoke._ssd_kernel_inputs(inp, chunk)
        row = {}
        if not name.startswith("abl_"):
            got = ss.ssd_intra_chunk(*kin)
            want = ss.ssd_intra_chunk_ref(*kin)
            rel = [float((g - w).abs().max()) / float(w.abs().max())
                   for g, w in zip(got, want)]
            row["rel_err_y_state"] = rel
            row["inside"] = all(r <= 1e-5 for r in rel)
            del got, want
        row["eager_us"] = _eager_us(lambda: ss.ssd_intra_chunk(*kin), n)
        out[key] = row
        del inp, kin
        torch.cuda.empty_cache()
    return out


def main() -> None:
    which = sys.argv[1] if len(sys.argv) > 1 else "ablation"
    todo = PRESETS[which]
    src_dir = tempfile.mkdtemp()
    if len(sys.argv) > 3 and sys.argv[2] == "--one":   # a child process
        name = sys.argv[3]
        built = load_variant(name, todo[name], src_dir)
        real_load = build.load
        build.load = lambda n: built if n == "ssd_scan" else real_load(n)
        ss._check_build = lambda: None
        print("RESULT " + json.dumps(run_one(name)), flush=True)
        return
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card {card}; variants {list(todo)}", flush=True)
    with ThreadPoolExecutor(len(todo)) as pool:
        built = list(pool.map(lambda kv: load_variant(*kv, src_dir),
                              todo.items()))
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    for name, b in zip(todo, built):
        sass = subprocess.run([tool, "-sass", str(b.path)],
                              capture_output=True, text=True).stdout
        sizes = {m.group(1): 0 for m in re.finditer(
            r"Function : \S*ssd_intra_kernelI(\S+?)EEEv", sass)}
        cur = None
        for ln in sass.splitlines():
            m = re.search(r"Function : \S*ssd_intra_kernelI(\S+?)EEEv", ln)
            if m or "Function :" in ln:
                cur = m.group(1) if m else None
            elif cur and re.search(r"/\*[0-9a-f]{4,}\*/", ln):
                sizes[cur] += 1
        print(f"{name}: SASS instructions {sizes}", flush=True)
        regs = re.findall(r"ssd_intra_kernelI(\S+?)EEEv\S*\n[^\n]*\n[^\n]*"
                          r"Used (\d+) registers", b.ptxas)
        child = subprocess.run([sys.executable, __file__, which, "--one",
                                name], capture_output=True, text=True,
                               timeout=600)
        line = [s for s in child.stdout.splitlines()
                if s.startswith("RESULT ")]
        print(f"{name}: registers {dict(regs)}, local bytes "
              f"{sorted(set(ss.local_bytes(b.ptxas).values()))}; "
              + (line[0][7:] if line else f"failed ({child.returncode}): "
                 f"{child.stderr[-1500:]}"), flush=True)


if __name__ == "__main__":
    main()
