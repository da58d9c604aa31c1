"""The port's hand-written CUDA kernels against their plain versions, on
the card.

Every test here is marked ``cuda`` and skips, naming the missing device,
where no CUDA card is present (the CPU suite): a CUDA kernel has no
interpret mode.  On the card (``python -m pytest -m cuda
tests/test_torch_kernels_cuda.py``) they build the kernels from
``src/repro_torch/kernels/csrc`` and compare.  This file imports no JAX,
so it runs on a machine that has only PyTorch.

Envelopes:

* B6 (flash attention), both routes (bf16 at d 64, 80, 128 and at q/k
  192 over v 128 on the tensor-core kernel, float32 at every pair and
  bf16 at d 48 on the SIMT kernel):
  float32 within 1e-5 of max|out|; bfloat16 within 2 bf16 ulps of the
  plain output plus that float32 envelope (the two sum in other orders,
  and a value that cancels near zero has ulps finer than the float32
  error).
* B4 (prox_step): bitwise, float32 and bfloat16 (the same FMA forms and
  one rounding on both routes).
* B5 (rmsnorm): float32 within 8 ulps of each element (the row sum runs
  in another order; ``1 / sqrt`` is correctly rounded on both routes);
  bfloat16 within one bf16 ulp, and bitwise equal on all but 1e-3 of a
  test's elements (both round once from float32; the model layer's
  order, cast and then scale, differs on about a quarter).
* B7 (SSD intra-chunk on the tensor cores in split TF32, and
  ``ssd_scan_pallas`` against ``ssd_chunked``): within 1e-5 of the largest
  |output| (float32 sums and the cumulative sum in other orders).
* B1-B3 (the fused event steps): k and clipped exact; policy ids 0-3
  bitwise; hinge/poly and group_l2 within the envelopes stated above
  their tests.
"""

import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import prox_step as px
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import ssd_scan as ss
from repro_torch.kernels.ops import flash_attention
from repro_torch.models.ssm import ssd_chunked

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the H100); torch.cuda.is_available()"
                    " is False here")
    return torch.device("cuda")


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bfloat16 numbers at |x| (8 significant bits)."""
    _, e = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def check(got, want):
    got_f, want_f = got.float(), want.float()
    err = (got_f - want_f).abs()
    env = 1e-5 * max(float(want_f.abs().max()), 1e-30)
    if want.dtype == torch.bfloat16:
        env = env + 2 * bf16_ulp(want_f)
    bad = ~(err <= env)  # NaN fails too
    assert not bool(bad.any()), (float(err.max()), int(bad.sum()))
    return float(err.max()) if err.numel() else 0.0


def _case(gen, BH, Sq, Sk, d, dtype, dev):
    q, k, v = (torch.randn(BH, n, d, generator=gen).to(dtype).to(dev)
               for n in (Sq, Sk, Sk))
    return q, k, v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [48, 64, 128])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 9)])
def test_b6_kernel_matches_plain(cuda, dtype, d, causal, window):
    gen = torch.Generator().manual_seed(d)
    for Sq, Sk in [(1, 1), (17, 17), (64, 64), (300, 300), (17, 300),
                   (1, 2048), (300, 2048), (2048, 2048)]:
        q, k, v = _case(gen, 3, Sq, Sk, d, dtype, cuda)
        qp = (torch.arange(Sq, dtype=torch.int32) + (Sk - Sq)).to(cuda)
        kp = torch.arange(Sk, dtype=torch.int32).to(cuda)
        before = fa.flash_attention_bhsd.launches
        got = fa.flash_attention_bhsd(q, k, v, qp, kp, causal=causal,
                                      window=window, scale=d ** -0.5)
        assert fa.flash_attention_bhsd.launches == before + 1
        want = fa.flash_attention_bhsd_ref(q, k, v, qp, kp, causal=causal,
                                           window=window, scale=d ** -0.5)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == q.shape
        check(got, want)


@pytest.mark.parametrize("G", [1, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b6_gqa_fold_and_ring_holes(cuda, G, dtype):
    """The fold gives each tile rows of several heads (positions
    tile(qpos, G)); ring holes put -1 anywhere in kpos."""
    gen = torch.Generator().manual_seed(G)
    B, KV, d, S = 2, 2, 64, 77
    q = torch.randn(B, S, KV * G, d, generator=gen).to(dtype).to(cuda)
    k, v = (torch.randn(B, S, KV, d, generator=gen).to(dtype).to(cuda)
            for _ in range(2))
    pos = torch.arange(S, dtype=torch.int32)
    holes = torch.where(torch.arange(S) % 3 == 0, -1, pos + 90).to(
        torch.int32)
    for qpos, kpos, window in [(pos, pos, None), (pos, pos, 9),
                               (pos + 100, holes, None)]:
        got = flash_attention(q, k, v, qpos.to(cuda), kpos.to(cuda),
                              causal=True, window=window, scale=0.125)
        want = flash_attention(q.cpu(), k.cpu(), v.cpu(), qpos, kpos,
                               causal=True, window=window, scale=0.125)
        torch.cuda.synchronize()
        check(got.cpu(), want)


def test_b6_refuses_what_it_has_no_kernel_for(cuda):
    q = torch.zeros(1, 4, 40, device=cuda)
    with pytest.raises(ValueError, match="head dim 40"):
        fa.flash_attention_bhsd(q, q, q, torch.zeros(4, dtype=torch.int32,
                                                     device=cuda),
                                torch.zeros(4, dtype=torch.int32,
                                            device=cuda))
    h = torch.zeros(1, 4, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="bfloat16 or all float32"):
        fa.flash_attention_bhsd(h, h, h, torch.zeros(4, dtype=torch.int32,
                                                     device=cuda),
                                torch.zeros(4, dtype=torch.int32,
                                            device=cuda))


NEW_PAIRS = [(80, 80), (192, 128)]   # zamba2 / hubert; MLA's prefill


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dims", NEW_PAIRS)
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 9)])
def test_b6_simt_pairs_match_plain(cuda, dtype, dims, causal, window):
    """d 80 and q/k 192 over v 128 in both dtypes: float32 on the SIMT
    route, bf16 on the tensor-core route (each launch counted on its
    route), the output (BH, Sq, dv), ring holes (kpos -1) in every other
    shape; B6's envelopes."""
    d, dv = dims
    gen = torch.Generator().manual_seed(d + dv)
    for i, (Sq, Sk) in enumerate([(1, 1), (17, 17), (64, 64), (300, 300),
                                  (17, 300), (1, 2048), (300, 2048),
                                  (2048, 2048)]):
        q, k = (torch.randn(3, n, d, generator=gen).to(dtype).to(cuda)
                for n in (Sq, Sk))
        v = torch.randn(3, Sk, dv, generator=gen).to(dtype).to(cuda)
        qp = (torch.arange(Sq, dtype=torch.int32) + (Sk - Sq)).to(cuda)
        kp = torch.arange(Sk, dtype=torch.int32)
        if i % 2:
            kp = torch.where(torch.arange(Sk) % 3 == 0, -1, kp).to(
                torch.int32)
        kp = kp.to(cuda)
        before = _counts()
        got = fa.flash_attention_bhsd(q, k, v, qp, kp, causal=causal,
                                      window=window, scale=d ** -0.5)
        after = _counts()
        route = "simt" if dtype == torch.float32 else "tc"
        assert fa.card_route(dtype, d, dv) == route
        assert (after[0] - before[0], after[1] - before[1]) == (
            (0, 1) if route == "simt" else (1, 0))
        want = fa.flash_attention_bhsd_ref(q, k, v, qp, kp, causal=causal,
                                           window=window, scale=d ** -0.5)
        torch.cuda.synchronize()
        assert got.dtype == dtype and tuple(got.shape) == (3, Sq, dv)
        check(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [1, 2])
def test_b6_fold_keeps_v_head_dim(cuda, dtype, G):
    """``kernels.ops.flash_attention`` at q/k 192 over v 128 (MLA's
    prefill, G 1) and with G 2 heads folded: one launch (float32 SIMT,
    bf16 tensor-core), the card against the CPU's plain version."""
    gen = torch.Generator().manual_seed(G)
    B, KV, S = 2, 3, 130
    q = torch.randn(B, S, KV * G, 192, generator=gen).to(dtype)
    k = torch.randn(B, S, KV, 192, generator=gen).to(dtype)
    v = torch.randn(B, S, KV, 128, generator=gen).to(dtype)
    pos = torch.arange(S, dtype=torch.int32)
    before = _counts()
    got = flash_attention(q.to(cuda), k.to(cuda), v.to(cuda), pos.to(cuda),
                          pos.to(cuda), causal=True, scale=192 ** -0.5)
    after = _counts()
    assert (after[0] - before[0], after[1] - before[1]) == (
        (0, 1) if dtype == torch.float32 else (1, 0))
    want = flash_attention(q, k, v, pos, pos, causal=True, scale=192 ** -0.5)
    torch.cuda.synchronize()
    assert tuple(got.shape) == (B, S, KV * G, 128)
    check(got.cpu(), want)


@pytest.mark.parametrize("dims", [(128, 64), (80, 64), (96, 96),
                                  (192, 192), (64, 128)])
def test_b6_refuses_an_unsupported_pair(cuda, dims):
    """A (q/k, v) head-dim pair without an instance raises on the card and
    launches nothing; it is never sent to the plain version."""
    d, dv = dims
    q = torch.zeros(1, 4, d, device=cuda, dtype=torch.bfloat16)
    v = torch.zeros(1, 4, dv, device=cuda, dtype=torch.bfloat16)
    pos = torch.zeros(4, dtype=torch.int32, device=cuda)
    before = fa.flash_attention_bhsd.launches
    with pytest.raises(ValueError, match=f"no kernel for head dim {d} "):
        fa.flash_attention_bhsd(q, q, v, pos, pos)
    assert fa.flash_attention_bhsd.launches == before


def test_b6_fully_masked_rows_are_zero(cuda):
    gen = torch.Generator().manual_seed(0)
    q, k, v = _case(gen, 2, 70, 70, 64, torch.float32, cuda)
    qp = torch.arange(70, dtype=torch.int32).to(cuda)
    kp = torch.full((70,), -1, dtype=torch.int32).to(cuda)
    got = fa.flash_attention_bhsd(q, k, v, qp, kp, causal=True, scale=0.1)
    assert bool((got == 0).all())


def _counts():
    """(tensor-core, SIMT) launches so far."""
    f = fa.flash_attention_bhsd
    return f.launches_tc, f.launches - f.launches_tc


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 128, "tc"), (torch.bfloat16, 64, "tc"),
    (torch.bfloat16, 48, "simt"), (torch.float32, 128, "simt"),
    (torch.float32, 64, "simt"), (torch.bfloat16, 80, "tc"),
    (torch.float32, 80, "simt"), (torch.bfloat16, 192, "tc"),
    (torch.float32, 192, "simt")])
def test_b6_route_by_dtype_and_head_dim(cuda, dtype, d, route):
    """bf16 at d 64, 80, 128 and at q/k 192 (over v 128) launches the
    tensor-core kernel; float32 (and bf16 at d 48) the SIMT kernel: one
    launch, counted on its route."""
    dv = 128 if d == 192 else d
    gen = torch.Generator().manual_seed(d)
    q, k = (torch.randn(2, 300, d, generator=gen).to(dtype).to(cuda)
            for _ in range(2))
    v = torch.randn(2, 300, dv, generator=gen).to(dtype).to(cuda)
    pos = torch.arange(300, dtype=torch.int32).to(cuda)
    before = _counts()
    got = fa.flash_attention_bhsd(q, k, v, pos, pos, causal=True,
                                  scale=d ** -0.5)
    after = _counts()
    assert fa.card_route(dtype, d, dv) == route
    assert (after[0] - before[0], after[1] - before[1]) == \
        ((1, 0) if route == "tc" else (0, 1))
    want = fa.flash_attention_bhsd_ref(q, k, v, pos, pos, causal=True,
                                       scale=d ** -0.5)
    torch.cuda.synchronize()
    check(got, want)


def _folded(gen, G, S, d, dev, holes=False, dv=None):
    """A folded prompt of one batch row and 2 KV heads: q (2, G S, d), k
    (2, S, d), v (2, S, dv) (dv defaults to d) with query positions
    tile(pos, G); ring holes put -1 in every third key."""
    dv = d if dv is None else dv
    q = torch.randn(2, G * S, d, generator=gen).to(torch.bfloat16).to(dev)
    k = torch.randn(2, S, d, generator=gen).to(torch.bfloat16).to(dev)
    v = torch.randn(2, S, dv, generator=gen).to(torch.bfloat16).to(dev)
    pos = torch.arange(S, dtype=torch.int32)
    kpos = torch.where(torch.arange(S) % 3 == 0, -1, pos).to(torch.int32) \
        if holes else pos
    return q, k, v, pos.repeat(G).to(dev), kpos.to(dev)


TC_PAIRS = [(128, 128), (80, 80), (192, 128)]   # the tensor-core (dqk, dv)


@pytest.mark.parametrize("dims", TC_PAIRS)
@pytest.mark.parametrize("G,S", [(5, 4096), (5, 77), (5, 200), (1, 333)])
@pytest.mark.parametrize("causal,window,holes", [
    (True, None, False), (True, 9, False), (True, None, True),
    (False, None, False)])
def test_b6_tc_folded_prompt_matches_plain(cuda, G, S, causal, window, holes,
                                           dims):
    """The tensor-core kernel at each of its (q/k, v) pairs but 64, at a
    folded long prompt (G 5, S 4096) and at Sq not a multiple of 128 (G S
    = 385, 1000, 333), where a query tile holds rows of two heads; causal
    with window 9 and with ring holes, and bidirectional; one tensor-core
    launch; unchanged envelope."""
    d, dv = dims
    gen = torch.Generator().manual_seed(G * S)
    q, k, v, qpos, kpos = _folded(gen, G, S, d, cuda, holes, dv)
    before = _counts()
    got = fa.flash_attention_bhsd(q, k, v, qpos, kpos, causal=causal,
                                  window=window, scale=d ** -0.5)
    after = _counts()
    assert (after[0] - before[0], after[1] - before[1]) == (1, 0)
    want = fa.flash_attention_bhsd_ref(q, k, v, qpos, kpos, causal=causal,
                                       window=window, scale=d ** -0.5)
    torch.cuda.synchronize()
    assert tuple(got.shape) == (2, G * S, dv)
    check(got, want)


@pytest.mark.parametrize("dims", TC_PAIRS)
def test_b6_tc_fully_masked_rows_are_zero(cuda, dims):
    """bf16 at each tensor-core pair but 64: rows with qpos -1, rows that
    see no key, and a call whose keys are all holes come out as zeros; the
    other rows do not; no keys at all (Sk 0) gives zeros too."""
    d, dv = dims
    gen = torch.Generator().manual_seed(1)
    q, k = (torch.randn(2, 300, d, generator=gen).to(torch.bfloat16).to(cuda)
            for _ in range(2))
    v = torch.randn(2, 300, dv, generator=gen).to(torch.bfloat16).to(cuda)
    qp = torch.arange(300, dtype=torch.int32)
    qp[::7] = -1
    kp = torch.arange(300, dtype=torch.int32) + 150   # rows < 150 see none
    got = fa.flash_attention_bhsd(q, k, v, qp.to(cuda), kp.to(cuda),
                                  causal=True, scale=0.1)
    torch.cuda.synchronize()
    dead = (qp < 0) | (qp < 150)
    assert bool((got[:, dead.to(cuda)] == 0).all())
    assert bool((got[:, (~dead).to(cuda)] != 0).any())
    check(got, fa.flash_attention_bhsd_ref(q, k, v, qp.to(cuda), kp.to(cuda),
                                           causal=True, scale=0.1))
    holes = torch.full((300,), -1, dtype=torch.int32, device=cuda)
    none = fa.flash_attention_bhsd(q, k, v, qp.to(cuda), holes, causal=False,
                                   scale=0.1)
    assert bool((none == 0).all())
    empty = fa.flash_attention_bhsd(q, k[:, :0].contiguous(),
                                    v[:, :0].contiguous(), qp.to(cuda),
                                    holes[:0].contiguous(), causal=False,
                                    scale=0.1)
    torch.cuda.synchronize()
    assert tuple(empty.shape) == (2, 300, dv) and bool((empty == 0).all())


def test_b6_tensor_core_kernels_do_not_spill(cuda):
    """All four tensor-core instances ((64, 64), (80, 80), (128, 128),
    (192, 128)) use no local memory, as the runtime reports it for the
    loaded build: the wrapper's own guard (``_lib`` refuses such a build)
    passes.  The builds of this design that spilled (S, the split P and O
    of 96- and 128-key tiles) ran slower, and some gave wrong outputs on
    the card."""
    assert fa._tc_local_bytes(fa._lib()) == {
        (64, 64): 0, (80, 80): 0, (128, 128): 0, (192, 128): 0}


def test_b6_tensor_core_instances_issue_wgmma_fed_by_tma(cuda):
    """Each tensor-core instance, (64, 64), (80, 80), (128, 128) and (192,
    128) by its mangled template arguments, issues warpgroup products
    (``HGMMA`` in its SASS) and TMA tile loads (``UTMALDG``): the route
    that bf16 at d 80 and at 192 over 128 now takes is the tensor-core
    one, not the SIMT kernel under another name."""
    from repro_torch.kernels import build
    funcs = _sass_functions(build.load("flash_attention").path)
    names = {tuple(map(int, m.groups())): n for n in funcs
             for m in [re.search(r"fa_tc_kernelILi(\d+)ELi(\d+)EE", n)] if m}
    assert sorted(names) == sorted(fa.TC_HEAD_DIMS), sorted(funcs)
    for pair, name in names.items():
        assert any("HGMMA" in ln for ln in funcs[name]), pair
        assert any("UTMALDG" in ln for ln in funcs[name]), pair


def test_b6_simt_kernels_do_not_spill(cuda):
    """Every SIMT instance uses no local memory either, as the runtime
    reports it (``flash_attention_simt_local_bytes``): the guard that
    ``_lib`` applies to every instance passes.  Without the kernel's
    minimum of one block a multiprocessor, ptxas held the float32 (64,
    64) instance at 64 registers and it spilled."""
    used = fa._simt_local_bytes(fa._lib())
    assert set(used) == {(str(dt)[6:], d, dv)
                         for dt, d, dv in fa.simt_instances()}
    assert len(used) == 6 and not any(used.values()), used


def test_model_prefill_on_the_card_matches_the_cpu(cuda):
    """qwen2.5-32b.reduced() in float32 with the same parameters on both
    devices: logits within 1e-4, one B6 launch per layer per prefill, and
    the same greedy tokens."""
    from repro_torch import interop
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import forward, init_params, prefill
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("qwen2.5-32b").reduced()
    assert cfg.attention_impl == "pallas"
    cpu = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = interop.model_params(interop.model_tree(cpu), cfg, device=cuda)
    toks = torch.randint(0, cfg.vocab, (2, 40),
                         generator=torch.Generator().manual_seed(1))
    lc, _ = forward(cpu, cfg, {"tokens": toks})
    before = fa.flash_attention_bhsd.launches
    lg, _ = forward(card, cfg, {"tokens": toks.to(cuda)})
    assert fa.flash_attention_bhsd.launches - before == cfg.n_layers
    assert float((lg.cpu() - lc).abs().max()) < 1e-4
    pc, _ = prefill(cpu, cfg, {"tokens": toks})
    pg, _ = prefill(card, cfg, {"tokens": toks.to(cuda)})
    assert float((pg.cpu() - pc).abs().max()) < 1e-4
    oc, _ = generate(cfg, cpu, toks, 12)
    og, _ = generate(cfg, card, toks.to(cuda), 12)
    assert torch.equal(og.cpu(), oc)


# ------------------------------------------------------- B4, B5, B7 ----

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["none", "l1", "l2", "box"])
def test_b4_kernel_matches_plain(cuda, dtype, kind):
    """Bitwise on the pad-tail sizes (vector and scalar paths), gamma as a
    Python float and as a 0-d tensor on the card, and on an unaligned
    view (the scalar path alone)."""
    gen = torch.Generator().manual_seed(len(kind))
    for n in (1, 7, 127, 128, 1023, 1024, 1025, 4097, 65536 + 3):
        x, g = (torch.randn(n, generator=gen).to(dtype).to(cuda)
                for _ in range(2))
        for gamma in (0.13, torch.tensor(0.29687762, device=cuda)):
            before = px.prox_step.launches
            got = ops.prox_step(x, g, gamma, kind=kind, lam=0.47437608)
            assert px.prox_step.launches == before + 1
            want = px.prox_step_ref(x, g, gamma, kind=kind, lam=0.47437608)
            torch.cuda.synchronize()
            assert got.dtype == dtype and got.shape == x.shape
            assert torch.equal(got, want), (n, gamma)
    got = ops.prox_step(x[1:], g[1:], 0.2, kind=kind, lam=0.03)
    assert torch.equal(got, px.prox_step_ref(x[1:], g[1:], 0.2, kind=kind,
                                             lam=0.03))


def test_b4_tree_and_refusals(cuda):
    gen = torch.Generator().manual_seed(4)
    p = {"w": torch.randn(33, 17, generator=gen).to(cuda),
         "b": [torch.randn(17, generator=gen).to(cuda)]}
    q = {"w": torch.randn(33, 17, generator=gen).to(cuda),
         "b": [torch.randn(17, generator=gen).to(cuda)]}
    before = px.prox_step.launches
    got = ops.prox_step_tree(p, q, 0.07, kind="l1", lam=0.03)
    assert px.prox_step.launches == before + 2
    assert torch.equal(got["w"], px.prox_step_ref(p["w"], q["w"], 0.07,
                                                  lam=0.03))
    assert torch.equal(got["b"][0], px.prox_step_ref(p["b"][0], q["b"][0],
                                                     0.07, lam=0.03))
    h = torch.zeros(4, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or both bfloat16"):
        ops.prox_step(h, h, 0.1)
    x = torch.zeros(4, device=cuda)
    with pytest.raises(ValueError, match="0-d float32"):
        ops.prox_step(x, x, torch.zeros(1, device=cuda))
    with pytest.raises(ValueError, match="span devices"):
        ops.prox_step(x, x, torch.tensor(0.1))


def _rms_check(got, want, tally):
    g, w = got.float(), want.float()
    err = (g - w).abs()
    if want.dtype == torch.float32:
        env = 8 * torch.finfo(torch.float32).eps * w.abs()
    else:
        env = bf16_ulp(w)
        tally[0] += int((got != want).sum())
        tally[1] += want.numel()
    assert bool((err <= env).all()), float(err.max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b5_kernel_matches_plain(cuda, dtype):
    gen = torch.Generator().manual_seed(5)
    tally = [0, 0]
    for rows, D in ((1, 64), (7, 64), (300, 256), (33, 2048), (5, 5120),
                    (3, 8192), (2, 1000)):
        x = (torch.randn(rows, D, generator=gen) * 3).to(dtype).to(cuda)
        s = (torch.randn(D, generator=gen) + 1).to(dtype).to(cuda)
        before = rn.rmsnorm.launches
        got = ops.rmsnorm_fused(x, s)
        assert rn.rmsnorm.launches == before + 1
        want = rn.rmsnorm_ref(x, s)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == x.shape
        _rms_check(got, want, tally)
    x3 = torch.randn(2, 3, 96, generator=gen).to(dtype).to(cuda)
    s3 = torch.full((96,), 1.3, device=cuda, dtype=dtype)
    _rms_check(ops.rmsnorm_fused(x3, s3), rn.rmsnorm_ref(x3, s3), tally)
    assert tally[0] <= 1e-3 * tally[1], tally
    with pytest.raises(ValueError, match="both float32 or both bfloat16"):
        ops.rmsnorm_fused(x3.to(torch.bfloat16), s3.float())


def _ssd_case(gen, dev, BC, Q, H, P, G, N, x_dtype=torch.float32):
    x = torch.randn(BC, Q, H, P, generator=gen).to(x_dtype)
    dt = torch.nn.functional.softplus(torch.randn(BC, Q, H, generator=gen))
    dA = -torch.nn.functional.softplus(torch.randn(BC, Q, H, generator=gen))
    B, C = (torch.randn(BC, Q, G, N, generator=gen) for _ in range(2))
    return tuple(t.to(dev) for t in (x, dt, dA, B, C))


def _ssd_close(got, want):
    env = 1e-5 * max(float(want.abs().max()), 1e-30)
    assert float((got.float() - want.float()).abs().max()) <= env


@pytest.mark.parametrize("dims", [(1, 16, 1, 8, 1, 4), (3, 16, 4, 8, 2, 4),
                                  (2, 17, 6, 8, 3, 4), (2, 64, 2, 16, 1, 8),
                                  (2, 100, 3, 64, 1, 64),
                                  (2, 256, 4, 64, 1, 128),
                                  (1, 256, 4, 128, 2, 128),
                                  (2, 256, 48, 64, 1, 128),
                                  (2, 128, 4, 64, 4, 64),
                                  (2, 100, 6, 64, 2, 64)])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_b7_kernel_matches_plain(cuda, dims, x_dtype):
    """(2, 256, 48, 64, 1, 128) is mamba2-780m's grouping (48 heads over
    one group) at a small batch; (2, 128, 4, 64, 4, 64) has G = H (no
    sharing); (2, 100, 6, 64, 2, 64) a ragged Q with 3 heads a group."""
    gen = torch.Generator().manual_seed(sum(dims))
    args = _ssd_case(gen, cuda, *dims, x_dtype=x_dtype)
    before = ss.ssd_intra_chunk.launches
    y, st = ss.ssd_intra_chunk(*args)
    assert ss.ssd_intra_chunk.launches == before + 1
    y_r, st_r = ss.ssd_intra_chunk_ref(*args)
    torch.cuda.synchronize()
    _ssd_close(y, y_r)
    _ssd_close(st, st_r)


@pytest.mark.parametrize("dims,offset", [
    ((16, 256, 48, 64, 1, 128), 0),   # 16 chunks: blocks of several heads
    ((1, 320, 2, 64, 1, 64), 0),      # Q past 256: the strip in windows
    ((2, 40, 4, 5, 2, 6), 0),         # P 5, N 6: element copies
    ((2, 64, 4, 64, 2, 32), 1),       # x off 16-byte alignment
    ((1, 320, 2, 100, 1, 64), 0)])    # P past 64: two passes (float32 x)
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_b7_head_slices_windows_and_element_copies(cuda, dims, offset,
                                                   x_dtype):
    """The kernel's other paths: a y block walking a slice of a group's
    heads (the launcher's choice at 16 chunks of mamba2-780m's heads on
    132 SMs), the strip in windows of 256 columns, the element-copy
    staging of rows that are not whole 16-byte chunks or not aligned, and
    a float32 x past P 64 in two column passes (with windows)."""
    gen = torch.Generator().manual_seed(sum(dims) + offset)
    x, dt, dA, B, C = _ssd_case(gen, cuda, *dims, x_dtype=x_dtype)
    if offset:
        flat = torch.zeros(x.numel() + offset, dtype=x_dtype, device=cuda)
        flat[offset:] = x.reshape(-1)
        x = flat[offset:].view(x.shape)
        assert x.is_contiguous() and x.data_ptr() % 16 != 0
    before = ss.ssd_intra_chunk.launches
    y, st = ss.ssd_intra_chunk(x, dt, dA, B, C)
    assert ss.ssd_intra_chunk.launches == before + 1
    y_r, st_r = ss.ssd_intra_chunk_ref(x, dt, dA, B, C)
    torch.cuda.synchronize()
    _ssd_close(y, y_r)
    _ssd_close(st, st_r)


def test_b7_is_deterministic(cuda):
    """The kernel has no atomics and a fixed order of sums: twenty launches
    on the same inputs give bitwise the same y and state (a race between
    the staged tiles and their readers would show as a difference), at a
    shape with several heads a block (the launcher's choice at 16 chunks)
    and one with the strip in windows."""
    for dims in ((16, 256, 48, 64, 1, 128), (1, 320, 2, 64, 1, 64)):
        gen = torch.Generator().manual_seed(sum(dims))
        args = _ssd_case(gen, cuda, *dims, x_dtype=torch.bfloat16)
        y0, st0 = ss.ssd_intra_chunk(*args)
        for _ in range(20):
            y, st = ss.ssd_intra_chunk(*args)
            assert torch.equal(y, y0) and torch.equal(st, st0)


def test_b7_instances_use_the_tensor_cores_and_no_local_memory(cuda):
    """Every instance of the kernel (four widths of P for a bfloat16 x,
    three for a float32 x, whose P past 64 runs in two column passes)
    issues tensor-core products (``HMMA`` in its SASS) and, by the ptxas
    report the build keeps, uses no local memory; the wrapper's own guard
    passes."""
    from repro_torch.kernels import build
    built = build.load("ssd_scan")
    used = ss.local_bytes(built.ptxas)
    assert len(used) == 7 and not any(used.values()), used
    funcs = _sass_functions(built.path)
    names = [n for n in funcs if "ssd_intra_kernel" in n]
    assert sorted(names) == sorted(used)
    for name in names:
        assert any("HMMA" in ln for ln in funcs[name]), name
    ss._check_build()


def test_b7_scan_pallas_matches_ssd_chunked(cuda):
    """The whole scan with the kernel against the port's oracle on the
    card, h0 included, chunk 256 over a ragged sequence."""
    gen = torch.Generator().manual_seed(7)
    Bt, S, H, P, G, N = 2, 700, 4, 64, 1, 128
    x = torch.randn(Bt, S, H, P, generator=gen).to(cuda)
    dt = torch.nn.functional.softplus(
        torch.randn(Bt, S, H, generator=gen)).to(cuda)
    A = -torch.exp(torch.randn(H, generator=gen)).to(cuda)
    B, C = (torch.randn(Bt, S, G, N, generator=gen).to(cuda)
            for _ in range(2))
    h0 = torch.randn(Bt, H, P, N, generator=gen).to(cuda)
    before = ss.ssd_intra_chunk.launches
    y, h = ops.ssd_scan_pallas(x, dt, A, B, C, chunk=256, h0=h0)
    assert ss.ssd_intra_chunk.launches == before + 1
    y2, h2 = ssd_chunked(x, dt, A, B, C, chunk=256, h0=h0)
    torch.cuda.synchronize()
    _ssd_close(y, y2)
    _ssd_close(h, h2)


def test_b7_refuses_what_it_has_no_kernel_for(cuda):
    gen = torch.Generator().manual_seed(0)
    x, dt, dA, B, C = _ssd_case(gen, cuda, 1, 16, 2, 160, 1, 4)
    with pytest.raises(ValueError, match="P=160"):
        ss.ssd_intra_chunk(x, dt, dA, B, C)
    x, dt, dA, B, C = _ssd_case(gen, cuda, 1, 16, 2, 8, 1, 4)
    with pytest.raises(ValueError, match="dt must be float32"):
        ss.ssd_intra_chunk(x, dt.double(), dA, B, C)


# ----------------------------------------- B1-B3 (the fused event steps) ----
#
# Each test runs three consecutive events of a kernel and of its plain
# version from one state whose k and tau sit on the window edges.  Exact:
# k, clipped.  Bitwise for policy ids 0-3: gamma, total, cumbuf, and the
# vectors (B1's x_new under every prox but group_l2; B2's x_new; B3's x_new
# and delta_new).  Envelopes: hinge/poly gamma within GAMMA_ULPS ulps
# (powf against torch.pow); the vectors of ids 4-5 and group_l2 within
# X_REL of max|x| (a gamma an ulp away; the norm summed in another order).
# H 2, 64 and 256 stage the cumbuf row in shared memory, 4096 takes the
# slot alone (kRowCap = 1024); d 1, 127 and 4097 take the scalar path, 784
# the float4 one, and an offset view of a row the scalar one.

GAMMA_ULPS = 4
X_REL = 1e-5
FUSED_PROXES = (("none", {}), ("l1", dict(lam=1e-2)), ("l2", dict(lam=1e-2)),
                ("elastic_net", dict(lam1=1e-2, lam2=1e-2)),
                ("box", dict(lo=-0.5, hi=0.5)), ("group_l2", dict(lam=1.0)))


def _event_case(seed, B, d, H, dev, offset=0):
    """Policy ids cycling 0-5, k and tau on the window edges, four (B, d)
    vectors (x, g or xc, xw, delta) and agg alternating 0/1, on the card.
    With ``offset`` the vectors are views that start ``offset`` floats into
    their storage (contiguous, not 16-byte aligned)."""
    from repro_torch.core.stepsize import StepsizeState
    from repro_torch.sweep.policies import PolicyParams
    rng = np.random.default_rng(seed)
    k = np.array([0, 1, H - 1, H, H + 5, 3 * H + 7])[rng.integers(0, 6, B)]
    tau = np.where(rng.random(B) < 0.5,
                   np.array([0, 1, H - 1, H, H + 5, 2 * H + 3])[
                       rng.integers(0, 6, B)],
                   rng.integers(0, H + 6, B))
    cum = np.cumsum(rng.random((B, H)), axis=1)
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    params = PolicyParams(torch.tensor(np.arange(B) % 6, **i32),
                          torch.tensor(rng.random(B) + 0.5, **f32),
                          torch.tensor(rng.random(B) * 0.9 + 0.05, **f32),
                          torch.tensor(rng.random(B) * 5, **f32))
    state = StepsizeState(torch.tensor(k, **i32),
                          torch.tensor(cum[:, -1] + 1.0, **f32),
                          torch.tensor(cum, **f32),
                          torch.tensor(rng.integers(0, 3, B), **i32))

    def vector():
        flat = torch.tensor(rng.normal(size=B * d + offset), **f32)
        return flat[offset:].view(B, d)

    agg = torch.tensor(np.arange(B) % 2, **f32)
    return params, state, torch.tensor(tau, **i32), \
        [vector() for _ in range(4)], agg


def _clone(state):
    return type(state)(*(t.clone() for t in state))


def _check_event(pid, got, want, bitwise_vectors=True):
    (ga, sa, *va), (gb, sb, *vb) = got, want
    assert torch.equal(sa.k, sb.k) and torch.equal(sa.clipped, sb.clipped)
    exact = pid <= 3
    for a, b in ((ga, gb), (sa.total, sb.total), (sa.cumbuf, sb.cumbuf)):
        assert torch.equal(a[exact], b[exact])
    dg = (ga - gb).abs()[~exact]
    ulp = torch.finfo(torch.float32).eps * gb.abs()[~exact]
    assert not bool((~(dg <= GAMMA_ULPS * ulp)).any()), float(dg.max())
    for a, b in zip(va, vb):
        if bitwise_vectors:
            assert torch.equal(a[exact], b[exact])
        err = (a - b).abs()
        env = X_REL * max(1.0, float(b.abs().max()))
        assert not bool((~(err <= env)).any()), float(err.max())


def _b1_events(params, state, tau, x, g, prox, dev):
    from repro_torch.kernels import fused_step as fs
    before = fs.fused_policy_prox_step.launches
    s1, s2 = _clone(state), _clone(state)
    x1 = x2 = x
    for e in range(3):
        ga, s1, x1 = fs.fused_policy_prox_step(params, prox, s1, tau, x1, g,
                                               bool(e % 2))
        gb, s2, x2 = fs.fused_policy_prox_step_ref(params, prox, s2, tau, x2,
                                                   g, bool(e % 2))
    torch.cuda.synchronize()
    assert fs.fused_policy_prox_step.launches == before + 3
    assert x1.is_cuda and x1.data_ptr() % 16 == 0
    return (ga, s1, x1), (gb, s2, x2)


def _b1_check(dev, B, d, H, seed, offset=0):
    from repro_torch.core.prox import make_prox
    for name, kw in FUSED_PROXES:
        params, state, tau, (x, g, _, _), _ = _event_case(seed, B, d, H, dev,
                                                          offset)
        got, want = _b1_events(params, state, tau, x, g,
                               make_prox(name, **kw), dev)
        _check_event(params.policy_id, got, want, name != "group_l2")


@pytest.mark.parametrize("H", [2, 64, 256, 4096])
@pytest.mark.parametrize("d", [1, 127, 784, 4097])
def test_b1_kernel_matches_plain(cuda, d, H):
    """Every prox kind, 12 cells (ids 0-5 twice)."""
    _b1_check(cuda, 12, d, H, seed=d * 7 + H)


def test_b1_kernel_matches_plain_at_the_main_path_shape(cuda):
    """96 cells x 784, H = 256 (mnist-96's PIAG path), every prox kind."""
    _b1_check(cuda, 96, 784, 256, seed=1)


def test_b1_scalar_path_on_unaligned_rows(cuda):
    """Rows that start off a 16-byte boundary take the kernel's scalar
    path, never the plain version: a column slice at an odd offset (one
    cell) and an offset view of 24 cells, at d = 784."""
    from repro_torch.core.prox import make_prox
    _b1_check(cuda, 24, 784, 256, seed=2, offset=1)
    params, state, tau, (x, g, _, _), _ = _event_case(3, 1, 784, 64, cuda)
    wide = torch.randn(1, 785, generator=torch.Generator().manual_seed(3))
    x = wide.to(cuda)[:, 1:]
    assert x.is_contiguous() and x.data_ptr() % 16 == 4
    got, want = _b1_events(params, state, tau, x, g,
                           make_prox("l1", lam=1e-2), cuda)
    _check_event(params.policy_id, got, want)


def _fed_events(kind, params, state, tau, vecs, agg, scale=0.1):
    from repro_torch.kernels import fused_step as fs
    fn = getattr(fs, f"fused_policy_{kind}_step")
    ref = getattr(fs, f"fused_policy_{kind}_step_ref")
    x, xc, xw, delta = vecs
    before = fn.launches
    s1, s2 = _clone(state), _clone(state)
    xa = xb = x
    da = db = delta
    for e in range(3):
        if kind == "mix":
            got = fn(params, s1, tau, xa, xc, bool(e % 2))
            want = ref(params, s2, tau, xb, xc, bool(e % 2))
        else:
            got = fn(params, s1, tau, xa, xc, xw, da, agg, scale,
                     bool(e % 2))
            want = ref(params, s2, tau, xb, xc, xw, db, agg, scale,
                       bool(e % 2))
            da, db = got[3], want[3]
        s1, s2, xa, xb = got[1], want[1], got[2], want[2]
    torch.cuda.synchronize()
    assert fn.launches == before + 3
    _check_event(params.policy_id, got, want)


@pytest.mark.parametrize("H", [2, 64, 256, 4096])
@pytest.mark.parametrize("d", [1, 127, 784, 4097])
def test_b3_kernel_matches_plain(cuda, d, H):
    """12 cells, agg 0 on half and 1 on the other half."""
    params, state, tau, vecs, agg = _event_case(d * 5 + H, 12, d, H, cuda)
    assert set(agg.tolist()) == {0.0, 1.0}
    _fed_events("buff", params, state, tau, vecs, agg)


@pytest.mark.parametrize("agg_value", [None, 0.0, 1.0])
def test_b3_kernel_matches_plain_at_the_main_path_shape(cuda, agg_value):
    """24 cells x 784, H = 64 (mnist-fed-24's FedBuff path), agg mixed,
    all 0 and all 1; eta / |R| = 0.4 / 4."""
    params, state, tau, vecs, agg = _event_case(4, 24, 784, 64, cuda)
    if agg_value is not None:
        agg = torch.full_like(agg, agg_value)
    _fed_events("buff", params, state, tau, vecs, agg, scale=0.4 / 4)


def test_b3_scalar_path_on_unaligned_rows(cuda):
    """An offset view of 24 cells at d = 784, and a column slice at an odd
    offset of one cell: the kernel's scalar path."""
    params, state, tau, vecs, agg = _event_case(5, 24, 784, 64, cuda,
                                                offset=3)
    _fed_events("buff", params, state, tau, vecs, agg)
    params, state, tau, vecs, agg = _event_case(6, 1, 784, 64, cuda)
    wide = torch.randn(1, 785, generator=torch.Generator().manual_seed(6))
    vecs[3] = wide.to(cuda)[:, 1:]
    _fed_events("buff", params, state, tau, vecs, torch.ones_like(agg))


@pytest.mark.parametrize("H", [2, 64, 256, 4096])
@pytest.mark.parametrize("d", [1, 127, 784, 4097])
def test_b2_kernel_matches_plain(cuda, d, H):
    """12 cells; d 784 takes the float4 instance, d 1, 127, 4097 the
    scalar one."""
    params, state, tau, vecs, agg = _event_case(d * 3 + H, 12, d, H, cuda)
    _fed_events("mix", params, state, tau, vecs, agg)


def test_b2_kernel_matches_plain_at_the_main_path_shape(cuda):
    """24 cells x 784, H = 256 (mnist-fed-24's FedAsync path)."""
    params, state, tau, vecs, agg = _event_case(7, 24, 784, 256, cuda)
    _fed_events("mix", params, state, tau, vecs, agg)


def test_b2_scalar_path_on_unaligned_rows(cuda):
    """An offset view of 24 cells at d = 784, and a column slice at an odd
    offset of one cell: the kernel's scalar instance."""
    params, state, tau, vecs, agg = _event_case(9, 24, 784, 256, cuda,
                                                offset=1)
    _fed_events("mix", params, state, tau, vecs, agg)
    params, state, tau, vecs, agg = _event_case(10, 1, 784, 256, cuda)
    wide = torch.randn(1, 785, generator=torch.Generator().manual_seed(10))
    vecs[1] = wide.to(cuda)[:, 1:]
    _fed_events("mix", params, state, tau, vecs, agg)


def test_b1_b2_b3_count_launches_and_refuse_bad_inputs(cuda):
    """Each wrapper counts one launch per call on the card and none on the
    CPU; the floor kernel counts nothing; a bad input raises before any
    launch, and CPU tensors beside card ones raise."""
    from repro_torch.core.prox import make_prox
    from repro_torch.kernels import fused_step as fs
    params, state, tau, (x, g, xw, delta), agg = _event_case(8, 6, 33, 8,
                                                             cuda)
    wrappers = (fs.fused_policy_prox_step, fs.fused_policy_mix_step,
                fs.fused_policy_buff_step)
    prox = make_prox("l1", lam=1e-2)
    calls = (lambda p, s, t, a, b: fs.fused_policy_prox_step(
                 p, prox, s, t, a, b),
             lambda p, s, t, a, b: fs.fused_policy_mix_step(p, s, t, a, b),
             lambda p, s, t, a, b: fs.fused_policy_buff_step(
                 p, s, t, a, b, xw.to(a.device), delta.to(a.device),
                 agg.to(a.device), 0.1))
    for fn, call in zip(wrappers, calls):
        before = [w.launches for w in wrappers]
        call(params, _clone(state), tau, x, g)
        cpu = type(params)(*(t.cpu() for t in params))
        call(cpu, type(state)(*(t.cpu() for t in state)), tau.cpu(),
             x.cpu(), g.cpu())
        fs._launch_floor(6)
        torch.cuda.synchronize()
        assert [w.launches for w in wrappers] == [
            n + (w is fn) for n, w in zip(before, wrappers)]
        with pytest.raises(ValueError, match="must be a contiguous"):
            call(params, _clone(state), tau, x.t().contiguous().t(), g)
        with pytest.raises(ValueError, match="span devices"):
            call(params, _clone(state), tau.cpu(), x, g)
        assert [w.launches for w in wrappers] == [
            n + (w is fn) for n, w in zip(before, wrappers)]


def _sass_functions(path):
    """``{function name: [instruction lines]}`` of a built library, as
    ``cuobjdump -sass`` prints them (cuobjdump beside nvcc)."""
    import os
    import subprocess
    from repro_torch.kernels import build
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    out = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                         text=True, check=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name and re.search(r"/\*[0-9a-f]{4}\*/", line):
            funcs[name].append(line)
    return funcs


def _loads_before_the_first_barrier(funcs, kernel, vec4):
    """The global loads (``LDG``) of B1's, B2's or B3's ``vec4`` instance
    that come before its first ``BAR.SYNC``."""
    tag = f"fused_policy_{kernel}_kernelILb{int(vec4)}E"
    names = [n for n in funcs if tag in n]
    assert len(names) == 1, (tag, sorted(funcs))
    code = funcs[names[0]]
    first_bar = next(i for i, ln in enumerate(code) if "BAR.SYNC" in ln)
    return [ln for ln in code[:first_bar] if re.search(r"\bLDG\.", ln)]


@pytest.mark.parametrize("kernel,vectors", [("prox", 2), ("mix", 2),
                                            ("buff", 4)])
@pytest.mark.parametrize("vec4", [True, False])
def test_b1_b3_load_every_vector_before_the_first_barrier(
        cuda, kernel, vectors, vec4):
    """The compiled redesign makes one memory trip: in the instance's SASS
    every load of the first chunk of each vector (4 float4 or 16 floats a
    thread) comes before the first barrier.  The float4 instance's vector
    loads are its 128-bit ones; its other loads (the cell's scalars, the
    far slot, the row staged in shared memory, B3's agg) are the same code
    in the scalar instance, which must hold them and all 16 floats of each
    vector before its barrier, so one vector load moved past it fails."""
    from repro_torch.kernels import build
    funcs = _sass_functions(build.load("fused_step").path)
    wide_build = _loads_before_the_first_barrier(funcs, kernel, True)
    wide = [ln for ln in wide_build if ".128" in ln]
    others = len(wide_build) - len(wide)
    if vec4:
        assert len(wide) >= vectors * 4, (len(wide), others)
    else:
        loads = _loads_before_the_first_barrier(funcs, kernel, False)
        assert not [ln for ln in loads if ".128" in ln]
        assert len(loads) >= vectors * 16 + others, (len(loads), others)


# -------------------------------------------- Async-BCD and telemetry ----
#
# Async-BCD runs B1 on the (B, ceil(d/m)) block rows it gathers from each
# cell's iterate: db 40 (m 20 on d 784, the main path) takes the float4
# instance, db 5 (m 7 on d 30) the scalar one.  The checks of the B1 tests
# above hold.  On the card the engines are bitwise (the kernel computes
# the plain version's operations, each rounded once), and telemetry is
# neutral: its accumulator feeds no solver value.

def _gathered_rows(seed, B, m, db, dev):
    """(B, db) rows gathered from a (B, m, db) tensor at random blocks,
    as ``bcd_scan`` gathers them."""
    gen = torch.Generator().manual_seed(seed)
    full = torch.randn(B, m, db, generator=gen).to(dev)
    j = torch.randint(0, m, (B,), generator=gen).to(dev)
    return full[torch.arange(B, device=dev), j]


@pytest.mark.parametrize("H", [64, 256])
@pytest.mark.parametrize("m, db", [(20, 40), (7, 5)])
def test_b1_on_gathered_bcd_block_rows(cuda, m, db, H):
    """96 cells of block rows, every prox kind, three events."""
    from repro_torch.core.prox import make_prox
    for i, (name, kw) in enumerate(FUSED_PROXES):
        params, state, tau, _, _ = _event_case(db + H + i, 96, db, H, cuda)
        x = _gathered_rows(2 * i, 96, m, db, cuda)
        g = _gathered_rows(2 * i + 1, 96, m, db, cuda)
        assert x.is_contiguous() and (x.data_ptr() % 16 == 0)
        got, want = _b1_events(params, state, tau, x, g,
                               make_prox(name, **kw), cuda)
        _check_event(params.policy_id, got, want, name != "group_l2")


def _bcd_spec(**ex):
    from repro_torch import api
    return api.ExperimentSpec(
        problem=api.ProblemSpec(kind="logreg", params=dict(
            n_samples=4000, dim=784, sparse_like=False, lam1=1e-3,
            lam2=1e-4)),
        solver=api.SolverSpec(name="bcd", horizon="auto", m=20),
        topology=api.TopologySpec(kind="standard", n_workers=(10,)),
        policies=api.PolicyGridSpec(names=("adaptive1", "adaptive2", "fixed",
                                           "naive", "hinge", "poly"),
                                    seeds=(0, 1)),
        execution=api.ExecutionSpec(**{"backend": "batched",
                                       "record_every": 10, **ex}),
        n_events=200)


def test_bcd_fused_is_bitwise_scan_on_the_card(cuda):
    """``api.run(solver="bcd")`` on the card: the fused engine (one B1
    launch per event per bucket, no B2 or B3) is bitwise the scan engine
    on every leaf; ragged buckets too."""
    from repro_torch.kernels import fused_step as fs
    wrappers = (fs.fused_policy_prox_step, fs.fused_policy_mix_step,
                fs.fused_policy_buff_step)
    for n_workers in ((10,), (3, 4)):
        from repro_torch import api
        spec = _bcd_spec().replace(topology=api.TopologySpec(
            kind="standard", n_workers=n_workers))
        before = [w.launches for w in wrappers]
        fused = api.run(spec)
        n_buckets = len(fused.grid.buckets())
        assert [w.launches - b for w, b in zip(wrappers, before)] == \
            [200 * n_buckets, 0, 0]
        scan = api.run(spec.replace(execution=api.ExecutionSpec(
            backend="batched", record_every=10, engine="scan")))
        assert fs.fused_policy_prox_step.launches == \
            before[0] + 200 * n_buckets
        for f in ("x", "objective", "gammas", "taus", "blocks", "clipped"):
            assert torch.equal(getattr(fused.raw, f), getattr(scan.raw, f)), f
        assert bool(torch.isfinite(fused.objective).all())
        assert int(fused.clipped.sum()) == 0


@pytest.mark.parametrize("solver", ["piag", "bcd"])
def test_telemetry_is_neutral_on_the_card(cuda, solver):
    from repro_torch import api
    spec = _bcd_spec().replace(solver=api.SolverSpec(
        name=solver, horizon="auto", m=20))
    off = api.run(spec)
    on = api.run(spec.replace(execution=api.ExecutionSpec(
        backend="batched", record_every=10, telemetry=True)))
    for f in off.raw._fields:
        if f in ("telemetry", "faults"):
            continue
        assert torch.equal(getattr(off.raw, f), getattr(on.raw, f)), f
    tel = on.raw.telemetry
    assert tel.hist.is_cuda
    assert torch.all(tel.hist.sum(dim=1) == 200)
    # the accumulator sees every event, the recorded rows every tenth
    assert bool((tel.tau_max >= off.raw.taus.max(dim=1).values).all())
    assert on.telemetry.hist_source == "accumulator"
    assert sum(on.telemetry.delay_hist) == on.n_cells * 200


def test_piag_fused_off_is_absent_on_the_card(cuda):
    """The op-trace contracts of ``repro_torch.staticcheck`` for PIAG under
    ``engine="fused"`` on the card: faults off (None, disabled, left out)
    and telemetry off give one op trace, and that trace holds exactly one
    B1 launch an event -- at scan level and in the batched program."""
    from repro_torch.staticcheck import contracts
    pb = contracts.Problem(n_samples=40, dim=8, n_workers=4, n_events=12)
    checks = (contracts.verify_scan_level(("piag",), "cuda", pb)
              + contracts.verify_program_level(("piag",), ("batched",),
                                               "cuda", pb))
    failed = [c for c in checks if not c.ok]
    assert not failed, "\n".join(f"{c.name}: {c.detail[:2000]}"
                                 for c in failed)
    launches = [c.launches for c in checks if c.name.endswith("launches")]
    assert launches == [{"fused_policy_prox_step": 12}] * 2
    names = {c.name for c in checks}
    assert {"scan/piag/explicit-none-is-omitted",
            "scan/piag/disabled-faults-are-none",
            "batched/piag/disabled-faults-are-none"} <= names
