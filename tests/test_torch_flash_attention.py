"""B6 on the CPU: the plain version of the port's flash-attention kernel
and its GQA fold against the reference.

The reference runs its Pallas kernel ``flash_attention_bhsd`` in interpret
mode (as ``tests/test_kernels.py`` does) and its jnp oracle
``flash_attention_ref``; the port's CPU route is
``flash_attention_bhsd_ref`` (a CPU tensor never reaches the CUDA kernel,
which ``tests/test_torch_kernels_cuda.py`` holds against this plain
version on the card).  Same numpy inputs on both sides.

Envelopes, as the reference's own kernel tests state them: float32 within
2e-5 absolute (the blocked kernel and a one-shot softmax sum in other
orders); bfloat16 within 2e-2 absolute (outputs of size ~1 rounded to
bfloat16 on both sides).
"""
import ast
import ctypes
import importlib.util
import pathlib
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_bhsd as j_fa
from repro.models.attention import attend as j_attend
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ops import flash_attention
from repro_torch.models.attention import attend

ENV = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's programs here are small: torch's intra-op threads would
    only contend with the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(rng, shapes, dtype):
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    if dtype == "bfloat16":  # round once, so both sides see the same bf16
        arrs = [np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                for a in arrs]
    return arrs


def _jax(a, dtype):
    return jnp.asarray(a, getattr(jnp, dtype))


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _np(t):
    return (t.float().numpy() if torch.is_tensor(t)
            else np.asarray(t, np.float32))


@pytest.mark.parametrize("dims", [(2, 33, 33, 16), (1, 128, 128, 32),
                                  (3, 65, 200, 64), (2, 1, 96, 16)])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 13),
                                           (False, None)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_reference_oracle_sweep(dims, causal, window, dtype):
    """The sweep of ``tests/test_kernels.py:35`` against ``ref.py:28``."""
    BH, Sq, Sk, d = dims
    rng = np.random.default_rng(Sq * 7 + Sk)
    q, k, v = _inputs(rng, [(BH, Sq, d), (BH, Sk, d), (BH, Sk, d)], dtype)
    qp = (np.arange(Sq) + (Sk - Sq)).astype(np.int32)
    kp = np.arange(Sk, dtype=np.int32)
    got = fa.flash_attention_bhsd(
        _torch(q, dtype), _torch(k, dtype), _torch(v, dtype),
        torch.from_numpy(qp), torch.from_numpy(kp), causal=causal,
        window=window, scale=d ** -0.5)
    want = jref.flash_attention_ref(
        _jax(q, dtype), _jax(k, dtype), _jax(v, dtype), jnp.asarray(qp),
        jnp.asarray(kp), causal=causal, window=window, scale=d ** -0.5)
    assert got.dtype == getattr(torch, dtype) and got.shape == q.shape
    np.testing.assert_allclose(_np(got), _np(want), atol=ENV[dtype])


@pytest.mark.parametrize("dims,causal,window,dtype", [
    ((3, 65, 200, 64), True, 13, "float32"),
    ((2, 33, 33, 16), False, None, "float32"),
    ((3, 65, 200, 64), True, None, "bfloat16"),
])
def test_plain_matches_interpreted_pallas_kernel(dims, causal, window, dtype):
    """Against the TPU kernel itself, interpreted on the CPU, with the
    block sizes of ``tests/test_kernels.py`` (so its k loop runs several
    online-softmax steps)."""
    BH, Sq, Sk, d = dims
    rng = np.random.default_rng(d)
    q, k, v = _inputs(rng, [(BH, Sq, d), (BH, Sk, d), (BH, Sk, d)], dtype)
    qp = (np.arange(Sq) + (Sk - Sq)).astype(np.int32)
    kp = np.arange(Sk, dtype=np.int32)
    got = fa.flash_attention_bhsd(
        _torch(q, dtype), _torch(k, dtype), _torch(v, dtype),
        torch.from_numpy(qp), torch.from_numpy(kp), causal=causal,
        window=window, scale=d ** -0.5)
    want = j_fa(_jax(q, dtype), _jax(k, dtype), _jax(v, dtype),
                jnp.asarray(qp), jnp.asarray(kp), causal=causal,
                window=window, scale=d ** -0.5, block_q=32, block_k=64,
                interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), atol=ENV[dtype])


def test_ring_holes_are_ignored():
    """``tests/test_kernels.py:52``: kpos == -1 slots anywhere."""
    BH, Sq, Sk, d = 2, 4, 32, 16
    q, k, v = _inputs(np.random.default_rng(3),
                      [(BH, Sq, d), (BH, Sk, d), (BH, Sk, d)], "float32")
    qp = (np.arange(Sq) + 100).astype(np.int32)
    kp = np.where(np.arange(Sk) % 3 == 0, -1, np.arange(Sk) + 90).astype(
        np.int32)
    got = fa.flash_attention_bhsd(*map(torch.from_numpy, (q, k, v, qp, kp)),
                                  causal=True, window=None, scale=0.25)
    for want in (jref.flash_attention_ref(*map(jnp.asarray, (q, k, v, qp,
                                                             kp)),
                                          causal=True, window=None,
                                          scale=0.25),
                 j_fa(*map(jnp.asarray, (q, k, v, qp, kp)), causal=True,
                      window=None, scale=0.25, block_q=4, block_k=8,
                      interpret=True)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # the holes really are skipped: filling them with garbage changes nothing
    k2, v2 = k.copy(), v.copy()
    k2[:, kp < 0] = 1e3
    v2[:, kp < 0] = -7.0
    again = fa.flash_attention_bhsd(
        *map(torch.from_numpy, (q, k2, v2, qp, kp)), causal=True,
        window=None, scale=0.25)
    assert torch.equal(again, got)


@pytest.mark.parametrize("gqa", [(8, 2), (4, 4), (6, 1)])
def test_gqa_fold_matches_model_attend(gqa):
    """``tests/test_kernels.py:70``: the fold against the reference's naive
    model attention, and against the port's."""
    H, KV = gqa
    B, S, d = 2, 45, 16
    q, k, v = _inputs(np.random.default_rng(H), [(B, S, H, d), (B, S, KV, d),
                                                 (B, S, KV, d)], "float32")
    pos = np.arange(S, dtype=np.int32)
    got = flash_attention(*map(torch.from_numpy, (q, k, v, pos, pos)),
                          causal=True, window=None, scale=0.25)
    want = j_attend(*map(jnp.asarray, (q, k, v, pos, pos)), causal=True,
                    window=None, scale=0.25, q_chunk=16, impl="naive")
    also = jops.flash_attention(*map(jnp.asarray, (q, k, v, pos, pos)),
                                causal=True, window=None, scale=0.25)
    port_naive = attend(*map(torch.from_numpy, (q, k, v, pos, pos)),
                        causal=True, window=None, scale=0.25, q_chunk=16,
                        impl="naive")
    assert got.shape == (B, S, H, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(also), atol=2e-5)
    np.testing.assert_allclose(got.numpy(), port_naive.numpy(), atol=2e-5)


@pytest.mark.parametrize("gqa,window", [((8, 2), 16), ((4, 4), 9)])
def test_gqa_sliding_window_golden(gqa, window):
    """``tests/test_kernels.py:245``: fold + sliding window."""
    H, KV = gqa
    B, S, d = 2, 40, 16
    q, k, v = _inputs(np.random.default_rng(window),
                      [(B, S, H, d), (B, S, KV, d), (B, S, KV, d)], "float32")
    pos = np.arange(S, dtype=np.int32)
    got = flash_attention(*map(torch.from_numpy, (q, k, v, pos, pos)),
                          causal=True, window=window, scale=d ** -0.5)
    want = j_attend(*map(jnp.asarray, (q, k, v, pos, pos)), causal=True,
                    window=window, scale=d ** -0.5, q_chunk=16,
                    impl="naive")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_fold_masks_by_position_not_row():
    """After the fold a row's index is not its position: with G = 3 heads
    of 5 positions, row 5 (head 1, position 0) sees one key, not six."""
    B, S, KV, G, d = 1, 5, 1, 3, 16
    q, k, v = _inputs(np.random.default_rng(0),
                      [(B, S, KV * G, d), (B, S, KV, d), (B, S, KV, d)],
                      "float32")
    pos = torch.arange(S, dtype=torch.int32)
    out = flash_attention(*map(torch.from_numpy, (q, k, v)), pos, pos,
                          causal=True, scale=0.3)
    # position 0 of every head attends to key 0 alone: out == v[0]
    for h in range(G):
        np.testing.assert_allclose(out[0, 0, h].numpy(), v[0, 0, 0],
                                   atol=1e-6)


def test_fully_masked_and_negative_query_rows_are_zero():
    q, k, v = _inputs(np.random.default_rng(1), [(2, 6, 16)] * 3, "float32")
    qp = torch.tensor([-1, 0, 1, 2, 3, 4], dtype=torch.int32)
    kp = torch.tensor([-1, -1, 5, 6, 7, 8], dtype=torch.int32)
    out = fa.flash_attention_bhsd(*map(torch.from_numpy, (q, k, v)), qp, kp,
                                  causal=False, scale=0.25)
    assert bool((out[:, 0] == 0).all())   # qpos = -1: masked (the kernel's)
    assert bool((out[:, 1:] != 0).any())
    causal = fa.flash_attention_bhsd(*map(torch.from_numpy, (q, k, v)), qp,
                                     kp, causal=True, scale=0.25)
    assert bool((causal == 0).all())      # every key is in the future


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = fa.flash_attention_bhsd.launches
    x = torch.zeros(1, 3, 40)  # a head dim the kernel has no instance for
    pos = torch.arange(3, dtype=torch.int32)
    out = fa.flash_attention_bhsd(x, x, x, pos, pos)
    assert out.shape == x.shape
    assert fa.flash_attention_bhsd.launches == before


# ----------------------------------------- the tensor-core kernel's arithmetic

EMULATED_KEY_TILE = 64      # keys per tile of the tensor-core kernel (tc::kBK)
LOG2E = np.float32(1.4426950408889634)
EX2_ULPS = 2                # ex2.approx.ftz.f32: at most 2 ulps of the result


def _bf16_envelope_outside(got, want) -> int:
    """Elements of ``got`` outside B6's bf16 envelope around ``want`` (the
    smoke's and the card tests': 2 bf16 ulps of the plain output plus 1e-5
    of its largest magnitude)."""
    g, w = got.float(), want.float()
    _, e = torch.frexp(w.abs())
    env = 1e-5 * float(w.abs().max()) + 2 * torch.ldexp(torch.ones_like(w),
                                                        e - 8)
    return int(((g - w).abs() > env).sum())


def _emulate_tc(q, k, v, qpos, kpos, *, causal, window, scale, p_mode,
                exp_mode, seed=0):
    """The tensor-core kernel's arithmetic in float32 torch ops: key tiles
    of EMULATED_KEY_TILE, scores in float32 (bf16 products are exact),
    scale, mask by position, the online softmax with the kernel's NEG_INF
    tests, and O += P V in float32 with P as the kernel feeds it:
    ``p_mode`` "split" (bf16 hi = bf16(p) plus lo = bf16(p - hi)) or
    "bf16" (one rounding); ``exp_mode`` "exp" (as the plain version) or
    "exp2" (exp2((s - m) log2 e) as ex2.approx.ftz gives it: each result
    moved by its 2-ulp error bound, the sign drawn from ``seed``, and
    results below 2^-126 flushed to zero)."""
    gen = torch.Generator().manual_seed(seed)

    def ex(x):
        if exp_mode == "exp":
            return torch.exp(x)
        y = torch.exp2(x * torch.tensor(LOG2E))
        sign = torch.randint(0, 2, y.shape, generator=gen) * 2 - 1
        y = y * (1 + sign * EX2_ULPS * 2.0 ** -23)
        return torch.where(y < 2.0 ** -126, 0.0, y)

    qf, kf, vf = q.float(), k.float(), v.float()
    BH, Sq, d = q.shape
    m = torch.full((BH, Sq, 1), fa.NEG_INF)
    l = torch.zeros(BH, Sq, 1)
    o = torch.zeros(BH, Sq, d)
    for k0 in range(0, k.shape[1], EMULATED_KEY_TILE):
        kt = kf[:, k0:k0 + EMULATED_KEY_TILE]
        vt = vf[:, k0:k0 + EMULATED_KEY_TILE]
        s = torch.einsum("bqd,bkd->bqk", qf, kt) * scale
        vis = fa._visible(qpos, kpos[k0:k0 + EMULATED_KEY_TILE], causal,
                          window)
        s = torch.where(vis[None], s, fa.NEG_INF)
        mn = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.where(m > fa.NEG_INF / 2, ex(m - mn), 0.0)
        p = torch.where(s > fa.NEG_INF / 2, ex(s - mn), 0.0)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        o = alpha * o
        hi = p.bfloat16().float()
        o = o + hi @ vt
        if p_mode == "split":
            o = o + (p - hi).bfloat16().float() @ vt
        m = mn
    return (o / torch.clamp(l, min=1e-30)).to(v.dtype)


def _folded_case(G, S, holes, seed):
    """One KV head's folded prompt: q (1, G S, 128), k/v (1, S, 128) bf16
    from numpy N(0, 1), query positions tile(arange(S), G); ring holes put
    -1 in every third key."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, n, 128)).astype(
        np.float32)).bfloat16() for n in (G * S, S, S))
    pos = torch.arange(S, dtype=torch.int32)
    kpos = (torch.where(torch.arange(S) % 3 == 0, -1, pos).to(torch.int32)
            if holes else pos)
    return q, k, v, pos.repeat(G), kpos


EMULATION_CASES = [  # (G, S, causal, window, ring holes)
    (1, 300, True, None, False), (5, 300, True, 9, False),
    (5, 300, False, None, False), (1, 2048, True, None, True),
    (5, 2048, True, None, False)]


@pytest.mark.parametrize("exp_mode", ["exp", "exp2"])
@pytest.mark.parametrize("G,S,causal,window,holes", EMULATION_CASES)
def test_split_p_emulation_stays_inside_the_bf16_envelope(G, S, causal,
                                                           window, holes,
                                                           exp_mode):
    """The tensor-core kernel's design, P split into bf16 hi + lo, against
    the plain version: no element outside B6's bf16 envelope, with the
    plain version's expf and with the kernel's ex2.approx.ftz of the
    folded argument."""
    q, k, v, qpos, kpos = _folded_case(G, S, holes, seed=G * S)
    kw = dict(causal=causal, window=window, scale=128 ** -0.5)
    want = fa.flash_attention_bhsd_ref(q, k, v, qpos, kpos, **kw)
    got = _emulate_tc(q, k, v, qpos, kpos, p_mode="split",
                      exp_mode=exp_mode, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert _bf16_envelope_outside(got, want) == 0


@pytest.mark.parametrize("G,S", [(1, 300), (5, 2048)])
def test_single_bf16_p_leaves_the_bf16_envelope(G, S):
    """Why P is split: rounded once to bf16 (the usual flash-attention
    shortcut), P moves outputs of a causal prompt out of the envelope."""
    q, k, v, qpos, kpos = _folded_case(G, S, False, seed=G * S)
    kw = dict(causal=True, window=None, scale=128 ** -0.5)
    want = fa.flash_attention_bhsd_ref(q, k, v, qpos, kpos, **kw)
    got = _emulate_tc(q, k, v, qpos, kpos, p_mode="bf16", exp_mode="exp",
                      **kw)
    assert _bf16_envelope_outside(got, want) > 1e-3 * want.numel()


def _chip_smoke(monkeypatch):
    """``chip_smoke.py`` as a module, without running it: the script
    leaves at once without a card, so the check is switched off for the
    import (the module level only imports and defines)."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: True)
        spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("causal,window", [(True, None), (True, 7),
                                           (False, None), (False, 7)])
def test_attention_work_counts_visible_pairs(causal, window, monkeypatch):
    rng = np.random.default_rng(5)
    qp = np.concatenate([np.arange(20), [-1, -1]]).astype(np.int32)
    kp = rng.permutation(np.where(np.arange(30) % 4 == 0, -1,
                                  np.arange(30))).astype(np.int32)
    vis = (kp[None] >= 0) & (qp[:, None] >= 0)
    if causal:
        vis &= kp[None] <= qp[:, None]
    if window is not None:
        vis &= kp[None] > qp[:, None] - window
    nbytes, flops = _chip_smoke(monkeypatch).attention_work(
        6, 64, qp, kp, causal=causal, window=window, itemsize=2)
    assert flops == 4 * 64 * 6 * int(vis.sum())
    assert nbytes == 2 * 6 * 64 * (2 * 22 + 2 * 30) + 4 * 52


def test_attention_work_counts_v_head_dim(monkeypatch):
    """MLA's prefill moves q/k at 192 and v and out at 128 and does
    2 (192 + 128) flops a visible pair (17b's bound); equal dims give the
    4 d of the test above."""
    pos = np.arange(10, dtype=np.int32)
    work = _chip_smoke(monkeypatch).attention_work
    nbytes, flops = work(3, 192, pos, pos, causal=True, window=None,
                         itemsize=2, dv=128)
    assert flops == 2 * (192 + 128) * 3 * 55
    assert nbytes == 2 * 3 * (192 + 128) * 20 + 4 * 20
    assert work(3, 64, pos, pos, causal=True, window=None, itemsize=2,
                dv=64) == work(3, 64, pos, pos, causal=True, window=None,
                               itemsize=2)


class _FakeLib:
    """Stands in for the built library: each C function is a callable
    that takes argtypes and restype as the wrapper binds them."""

    def __init__(self, local_bytes, simt_bytes=None):
        def fn(result):
            return type("CFunc", (), {"__call__": lambda self, *a: result(
                *a)})()
        simt = simt_bytes or {}
        self.flash_attention_bhsd_launch = fn(lambda *a: 0)
        self.flash_attention_bhsd_tc_launch = fn(lambda *a: 0)
        self.flash_attention_error_string = fn(lambda code: b"")
        self.flash_attention_tc_local_bytes = fn(local_bytes.__getitem__)
        self.flash_attention_simt_local_bytes = fn(
            lambda dtype, d, dv: simt.get((dtype, d, dv), 0))


@pytest.mark.parametrize("local_bytes,simt_bytes,refused", [
    ({64: 0, 128: 0}, None, False), ({64: 0, 128: 64}, None, True),
    ({64: -1, 128: 0}, None, True), ({64: 0, 128: 0}, {(0, 64, 64): 24}, True),
    ({64: 0, 128: 0}, {(1, 192, 128): -1}, True)])
def test_lib_refuses_a_tensor_core_build_with_local_memory(
        local_bytes, simt_bytes, refused, monkeypatch):
    """The wrapper's guard on the serving path: a build whose tensor-core
    or SIMT instances use local memory (spills), or whose use the runtime
    cannot report, never launches; the check reruns until a build
    passes."""
    fake = _FakeLib(local_bytes, simt_bytes)
    monkeypatch.setattr(build, "load", lambda name: type(
        "Built", (), {"lib": fake})())
    fa._lib.cache_clear()
    try:
        if refused:
            with pytest.raises(RuntimeError, match="uses local memory"):
                fa._lib()
            with pytest.raises(RuntimeError, match="uses local memory"):
                fa._lib()
        else:
            assert fa._lib() is fake
            assert fa._tc_local_bytes(fake) == local_bytes
            assert fa._simt_local_bytes(fake) == {
                (str(dt)[6:], d, dv): 0 for dt, d, dv in fa.simt_instances()}
    finally:
        fa._lib.cache_clear()


def test_kernel_source_matches_its_wrapper():
    """The CUDA source builds for sm_90a, has an instance for every (q/k,
    v) head-dim pair the wrapper accepts in each dtype (float32 all on
    the SIMT kernel; bf16 on the SIMT kernel but for the tensor-core
    kernel's equal dims), returns cudaGetLastError() after the launch,
    and the wrapper raises on a nonzero code and on unsupported inputs;
    bf16 at d 128 takes the tensor-core kernel (wgmma fed by TMA), bf16
    at d 80 and at 192 over 128 the SIMT kernel."""
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    src = (build.CSRC_DIR / "flash_attention.cu").read_text()
    cases = re.findall(r"FA_CASE\((float|__nv_bfloat16), (\d+), (\d+)\)",
                       src)
    simt = {t: {(int(a), int(b)) for tt, a, b in cases if tt == t}
            for t in ("float", "__nv_bfloat16")}
    assert len(cases) == sum(map(len, simt.values()))   # no duplicate
    assert simt["float"] == set(fa.SUPPORTED_HEAD_DIMS)
    tc_pairs = {(d, d) for d in fa.TC_HEAD_DIMS}
    assert simt["__nv_bfloat16"] | tc_pairs == set(fa.SUPPORTED_HEAD_DIMS)
    assert not simt["__nv_bfloat16"] & tc_pairs
    for d, dv in fa.SUPPORTED_HEAD_DIMS:
        assert fa.card_route(torch.float32, d, dv) == "simt"
        assert fa.card_route(torch.bfloat16, d, dv) == (
            "tc" if (d, dv) in tc_pairs else "simt")
    assert fa.card_route(torch.bfloat16, 80) == "simt"
    assert fa.card_route(torch.bfloat16, 192, 128) == "simt"
    assert "return static_cast<int>(cudaGetLastError());" in src
    assert "repro/kernels/flash_attention.py" in src
    # the tensor-core route: wgmma fed by TMA, a bf16 instance for each of
    # TC_HEAD_DIMS (d 128 among them), the key tile the emulation assumes
    assert "wgmma.mma_async" in src and "cp.async.bulk.tensor" in src
    tc_dims = tuple(int(x) for x in re.findall(r"TC_CASE\((\d+)\)", src))
    assert tc_dims == fa.TC_HEAD_DIMS and 128 in tc_dims
    tile = re.search(r"constexpr int kBK = (\d+);",
                     src.split("namespace tc {")[1])
    assert int(tile.group(1)) == EMULATED_KEY_TILE
    assert fa.card_route(torch.bfloat16, 128) == "tc"
    assert fa.card_route(torch.float32, 128) == "simt"
    assert fa.card_route(torch.bfloat16, 48) == "simt"
    tree = ast.parse(open(fa.__file__).read())
    raises = [ast.unparse(n) for n in ast.walk(tree)
              if isinstance(n, ast.Raise)]
    assert any("launch failed" in r for r in raises)
    assert any("no kernel for head dim" in r for r in raises)
    # the guard against spilling tensor-core builds reads the runtime
    assert "int flash_attention_tc_local_bytes(int d)" in src
    assert "localSizeBytes" in src
    assert any("uses local memory" in r for r in raises)
    # the SIMT guard asks the runtime for exactly the instances built
    local = re.findall(r"FA_LOCAL\((float|__nv_bfloat16), (\d+), (\d+)\)",
                       src)
    assert sorted(local) == sorted(cases)
    assert {(str(dt)[6:], d, dv) for dt, d, dv in fa.simt_instances()} == {
        ("float32" if t == "float" else "bfloat16", int(a), int(b))
        for t, a, b in cases}


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "int": ctypes.c_int, "float": ctypes.c_float}


@pytest.mark.parametrize("symbol", ["flash_attention_bhsd_launch",
                                    "flash_attention_bhsd_tc_launch",
                                    "flash_attention_tc_local_bytes",
                                    "flash_attention_simt_local_bytes"])
def test_ctypes_bindings_match_the_c_interface(symbol):
    """``_bind`` declares exactly the parameter types of each C entry of
    ``flash_attention.cu`` (the SIMT entry takes v's head dim ``dv`` after
    ``d``): a wrong count or width would pass garbage to the card."""
    src = (build.CSRC_DIR / "flash_attention.cu").read_text()
    m = re.search(r"int\s+" + symbol + r"\(([^)]*)\)", src)
    params = [re.sub(r"\s*\w+$", "", p.strip()) for p in
              m.group(1).split(",")]
    lib = types.SimpleNamespace(**{name: types.SimpleNamespace() for name in (
        "flash_attention_bhsd_launch", "flash_attention_bhsd_tc_launch",
        "flash_attention_error_string", "flash_attention_tc_local_bytes",
        "flash_attention_simt_local_bytes")})
    fa._bind(lib)
    assert getattr(lib, symbol).argtypes == [_C_TYPES[p] for p in params]
    assert getattr(lib, symbol).restype == ctypes.c_int
    if symbol == "flash_attention_bhsd_launch":
        assert re.sub(r"\s+", " ", m.group(1)).count("int d, int dv,") == 1
