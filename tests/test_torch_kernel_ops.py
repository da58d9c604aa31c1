"""B4, B5 and B7 (intra-chunk) on the CPU: the plain versions behind the
port's ``kernels.ops`` entry points against the reference.

The reference runs its Pallas kernels in interpret mode (as
``tests/test_kernels.py`` does) and its jnp oracles ``repro.kernels.ref``;
the port's CPU route is each kernel's plain version (a CPU tensor never
reaches a CUDA kernel; ``tests/test_torch_kernels_cuda.py`` holds the
kernels against these plain versions on the card).  Same numpy inputs on
both sides.

Envelopes:

* B4 (``prox_step``): bitwise to the reference's kernel in float32 and
  bfloat16.  Both compute ``x - gamma*g`` as one FMA (the reference's
  compiled kernel contracts it), and ``1 + gamma*lam`` of ``l2`` as one
  FMA, in float32 with one rounding to ``x``'s dtype.  Against the
  unfused oracle ``ref.prox_step_ref``: within one float32 ulp of
  ``|x| + gamma |g|`` (the oracle rounds the product once more; near
  cancellation that is many ulps of the result), plus one bf16 ulp of the
  oracle's result rounded to bfloat16 in bfloat16.
* B5 (``rmsnorm_fused``): float32 within 8 ulps of ``ref.rmsnorm_ref`` (up
  to 4 measured here): the reference's ``lax.rsqrt`` on XLA:CPU is an
  approximation within 2 ulps of ``1 / sqrt``, and it sums the row in
  another order, so bitwise equality cannot be had from an independent
  implementation.  bfloat16 within one bf16 ulp (0 measured here).
  The model-layer match: float32 1e-5, as the reference's test states.
* B7 intra-chunk: within 1e-5 of the largest |output| (the two sum the
  float32 products in other orders; the measured gap is about 1e-7).  The
  card kernel's split-TF32 arithmetic, emulated here with bit operations,
  stays inside that envelope; a single TF32 product per float32 one does
  not.
"""
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
from repro.kernels.ssd_scan import ssd_intra_chunk as j_intra
from repro.models.layers import rmsnorm as j_layer_rmsnorm
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ssd_scan import ssd_intra_chunk
from repro_torch.models.layers import rmsnorm as layer_rmsnorm

SSD_REL_ENVELOPE = 1e-5
RMS_F32_ULPS = 8


def _arrays(seed, shape, dtype, n=2):
    """``n`` standard normal arrays, rounded once to ``dtype`` so both
    packages see the same values; returned as float32 numpy."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]
    if dtype == "bfloat16":
        arrs = [np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                for a in arrs]
    return arrs


def _jax(a, dtype):
    return jnp.asarray(a, getattr(jnp, dtype))


def _torch(a, dtype):
    return torch.from_numpy(np.array(a, np.float32)).to(getattr(torch, dtype))


def _np(t):
    return (t.float().numpy() if torch.is_tensor(t)
            else np.asarray(jnp.asarray(t).astype(jnp.float32)))


def bf16_ulp(v: np.ndarray) -> np.ndarray:
    """The spacing of bfloat16 numbers at |v| (8 significant bits)."""
    _, e = np.frexp(np.abs(v).astype(np.float32))
    return np.ldexp(np.float32(1), e - 8)


def f32_ulp(v: np.ndarray) -> np.ndarray:
    return np.spacing(np.abs(v).astype(np.float32))


# ------------------------------------------------------------------ B4 ----

@pytest.mark.parametrize("shape", [(17,), (1000,), (64, 130), (3, 5, 7),
                                   (2048,)])
@pytest.mark.parametrize("kind", ["none", "l1", "l2", "box"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prox_step_sweep(shape, kind, dtype):
    """tests/test_kernels.py:19 on the port: bitwise to the reference's
    kernel, with gamma as a Python float and as a 0-d float32 tensor."""
    x, g = _arrays(7, shape, dtype)
    want = _np(jops.prox_step(_jax(x, dtype), _jax(g, dtype), 0.13,
                              kind=kind, lam=0.05))
    tx, tg = _torch(x, dtype), _torch(g, dtype)
    got = ops.prox_step(tx, tg, 0.13, kind=kind, lam=0.05)
    got_t = ops.prox_step(tx, tg, torch.tensor(0.13, dtype=torch.float32),
                          kind=kind, lam=0.05)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == shape
    np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(_np(got_t), want)
    # the unfused oracle (float32 out for either input dtype)
    oracle = np.asarray(jref.prox_step_ref(_jax(x, dtype), _jax(g, dtype),
                                           jnp.float32(0.13), kind=kind,
                                           lam=0.05), np.float32)
    if dtype == "bfloat16":
        oracle = _np(jnp.asarray(oracle, jnp.bfloat16))
    env = f32_ulp(np.abs(x) + np.float32(0.13) * np.abs(g))
    if dtype == "bfloat16":
        env = env + bf16_ulp(oracle)
    err = np.abs(_np(got) - oracle)
    assert (err <= env).all(), float((err / env).max())


@pytest.mark.parametrize("n", [1, 127, 128, 1023, 1024, 1025, 4097])
def test_prox_step_pad_tail_edges(n):
    """tests/test_kernels.py:232 on the port: any n, the shape kept,
    bitwise to the reference's kernel (interpret=True), within one ulp of
    the unfused oracle."""
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    g = np.random.default_rng(n + 5).standard_normal(n).astype(np.float32)
    want = np.asarray(jops.prox_step(jnp.asarray(x), jnp.asarray(g), 0.2,
                                     kind="l1", lam=0.03, interpret=True))
    got = ops.prox_step(torch.from_numpy(x), torch.from_numpy(g),
                        torch.tensor(0.2), kind="l1", lam=0.03)
    assert tuple(got.shape) == (n,)
    np.testing.assert_array_equal(got.numpy(), want)
    oracle = np.asarray(jref.prox_step_ref(jnp.asarray(x), jnp.asarray(g),
                                           jnp.float32(0.2), kind="l1",
                                           lam=0.03))
    env = f32_ulp(np.abs(x) + np.float32(0.2) * np.abs(g))
    assert (np.abs(got.numpy() - oracle) <= env).all()


@pytest.mark.parametrize("kind", ["l1", "l2", "box"])
def test_prox_step_tree_golden(kind):
    """tests/test_kernels.py:143 on the port: leafwise over a dict (and a
    tuple and a list), bitwise to the reference's ``prox_step_tree``."""
    w, gw = _arrays(3, (33, 17), "float32")
    b, gb = _arrays(4, (17,), "float32")
    want = jops.prox_step_tree({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                               {"w": jnp.asarray(gw), "b": jnp.asarray(gb)},
                               0.07, kind=kind, lam=0.03)
    T = torch.from_numpy
    got = ops.prox_step_tree({"w": T(w), "b": T(b)}, {"w": T(gw), "b": T(gb)},
                             0.07, kind=kind, lam=0.03)
    assert set(got) == {"w", "b"}
    for leaf in ("w", "b"):
        np.testing.assert_array_equal(got[leaf].numpy(),
                                      np.asarray(want[leaf]))
    seq = ops.prox_step_tree((T(w), [T(b)]), (T(gw), [T(gb)]), 0.07,
                             kind=kind, lam=0.03)
    assert isinstance(seq, tuple) and isinstance(seq[1], list)
    np.testing.assert_array_equal(seq[0].numpy(), np.asarray(want["w"]))
    np.testing.assert_array_equal(seq[1][0].numpy(), np.asarray(want["b"]))


def test_prox_step_holds_the_fma_forms():
    """Which form B4's parity holds against: ``x - gamma*g`` as one FMA
    (the unfused product-then-subtract differs on many elements here), and
    the ``l2`` divisor ``1 + gamma*lam`` as one FMA (this gamma, lam pair
    rounds the unfused divisor differently)."""
    x, g = _arrays(11, (4097,), "float32")
    tx, tg = torch.from_numpy(x), torch.from_numpy(g)
    gam = np.float32(0.29687762)
    lam = float(np.float32(0.47437608))
    unfused = x - gam * g
    got = ops.prox_step(tx, tg, float(gam), kind="none")
    assert (got.numpy() != unfused).sum() > 100
    np.testing.assert_array_equal(got.numpy(), np.asarray(jops.prox_step(
        jnp.asarray(x), jnp.asarray(g), float(gam), kind="none")))
    d_unfused = np.float32(1) + np.float32(gam * np.float32(lam))
    d_fma = np.float32(np.float64(gam) * np.float64(np.float32(lam)) + 1.0)
    assert d_unfused != d_fma
    got_l2 = ops.prox_step(tx, tg, float(gam), kind="l2", lam=lam)
    np.testing.assert_array_equal(got_l2.numpy(), np.asarray(jops.prox_step(
        jnp.asarray(x), jnp.asarray(g), float(gam), kind="l2", lam=lam)))


def test_prox_step_refuses_an_unknown_kind():
    x = torch.zeros(4)
    with pytest.raises(ValueError, match="unknown kind"):
        ops.prox_step(x, x, 0.1, kind="elastic")


# ------------------------------------------------------------------ B5 ----

@pytest.mark.parametrize("shape", [(7, 64), (2, 33, 128), (300, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_kernel_sweep(shape, dtype):
    """tests/test_kernels.py:120 on the port, against the oracle and the
    reference's kernel (envelopes in the module docstring)."""
    x, s = _arrays(2, shape, dtype)
    s = s.reshape(-1)[:shape[-1]] + 1.0
    if dtype == "bfloat16":
        s = _np(jnp.asarray(s, jnp.bfloat16))
    want = _np(jref.rmsnorm_ref(_jax(x, dtype), _jax(s, dtype)))
    kern = _np(jops.rmsnorm_fused(_jax(x, dtype), _jax(s, dtype)))
    got = ops.rmsnorm_fused(_torch(x, dtype), _torch(s, dtype))
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == shape
    for other in (want, kern):
        err = np.abs(_np(got) - other)
        if dtype == "float32":
            ulps = err / f32_ulp(other)
            assert ulps.max() <= RMS_F32_ULPS, ulps.max()
        else:
            ulps = err / bf16_ulp(other)
            assert ulps.max() <= 1, ulps.max()


def test_rmsnorm_kernel_matches_model_layer():
    """tests/test_kernels.py:131 on the port: float32 1e-5 against both
    packages' model layer."""
    x = _arrays(9, (4, 10, 96), "float32", n=1)[0]
    scale = np.full(96, 1.3, np.float32)
    got = ops.rmsnorm_fused(torch.from_numpy(x), torch.from_numpy(scale))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(j_layer_rmsnorm(jnp.asarray(x),
                                                jnp.asarray(scale))),
        atol=1e-5)
    np.testing.assert_allclose(
        got.numpy(), layer_rmsnorm(torch.from_numpy(x),
                                   torch.from_numpy(scale)).numpy(),
        atol=1e-5)


def test_rmsnorm_bf16_keeps_the_kernels_order():
    """In bfloat16 the kernel scales in float32 before its one cast, while
    ``models.layers.rmsnorm`` casts first: wherever the reference's kernel
    and its model layer disagree, the port's ``rmsnorm_fused`` takes the
    kernel's value."""
    x, s = _arrays(2, (7, 64), "bfloat16")
    s = _np(jnp.asarray(s[0] + 1.0, jnp.bfloat16))
    jx, js = _jax(x, "bfloat16"), _jax(s, "bfloat16")
    kern = _np(jops.rmsnorm_fused(jx, js))
    layer = _np(j_layer_rmsnorm(jx, js))
    got = _np(ops.rmsnorm_fused(_torch(x, "bfloat16"), _torch(s, "bfloat16")))
    port_layer = _np(layer_rmsnorm(_torch(x, "bfloat16"),
                                   _torch(s, "bfloat16")))
    differ = kern != layer
    assert differ.sum() > 10
    np.testing.assert_array_equal(got[differ], kern[differ])
    assert (got != port_layer).sum() > 10


# --------------------------------------------------------- B7 (intra) ----

def _ssd_chunk_inputs(seed, BC, Q, H, P, G, N):
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((BC, Q, H, P)).astype(f)
    dt = np.log1p(np.exp(rng.standard_normal((BC, Q, H)))).astype(f)
    dA = -np.log1p(np.exp(rng.standard_normal((BC, Q, H)))).astype(f)
    B = rng.standard_normal((BC, Q, G, N)).astype(f)
    C = rng.standard_normal((BC, Q, G, N)).astype(f)
    return x, dt, dA, B, C


def _close(got, want):
    got, want = _np(got), np.asarray(want, np.float32)
    env = SSD_REL_ENVELOPE * float(np.abs(want).max())
    assert np.abs(got - want).max() <= env, (np.abs(got - want).max(), env)


def test_ssd_intra_kernel_vs_ref():
    """tests/test_kernels.py:102 on the port: one chunk against the
    reference's kernel and ``ref.ssd_intra_ref``, and ``ref.ssd_intra_ref``
    of the port against the same."""
    arrs = _ssd_chunk_inputs(5, 1, 16, 1, 8, 1, 4)
    y_k, st_k = j_intra(*map(jnp.asarray, arrs))
    x, dt, dA, B, C = arrs
    y_r, st_r = jref.ssd_intra_ref(*(jnp.asarray(a) for a in (
        x[0, :, 0], dt[0, :, 0], dA[0, :, 0], B[0, :, 0], C[0, :, 0])))
    y, st = ssd_intra_chunk(*map(torch.from_numpy, arrs))
    _close(y[0, :, 0], y_r)
    _close(st[0, 0], st_r)
    _close(y, y_k)
    _close(st, st_k)
    y1, st1 = ref.ssd_intra_ref(*(torch.from_numpy(np.ascontiguousarray(a))
                                  for a in (x[0, :, 0], dt[0, :, 0],
                                            dA[0, :, 0], B[0, :, 0],
                                            C[0, :, 0])))
    _close(y1, y_r)
    _close(st1, st_r)


def test_ssd_intra_chunk_batched_groups():
    """Several chunks and heads with G < H (group h // (H / G)) against the
    reference's kernel, state laid out (N, P)."""
    arrs = _ssd_chunk_inputs(6, 3, 16, 4, 8, 2, 4)
    y_k, st_k = j_intra(*map(jnp.asarray, arrs))
    y, st = ssd_intra_chunk(*map(torch.from_numpy, arrs))
    assert tuple(y.shape) == (3, 16, 4, 8) and tuple(st.shape) == (3, 4, 4, 8)
    _close(y, y_k)
    _close(st, st_k)


def _tf32(a: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: float32 rounded to 10 mantissa bits, to
    nearest with ties away from zero (finite inputs)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tc_product(a: torch.Tensor, b: torch.Tensor, mode: str, eq: str,
                b_exact: bool = False) -> torch.Tensor:
    """``einsum(eq, a, b)`` as the tensor cores compute it from float32
    operands: ``mode`` "split" (hi = tf32(v), lo = tf32(v - hi);
    lo.hi + hi.lo + hi.hi, or lo.b + hi.b where ``b`` is exact in TF32)
    or "single" (tf32(a) . tf32(b)); products exact, sums in float32."""
    ah = _tf32(a)
    if mode == "single":
        return torch.einsum(eq, ah, _tf32(b))
    al = _tf32(a - ah)
    if b_exact:
        return torch.einsum(eq, al, b) + torch.einsum(eq, ah, b)
    bh = _tf32(b)
    bl = _tf32(b - bh)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)
            + torch.einsum(eq, ah, bh))


def _emulate_b7(x, dt, dA, B, C, mode: str):
    """B7's products on the tensor cores, one group (G = 1): C.B^T in
    split (or single) TF32, W rounded to float32 and then split, W.x and
    (B w2)^T.x with x exact in TF32 where it came from bfloat16."""
    Q = x.shape[1]
    exact = bool(torch.equal(x, x.bfloat16().float()))
    cums = torch.cumsum(dA, dim=1)                       # (BC, Q, H)
    cb = _tc_product(C[:, :, 0], B[:, :, 0], mode, "btn,bsn->bts")
    decay = cums[:, :, None, :] - cums[:, None, :, :]    # (BC, t, s, H)
    tri = torch.ones(Q, Q, dtype=torch.bool).tril()
    L = torch.exp(torch.where(tri[None, :, :, None], decay,
                              torch.full_like(decay, -1e30)))
    W = cb[..., None] * L * dt[:, None, :, :]
    y = _tc_product(W, x, mode, "btsh,bshp->bthp", b_exact=exact)
    w2 = torch.exp(cums[:, -1:, :] - cums) * dt
    A = B[:, :, 0, :, None] * w2[:, :, None, :]          # (BC, s, N, H)
    st = _tc_product(A, x, mode, "bsnh,bshp->bhnp", b_exact=exact)
    return y, st


def _ssd_rel_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_split_tf32_emulation_stays_inside_the_b7_envelope(x_dtype):
    """The card kernel's design at one chunk of mamba2-780m's shape (Q 256,
    N 128, P 64, two heads of one group), on the reference's inputs: every
    product in split TF32 with float32 sums keeps y and the state within
    1e-5 of max|out| of ``ssd_intra_chunk_ref``, for a float32 x and for a
    bfloat16 x (two products, x exact in TF32)."""
    arrs = _ssd_chunk_inputs(21, 1, 256, 2, 64, 1, 128)
    x, dt, dA, B, C = map(torch.from_numpy, arrs)
    if x_dtype == "bfloat16":
        x = x.bfloat16().float()
    y_r, st_r = ssd_intra_chunk(x, dt, dA, B, C)
    y, st = _emulate_b7(x, dt, dA, B, C, "split")
    assert _ssd_rel_err(y, y_r) <= SSD_REL_ENVELOPE
    assert _ssd_rel_err(st, st_r) <= SSD_REL_ENVELOPE


def test_single_tf32_product_leaves_the_b7_envelope():
    """Why the operands are split: one TF32 product per float32 one (the
    tensor cores' usual float32 shortcut) moves y out of the envelope on
    the same inputs."""
    arrs = _ssd_chunk_inputs(21, 1, 256, 2, 64, 1, 128)
    x, dt, dA, B, C = map(torch.from_numpy, arrs)
    y_r, _ = ssd_intra_chunk(x, dt, dA, B, C)
    y, _ = _emulate_b7(x, dt, dA, B, C, "single")
    assert _ssd_rel_err(y, y_r) > 10 * SSD_REL_ENVELOPE


def _chip_smoke(monkeypatch):
    """``chip_smoke.py`` as a module, without running it (the script leaves
    at once without a card, so the check is switched off for the import;
    the module level only imports and defines)."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: True)
        spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("x_itemsize,per_product", [(2, 2), (4, 3)])
def test_ssd_intra_work_counts_the_split_tf32_products(x_itemsize,
                                                       per_product,
                                                       monkeypatch):
    """B7's bound at mamba2-780m's layer on 8192 tokens: the bytes once,
    and the products in split TF32 (C.B^T once per (chunk, group) at
    three TF32 products, W.x and the state per cell at two for a bfloat16
    x, three for float32).  With bf16 x the bytes bound it: 63.5 us
    against 53.8 us of TF32 products."""
    smoke = _chip_smoke(monkeypatch)
    BC, Q, H, P, G, N = 32, 256, 48, 64, 1, 128
    nbytes, flops = smoke.ssd_intra_work(BC, Q, H, P, G, N, x_itemsize)
    pairs = Q * (Q + 1) // 2
    assert flops == 2 * (3 * BC * G * pairs * N + per_product * (
        BC * H * pairs * P + BC * H * Q * N * P))
    assert nbytes == (x_itemsize * BC * Q * H * P + 4 * (
        2 * BC * Q * H + 2 * BC * Q * G * N + BC * Q * H * P
        + BC * H * N * P))
    if x_itemsize == 2:
        assert (nbytes, flops) == (212_860_928, 26_628_587_520)
        assert nbytes / smoke.HBM_BYTES_PER_S > flops / smoke.TF32_OPS_PER_S


# ------------------------------------------------- the ctypes bindings ----

_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "long long": ctypes.c_longlong, "int": ctypes.c_int,
            "float": ctypes.c_float}


def _c_signature(src: str, name: str):
    """Parameter ctypes and return type of ``name`` in a CUDA source's
    plain C interface."""
    m = re.search(r"(int|long long|const char\*)\s+" + name + r"\(([^)]*)\)",
                  src)
    assert m, name
    params = [p.strip() for p in m.group(2).split(",")]
    return ([_C_TYPES[re.sub(r"\s*\w+$", "", p).strip()] for p in params],
            m.group(1))


class _Fn:
    restype = None
    argtypes = None


class _Lib:
    """Stands in for a loaded library: every symbol is a settable object."""

    def __getattr__(self, name):
        fn = _Fn()
        setattr(self, name, fn)
        return fn


@pytest.mark.parametrize("module,symbols", [
    ("prox_step", ("prox_step_launch",)),
    ("rmsnorm", ("rmsnorm_launch",)),
    ("ssd_scan", ("ssd_intra_chunk_launch",)),
])
def test_ctypes_bindings_match_the_c_interface(module, symbols, monkeypatch):
    """Each wrapper declares exactly the parameter types of its source's C
    functions (a wrong count or width would pass garbage to the card);
    checked here against the source text, with the library faked."""
    import importlib
    from repro_torch.kernels import build
    mod = importlib.import_module(f"repro_torch.kernels.{module}")
    lib = _Lib()
    monkeypatch.setattr(build, "load", lambda name: types.SimpleNamespace(
        lib=lib) if name == module else None)
    mod._lib()
    src = (build.CSRC_DIR / f"{module}.cu").read_text()
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    for sym in symbols:
        params, ret = _c_signature(src, sym)
        assert getattr(lib, sym).argtypes == params, sym
        assert getattr(lib, sym).restype == {
            "int": ctypes.c_int, "long long": ctypes.c_longlong}[ret]
    assert "return static_cast<int>(cudaGetLastError());" in src
