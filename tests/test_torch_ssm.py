"""B7 and its model-side oracle on the CPU: the port's
``kernels.ops.ssd_scan_pallas`` (the intra-chunk kernel's plain version
plus the host cross-chunk combine) and ``models.ssm`` against the
reference.

The reference runs ``repro.kernels.ops.ssd_scan_pallas`` with its Pallas
kernel in interpret mode (as ``tests/test_kernels.py`` does), and its jnp
``repro.models.ssm``.  Same numpy inputs on both sides; each reference
call is made once per module (a fixture), since an interpret-mode scan
takes a second or two.

Envelope: y and the final state within 1e-5 of their largest magnitude
(the reference's own kernel-vs-oracle gap is about 1e-7 of max|y|; the
two packages sum the float32 products and the cumulative decay in other
orders).  The recurrence checks keep ``tests/test_models.py``'s 3e-4
absolute.

The Mamba2 mixer (``_causal_conv``, ``mamba2_block``) is held against the
reference's on its own parameters (carried as float32 numpy): float32
outputs and states within 1e-5 of their largest magnitude, bfloat16
``_causal_conv`` within one bfloat16 ulp of it (the taps are summed in
the reference's order; XLA may keep the chain in float32).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import ssm as jssm
from repro.models.config import ModelConfig as JConfig
from repro.models.ssm import ssd_chunked as j_chunked
from repro.models.ssm import ssd_recurrent_step as j_step
from repro_torch.kernels import ops
from repro_torch.models import ModelConfig, ssm
from repro_torch.models.ssm import ssd_chunked, ssd_recurrent_step

REL_ENVELOPE = 1e-5
SEQ = ("x", "dt", "B", "C")           # the inputs with a sequence axis
SWEEP = [(2, 40, 4, 8, 2, 16), (1, 64, 2, 16, 1, 8), (2, 17, 6, 8, 3, 4)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's programs here are tiny: torch's intra-op threads would
    only contend with the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, Bt, S, H, P, G, N, h0=False):
    rng = np.random.default_rng(seed)
    f = np.float32
    out = dict(
        x=rng.standard_normal((Bt, S, H, P)).astype(f),
        dt=np.log1p(np.exp(rng.standard_normal((Bt, S, H)))).astype(f),
        A=(-np.exp(rng.standard_normal(H))).astype(f),
        B=rng.standard_normal((Bt, S, G, N)).astype(f),
        C=rng.standard_normal((Bt, S, G, N)).astype(f))
    if h0:
        out["h0"] = rng.standard_normal((Bt, H, P, N)).astype(f)
    return out


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _t(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


def _close(got, want, env=REL_ENVELOPE):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    tol = env * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol, (err, tol)


@pytest.fixture(scope="module")
def sweep_ref():
    """The reference's kernel path and oracle on each sweep case."""
    out = {}
    for dims in SWEEP:
        inp = _j(_inputs(sum(dims), *dims))
        out[dims] = (jops.ssd_scan_pallas(**inp, chunk=16),
                     j_chunked(**inp, chunk=16))
    return out


@pytest.mark.parametrize("dims", SWEEP)
def test_ssd_kernel_sweep(dims, sweep_ref):
    """tests/test_kernels.py:88 on the port: ``ssd_scan_pallas`` and
    ``ssd_chunked`` of the port against the reference's kernel path and
    oracle, and against each other."""
    (yk, hk), (yc, hc) = sweep_ref[dims]
    inp = _t(_inputs(sum(dims), *dims))
    y1, h1 = ops.ssd_scan_pallas(**inp, chunk=16)
    y2, h2 = ssd_chunked(**inp, chunk=16)
    for y, h in ((y1, h1), (y2, h2)):
        assert y.dtype == torch.float32 and h.dtype == torch.float32
        for yw, hw in ((yk, hk), (yc, hc)):
            _close(y, yw)
            _close(h, hw)
    _close(y1, y2.numpy())
    _close(h1, h2.numpy())


@pytest.mark.parametrize("chunk", [5, 8, 25])
def test_ssd_chunked_equals_recurrence(chunk):
    """tests/test_models.py:39 on the port: the chunked scan equals the
    step-by-step recurrence (3e-4, as there), and each matches the
    reference's."""
    dims = (2, 25, 4, 8, 2, 16)
    raw = _inputs(chunk, *dims)
    inp = _t(raw)
    y_c, hf = ssd_chunked(**inp, chunk=chunk)
    Bt, S, H, P, G, N = dims
    h = torch.zeros(Bt, H, P, N)
    jh = jnp.zeros((Bt, H, P, N))
    j_step_jit = jax.jit(j_step)
    ys = []
    for t in range(S):
        args = (inp["x"][:, t], inp["dt"][:, t], inp["A"], inp["B"][:, t],
                inp["C"][:, t])
        y_t, h = ssd_recurrent_step(*args, h)
        jy_t, jh = j_step_jit(*(jnp.asarray(a.numpy()) for a in args), jh)
        _close(y_t, jy_t)
        ys.append(y_t)
    np.testing.assert_allclose(y_c.numpy(), torch.stack(ys, 1).numpy(),
                               atol=3e-4)
    np.testing.assert_allclose(hf.numpy(), h.numpy(), atol=3e-4)
    _close(h, jh)
    yj, hj = j_chunked(**_j(raw), chunk=chunk)
    _close(y_c, yj)
    _close(hf, hj)


@pytest.fixture(scope="module")
def h0_ref():
    """The reference's h0 golden: the full pass, its oracle, and the two
    halves chained through the carried state."""
    inp = _j(_inputs(3, 2, 32, 2, 8, 1, 4, h0=True))
    full = jops.ssd_scan_pallas(**inp, chunk=8)
    oracle = j_chunked(**inp, chunk=8)
    half = 16
    first = {k: v[:, :half] for k, v in inp.items() if k in SEQ}
    second = {k: v[:, half:] for k, v in inp.items() if k in SEQ}
    ya, ha = jops.ssd_scan_pallas(**first, A=inp["A"], chunk=8, h0=inp["h0"])
    yb, hb = jops.ssd_scan_pallas(**second, A=inp["A"], chunk=8, h0=ha)
    return full, oracle, (jnp.concatenate([ya, yb], axis=1), hb)


def test_ssd_kernel_with_initial_state_golden(h0_ref):
    """tests/test_kernels.py:157 on the port: the h0 carry-in, and two
    halves chained through the carried state equal one pass."""
    inp = _t(_inputs(3, 2, 32, 2, 8, 1, 4, h0=True))
    y1, hf1 = ops.ssd_scan_pallas(**inp, chunk=8)
    y2, hf2 = ssd_chunked(**inp, chunk=8)
    half = 16
    first = {k: v[:, :half] for k, v in inp.items() if k in SEQ}
    second = {k: v[:, half:] for k, v in inp.items() if k in SEQ}
    ya, ha = ops.ssd_scan_pallas(**first, A=inp["A"], chunk=8, h0=inp["h0"])
    yb, hb = ops.ssd_scan_pallas(**second, A=inp["A"], chunk=8, h0=ha)
    y_chain = torch.cat([ya, yb], dim=1)
    (yk, hk), (yc, hc), (yj_chain, hj_chain) = h0_ref
    for y, h in ((y1, hf1), (y2, hf2), (y_chain, hb)):
        for yw, hw in ((yk, hk), (yc, hc), (yj_chain, hj_chain)):
            _close(y, yw)
            _close(h, hw)
    np.testing.assert_allclose(y_chain.numpy(), y1.numpy(), atol=3e-4)
    np.testing.assert_allclose(hb.numpy(), hf1.numpy(), atol=3e-4)


def test_ssd_scan_pallas_bf16_input():
    """A bfloat16 x (the model's compute dtype): y comes back in bfloat16,
    the state in float32, both within the envelope of the float32 pass on
    the same (bf16-rounded) values plus one bf16 rounding of y."""
    inp = _t(_inputs(4, 1, 48, 4, 16, 2, 8))
    inp["x"] = inp["x"].to(torch.bfloat16)
    y, h = ops.ssd_scan_pallas(**inp, chunk=16)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    ref = dict(inp, x=inp["x"].float())
    y32, h32 = ssd_chunked(**ref, chunk=16)
    _close(h, h32.numpy())
    err = (y.float() - y32).abs()
    assert bool((err <= 2.0 ** -8 * y32.abs() + REL_ENVELOPE
                 * float(y32.abs().max())).all())


# --------------------------------------------------- the Mamba2 mixer

JCFG = JConfig(name="s", family="ssm", n_layers=2, d_model=64, vocab=97,
               ssm_state=16, ssm_head_dim=16, ssm_chunk=8, d_ff=0,
               rope="none")


def _mixer(jcfg, seed=0):
    jp = jssm.ssm_params(jax.random.PRNGKey(seed), jcfg)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    tp = {n: torch.from_numpy(np.array(v, np.float32)).to(
        ssm.ssm_params(None, tcfg)[n].dtype) for n, v in jp.items()}
    return jp, tp, tcfg


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(dtype, with_state):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 7, 12)).astype(np.float32)
    w = (rng.standard_normal((4, 12)) * 0.5).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jargs = [jnp.asarray(a, jdt) for a in (x, w, b)]
    targs = [torch.from_numpy(a).to(tdt) for a in (x, w, b)]
    jy, js = jssm._causal_conv(*jargs, jnp.asarray(st, jdt) if with_state
                               else None)
    ty, ts = ssm._causal_conv(*targs, torch.from_numpy(st).to(tdt)
                              if with_state else None)
    assert ty.dtype == tdt and tuple(ty.shape) == jy.shape
    want = np.asarray(jy.astype(jnp.float32))
    env = (1e-6 if dtype == "float32" else 2.0 ** -7) * np.abs(want).max()
    np.testing.assert_allclose(ty.float().numpy(), want, atol=env)
    np.testing.assert_array_equal(ts.float().numpy(),
                                  np.asarray(js.astype(jnp.float32)))


def test_softplus_is_the_references_formula():
    """Within 2 float32 ulps of ``jax.nn.softplus`` (the two libraries'
    ``exp`` and ``log1p`` round apart), on both sides of 20."""
    x = torch.tensor([-40.0, -3.0, 0.0, 1e-3, 5.0, 20.0, 25.0, 90.0])
    want = np.asarray(jax.nn.softplus(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(ssm.softplus(x).numpy(), want,
                               rtol=2 * 2.0 ** -23)


def test_ssm_params_shapes_and_dtypes():
    jcfg = JCFG.replace(param_dtype="bfloat16")
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    p = ssm.ssm_params(torch.Generator().manual_seed(0), tcfg)
    want = jax.eval_shape(lambda k: jssm.ssm_params(k, jcfg),
                          jax.random.PRNGKey(0))
    assert set(p) == set(want)
    for n, leaf in want.items():
        assert tuple(p[n].shape) == leaf.shape, n
        assert str(p[n].dtype).split(".")[-1] == str(leaf.dtype), n
    for n in ("A_log", "D", "dt_bias"):
        np.testing.assert_allclose(p[n].numpy(), np.asarray(
            jssm.ssm_params(jax.random.PRNGKey(0), jcfg)[n]), rtol=1e-6)


@pytest.mark.parametrize("S", [8, 21])
def test_mamba2_block_train_and_prefill_match_reference(S):
    jp, tp, tcfg = _mixer(JCFG)
    x = np.random.default_rng(S).standard_normal((2, S, 64)).astype(
        np.float32)
    jy, _ = jssm.mamba2_block(jp, jnp.asarray(x), JCFG, "train")
    ty, none = ssm.mamba2_block(tp, torch.from_numpy(x), tcfg, "train")
    assert none is None
    _close(ty, jy)
    jy, jst = jssm.mamba2_block(jp, jnp.asarray(x), JCFG, "prefill")
    ty, tst = ssm.mamba2_block(tp, torch.from_numpy(x), tcfg, "prefill")
    _close(ty, jy)
    _close(tst["h"], jst["h"])
    np.testing.assert_array_equal(tst["conv"].numpy(),
                                  np.asarray(jst["conv"]))


def test_mamba2_block_decode_matches_reference():
    """Prefill 9 tokens, then 6 decode steps on both packages, each from
    its own state."""
    jp, tp, tcfg = _mixer(JCFG, seed=3)
    x = np.random.default_rng(4).standard_normal((2, 15, 64)).astype(
        np.float32)
    _, jst = jssm.mamba2_block(jp, jnp.asarray(x[:, :9]), JCFG, "prefill")
    _, tst = ssm.mamba2_block(tp, torch.from_numpy(x[:, :9]), tcfg,
                              "prefill")
    for t in range(9, 15):
        jy, jst = jssm.mamba2_block(jp, jnp.asarray(x[:, t:t + 1]), JCFG,
                                    "decode", state=jst)
        ty, tst = ssm.mamba2_block(tp, torch.from_numpy(x[:, t:t + 1]),
                                   tcfg, "decode", state=tst)
        _close(ty, jy)
        _close(tst["h"], jst["h"])
    init = ssm.init_ssm_state(tcfg, 2)
    jinit = jssm.init_ssm_state(JCFG, 2)
    for n in ("h", "conv"):
        assert tuple(init[n].shape) == jinit[n].shape
        assert not bool(init[n].any())
