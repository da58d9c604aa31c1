"""repro_torch.core.stepsize / sweep.policies held against the reference.

Inputs are numpy arrays handed to both packages.  Tolerances: window sums,
clip flags and the gammas of the fixed / naive / adaptive1 / adaptive2
families are bitwise; hinge and poly gammas (a float32 ``pow`` and an FMA
the reference's compiler may form) are held to GAMMA_ULPS ulps.
"""
import warnings
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import stepsize as jss
from repro.sweep import policies as jpol
from repro_torch import interop
from repro_torch.core import stepsize as tss
from repro_torch.kernels.fused_step import as_policy_params
from repro_torch.sweep import policies as tpol

GAMMA_ULPS = 4
CPU = "cpu"

POLICY_KW = {
    "fixed": dict(tau_bound=37), "constant": {}, "sun_deng": dict(tau_bound=12),
    "davis": dict(tau_bound=9, ratio=0.7), "naive": dict(b=2.0),
    "adaptive1": dict(alpha=0.8), "adaptive2": {}, "hinge": dict(a=3.0, b=2.0),
    "poly": dict(a=0.7),
}
BITWISE = ("fixed", "constant", "sun_deng", "davis", "naive", "adaptive1",
           "adaptive2")


def _taus(seed=0, n=300, high=40):
    """Delays within the history so far (tau <= k), as a trace gives."""
    rng = np.random.default_rng(seed)
    return np.minimum(rng.integers(0, high, size=n),
                      np.arange(n)).astype(np.int32)


def _assert_gammas(name, ref, got):
    ref, got = np.asarray(ref), np.asarray(got)
    if name in BITWISE:
        np.testing.assert_array_equal(got, ref)
    else:
        ulp = np.finfo(np.float32).eps * np.abs(ref)
        assert np.all(np.abs(got - ref) <= GAMMA_ULPS * ulp)


def _state_pair(k, total, cumbuf, clipped):
    ref = jss.StepsizeState(k=jnp.int32(k), total=jnp.float32(total),
                            cumbuf=jnp.asarray(cumbuf, jnp.float32),
                            clipped=jnp.int32(clipped))
    return ref, interop.stepsize_state(k, total, cumbuf, clipped, device=CPU)


@pytest.mark.parametrize("H", [2, 8, 64])
@pytest.mark.parametrize("tau_off", [-1, 0, 5])
def test_window_sum_at_horizon_edges_pinned_to_clipped(H, tau_off):
    """tau = H-1, H, H+5 at a k past the horizon: the window sum equals the
    reference's and the clip flag is set exactly when tau > H - 1."""
    rng = np.random.default_rng(H)
    cumbuf = np.cumsum(rng.random(H)).astype(np.float32)
    k, tau = 3 * H + 1, H + tau_off
    ref, port = _state_pair(k, cumbuf[-1] + 1.0, cumbuf, 0)
    ws_r, clip_r = jss.window_sum(ref, tau)
    ws_p, clip_p = tss.window_sum(port, tau)
    assert float(ws_p) == float(ws_r)
    assert int(clip_p) == int(clip_r) == int(tau > H - 1)


@pytest.mark.parametrize("tau", [0, 1, 7])
def test_window_sum_at_k0(tau):
    cumbuf = np.linspace(0.1, 0.8, 8, dtype=np.float32)
    ref, port = _state_pair(0, 0.0, cumbuf, 0)
    ws_r, clip_r = jss.window_sum(ref, tau)
    ws_p, clip_p = tss.window_sum(port, tau)
    assert float(ws_p) == float(ws_r) == 0.0
    assert int(clip_p) == int(clip_r) == int(tau > 0)


def test_batched_window_sum_and_push_match_reference():
    rng = np.random.default_rng(3)
    B, H = 6, 16
    k = rng.integers(0, 40, B).astype(np.int32)
    tau = rng.integers(0, 20, B).astype(np.int32)
    cumbuf = np.cumsum(rng.random((B, H)), axis=1).astype(np.float32)
    total = (cumbuf[:, -1] + 1).astype(np.float32)
    clipped = np.zeros(B, np.int32)
    ref = jss.StepsizeState(*(jnp.asarray(a) for a in (k, total, cumbuf, clipped)))
    port = interop.stepsize_state(k, total, cumbuf, clipped, device=CPU)
    ws_r, c_r = jss.window_sum(ref, tau)
    ws_p, c_p = tss.window_sum(port, torch.from_numpy(tau))
    np.testing.assert_array_equal(ws_p.numpy(), np.asarray(ws_r))
    np.testing.assert_array_equal(c_p.numpy(), np.asarray(c_r))
    gamma = rng.random(B).astype(np.float32)
    new_r = jss._push(ref, jnp.asarray(gamma), c_r)
    new_p = tss._push(port, torch.from_numpy(gamma), c_p)
    for a, b in zip(new_p, new_r):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("name", sorted(POLICY_KW))
def test_policy_run_matches_reference(name):
    taus = _taus()
    gp = 0.37
    ref = jss.make_policy(name, gp, **POLICY_KW[name]).run(taus)
    got = tss.make_policy(name, gp, **POLICY_KW[name]).run(taus, device=CPU)
    _assert_gammas(name, ref, got.numpy())


@pytest.mark.parametrize("name", sorted(POLICY_KW))
def test_policy_params_match_reference(name):
    pol_r = jss.make_policy(name, 0.37, **POLICY_KW[name])
    pol_p = tss.make_policy(name, 0.37, **POLICY_KW[name])
    ref = jpol.policy_params(pol_r)
    got = tpol.policy_params(pol_p, device=CPU)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_param_policy_batched_matches_reference_vmap():
    """A (B,) ParamPolicy step sequence against the reference's vmapped,
    jitted ParamPolicy scan (the sweep form)."""
    names = sorted(POLICY_KW)
    taus = np.stack([_taus(seed=i, n=120) for i in range(len(names))])
    pols_r = [jss.make_policy(n, 0.37, **POLICY_KW[n]) for n in names]
    pols_p = [tss.make_policy(n, 0.37, **POLICY_KW[n]) for n in names]
    H = 64

    def cell(pp, tr):
        pol = jpol.ParamPolicy(pp)

        def body(s, t):
            g, s = pol.step(s, t)
            return s, g
        return jax.lax.scan(body, pol.init(H), tr)[1]

    ref = np.asarray(jax.jit(jax.vmap(cell))(jpol.stack_params(pols_r),
                                            jnp.asarray(taus)))
    pol = tpol.ParamPolicy(tpol.stack_params(pols_p, device=CPU))
    state = pol.init(H)
    got = []
    for t in torch.from_numpy(taus).T:
        g, state = pol.step(state, t)
        got.append(g)
    got = torch.stack(got, dim=1).numpy()
    for i, n in enumerate(names):
        _assert_gammas(n, ref[i], got[i])


def test_run_warns_when_delay_exceeds_history():
    taus = np.array([0, 5, 1, 9], np.int32)  # tau > k at events 1 and 3
    with pytest.warns(RuntimeWarning, match="2 event"):
        tss.Adaptive1(gamma_prime=0.5).run(taus, device=CPU)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tss.FixedStepSize(gamma_prime=0.5).run(taus, device=CPU)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 5, 64, 65, 4095])
def test_next_pow2_and_auto_horizon_match_reference(n):
    assert tss.next_pow2(n) == jss.next_pow2(n)
    assert tss.auto_horizon(n) == jss.auto_horizon(n)
    assert tss.auto_horizon(n, slack=3) == jss.auto_horizon(n, slack=3)


def test_auto_horizon_rejects_zero_slack():
    with pytest.raises(ValueError):
        tss.auto_horizon(5, slack=0)


def test_clipped_count_and_clip_delta():
    pol = tss.Adaptive2(gamma_prime=0.5)
    s0 = pol.init(4, device=CPU)
    _, s1 = pol.step(s0, 9)
    assert int(tss.clip_delta(s0, s1)) == 1
    assert int(tss.clipped_count(s1)) == 1


def test_adaptive_lipschitz_matches_reference_and_is_rejected_by_fused():
    taus = _taus(n=150)
    ref = jss.AdaptiveLipschitz(gamma_prime=0.4).run(taus)
    got = tss.AdaptiveLipschitz(gamma_prime=0.4).run(taus, device=CPU)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    with pytest.raises(TypeError, match="AdaptiveLipschitz"):
        as_policy_params(tss.AdaptiveLipschitz(gamma_prime=0.4), CPU)


def _fma_oracle(a, b, c):
    """``a * b + c`` computed exactly, rounded once to float32 (ties to
    even)."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    near = np.float32(float(exact))
    cands = [np.nextafter(near, np.float32(-np.inf)), near,
             np.nextafter(near, np.float32(np.inf))]
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                     int(np.float32(v).view(np.int32)) & 1))


@pytest.mark.parametrize("case", ["ties", "random"])
def test_fma32_is_a_correctly_rounded_fma(case):
    """fma32 rounds once: exactly the oracle's float32, bitwise, also where
    a float64 sum lands on a float32 tie and rounding it twice would not."""
    if case == "ties":
        one = np.float32(1 + 2.0 ** -12)
        tiny = [2.0 ** -80, -2.0 ** -80, 2.0 ** -60, -2.0 ** -60, 0.0]
        a = np.array([one] * 5 + [-one] * 5, np.float32)
        b = np.array([one] * 10, np.float32)
        c = np.array(tiny + [-t for t in tiny], np.float32)
    else:
        rng = np.random.default_rng(7)
        a, b, c = (rng.standard_normal(2000).astype(np.float32)
                   * np.float32(2.0) ** rng.integers(-30, 30, 2000)
                   .astype(np.float32) for _ in range(3))
    got = tss.fma32(torch.from_numpy(a), torch.from_numpy(b),
                    torch.from_numpy(c)).numpy()
    want = np.array([_fma_oracle(*t) for t in zip(a, b, c)], np.float32)
    bad = np.flatnonzero(got.view(np.int32) != want.view(np.int32))
    assert bad.size == 0, (case, bad[:5], got[bad[:5]], want[bad[:5]])
    if case == "ties":
        assert got[0] == np.float32(1 + 2.0 ** -11 + 2.0 ** -23)


def test_make_policy_rejects_unknown_name():
    with pytest.raises(ValueError, match="unknown step-size policy"):
        tss.make_policy("bogus", 0.1)
