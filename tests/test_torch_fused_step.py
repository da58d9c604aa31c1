"""repro_torch.kernels.fused_step: the plain PyTorch version of the fused
policy + prox event against the reference's Pallas kernel.

The reference kernel runs as ``tests/test_fused_engine.py`` runs it on the
CPU: interpret mode (``repro.kernels.dispatch.default_interpret``), under
``jit``.  The port's wrapper takes its plain version because the tensors
lie on the CPU.  The CUDA kernel itself is held against that plain version
on the card by ``chip_smoke.py`` (phase 3).

Tolerances: k and clipped exact; gamma, total and cumbuf bitwise for
policy ids 0-3; hinge/poly gamma within GAMMA_ULPS ulps; x_new within
X_REL of max |x_new| -- the reference's compiler contracts x - gamma * g
into an FMA, the port does not.
"""
import ast
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import prox as jprox
from repro.core.stepsize import StepsizeState as JState
from repro.kernels.fused_step import fused_policy_prox_step as j_fused
from repro.sweep.policies import PolicyParams as JParams
from repro_torch import interop
from repro_torch.core import prox as tprox
from repro_torch.core.stepsize import AdaptiveLipschitz
from repro_torch.kernels import build, dispatch
from repro_torch.kernels import fused_step as fs

GAMMA_ULPS = 4
X_REL = 1e-6
OPS = {
    "none": {}, "l1": dict(lam=0.05), "l2": dict(lam=0.3),
    "elastic_net": dict(lam1=0.05, lam2=0.3), "box": dict(lo=-0.4, hi=0.6),
    "group_l2": dict(lam=0.8),
}


def _case(seed=0, B=24, d=33, H=8):
    """Cells cycling through policy ids 0-5 with k / tau on the window
    edges (k = 0, tau = H-1, H, H+5, tau > k)."""
    rng = np.random.default_rng(seed)
    pid = (np.arange(B) % 6).astype(np.int32)
    k = np.array([0, 1, H - 1, H, H + 5, 3 * H])[np.arange(B) // 6 % 6]
    tau = np.array([0, H - 1, H, H + 5, 2, 40])[(np.arange(B) + seed) % 6]
    cumbuf = np.cumsum(rng.random((B, H)), axis=1).astype(np.float32)
    return dict(
        params=(pid, rng.uniform(0.5, 1.5, B).astype(np.float32),
                rng.uniform(0.05, 0.95, B).astype(np.float32),
                rng.uniform(0.0, 5.0, B).astype(np.float32)),
        state=(k.astype(np.int32), (cumbuf[:, -1] + 1).astype(np.float32),
               cumbuf, rng.integers(0, 3, B).astype(np.int32)),
        tau=tau.astype(np.int32),
        x=rng.normal(size=(B, d)).astype(np.float32),
        g=rng.normal(size=(B, d)).astype(np.float32))


def _reference(c, name, steps=1):
    prox = jprox.make_prox(name, **OPS[name])

    def cell(pp, st, tau, x, g):
        for _ in range(steps):
            gamma, st, x = j_fused(pp, prox, st, tau, x, g)
        return gamma, st, x

    out = jax.jit(jax.vmap(cell))(
        JParams(*map(jnp.asarray, c["params"])),
        JState(*map(jnp.asarray, c["state"])), jnp.asarray(c["tau"]),
        jnp.asarray(c["x"]), jnp.asarray(c["g"]))
    gamma, st, x = jax.tree_util.tree_map(np.asarray, out)
    return gamma, st, x


def _port(c, name, steps=1, fma_push=False):
    prox = tprox.make_prox(name, **OPS[name])
    params = interop.policy_params(*c["params"], device="cpu")
    state = interop.stepsize_state(*c["state"], device="cpu")
    tau = torch.from_numpy(c["tau"])
    x, g = torch.from_numpy(c["x"]), torch.from_numpy(c["g"])
    for _ in range(steps):
        gamma, state, x = fs.fused_policy_prox_step(params, prox, state, tau,
                                                    x, g, fma_push)
    return gamma.numpy(), [t.numpy() for t in state], x.numpy()


def _check(c, ref, got):
    (g_r, s_r, x_r), (g_p, s_p, x_p) = ref, got
    exact = c["params"][0] <= 3
    np.testing.assert_array_equal(s_p[0], s_r.k)
    np.testing.assert_array_equal(s_p[3], s_r.clipped)
    np.testing.assert_array_equal(g_p[exact], g_r[exact])
    np.testing.assert_array_equal(s_p[1][exact], s_r.total[exact])
    np.testing.assert_array_equal(s_p[2][exact], s_r.cumbuf[exact])
    ulp = np.finfo(np.float32).eps * np.abs(g_r[~exact])
    assert np.all(np.abs(g_p[~exact] - g_r[~exact]) <= GAMMA_ULPS * ulp)
    np.testing.assert_allclose(x_p, x_r, rtol=0,
                               atol=X_REL * max(1.0, np.abs(x_r).max()))


@pytest.mark.parametrize("name", sorted(OPS))
def test_plain_version_matches_reference_kernel(name):
    """Six policy ids x this prox op, one event, batched over cells (the
    sweep form: runtime policy parameters, push total + gamma)."""
    c = _case()
    _check(c, _reference(c, name), _port(c, name))


def test_three_consecutive_events_match_reference_kernel():
    c = _case(seed=1)
    _check(c, _reference(c, "l1", steps=3), _port(c, "l1", steps=3))


def test_fma_push_matches_reference_solo_kernel():
    """With the policy a compile-time constant (a solo run), the reference
    contracts the push of a product-form gamma into an FMA; ``fma_push``
    reproduces it."""
    c = _case(seed=2, B=6)
    prox_r, prox_p = jprox.L1(lam=0.05), tprox.L1(lam=0.05)
    state = JState(*map(jnp.asarray, c["state"]))
    port_state = interop.stepsize_state(*c["state"], device="cpu")
    params = interop.policy_params(*c["params"], device="cpu")
    _, port_state, _ = fs.fused_policy_prox_step(
        params, prox_p, port_state, torch.from_numpy(c["tau"]),
        torch.from_numpy(c["x"]), torch.from_numpy(c["g"]), fma_push=True)
    for i in range(6):
        pp = JParams(*(jnp.asarray(p[i]) for p in c["params"]))
        run = jax.jit(functools.partial(j_fused, pp, prox_r))
        _, st, _ = run(jax.tree_util.tree_map(lambda a: a[i], state),
                       c["tau"][i], c["x"][i], c["g"][i])
        assert port_state.total[i].item() == float(st.total), i


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    c = _case()
    before = fs.fused_policy_prox_step.launches
    got = _port(c, "l2")
    params = interop.policy_params(*c["params"], device="cpu")
    state = interop.stepsize_state(*c["state"], device="cpu")
    ref = fs.fused_policy_prox_step_ref(
        params, tprox.make_prox("l2", **OPS["l2"]), state,
        torch.from_numpy(c["tau"]), torch.from_numpy(c["x"]),
        torch.from_numpy(c["g"]))
    assert fs.fused_policy_prox_step.launches == before
    np.testing.assert_array_equal(got[2], ref[2].numpy())


def test_state_is_updated_in_place():
    c = _case()
    state = interop.stepsize_state(*c["state"], device="cpu")
    k_before = state.k.clone()
    _, new, _ = fs.fused_policy_prox_step(
        interop.policy_params(*c["params"], device="cpu"), tprox.Zero(),
        state, torch.from_numpy(c["tau"]), torch.from_numpy(c["x"]),
        torch.from_numpy(c["g"]))
    assert new.k is state.k and torch.equal(state.k, k_before + 1)


def test_select_gamma_matches_reference_branches():
    from repro.kernels.fused_step import select_gamma as j_select
    c = _case(seed=3)
    ws = np.random.default_rng(3).uniform(0, 1.5, 24).astype(np.float32)
    ref = np.asarray(jax.jit(j_select)(*map(jnp.asarray, c["params"]),
                                       jnp.asarray(ws), jnp.asarray(c["tau"])))
    got = fs.select_gamma(*map(torch.from_numpy, c["params"]),
                          torch.from_numpy(ws), torch.from_numpy(c["tau"]))
    exact = c["params"][0] <= 3
    np.testing.assert_array_equal(got.numpy()[exact], ref[exact])


def test_boundary_bytes_counts_touched_slots_only():
    d, B = 784, 96
    assert fs.boundary_bytes(512, d, cells=B) == \
        fs.boundary_bytes(4096, d, cells=B)
    assert fs.boundary_bytes(512, d, cells=B) - \
        fs.boundary_bytes(512, d, cells=B, reads_slot=0) == 4 * B
    assert fs.boundary_bytes(512, d) == 12 * d + 56


def test_guards_reject_what_the_kernel_cannot_run():
    with pytest.raises(TypeError, match="AdaptiveLipschitz"):
        fs.as_policy_params(AdaptiveLipschitz(gamma_prime=0.3), "cpu")
    with pytest.raises(ValueError, match="single 1-D"):
        fs.fused_leaf([torch.zeros(3), torch.zeros(2)], "PIAG iterate")
    with pytest.raises(ValueError, match="single 1-D"):
        fs.fused_leaf(torch.zeros(3, 2), "PIAG iterate")

    class Custom(tprox.ProxOp):
        pass

    with pytest.raises(TypeError, match="no prox op Custom"):
        fs.prox_code(Custom())


def test_device_rule():
    assert dispatch.resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            dispatch.resolve_device(None)
    with pytest.raises(ValueError, match="unsupported device"):
        dispatch.resolve_device("meta")
    assert dispatch.kernel_route(torch.zeros(2)) == "plain"
    with pytest.raises(ValueError, match="no kernel or plain version"):
        dispatch.kernel_route(torch.zeros(2, device="meta"))
    with pytest.raises(ValueError, match="span devices"):
        dispatch.kernel_route(torch.zeros(2), torch.zeros(2, device="meta"))


def test_kernel_source_is_built_for_sm90a_and_checked_after_launch():
    """The build targets sm_90a and keeps the ptxas report; the launcher
    returns cudaGetLastError() and the wrapper raises on it."""
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert "-v" in build.NVCC_FLAGS
    src = (build.CSRC_DIR / "fused_step.cu").read_text()
    assert "cudaGetLastError()" in src
    for kind in ("kNone", "kL1", "kL2", "kElasticNet", "kBox", "kGroupL2"):
        assert kind in src
    tree = ast.parse(open(fs.__file__).read())
    raises = [n for n in ast.walk(tree) if isinstance(n, ast.Raise)]
    assert any("launch failed" in ast.unparse(r) for r in raises)
