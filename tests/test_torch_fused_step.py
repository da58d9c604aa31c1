"""repro_torch.kernels.fused_step: the plain PyTorch versions of the fused
event kernels against the reference's Pallas kernels -- B1 (policy + prox),
B2 (policy + FedAsync mix) and B3 (policy + FedBuff buffer step).

The reference kernel runs as ``tests/test_fused_engine.py`` runs it on the
CPU: interpret mode (``repro.kernels.dispatch.default_interpret``), under
``jit``.  The port's wrapper takes its plain version because the tensors
lie on the CPU.  The CUDA kernel itself is held against that plain version
on the card by ``chip_smoke.py`` (phase 3).

Tolerances: k and clipped exact; gamma, total and cumbuf bitwise for
policy ids 0-3; hinge/poly gamma within GAMMA_ULPS ulps.  B1's x_new within
X_REL of max |x_new| -- the reference's compiler contracts x - gamma * g
into an FMA, the port does not.  B2's x_new and B3's x_new and delta_new
bitwise for ids 0-3 (both sides contract the mix, the accumulate and the
apply), within X_REL for ids 4-5 (their gamma may differ by an ulp).
"""
import ast
import ctypes
import functools
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import prox as jprox
from repro.core.stepsize import StepsizeState as JState
from repro.kernels.fused_step import fused_policy_buff_step as j_buff
from repro.kernels.fused_step import fused_policy_mix_step as j_mix
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


# ------------------------------------------------------- B2 and B3 ----

def _fed_case(seed=0, B=24, d=33, H=8):
    c = _case(seed, B, d, H)
    rng = np.random.default_rng(seed + 100)
    c.update(xc=rng.normal(size=(B, d)).astype(np.float32),
             xw=rng.normal(size=(B, d)).astype(np.float32),
             delta=rng.normal(size=(B, d)).astype(np.float32),
             agg=(np.arange(B) % 3 == 1).astype(np.float32))
    return c


def _fed_reference(c, kind, steps=3, scale=0.4 / 3):
    def cell(pp, st, tau, x, xc, xw, delta, agg):
        for _ in range(steps):
            if kind == "mix":
                gamma, st, x = j_mix(pp, st, tau, x, xc)
            else:
                gamma, st, x, delta = j_buff(pp, st, tau, x, xc, xw, delta,
                                             agg, scale)
        return gamma, st, x, delta

    out = jax.jit(jax.vmap(cell))(
        JParams(*map(jnp.asarray, c["params"])),
        JState(*map(jnp.asarray, c["state"])), jnp.asarray(c["tau"]),
        *(jnp.asarray(c[k]) for k in ("x", "xc", "xw", "delta", "agg")))
    return jax.tree_util.tree_map(np.asarray, out)


def _fed_port(c, kind, steps=3, scale=0.4 / 3, fma_push=False):
    params = interop.policy_params(*c["params"], device="cpu")
    state = interop.stepsize_state(*c["state"], device="cpu")
    tau = torch.from_numpy(c["tau"])
    x, xc, xw, delta, agg = (torch.from_numpy(c[k]) for k in
                             ("x", "xc", "xw", "delta", "agg"))
    for _ in range(steps):
        if kind == "mix":
            gamma, state, x = fs.fused_policy_mix_step(params, state, tau, x,
                                                       xc, fma_push)
        else:
            gamma, state, x, delta = fs.fused_policy_buff_step(
                params, state, tau, x, xc, xw, delta, agg, scale, fma_push)
    return gamma.numpy(), [t.numpy() for t in state], x.numpy(), \
        delta.numpy()


def _fed_check(c, ref, got, kind):
    (g_r, s_r, x_r, d_r), (g_p, s_p, x_p, d_p) = ref, got
    _check(c, (g_r, s_r, x_r), (g_p, s_p, x_p))
    exact = c["params"][0] <= 3
    vectors = [(x_p, x_r)] + ([(d_p, d_r)] if kind == "buff" else [])
    for a, r in vectors:
        assert np.array_equal(a[exact], r[exact]), \
            f"{kind}: ids 0-3 differ by up to {np.abs(a - r)[exact].max()}"
        assert np.abs(a - r).max() <= X_REL * max(1.0, np.abs(r).max())


@pytest.mark.parametrize("kind", ["mix", "buff"])
@pytest.mark.parametrize("seed", [0, 1])
def test_fed_plain_versions_match_reference_kernels(kind, seed):
    """Six policy ids on the window edges, three consecutive events, agg
    mixed 0/1 (B3), batched over cells (the sweep form)."""
    c = _fed_case(seed=seed)
    _fed_check(c, _fed_reference(c, kind), _fed_port(c, kind), kind)


@pytest.mark.parametrize("kind", ["mix", "buff"])
def test_fed_fma_push_matches_reference_solo_kernels(kind):
    """A concrete policy (a solo run): the reference contracts the push of a
    product-form gamma; ``fma_push`` reproduces the pushed total."""
    c = _fed_case(seed=2, B=6)
    got = _fed_port(c, kind, steps=1, fma_push=True)
    for i in range(6):
        pp = JParams(*(jnp.asarray(p[i]) for p in c["params"]))
        st = JState(*(jnp.asarray(s[i]) for s in c["state"]))
        args = [jnp.asarray(c[k][i]) for k in ("x", "xc", "xw", "delta")]
        if kind == "mix":
            out = jax.jit(functools.partial(j_mix, pp))(
                st, c["tau"][i], args[0], args[1])
        else:
            out = jax.jit(lambda st, tau, *a: j_buff(pp, st, tau, *a,
                                                     0.4 / 3))(
                st, c["tau"][i], *args, jnp.asarray(c["agg"][i]))
        assert got[1][1][i] == float(out[1].total), i


def test_fed_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    c = _fed_case()
    before = (fs.fused_policy_mix_step.launches,
              fs.fused_policy_buff_step.launches)
    for kind in ("mix", "buff"):
        got = _fed_port(c, kind, steps=1)
        params = interop.policy_params(*c["params"], device="cpu")
        state = interop.stepsize_state(*c["state"], device="cpu")
        t = {k: torch.from_numpy(c[k]) for k in
             ("tau", "x", "xc", "xw", "delta", "agg")}
        if kind == "mix":
            ref = fs.fused_policy_mix_step_ref(params, state, t["tau"],
                                               t["x"], t["xc"])
        else:
            ref = fs.fused_policy_buff_step_ref(
                params, state, t["tau"], t["x"], t["xc"], t["xw"],
                t["delta"], t["agg"], 0.4 / 3)
            np.testing.assert_array_equal(got[3], ref[3].numpy())
        np.testing.assert_array_equal(got[2], ref[2].numpy())
    assert (fs.fused_policy_mix_step.launches,
            fs.fused_policy_buff_step.launches) == before


def test_fed_state_is_updated_in_place_and_scale_is_float32():
    c = _fed_case()
    state = interop.stepsize_state(*c["state"], device="cpu")
    k0 = state.k.clone()
    t = {k: torch.from_numpy(c[k]) for k in
         ("tau", "x", "xc", "xw", "delta", "agg")}
    params = interop.policy_params(*c["params"], device="cpu")
    _, new, x64, _ = fs.fused_policy_buff_step(
        params, state, t["tau"], t["x"], t["xc"], t["xw"], t["delta"],
        t["agg"], 0.4 / 3)
    assert new.k is state.k and torch.equal(state.k, k0 + 1)
    state = interop.stepsize_state(*c["state"], device="cpu")
    _, _, x32, _ = fs.fused_policy_buff_step(
        params, state, t["tau"], t["x"], t["xc"], t["xw"], t["delta"],
        t["agg"], float(np.float32(0.4 / 3)))
    assert torch.equal(x64, x32)


def test_fed_boundary_bytes_count_each_vector_once():
    d, B = 784, 24
    assert fs.boundary_bytes_mix(d) == 12 * d + 56
    assert fs.boundary_bytes_buff(d) == 24 * d + 60
    assert fs.boundary_bytes_mix(d, cells=B) - \
        fs.boundary_bytes_mix(d, cells=B, reads_slot=0) == 4 * B
    assert fs.boundary_bytes_buff(d, cells=B) == B * (24 * d + 60)


def test_wrappers_refuse_inputs_the_kernels_cannot_read():
    c = _fed_case(B=4, d=5)
    params = interop.policy_params(*c["params"], device="cpu")
    state = interop.stepsize_state(*c["state"], device="cpu")
    tau = torch.from_numpy(c["tau"])
    x = torch.zeros(4, 5)
    with pytest.raises(ValueError, match="fused_policy_buff_step: agg"):
        fs._card_pointers("fused_policy_buff_step", fs._BUFF_SPEC,
                          (*params, tau, *state,
                           torch.zeros(4, dtype=torch.int32), x, x, x, x),
                          4, 5, 8)
    with pytest.raises(ValueError, match="fused_policy_mix_step: xc"):
        fs._card_pointers("fused_policy_mix_step", fs._MIX_SPEC,
                          (*params, tau, *state, x, x.T), 4, 5, 8)


def _two_pass_message(kernel, name, t, dtype, shape):
    """The message the two-pass check (``_check_inputs``, replaced by
    ``_card_pointers``) gave for a bad input."""
    return (f"{kernel}: {name} must be a contiguous {dtype} tensor of "
            f"shape {tuple(shape)}; got {t.dtype} {tuple(t.shape)} "
            f"contiguous={t.is_contiguous()}")


def _bad_inputs(t):
    """A wrong dtype, a wrong shape and a non-contiguous tensor in place of
    ``t``."""
    other = torch.float64 if t.dtype == torch.float32 else torch.int64
    wrong_shape = torch.zeros(t.shape[0] + 1, *t.shape[1:], dtype=t.dtype)
    strided = torch.zeros(*t.shape[:-1], 2 * t.shape[-1],
                          dtype=t.dtype)[..., ::2]
    return t.to(other), wrong_shape, strided


@pytest.mark.parametrize("kind", ["prox", "mix", "buff"])
def test_one_pass_check_gives_the_two_pass_messages(kind):
    """Each bad input of each launch raises what ``_check_inputs`` raised,
    word for word; good inputs give their data pointers in the launcher's
    order; a tensor on another device raises ``kernel_route``'s message
    (the wrappers route through it before ``_card_pointers``)."""
    B, d, H = 4, 5, 8
    c = _fed_case(B=B, d=d, H=H)
    params = interop.policy_params(*c["params"], device="cpu")
    state = interop.stepsize_state(*c["state"], device="cpu")
    vec = {k: torch.from_numpy(c[k]) for k in
           ("x", "g", "xc", "xw", "delta", "agg")}
    spec = {"prox": fs._PROX_SPEC, "mix": fs._MIX_SPEC,
            "buff": fs._BUFF_SPEC}[kind]
    kernel = f"fused_policy_{kind}_step"
    good = (*params, torch.from_numpy(c["tau"]), *state,
            *(vec[name] for name, _, _ in spec[9:]))
    assert fs._card_pointers(kernel, spec, good, B, d, H) == \
        [t.data_ptr() for t in good]
    assert dispatch.kernel_route(*good) == "plain"
    shapes = ((B,), (B, H), (B, d))
    for i, (name, dtype, s) in enumerate(spec):
        assert good[i].dtype == dtype and tuple(good[i].shape) == shapes[s]
        for bad in _bad_inputs(good[i]):
            tensors = good[:i] + (bad,) + good[i + 1:]
            msg = _two_pass_message(kernel, name, bad, dtype, shapes[s])
            with pytest.raises(ValueError, match=f"^{re.escape(msg)}$"):
                fs._card_pointers(kernel, spec, tensors, B, d, H)
        meta = good[:i] + (good[i].to("meta"),) + good[i + 1:]
        with pytest.raises(ValueError, match=re.escape(
                "kernel inputs span devices ['cpu', 'meta']")):
            dispatch.kernel_route(*meta)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        dispatch.kernel_route(*(t.to("meta") for t in good))


_C_TYPES = {"const int*": ctypes.c_void_p, "int*": ctypes.c_void_p,
            "const float*": ctypes.c_void_p, "float*": ctypes.c_void_p,
            "void*": ctypes.c_void_p, "int": ctypes.c_int,
            "float": ctypes.c_float}


class _Lib:
    """Stands in for the loaded library: every symbol is a settable
    object."""

    def __getattr__(self, name):
        fn = types.SimpleNamespace(argtypes=None, restype=None)
        setattr(self, name, fn)
        return fn


def test_ctypes_bindings_match_the_c_signatures(monkeypatch):
    """Every ``extern "C"`` launcher of ``fused_step.cu`` takes exactly the
    ctypes ``_ARGTYPES`` declares (a wrong count or width would pass
    garbage to the card); the library is faked."""
    lib = _Lib()
    monkeypatch.setattr(build, "load", lambda name: types.SimpleNamespace(
        lib=lib) if name == "fused_step" else None)
    monkeypatch.setattr(fs, "_FNS", {})
    fns = fs._fns()
    src = (build.CSRC_DIR / "fused_step.cu").read_text()
    c_api = src[src.index('extern "C" {'):]
    launchers = re.findall(r"^int (\w+_launch)\(([^)]*)\)", c_api, re.M)
    assert {name for name, _ in launchers} == set(fs._ARGTYPES)
    for name, params in launchers:
        types_ = [_C_TYPES[re.sub(r"\s*\w+$", "", p.strip())]
                  for p in params.split(",")]
        assert fns[name] is getattr(lib, name)
        assert getattr(lib, name).argtypes == types_, name
        assert getattr(lib, name).restype is ctypes.c_int
    assert lib.fused_step_error_string.restype is ctypes.c_char_p


def test_fed_kernels_are_in_the_source_with_their_launchers():
    src = (build.CSRC_DIR / "fused_step.cu").read_text()
    for name in ("fused_policy_mix_kernel", "fused_policy_buff_kernel",
                 "fused_policy_mix_step_launch",
                 "fused_policy_buff_step_launch", "block_prologue"):
        assert name in src
    assert src.count("return static_cast<int>(cudaGetLastError());") == 4
    assert set(fs._ARGTYPES) == {"fused_policy_prox_step_launch",
                                 "fused_policy_mix_step_launch",
                                 "fused_policy_buff_step_launch",
                                 "fused_step_floor_launch"}


def _kernel_text(src: str, name: str) -> str:
    """The text of ``__global__`` kernel ``name``, signature to closing
    brace."""
    start = src.index(f"{name}(", src.index("__global__ void"))
    start = src.rindex("__global__", 0, start)
    return src[start:src.index("\n}\n", start) + 3]


def test_b1_b3_stage_the_row_and_b2_keeps_its_first_design():
    """All three event kernels, B2 included (it no longer keeps its first
    design; the name is kept), run ``block_prologue`` (the cumbuf row
    staged in shared memory up to kRowCap) and have a float4 and a scalar
    instance, chosen by the launcher; ``policy_prologue``, the first
    design's prologue of two dependent trips, is gone from the source."""
    src = (build.CSRC_DIR / "fused_step.cu").read_text()
    assert "constexpr int kRowCap = 1024;" in src
    assert "if (H <= kRowCap)" in src
    assert "policy_prologue" not in src
    for name in ("fused_policy_prox_kernel", "fused_policy_mix_kernel",
                 "fused_policy_buff_kernel"):
        body = _kernel_text(src, name)
        assert "block_prologue(" in body
        assert "template <bool kVec4>" in src[:src.index(body)][-60:]
        assert f"&{name}<true>" in src and f"&{name}<false>" in src
