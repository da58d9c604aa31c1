"""repro_torch.core.prox held against repro.core.prox.

The port applies an operator to (B, d) cells with one step-size per cell;
the reference is ``vmap``-ped over the same cells.  Tolerances: the
elementwise operators are bitwise; ``GroupL2`` (a norm reduction) and
every ``value`` (a sum) are held to REL_TOL, float32 reductions taken in
another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import prox as jprox
from repro_torch.core import prox as tprox

REL_TOL = 2e-6
OPS = {
    "none": {}, "l1": dict(lam=0.05), "l2": dict(lam=0.3),
    "elastic_net": dict(lam1=0.05, lam2=0.3), "box": dict(lo=-0.4, hi=0.6),
    "group_l2": dict(lam=0.8),
}


def _inputs(seed=0, B=7, d=33):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, d)).astype(np.float32)
    gamma = rng.uniform(0.1, 2.0, size=B).astype(np.float32)
    x[0, :4] = 0.0  # exact zeros exercise sign()
    return x, gamma


@pytest.mark.parametrize("name", sorted(OPS))
def test_prox_matches_reference(name):
    x, gamma = _inputs()
    ref = np.asarray(jax.vmap(jprox.make_prox(name, **OPS[name]).prox)(
        jnp.asarray(x), jnp.asarray(gamma)))
    got = tprox.make_prox(name, **OPS[name]).prox(
        torch.from_numpy(x), torch.from_numpy(gamma)).numpy()
    if name == "group_l2":
        np.testing.assert_allclose(got, ref, rtol=REL_TOL, atol=0)
    else:
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name", sorted(OPS))
def test_value_matches_reference(name):
    x, _ = _inputs(seed=1)
    if name == "box":
        x = np.clip(x, -0.4, 0.6)
        x[2, 0] = 5.0  # one cell outside the box -> inf
    ref = np.asarray(jax.vmap(jprox.make_prox(name, **OPS[name]).value)(
        jnp.asarray(x)))
    got = tprox.make_prox(name, **OPS[name]).value(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=REL_TOL, atol=0)


def test_prox_of_one_leaf_with_scalar_gamma():
    x, _ = _inputs(B=1)
    op_r, op_p = jprox.L1(lam=0.05), tprox.L1(lam=0.05)
    ref = np.asarray(op_r.prox(jnp.asarray(x[0]), jnp.float32(0.7)))
    got = op_p.prox(torch.from_numpy(x[0]), torch.tensor(0.7)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_group_l2_zeroes_a_small_group():
    op = tprox.GroupL2(lam=10.0)
    out = op.prox(torch.full((2, 5), 0.1), torch.tensor([1.0, 1.0]))
    assert torch.equal(out, torch.zeros(2, 5))


def test_make_prox_rejects_unknown_name():
    with pytest.raises(ValueError, match="unknown prox"):
        tprox.make_prox("l0")
