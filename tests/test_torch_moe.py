"""The port's MoE layer (``models.moe``) against the reference's, on the
CPU, from the same numpy inputs and the reference's parameters.

Router envelope.  Both packages take the softmax of the same float32
logits, in other summation orders, so a probability may move by a few
float32 ulps.  Expert ids must therefore agree wherever the reference's
k-th and (k+1)-th probabilities differ by more than ``MARGIN``; the tests
count those tokens and require all of them to agree (and, at these
inputs, every token to qualify, or the block comparison would rest on
fewer tokens than it says).  Exact ties go to the lower expert index in
both packages.  Outputs: float32 within ``Y_ENV`` absolute (values of
size ~1), the balance loss within ``AUX_ENV``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.train import PRESETS as J_PRESETS
import repro.launch.train as jtrain
from repro.models import init_params as j_init
from repro.models import loss_fn as j_loss_fn
from repro.models.config import ModelConfig as JConfig
from repro.models.moe import moe_block as j_moe_block
from repro.models.moe import moe_block_capacity as j_moe_capacity
from repro.models.moe import moe_params as j_moe_params
from repro.models.moe import router_topk as j_router_topk
import repro_torch.launch.train as ttrain
from repro_torch import interop
from repro_torch.models import ModelConfig, forward, loss_fn
from repro_torch.models.moe import (moe_block, moe_block_capacity,
                                    moe_params, router_topk)

MARGIN = 1e-6
Y_ENV = 2e-5
AUX_ENV = 1e-6
LOSS_REL = 1e-4
KEY = jax.random.PRNGKey(0)
BASE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab=97, q_chunk=8)
JCFG = JConfig(name="moe", family="moe", n_experts=4, top_k=2, moe_ff=32,
               shared_ff=32, **BASE)
TCFG = ModelConfig(**dataclasses.asdict(JCFG))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's programs here are tiny: torch's intra-op threads would
    only contend with the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sure(probs: np.ndarray, k: int) -> np.ndarray:
    """Tokens whose k-th and (k+1)-th reference probabilities differ by
    more than ``MARGIN``."""
    s = -np.sort(-probs, axis=-1)
    return (s[:, k - 1] - s[:, k]) > MARGIN


def _params(cfg=JCFG, seed=1):
    jp = j_moe_params(jax.random.PRNGKey(seed), cfg)
    tp = {n: torch.from_numpy(np.array(v, np.float32)) for n, v in jp.items()}
    return jp, tp


def _x(T=64, seed=0, d=64):
    return np.random.default_rng(seed).standard_normal(
        (2, T // 2, d)).astype(np.float32)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_router_topk_matches_reference(k):
    logits = np.random.default_rng(k).standard_normal((256, 8)).astype(
        np.float32) * 2
    jc, ja, ji = j_router_topk(jnp.asarray(logits), k)
    tc, ta, ti = router_topk(torch.from_numpy(logits), k)
    sure = _sure(np.asarray(jax.nn.softmax(logits, axis=-1)), k)
    assert sure.all(), f"{(~sure).sum()} tokens inside the margin"
    np.testing.assert_array_equal(ti.numpy()[sure], np.asarray(ji)[sure])
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    assert abs(float(ta) - float(ja)) <= AUX_ENV


def test_router_topk_ties_go_to_the_lower_index():
    """``jax.lax.top_k`` order on exact ties, which ``torch.topk`` does not
    promise: uniform rows, and rows with two equal leaders."""
    logits = np.zeros((16, 6), np.float32)
    logits[8:, [1, 4]] = 3.0
    for k in (1, 2, 3):
        _, _, ji = j_router_topk(jnp.asarray(logits), k)
        _, _, ti = router_topk(torch.from_numpy(logits), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ti.numpy()[0], [0, 1, 2])
    np.testing.assert_array_equal(ti.numpy()[8], [1, 4, 0])


def _router_probs(jp, x):
    t = x.reshape(-1, x.shape[-1])
    return np.asarray(jax.nn.softmax(jnp.asarray(t) @ jp["router"], axis=-1))


def test_moe_block_matches_reference():
    jp, tp = _params()
    x = _x()
    sure = _sure(_router_probs(jp, x), JCFG.top_k)
    assert sure.all(), f"{(~sure).sum()} tokens inside the margin"
    jy, ja = j_moe_block(jp, jnp.asarray(x), JCFG)
    ty, ta = moe_block(tp, torch.from_numpy(x), TCFG)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=Y_ENV)
    assert abs(float(ta) - float(ja)) <= AUX_ENV


@pytest.mark.parametrize("cf", [0.5, 1.0, 4.0])
def test_moe_block_capacity_matches_reference(cf):
    """At capacity factors that drop many, some and no tokens: the same
    tokens overflow (slots in token-major order), so the outputs agree."""
    jp, tp = _params()
    x = _x()
    probs = _router_probs(jp, x)
    sure = _sure(probs, JCFG.top_k)
    assert sure.all(), f"{(~sure).sum()} tokens inside the margin"
    T, E, k = 64, JCFG.n_experts, JCFG.top_k
    C = max(1, int(T * k / E * cf))
    load = np.bincount(np.argsort(-probs, axis=-1, kind="stable")[:, :k]
                       .ravel(), minlength=E)
    assert (load.max() > C) == (cf < 4.0), (load, C)   # drops or not
    jy, ja = j_moe_capacity(jp, jnp.asarray(x), JCFG, capacity_factor=cf)
    ty, ta = moe_block_capacity(tp, torch.from_numpy(x), TCFG,
                                capacity_factor=cf)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=Y_ENV)
    assert abs(float(ta) - float(ja)) <= AUX_ENV


def test_moe_capacity_matches_dense_when_no_drop():
    """``tests/test_models.py:109`` on the port."""
    cfg = TCFG
    p = moe_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    x = torch.randn((2, 16, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    y_d, aux_d = moe_block(p, x, cfg)
    y_c, aux_c = moe_block_capacity(p, x, cfg, capacity_factor=4.0)
    np.testing.assert_allclose(y_d.numpy(), y_c.numpy(), atol=2e-4)
    np.testing.assert_allclose(float(aux_d), float(aux_c), atol=1e-5)


def test_moe_aux_loss_minimum_is_topk():
    """``tests/test_models.py:120`` on the port: balanced routing gives
    aux == k; concentrating probability on the chosen experts raises it."""
    _, aux_bal, _ = router_topk(torch.zeros((64, 4)), 2)
    assert 1.95 < float(aux_bal) < 2.05
    skew = torch.tensor([[8.0, 8.0, -8.0, -8.0]]).repeat(64, 1)
    _, aux_skew, _ = router_topk(skew, 2)
    assert float(aux_skew) > float(aux_bal) + 1.5


def test_moe_params_shapes_and_dtypes():
    cfg = TCFG.replace(param_dtype="bfloat16")
    p = moe_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    jshapes = jax.eval_shape(lambda k: j_moe_params(
        k, JCFG.replace(param_dtype="bfloat16")), KEY)
    assert set(p) == set(jshapes)
    for n, leaf in jshapes.items():
        assert tuple(p[n].shape) == leaf.shape, n
        assert str(p[n].dtype).split(".")[-1] == str(leaf.dtype), n
    assert p["router"].dtype == torch.float32


@pytest.mark.parametrize("impl", ["capacity", "dense"])
def test_forward_and_loss_sum_the_aux_over_layers(impl):
    """``forward``'s aux is the sum of the layers' balance losses and
    ``loss_fn`` adds ``router_aux_coef`` times it, as the reference's."""
    jcfg = JCFG.replace(moe_impl=impl, attention_impl="chunked")
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    jp = j_init(jcfg, KEY)
    model = interop.model_params(jax.tree_util.tree_map(np.asarray, jp),
                                 tcfg, device="cpu")
    toks = np.random.default_rng(5).integers(0, jcfg.vocab, (2, 17)).astype(
        np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    jl, jparts = j_loss_fn(jp, jcfg, {n: jnp.asarray(v)
                                      for n, v in batch.items()})
    tl, tparts = loss_fn(model, tcfg, {n: torch.from_numpy(v)
                                       for n, v in batch.items()})
    _, aux = forward(model, tcfg, {"tokens": torch.from_numpy(
        batch["tokens"])})
    assert float(aux) > 1.0          # two layers of ~k each
    assert abs(float(tparts["aux"]) - float(jparts["aux"])) <= 2 * AUX_ENV
    assert float(tparts["aux"]) == float(aux)
    assert abs(float(tl) - float(jl)) <= 1e-5
    assert abs(float(tl) - float(tparts["ce"])
               - jcfg.router_aux_coef * float(aux)) <= 1e-6


def _reference_init(jc):
    def init_params(cfg, generator=None, device=None):
        seed = int(generator.initial_seed()) if generator is not None else 0
        pj = jax.tree_util.tree_map(np.asarray,
                                    j_init(jc, jax.random.PRNGKey(seed)))
        return interop.model_params(pj, cfg, device=device)
    return init_params


def test_moe_run_training_matches_reference():
    """``launch.train.run_training`` on a narrow moe-tiny (capacity
    dispatch, the aux term in the loss) from the reference's parameters:
    taus exact, gammas bitwise, losses within ``LOSS_REL`` of the
    first."""
    shape = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                 head_dim=16, d_ff=128, moe_ff=64, shared_ff=64, vocab=128,
                 name="moe-narrow")
    jc = J_PRESETS["moe-tiny"].replace(**shape)
    tc = ttrain.PRESETS["moe-tiny"].replace(attention_impl="chunked", **shape)
    kw = dict(steps=8, batch=2, seq=32, n_workers=2, log_every=1)
    lj = jtrain.run_training(jc, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttrain, "init_params", _reference_init(jc))
        lt = ttrain.run_training(tc, device="cpu", **kw)
    for a, b in zip(lj, lt):
        assert (a["step"], a["tau"]) == (b["step"], b["tau"])
        assert np.float32(a["gamma"]).view(np.int32) == \
            np.float32(b["gamma"]).view(np.int32)
        assert abs(a["loss"] - b["loss"]) <= LOSS_REL * abs(lj[0]["loss"]), \
            (a, b)


def test_moe_tiny_preset_trains():
    """The ``moe-tiny`` preset at full width (6 layers, 8 experts) takes
    optimizer steps on the port and its loss stays finite."""
    cfg = ttrain.PRESETS["moe-tiny"].replace(attention_impl="chunked")
    log = ttrain.run_training(cfg, steps=2, batch=1, seq=16, n_workers=2,
                              log_every=1, device="cpu")
    assert [r["step"] for r in log] == [0, 1]
    assert all(np.isfinite(r["loss"]) for r in log)
