"""The port's ``optim`` (``Sgd``, ``Momentum``, ``AdamW``, the
``DelayAdaptiveOptimizer``, schedules), ``core.async_sgd``, ``data`` and
``models.loss_fn`` against the reference.

The same numpy trees go to both packages.  Updates run on carried trees
(each call takes the previous call's output) against the reference's
jitted ``update``, as its trainer jits it: taus exact, gammas bitwise
(the port's policies contract the push as XLA does), parameters and
optimizer state within ``OPT_REL`` of each leaf's largest value (XLA:CPU
contracts some ``a * b + c`` of the updates into FMAs, the port rounds
twice; ROADMAP queue C).  Batches bitwise.  ``loss_fn`` within
``LOSS_TOL`` and its gradients within ``GRAD_REL`` of each leaf's largest
|gradient| (float32 matmuls and softmax sums in other orders).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim as jo
from repro.checkpoint import save_checkpoint as j_save
from repro.core import L1 as JL1, Adaptive1 as JA1, Zero as JZero
from repro.core.async_sgd import AsyncSGD as JAsyncSGD
from repro.data import EmbedStream as JEmbed, TokenStream as JToken
from repro.launch.steps import TrainState as JTrainState
from repro.launch.steps import make_trainer as j_make_trainer
from repro.models import init_params as j_init, loss_fn as j_loss
from repro.models.config import ModelConfig as JConfig
import repro_torch.optim as to
from repro_torch import interop
from repro_torch.checkpoint import save_checkpoint
from repro_torch.core import L1, Adaptive1, AsyncSGD, Zero
from repro_torch.core.pytree import tree_leaves
from repro_torch.data import EmbedStream, TokenStream
from repro_torch.launch.steps import loss_and_grad
from repro_torch.models import loss_fn, param_tree
from repro_torch.models.config import ModelConfig

OPT_REL = 1e-5    # params / optimizer state after 12 carried updates
SCHED_ULPS = 2    # schedules: float32 cos and divisions
LOSS_TOL = 1e-5   # loss_fn, absolute
GRAD_REL = 1e-5   # gradients, relative to each leaf's largest |value|


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's programs here are tiny: torch's intra-op threads would
    only contend with the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(rng, scale=1.0):
    return {"a": (rng.normal(size=(5, 7)) * scale).astype(np.float32),
            "b": {"c": (rng.normal(size=(11,)) * scale).astype(np.float32),
                  "d": (rng.normal(size=(3, 2, 4)) * scale).astype(np.float32)}}


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


def _close(jtree, ttree, rel, what):
    jl = [np.asarray(x) for x in jax.tree_util.tree_leaves(jtree)]
    tl = [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
          for x in tree_leaves(ttree)]
    assert len(jl) == len(tl), what
    for a, b in zip(jl, tl):
        assert a.shape == b.shape, what
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(a, b, err_msg=what)
        else:
            err = np.abs(a - b).max() if a.size else 0.0
            assert err <= rel * max(np.abs(a).max(), 1e-30), (what, err)


BASES = {"sgd": (jo.Sgd(), to.Sgd()),
         "momentum": (jo.Momentum(beta=0.9), to.Momentum(beta=0.9)),
         "nesterov": (jo.Momentum(beta=0.9, nesterov=True),
                      to.Momentum(beta=0.9, nesterov=True)),
         "adamw": (jo.AdamW(weight_decay=0.01), to.AdamW(weight_decay=0.01))}


def _carried(jopt, topt, n_updates=12, n_workers=3, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    p0 = _tree(rng)
    grads = [_tree(rng, scale) for _ in range(n_updates)]
    workers = rng.integers(0, n_workers, size=n_updates)
    jp, tp = _j(p0), _t(p0)
    js, ts = jopt.init(jp), topt.init(tp)
    jup = jax.jit(jopt.update)
    out_j, out_t = [], []
    for g, w in zip(grads, workers):
        jp, js, jg, jt = jup(jp, _j(g), js, jnp.int32(w))
        tp, ts, tg, tt = topt.update(tp, _t(g), ts, int(w))
        out_j.append((int(jt), np.float32(jg)))
        out_t.append((int(tt), np.float32(tg.numpy())))
    return (jp, js, out_j), (tp, ts, out_t)


@pytest.mark.parametrize("base", sorted(BASES))
@pytest.mark.parametrize("clip", [None, 1.0])
@pytest.mark.parametrize("prox", ["zero", "l1"])
def test_delay_adaptive_optimizer_matches_reference(base, clip, prox):
    jb, tb = BASES[base]
    jprox, tprox = ((JZero(), Zero()) if prox == "zero"
                    else (JL1(lam=1e-2), L1(lam=1e-2)))
    jopt = jo.DelayAdaptiveOptimizer(policy=JA1(gamma_prime=0.4), base=jb,
                                     prox=jprox, grad_clip=clip, n_workers=3,
                                     horizon=64)
    topt = to.DelayAdaptiveOptimizer(policy=Adaptive1(gamma_prime=0.4),
                                     base=tb, prox=tprox, grad_clip=clip,
                                     n_workers=3, horizon=64)
    (jp, js, oj), (tp, ts, ot) = _carried(jopt, topt, scale=3.0)
    assert [t for t, _ in oj] == [t for t, _ in ot]
    assert [g.view(np.int32) for _, g in oj] == \
        [g.view(np.int32) for _, g in ot]
    _close(jp, tp, OPT_REL, "params")
    _close(js, ts, OPT_REL, "state")


@pytest.mark.parametrize("beta,wd,prox", [(0.0, 0.0, "zero"),
                                          (0.9, 0.01, "l1")])
def test_async_sgd_matches_reference(beta, wd, prox):
    jprox, tprox = ((JZero(), Zero()) if prox == "zero"
                    else (JL1(lam=1e-2), L1(lam=1e-2)))
    jopt = JAsyncSGD(policy=JA1(gamma_prime=0.3), prox=jprox, beta=beta,
                     weight_decay=wd, n_workers=3, horizon=64)
    topt = AsyncSGD(policy=Adaptive1(gamma_prime=0.3), prox=tprox, beta=beta,
                    weight_decay=wd, n_workers=3, horizon=64)
    (jp, js, oj), (tp, ts, ot) = _carried(jopt, topt)
    assert [t for t, _ in oj] == [t for t, _ in ot]
    assert [g.view(np.int32) for _, g in oj] == \
        [g.view(np.int32) for _, g in ot]
    _close(jp, tp, OPT_REL, "params")
    _close(js, ts, OPT_REL, "state")


def test_round_robin_delays_and_the_base_rules():
    """The reference's own checks on the port: round robin over 3 workers
    gives tau 2 in steady state, and each base rule minimizes a
    quadratic."""
    def quad_grad(p):
        return {"w": 2.0 * (p["w"] - 2.0)}

    params = {"w": torch.ones(4) * 3}
    opt = to.DelayAdaptiveOptimizer(policy=Adaptive1(gamma_prime=0.4),
                                    prox=L1(lam=1e-3), n_workers=3)
    st, taus = opt.init(params), []
    for k in range(30):
        params, st, gamma, tau = opt.update(params, quad_grad(params), st,
                                            k % 3)
        taus.append(int(tau))
    assert taus[0] == 0 and set(taus[6:]) == {2}
    for rule, lr in ((to.AdamW(), 0.05), (to.Momentum(beta=0.9), 0.02),
                     (to.Sgd(), 0.02)):
        p = {"w": torch.zeros(4)}
        s = rule.init(p)
        for _ in range(400):
            upd, s = rule.update(quad_grad(p), s, p)
            p = to.apply_updates(p, upd, lr)
        assert float(torch.sum((p["w"] - 2.0) ** 2)) < 1e-3


def test_global_norm_and_clip_bitwise():
    rng = np.random.default_rng(3)
    g = _tree(rng, 40.0)
    jn, tn = jo.global_norm(_j(g)), to.global_norm(_t(g))
    assert np.float32(jn).view(np.int32) == tn.numpy().view(np.int32)
    _close(jo.clip_by_global_norm(_j(g), 1.0),
           to.clip_by_global_norm(_t(g), 1.0), 0.0, "clip")
    assert abs(float(to.global_norm(to.clip_by_global_norm(_t(g), 1.0)))
               - 1.0) < 1e-5


@pytest.mark.parametrize("name,args", [
    ("constant", (0.3,)), ("linear_warmup", (1.0, 10)),
    ("cosine", (1.0, 100, 10, 0.1)), ("cosine", (0.5, 50, 0, 0.2))])
def test_schedules_match_reference(name, args):
    jf, tf = jo.SCHEDULES[name](*args), to.SCHEDULES[name](*args)
    for s in (0, 1, 5, 10, 37, 50, 99, 100, 150):
        a = np.float32(jf(jnp.int32(s))).view(np.int32)
        b = tf(torch.tensor(s, dtype=torch.int32)).numpy().view(np.int32)
        assert abs(int(a) - int(b)) <= SCHED_ULPS, (s, a, b)
    assert sorted(to.SCHEDULES) == sorted(jo.SCHEDULES)


def test_make_optimizer_and_names():
    assert sorted(to.optimizers.OPTIMIZERS) == sorted(jo.optimizers.OPTIMIZERS)
    assert to.make_optimizer("momentum", beta=0.5) == to.Momentum(beta=0.5)
    assert to.make_optimizer("adamw").b2 == jo.make_optimizer("adamw").b2


@pytest.mark.parametrize("index", [0, 7, 10_000])
def test_token_stream_bitwise(index):
    j = JToken(vocab=97, batch=3, seq=40, seed=5)
    t = TokenStream(vocab=97, batch=3, seq=40, seed=5, device="cpu")
    a, b = j.batch_at(index), t.batch_at(index)
    for key in ("tokens", "targets"):
        assert b[key].dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(a[key]), b[key].numpy())
    b2 = t.batch_at(index, batch=2, seq=17)
    np.testing.assert_array_equal(np.asarray(j.batch_at(index, 2, 17)["tokens"]),
                                  b2["tokens"].numpy())


@pytest.mark.parametrize("mrope", [False, True])
def test_embed_stream_bitwise(mrope):
    j = JEmbed(d_model=16, vocab=31, batch=2, seq=80, seed=2, mrope=mrope,
               image_grid=(4, 4))
    t = EmbedStream(d_model=16, vocab=31, batch=2, seq=80, seed=2,
                    mrope=mrope, image_grid=(4, 4), device="cpu")
    a, b = j.batch_at(3), t.batch_at(3)
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_array_equal(np.asarray(a[key]), b[key].numpy())


KW = dict(name="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
          head_dim=16, d_ff=128, vocab=97, q_chunk=8,
          attention_impl="chunked")


@pytest.fixture(scope="module")
def model_pair():
    jc = JConfig(**KW)
    jp = j_init(jc, jax.random.PRNGKey(0))
    pn = jax.tree_util.tree_map(np.asarray, jp)
    tree = param_tree(interop.model_params(pn, ModelConfig(**KW),
                                           device="cpu"))
    rng = np.random.default_rng(0)
    tok = rng.integers(0, 97, (2, 32)).astype(np.int32)
    tgt = rng.integers(0, 97, (2, 32)).astype(np.int32)
    return jp, tree, tok, tgt


@pytest.mark.parametrize("ce_chunk", [0, 8])
@pytest.mark.parametrize("pad", [False, True])
def test_loss_fn_and_grads_match_reference(model_pair, ce_chunk, pad):
    """Dense and chunked cross-entropy (padding labels -1 too), the loss
    within ``LOSS_TOL`` and every gradient leaf within ``GRAD_REL``."""
    jp, tree, tok, tgt = model_pair
    if pad:
        tgt = tgt.copy()
        tgt[:, 20:] = -1
    jc = JConfig(**KW, ce_chunk=ce_chunk)
    tc = ModelConfig(**KW, ce_chunk=ce_chunk)
    jb = {"tokens": jnp.asarray(tok), "targets": jnp.asarray(tgt)}
    tb = {"tokens": torch.from_numpy(tok), "targets": torch.from_numpy(tgt)}
    (jl, jm), jg = jax.jit(jax.value_and_grad(lambda p: j_loss(p, jc, jb),
                                              has_aux=True))(jp)
    tl, tm, tg = loss_and_grad(tree, tc, tb)
    assert abs(float(jl) - float(tl)) <= LOSS_TOL
    assert abs(float(jm["ce"]) - float(tm["ce"])) <= LOSS_TOL
    _close(jg, tg, GRAD_REL, "grads")
    with torch.no_grad():
        assert abs(float(loss_fn(tree, tc, tb)[0]) - float(tl)) == 0.0


def test_loss_fn_refuses_pallas_while_training(model_pair):
    _, tree, tok, tgt = model_pair
    cfg = ModelConfig(**{**KW, "attention_impl": "pallas"})
    batch = {"tokens": torch.from_numpy(tok), "targets": torch.from_numpy(tgt)}
    with pytest.raises(ValueError, match="forward-only"):
        loss_and_grad(tree, cfg, batch)
    with torch.no_grad():     # evaluation has no backward to refuse
        assert torch.isfinite(loss_fn(tree, cfg, batch)[0])


def test_train_state_interop_and_checkpoint_layout(model_pair, tmp_path):
    """``interop.train_state`` carries the reference's state after two
    train steps leaf for leaf, and the port's checkpoint of it has the
    reference's keys, shapes and values."""
    jp, _, tok, tgt = model_pair
    jc = JConfig(**KW)
    trainer = j_make_trainer(jc, n_workers=3, lr=3e-3)
    st = JTrainState(params=jp, opt=trainer.optimizer.init(jp))
    batch = {"tokens": jnp.asarray(tok), "targets": jnp.asarray(tgt)}
    step = jax.jit(trainer.train_step)
    for w in (0, 2):
        st, _ = step(st, batch, jnp.int32(w))
    ts = interop.train_state(st, ModelConfig(**KW), device="cpu")
    _close(st, ts, 0.0, "train_state")
    j_save(str(tmp_path / "j.npz"), (st,), {"steps": 2})
    save_checkpoint(str(tmp_path / "t.npz"), (ts,), {"steps": 2})
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "t.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            if k != "__metadata__":
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert os.path.getsize(tmp_path / "t.npz") > 0
