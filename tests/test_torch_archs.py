"""The ``.reduced()`` config of every architecture on the port, on the CPU.

* All ten ``ARCH_IDS``, as ``tests/test_arch_smoke.py:33`` runs them:
  the port's own model (``init_params``), ``forward`` on the arch's
  batch (tokens, or ``EmbedStream`` embeddings for the audio and VLM
  frontends) gives finite logits of shape (B, S, vocab), and where
  ``has_decode`` a prefill into a longer cache and three decode steps
  give finite logits.
* The four archs of the MLA, hybrid, audio and VLM paths
  (deepseek-v2-236b, zamba2-2.7b, hubert-xlarge, qwen2-vl-72b) on the
  reference's parameters: ``forward`` within 1e-4 of the reference's
  logits, ``loss_fn`` and its gradients (``torch.autograd`` through the
  reference-layout tree) within 1e-5 of ``jax.grad``'s, and the
  parameter tree both ways (``interop.model_tree`` gives back the
  reference's tree, ``models.param_tree`` holds the same leaves, and
  ``interop.model_params`` refuses a tree missing a leaf).

Float32, the reference's ``"chunked"`` attention on both sides where
gradients are taken (the kernel has no backward).  The loss is a mean of
~log(vocab) ~ 6; its gradients are small (<~0.1), so 1e-5 absolute
holds the float32 sums of the two packages in other orders.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.data import EmbedStream as JEmbedStream
from repro.data import TokenStream as JTokenStream
from repro.models import forward as j_forward
from repro.models import init_params as j_init_params
from repro.models import loss_fn as j_loss_fn
from repro_torch import interop
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import (ModelConfig, decode_step, forward,
                                init_params, loss_fn, param_tree, prefill)

B, S = 2, 16
NEW_ARCHS = ("deepseek-v2-236b", "zamba2-2.7b", "hubert-xlarge",
             "qwen2-vl-72b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch_np(cfg) -> dict:
    """``tests/test_arch_smoke.py``'s batch for ``cfg`` as numpy."""
    if cfg.embed_inputs:
        stream = JEmbedStream(d_model=cfg.d_model, vocab=cfg.vocab, batch=B,
                              seq=S, mrope=cfg.rope == "mrope")
    else:
        stream = JTokenStream(vocab=cfg.vocab, batch=B, seq=S)
    return {n: np.array(a) for n, a in stream.batch_at(0).items()}


def _inputs(batch: dict) -> dict:
    return {n: a for n, a in batch.items() if n != "targets"}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_reduced_forward_and_decode(arch):
    cfg = get_config(arch).reduced()
    assert cfg.n_layers == 2 and cfg.d_model <= 512 and cfg.n_experts <= 4
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = {n: torch.from_numpy(a) for n, a in _batch_np(cfg).items()}
    logits, aux = forward(model, cfg, _inputs(batch))
    assert tuple(logits.shape) == (B, S, cfg.vocab), arch
    assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(aux))
    if cfg.has_decode:
        last, cache = prefill(model, cfg, _inputs(batch), max_len=S + 3)
        tok = torch.argmax(last[:, -1:], dim=-1).to(torch.int32)
        for pos in range(S, S + 3):
            last, cache = decode_step(model, cfg, cache, tok, pos)
            assert tuple(last.shape) == (B, 1, cfg.vocab), arch
            assert bool(torch.isfinite(last).all()), arch
            tok = torch.argmax(last[:, -1:], dim=-1).to(torch.int32)


@pytest.fixture(scope="module", params=NEW_ARCHS)
def carried(request):
    jcfg = j_get_config(request.param).reduced()
    jp = jax.jit(j_init_params, static_argnums=0)(jcfg, jax.random.PRNGKey(5))
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    assert tcfg.attention_impl == "chunked"
    jnp_tree = jax.tree_util.tree_map(np.asarray, jp)
    model = interop.model_params(jnp_tree, tcfg, device="cpu")
    return jcfg, jp, jnp_tree, tcfg, model


def test_new_arch_forward_loss_and_grads_match_reference(carried):
    jcfg, jp, _, tcfg, model = carried
    batch = _batch_np(jcfg)
    jl, jaux = jax.jit(lambda p, b: j_forward(p, jcfg, b))(
        jp, {n: jnp.asarray(a) for n, a in _inputs(batch).items()})
    tb = {n: torch.from_numpy(a) for n, a in batch.items()}
    tl, taux = forward(model, tcfg, _inputs(tb))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    assert abs(float(taux) - float(jaux)) <= 1e-6

    jbatch = {n: jnp.asarray(a) for n, a in batch.items()}
    (jloss, jparts), jgrad = jax.jit(jax.value_and_grad(
        lambda p: j_loss_fn(p, jcfg, jbatch), has_aux=True))(jp)
    tree = param_tree(model)
    leaves = [t.requires_grad_() for t in jax.tree_util.tree_leaves(tree)]
    tloss, tparts = loss_fn(tree, tcfg, tb)
    # a VLM's token table takes no gradient from embeddings (jax.grad: 0)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(
        leaves, torch.autograd.grad(tloss, leaves, allow_unused=True))]
    assert abs(float(tloss.detach()) - float(jloss)) <= 1e-5
    assert abs(float(tparts["ce"].detach()) - float(jparts["ce"])) <= 1e-5
    want = jax.tree_util.tree_leaves(jgrad)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_leaves_with_path(jgrad)]
    assert len(want) == len(grads)
    for path, g, w in zip(paths, grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   err_msg=path)


def test_new_arch_param_tree_both_ways(carried):
    jcfg, jp, jnp_tree, tcfg, model = carried
    got = interop.model_tree(model)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(jnp_tree)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(jnp_tree)):
        np.testing.assert_array_equal(a, b)
    tree = param_tree(model)
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(jnp_tree)
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(jnp_tree)):
        np.testing.assert_array_equal(a.numpy(), b)
    # a missing leaf, a misshapen one, or an extra top-level entry is
    # refused (in the shared block of a hybrid model, else in the layers)
    part = "shared" if "shared" in jnp_tree else "layers"
    sub = next(iter(jnp_tree[part]))
    leaves = jnp_tree[part][sub]
    name = next(iter(leaves))
    for bad_leaves, match in (
            ({n: a for n, a in leaves.items() if n != name}, "do not match"),
            (dict(leaves, **{name: leaves[name][..., :-1]}), "shape")):
        bad = dict(jnp_tree, **{part: dict(jnp_tree[part],
                                           **{sub: bad_leaves})})
        with pytest.raises(ValueError, match=match):
            interop.model_params(bad, tcfg, device="cpu")
    with pytest.raises(ValueError, match="parameter tree has"):
        interop.model_params(dict(jnp_tree, extra={}), tcfg, device="cpu")
