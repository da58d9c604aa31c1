"""The data-parallel step (``launch.steps.rows_loss_and_grad``, through
``launch.run_distributed.sharded_train_step``) on the CPU listed 8 times
at (2, 4): two data-parallel rows, each computing the loss and the
gradients of its half of the batch, batch 8, seq 32, float32.

* Against the port's unsharded step (``Trainer.train_step``) from one
  initial state, for the four archs of ``test_torch_run_distributed.py``
  with the reference trainer's clip of 1.0 (it acts: gradient norms 2-9)
  and with a clip far above the norm: taus exact and gammas bitwise at
  every step; the step-0 loss within ``LOSS0_REL`` of the unsharded one,
  relative; every step-0 gradient leaf within ``GRAD_REL`` of that
  leaf's largest absolute value; the later losses within ``LOSS_REL`` of
  the first; the last state within ``LAST_NORM_REL`` in norm, leaf by
  leaf.  The rows sum the label count, the MoE statistics and the
  gradients in row order, the unsharded step over the whole batch at
  once: a rounding apart (measured: losses 7e-8 of the first, gradients
  7.4e-7 of a leaf's max).  Every MoE layer's dropped (token, slot) count
  equals the unsharded step's at every step.
* The same in bf16 (D1's dtype) for reduced qwen2-moe-a2.7b: the step-0
  loss within ``LOSS0_REL`` and the dropped counts of step 0 equal; each
  row's bf16 gradient is rounded once and their sum again, where the
  unsharded step rounds once (36% of the step-0 gradient elements differ,
  by up to 0.6% of a leaf's max), and the capacity routing follows the
  parameters: the later losses measured 1.72e-4 of the first apart,
  held to ``BF16_LOSS_REL`` (ROADMAP queue C).
* The capacity MoE block across slices: slicing with each slice's own
  capacity and slots (the naive split) keeps other (token, slot) pairs
  than the whole batch, and the port's slices, given the whole batch's
  token count and the earlier slices' per-expert offsets, keep exactly
  the whole batch's pairs: the same y bitwise, the same dropped count,
  and the balance term composed from the slices' statistics within
  ``AUX_REL`` of the whole batch's.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.core.pytree import tree_leaves
from repro_torch.launch import run_distributed as rd
from repro_torch.launch.steps import (data_parallel_loss_and_grad,
                                      loss_and_grad, make_trainer)
from repro_torch.launch.train import make_stream
from repro_torch.mesh import batch_shardings, device_put, gather, make_mesh
from repro_torch.models.moe import (MoeSlice, _route, moe_block,
                                    moe_block_capacity, moe_params)
from repro_torch.models.transformer import (compose_loss, loss_parts,
                                            moe_layer_count)

ARCHS = ["qwen2-moe-a2.7b", "mamba2-780m", "deepseek-v2-236b", "qwen2.5-32b"]
STEPS, BATCH, SEQ = 3, 8, 32
LOSS0_REL = 1e-6       # step-0 loss, relative to the unsharded one
GRAD_REL = 1e-5        # step-0 gradient, of each leaf's max |grad|
LOSS_REL = 1e-6        # later losses, of the first
LAST_NORM_REL = 1e-2   # the last state, leaf by leaf in norm
AUX_REL = 1e-6         # the composed balance term, relative
BF16_LOSS_REL = 5e-4   # bf16 later losses, of the first (measured 1.72e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh((2, 4), devices=["cpu"] * 8)


def _bits(t):
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


def _dropped(params, cfg, batch):
    """Each MoE layer's dropped (token, slot) pairs over the whole batch."""
    with torch.no_grad():
        parts = loss_parts(params, cfg, batch)
    return [int(s.dropped) for s in parts.moe]


@pytest.mark.parametrize("clip", [1.0, 1e9], ids=["clip", "noclip"])
@pytest.mark.parametrize("arch", ARCHS)
def test_dp_step_matches_unsharded(arch, clip, mesh):
    cfg = get_config(arch).reduced().replace(attention_impl="chunked")
    trainer = make_trainer(cfg, n_workers=2, lr=1e-3, grad_clip=clip)
    plain = trainer.init(device="cpu")
    sharded = rd.shard_state(trainer.init(device="cpu"), mesh)
    stream = make_stream(cfg, BATCH, SEQ, device="cpu")

    b0 = stream.batch_at(0)
    _, _, want = loss_and_grad(plain.params, cfg, b0)
    _, _, got = data_parallel_loss_and_grad(plain.params, cfg, b0, mesh)
    gnorm = float(torch.sqrt(sum(torch.sum(g * g)
                                 for g in tree_leaves(want))))
    assert (gnorm > clip) == (clip == 1.0)        # the clip acts, or not
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert float((a - b).abs().max()) <= GRAD_REL * float(
            b.abs().max())

    losses = []
    with mesh:
        for k in range(STEPS):
            b = stream.batch_at(k)
            drops = _dropped(plain.params, cfg, b)
            plain, m = trainer.train_step(plain, b, k % 2)
            sharded, ms = rd.sharded_train_step(
                trainer, sharded, device_put(b, batch_shardings(b, mesh,
                                                                BATCH)),
                k % 2)
            assert int(ms["tau"]) == int(m["tau"])
            assert _bits(ms["gamma"]) == _bits(m["gamma"])
            assert [int(v) for v in ms["dropped"]] == drops
            assert len(drops) == moe_layer_count(cfg)
            losses.append((float(m["loss"]), float(ms["loss"])))
    first = abs(losses[0][0])
    assert abs(losses[0][1] - losses[0][0]) <= LOSS0_REL * first
    for want_l, got_l in losses[1:]:
        assert abs(got_l - want_l) <= LOSS_REL * first
    got_state = [gather(x, "cpu") for x in
                 tree_leaves(sharded.params) + tree_leaves(sharded.opt.inner)]
    for a, b in zip(got_state, tree_leaves(plain.params)
                    + tree_leaves(plain.opt.inner)):
        assert torch.linalg.vector_norm(a.float() - b.float()) <= \
            LAST_NORM_REL * torch.linalg.vector_norm(b.float())


def test_dp_step_in_bf16_holds_its_envelope(mesh):
    cfg = get_config("qwen2-moe-a2.7b").reduced().replace(
        param_dtype="bfloat16", compute_dtype="bfloat16")
    trainer = make_trainer(cfg.replace(attention_impl="chunked"),
                           n_workers=2, lr=1e-3)
    stream = make_stream(cfg, BATCH, SEQ, device="cpu")
    state = trainer.init(device="cpu")
    plain = []
    for k in range(STEPS):
        b = stream.batch_at(k)
        drops = _dropped(state.params, trainer.cfg, b)
        state, m = trainer.train_step(state, b, k % 2)
        plain.append((float(m["loss"]), _bits(m["gamma"]), int(m["tau"]),
                      drops))
    _, log = rd.run(cfg, mesh, STEPS, BATCH, SEQ, device="cpu")
    first = abs(plain[0][0])
    assert abs(log[0]["loss"] - plain[0][0]) <= LOSS0_REL * first
    assert log[0]["dropped"] == plain[0][3]
    for r, (loss, gamma, tau, _) in zip(log, plain):
        assert r["tau"] == tau
        assert _bits(torch.tensor(r["gamma"], dtype=torch.float32)) == gamma
        assert abs(r["loss"] - loss) <= BF16_LOSS_REL * first


def test_dp_loss_needs_a_batch_that_divides(mesh):
    cfg = get_config("qwen2.5-32b").reduced().replace(
        attention_impl="chunked")
    params = make_trainer(cfg).init(device="cpu").params
    batch = make_stream(cfg, 3, SEQ, device="cpu").batch_at(0)
    with pytest.raises(ValueError, match="divide"):
        data_parallel_loss_and_grad(params, cfg, batch, mesh)


# ------------------------------------------------ capacity across slices

def _moe_case():
    """A reduced qwen2-moe-a2.7b MoE layer (E 4, k 2) on 64 tokens whose
    router favours expert 0 on the first half and expert 3 on the
    second: at capacity factor 1 the whole batch (C 32) and each half
    alone (C 16) drop different pairs."""
    cfg = get_config("qwen2-moe-a2.7b").reduced()
    p = moe_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((4, 16, cfg.d_model))
                         .astype(np.float32))
    to_logits = torch.linalg.pinv(p["router"])          # (E, D)
    x[:2] += 3.0 * to_logits[0]
    x[2:] += 3.0 * to_logits[3]
    return cfg, p, x


def _kept(top_i, C, offsets=None, E=4):
    """The (token, expert) pairs that get a slot below ``C``: slots in
    token-major order, after ``offsets`` (per expert) where given."""
    used = [0 if offsets is None else int(offsets[e]) for e in range(E)]
    kept = set()
    for t in range(top_i.shape[0]):
        for e in top_i[t].tolist():
            if used[e] < C:
                kept.add((t, e))
            used[e] += 1
    return kept


def test_capacity_slices_keep_the_whole_batchs_pairs():
    cfg, p, x = _moe_case()
    cf = 1.0
    E, k = cfg.n_experts, cfg.top_k
    B, S, D = x.shape
    T, halves = B * S, (x[:2], x[2:])
    C, C_half = int(T * k / E * cf), int(T // 2 * k / E * cf)
    with torch.no_grad():
        top = [_route(h.reshape(-1, D) @ p["router"], k)[2] for h in halves]
        whole = torch.cat(top)
        want_kept = _kept(whole, C)
        y_whole, st_whole = moe_block_capacity(p, x, cfg, cf,
                                               ctx=MoeSlice(T))

        # the naive split: each half with its own capacity and slots
        naive = _kept(top[0], C_half) | {
            (t + T // 2, e) for t, e in _kept(top[1], C_half)}
        assert naive != want_kept
        y_naive = torch.cat([moe_block_capacity(p, h, cfg, cf)[0]
                             for h in halves])
        assert not torch.equal(y_naive, y_whole)

        # the port's slices: the whole batch's C, the first half's offsets
        y0, st0 = moe_block_capacity(p, halves[0], cfg, cf, ctx=MoeSlice(T))
        y1, st1 = moe_block_capacity(p, halves[1], cfg, cf,
                                     ctx=MoeSlice(T, st0.counts))
    got_kept = _kept(top[0], C) | {(t + T // 2, e) for t, e in
                                   _kept(top[1], C, st0.counts)}
    assert got_kept == want_kept
    assert int(st0.dropped) + int(st1.dropped) == int(st_whole.dropped) \
        == len(whole.reshape(-1)) - len(want_kept) > 0
    assert torch.equal(st0.counts + st1.counts, st_whole.counts)
    assert torch.equal(torch.cat([y0, y1]), y_whole)
    # the offsets may also come from a function of the slice's counts
    with torch.no_grad():
        y1f, _ = moe_block_capacity(
            p, halves[1], cfg, cf,
            ctx=MoeSlice(T, lambda counts: st0.counts))
    assert torch.equal(y1f, y1)

    # the balance term of the whole batch from the slices' statistics
    aux = E * torch.sum(((st0.counts + st1.counts).float() / T)
                        * ((st0.probsum + st1.probsum) / T))
    assert abs(float(aux) - float(st_whole.aux)) <= AUX_REL * abs(
        float(st_whole.aux))


def test_without_a_slice_the_blocks_are_unchanged():
    """No context: (y, aux) as before; a one-slice context adds the
    statistics and changes neither."""
    cfg, p, x = _moe_case()
    with torch.no_grad():
        for block in (moe_block_capacity, moe_block):
            y, aux = block(p, x, cfg)
            y_s, st = block(p, x, cfg, ctx=MoeSlice(x.shape[0] * x.shape[1]))
            assert torch.equal(y, y_s) and torch.equal(aux, st.aux)
            chosen = F.one_hot(_route(x.reshape(-1, x.shape[-1])
                                      @ p["router"], cfg.top_k)[2],
                               cfg.n_experts).sum(dim=(0, 1))
            assert torch.equal(st.counts, chosen)


def test_slice_losses_sum_to_the_batch_loss(mesh):
    """``compose_loss`` of each half within the summed parts adds up to
    the whole batch's loss; the dp step's aux within ``AUX_REL``."""
    cfg = get_config("qwen2-moe-a2.7b").reduced().replace(
        attention_impl="chunked")
    params = make_trainer(cfg).init(device="cpu").params
    batch = make_stream(cfg, BATCH, SEQ, device="cpu").batch_at(0)
    with torch.no_grad():
        want, wparts = compose_loss(cfg, *[loss_parts(params, cfg, batch)] * 2)
        loss, metrics, _ = data_parallel_loss_and_grad(params, cfg, batch,
                                                       mesh)
    assert abs(float(loss) - float(want)) <= LOSS0_REL * abs(float(want))
    assert abs(float(metrics["aux"]) - float(wparts["aux"])) <= \
        AUX_REL * abs(float(wparts["aux"]))
