"""The tensor-parallel sharded step (``models.tensor_parallel`` through
``launch.run_distributed.sharded_train_step``) on the CPU listed at every
position of (1, 2), (1, 4), (2, 2) and (2, 4) ("data", "model") meshes,
batch 8 x 32: each data-parallel row's "model" positions compute with
their own blocks of the plan (column-parallel q / k / v, w1 / w3 and
logits, row-parallel products summed in position order, expert-parallel
capacity MoE, the vocab-parallel embedding).

* Against the port's unsharded step (``Trainer.train_step``) from one
  initial state, for the configs of ``_torch_tp_cases.CASES``: reduced
  qwen2-moe-a2.7b, reduced qwen2.5-32b with two kv heads (so that, as at
  full width, its k / v projections are cut on D and are row-parallel;
  its query heads fold onto them as the GQA fold reads them), and MLA
  with DeepSeek's MoE (deepseek-v2), the VLM (qwen2-vl, image
  embeddings and M-RoPE grids) and the encoder (hubert, bidirectional,
  LayerNorm) each in two layouts (reduced, and a reduced config cut on
  the full config's dims), float32, with the reference trainer's
  clip (it acts) and, at (2, 4), a clip far above the norm: taus exact
  and gammas bitwise at every step, the step-0 loss within ``LOSS0_REL``
  of the unsharded one, every step-0 gradient leaf within ``GRAD_REL``
  of its largest absolute value (the VLM's k bias, a sum that cancels,
  within that plus twice either step's float32 noise floor, read on the
  elements that are zero in exact arithmetic: ``_still_sections``),
  the later losses within ``LOSS_REL`` of the first, the step-0
  dropped (token, slot) counts equal.
* The same in bf16 for qwen2-moe: the step-0 loss within
  ``BF16_LOSS0_REL`` and the later losses within ``BF16_LOSS_REL`` of
  the first (measured: step 0 up to 1.25e-6 at (1, 2) and (2, 2), later
  up to 3.7e-4; a row-parallel product's float32 partial sums, rounded
  once, round a few elements to the other neighbouring bf16 value, where
  the data-parallel step changes nothing at step 0: ROADMAP queue C).
* Against the reference's unsharded jitted step from the reference's
  initial state carried across (``interop.train_state``) and its
  stream: taus exact, gammas bitwise, losses within ``REF_LOSS_REL`` of
  the first.
* On (2, 1) (a model axis of 1) the tensor-parallel route is bitwise
  the row-gathered route; on (2, 4) two runs are bitwise alike (each
  block's gradient contributions sum in one order).
* The route by family; a plan that cuts a query column block through a
  head raises, and so does a decode step on tensor-parallel leaves; no
  position holds a whole leaf but the small ones the step gathers by
  rule (norm scales and LayerNorm biases, row-parallel k / v biases, the
  router, MLA's q / kv norms), by the bytes each position holds and by
  the leaves gathered whole during a step; each ``*-full-cut`` config's
  plan cuts every leaf on its full config's dim.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.launch.steps import make_trainer as j_make_trainer
from repro.launch.train import make_stream as j_make_stream
from _torch_tp_cases import CASES, FULL_CUT, tp_cfg
from repro_torch import interop
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.pytree import tree_flatten_with_path, tree_leaves
from repro_torch.launch import run_distributed as rd
from repro_torch.launch.steps import (data_parallel_loss_and_grad,
                                      loss_and_grad, make_trainer,
                                      model_blocks)
from repro_torch.launch.train import make_stream
from repro_torch.mesh import (AbstractMesh, batch_shardings, device_put,
                              gather, make_mesh, model_dim, param_shardings)
from repro_torch.models import attention, init_params, param_specs, \
    param_tree
from repro_torch.models import tensor_parallel as tp
from repro_torch.models.transformer import loss_parts, moe_layer_count

STEPS, BATCH, SEQ = 3, 8, 32
LOSS0_REL = 1e-6        # step-0 loss, relative to the unsharded one
GRAD_REL = 1e-5         # step-0 gradient, of each leaf's max |grad|
LOSS_REL = 1e-6         # later losses, of the first
BF16_LOSS0_REL = 5e-6   # bf16 step-0 loss (measured up to 1.25e-6)
BF16_LOSS_REL = 5e-4    # bf16 later losses, of the first (measured 3.7e-4)
REF_LOSS_REL = 1e-4     # against the reference's unsharded step
MESHES = [(1, 2), (1, 4), (2, 2), (2, 4)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(case, **over):
    return tp_cfg(case, attention_impl="chunked", **over)


def _mesh(shape):
    return make_mesh(shape, devices=["cpu"] * int(np.prod(shape)))


def _bits(t):
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


def _dropped(params, cfg, batch):
    with torch.no_grad():
        return [int(s.dropped) for s in loss_parts(params, cfg, batch).moe]


def _still_sections(cfg, positions) -> torch.Tensor:
    """The k-bias elements (every kv head's dims) of the M-RoPE sections
    whose position stream is one value over the whole batch (the reduced
    rows are image patches at t = 0).  The softmax's gradient sums to
    zero over a query's keys, so the k bias reaches the loss only through
    the rotation's differences between keys: its step-0 gradient is a
    sum that cancels (float32 leaves noise of ~1e-9 on every element,
    above 1e-5 of the leaf's max; ROADMAP queue C) and is zero in exact
    arithmetic on these elements, where every key's rotation is the same.
    What either step computes there is its noise floor."""
    hd, half = cfg.head_dim, cfg.head_dim // 2
    still = torch.zeros(hd, dtype=torch.bool)
    lo = 0
    for i, n in enumerate(cfg.mrope_sections):
        if bool((positions[i] == positions[i].flatten()[0]).all()):
            still[lo:lo + n] = still[half + lo:half + lo + n] = True
        lo += n
    assert still.any()
    return still.repeat(cfg.n_kv_heads)


def _compare(cfg, mesh, clip, grads=True):
    """Both steps ``STEPS`` times from one initial state; the unsharded
    and the sharded losses, checking taus, gammas, the step-0 dropped
    counts and (``grads``) the step-0 gradients on the way."""
    n = mesh.shape["data"]
    trainer = make_trainer(cfg, n_workers=n, lr=1e-3, grad_clip=clip)
    plain = trainer.init(device="cpu")
    sharded = rd.shard_state(trainer.init(device="cpu"), mesh)
    stream = make_stream(cfg, BATCH, SEQ, device="cpu")
    b0 = stream.batch_at(0)
    if grads:
        _, _, want = loss_and_grad(plain.params, cfg, b0)
        _, _, got = data_parallel_loss_and_grad(plain.params, cfg, b0, mesh)
        flat, _ = tree_flatten_with_path(want)
        for (path, b), a in zip(flat, tree_leaves(got)):
            assert a.shape == b.shape
            env = GRAD_REL * float(b.abs().max())
            if path[-1].key == "bk" and cfg.rope == "mrope":
                still = _still_sections(cfg, b0["positions"])
                env += 2 * max(float(a[..., still].abs().max()),
                               float(b[..., still].abs().max()))
            assert float((a - b).abs().max()) <= env
    losses = []
    with mesh:
        for k in range(STEPS):
            b = stream.batch_at(k)
            drops = _dropped(plain.params, cfg, b)
            plain, m = trainer.train_step(plain, b, k % n)
            sharded, ms = rd.sharded_train_step(
                trainer, sharded, device_put(b, batch_shardings(b, mesh,
                                                                BATCH)),
                k % n)
            assert int(ms["tau"]) == int(m["tau"])
            assert _bits(ms["gamma"]) == _bits(m["gamma"])
            assert len(ms["dropped"]) == moe_layer_count(cfg)
            if k == 0:
                assert [int(v) for v in ms["dropped"]] == drops
            assert ms["exchanged_bytes"] > 0
            losses.append((float(m["loss"]), float(ms["loss"])))
    return losses


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", sorted(CASES))
def test_tp_step_matches_unsharded_under_the_clip(arch, shape):
    losses = _compare(_cfg(arch), _mesh(shape), clip=1.0)
    first = abs(losses[0][0])
    assert abs(losses[0][1] - losses[0][0]) <= LOSS0_REL * first
    for want, got in losses[1:]:
        assert abs(got - want) <= LOSS_REL * first


@pytest.mark.parametrize("arch", sorted(CASES))
def test_tp_step_matches_unsharded_without_the_clip(arch):
    losses = _compare(_cfg(arch), _mesh((2, 4)), clip=1e9)
    first = abs(losses[0][0])
    assert abs(losses[0][1] - losses[0][0]) <= LOSS0_REL * first
    for want, got in losses[1:]:
        assert abs(got - want) <= LOSS_REL * first


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_tp_step_in_bf16_holds_its_envelope(shape):
    cfg = _cfg("qwen2-moe-a2.7b", param_dtype="bfloat16",
               compute_dtype="bfloat16")
    losses = _compare(cfg, _mesh(shape), clip=1.0, grads=False)
    first = abs(losses[0][0])
    assert abs(losses[0][1] - losses[0][0]) <= BF16_LOSS0_REL * first
    for want, got in losses[1:]:
        assert abs(got - want) <= BF16_LOSS_REL * first


@pytest.mark.parametrize("arch", sorted(CASES))
def test_tp_step_matches_reference_unsharded_step(arch):
    """From the reference's ``Trainer.init`` carried across, at (1, 4)."""
    mesh = _mesh((1, 4))
    name, over = CASES[arch]
    jcfg = jconfigs.get_config(name).reduced().replace(**over)
    tcfg = _cfg(arch)
    jtr = j_make_trainer(jcfg, n_workers=1, lr=1e-3)
    jstate = jtr.init(jax.random.PRNGKey(0))
    trainer = make_trainer(tcfg, n_workers=1, lr=1e-3)
    state = rd.shard_state(
        interop.train_state(jax.tree_util.tree_map(np.asarray, jstate), tcfg,
                            device="cpu"), mesh)
    jstream = j_make_stream(jcfg, BATCH, SEQ)
    stream = make_stream(tcfg, BATCH, SEQ, device="cpu")
    jstep = jax.jit(jtr.train_step)
    jl, tl = [], []
    with mesh:
        for k in range(STEPS):
            jstate, jm = jstep(jstate, jstream.batch_at(k), jnp.int32(0))
            b = stream.batch_at(k)
            state, m = rd.sharded_train_step(
                trainer, state, device_put(b, batch_shardings(b, mesh,
                                                              BATCH)), 0)
            assert int(m["tau"]) == int(jm["tau"])
            assert np.float32(jm["gamma"]).view(np.int32) == \
                np.float32(float(m["gamma"])).view(np.int32)
            jl.append(float(jm["loss"]))
            tl.append(float(m["loss"]))
    assert np.abs(np.array(jl) - np.array(tl)).max() <= \
        REF_LOSS_REL * abs(jl[0])


def _state_after(cfg, mesh):
    trainer = make_trainer(cfg, n_workers=mesh.shape["data"], lr=1e-3)
    state = rd.shard_state(trainer.init(device="cpu"), mesh)
    stream = make_stream(cfg, BATCH, SEQ, device="cpu")
    trace = []
    with mesh:
        for k in range(STEPS):
            b = stream.batch_at(k)
            state, m = rd.sharded_train_step(
                trainer, state, device_put(b, batch_shardings(b, mesh,
                                                              BATCH)),
                k % mesh.shape["data"])
            trace.append((_bits(m["loss"]), _bits(m["gamma"]),
                          int(m["tau"])))
    leaves = [gather(x, "cpu") for x in tree_leaves(state.params)
              + tree_leaves(state.opt.inner)]
    return trace, leaves


def _same(a, b):
    (ta, la), (tb, lb) = a, b
    assert ta == tb
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(_bits(x), _bits(y))


def test_tp_route_on_a_model_axis_of_one_is_the_row_gathered_route(
        monkeypatch):
    cfg = _cfg("qwen2-moe-a2.7b")
    mesh = _mesh((2, 1))
    assert tp.route(cfg) == tp.TENSOR_PARALLEL
    on_tp = _state_after(cfg, mesh)
    monkeypatch.setattr(tp, "route", lambda cfg: tp.ROW_GATHERED)
    _same(on_tp, _state_after(cfg, mesh))


def test_tp_step_is_deterministic():
    """Two runs of (2, 4), where both rows share every block (the card or
    the CPU listed at every position): bitwise alike."""
    cfg = _cfg("qwen2-moe-a2.7b")
    _same(_state_after(cfg, _mesh((2, 4))), _state_after(cfg, _mesh((2, 4))))


def test_route_by_family():
    routes = {a: tp.route(get_config(a)) for a in ARCH_IDS}
    assert {a for a, r in routes.items() if r == tp.TENSOR_PARALLEL} == {
        "qwen2.5-32b", "qwen2-moe-a2.7b", "yi-34b", "starcoder2-15b",
        "nemotron-4-15b", "deepseek-v2-236b", "qwen2-vl-72b",
        "hubert-xlarge"}
    assert {a for a, r in routes.items() if r == tp.ROW_GATHERED} == {
        "mamba2-780m", "zamba2-2.7b"}


def _cut_dims(cfg, mesh):
    """Each parameter leaf's dim cut over "model" under ``mesh``'s
    plan."""
    specs = param_specs(cfg)
    flat, _ = tree_flatten_with_path(specs)
    return {tuple(str(getattr(k, "key", k)) for k in path):
            model_dim(sh, len(leaf.shape))
            for (path, leaf), sh in zip(
                flat, tree_leaves(param_shardings(specs, AbstractMesh(
                    mesh, ("data", "model")))))}


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", sorted(FULL_CUT))
def test_full_cut_configs_cut_as_the_full_configs(arch, shape):
    """Leaf for leaf, the ``-full-cut`` config's plan cuts the dim the
    full config's cuts, where the reduced config's differs somewhere."""
    full = _cut_dims(get_config(arch), shape)
    assert _cut_dims(_cfg(f"{arch}-full-cut"), shape) == full
    assert _cut_dims(_cfg(arch), shape) != full


def _step_raises_through_a_head(arch, m):
    cfg = _cfg(arch)
    mesh = _mesh((1, m))
    trainer = make_trainer(cfg, n_workers=1, lr=1e-3)
    state = rd.shard_state(trainer.init(device="cpu"), mesh)
    b = make_stream(cfg, BATCH, SEQ, device="cpu").batch_at(0)
    with mesh, pytest.raises(ValueError, match="whole heads"):
        rd.sharded_train_step(trainer, state, device_put(
            b, batch_shardings(b, mesh, BATCH)), 0)


def test_a_column_block_through_a_head_raises():
    """Reduced qwen2-moe on a model axis of 8: wq's 256 columns cut into
    blocks of 32, half a head of 64."""
    _step_raises_through_a_head("qwen2-moe-a2.7b", 8)


def test_an_mla_query_block_through_a_head_raises():
    """The full-cut MLA config on a model axis of 16: wq_b's 512 columns
    cut into blocks of 32, half a head of 48 + 16."""
    _step_raises_through_a_head("deepseek-v2-236b-full-cut", 16)


def test_dense_moe_oracle_is_not_tensor_parallel():
    cfg = _cfg("qwen2-moe-a2.7b", moe_impl="dense")
    mesh = _mesh((1, 2))
    trainer = make_trainer(cfg, n_workers=1, lr=1e-3)
    state = rd.shard_state(trainer.init(device="cpu"), mesh)
    b = make_stream(cfg, BATCH, SEQ, device="cpu").batch_at(0)
    with mesh, pytest.raises(ValueError, match="not tensor-parallel"):
        rd.sharded_train_step(trainer, state, device_put(
            b, batch_shardings(b, mesh, BATCH)), 0)


@pytest.mark.parametrize("arch", sorted(CASES))
def test_no_position_holds_a_whole_leaf(arch, monkeypatch):
    """Each position of a (2, 4) row holds its "model" block of every
    leaf: a quarter of it (every leaf of these configs is cut over
    "model"), so a quarter of the parameters' bytes; during a step the
    leaves gathered whole are only norm scales and LayerNorm biases, the
    biases of row-parallel k / v, the router and MLA's q / kv norms."""
    cfg = _cfg(arch)
    mesh = _mesh((2, 4))
    trainer = make_trainer(cfg, n_workers=2, lr=1e-3)
    state = rd.shard_state(trainer.init(device="cpu"), mesh)
    on = rd.gather_params(state, cfg)
    whole_bytes = sum(int(np.prod(s.shape)) * s.dtype.itemsize
                      for s in tree_leaves(state.params))
    for row in on.values():
        leaves = tree_leaves(row)
        assert all(isinstance(x, tp.TpLeaf) and x.dim is not None
                   for x in leaves)
        held = [sum(x.blocks[p].numel() * x.blocks[p].element_size()
                    for x in leaves) for p in range(4)]
        assert held == [whole_bytes // 4] * 4
        for x in leaves:
            assert all(b.numel() * 4 == int(np.prod(x.shape))
                       for b in x.blocks)
    gathered = []
    leaf_whole = tp.whole

    def spy(v):
        if isinstance(v, tp.TpLeaf) and v.dim is not None:
            gathered.append(v.shape)
        return leaf_whole(v)
    for mod in ("repro_torch.models.layers", "repro_torch.models.moe",
                "repro_torch.models.attention"):
        monkeypatch.setattr(f"{mod}.whole", spy)
    monkeypatch.setattr(tp, "whole", spy)
    b = make_stream(cfg, BATCH, SEQ, device="cpu").batch_at(0)
    with mesh:
        rd.sharded_train_step(trainer, state, device_put(
            b, batch_shardings(b, mesh, BATCH)), 0)
    small = {(cfg.d_model,), (cfg.n_kv_heads * cfg.head_dim,),
             (cfg.d_model, cfg.n_experts), (cfg.q_lora_rank,),
             (cfg.kv_lora_rank,)}
    assert gathered and set(gathered) <= small


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "deepseek-v2-236b",
                                  "deepseek-v2-236b-full-cut"])
def test_a_tensor_parallel_decode_step_raises(arch):
    """GQA's and MLA's decode steps refuse a row's tensor-parallel
    leaves (the sharded decode is a later item)."""
    cfg = _cfg(arch)
    mesh = _mesh((1, 2))
    tree = param_tree(init_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu"))
    row = model_blocks(device_put(tree, param_shardings(tree, mesh)),
                       mesh)[0]
    p = {n: leaf[0] for n, leaf in row["layers"]["attn"].items()}
    x = torch.zeros((1, 1, cfg.d_model))
    cache = attention.init_cache(cfg, 1, 4, ring=False, device="cpu")
    with pytest.raises(ValueError, match="tensor-parallel decode"):
        attention.attention_block(p, x, cfg, None, None, "decode",
                                  cache=cache, pos=0)
