"""The dry run's per-position counts of the tensor-parallel step
(``launch.dryrun.sharded_step_costs``), on ``meta`` tensors for the
configs of ``_torch_tp_cases.CASES`` (reduced qwen2-moe-a2.7b, reduced
qwen2.5-32b with two kv heads, and MLA with DeepSeek's MoE, the VLM and
the encoder, each reduced and cut on its full config's dims), float32,
batch 8 x 32, on (1, 4) and (2, 4), without remat (with it, the
checkpoint's recompute stops after the last saved tensor it needs, which
falls after the other positions' partial products of a layer's last
row-parallel product).  Exact identities:

* each position's counted matmul-class FLOPs of the rows' loss and
  gradients equal the row-gathered step's, less the FLOPs the rows
  compute whole (the router's logits), over the model size: every cut
  product's forward and backward split in four;
* the bytes a row's positions exchange equal the sizes of the
  activations the products gather or sum, as the plan cuts each
  product (``_exchanged``): the embedding's rows (token inputs), the
  row-parallel partial sums (float32) and the column-parallel outputs a
  whole-reading op gathers -- the heads' outputs before a
  column-parallel ``wo`` and its output, k / v at two kv heads, MLA's
  low-rank query and latent (either cut, the norms read them whole) and
  a row-parallel ``wq_b``'s queries, the MLP's and the shared expert's
  products, the experts' bucket rows and the logits;
* the moved bytes of both routes are the plan's (``moved_bytes``).
"""
import pytest
import torch

from _torch_tp_cases import CASES, tp_cfg
from repro_torch.launch.dryrun import sharded_step_costs
from repro_torch.mesh import AbstractMesh, model_dim, param_shardings
from repro_torch.models import param_specs
from repro_torch.models import tensor_parallel
from repro_torch.models.tensor_parallel import ROW_GATHERED, TENSOR_PARALLEL

BATCH, SEQ = 8, 32
F32 = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(cfg, shape):
    """Whether the plan of ``shape`` cuts each attention, MLP and MoE
    leaf of a layer on its contraction dim (row-parallel), by name."""
    specs = param_specs(cfg)["layers"]
    plan = param_shardings(specs, AbstractMesh(shape, ("data", "model")))
    return {n: model_dim(sh, specs[part][n].ndim) == specs[part][n].ndim - 2
            for part in ("attn", "mlp", "moe") if part in specs
            for n, sh in plan[part].items()}


def _exchanged(cfg, shape):
    """The activation bytes one row's positions gather or sum, forward."""
    rows = _rows(cfg, shape)
    T, D, L, V = BATCH // shape[0] * SEQ, cfg.d_model, cfg.n_layers, \
        cfg.vocab
    H = cfg.n_heads
    if cfg.use_mla:
        dv = cfg.v_head_dim
        qk = cfg.nope_head_dim + cfg.rope_head_dim
        attn = T * cfg.q_lora_rank + T * (cfg.kv_lora_rank
                                          + cfg.rope_head_dim)
        attn += T * H * qk if rows["wq_b"] else 0        # q's row sum
    else:
        dv = cfg.head_dim
        kv = 2 * T * cfg.n_kv_heads * dv                  # k / v row sums
        attn = kv if rows["wk"] else 0
    attn += T * D if rows["wo"] else T * H * dv + T * D  # wo
    if cfg.n_experts:
        C = int(BATCH * SEQ * cfg.top_k / cfg.n_experts * 1.25)
        mix = cfg.n_experts * C * D                        # bucket rows
        mix += (2 * T * cfg.shared_ff if rows["shared_w1"] else 0) + T * D
    else:
        assert rows["w2"] and not rows["w1"]
        mix = T * D                                        # w2's row sum
    embed = 0 if cfg.embed_inputs else T * D
    return F32 * (embed + L * (attn + mix) + T * V)       # + the logits


@pytest.mark.parametrize("shape", [(1, 4), (2, 4)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", list(CASES))
def test_position_counts_split_the_cut_products(arch, shape, monkeypatch):
    cfg = tp_cfg(arch, remat=False)
    tp = sharded_step_costs(cfg, shape, BATCH, SEQ)
    monkeypatch.setattr(tensor_parallel, "route", lambda cfg: ROW_GATHERED)
    rg = sharded_step_costs(cfg, shape, BATCH, SEQ)
    assert tp["route"] == TENSOR_PARALLEL and rg["route"] == ROW_GATHERED
    by = tp["by_position"]
    M, R = shape[1], shape[0]
    assert set(by) == {None, *range(M)}
    assert tp["compute"].flops == rg["compute"].flops
    for p in range(M):
        assert by[p].flops * M == rg["compute"].flops - by[None].flops
        pos = tp["positions"][p]
        assert pos["flops"] == (by[None].flops + by[p].flops) / R
        assert pos["exchanged_bytes"] == [_exchanged(cfg, shape)] * R
        assert all(n > 0 for n in pos["leaf_bytes"])
    assert by[None].flops < rg["compute"].flops / M / 10
    assert rg["positions"][0]["exchanged_bytes"] == [0] * R
    assert tp["moved"] == rg["moved"]      # every position on ``meta``
