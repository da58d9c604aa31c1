"""The dry run's per-position counts of the tensor-parallel step
(``launch.dryrun.sharded_step_costs``), on ``meta`` tensors for reduced
qwen2-moe-a2.7b and reduced qwen2.5-32b with two kv heads, float32,
batch 8 x 32, on (1, 4) and (2, 4), without remat (with it, the
checkpoint's recompute stops after the last saved tensor it needs, which
falls after the other positions' partial products of a layer's last
row-parallel product).  Exact identities:

* each position's counted matmul-class FLOPs of the rows' loss and
  gradients equal the row-gathered step's, less the FLOPs the rows
  compute whole (the router's logits), over the model size: every cut
  product's forward and backward split in four;
* the bytes a row's positions exchange equal the sizes of the
  activations the products gather or sum: the embedding's rows, the
  heads' outputs and ``wo``'s column blocks, the row-parallel partial
  sums (float32; the k / v projections at two kv heads, the MLP's w2, the
  shared expert's w1 / w3 at this size), the shared expert's and the
  experts' outputs and the logits;
* the moved bytes of both routes are the plan's (``moved_bytes``).
"""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch.dryrun import sharded_step_costs
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


def _exchanged(arch, cfg, rows):
    """The activation bytes one row's positions gather or sum, forward."""
    T, D, L, V = BATCH // rows * SEQ, cfg.d_model, cfg.n_layers, cfg.vocab
    attn = T * cfg.n_heads * cfg.head_dim + T * D      # heads, wo's blocks
    if arch == "qwen2.5-32b":
        kv = 2 * T * cfg.n_kv_heads * cfg.head_dim      # k / v row sums
        layer = attn + kv + T * D                        # w2's row sum
    else:
        C = int(BATCH * SEQ * cfg.top_k / cfg.n_experts * 1.25)
        experts = cfg.n_experts * C * D                  # bucket rows
        shared = 2 * T * cfg.shared_ff + T * D           # w1 / w3 rows, w2
        layer = attn + experts + shared
    return F32 * (T * D + L * layer + T * V)             # + embed, logits


@pytest.mark.parametrize("shape", [(1, 4), (2, 4)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "qwen2.5-32b"])
def test_position_counts_split_the_cut_products(arch, shape, monkeypatch):
    over = {"n_kv_heads": 2} if arch == "qwen2.5-32b" else {}
    cfg = get_config(arch).reduced().replace(remat=False, **over)
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
        assert pos["exchanged_bytes"] == [_exchanged(arch, cfg, R)] * R
        assert all(n > 0 for n in pos["leaf_bytes"])
    assert by[None].flops < rg["compute"].flops / M / 10
    assert rg["positions"][0]["exchanged_bytes"] == [0] * R
    assert tp["moved"] == rg["moved"]      # every position on ``meta``
