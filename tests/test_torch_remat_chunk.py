"""``remat_chunk``: the chunked attention recomputes each chunk's scores in
the backward pass (``torch.utils.checkpoint``, as the reference's
``jax.checkpoint`` of ``chunk_attend``).

* Gradients of ``loss_fn`` are bitwise the same with the knob on and
  off (reduced configs, seq 128 over ``q_chunk`` 64: two chunks a
  layer), for GQA, MLA and an MoE trunk;
* the train step's FLOPs that ``launch.op_cost`` counts on ``meta`` with
  the knob on equal the reference's ``analyze_hlo`` count of its lowered
  step exactly (seq 256, batch 2: four chunks), and exceed the count
  with the knob off by the recomputed forward.
"""
import pytest
import torch

from _torch_cost_ref import port_trace, reference_flops
from repro_torch.configs import get_config
from repro_torch.core.pytree import tree_leaves
from repro_torch.launch.steps import loss_and_grad, make_trainer
from repro_torch.launch.train import make_stream

ARCHS = ["qwen2.5-32b", "deepseek-v2-236b", "qwen2-moe-a2.7b"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_chunk_gradients_are_bitwise(arch):
    cfg = get_config(arch).reduced().replace(attention_impl="chunked")
    assert cfg.q_chunk < 128
    params = make_trainer(cfg).init(device="cpu").params
    batch = make_stream(cfg, 2, 128, device="cpu").batch_at(0)
    loss_off, _, g_off = loss_and_grad(params, cfg, batch)
    loss_on, _, g_on = loss_and_grad(params, cfg.replace(remat_chunk=True),
                                     batch)
    assert torch.equal(loss_on, loss_off)
    for a, b in zip(tree_leaves(g_on), tree_leaves(g_off)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS[:2])
def test_remat_chunk_flops_equal_the_reference(arch):
    on = dict(remat_chunk=True)
    cost = port_trace(arch, "train", 256, 2, knobs=on).cost()
    assert cost.uncounted == {}
    assert cost.flops == reference_flops(arch, "train", 256, 2, knobs=on)
    assert cost.flops > port_trace(arch, "train", 256, 2).cost().flops
