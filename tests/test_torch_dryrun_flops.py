"""FLOP parity of the dry run's train step: for every architecture at its
reduced config (seq 256, batch 2), the FLOPs ``launch.op_cost`` counts
for the port's ``Trainer.train_step`` on ``meta`` tensors equal the
reference's ``analyze_hlo`` over its lowered ``train_step`` exactly.  The
Mamba2 trunks (mamba2-780m, zamba2-2.7b) are exact once the two products
only the reference counts are added (``_torch_cost_ref``'s docstring;
ROADMAP queue C), and their ratio is held to the measured one.
"""
import pytest
import torch

import repro.configs as jconfigs
from _torch_cost_ref import port_trace, reference_flops, ssm_training_gap

SEQ, BATCH = 256, 2
# port / reference at this size, measured (the gap of ssm_training_gap)
RATIO = {"mamba2-780m": 0.9998687147170802,
         "zamba2-2.7b": 0.9819939746374273}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_train_step_flops_equal_the_reference(arch):
    ref = reference_flops(arch, "train", SEQ, BATCH)
    cost = port_trace(arch, "train", SEQ, BATCH).cost()
    assert cost.uncounted == {}
    gap = ssm_training_gap(arch, SEQ, BATCH)
    assert cost.flops + gap == ref
    assert (gap > 0) == (arch in RATIO)
    if arch in RATIO:
        assert cost.flops / ref == RATIO[arch]
