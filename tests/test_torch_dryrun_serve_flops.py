"""FLOP parity of the dry run's serving steps: for every architecture at
its reduced config (seq 256, batch 2), the FLOPs ``launch.op_cost``
counts for the port's prefill (an encoder's forward) and, where the
architecture decodes, its decode step against a full cache, on a
``meta`` ``Transformer``, equal the reference's ``analyze_hlo`` over its
lowered step exactly.
"""
import pytest
import torch

import repro.configs as jconfigs
from _torch_cost_ref import port_trace, reference_flops

SEQ, BATCH = 256, 2
CASES = [(a, k) for a in jconfigs.ARCH_IDS for k in ("prefill", "decode")
         if k == "prefill" or jconfigs.get_config(a).has_decode]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_cases_cover_every_architecture_and_kind():
    assert len(CASES) == 2 * len(jconfigs.ARCH_IDS) - 1  # hubert: no decode


@pytest.mark.parametrize("arch,kind", CASES)
def test_serving_step_flops_equal_the_reference(arch, kind):
    ref = reference_flops(arch, kind, SEQ, BATCH)
    cost = port_trace(arch, kind, SEQ, BATCH).cost()
    assert cost.uncounted == {}
    assert cost.flops == ref > 0
