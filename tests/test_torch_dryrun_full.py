"""FLOP parity at full width and depth, on one device: qwen2-moe-a2.7b's
train step at 16 x 4096, deepseek-v2-236b's decode at 8 x 32768 and
mamba2-780m's prefill at 2 x 32768 count exactly the reference's FLOPs;
mamba2-780m's train step at 4 x 4096 counts exactly the reference's less
the SSD product only it counts (``_torch_cost_ref``; here the head dim
64 is the smaller of N and P, where the reduced configs take N), at the
measured ratio.  zamba2-2.7b's two products are held at its reduced size
(``test_torch_dryrun_flops.py``); at 4 x 4096 they measured 0.9916094251725964
of the reference, exact with both added (ROADMAP queue C).
"""
import pytest
import torch

from _torch_cost_ref import (port_trace, reference_flops,
                             ssm_training_gap)

# port / reference at 4 x 4096, measured
RATIO = {"mamba2-780m": 0.9999568449330557}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch,kind,seq,batch", [
    ("qwen2-moe-a2.7b", "train", 4096, 16),
    ("deepseek-v2-236b", "decode", 32768, 8),
    ("mamba2-780m", "prefill", 32768, 2),
])
def test_full_size_flops_equal_the_reference(arch, kind, seq, batch):
    ref = reference_flops(arch, kind, seq, batch, reduced=False)
    cost = port_trace(arch, kind, seq, batch, reduced=False).cost()
    assert cost.uncounted == {}
    assert cost.flops == ref > 0


@pytest.mark.parametrize("arch", sorted(RATIO))
def test_full_size_ssm_training_gap_is_the_two_products(arch):
    ref = reference_flops(arch, "train", 4096, 4, reduced=False)
    port = port_trace(arch, "train", 4096, 4, reduced=False).cost().flops
    assert port + ssm_training_gap(arch, 4096, 4, reduced=False) == ref
    assert port / ref == RATIO[arch]
