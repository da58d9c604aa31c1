"""``repro_torch.launch.op_cost``, the port's counterpart of the
reference's while-aware HLO cost model: the programs of
``tests/test_hlo_cost.py`` rewritten in torch (a loop of 7 matmuls of
128, the loop nested x3, a matmul inside ``relu(x @ x) * 2``) count
exactly ``2 N^3`` a matmul, every iteration recorded; byte counts are
exact for a matmul, an elementwise op, a view (0), in-place and indexed
writes; the backward pass and a checkpoint's recompute are counted;
``meta`` tensors count as real ones do; a custom op and a hand-written
kernel's launch are named under ``uncounted``.
"""
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import fused_step
from repro_torch.launch import op_cost

N, L = 128, 7
F32 = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _loop(x, W):
    for i in range(W.shape[0]):
        x = x @ W[i]
    return x


def _nested(x, W):
    for i in range(W.shape[0]):
        for _ in range(3):
            x = x @ W[i]
    return x


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_loop_of_matmuls_is_exact(device):
    W, x = torch.zeros(L, N, N, device=device), torch.zeros(N, N,
                                                            device=device)
    cost = op_cost.analyze(_loop, x, W)
    assert cost.flops == 2 * N ** 3 * L
    # each matmul reads x and W[i] (a view: no copy) and writes its result
    assert cost.bytes == 3 * N * N * F32 * L
    assert cost.uncounted == {}


def test_nested_loops_are_exact():
    W, x = torch.zeros(L, N, N), torch.zeros(N, N)
    assert op_cost.analyze(_nested, x, W).flops == 2 * N ** 3 * L * 3


def test_matmul_inside_elementwise_ops_is_counted():
    x = torch.zeros(N, N)
    cost = op_cost.analyze(lambda x: torch.relu(x @ x) * 2.0, x)
    assert cost.flops == 2 * N ** 3
    # mm 3 N^2, relu 2 N^2, mul 2 N^2 (the scalar is no tensor)
    assert cost.bytes == 7 * N * N * F32


def test_elementwise_view_and_in_place_bytes():
    a, b = torch.zeros(64, 32), torch.zeros(64, 32)
    nb = 64 * 32 * F32
    assert op_cost.analyze(torch.add, a, b).bytes == 3 * nb
    assert op_cost.analyze(lambda a: a.view(-1).t().reshape(32, 64), a
                           ).bytes == 0
    # add_ reads both and writes a; copy_ and fill_ only write a
    assert op_cost.analyze(lambda a, b: a.add_(b), a, b).bytes == 3 * nb
    assert op_cost.analyze(lambda a, b: a.copy_(b), a, b).bytes == 2 * nb
    assert op_cost.analyze(lambda a: a.fill_(1.0), a).bytes == nb
    # a write into a slice counts the slice, not the buffer
    cache = torch.zeros(1000, 32)
    row = torch.ones(2, 32)
    assert op_cost.analyze(lambda c, r: c[10:12].copy_(r), cache, row
                           ).bytes == 2 * 2 * 32 * F32


def test_index_put_counts_its_region():
    buf, idx, vals = torch.zeros(1000, 8), torch.tensor([3, 7]), \
        torch.ones(2, 8)
    tr = op_cost.trace(lambda: buf.index_put_((idx,), vals))
    [rec] = [r for r in tr.records if "index_put" in r.op]
    # indices and values read, two rows of 8 written
    assert rec.bytes == 2 * 8 + 2 * 8 * F32 + 2 * 8 * F32


def test_backward_and_recompute_are_counted():
    w = torch.zeros(N, N, requires_grad=True)
    x = torch.zeros(N, N)

    def plain():
        return torch.autograd.grad((x @ w).sum(), w)

    def remat():
        y = checkpoint(lambda x: torch.relu(x @ w) @ w, x,
                       use_reentrant=False)
        return torch.autograd.grad(y.sum(), w)

    # forward + the weight's gradient (x's needs none)
    assert op_cost.analyze(plain).flops == 2 * 2 * N ** 3
    tr = op_cost.trace(remat)
    # 2 forward products, the first recomputed (the second's output is
    # saved by nothing, so the recompute stops before it), 3 for the
    # gradients (w twice, the hidden once)
    assert tr.cost().flops == (2 + 1 + 3) * 2 * N ** 3
    wheres = {r.where for r in tr.records if r.flops}
    assert "forward" in wheres and "MmBackward0" in wheres


def test_top_contributors_sum_calls_and_sort():
    W, x = torch.zeros(L, N, N), torch.zeros(N, N)
    tr = op_cost.trace(lambda: (_loop(x, W), x @ torch.zeros(N, 2 * N)))
    rows = op_cost.top_contributors(tr, "flops", 5)
    assert rows[0] == (2.0 * N ** 3 * L, "forward", "aten.mm.default",
                       f"{L} calls", "float32[128,128], float32[128,128]")
    assert rows[1][0] == 2.0 * N ** 2 * 2 * N and len(rows) == 2
    assert op_cost.top_contributors(tr, "bytes", 1)[0][0] == \
        3 * N * N * F32 * L
    with pytest.raises(ValueError, match="moved"):
        op_cost.top_contributors(tr, "coll")


@torch.library.custom_op("op_cost_test::double", mutates_args=())
def _double(x: torch.Tensor) -> torch.Tensor:
    return x * 2


@_double.register_fake
def _(x):
    return torch.empty_like(x)


def test_custom_op_and_kernel_launches_are_uncounted():
    x = torch.zeros(16, 16)

    def launches_b1():
        # what a hand-written wrapper does where it launches (ctypes: no
        # aten op reaches the dispatcher)
        fused_step.fused_policy_prox_step.launches += 1
        return _double(x)

    before = fused_step.fused_policy_prox_step.launches
    try:
        cost = op_cost.analyze(launches_b1)
    finally:
        fused_step.fused_policy_prox_step.launches = before
    assert cost.uncounted == {"op_cost_test.double": 1,
                              "launch fused_policy_prox_step": 1}
    assert cost.flops == 0


def test_cost_carries_moved_bytes_by_kind():
    cost = op_cost.Cost(flops=1.0).with_moved({"gather": 5, "cut": 3})
    assert cost.moved_bytes == 8.0
    assert cost.moved_breakdown == {"gather": 5.0, "cut": 3.0,
                                    "replicate": 0.0}
    cost += op_cost.Cost(flops=2.0, uncounted={"x": 1})
    assert cost.flops == 3.0 and cost.uncounted == {"x": 1}
