"""The port's hand-written CUDA kernels against their plain versions, on
the card.

Every test here is marked ``cuda`` and skips, naming the missing device,
where no CUDA card is present (the CPU suite): a CUDA kernel has no
interpret mode.  On the card (``python -m pytest -m cuda
tests/test_torch_kernels_cuda.py``) they build the kernels from
``src/repro_torch/kernels/csrc`` and compare.  This file imports no JAX,
so it runs on a machine that has only PyTorch.

Envelopes (B6, flash attention): float32 within 1e-5 of max|out|;
bfloat16 within 2 bf16 ulps of the plain output plus that float32
envelope (the two sum in other orders, and a value that cancels near zero
has ulps finer than the float32 error).
"""
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ops import flash_attention

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the H100); torch.cuda.is_available()"
                    " is False here")
    return torch.device("cuda")


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bfloat16 numbers at |x| (8 significant bits)."""
    _, e = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def check(got, want):
    got_f, want_f = got.float(), want.float()
    err = (got_f - want_f).abs()
    env = 1e-5 * max(float(want_f.abs().max()), 1e-30)
    if want.dtype == torch.bfloat16:
        env = env + 2 * bf16_ulp(want_f)
    bad = err > env
    assert not bool(bad.any()), (float(err.max()), int(bad.sum()))
    return float(err.max()) if err.numel() else 0.0


def _case(gen, BH, Sq, Sk, d, dtype, dev):
    q, k, v = (torch.randn(BH, n, d, generator=gen).to(dtype).to(dev)
               for n in (Sq, Sk, Sk))
    return q, k, v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [48, 64, 128])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 9)])
def test_b6_kernel_matches_plain(cuda, dtype, d, causal, window):
    gen = torch.Generator().manual_seed(d)
    for Sq, Sk in [(1, 1), (17, 17), (64, 64), (300, 300), (17, 300),
                   (1, 2048), (300, 2048), (2048, 2048)]:
        q, k, v = _case(gen, 3, Sq, Sk, d, dtype, cuda)
        qp = (torch.arange(Sq, dtype=torch.int32) + (Sk - Sq)).to(cuda)
        kp = torch.arange(Sk, dtype=torch.int32).to(cuda)
        before = fa.flash_attention_bhsd.launches
        got = fa.flash_attention_bhsd(q, k, v, qp, kp, causal=causal,
                                      window=window, scale=d ** -0.5)
        assert fa.flash_attention_bhsd.launches == before + 1
        want = fa.flash_attention_bhsd_ref(q, k, v, qp, kp, causal=causal,
                                           window=window, scale=d ** -0.5)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == q.shape
        check(got, want)


@pytest.mark.parametrize("G", [1, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b6_gqa_fold_and_ring_holes(cuda, G, dtype):
    """The fold gives each tile rows of several heads (positions
    tile(qpos, G)); ring holes put -1 anywhere in kpos."""
    gen = torch.Generator().manual_seed(G)
    B, KV, d, S = 2, 2, 64, 77
    q = torch.randn(B, S, KV * G, d, generator=gen).to(dtype).to(cuda)
    k, v = (torch.randn(B, S, KV, d, generator=gen).to(dtype).to(cuda)
            for _ in range(2))
    pos = torch.arange(S, dtype=torch.int32)
    holes = torch.where(torch.arange(S) % 3 == 0, -1, pos + 90).to(
        torch.int32)
    for qpos, kpos, window in [(pos, pos, None), (pos, pos, 9),
                               (pos + 100, holes, None)]:
        got = flash_attention(q, k, v, qpos.to(cuda), kpos.to(cuda),
                              causal=True, window=window, scale=0.125)
        want = flash_attention(q.cpu(), k.cpu(), v.cpu(), qpos, kpos,
                               causal=True, window=window, scale=0.125)
        torch.cuda.synchronize()
        check(got.cpu(), want)


def test_b6_refuses_what_it_has_no_kernel_for(cuda):
    q = torch.zeros(1, 4, 40, device=cuda)
    with pytest.raises(ValueError, match="head dim 40"):
        fa.flash_attention_bhsd(q, q, q, torch.zeros(4, dtype=torch.int32,
                                                     device=cuda),
                                torch.zeros(4, dtype=torch.int32,
                                            device=cuda))
    h = torch.zeros(1, 4, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="bfloat16 or all float32"):
        fa.flash_attention_bhsd(h, h, h, torch.zeros(4, dtype=torch.int32,
                                                     device=cuda),
                                torch.zeros(4, dtype=torch.int32,
                                            device=cuda))


def test_b6_fully_masked_rows_are_zero(cuda):
    gen = torch.Generator().manual_seed(0)
    q, k, v = _case(gen, 2, 70, 70, 64, torch.float32, cuda)
    qp = torch.arange(70, dtype=torch.int32).to(cuda)
    kp = torch.full((70,), -1, dtype=torch.int32).to(cuda)
    got = fa.flash_attention_bhsd(q, k, v, qp, kp, causal=True, scale=0.1)
    assert bool((got == 0).all())


def test_model_prefill_on_the_card_matches_the_cpu(cuda):
    """qwen2.5-32b.reduced() in float32 with the same parameters on both
    devices: logits within 1e-4, one B6 launch per layer per prefill, and
    the same greedy tokens."""
    from repro_torch import interop
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import forward, init_params, prefill
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("qwen2.5-32b").reduced()
    assert cfg.attention_impl == "pallas"
    cpu = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = interop.model_params(interop.model_tree(cpu), cfg, device=cuda)
    toks = torch.randint(0, cfg.vocab, (2, 40),
                         generator=torch.Generator().manual_seed(1))
    lc, _ = forward(cpu, cfg, {"tokens": toks})
    before = fa.flash_attention_bhsd.launches
    lg, _ = forward(card, cfg, {"tokens": toks.to(cuda)})
    assert fa.flash_attention_bhsd.launches - before == cfg.n_layers
    assert float((lg.cpu() - lc).abs().max()) < 1e-4
    pc, _ = prefill(cpu, cfg, {"tokens": toks})
    pg, _ = prefill(card, cfg, {"tokens": toks.to(cuda)})
    assert float((pg.cpu() - pc).abs().max()) < 1e-4
    oc, _ = generate(cfg, cpu, toks, 12)
    og, _ = generate(cfg, card, toks.to(cuda), 12)
    assert torch.equal(og.cpu(), oc)
