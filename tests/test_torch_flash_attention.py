"""B6 on the CPU: the plain version of the port's flash-attention kernel
and its GQA fold against the reference.

The reference runs its Pallas kernel ``flash_attention_bhsd`` in interpret
mode (as ``tests/test_kernels.py`` does) and its jnp oracle
``flash_attention_ref``; the port's CPU route is
``flash_attention_bhsd_ref`` (a CPU tensor never reaches the CUDA kernel,
which ``tests/test_torch_kernels_cuda.py`` holds against this plain
version on the card).  Same numpy inputs on both sides.

Envelopes, as the reference's own kernel tests state them: float32 within
2e-5 absolute (the blocked kernel and a one-shot softmax sum in other
orders); bfloat16 within 2e-2 absolute (outputs of size ~1 rounded to
bfloat16 on both sides).
"""
import ast
import importlib.util
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_bhsd as j_fa
from repro.models.attention import attend as j_attend
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ops import flash_attention
from repro_torch.models.attention import attend

ENV = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(rng, shapes, dtype):
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    if dtype == "bfloat16":  # round once, so both sides see the same bf16
        arrs = [np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                for a in arrs]
    return arrs


def _jax(a, dtype):
    return jnp.asarray(a, getattr(jnp, dtype))


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _np(t):
    return (t.float().numpy() if torch.is_tensor(t)
            else np.asarray(t, np.float32))


@pytest.mark.parametrize("dims", [(2, 33, 33, 16), (1, 128, 128, 32),
                                  (3, 65, 200, 64), (2, 1, 96, 16)])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 13),
                                           (False, None)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_reference_oracle_sweep(dims, causal, window, dtype):
    """The sweep of ``tests/test_kernels.py:35`` against ``ref.py:28``."""
    BH, Sq, Sk, d = dims
    rng = np.random.default_rng(Sq * 7 + Sk)
    q, k, v = _inputs(rng, [(BH, Sq, d), (BH, Sk, d), (BH, Sk, d)], dtype)
    qp = (np.arange(Sq) + (Sk - Sq)).astype(np.int32)
    kp = np.arange(Sk, dtype=np.int32)
    got = fa.flash_attention_bhsd(
        _torch(q, dtype), _torch(k, dtype), _torch(v, dtype),
        torch.from_numpy(qp), torch.from_numpy(kp), causal=causal,
        window=window, scale=d ** -0.5)
    want = jref.flash_attention_ref(
        _jax(q, dtype), _jax(k, dtype), _jax(v, dtype), jnp.asarray(qp),
        jnp.asarray(kp), causal=causal, window=window, scale=d ** -0.5)
    assert got.dtype == getattr(torch, dtype) and got.shape == q.shape
    np.testing.assert_allclose(_np(got), _np(want), atol=ENV[dtype])


@pytest.mark.parametrize("dims,causal,window,dtype", [
    ((3, 65, 200, 64), True, 13, "float32"),
    ((2, 33, 33, 16), False, None, "float32"),
    ((3, 65, 200, 64), True, None, "bfloat16"),
])
def test_plain_matches_interpreted_pallas_kernel(dims, causal, window, dtype):
    """Against the TPU kernel itself, interpreted on the CPU, with the
    block sizes of ``tests/test_kernels.py`` (so its k loop runs several
    online-softmax steps)."""
    BH, Sq, Sk, d = dims
    rng = np.random.default_rng(d)
    q, k, v = _inputs(rng, [(BH, Sq, d), (BH, Sk, d), (BH, Sk, d)], dtype)
    qp = (np.arange(Sq) + (Sk - Sq)).astype(np.int32)
    kp = np.arange(Sk, dtype=np.int32)
    got = fa.flash_attention_bhsd(
        _torch(q, dtype), _torch(k, dtype), _torch(v, dtype),
        torch.from_numpy(qp), torch.from_numpy(kp), causal=causal,
        window=window, scale=d ** -0.5)
    want = j_fa(_jax(q, dtype), _jax(k, dtype), _jax(v, dtype),
                jnp.asarray(qp), jnp.asarray(kp), causal=causal,
                window=window, scale=d ** -0.5, block_q=32, block_k=64,
                interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), atol=ENV[dtype])


def test_ring_holes_are_ignored():
    """``tests/test_kernels.py:52``: kpos == -1 slots anywhere."""
    BH, Sq, Sk, d = 2, 4, 32, 16
    q, k, v = _inputs(np.random.default_rng(3),
                      [(BH, Sq, d), (BH, Sk, d), (BH, Sk, d)], "float32")
    qp = (np.arange(Sq) + 100).astype(np.int32)
    kp = np.where(np.arange(Sk) % 3 == 0, -1, np.arange(Sk) + 90).astype(
        np.int32)
    got = fa.flash_attention_bhsd(*map(torch.from_numpy, (q, k, v, qp, kp)),
                                  causal=True, window=None, scale=0.25)
    for want in (jref.flash_attention_ref(*map(jnp.asarray, (q, k, v, qp,
                                                             kp)),
                                          causal=True, window=None,
                                          scale=0.25),
                 j_fa(*map(jnp.asarray, (q, k, v, qp, kp)), causal=True,
                      window=None, scale=0.25, block_q=4, block_k=8,
                      interpret=True)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # the holes really are skipped: filling them with garbage changes nothing
    k2, v2 = k.copy(), v.copy()
    k2[:, kp < 0] = 1e3
    v2[:, kp < 0] = -7.0
    again = fa.flash_attention_bhsd(
        *map(torch.from_numpy, (q, k2, v2, qp, kp)), causal=True,
        window=None, scale=0.25)
    assert torch.equal(again, got)


@pytest.mark.parametrize("gqa", [(8, 2), (4, 4), (6, 1)])
def test_gqa_fold_matches_model_attend(gqa):
    """``tests/test_kernels.py:70``: the fold against the reference's naive
    model attention, and against the port's."""
    H, KV = gqa
    B, S, d = 2, 45, 16
    q, k, v = _inputs(np.random.default_rng(H), [(B, S, H, d), (B, S, KV, d),
                                                 (B, S, KV, d)], "float32")
    pos = np.arange(S, dtype=np.int32)
    got = flash_attention(*map(torch.from_numpy, (q, k, v, pos, pos)),
                          causal=True, window=None, scale=0.25)
    want = j_attend(*map(jnp.asarray, (q, k, v, pos, pos)), causal=True,
                    window=None, scale=0.25, q_chunk=16, impl="naive")
    also = jops.flash_attention(*map(jnp.asarray, (q, k, v, pos, pos)),
                                causal=True, window=None, scale=0.25)
    port_naive = attend(*map(torch.from_numpy, (q, k, v, pos, pos)),
                        causal=True, window=None, scale=0.25, q_chunk=16,
                        impl="naive")
    assert got.shape == (B, S, H, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(also), atol=2e-5)
    np.testing.assert_allclose(got.numpy(), port_naive.numpy(), atol=2e-5)


@pytest.mark.parametrize("gqa,window", [((8, 2), 16), ((4, 4), 9)])
def test_gqa_sliding_window_golden(gqa, window):
    """``tests/test_kernels.py:245``: fold + sliding window."""
    H, KV = gqa
    B, S, d = 2, 40, 16
    q, k, v = _inputs(np.random.default_rng(window),
                      [(B, S, H, d), (B, S, KV, d), (B, S, KV, d)], "float32")
    pos = np.arange(S, dtype=np.int32)
    got = flash_attention(*map(torch.from_numpy, (q, k, v, pos, pos)),
                          causal=True, window=window, scale=d ** -0.5)
    want = j_attend(*map(jnp.asarray, (q, k, v, pos, pos)), causal=True,
                    window=window, scale=d ** -0.5, q_chunk=16,
                    impl="naive")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_fold_masks_by_position_not_row():
    """After the fold a row's index is not its position: with G = 3 heads
    of 5 positions, row 5 (head 1, position 0) sees one key, not six."""
    B, S, KV, G, d = 1, 5, 1, 3, 16
    q, k, v = _inputs(np.random.default_rng(0),
                      [(B, S, KV * G, d), (B, S, KV, d), (B, S, KV, d)],
                      "float32")
    pos = torch.arange(S, dtype=torch.int32)
    out = flash_attention(*map(torch.from_numpy, (q, k, v)), pos, pos,
                          causal=True, scale=0.3)
    # position 0 of every head attends to key 0 alone: out == v[0]
    for h in range(G):
        np.testing.assert_allclose(out[0, 0, h].numpy(), v[0, 0, 0],
                                   atol=1e-6)


def test_fully_masked_and_negative_query_rows_are_zero():
    q, k, v = _inputs(np.random.default_rng(1), [(2, 6, 16)] * 3, "float32")
    qp = torch.tensor([-1, 0, 1, 2, 3, 4], dtype=torch.int32)
    kp = torch.tensor([-1, -1, 5, 6, 7, 8], dtype=torch.int32)
    out = fa.flash_attention_bhsd(*map(torch.from_numpy, (q, k, v)), qp, kp,
                                  causal=False, scale=0.25)
    assert bool((out[:, 0] == 0).all())   # qpos = -1: masked (the kernel's)
    assert bool((out[:, 1:] != 0).any())
    causal = fa.flash_attention_bhsd(*map(torch.from_numpy, (q, k, v)), qp,
                                     kp, causal=True, scale=0.25)
    assert bool((causal == 0).all())      # every key is in the future


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = fa.flash_attention_bhsd.launches
    x = torch.zeros(1, 3, 40)  # a head dim the kernel has no instance for
    pos = torch.arange(3, dtype=torch.int32)
    out = fa.flash_attention_bhsd(x, x, x, pos, pos)
    assert out.shape == x.shape
    assert fa.flash_attention_bhsd.launches == before


def _chip_smoke(monkeypatch):
    """``chip_smoke.py`` as a module, without running it: the script
    leaves at once without a card, so the check is switched off for the
    import (the module level only imports and defines)."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: True)
        spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("causal,window", [(True, None), (True, 7),
                                           (False, None), (False, 7)])
def test_attention_work_counts_visible_pairs(causal, window, monkeypatch):
    rng = np.random.default_rng(5)
    qp = np.concatenate([np.arange(20), [-1, -1]]).astype(np.int32)
    kp = rng.permutation(np.where(np.arange(30) % 4 == 0, -1,
                                  np.arange(30))).astype(np.int32)
    vis = (kp[None] >= 0) & (qp[:, None] >= 0)
    if causal:
        vis &= kp[None] <= qp[:, None]
    if window is not None:
        vis &= kp[None] > qp[:, None] - window
    nbytes, flops = _chip_smoke(monkeypatch).attention_work(
        6, 64, qp, kp, causal=causal, window=window, itemsize=2)
    assert flops == 4 * 64 * 6 * int(vis.sum())
    assert nbytes == 2 * 6 * 64 * (2 * 22 + 2 * 30) + 4 * 52


def test_kernel_source_matches_its_wrapper():
    """The CUDA source builds for sm_90a, has an instance for every head
    dim the wrapper accepts, returns cudaGetLastError() after the launch,
    and the wrapper raises on a nonzero code and on unsupported inputs."""
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    src = (build.CSRC_DIR / "flash_attention.cu").read_text()
    dims = tuple(int(x) for x in re.findall(r"FA_CASE\((\d+)\)", src))
    assert dims == fa.SUPPORTED_HEAD_DIMS
    assert "return static_cast<int>(cudaGetLastError());" in src
    assert "repro/kernels/flash_attention.py" in src
    tree = ast.parse(open(fa.__file__).read())
    raises = [ast.unparse(n) for n in ast.walk(tree)
              if isinstance(n, ast.Raise)]
    assert any("launch failed" in r for r in raises)
    assert any("no kernel for head dim" in r for r in raises)
