"""The port's serving path (``launch.serve.generate`` and
``serving.ContinuousBatcher``) on the CPU.

The three cases of ``tests/test_serving.py`` run on the port (its own
``init_params``); then, on the reference's parameters carried across by
``interop.model_params``, the port's greedy ``generate`` and
``ContinuousBatcher`` outputs equal the reference's token for token
(float32; greedy is exact while the top-2 logit margins exceed the 1e-4
logit envelope of ``tests/test_torch_models.py``, which they do here).
Temperature sampling draws from a seeded ``torch.Generator`` (the
reference draws from ``jax.random``, a deliberate deviation): tested for
being seeded and reproducible only.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.serve import generate as j_generate
from repro.launch.train import PRESETS as J_PRESETS
from repro.models import init_params as j_init_params
from repro.serving import ContinuousBatcher as JBatcher
from repro.serving import Request as JRequest
from repro_torch import interop
from repro_torch.launch import serve
from repro_torch.launch.serve import generate
from repro_torch.launch.train import PRESETS
from repro_torch.models import ModelConfig, init_params
from repro_torch.serving import ContinuousBatcher, Request

SMALL = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
             d_ff=256, vocab=256, name="lm-serve")
CFG = PRESETS["25m"].replace(**SMALL)
J_CFG = J_PRESETS["25m"].replace(**SMALL)


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, torch.Generator().manual_seed(0), device="cpu")


@pytest.fixture(scope="module")
def carried():
    """(reference params, the port model holding them, port config with
    the reference's attention_impl)."""
    jp = jax.jit(j_init_params, static_argnums=0)(J_CFG,
                                                  jax.random.PRNGKey(0))
    tcfg = ModelConfig(**dataclasses.asdict(J_CFG))
    model = interop.model_params(jax.tree_util.tree_map(np.asarray, jp),
                                 tcfg, device="cpu")
    return jp, model, tcfg


def _prompts(n, rng):
    return [rng.integers(0, CFG.vocab, size=rng.integers(4, 12)).astype(
        np.int32) for _ in range(n)]


# ------------------------------------ tests/test_serving.py on the port

def test_batcher_completes_all_requests(params):
    rng = np.random.default_rng(0)
    cb = ContinuousBatcher(CFG, params, max_slots=3, max_len=64)
    reqs = [Request(rid=i, prompt=p, max_new=int(rng.integers(3, 9)))
            for i, p in enumerate(_prompts(7, rng))]
    for r in reqs:
        cb.submit(r)
    stats = cb.run_until_idle()
    assert stats["completed"] == 7
    for r in reqs:
        assert r.output is not None and 1 <= len(r.output) <= r.max_new
        assert r.t_first_token is not None and r.t_done >= r.t_first_token


def test_batcher_matches_single_request_greedy(params):
    """Continuous batching is a scheduling change, not a model change."""
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, CFG.vocab, size=8).astype(np.int32)
    gen = 6
    ref, _ = generate(CFG, params, torch.from_numpy(prompt)[None, :], gen)
    ref_new = ref[0, len(prompt):].numpy()
    cb = ContinuousBatcher(CFG, params, max_slots=2, max_len=64)
    cb.submit(Request(rid=0, prompt=prompt, max_new=gen))
    cb.submit(Request(rid=1, prompt=_prompts(1, rng)[0], max_new=4))
    cb.run_until_idle()
    out = next(r for r in cb.done if r.rid == 0).output
    np.testing.assert_array_equal(out, ref_new)


def test_slots_recycle(params):
    rng = np.random.default_rng(2)
    cb = ContinuousBatcher(CFG, params, max_slots=1, max_len=64)
    for i, p in enumerate(_prompts(3, rng)):
        cb.submit(Request(rid=i, prompt=p, max_new=3))
    stats = cb.run_until_idle()
    assert stats["completed"] == 3


# ------------------------------------------------- against the reference

def test_generate_greedy_equals_reference(carried):
    jp, model, tcfg = carried
    prompts = np.random.default_rng(3).integers(0, CFG.vocab, (3, 9)).astype(
        np.int32)
    want, _ = j_generate(J_CFG, jp, jnp.asarray(prompts), 7)
    got, stats = generate(tcfg, model, prompts, 7)
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert set(stats) == {"prefill_s", "decode_s", "tok_per_s"}


@pytest.mark.parametrize("impl", ["pallas", "chunked"])
def test_batcher_greedy_equals_reference(carried, impl):
    jp, model, tcfg = carried
    rng = np.random.default_rng(4)
    prompts = _prompts(5, rng)
    budgets = [int(rng.integers(2, 7)) for _ in prompts]
    jcb = JBatcher(J_CFG.replace(attention_impl=impl), jp, max_slots=2,
                   max_len=32)
    tcb = ContinuousBatcher(tcfg.replace(attention_impl=impl), model,
                            max_slots=2, max_len=32)
    for i, (p, n) in enumerate(zip(prompts, budgets)):
        jcb.submit(JRequest(rid=i, prompt=p, max_new=n))
        tcb.submit(Request(rid=i, prompt=p, max_new=n))
    js, ts = jcb.run_until_idle(), tcb.run_until_idle()
    assert (ts["ticks"], ts["tokens"], ts["completed"]) == \
        (js["ticks"], js["tokens"], js["completed"])
    assert [r.rid for r in tcb.done] == [r.rid for r in jcb.done]
    for a, b in zip(tcb.done, jcb.done):
        np.testing.assert_array_equal(a.output, b.output)


def test_batcher_stops_at_max_len_like_the_reference(carried):
    jp, model, tcfg = carried
    prompt = np.arange(10, dtype=np.int32)
    jcb = JBatcher(J_CFG, jp, max_slots=1, max_len=14)
    tcb = ContinuousBatcher(tcfg, model, max_slots=1, max_len=14)
    jcb.submit(JRequest(rid=0, prompt=prompt, max_new=20))
    tcb.submit(Request(rid=0, prompt=prompt, max_new=20))
    jcb.run_until_idle(), tcb.run_until_idle()
    np.testing.assert_array_equal(tcb.done[0].output, jcb.done[0].output)
    assert len(tcb.done[0].output) == 3


def test_temperature_sampling_is_seeded(params):
    prompts = torch.randint(0, CFG.vocab, (2, 6),
                            generator=torch.Generator().manual_seed(5))
    a, _ = generate(CFG, params, prompts, 8, temperature=1.0, seed=3)
    b, _ = generate(CFG, params, prompts, 8, temperature=1.0, seed=3)
    c, _ = generate(CFG, params, prompts, 8, temperature=1.0, seed=4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    greedy, _ = generate(CFG, params, prompts, 8)
    assert torch.equal(greedy[:, :6], a[:, :6])

    def run(seed):
        cb = ContinuousBatcher(CFG, params, max_slots=2, max_len=32,
                               temperature=1.0, seed=seed)
        for i in range(3):
            cb.submit(Request(rid=i, prompt=prompts[i % 2].numpy(),
                              max_new=6))
        cb.run_until_idle()
        return [r.output.tolist() for r in cb.done]

    assert run(7) == run(7) and run(7) != run(8)


def test_batcher_makes_its_own_model_from_the_seed():
    cb = ContinuousBatcher(CFG, max_slots=1, max_len=16, seed=2,
                           device="cpu")
    ref = init_params(CFG, torch.Generator().manual_seed(2), device="cpu")
    assert torch.equal(cb.params.layers[1].mlp["w2"], ref.layers[1].mlp["w2"])
    with pytest.raises(ValueError, match="text-in decoder"):
        ContinuousBatcher(CFG.replace(causal=False, has_decode=False), ref)


def test_serve_cli_on_the_cpu(capsys):
    serve.main(["--preset", "25m", "--reduced", "--device", "cpu",
                "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    out = capsys.readouterr().out
    assert "generated (2, 11) on cpu" in out and "tok/s" in out
