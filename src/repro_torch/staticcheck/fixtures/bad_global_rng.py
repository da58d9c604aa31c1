"""Known-bad fixture for RNG001: draws from a global random state.

The reference's JIT001 fixture freezes host entropy into a traced
program.  The port runs eagerly, so the same fault shows as draws from a
process-wide generator: each result depends on every earlier draw.  The
three draw forms: torch without ``generator=``, numpy's legacy module
functions, the ``random`` module.

Never imported or executed.
"""
import random

import numpy as np
import torch


def noisy_step(x: torch.Tensor, seed: int) -> torch.Tensor:
    gen = torch.Generator(device=x.device).manual_seed(seed)
    ok = torch.randn(x.shape, generator=gen, device=x.device)  # OK
    noise = torch.randn(x.shape, device=x.device)  # BAD: torch's global state
    return x + ok + noise


def sample_delays(n: int, seed: int) -> np.ndarray:
    ok = np.random.default_rng(seed).integers(0, 10, n)  # OK: explicit
    bad = np.random.randint(0, 10, n)  # BAD: numpy's global state
    return ok + bad


def jitter() -> float:
    return random.random()  # BAD: the random module's global state
