"""Continuous-batching serving scheduler, single device (counterpart of
``repro.serving.scheduler``).

Requests arrive with prompts of different lengths and different
generation budgets.  The scheduler holds up to ``max_slots`` sequences at
once, prefills a new request into a free slot (one prefill per admission,
through the flash-attention kernel on the card) and runs one decode step
per tick for every active slot.  A finished slot is recycled at once, so
throughput does not stall on the longest request.

Each slot has its own batch-1 cache of length ``max_len``; the prefill
writes the prompt straight into a fresh one.  A slot's decode step reads
its cache up to its own position only (``models.attention``), so a
request's greedy tokens are those of a single-request ``generate``, the
reference's correctness check.  Sampling (:func:`sample_next`, shared
with ``launch.serve.generate``): greedy is the reference's argmax;
``temperature > 0`` draws from a seeded ``torch.Generator`` (seed + 1, as
the reference keys ``PRNGKey(seed + 1)``), not ``jax.random``.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from ..kernels.dispatch import resolve_device
from ..models import decode_step, init_params, prefill
from ..models.config import ModelConfig

__all__ = ["Request", "ContinuousBatcher", "sample_next"]


def sample_next(logits: torch.Tensor, temperature: float,
                generator: Optional[torch.Generator]) -> torch.Tensor:
    """(B, V) logits -> (B,) next tokens: the first argmax when
    ``temperature`` is 0, else a draw from ``softmax(logits / T)``."""
    if temperature > 0:
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.argmax(logits, dim=-1)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (P,) int32
    max_new: int
    arrived_at: float = 0.0
    # filled by the scheduler
    output: Optional[np.ndarray] = None
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None


@dataclasses.dataclass
class _Slot:
    req: Optional[Request] = None
    pos: int = 0                  # next write position in this slot's cache
    generated: int = 0
    tokens: List[int] = dataclasses.field(default_factory=list)

    @property
    def free(self) -> bool:
        return self.req is None


class ContinuousBatcher:
    """Slot-based continuous batching over per-slot decode steps.

    ``params``: a ``models.Transformer`` (made by ``init_params`` from
    ``seed`` on ``device`` when not given; ``device`` defaults to the
    model's, else the CUDA card)."""

    def __init__(self, cfg: ModelConfig, params=None, *, max_slots: int = 4,
                 max_len: int = 512, seed: int = 0,
                 temperature: float = 0.0, device=None):
        if not cfg.has_decode or cfg.embed_inputs:
            raise ValueError(f"{cfg.name}: continuous batching serves "
                             "text-in decoder models")
        self.cfg = cfg
        if params is None:
            dev = resolve_device(device)
            params = init_params(
                cfg, torch.Generator(device=dev).manual_seed(seed), dev)
        self.params = params
        self.device = params.device
        self.max_slots = max_slots
        self.max_len = max_len
        self.temperature = temperature
        self.slots = [_Slot() for _ in range(max_slots)]
        self.queue: Deque[Request] = deque()
        self.done: List[Request] = []
        self._gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.caches: List[Optional[dict]] = [None] * max_slots

    # ------------------------------------------------------------- admit
    def submit(self, req: Request) -> None:
        req.arrived_at = time.perf_counter()
        self.queue.append(req)

    def _admit(self) -> None:
        for i, slot in enumerate(self.slots):
            if not self.queue:
                return
            if not slot.free:
                continue
            req = self.queue.popleft()
            P = len(req.prompt)
            tokens = torch.as_tensor(np.asarray(req.prompt, np.int32),
                                     device=self.device)[None, :]
            self.caches[i] = None  # release the finished request's cache
            logits, self.caches[i] = prefill(self.params, self.cfg,
                                             {"tokens": tokens},
                                             max_len=self.max_len)
            slot.req = req
            slot.pos = P
            slot.generated = 0
            slot.tokens = [self._sample(logits[:, -1])]
            req.t_first_token = time.perf_counter()

    def _sample(self, logits_row: torch.Tensor) -> int:
        return int(sample_next(logits_row, self.temperature, self._gen)[0])

    # -------------------------------------------------------------- tick
    def step(self) -> int:
        """Admit waiting requests, run one decode step for every active
        slot; returns the number of active slots processed."""
        self._admit()
        active = [i for i, s in enumerate(self.slots) if not s.free]
        for i in active:
            slot = self.slots[i]
            tok = torch.tensor([[slot.tokens[-1]]], dtype=torch.int32,
                               device=self.device)
            logits, self.caches[i] = decode_step(
                self.params, self.cfg, self.caches[i], tok, slot.pos)
            slot.pos += 1
            slot.generated += 1
            nxt = self._sample(logits[:, -1])
            if slot.generated < slot.req.max_new and \
                    slot.pos < self.max_len - 1:
                slot.tokens.append(nxt)
            else:
                self._finish(i)
        return len(active)

    def _finish(self, i: int) -> None:
        slot = self.slots[i]
        req = slot.req
        req.output = np.asarray(slot.tokens, np.int32)
        req.t_done = time.perf_counter()
        self.done.append(req)
        self.slots[i] = _Slot()

    # --------------------------------------------------------------- run
    def run_until_idle(self, max_ticks: int = 10_000) -> Dict[str, float]:
        t0 = time.perf_counter()
        toks = 0
        ticks = 0
        while (self.queue or any(not s.free for s in self.slots)) and \
                ticks < max_ticks:
            toks += self.step()
            ticks += 1
        dt = time.perf_counter() - t0
        return {"ticks": ticks, "tokens": toks, "wall_s": dt,
                "tok_per_s": toks / max(dt, 1e-9),
                "completed": len(self.done)}
