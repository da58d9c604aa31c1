"""Synthetic data pipelines (counterpart of ``repro.data.synthetic``):
deterministic numpy generators, bitwise the reference's, whose batches
land as tensors on the stream's ``device`` (the CUDA card unless
``"cpu"``).

* ``TokenStream``    -- language-model token batches with a learnable
                        structure (Markov-ish bigram process) so a ~100M model
                        trained for a few hundred steps shows a real loss
                        drop, not noise-floor hovering.
* ``EmbedStream``    -- frame/patch embedding batches for the audio/VLM stub
                        frontends (the assignment's carve-out): produces
                        (B, S, D) embeddings + targets, plus M-RoPE position
                        grids for the VLM case.
* logistic-regression generators live in ``repro.core.problems``.
All generators are seeded, stateless per batch index (sample k is a pure
function of (seed, k)), so every data-parallel worker can source its own
shard without coordination -- which is exactly what an asynchronous
parameter-server needs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..kernels.dispatch import resolve_device


def _put(a: np.ndarray, device) -> torch.Tensor:
    """A host batch on ``device``; to the card through pinned memory, so
    the copy does not wait for the work queued before it."""
    dev = resolve_device(device)
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t


@dataclasses.dataclass
class TokenStream:
    vocab: int
    batch: int
    seq: int
    seed: int = 0
    n_states: int = 64
    device: Optional[str] = None

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        V, K = self.vocab, min(self.n_states, self.vocab)
        # sparse bigram transition table: each state strongly prefers ~4 next
        self._next = rng.integers(0, V, size=(K, 4))
        self._state_of = rng.integers(0, K, size=(V,))

    def batch_at(self, index: int, batch: Optional[int] = None,
                 seq: Optional[int] = None) -> Dict[str, torch.Tensor]:
        B = batch or self.batch
        S = seq or self.seq
        rng = np.random.default_rng((self.seed, index))
        toks = np.zeros((B, S + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, size=(B,))
        noise = rng.random((B, S))
        pick = rng.integers(0, 4, size=(B, S))
        rand_tok = rng.integers(0, self.vocab, size=(B, S))
        for t in range(S):
            st = self._state_of[toks[:, t]]
            nxt = self._next[st, pick[:, t]]
            toks[:, t + 1] = np.where(noise[:, t] < 0.85, nxt, rand_tok[:, t])
        return {"tokens": _put(toks[:, :-1], self.device),
                "targets": _put(toks[:, 1:], self.device)}


@dataclasses.dataclass
class EmbedStream:
    """Precomputed modality embeddings (audio frames / vision patches)."""

    d_model: int
    vocab: int
    batch: int
    seq: int
    seed: int = 0
    mrope: bool = False
    image_grid: tuple = (8, 8)   # (h, w) patch grid at the sequence start
    device: Optional[str] = None

    def batch_at(self, index: int, batch: Optional[int] = None,
                 seq: Optional[int] = None) -> Dict[str, torch.Tensor]:
        B = batch or self.batch
        S = seq or self.seq
        rng = np.random.default_rng((self.seed, index, 7))
        emb = rng.normal(size=(B, S, self.d_model)).astype(np.float32) * 0.1
        tgt = rng.integers(0, self.vocab, size=(B, S)).astype(np.int32)
        out = {"embeds": _put(emb, self.device),
               "targets": _put(tgt, self.device)}
        if self.mrope:
            out["positions"] = _put(self.mrope_positions(B, S), self.device)
        return out

    def mrope_positions(self, B: int, S: int) -> np.ndarray:
        """(3, B, S) (t, h, w) grids: image patches first, then text."""
        h, w = self.image_grid
        n_img = min(h * w, S)
        t = np.zeros((S,), np.int32)
        hh = np.zeros((S,), np.int32)
        ww = np.zeros((S,), np.int32)
        idx = np.arange(n_img)
        hh[:n_img] = idx // w
        ww[:n_img] = idx % w
        # text continues after the image's temporal footprint
        text_pos = np.arange(S - n_img) + max(h, w)
        t[n_img:] = text_pos
        hh[n_img:] = text_pos
        ww[n_img:] = text_pos
        pos = np.stack([t, hh, ww])          # (3, S)
        return np.broadcast_to(pos[:, None, :], (3, B, S)).copy()
