"""Batched serving driver: prefill a prompt batch, then decode tokens
(counterpart of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-32b \\
        --batch 4 --prompt-len 64 --gen 32

runs on the CUDA card (prefill through the hand-written flash-attention
kernel); ``--device cpu --reduced`` runs a reduced model on the CPU.
The dense, MoE (``--arch qwen2-moe-a2.7b``), MLA (``--arch
deepseek-v2-236b``), Mamba2 (``--arch mamba2-780m``) and hybrid
(``--arch zamba2-2.7b``) models serve.  As the reference's, the CLI
refuses an encoder-only model (hubert-xlarge: nothing to decode) and a
model that takes embeddings (qwen2-vl-72b): ``generate`` still serves a
VLM's text prompts through its token table, and its image path is
``models.prefill`` on ``{"embeds", "positions"}`` followed by
``models.decode_step`` (``examples/serve_decode.py`` in the reference).

Sampling: greedy (``temperature=0``) is the reference's argmax.  With
``temperature > 0`` the port draws from a seeded ``torch.Generator`` on
the model's device; the reference draws from ``jax.random``, so the two
streams differ (a deliberate deviation; same seed, same draw within the
port).
"""
from __future__ import annotations

import argparse
import time
import torch

from ..configs import ARCH_IDS, get_config
from ..kernels.dispatch import resolve_device
from ..models import decode_step, init_params, prefill
from ..models.config import ModelConfig
from ..serving.scheduler import sample_next
from .train import PRESETS

__all__ = ["generate", "main"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def generate(cfg: ModelConfig, params, prompts, gen: int,
             temperature: float = 0.0, seed: int = 0):
    """prompts (B, S) int -> ((B, S+gen) int32, stats): greedy or
    temperature sampling on the model's device.

    The prefill writes the prompt straight into a cache of length
    ``S + gen`` (the reference grafts its prefill cache into one).
    ``stats``: ``prefill_s`` (the prefill, to its last device op),
    ``decode_s`` and ``tok_per_s`` over the decode loop, as the
    reference times it."""
    dev = params.device
    prompts = torch.as_tensor(prompts).to(device=dev, dtype=torch.int32)
    B, S = prompts.shape
    t0 = time.perf_counter()
    last, cache = prefill(params, cfg, {"tokens": prompts}, max_len=S + gen)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    generator = torch.Generator(device=dev).manual_seed(seed)
    out = prompts
    t0 = time.perf_counter()
    for i in range(gen):
        nxt = sample_next(last[:, -1], temperature, generator)[:, None].to(
            torch.int32)
        out = torch.cat([out, nxt], dim=1)
        last, cache = decode_step(params, cfg, cache, nxt, S + i)
    _sync(dev)
    dt = time.perf_counter() - t0
    return out, {"prefill_s": prefill_s, "decode_s": dt,
                 "tok_per_s": B * gen / dt}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--arch", choices=ARCH_IDS)
    g.add_argument("--preset", choices=list(PRESETS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = PRESETS[args.preset] if args.preset else get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if not cfg.has_decode:
        raise SystemExit(f"{cfg.name} is encoder-only; nothing to decode")
    if cfg.embed_inputs:
        raise SystemExit("serve driver is text-only; VLM prefill needs the "
                         "frontend stub (models.prefill on embeds and "
                         "positions, then models.decode_step)")
    dev = resolve_device(args.device)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=torch.Generator(device=dev).manual_seed(0),
                            device=dev, dtype=torch.int32)
    out, stats = generate(cfg, params, prompts, args.gen,
                          temperature=args.temperature)
    print(f"generated {tuple(out.shape)} on {dev}: prefill "
          f"{stats['prefill_s']:.3f}s, decode {stats['decode_s']:.2f}s "
          f"({stats['tok_per_s']:.1f} tok/s)")
    print(out[:2, args.prompt_len:].cpu().numpy())


if __name__ == "__main__":
    main()
