"""Per-(family, shape) optimization knobs (counterpart of
``repro.launch.recipes``): the reference's table, as it stands.

The knob bundle is not a safe global default: activation constraints
regress embedding-input models (VLM / audio), and the small-output rule
regresses decode.  ``recommended_knobs`` returns the reference's kwargs
for its dry-run and trainer.
"""
from __future__ import annotations

from typing import Dict

from ..configs import SHAPES, get_config

__all__ = ["recommended_knobs"]

# keyed by (token_inputs, shape.kind)
_RECIPES: Dict[tuple, dict] = {
    # token-input models (dense / moe / ssm / hybrid)
    (True, "train"): dict(remat_chunk=True, shard_acts=True, seq_shard=True,
                          ce_chunk=512),
    (True, "prefill"): dict(shard_acts=True),
    (True, "decode"): dict(cp_cache=True),
    (True, "decode_long"): dict(cp_cache=True),
    # embedding-input models (audio / vlm): remat only
    (False, "train"): dict(remat_chunk=True),
    (False, "prefill"): dict(),
    (False, "decode"): dict(cp_cache=True),
    (False, "decode_long"): dict(cp_cache=True),
}


def recommended_knobs(arch: str, shape_name: str) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    knobs = dict(_RECIPES[(not cfg.embed_inputs, shape.kind)])
    # chunked CE only pays off for big vocabularies
    if knobs.get("ce_chunk") and cfg.vocab < 100_000:
        knobs.pop("ce_chunk")
    return knobs
