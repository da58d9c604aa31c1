"""The configurations the tensor-parallel tests run: each family's
reduced config and, where its plan cuts some leaf on another dim than the
full config's, a reduced config whose plan cuts every leaf on the full
config's dims (``*-full-cut``; ``test_torch_tp_step.py`` checks that leaf
for leaf on every mesh the tests use).

* qwen2.5-32b: two kv heads, so that k / v are row-parallel as at full
  width (the reduced config's four are column-parallel);
* qwen2-moe-a2.7b: as reduced (its cuts are D1's);
* deepseek-v2-236b: reduced, ``wq_a`` column / ``wq_b`` row / ``wo``
  column; full-cut (q LoRA rank 128, eight heads): ``wq_a`` row, ``wq_b``
  column over the heads, ``wo`` row over the heads;
* qwen2-vl-72b: reduced (k / v column); full-cut, two kv heads (k / v
  row);
* hubert-xlarge: reduced (``unembed`` column over its 504 outputs);
  full-cut, d_model 512 (``unembed`` row over D) with eight heads and
  d_ff 1024, so that ``wq`` / ``wk`` / ``wv`` stay column- and ``w2``
  row-parallel as at full width.
"""
from repro_torch.configs import get_config

FULL_CUT = {
    "deepseek-v2-236b": dict(q_lora_rank=128, n_heads=8, n_kv_heads=8),
    "qwen2-vl-72b": dict(n_kv_heads=2),
    "hubert-xlarge": dict(d_model=512, n_heads=8, n_kv_heads=8, d_ff=1024),
}

# case id -> (arch, overrides of the reduced config)
CASES = {
    "qwen2.5-32b": ("qwen2.5-32b", {"n_kv_heads": 2}),
    "qwen2-moe-a2.7b": ("qwen2-moe-a2.7b", {}),
    **{case: (arch, over) for arch, over in FULL_CUT.items()
       for case, over in ((arch, {}), (f"{arch}-full-cut", over))},
}
DECODERS = [c for c, (a, _) in CASES.items() if get_config(a).has_decode]
ENCODERS = [c for c in CASES if c not in DECODERS]


def tp_cfg(case: str, **over):
    """The reduced config of ``case``, with ``over`` on top."""
    arch, base = CASES[case]
    return get_config(arch).reduced().replace(**base, **over)
