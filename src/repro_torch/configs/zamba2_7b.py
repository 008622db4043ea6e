"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention blocks.

81 blocks: 13 repeats of (5 mamba + 1 shared-attention) + 3 mamba tail.
The shared-attention block's parameters are shared across all 13 occurrences
(Zamba2's defining trick).  [arXiv:2411.15242; unverified]
"""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,  # 3584 / 32
    d_ff=14336,
    vocab=32000,
    ssm_state=64,
    ssm_head_dim=64,
    pattern=("mamba",) * 5 + ("shared_attn",),
    n_repeats=13,
    tail=("mamba",) * 3,
    # hybrid: shared-attention KV is AWRP-bounded for long-context decode;
    # mamba blocks carry O(1) SSM state => long_500k runs (DESIGN.md §5)
    microbatches=4,
    run_shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
    bounded_kv_pages=256,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG,
    n_layers=7,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    head_dim=32,
    d_ff=256,
    vocab=512,
    ssm_state=16,
    ssm_head_dim=32,
    pattern=("mamba",) * 2 + ("shared_attn",),
    n_repeats=2,
    tail=("mamba",),
    ssm_chunk=32,
    bounded_kv_pages=4,
    page_size=8,
)
