"""mamba2-370m [ssm] — pure SSD (state-space duality), attention-free.

48 mamba2 blocks, d_model 1024, d_inner 2048, headdim 64 (32 ssm heads),
state 128.  No KV cache => the paper's KV eviction is inapplicable (AWRP
still manages this arch's host prefix cache of SSM states — DESIGN.md §5);
long_500k runs with O(1) recurrent state.  [arXiv:2405.21060; unverified]
"""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_head_dim=64,
    pattern=("mamba",),
    n_repeats=48,
    microbatches=2,
    run_shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG,
    n_layers=4,
    d_model=128,
    ssm_state=16,
    ssm_head_dim=32,
    vocab=512,
    pattern=("mamba",),
    n_repeats=4,
    ssm_chunk=32,
)
