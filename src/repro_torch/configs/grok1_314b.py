"""grok-1-314b [moe] — 8 experts, top-2. [hf:xai-org/grok-1; unverified]

Its decode weight layout (``decode_param_mode="tp2d"``) and expert
sharding (``moe_sharding="tp"``) are the reference's.
Its weights exceed one card: ``launch.serve`` refuses the full config, and
the smoke config is the GELU-expert case of the CPU parity tests.
"""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab=131072,
    n_experts=8,
    top_k=2,
    act="gelu",
    microbatches=16,
    # 314B params: bf16 Adam states and gradient accumulation, no f32 master
    adam_dtype="bfloat16",
    grad_accum_dtype="bfloat16",
    opt_master=False,
    decode_param_mode="tp2d",
    run_shapes=("train_4k", "prefill_32k", "decode_32k"),
    skip_reasons={"long_500k": "pure full-attention arch (DESIGN.md §5)"},
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG,
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab=512,
    n_experts=4,
    top_k=2,
)
