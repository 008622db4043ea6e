"""phi3.5-moe-42b-a6.6b [moe] — 16 experts, top-2.
[hf:microsoft/Phi-3.5-MoE-instruct; hf]

The reference's config also picks its expert sharding (EP); the port
runs on one card and carries no sharding fields.
"""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab=32064,
    n_experts=16,
    top_k=2,
    microbatches=16,
    capacity_factor=1.0,
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
    d_ff=192,
    vocab=512,
    n_experts=4,
    top_k=2,
)
