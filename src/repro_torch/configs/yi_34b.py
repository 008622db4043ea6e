"""yi-34b [dense] — llama-arch GQA. [arXiv:2403.04652; hf]

Its serving weight layout is the reference's: feature dims sharded over
(batch x model) jointly with no gather (``decode_param_mode="tp2d"``).
"""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab=64000,
    rope_theta=5_000_000.0,
    microbatches=16,
    decode_param_mode="tp2d",
    run_shapes=("train_4k", "prefill_32k", "decode_32k"),
    skip_reasons={"long_500k": "pure full-attention arch (DESIGN.md §5)"},
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG,
    n_layers=3,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=384,
    vocab=512,
)
