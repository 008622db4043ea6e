"""internvl2-26b [vlm] — InternViT + InternLM2 backbone.

Per the protocol, only the LM BACKBONE is modelled; the vision frontend is a
STUB: ``input_specs()`` provides 256 precomputed patch embeddings that are
folded into the sequence (first 256 positions).  [arXiv:2404.16821; hf]
"""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=92553,
    n_patch_tokens=256,
    microbatches=8,
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
    n_patch_tokens=8,
)
