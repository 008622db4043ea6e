"""smollm-360m [dense] — llama-arch small. [hf:HuggingFaceTB/SmolLM-135M; hf]"""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab=49152,
    tie_embeddings=True,
    microbatches=2,
    run_shapes=("train_4k", "prefill_32k", "decode_32k"),
    skip_reasons={"long_500k": "pure full-attention arch (DESIGN.md §5)"},
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG,
    n_layers=3,
    d_model=96,
    n_heads=3,
    n_kv_heads=1,
    head_dim=32,
    d_ff=256,
    vocab=512,
)
