"""gemma3-27b [dense] — 5:1 local:global attention, 128k context.

62 layers = 10 x (5 local + 1 global) + 2 local tail; sliding window 1024.
long_500k runs: local layers are O(window); the 1:6 global layers' KV is
AWRP-bounded (the paper's technique making the arch sub-quadratic end-to-end).
[hf:google/gemma-3-1b-pt; unverified]
"""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab=262144,
    act="gelu",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    pattern=("local",) * 5 + ("global",),
    n_repeats=10,
    tail=("local",) * 2,
    sliding_window=1024,
    microbatches=16,
    run_shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
    bounded_kv_pages=256,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG,
    n_layers=5,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=384,
    vocab=512,
    pattern=("local", "local", "global"),
    n_repeats=1,
    tail=("local", "local"),
    sliding_window=16,
    bounded_kv_pages=4,
    page_size=8,
)
