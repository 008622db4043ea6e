"""whisper-large-v3 [audio] — encoder-decoder transformer backbone.

Conv frontend is a STUB per the protocol: ``input_specs()`` provides
precomputed frame embeddings (B, seq/2, d) standing in for the mel+conv stem
output; decoder runs on seq_len tokens.  32 encoder + 32 decoder layers, MHA
(kv=20 == heads), GELU.  Real Whisper decodes <=448 tokens; the 32k/500k
shapes are protocol shape exercises on the backbone (DESIGN.md §5) — long_500k
is skipped (full attention, enc-dec).  [arXiv:2212.04356; unverified]
"""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=32,  # per side
    enc_layers=32,
    dec_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab=51866,
    act="gelu",
    enc_seq_divisor=2,
    cross_kv_len=1500,
    microbatches=8,
    run_shapes=("train_4k", "prefill_32k", "decode_32k"),
    skip_reasons={"long_500k": "enc-dec full attention; real decoder is 448 tokens (DESIGN.md §5)"},
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG,
    n_layers=2,
    enc_layers=2,
    dec_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    head_dim=32,
    d_ff=256,
    vocab=512,
    cross_kv_len=24,
)
