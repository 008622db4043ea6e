"""Model configuration for the port (``repro/configs/base.py``'s fields that
the serving slice reads, with the same names and defaults).

The port serves stacks of full-attention (``"attn"``, ``"global"``),
sliding-window (``"local"``), MoE (``"moe"``: full attention and a top-k
expert FFN), Mamba-2 (``"mamba"``: the SSD recurrence, no MLP) and shared
attention (``"shared_attn"``: an attention + MLP block whose parameters every
occurrence shares, zamba2's) blocks, as a homogeneous ``"attn"`` or
``"moe"`` stack or a repeating ``pattern`` unit plus a ``tail`` (gemma3's 5
local + 1 global, zamba2's 5 mamba + 1 shared attention); ``qkv_bias`` adds
the q/k/v biases (qwen2.5).  The encoder-decoder family (whisper) stacks
``enc_layers`` encoder and ``dec_layers`` decoder blocks; the VLM family
(internvl2) is a decoder stack whose first ``n_patch_tokens`` positions take
the patch embeddings.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

__all__ = ["ModelConfig"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    # transformer core
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab: int = 0
    act: str = "swiglu"  # swiglu | gelu
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # layer pattern: repeating unit + tail.  None => homogeneous ("attn" or
    # "moe") stack.
    pattern: Optional[Tuple[str, ...]] = None
    n_repeats: int = 0
    tail: Tuple[str, ...] = ()
    sliding_window: int = 0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    d_conv: int = 4
    # encoder-decoder
    enc_layers: int = 0
    dec_layers: int = 0
    enc_seq_divisor: int = 2  # encoder frames = seq_len // divisor (stub)
    cross_kv_len: int = 1_500  # fixed encoder context for decode shapes
    # modality stub (vlm)
    n_patch_tokens: int = 0
    # serving / paged KV (the paper's technique)
    page_size: int = 64
    bounded_kv_pages: int = 256
    kv_policy: str = "awrp"  # awrp | lru | fifo | lfu | arc | car | arc_adaptive | car_adaptive
    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    # training execution (carried so published configs copy verbatim)
    microbatches: int = 8
    run_shapes: Tuple[str, ...] = ("train_4k", "prefill_32k", "decode_32k")
    skip_reasons: Dict[str, str] = dataclasses.field(default_factory=dict)

    # ---- derived -----------------------------------------------------------
    @property
    def layer_pattern(self) -> Tuple[str, ...]:
        if self.pattern is None:
            unit = ("moe",) if self.n_experts else ("attn",)
            return unit * self.n_layers
        return self.pattern * self.n_repeats + self.tail

    @property
    def qk_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:  # mamba2
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim
