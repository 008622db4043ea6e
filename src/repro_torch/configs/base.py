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

The training fields (``remat``, ``microbatches``, ``adam_dtype``,
``grad_accum_dtype``, ``opt_master``, ``grad_compress``) and the shape grid
``SHAPES`` are the reference's, read by ``models/model.py`` ``forward``,
``train/train_step.py`` and ``launch/train.py``.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

__all__ = ["ModelConfig", "ShapeSpec", "SHAPES", "ARCH_IDS", "load_config",
           "load_smoke_config"]

ARCH_IDS = (
    "zamba2_7b",
    "qwen25_14b",
    "gemma3_27b",
    "smollm_360m",
    "yi_34b",
    "internvl2_26b",
    "grok1_314b",
    "phi35_moe",
    "whisper_large_v3",
    "mamba2_370m",
)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One cell of the (arch x shape) grid."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


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
    moe_sharding: str = "tp"  # tp | ep: the experts' "model" split (sharding/specs.py)
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
    # numerics / execution
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    remat: str = "full"  # none | full
    # training execution
    microbatches: int = 8  # grad-accum chunks of the global batch
    adam_dtype: str = "float32"
    grad_accum_dtype: str = "float32"
    opt_master: bool = True
    grad_compress: bool = False  # int8 quant -> dequant of the matrix grads
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


def _arch_module(arch: str):
    arch = arch.replace("-", "_").replace(".", "")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def load_config(arch: str) -> ModelConfig:
    return _arch_module(arch).CONFIG


def load_smoke_config(arch: str) -> ModelConfig:
    return _arch_module(arch).SMOKE_CONFIG
