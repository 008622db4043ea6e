"""CUDA launch of the flash-attention forward kernel (``csrc/flash_attn.cu``).

Replaces ``repro/kernels/flash_attn.py`` ``flash_attention_kernel``: the
port's prefill attention.  This module only validates, allocates the output
and launches on the current stream; ``kernels/ops.py`` dispatches between it
and the plain version.  The kernel takes any Sq / Skv and masks the ragged
edge itself: there is no padding.  bf16 runs both products on the tensor
cores (P.V as three bf16 products, p split into hi + mid + lo); f32 runs on the
CUDA cores.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attn import DTYPE_CODE
from repro_torch.kernels.ref import attn_scale

HEAD_DIMS = (64, 112, 128, 256)  # the kernel's instantiations
MAX_G = 64  # query heads per KV head: one 64-row tile holds at least one position


def flash_attention_kernel(q, k, v, *, causal: bool, window: int,
                           kv_len: int | None = None):
    """q (B, Sq, KVH, G, hd), k/v (B, Skv, KVH, hd), bf16 or f32, contiguous
    on one CUDA device -> out like q.  One launch."""
    name = "flash_attention"
    if q.dim() != 5 or k.dim() != 4:
        raise ValueError(f"{name}: q must be 5-D and k/v 4-D, got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, Sq, KVH, G, hd = q.shape
    Skv = k.shape[1]
    kv_len = Skv if kv_len is None else int(kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"{name}: expected CUDA tensors, got {q.device}")
    if q.dtype not in DTYPE_CODE:
        raise ValueError(f"{name}: dtype {q.dtype} not supported; have {list(DTYPE_CODE)}")
    for t in (q, k, v):
        if t.dtype != q.dtype or t.device != q.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: q/k/v must share dtype and device and be "
                             "contiguous and 16-byte aligned")
    if k.shape != (B, Skv, KVH, hd) or v.shape != k.shape or hd not in HEAD_DIMS \
            or not 1 <= G <= MAX_G or min(B, Sq, Skv, KVH) < 1:
        raise ValueError(f"{name}: unsupported shapes q={tuple(q.shape)} "
                         f"k={tuple(k.shape)} (hd in {HEAD_DIMS}, G <= {MAX_G})")
    if not 0 <= kv_len <= Skv or int(window) < 0:
        raise ValueError(f"{name}: kv_len {kv_len} / window {window} out of range")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _build.library().repro_flash_attention(
        DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), B, Sq, Skv, KVH, G, hd, int(bool(causal)), int(window),
        kv_len, attn_scale(hd), stream)
    _build.check(err, name)
    return out
