"""CUDA launches of the flash-attention kernels (``csrc/flash_attn.cu``,
``csrc/flash_attn_bwd.cu``).

``flash_attention_kernel`` replaces ``repro/kernels/flash_attn.py``
``flash_attention_kernel``: the port's prefill attention.  This module only
validates, allocates the outputs and launches on the current stream;
``kernels/ops.py`` dispatches between it and the plain version.  The kernel
takes any Sq / Skv and masks the ragged edge itself: there is no padding.
bf16 runs both products on the tensor cores with ``wgmma``, K and V staged
by TMA (P.V as three bf16 products, p split into hi + mid + lo); f32 runs on
the CUDA cores.  With
``return_lse=True`` it also returns the rows' log-sum-exp (B, Sq, KVH, G) in
f32, which ``flash_attention_backward_kernel`` takes: the gradient of the
same function (port-only: the reference's gradient is XLA's derivative of
its jnp attention), three launches, for the training path's attention
(self-attention, and cross-attention at Sq != Skv, under every mask the
forward takes); bf16 runs its five products on the tensor cores (p and dS rounded once to
bf16 as operands), f32 on the CUDA cores.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attn import DTYPE_CODE
from repro_torch.kernels.ref import attn_scale

#: the kernel's instantiations; each is a multiple of 8, so every global
#: stride of the bf16 kernel's TMA maps (hd, KVH * hd and KVH * G * hd
#: elements of 2 bytes) is a multiple of 16 bytes, as TMA requires
HEAD_DIMS = (64, 112, 128, 256)
BWD_HEAD_DIMS = (64, 112, 128)  # the backward's
MAX_G = 64  # query heads per KV head: one 64-row tile holds at least one position


def flash_attention_kernel(q, k, v, *, causal: bool, window: int,
                           kv_len: int | None = None, return_lse: bool = False):
    """q (B, Sq, KVH, G, hd), k/v (B, Skv, KVH, hd), bf16 or f32, contiguous
    on one CUDA device -> out like q; with ``return_lse`` (out, lse (B, Sq,
    KVH, G) f32).  One launch; ``out`` has the same bits either way."""
    name = "flash_attention"
    if q.dim() != 5 or k.dim() != 4:
        raise ValueError(f"{name}: q must be 5-D and k/v 4-D, got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, Sq, KVH, G, hd = q.shape
    Skv = k.shape[1]
    kv_len = Skv if kv_len is None else int(kv_len)
    if k.shape != (B, Skv, KVH, hd) or v.shape != k.shape or hd not in HEAD_DIMS \
            or not 1 <= G <= MAX_G or min(B, Sq, Skv, KVH) < 1:
        raise ValueError(f"{name}: unsupported shapes q={tuple(q.shape)} "
                         f"k={tuple(k.shape)} (hd in {HEAD_DIMS}, G <= {MAX_G})")
    if q.device.type != "cuda":
        raise ValueError(f"{name}: expected CUDA tensors, got {q.device}")
    if q.dtype not in DTYPE_CODE:
        raise ValueError(f"{name}: dtype {q.dtype} not supported; have {list(DTYPE_CODE)}")
    for t in (q, k, v):
        if t.dtype != q.dtype or t.device != q.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: q/k/v must share dtype and device and be "
                             "contiguous and 16-byte aligned")
    if not 0 <= kv_len <= Skv or int(window) < 0:
        raise ValueError(f"{name}: kv_len {kv_len} / window {window} out of range")
    out = torch.empty_like(q)
    lse = (torch.empty((B, Sq, KVH, G), dtype=torch.float32, device=q.device)
           if return_lse else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _build.library().repro_flash_attention(
        DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), 0 if lse is None else lse.data_ptr(), B, Sq, Skv, KVH, G, hd,
        int(bool(causal)), int(window), kv_len, attn_scale(hd), stream)
    _build.check(err, name)
    return out if lse is None else (out, lse)


def check_backward_case(q_shape, k_shape, kv_len, *, kernel: bool = True,
                        name: str = "flash_attention_bwd") -> None:
    """Raise a ``ValueError`` naming the case for what the backward does not
    take: a ``kv_len`` outside [0, Skv] and, for the kernel (``kernel``), hd
    outside ``BWD_HEAD_DIMS`` (the plain version takes any hd).  Sq and Skv
    may differ."""
    hd, Skv = q_shape[-1], k_shape[1]
    if kv_len is not None and not 0 <= kv_len <= Skv:
        raise ValueError(f"{name}: kv_len {kv_len} out of range [0, {Skv}]")
    if kernel and hd not in BWD_HEAD_DIMS:
        raise ValueError(f"{name}: hd {hd} is not supported; have {BWD_HEAD_DIMS}")


def flash_attention_backward_kernel(q, k, v, out, lse, dout, *, causal: bool,
                                    window: int, kv_len: int | None = None):
    """Gradient of ``flash_attention_kernel`` under the same masks: q, out,
    dout (B, Sq, KVH, G, hd), k/v (B, Skv, KVH, hd), bf16 or f32, lse (B,
    Sq, KVH, G) f32, contiguous on one CUDA device -> (dq, dk, dv) in the
    inputs' dtype; keys at or past ``kv_len`` get zero gradients.  Three
    launches (D = rowsum(dout * out), dK/dV, dQ), f32 sums in a fixed order,
    no atomics; bf16 tensors 16-byte aligned."""
    name = "flash_attention_bwd"
    if q.dim() != 5 or k.dim() != 4:
        raise ValueError(f"{name}: q must be 5-D and k/v 4-D, got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    check_backward_case(q.shape, k.shape, kv_len, name=name)
    B, Sq, KVH, G, hd = q.shape
    Skv = k.shape[1]
    kv_len = Skv if kv_len is None else int(kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"{name}: expected CUDA tensors, got {q.device}")
    if q.dtype not in DTYPE_CODE:
        raise ValueError(f"{name}: dtype {q.dtype} not supported; have {list(DTYPE_CODE)}")
    for t in (q, k, v, out, dout):
        if t.dtype != q.dtype or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name}: q/k/v/out/dout must share dtype and device and "
                             "be contiguous")
        if t.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"{name}: bf16 q/k/v/out/dout must be 16-byte aligned "
                             "(the tensor-core kernels stage them with cp.async)")
    if (k.shape != (B, Skv, KVH, hd) or v.shape != k.shape or out.shape != q.shape
            or dout.shape != q.shape or not 1 <= G <= MAX_G or min(B, Sq, Skv, KVH) < 1):
        raise ValueError(f"{name}: unsupported shapes q={tuple(q.shape)} "
                         f"k={tuple(k.shape)} out={tuple(out.shape)} "
                         f"dout={tuple(dout.shape)} (G <= {MAX_G})")
    if (lse.shape != (B, Sq, KVH, G) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"{name}: lse must be contiguous f32 (B, Sq, KVH, G) on q's "
                         f"device, got {tuple(lse.shape)} {lse.dtype}")
    if int(window) < 0:
        raise ValueError(f"{name}: window {window} out of range")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    rowsum = torch.empty((B, Sq, KVH, G), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _build.library().repro_flash_attention_bwd(
        DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        rowsum.data_ptr(), B, Sq, Skv, KVH, G, hd, int(bool(causal)), int(window), kv_len,
        attn_scale(hd), stream)
    _build.check(err, name)
    return dq, dk, dv
