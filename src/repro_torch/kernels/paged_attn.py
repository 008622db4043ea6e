"""CUDA launch of the paged decode-attention kernel (``csrc/paged_attn.cu``).

Replaces ``repro/kernels/paged_attn.py`` ``paged_attention_kernel``.  This
module only validates, allocates the outputs and the scratch and launches on
the current stream; ``kernels/ops.py`` dispatches between it and the plain
version.

Kernels 3 and 4 run as two launches on the stream: one CTA per (page, kv
head, sequence) writes the page's partials to a scratch buffer
(``torch.empty``, ``split_scratch_floats`` floats), then one CTA per (query,
64-dim slice, kv head, sequence) folds them in page order (``split_ctas``
counts both grids).  The last fold CTA of a sequence, found with an atomic
counter, writes the mass; the counters live in one zeroed int32 buffer per
(device, stream) (``split_buffers``), and the kernel leaves them 0, so
launches on one stream reuse it.  A captured CUDA graph keeps the buffer of
the stream it was captured on: the serving engine captures every decode
graph on one stream it owns (``ServeEngine.capture_stream``), and its
warm-up makes the buffer before the capture.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attn_scale

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_G = 8  # kMaxG in paged_attn_common.cuh

_COUNTERS: dict = {}


def split_ctas(B: int, P: int, KVH: int, G: int, hd: int) -> int:
    """CTAs of one call of kernel 3 or 4: the partials grid (P, KVH, B) and
    the fold grid (G * ceil(hd / 64), KVH, B)."""
    return P * KVH * B + G * -(-hd // 64) * KVH * B


def split_scratch_floats(B: int, P: int, KVH: int, G: int, hd: int) -> int:
    """Floats of the partials' scratch (``split_scratch_floats`` in
    ``paged_attn_common.cuh``): pv (B, KVH, P, G, hd), psum and pmax (B, P,
    KVH, G), (m, l) (B, KVH*G, 2)."""
    R = KVH * G
    return B * P * R * hd + 2 * B * P * R + 2 * B * R


def split_buffers(B: int, P: int, KVH: int, G: int, hd: int, device):
    """(scratch, counters) of one call: the partials' scratch, and a zeroed
    int32 buffer of at least B counters for the current stream of
    ``device``, kept across calls (the kernels reset what they use)."""
    scratch = torch.empty(split_scratch_floats(B, P, KVH, G, hd), dtype=torch.float32,
                          device=device)
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    counters = _COUNTERS.get(key)
    if counters is None or counters.numel() < B:
        counters = torch.zeros(max(B, 1024), dtype=torch.int32, device=device)
        _COUNTERS[key] = counters
    return scratch, counters


def check_head_rows(name: str, hd: int, t: torch.Tensor) -> None:
    """Kernels 3 and 4 stage one kv head's slice of a row in 16-byte chunks."""
    if hd * t.element_size() % 16:
        raise ValueError(f"{name}: a head's row ({hd * t.element_size()} B) must be "
                         "a multiple of 16 bytes")


def check_inputs(name: str, floats, ints) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device,
    the float ones of one supported dtype and the int ones int32."""
    dev = floats[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: expected CUDA tensors, got {dev}")
    dtype = floats[0].dtype
    if dtype not in DTYPE_CODE:
        raise ValueError(f"{name}: dtype {dtype} not supported; have {list(DTYPE_CODE)}")
    for t in floats:
        if t.dtype != dtype:
            raise ValueError(f"{name}: mixed dtypes {dtype} and {t.dtype}")
    for t in ints:
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: int planes must be int32, got {t.dtype}")
    for t in (*floats, *ints):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous and on {dev}")
    # pages are staged in 16-byte chunks: rows and base pointers must align
    row_bytes = floats[1].shape[-1] * floats[1].shape[-2] * floats[1].element_size()
    if row_bytes % 16 or any(t.data_ptr() % 16 for t in floats):
        raise ValueError(f"{name}: K/V rows ({row_bytes} B) and float tensors "
                         "must be 16-byte aligned")


def paged_attention_kernel(q, k_pages, v_pages, page_start, cur_pos):
    """q (B, KVH, G, hd); pages (B, P, page, KVH, hd); page_start (B, P) and
    cur_pos (B,) int32 -> (out (B, KVH, G, hd) in q's dtype, mass (B, P)
    f32).  One call: two launches, ``split_ctas(B, P, KVH, G, hd)`` CTAs."""
    B, P, page, KVH, hd = k_pages.shape
    G = q.shape[2]
    check_inputs("paged_attention", (q, k_pages, v_pages), (page_start, cur_pos))
    if q.shape != (B, KVH, G, hd) or v_pages.shape != k_pages.shape \
            or page_start.shape != (B, P) or cur_pos.shape != (B,) or G > MAX_G:
        raise ValueError("paged_attention: inconsistent shapes "
                         f"q={tuple(q.shape)} k={tuple(k_pages.shape)}")
    check_head_rows("paged_attention", hd, q)
    out = torch.empty_like(q)
    mass = torch.empty((B, P), dtype=torch.float32, device=q.device)
    scratch, counters = split_buffers(B, P, KVH, G, hd, q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _build.library().repro_paged_attention(
        DTYPE_CODE[q.dtype], q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_start.data_ptr(), cur_pos.data_ptr(), out.data_ptr(),
        mass.data_ptr(), scratch.data_ptr(), counters.data_ptr(), B, P, page, KVH,
        G, hd, attn_scale(hd), stream)
    _build.check(err, "paged_attention")
    return out, mass
