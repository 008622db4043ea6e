"""CUDA launches of the fused decode steps.

* ``policy_paged_attention_kernel`` (``csrc/policy_attn.cu``) replaces
  ``repro/kernels/policy_attn.py`` ``policy_paged_attention_kernel``:
  allocation / victim selection, paged attention with the new K/V row
  injected in-tile, and the F/R/clock score update, in one call (two
  launches: the pages' partials, then their fold and the score update).
* ``adaptive_policy_paged_attention_kernel`` (``csrc/adaptive_attn.cu``)
  replaces ``adaptive_policy_paged_attention_kernel``: the same step for the
  true-adaptive ARC/CAR pool, with the allocation miss and the per-page hit
  accesses of ``AdaptiveCore.on_access`` inside the call (the same two
  launches: the miss in every partials CTA at a page boundary, the hit
  accesses in the fold's last CTA of each sequence).

The pool K/V stay read-only; the caller scatters the new row at the returned
slot (``cache/paged_kv.py`` ``fused_decode_step`` /
``fused_adaptive_decode_step``).  The token index ``pos`` is a 0-d int32
tensor on the kernel's device, read by the kernels from device memory as the
Pallas kernels read ``pos_ref[0]``: no launch argument depends on its value,
so a captured CUDA graph replays the step at every position.
"""

from __future__ import annotations

import torch

from repro_torch.core.kv_policy import POLICY_ID
from repro_torch.kernels import _build
from repro_torch.kernels.paged_attn import (DTYPE_CODE, MAX_G, check_head_rows,
                                            check_inputs, split_buffers)
from repro_torch.kernels.ref import attn_scale

#: ``kind`` codes of the adaptive kernel
ADAPTIVE_KIND = {"arc": 0, "car": 1}
MAX_LANES = 1024  # kMaxLanes in csrc/adaptive_attn.cu


def check_pos(name: str, pos, device) -> None:
    """Raise unless ``pos`` is a 0-d int32 tensor on ``device`` (its value,
    which must be >= 0, stays on the device)."""
    if not (isinstance(pos, torch.Tensor) and pos.dim() == 0
            and pos.dtype == torch.int32 and pos.device == device):
        raise ValueError(f"{name}: pos must be a 0-d int32 tensor on {device}, got "
                         f"{pos!r}")


def policy_paged_attention_kernel(q, k_pages, v_pages, new_k, new_v, pos,
                                  f, r, page_start, clock, open_slot, *,
                                  policy: str):
    """q (B, KVH, G, hd); pages (B, P, page, KVH, hd) WITHOUT the new token;
    new_k/new_v (B, KVH, hd) in the pool's dtype; ``pos`` the token index
    shared by the batch (0-d int32 on the card); f/r/page_start (B, P) and
    clock/open_slot (B,) int32.  Returns ``(out, mass, slot, f', r', page_start', clock',
    open_slot')``.  One call: two launches (``paged_attn.split_ctas``),
    every CTA of the first running the allocation itself."""
    B, P, page, KVH, hd = k_pages.shape
    G = q.shape[2]
    check_inputs("policy_paged_attention", (q, k_pages, v_pages, new_k, new_v),
                 (f, r, page_start, clock, open_slot))
    if q.shape != (B, KVH, G, hd) or v_pages.shape != k_pages.shape \
            or new_k.shape != (B, KVH, hd) or new_v.shape != (B, KVH, hd) \
            or f.shape != (B, P) or r.shape != (B, P) \
            or page_start.shape != (B, P) or clock.shape != (B,) \
            or open_slot.shape != (B,) or G > MAX_G:
        raise ValueError("policy_paged_attention: inconsistent shapes "
                         f"q={tuple(q.shape)} k={tuple(k_pages.shape)}")
    check_pos("policy_paged_attention", pos, q.device)
    check_head_rows("policy_paged_attention", hd, q)
    dev = q.device
    out = torch.empty_like(q)
    mass = torch.empty((B, P), dtype=torch.float32, device=dev)
    slot = torch.empty((B,), dtype=torch.int32, device=dev)
    f2, r2, ps2 = (torch.empty_like(f) for _ in range(3))
    clock2, open2 = torch.empty_like(clock), torch.empty_like(open_slot)
    scratch, counters = split_buffers(B, P, KVH, G, hd, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _build.library().repro_policy_paged_attention(
        DTYPE_CODE[q.dtype], q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        new_k.data_ptr(), new_v.data_ptr(), pos.data_ptr(), f.data_ptr(), r.data_ptr(),
        page_start.data_ptr(), clock.data_ptr(), open_slot.data_ptr(),
        out.data_ptr(), mass.data_ptr(), slot.data_ptr(), f2.data_ptr(),
        r2.data_ptr(), ps2.data_ptr(), clock2.data_ptr(), open2.data_ptr(),
        scratch.data_ptr(), counters.data_ptr(),
        B, P, page, KVH, G, hd, attn_scale(hd), POLICY_ID[policy], stream)
    _build.check(err, "policy_paged_attention")
    return out, mass, slot, f2, r2, ps2, clock2, open2


def adaptive_policy_paged_attention_kernel(q, k_pages, v_pages, new_k, new_v,
                                           pos, f, r, page_start, clock,
                                           open_slot, blocks, tag, stamp, refbits,
                                           p_plane, ctr, *, kind: str, renorm_at):
    """The inputs of ``policy_paged_attention_kernel`` plus the ARC/CAR
    directory of each sequence: blocks/tag/stamp/refbits (B, L) int32 with
    2P <= L <= 1024, ``p_plane`` (B,) float32, ``ctr`` (B,) int32; ``kind``
    "arc" or "car"; ``renorm_at`` the core's stamp-renormalization ceiling (an
    int: the kernel always checks).  Returns the eight flat outputs followed
    by ``(blocks', tag', stamp', ref', p', ctr')``.  One call: two launches
    over the grids of ``paged_attn.split_ctas``."""
    B, P, page, KVH, hd = k_pages.shape
    G = q.shape[2]
    L = blocks.shape[1]
    name = "adaptive_policy_paged_attention"
    check_inputs(name, (q, k_pages, v_pages, new_k, new_v),
                 (f, r, page_start, clock, open_slot, blocks, tag, stamp, refbits,
                  ctr))
    if p_plane.dtype != torch.float32 or p_plane.device != q.device \
            or not p_plane.is_contiguous():
        raise ValueError(f"{name}: p must be a contiguous float32 tensor on {q.device}")
    if q.shape != (B, KVH, G, hd) or v_pages.shape != k_pages.shape \
            or new_k.shape != (B, KVH, hd) or new_v.shape != (B, KVH, hd) \
            or any(t.shape != (B, P) for t in (f, r, page_start)) \
            or any(t.shape != (B, L) for t in (blocks, tag, stamp, refbits)) \
            or any(t.shape != (B,) for t in (clock, open_slot, p_plane, ctr)) \
            or G > MAX_G or not 2 * P <= L <= MAX_LANES:
        raise ValueError(f"{name}: inconsistent shapes q={tuple(q.shape)} "
                         f"k={tuple(k_pages.shape)} blocks={tuple(blocks.shape)}")
    if kind not in ADAPTIVE_KIND:
        raise ValueError(f"{name}: kind {kind!r} not in {list(ADAPTIVE_KIND)}")
    if renorm_at is None or not -2**31 <= int(renorm_at) < 2**31:
        raise ValueError(f"{name}: renorm_at must be an int32, got {renorm_at!r}")
    check_pos(name, pos, q.device)
    dev = q.device
    out = torch.empty_like(q)
    mass = torch.empty((B, P), dtype=torch.float32, device=dev)
    slot = torch.empty((B,), dtype=torch.int32, device=dev)
    f2, r2, ps2 = (torch.empty_like(f) for _ in range(3))
    clock2, open2 = torch.empty_like(clock), torch.empty_like(open_slot)
    blk2, tag2, stp2, ref2 = (torch.empty_like(blocks) for _ in range(4))
    p2, ctr2 = torch.empty_like(p_plane), torch.empty_like(ctr)
    outs = (out, mass, slot, f2, r2, ps2, clock2, open2, blk2, tag2, stp2, ref2,
            p2, ctr2)
    scratch, counters = split_buffers(B, P, KVH, G, hd, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _build.library().repro_adaptive_policy_paged_attention(
        DTYPE_CODE[q.dtype], q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        new_k.data_ptr(), new_v.data_ptr(), pos.data_ptr(),
        *(t.data_ptr() for t in (f, r, page_start, clock, open_slot, blocks, tag,
                                 stamp, refbits, p_plane, ctr)),
        *(t.data_ptr() for t in outs), scratch.data_ptr(), counters.data_ptr(),
        B, P, page, KVH, G, hd, L, attn_scale(hd), ADAPTIVE_KIND[kind],
        int(renorm_at), stream)
    _build.check(err, name)
    return outs
