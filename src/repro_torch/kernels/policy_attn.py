"""CUDA launch of the fused flat-policy decode step (``csrc/policy_attn.cu``).

Replaces ``repro/kernels/policy_attn.py``
``policy_paged_attention_kernel``: allocation / victim selection, paged
attention with the new K/V row injected in-tile, and the F/R/clock score
update, in one launch.  The pool K/V stay read-only; the caller scatters the
new row at the returned slot (``cache/paged_kv.py`` ``fused_decode_step``).
The true-adaptive ARC/CAR variant (``adaptive_policy_paged_attention_kernel``)
is not ported yet.
"""

from __future__ import annotations

import torch

from repro_torch.core.kv_policy import POLICY_ID
from repro_torch.kernels import _build
from repro_torch.kernels.paged_attn import DTYPE_CODE, MAX_G, check_inputs
from repro_torch.kernels.ref import attn_scale


def policy_paged_attention_kernel(q, k_pages, v_pages, new_k, new_v, pos: int,
                                  f, r, page_start, clock, open_slot, *,
                                  policy: str):
    """q (B, KVH, G, hd); pages (B, P, page, KVH, hd) WITHOUT the new token;
    new_k/new_v (B, KVH, hd) in the pool's dtype; ``pos`` the token index
    shared by the batch; f/r/page_start (B, P) and clock/open_slot (B,)
    int32.  Returns ``(out, mass, slot, f', r', page_start', clock',
    open_slot')``.  One launch."""
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
    if not 0 <= int(pos) < 2**31:
        raise ValueError(f"policy_paged_attention: pos {pos} out of int32 range")
    dev = q.device
    out = torch.empty_like(q)
    mass = torch.empty((B, P), dtype=torch.float32, device=dev)
    slot = torch.empty((B,), dtype=torch.int32, device=dev)
    f2, r2, ps2 = (torch.empty_like(f) for _ in range(3))
    clock2, open2 = torch.empty_like(clock), torch.empty_like(open_slot)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _build.library().repro_policy_paged_attention(
        DTYPE_CODE[q.dtype], q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        new_k.data_ptr(), new_v.data_ptr(), int(pos), f.data_ptr(), r.data_ptr(),
        page_start.data_ptr(), clock.data_ptr(), open_slot.data_ptr(),
        out.data_ptr(), mass.data_ptr(), slot.data_ptr(), f2.data_ptr(),
        r2.data_ptr(), ps2.data_ptr(), clock2.data_ptr(), open2.data_ptr(),
        B, P, page, KVH, G, hd, attn_scale(hd), POLICY_ID[policy], stream)
    _build.check(err, "policy_paged_attention")
    return out, mass, slot, f2, r2, ps2, clock2, open2
