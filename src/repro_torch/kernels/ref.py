"""Plain PyTorch versions of the port's kernels.

* ``awrp_select_plain`` and ``awrp_select_rows_plain`` are the AWRP victim
  selection of kernels 1 and 2 (``csrc/awrp_select.cu``): the bit-pattern
  first-index min, not a float ``argmin``.

* ``paged_attention_plain`` and ``policy_paged_attention_plain`` follow their
  CUDA kernels' page-by-page flash recurrence (running ``m``/``l``/``acc``,
  per-page partial sums and maxima, the normalized per-page mass).  The
  wrappers in ``kernels/ops.py`` run them for tensors on the CPU; on the card
  ``chip_smoke.py`` holds each kernel against them.  Both share one page step,
  so on the CPU the fused version equals ``insert_token`` +
  ``paged_attention_plain`` + ``score_update`` bit for bit, the contract the
  kernels hold on the card.
* ``ref_paged_attention`` is the plain softmax over all rows
  (``repro/kernels/ref.py``), the oracle both are checked against.

All arithmetic is float32, whatever the pool's dtype.
"""

from __future__ import annotations

import math

import torch

from repro_torch.cache.paged_kv import allocate, score_planes
from repro_torch.core.policy_core import awrp_victim_rows

NEG_INF = -1e30


def attn_scale(hd: int) -> float:
    """The score scale ``1/sqrt(hd)`` as the float32 value every version
    multiplies by."""
    return float(torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32))


class _Flash:
    """Running flash-attention state of one decode step, all float32:
    ``m``/``l`` (B, KVH, G), ``acc`` (B, KVH, G, hd), and the per-page local
    sums and maxima ``psum``/``pmax`` (B, P, KVH, G)."""

    def __init__(self, q: torch.Tensor, n_pages: int):
        B, KVH, G, hd = q.shape
        dev = q.device
        self.m = torch.full((B, KVH, G), NEG_INF, dtype=torch.float32, device=dev)
        self.l = torch.zeros((B, KVH, G), dtype=torch.float32, device=dev)
        self.acc = torch.zeros((B, KVH, G, hd), dtype=torch.float32, device=dev)
        self.psum = torch.zeros((B, n_pages, KVH, G), dtype=torch.float32, device=dev)
        self.pmax = torch.full((B, n_pages, KVH, G), NEG_INF, dtype=torch.float32,
                               device=dev)

    def attend_page(self, q, k, v, start, cur, p_idx: int, scale: float):
        """One page: q (B, KVH, G, hd) f32; k/v (B, page, KVH, hd) f32;
        start/cur (B,) int32.  Rows are valid where ``start >= 0`` and
        ``start + row <= cur``."""
        page = k.shape[1]
        row = torch.arange(page, dtype=torch.int32, device=q.device)
        valid = (start[:, None] >= 0) & (start[:, None] + row[None] <= cur[:, None])
        vmask = valid[:, None, None, :]  # (B, 1, 1, page)
        s = torch.einsum("bkgh,bpkh->bkgp", q, k) * scale
        s = torch.where(vmask, s, NEG_INF)
        m_loc = s.amax(dim=-1)  # (B, KVH, G)
        p_exp = torch.exp(s - m_loc[..., None])
        p_exp = torch.where(vmask, p_exp, 0.0)
        ssum = p_exp.sum(dim=-1)
        m_new = torch.maximum(self.m, m_loc)
        corr = torch.exp(self.m - m_new)
        sc = torch.exp(m_loc - m_new)
        self.l = self.l * corr + ssum * sc
        pv = torch.einsum("bkgp,bpkh->bkgh", p_exp, v)
        self.acc = self.acc * corr[..., None] + pv * sc[..., None]
        self.m = m_new
        self.psum[:, p_idx] = ssum
        self.pmax[:, p_idx] = m_loc

    def finalize(self, out_dtype):
        """(out (B, KVH, G, hd) in ``out_dtype``, mass (B, P) f32)."""
        l = torch.clamp(self.l, min=1e-30)
        out = (self.acc / l[..., None]).to(out_dtype)
        w = torch.exp(self.pmax - self.m[:, None]) / l[:, None]
        mass = (self.psum * w).sum(dim=(2, 3))
        return out, mass


def _tile(pages: torch.Tensor, p_idx: int) -> torch.Tensor:
    return pages[:, p_idx].to(torch.float32).contiguous()


def paged_attention_plain(q, k_pages, v_pages, page_start, cur_pos):
    """q (B, KVH, G, hd); pages (B, P, page, KVH, hd); page_start (B, P)
    int32 (-1 = free); cur_pos (B,) int32 -> (out in q's dtype, mass (B, P)
    f32)."""
    P, hd = k_pages.shape[1], q.shape[-1]
    scale = attn_scale(hd)
    qf = q.to(torch.float32)
    st = _Flash(qf, P)
    for p_idx in range(P):
        st.attend_page(qf, _tile(k_pages, p_idx), _tile(v_pages, p_idx),
                       page_start[:, p_idx], cur_pos, p_idx, scale)
    return st.finalize(q.dtype)


def policy_paged_attention_plain(q, k_pages, v_pages, new_k, new_v, pos: int,
                                 f, r, page_start, clock, open_slot, *,
                                 policy: str):
    """The fused flat-policy decode step: allocation, attention with the new
    K/V row injected in-tile (the pool is only read), finalize and
    the score update.  Returns ``(out, mass, slot, f', r', page_start',
    clock', open_slot')``."""
    B, P, page = k_pages.shape[:3]
    hd = q.shape[-1]
    scale = attn_scale(hd)
    within = pos % page
    slot, fa, ra, psa = allocate(f, r, page_start, clock, open_slot, pos, page,
                                 policy)
    qf = q.to(torch.float32)
    nk = new_k.to(torch.float32)[:, None]  # (B, 1, KVH, hd)
    nv = new_v.to(torch.float32)[:, None]
    row = torch.arange(page, dtype=torch.int32, device=q.device)
    cur = torch.full((B,), pos, dtype=torch.int32, device=q.device)
    st = _Flash(qf, P)
    for p_idx in range(P):
        inject = ((slot[:, None] == p_idx) & (row[None] == within))[..., None, None]
        k = torch.where(inject, nk, _tile(k_pages, p_idx))
        v = torch.where(inject, nv, _tile(v_pages, p_idx))
        st.attend_page(qf, k, v, psa[:, p_idx], cur, p_idx, scale)
    out, mass = st.finalize(q.dtype)
    f2, r2, clock2 = score_planes(mass, fa, ra, psa, clock)
    open2 = slot if within == 0 else open_slot
    return out, mass, slot, f2, r2, psa, clock2, open2


def awrp_select_plain(f, r, clock, valid, pinned):
    """Plain version of kernel 1 (``repro/kernels/awrp_select.py``
    ``_masked_weight_first_min``): (B, P) int32 f/r and 0/1 valid/pinned,
    (B,) int32 clock -> (B,) int32 victim over ``valid & ~pinned`` lanes.
    Paper eq. (1) as ``f32(F) / f32(max(N - R, 1))``, keyed by the int32 bit
    pattern of the weight (INT_MAX on masked lanes), then the first lane
    achieving the row minimum: the policy core's inline AWRP victim.  A row
    with every lane masked gives lane 0."""
    return awrp_victim_rows(f, r, clock, (valid != 0) & (pinned == 0))


def awrp_select_rows_plain(f, r, clock, valid):
    """Plain version of kernel 2: the same without ``pinned``."""
    return awrp_victim_rows(f, r, clock, valid != 0)


def ref_paged_attention(q, k_pages, v_pages, page_start, cur_pos):
    """Plain softmax over every resident row: (out, page_mass)."""
    B, P, page, KVH, hd = k_pages.shape
    row = torch.arange(page, dtype=torch.int32, device=q.device)
    tok = page_start[..., None] + row
    valid = (page_start[..., None] >= 0) & (tok <= cur_pos[:, None, None])
    kf = k_pages.reshape(B, P * page, KVH, hd).to(torch.float32)
    vf = v_pages.reshape(B, P * page, KVH, hd).to(torch.float32)
    vmask = valid.reshape(B, P * page)[:, None, None]
    s = torch.einsum("bkgh,btkh->bkgt", q.to(torch.float32), kf) / math.sqrt(hd)
    s = torch.where(vmask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(vmask, p, 0.0)
    out = torch.einsum("bkgt,btkh->bkgh", p, vf)
    mass = p.sum(dim=(1, 2)).reshape(B, P, page).sum(-1)
    return out.to(q.dtype), mass
