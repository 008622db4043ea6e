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
* ``adaptive_policy_paged_attention_plain`` is kernel 5
  (``csrc/adaptive_attn.cu``), the same step for the true-adaptive ARC/CAR
  pool, built from the unfused chain's allocation and hit passes, so it
  equals ``adaptive_insert_token`` + ``paged_attention_plain`` +
  ``adaptive_score_update`` bit for bit.
* ``flat_sweep_plain`` and ``adaptive_sweep_plain`` are the persistent trace
  kernels (``csrc/sweep.cu``; the first is kernel 2 redesigned) as the eager
  loop they replace: ``FlatCore.on_access`` (inline victim) or
  ``AdaptiveCore.on_access`` at every step of the trace.
* ``flat_stream_plain`` and ``adaptive_stream_plain`` are the same kernels'
  stream mode (the tenancy manager's ``access_stream``) as the reference's
  scan body: a loop of masked ``on_access_counted`` calls, access t active
  on row ``stream_rows[t]`` alone.
* ``flash_attention_plain`` is kernel 6 (``csrc/flash_attn.cu``), the
  prefill attention with causal, sliding-window and ``kv_len`` masks.
* ``ref_paged_attention`` is the plain softmax over all rows
  (``repro/kernels/ref.py``), the oracle both are checked against.

All arithmetic is float32, whatever the pool's dtype.
"""

from __future__ import annotations

import math

import torch

from repro_torch.cache.paged_kv import (_hit, adaptive_allocate, adaptive_hits,
                                       allocate, score_planes)
from repro_torch.core.policy_core import (AdaptiveCore, AdaptiveState, FlatCore,
                                          awrp_victim_rows)

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

    @staticmethod
    def partials(q, k, v, start, cur, scale: float):
        """What one page contributes, from the query and that page alone:
        ``(m_loc, ssum, pv)``, its local max, its sum of exponentials and
        its unscaled P.V.  q (B, KVH, G, hd) f32; k/v (B, page, KVH, hd) f32;
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
        pv = torch.einsum("bkgp,bpkh->bkgh", p_exp, v)
        return m_loc, ssum, pv

    def fold(self, p_idx: int, m_loc, ssum, pv):
        """Fold page ``p_idx``'s partials into the running state; pages are
        folded in page order, whatever order their partials were computed
        in."""
        m_new = torch.maximum(self.m, m_loc)
        corr = torch.exp(self.m - m_new)
        sc = torch.exp(m_loc - m_new)
        self.l = self.l * corr + ssum * sc
        self.acc = self.acc * corr[..., None] + pv * sc[..., None]
        self.m = m_new
        self.psum[:, p_idx] = ssum
        self.pmax[:, p_idx] = m_loc

    def attend(self, q, tile, page_start, cur, scale: float):
        """Every page in page order: its partials, then their fold (the CUDA
        kernels 3 and 4 compute the partials in parallel and fold them in
        page order).  ``tile(p)`` gives page p's f32 (k, v), each (B, page,
        KVH, hd)."""
        for p in range(self.psum.shape[1]):
            self.fold(p, *self.partials(q, *tile(p), page_start[:, p], cur, scale))

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
    qf = q.to(torch.float32)
    st = _Flash(qf, P)
    st.attend(qf, lambda p: (_tile(k_pages, p), _tile(v_pages, p)), page_start,
              cur_pos, attn_scale(hd))
    return st.finalize(q.dtype)


def _injected_attention(q, k_pages, v_pages, new_k, new_v, pos, slot,
                        page_start):
    """Attention of the fused steps over the post-allocation pool, the new
    K/V row injected in-tile at (slot, pos % page) (the pool is only read):
    ``(out, mass)``."""
    B, P, page = k_pages.shape[:3]
    within = pos % page
    qf = q.to(torch.float32)
    nk = new_k.to(torch.float32)[:, None]  # (B, 1, KVH, hd)
    nv = new_v.to(torch.float32)[:, None]
    row = torch.arange(page, dtype=torch.int32, device=q.device)
    cur = pos.expand(B)

    def tile(p_idx):
        inject = ((slot[:, None] == p_idx) & (row[None] == within))[..., None, None]
        return (torch.where(inject, nk, _tile(k_pages, p_idx)),
                torch.where(inject, nv, _tile(v_pages, p_idx)))

    st = _Flash(qf, P)
    st.attend(qf, tile, page_start, cur, attn_scale(q.shape[-1]))
    return st.finalize(q.dtype)


def policy_paged_attention_plain(q, k_pages, v_pages, new_k, new_v, pos,
                                 f, r, page_start, clock, open_slot, *,
                                 policy: str):
    """The fused flat-policy decode step: allocation, attention with the new
    K/V row injected in-tile (the pool is only read), finalize and
    the score update; ``pos`` a 0-d int32 tensor, as the kernel reads it.
    Returns ``(out, mass, slot, f', r', page_start', clock', open_slot')``:
    the open slot is the allocated one at a page boundary, else unchanged,
    which is ``slot`` either way."""
    page = k_pages.shape[2]
    slot, fa, ra, psa = allocate(f, r, page_start, clock, open_slot, pos, page,
                                 policy)
    out, mass = _injected_attention(q, k_pages, v_pages, new_k, new_v, pos, slot,
                                    psa)
    f2, r2, clock2 = score_planes(mass, fa, ra, psa, clock)
    return out, mass, slot, f2, r2, psa, clock2, slot


def adaptive_policy_paged_attention_plain(q, k_pages, v_pages, new_k, new_v,
                                          pos, f, r, page_start, clock,
                                          open_slot, blocks, tag, stamp, refbits,
                                          p_plane, ctr, *, kind: str, renorm_at):
    """Plain version of kernel 5, the fused true-adaptive (arc/car) decode
    step, from the pieces of the unfused chain: the allocation as one masked
    ``AdaptiveCore.on_access`` miss with the demoted page mapped to its slot
    (``adaptive_allocate``), attention with the new row injected, finalize,
    the F/R/clock score update, then P masked hit accesses in slot order
    (``adaptive_hits``).  The directory planes are (B, L) int32 (L = 2P
    lanes), ``p_plane`` (B,) f32, ``ctr`` (B,) int32; the core has capacity P
    and ``renorm_at``.  Returns the flat step's eight outputs followed by
    the six updated directory planes, (B, L) and (B,).  Like the kernel it
    reads nothing back to the host for ARC (the renormalization check is
    masked); CAR's clock-hand sweep reads it once per trip."""
    B, P, page = k_pages.shape[:3]
    core = AdaptiveCore(kind=kind, caps=(P,) * B, lanes=blocks.shape[1],
                        renorm_at=renorm_at, masked_renorm=True)
    state = AdaptiveState(blocks[:, None], tag[:, None], stamp[:, None],
                          refbits[:, None], p_plane[:, None], ctr[:, None])
    slot, fa, ra, psa, state = adaptive_allocate(core, state, f, r, page_start,
                                                 clock, open_slot, pos, page)
    out, mass = _injected_attention(q, k_pages, v_pages, new_k, new_v, pos, slot,
                                    psa)
    f2, r2, clock2 = score_planes(mass, fa, ra, psa, clock)
    state = adaptive_hits(core, state, psa, _hit(mass, psa), page)
    return (out, mass, slot, f2, r2, psa, clock2, slot,
            *(t[:, 0] for t in state))


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


def _sweep(core, traces, row_trace, **kw):
    """``core.on_access`` over every step of each row's trace, from an empty
    state: ``(hits (rows, T) bool, final state)``."""
    ids = traces[row_trace.long()].T.contiguous()  # (T, rows)
    hits = torch.empty(ids.shape[::-1], dtype=torch.bool, device=traces.device)
    state = core.init(device=traces.device)
    for t in range(ids.shape[0]):
        state, hits[:, t] = core.on_access(state, ids[t], **kw)
    return hits, state


def flat_sweep_plain(traces, row_trace, pids, ways, *, num_sets: int, lanes: int):
    """Plain version of ``flat_sweep_kernel``: traces (N, T) int32; row_trace,
    pids, ways (rows,) int32 -> ``(hits (rows, T) bool, final FlatState)``."""
    core = FlatCore(pids=tuple(pids.tolist()), ways=tuple(ways.tolist()),
                    num_sets=num_sets, lanes=lanes)
    return _sweep(core, traces, row_trace)


def adaptive_sweep_plain(traces, row_trace, caps, *, kind: str, num_sets: int,
                         lanes: int, renorm_at):
    """Plain version of ``adaptive_sweep_kernel``: traces (N, T) int32;
    row_trace, caps (rows,) int32 -> ``(hits (rows, T) bool, final
    AdaptiveState)``; ``renorm_at`` None skips the renormalization check."""
    core = AdaptiveCore(kind=kind, caps=tuple(caps.tolist()), num_sets=num_sets,
                        lanes=lanes, renorm_at=renorm_at)
    return _sweep(core, traces, row_trace, caps=caps)


def _stream(core, keys, stream_rows, state, counters, alpha: float, ring=None):
    """Masked ``core.on_access_counted`` at every access of the stream, access
    t active on row ``stream_rows[t]`` alone: ``(hits (T,) bool, final state,
    final counters)``, and with a decision-trace ``ring`` the new ring (one
    event per access) as a fourth output."""
    rows = stream_rows.tolist()
    hits = torch.zeros(len(rows), dtype=torch.bool, device=keys.device)
    lane = torch.arange(core.rows, device=keys.device)
    for t, r in enumerate(rows):
        out = core.on_access_counted(state, counters, keys[t].expand(core.rows),
                                     active=lane == r, pressure_alpha=alpha, ring=ring)
        state, counters, hit = out[:3]
        if ring is not None:
            ring = out[3]
        hits[t] = hit[r]
    return (hits, state, counters) if ring is None else (hits, state, counters, ring)


def _single_set(name: str, blocks, dims: int) -> None:
    if blocks.dim() != dims or (dims == 3 and blocks.shape[1] != 1):
        raise ValueError(f"{name}: the stream mode takes num_sets == 1, got planes "
                         f"{tuple(blocks.shape)}")


def flat_stream_plain(keys, stream_rows, state, counters, pids, ways, *, alpha: float,
                      ring=None):
    """Plain version of ``flat_stream_kernel``: keys, stream_rows (T,) int32;
    a single-set ``FlatState`` and its ``RowCounters``; pids, ways (rows,)
    int32 -> ``(hits (T,) bool, final FlatState, final RowCounters)``, and
    with a ``DecisionRing`` the new ring fourth (its ring variant)."""
    _single_set("flat_stream", state.blocks, 2)
    core = FlatCore(pids=tuple(pids.tolist()), ways=tuple(ways.tolist()),
                    lanes=state.blocks.shape[1])
    return _stream(core, keys, stream_rows, state, counters, alpha, ring)


def adaptive_stream_plain(keys, stream_rows, state, counters, caps, *, kind: str,
                          alpha: float, renorm_at, ring=None):
    """Plain version of ``adaptive_stream_kernel``: keys, stream_rows (T,)
    int32; an ``AdaptiveState`` with num_sets == 1 and its ``RowCounters``;
    caps (rows,) int32 -> ``(hits (T,) bool, final AdaptiveState, final
    RowCounters)``, and with a ``DecisionRing`` the new ring fourth;
    ``renorm_at`` None skips the renormalization check."""
    _single_set("adaptive_stream", state.blocks, 3)
    core = AdaptiveCore(kind=kind, caps=tuple(caps.tolist()), lanes=state.blocks.shape[2],
                        renorm_at=renorm_at)
    return _stream(core, keys, stream_rows, state, counters, alpha, ring)


def _flash_mask(Sq: int, Skv: int, causal: bool, window: int, kv_len: int, device):
    """(Sq, Skv) bool: query position i sees key j."""
    qpos = torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Skv, device=device)[None, :]
    mask = kpos < kv_len
    if causal:
        mask = mask & (kpos <= qpos)
    if window:
        mask = mask & (qpos - kpos < window)
    return mask


def flash_attention_plain(q, k, v, *, causal: bool, window: int = 0,
                          kv_len: int | None = None, return_lse: bool = False):
    """Plain version of kernel 6 (``csrc/flash_attn.cu``), the function of
    ``repro/kernels/flash_attn.py`` ``flash_attention_kernel``: q (B, Sq,
    KVH, G, hd), k/v (B, Skv, KVH, hd) -> out like q, in q's dtype.  Query
    position i sees key j where ``j < kv_len``, ``j <= i`` if causal and
    ``i - j < window`` if window; f32 scores scaled by 1/sqrt(hd), masked
    scores NEG_INF, masked p 0 and ``l`` clamped at 1e-30, so a fully masked
    row gives 0.  One softmax over all keys, p kept in f32 for P.V.  With
    ``return_lse`` also the rows' log-sum-exp m + log(l) (B, Sq, KVH, G) in
    f32, NEG_INF for a fully masked row."""
    B, Sq, KVH, G, hd = q.shape
    Skv = k.shape[1]
    kv_len = Skv if kv_len is None else kv_len
    mask = _flash_mask(Sq, Skv, causal, window, kv_len, q.device)
    s = torch.einsum("bqkgh,bckh->bkgqc", q.to(torch.float32),
                     k.to(torch.float32)) * attn_scale(hd)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(mask, p, 0.0)
    l_raw = p.sum(dim=-1)  # (B, KVH, G, Sq)
    l = torch.clamp(l_raw, min=1e-30)
    out = torch.einsum("bkgqc,bckh->bqkgh", p, v.to(torch.float32))
    out = (out / l.permute(0, 3, 1, 2)[..., None]).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l_raw > 0, m[..., 0] + torch.log(l), NEG_INF)
    return out, lse.permute(0, 3, 1, 2).contiguous()


def flash_pairs(Sq: int, Skv: int, causal: bool, window: int, kv_len: int | None) -> int:
    """(query, key) pairs ``_flash_mask`` leaves, in closed form: row i sees
    keys [max(0, i - window + 1) if window, min(i, kv_len - 1) if causal
    else kv_len - 1]."""
    kv_len = Skv if kv_len is None else min(kv_len, Skv)
    i = torch.arange(Sq, dtype=torch.int64)
    hi = torch.full_like(i, kv_len - 1)
    if causal:
        hi = torch.minimum(hi, i)
    lo = (i - window + 1).clamp_min(0) if window else torch.zeros_like(i)
    return int((hi - lo + 1).clamp_min(0).sum())


def flash_attention_meta(q, k, v, *, causal: bool, window: int = 0,
                         kv_len: int | None = None, return_lse: bool = False):
    """Kernel 6 on ``meta`` tensors: ``flash_attention_plain``'s outputs'
    shapes and dtypes, and the FLOPs the kernel spends (4·hd a query head's
    pair the masks leave: q.k and p.v).  Returns ``(out or (out, lse),
    flops)``."""
    B, Sq, KVH, G, hd = q.shape
    flops = 4 * hd * B * KVH * G * flash_pairs(Sq, k.shape[1], causal, window, kv_len)
    out = torch.empty_like(q)
    if not return_lse:
        return out, flops
    return (out, torch.empty((B, Sq, KVH, G), dtype=torch.float32, device=q.device)), flops


def flash_attention_backward_meta(q, k, v, *, causal: bool, window: int = 0,
                                  kv_len: int | None = None):
    """The backward kernel on ``meta`` tensors: ``(dq, dk, dv)`` of
    ``flash_attention_backward_plain``'s shapes and dtypes, and its FLOPs
    (10·hd a query head's pair the masks leave: s, dp, dv, dq, dk).
    Returns ``((dq, dk, dv), flops)``."""
    B, Sq, KVH, G, hd = q.shape
    flops = 10 * hd * B * KVH * G * flash_pairs(Sq, k.shape[1], causal, window, kv_len)
    return (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)), flops


def flash_attention_backward_plain(q, k, v, out, lse, dout, *, causal: bool,
                                   window: int = 0, kv_len: int | None = None):
    """Plain version of the backward kernel (``csrc/flash_attn_bwd.cu``), in
    closed form and f32: with s = q.k / sqrt(hd), p = exp(s - lse) on the
    pairs the forward's mask leaves (``_flash_mask``: ``j < kv_len``, ``j <=
    i`` if causal, ``i - j < window`` if window; 0 elsewhere), dp = dout.v
    and D = rowsum(dout * out), ds = p * (dp - D), dq = ds.k / sqrt(hd),
    dk = ds^T.q / sqrt(hd) and dv = p^T.dout, summed over each kv head's G
    query heads.  q, out, dout (B, Sq, KVH, G, hd), k/v (B, Skv, KVH, hd),
    lse (B, Sq, KVH, G) f32 -> (dq, dk, dv) in q's dtype.  A fully masked
    row (lse NEG_INF) and a key at or past ``kv_len`` get zero gradients."""
    B, Sq, KVH, G, hd = q.shape
    Skv = k.shape[1]
    kv_len = Skv if kv_len is None else kv_len
    scale = attn_scale(hd)
    f32 = torch.float32
    qf, kf, vf = q.to(f32), k.to(f32), v.to(f32)
    of, gf = out.to(f32), dout.to(f32)
    mask = _flash_mask(Sq, Skv, causal, window, kv_len, q.device)
    s = torch.einsum("bqkgh,bckh->bkgqc", qf, kf) * scale
    lse_t = lse.to(f32).permute(0, 2, 3, 1)[..., None]  # (B, KVH, G, Sq, 1)
    p = torch.where(mask, torch.exp(torch.where(mask, s, 0.0) - lse_t), 0.0)
    dp = torch.einsum("bqkgh,bckh->bkgqc", gf, vf)
    D = (gf * of).sum(-1).permute(0, 2, 3, 1)[..., None]  # (B, KVH, G, Sq, 1)
    ds = p * (dp - D)
    dq = torch.einsum("bkgqc,bckh->bqkgh", ds, kf) * scale
    dk = torch.einsum("bkgqc,bqkgh->bckh", ds, qf) * scale
    dv = torch.einsum("bkgqc,bqkgh->bckh", p, gf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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
