"""Public wrappers around the port's kernels: the dispatch point.

A CUDA tensor goes to the hand-written kernel; a CPU tensor goes to the
plain PyTorch version (``kernels/ref.py``), and only because it lies on the
CPU.  There is no fallback: a CUDA call that fails raises.  Each wrapper
counts its kernel launches in ``LAUNCHES`` (plain ints, CUDA launches only),
so a run can show that its main path went through the kernels.  Kernels
3, 4 and 5 (``paged_attention``, ``policy_paged_attention``,
``adaptive_policy_paged_attention``) make ``SPLIT_LAUNCHES`` launches per
call, the pages' partials and then their fold, and count each.
``flat_sweep`` and ``adaptive_sweep`` run a row group's whole trace in one
launch (the sweep engine's trace route); ``flat_stream`` and
``adaptive_stream``, their stream mode, run a tenancy manager's interleaved
stream in one launch; given a decision-trace ring they launch the kernels'
ring variant, which also writes the ring, and count it under
``flat_stream_ring`` / ``adaptive_stream_ring``.  ``flash_attention`` is
differentiable: where a gradient is wanted it runs through ``FlashAttention``,
whose forward also keeps the rows' log-sum-exp and whose backward is the
backward kernel (``flash_attention_bwd``: three launches, counted once per
backward call).

Kernel 6 and its backward also take ``meta`` tensors, which hold no data:
the dry run (``launch/dryrun.py``) plans a cell on them.  There nothing is
launched and no launch is counted: ``ref.flash_attention_meta`` /
``ref.flash_attention_backward_meta`` give the outputs' shapes and dtypes,
as the plain versions would, and add the work the kernels do to
``META_FLOPS`` (4·hd FLOPs a (query head, key) pair the masks leave,
forward; 10·hd, backward), since the plain versions' (Sq, Skv) f32 scores,
which the kernels never hold, would stand in a planned cell's memory.  No
CPU or CUDA tensor takes that route.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import ref

#: kernel launches per wrapper since the last ``reset_launches``
LAUNCHES: Dict[str, int] = {"paged_attention": 0, "policy_paged_attention": 0,
                             "adaptive_policy_paged_attention": 0,
                             "awrp_select": 0, "awrp_select_rows": 0,
                             "flash_attention": 0, "flat_sweep": 0, "adaptive_sweep": 0,
                             "flat_stream": 0, "adaptive_stream": 0,
                             "flat_stream_ring": 0, "adaptive_stream_ring": 0,
                             "flash_attention_bwd": 0}


#: FLOPs of kernel 6's and its backward's ``meta`` calls since the last
#: ``reset_launches`` (the dry run's; no CUDA call adds to it)
META_FLOPS: Dict[str, float] = {"flash_attention": 0.0, "flash_attention_bwd": 0.0}


#: CUDA launches per call of kernels 3, 4 and 5: the pages' partials, their
#: fold
SPLIT_LAUNCHES = 2


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for name in META_FLOPS:
        META_FLOPS[name] = 0.0


def paged_attention(q, k_pages, v_pages, page_start, cur_pos):
    """Decode attention over a paged pool; returns ``(out, page_mass)``
    (``repro.kernels.ops.paged_attention``)."""
    if q.device.type == "cpu":
        return ref.paged_attention_plain(q, k_pages, v_pages, page_start, cur_pos)
    from repro_torch.kernels.paged_attn import paged_attention_kernel

    res = paged_attention_kernel(q, k_pages, v_pages, page_start, cur_pos)
    LAUNCHES["paged_attention"] += SPLIT_LAUNCHES
    return res


def policy_paged_attention(q, k_pages, v_pages, new_k, new_v, pos,
                           f, r, page_start, clock, open_slot, *, policy: str):
    """One fused flat-policy decode step at ``pos`` (0-d int32, on q's
    device); returns ``(out, page_mass, slot, f', r', page_start', clock',
    open_slot')`` (``repro.kernels.ops.policy_paged_attention``).  The
    caller scatters the new K/V row at ``slot``."""
    if q.device.type == "cpu":
        return ref.policy_paged_attention_plain(
            q, k_pages, v_pages, new_k, new_v, pos, f, r, page_start, clock,
            open_slot, policy=policy)
    from repro_torch.kernels.policy_attn import policy_paged_attention_kernel

    res = policy_paged_attention_kernel(
        q, k_pages, v_pages, new_k, new_v, pos, f, r, page_start, clock,
        open_slot, policy=policy)
    LAUNCHES["policy_paged_attention"] += SPLIT_LAUNCHES
    return res


def adaptive_policy_paged_attention(q, k_pages, v_pages, new_k, new_v, pos,
                                    f, r, page_start, clock, open_slot, blocks,
                                    tag, stamp, refbits, p_plane, ctr, *,
                                    kind: str, renorm_at):
    """One fused true-adaptive (arc/car) decode step; returns the eight
    outputs of ``policy_paged_attention`` followed by the six updated
    ARC/CAR planes ``(blocks, tag, stamp, ref (B, L), p, ctr (B,))``
    (``repro.kernels.ops.adaptive_policy_paged_attention``).  The caller
    scatters the new K/V row at ``slot``."""
    args = (q, k_pages, v_pages, new_k, new_v, pos, f, r, page_start, clock,
            open_slot, blocks, tag, stamp, refbits, p_plane, ctr)
    if q.device.type == "cpu":
        return ref.adaptive_policy_paged_attention_plain(*args, kind=kind,
                                                         renorm_at=renorm_at)
    from repro_torch.kernels.policy_attn import adaptive_policy_paged_attention_kernel

    res = adaptive_policy_paged_attention_kernel(*args, kind=kind, renorm_at=renorm_at)
    LAUNCHES["adaptive_policy_paged_attention"] += SPLIT_LAUNCHES
    return res


def awrp_select(f, r, clock, valid, pinned):
    """(B, P) int32 metadata, 0/1 valid/pinned, (B,) int32 clock -> (B,)
    int32 victim slots (paper eq. (1)) over ``valid & ~pinned`` lanes
    (``repro.kernels.ops.awrp_select``, without its lane padding)."""
    if f.device.type == "cpu":
        return ref.awrp_select_plain(f, r, clock, valid, pinned)
    from repro_torch.kernels.awrp_select import awrp_select_kernel

    res = awrp_select_kernel(f, r, clock, valid, pinned)
    LAUNCHES["awrp_select"] += 1
    return res


def awrp_select_rows(f, r, clock, valid):
    """(B, P) int32 metadata -> (B,) int32 victims, all rows in one launch:
    the AWRP victim of ``FlatCore(use_kernel=True).on_access`` (the
    incremental ``access_sets``, ``kv_policy.page_victim``), one call per
    access (``repro.kernels.ops.awrp_select_rows``)."""
    if f.device.type == "cpu":
        return ref.awrp_select_rows_plain(f, r, clock, valid)
    from repro_torch.kernels.awrp_select import awrp_select_rows_kernel

    res = awrp_select_rows_kernel(f, r, clock, valid)
    LAUNCHES["awrp_select_rows"] += 1
    return res


def flat_sweep(traces, row_trace, pids, ways, *, num_sets: int, lanes: int):
    """A flat (awrp/lru/fifo/lfu) row group's whole trace: traces (N, T)
    int32, row_trace / pids / ways (rows,) int32 -> ``(hits (rows, T) bool,
    final FlatState)``, ``FlatCore.on_access`` at every step.  Kernel 2
    redesigned for the card: one launch per call."""
    args = (traces, row_trace, pids, ways)
    if traces.device.type == "cpu":
        return ref.flat_sweep_plain(*args, num_sets=num_sets, lanes=lanes)
    from repro_torch.kernels.sweep import flat_sweep_kernel

    res = flat_sweep_kernel(*args, num_sets=num_sets, lanes=lanes)
    LAUNCHES["flat_sweep"] += 1
    return res


def adaptive_sweep(traces, row_trace, caps, *, kind: str, num_sets: int, lanes: int,
                   renorm_at):
    """An ARC or CAR row group's whole trace: traces (N, T) int32, row_trace /
    caps (rows,) int32 -> ``(hits (rows, T) bool, final AdaptiveState)``,
    ``AdaptiveCore.on_access`` at every step.  One launch per call."""
    kw = dict(kind=kind, num_sets=num_sets, lanes=lanes, renorm_at=renorm_at)
    if traces.device.type == "cpu":
        return ref.adaptive_sweep_plain(traces, row_trace, caps, **kw)
    from repro_torch.kernels.sweep import adaptive_sweep_kernel

    res = adaptive_sweep_kernel(traces, row_trace, caps, **kw)
    LAUNCHES["adaptive_sweep"] += 1
    return res


def flat_stream(keys, stream_rows, state, counters, pids, ways, *, alpha: float, ring=None):
    """A tenancy manager's flat (awrp/lru/fifo/lfu) rows over one interleaved
    stream: keys, stream_rows (T,) int32, a single-set ``FlatState`` and its
    ``RowCounters``, pids / ways (rows,) int32 -> ``(hits (T,) bool, new
    FlatState, new RowCounters)``, ``on_access_counted`` on row
    ``stream_rows[t]`` at step t.  With a decision-trace ring ``ring``
    (``buf``, ``count``) the new ring (one access event per access) comes
    fourth, as a ``(buf, count)`` pair.  The flat trace
    kernel's stream mode: one launch per call."""
    args = (keys, stream_rows, state, counters, pids, ways)
    if keys.device.type == "cpu":
        return ref.flat_stream_plain(*args, alpha=alpha, ring=ring)
    from repro_torch.kernels.sweep import flat_stream_kernel

    res = flat_stream_kernel(*args, alpha=alpha, ring=ring)
    LAUNCHES["flat_stream" if ring is None else "flat_stream_ring"] += 1
    return res


def adaptive_stream(keys, stream_rows, state, counters, caps, *, kind: str, alpha: float,
                    renorm_at, ring=None):
    """The same for ARC or CAR rows (``AdaptiveState`` with num_sets == 1,
    caps (rows,) int32): the ARC/CAR trace kernel's stream mode, one launch
    per call."""
    args = (keys, stream_rows, state, counters, caps)
    kw = dict(kind=kind, alpha=alpha, renorm_at=renorm_at, ring=ring)
    if keys.device.type == "cpu":
        return ref.adaptive_stream_plain(*args, **kw)
    from repro_torch.kernels.sweep import adaptive_stream_kernel

    res = adaptive_stream_kernel(*args, **kw)
    LAUNCHES["adaptive_stream" if ring is None else "adaptive_stream_ring"] += 1
    return res


def _flash_forward(q, k, v, causal, window, kv_len, return_lse):
    if q.device.type == "meta":
        res, flops = ref.flash_attention_meta(q, k, v, causal=causal, window=window,
                                              kv_len=kv_len, return_lse=return_lse)
        META_FLOPS["flash_attention"] += flops
        return res
    if q.device.type == "cpu":
        return ref.flash_attention_plain(q, k, v, causal=causal, window=window,
                                         kv_len=kv_len, return_lse=return_lse)
    from repro_torch.kernels.flash_attn import flash_attention_kernel

    res = flash_attention_kernel(q, k, v, causal=causal, window=window, kv_len=kv_len,
                                 return_lse=return_lse)
    LAUNCHES["flash_attention"] += 1
    return res


class FlashAttention(torch.autograd.Function):
    """Kernel 6 with its gradient: the forward keeps ``out`` and the rows'
    log-sum-exp, the backward runs the backward kernel (its plain version
    for CPU tensors) under the forward's masks: causal, ``window`` and
    ``kv_len``, at any Sq and Skv."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, kv_len):
        out, lse = _flash_forward(q, k, v, causal, window, kv_len, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = {"causal": causal, "window": window, "kv_len": kv_len}
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        if q.device.type == "meta":
            (dq, dk, dv), flops = ref.flash_attention_backward_meta(q, k, v, **ctx.kw)
            META_FLOPS["flash_attention_bwd"] += flops
        elif q.device.type == "cpu":
            dq, dk, dv = ref.flash_attention_backward_plain(q, k, v, out, lse, dout, **ctx.kw)
        else:
            from repro_torch.kernels.flash_attn import flash_attention_backward_kernel

            dq, dk, dv = flash_attention_backward_kernel(q, k, v, out, lse, dout, **ctx.kw)
            LAUNCHES["flash_attention_bwd"] += 1
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    kv_len: int | None = None):
    """Tiled flash attention: q (B, Sq, KVH, G, hd), k/v (B, Skv, KVH, hd) ->
    out like q, with causal, sliding-window (``window`` > 0) and ``kv_len``
    masks (``repro.kernels.ops.flash_attention``; any Sq / Skv, no padding).
    The port's prefill and training attention.  Where a gradient is wanted
    (grad mode on and an input that requires one) it runs through
    ``FlashAttention``, which takes every case the forward takes (on the
    card at hd 64, 112 or 128; another hd raises a ``ValueError``);
    otherwise the forward alone, with no log-sum-exp."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        from repro_torch.kernels.flash_attn import check_backward_case

        check_backward_case(q.shape, k.shape, kv_len, kernel=q.device.type == "cuda")
        return FlashAttention.apply(q, k, v, bool(causal), int(window),
                                    None if kv_len is None else int(kv_len))
    return _flash_forward(q, k, v, causal, window, kv_len, False)
