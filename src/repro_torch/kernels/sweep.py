"""CUDA launch of the persistent trace kernels (``csrc/sweep.cu``).

``flat_sweep_kernel`` is kernel 2 redesigned: it replaces
``repro/kernels/awrp_select.py`` ``awrp_select_rows_kernel``, which the
reference calls once per trace step, with one launch that runs a flat row
group's whole trace (``FlatCore.on_access`` at every step).
``adaptive_sweep_kernel`` does the same for one ARC or CAR row group
(``AdaptiveCore.on_access``).  ``flat_stream_kernel`` and
``adaptive_stream_kernel`` are their stream mode, the tenancy manager's
``access_stream``: one interleaved stream of (row, key) accesses, one row per
tenant, from a given state and given ``RowCounters``
(``on_access_counted`` on the access's row at every step).  Given a
decision-trace ring (``obs/decision_trace.py``) they launch their ring
variant, which also writes a new ring: one access event per access.  This
module only validates, allocates the outputs and launches on the current
stream;
``kernels/ops.py`` dispatches between it and the plain versions
(``kernels/ref.py``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.policy_core import AdaptiveState, FlatState, RowCounters
from repro_torch.kernels import _build

#: int32 fields per event of a decision-trace ring (``obs/decision_trace.NF``)
RING_FIELDS = 10

#: the kernels' limits: flat lanes per set, adaptive directory lanes
MAX_FLAT_LANES = 2048
MAX_ADAPTIVE_LANES = 1024
ADAPTIVE_KIND = {"arc": 0, "car": 1}


def _check(name: str, traces, per_row) -> int:
    """Raise unless ``traces`` is a (N, T) and every ``per_row`` tensor a
    (rows,) contiguous int32 tensor, all on one CUDA device; returns rows."""
    dev = traces.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: expected CUDA tensors, got {dev}")
    if traces.dim() != 2 or traces.shape[0] < 1:
        raise ValueError(f"{name}: traces must be (N, T) with N >= 1, got {tuple(traces.shape)}")
    rows = per_row[0].shape[0] if per_row[0].dim() == 1 else 0
    if rows < 1:
        raise ValueError(f"{name}: per-row tensors must be (rows,) with rows >= 1")
    for t in (traces, *per_row):
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: tensors must be int32, got {t.dtype}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous and on {dev}")
        if t is not traces and t.shape != (rows,):
            raise ValueError(f"{name}: per-row shapes differ: {tuple(t.shape)} vs ({rows},)")
    return rows


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def flat_sweep_kernel(traces, row_trace, pids, ways, *, num_sets: int, lanes: int):
    """traces (N, T) int32 block ids; row_trace, pids, ways (rows,) int32: each
    row's trace, flat ``POLICY_IDS`` value and live lanes per set (1 <= ways
    <= lanes).  Returns ``(hits, state)``: (rows, T) bool hits and the final
    ``FlatState`` in ``FlatCore``'s layout (``(rows, lanes)`` planes and a
    ``(rows,)`` clock at ``num_sets == 1``, else ``(rows, num_sets, lanes)``
    and ``(rows, num_sets)``).  One launch."""
    name = "flat_sweep"
    rows = _check(name, traces, (row_trace, pids, ways))
    if num_sets < 1 or not 1 <= lanes <= MAX_FLAT_LANES:
        raise ValueError(f"{name}: need num_sets >= 1 and 1 <= lanes <= {MAX_FLAT_LANES}, "
                         f"got {num_sets}, {lanes}")
    dev, T = traces.device, traces.shape[1]
    lead = (rows,) if num_sets == 1 else (rows, num_sets)
    hits = torch.empty((rows, T), dtype=torch.bool, device=dev)
    state = FlatState(*(torch.empty(lead + (lanes,), dtype=torch.int32, device=dev)
                        for _ in range(3)),
                      clock=torch.empty(lead, dtype=torch.int32, device=dev))
    err = _build.library().repro_flat_sweep(
        traces.data_ptr(), row_trace.data_ptr(), pids.data_ptr(), ways.data_ptr(),
        hits.data_ptr(), *(t.data_ptr() for t in state), rows, T, num_sets, lanes,
        _stream(dev))
    _build.check(err, name)
    return hits, state


def adaptive_sweep_kernel(traces, row_trace, caps, *, kind: str, num_sets: int, lanes: int,
                          renorm_at):
    """traces (N, T) int32 block ids; row_trace, caps (rows,) int32: each
    row's trace and per-set capacity (2 * caps <= lanes); ``kind`` "arc" or
    "car"; ``renorm_at`` the stamp-renormalization ceiling, or None for no
    check.  Returns ``(hits, state)``: (rows, T) bool hits and the final
    ``AdaptiveState`` ((rows, num_sets, lanes) planes, (rows, num_sets) p and
    ctr).  One launch."""
    name = "adaptive_sweep"
    rows = _check(name, traces, (row_trace, caps))
    if kind not in ADAPTIVE_KIND:
        raise ValueError(f"{name}: kind {kind!r} not in {list(ADAPTIVE_KIND)}")
    if num_sets < 1 or not 2 <= lanes <= MAX_ADAPTIVE_LANES:
        raise ValueError(f"{name}: need num_sets >= 1 and 2 <= lanes <= "
                         f"{MAX_ADAPTIVE_LANES}, got {num_sets}, {lanes}")
    if renorm_at is not None and not -2**31 <= int(renorm_at) < 2**31:
        raise ValueError(f"{name}: renorm_at must be an int32 or None, got {renorm_at!r}")
    dev, T = traces.device, traces.shape[1]
    hits = torch.empty((rows, T), dtype=torch.bool, device=dev)
    planes = [torch.empty((rows, num_sets, lanes), dtype=torch.int32, device=dev)
              for _ in range(4)]
    state = AdaptiveState(*planes,
                          p=torch.empty((rows, num_sets), dtype=torch.float32, device=dev),
                          ctr=torch.empty((rows, num_sets), dtype=torch.int32, device=dev))
    err = _build.library().repro_adaptive_sweep(
        traces.data_ptr(), row_trace.data_ptr(), caps.data_ptr(), hits.data_ptr(),
        *(t.data_ptr() for t in state), rows, T, num_sets, lanes, ADAPTIVE_KIND[kind],
        int(renorm_at is not None), 0 if renorm_at is None else int(renorm_at),
        _stream(dev))
    _build.check(err, name)
    return hits, state


def _stream_inputs(name: str, keys, stream_rows, state, counters, per_row):
    """Check the stream mode's inputs: keys, stream_rows (T,) int32; every
    plane of ``state`` and ``counters`` contiguous on one CUDA device with
    ``rows`` leading; ``per_row`` (rows,) int32.  Returns (rows, T, the
    (T, 2) int32 (row, key) records)."""
    dev = keys.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: expected CUDA tensors, got {dev}")
    if keys.dim() != 1 or stream_rows.shape != keys.shape:
        raise ValueError(f"{name}: keys and stream_rows must be equal-length (T,) tensors, "
                         f"got {tuple(keys.shape)} and {tuple(stream_rows.shape)}")
    rows = counters.hits.shape[0]
    floats = [counters.pressure] + ([state.p] if isinstance(state, AdaptiveState) else [])
    for t in (keys, stream_rows, *state, *counters, *per_row):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous and on {dev}")
        want = torch.float32 if any(t is f for f in floats) else torch.int32
        if t.dtype != want:
            raise ValueError(f"{name}: expected {want}, got {t.dtype}")
        if t is not keys and t is not stream_rows and t.shape[0] != rows:
            raise ValueError(f"{name}: every plane must have {rows} rows, got {tuple(t.shape)}")
    T = keys.shape[0]
    if T > 2**29:
        raise ValueError(f"{name}: at most 2**29 accesses per call, got {T}")
    return rows, T, torch.stack([stream_rows, keys], dim=1).contiguous()


def _new_counters(rows: int, dev) -> RowCounters:
    return RowCounters(*(torch.empty(rows, dtype=torch.int32, device=dev) for _ in range(3)),
                       pressure=torch.empty(rows, dtype=torch.float32, device=dev))


def _ptrs(tensors):
    return (ctypes.c_void_p * 4)(*(t.data_ptr() for t in tensors))


def _ring_args(name: str, ring, dev) -> tuple:
    """The ring variant's C arguments (count in, buf out, count out,
    capacity; null pointers and 0 without a ring) and the new ring
    ``(buf, count)`` it writes (None without one).  The new buf starts as a
    copy of the given one (a device-to-device copy, queued before the
    launch), into which the kernel writes its events; the kernel reads the
    count on the device."""
    if ring is None:
        return (None, None, None, 0), None
    buf, count = ring
    if buf.device != dev or count.device != dev:
        raise ValueError(f"{name}: the ring must lie on {dev}")
    if (buf.dtype != torch.int32 or buf.dim() != 2 or buf.shape[0] < 2
            or buf.shape[1] != RING_FIELDS or not buf.is_contiguous()):
        raise ValueError(f"{name}: ring buf must be contiguous (capacity + 1, {RING_FIELDS}) "
                         f"int32, got {tuple(buf.shape)} {buf.dtype}")
    if count.dtype != torch.int32 or count.dim() != 0:
        raise ValueError(f"{name}: ring count must be a 0-d int32 tensor")
    out = (buf.clone(), torch.empty_like(count))
    return (count.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), buf.shape[0] - 1), out


def flat_stream_kernel(keys, stream_rows, state: FlatState, counters: RowCounters, pids, ways,
                       *, alpha: float, ring=None):
    """The flat trace kernel's stream mode: keys, stream_rows (T,) int32 (row in
    [0, rows)); ``state`` a single-set ``FlatState`` ((rows, W) planes,
    (rows,) clock), ``counters`` its ``RowCounters``; pids, ways (rows,)
    int32.  Access t is ``on_access_counted`` on row ``stream_rows[t]``
    alone, with the pressure EWMA weight ``alpha``.  Returns ``(hits (T,)
    bool, new FlatState, new RowCounters)``; the inputs are not written.
    With a decision-trace ring ``ring = (buf, count)`` the ring variant runs
    and the new ``(buf, count)`` comes fourth: access t's event in slot
    ``(count + t) mod capacity`` (every ``stream_rows[t]`` must lie in [0,
    rows)).  One launch."""
    name = "flat_stream"
    if state.blocks.dim() != 2:
        raise ValueError(f"{name}: the stream mode takes num_sets == 1 ((rows, W) planes), "
                         f"got blocks {tuple(state.blocks.shape)}")
    rows, T, acc = _stream_inputs(name, keys, stream_rows, state, counters, (pids, ways))
    W = state.blocks.shape[1]
    if not 1 <= W <= MAX_FLAT_LANES:
        raise ValueError(f"{name}: need 1 <= lanes <= {MAX_FLAT_LANES}, got {W}")
    dev = keys.device
    ring_args, new_ring = _ring_args(name, ring, dev)
    hits = torch.zeros(T, dtype=torch.bool, device=dev)
    out = FlatState(*(torch.empty_like(t) for t in state))
    ctr = _new_counters(rows, dev)
    err = _build.library().repro_flat_stream(
        acc.data_ptr(), pids.data_ptr(), ways.data_ptr(), *(t.data_ptr() for t in state),
        _ptrs(counters), hits.data_ptr(), *(t.data_ptr() for t in out), _ptrs(ctr),
        rows, T, W, float(alpha), _stream(dev), *ring_args)
    _build.check(err, name)
    return (hits, out, ctr) if ring is None else (hits, out, ctr, new_ring)


def adaptive_stream_kernel(keys, stream_rows, state: AdaptiveState, counters: RowCounters,
                           caps, *, kind: str, alpha: float, renorm_at, ring=None):
    """The ARC/CAR trace kernel's stream mode: keys, stream_rows (T,) int32;
    ``state`` an ``AdaptiveState`` with num_sets == 1 ((rows, 1, L) planes,
    (rows, 1) p and ctr), ``counters`` its ``RowCounters``; caps (rows,)
    int32 (2 * caps <= L); ``renorm_at`` the stamp-renormalization ceiling,
    or None for no check (made at every access, on every row).  Returns
    ``(hits (T,) bool, new AdaptiveState, new RowCounters)``, and with a
    ``ring`` the new ring fourth, as ``flat_stream_kernel``.  One launch."""
    name = "adaptive_stream"
    if kind not in ADAPTIVE_KIND:
        raise ValueError(f"{name}: kind {kind!r} not in {list(ADAPTIVE_KIND)}")
    if state.blocks.dim() != 3 or state.blocks.shape[1] != 1:
        raise ValueError(f"{name}: the stream mode takes num_sets == 1 ((rows, 1, L) planes), "
                         f"got blocks {tuple(state.blocks.shape)}")
    rows, T, acc = _stream_inputs(name, keys, stream_rows, state, counters, (caps,))
    L = state.blocks.shape[2]
    if not 2 <= L <= MAX_ADAPTIVE_LANES:
        raise ValueError(f"{name}: need 2 <= lanes <= {MAX_ADAPTIVE_LANES}, got {L}")
    if renorm_at is not None and not -2**31 <= int(renorm_at) < 2**31:
        raise ValueError(f"{name}: renorm_at must be an int32 or None, got {renorm_at!r}")
    dev = keys.device
    ring_args, new_ring = _ring_args(name, ring, dev)
    hits = torch.zeros(T, dtype=torch.bool, device=dev)
    out = AdaptiveState(*(torch.empty_like(t) for t in state))
    ctr = _new_counters(rows, dev)
    err = _build.library().repro_adaptive_stream(
        acc.data_ptr(), caps.data_ptr(), *(t.data_ptr() for t in state), _ptrs(counters),
        hits.data_ptr(), *(t.data_ptr() for t in out), _ptrs(ctr), rows, T, L,
        ADAPTIVE_KIND[kind], int(renorm_at is not None),
        0 if renorm_at is None else int(renorm_at), float(alpha), _stream(dev), *ring_args)
    _build.check(err, name)
    return (hits, out, ctr) if ring is None else (hits, out, ctr, new_ring)
