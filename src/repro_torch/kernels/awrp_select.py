"""CUDA launch of the AWRP victim-selection kernels (``csrc/awrp_select.cu``).

Replaces ``repro/kernels/awrp_select.py`` ``awrp_select_kernel`` (kernel 1,
with a ``pinned`` mask) and ``awrp_select_rows_kernel`` (kernel 2, the sweep
engine's per-step victim search).  This module only validates, allocates
the ``(B,)`` int32 output and launches on the current stream;
``kernels/ops.py`` dispatches between it and the plain versions.  The CUDA
kernels take any lane count P: there is no lane padding.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build


def _check(name: str, planes, clock) -> None:
    """Raise unless every tensor is a contiguous int32 CUDA tensor on one
    device, the planes (B, P) with B, P >= 1 and the clock (B,)."""
    dev = clock.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: expected CUDA tensors, got {dev}")
    shape = planes[0].shape
    if len(shape) != 2 or shape[0] < 1 or shape[1] < 1:
        raise ValueError(f"{name}: planes must be (B, P) with B, P >= 1, got {tuple(shape)}")
    if clock.shape != (shape[0],):
        raise ValueError(f"{name}: clock must be ({shape[0]},), got {tuple(clock.shape)}")
    for t in (*planes, clock):
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: tensors must be int32, got {t.dtype}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous and on {dev}")
        if t is not clock and t.shape != shape:
            raise ValueError(f"{name}: plane shapes differ: {tuple(t.shape)} vs {tuple(shape)}")


def awrp_select_kernel(f, r, clock, valid, pinned):
    """f, r, valid, pinned (B, P) int32 (valid/pinned 0/1); clock (B,) int32
    -> (B,) int32 first-index min of the eq. (1) weight's bit pattern over
    ``valid & ~pinned`` lanes.  One launch."""
    _check("awrp_select", (f, r, valid, pinned), clock)
    B, P = f.shape
    out = torch.empty((B,), dtype=torch.int32, device=f.device)
    err = _build.library().repro_awrp_select(
        f.data_ptr(), r.data_ptr(), clock.data_ptr(), valid.data_ptr(),
        pinned.data_ptr(), out.data_ptr(), B, P,
        torch.cuda.current_stream(f.device).cuda_stream)
    _build.check(err, "awrp_select")
    return out


def awrp_select_rows_kernel(f, r, clock, valid):
    """Kernel 2: the same victim search without ``pinned``, for all B rows
    in one launch (the sweep engine calls it once per trace step)."""
    _check("awrp_select_rows", (f, r, valid), clock)
    B, P = f.shape
    out = torch.empty((B,), dtype=torch.int32, device=f.device)
    err = _build.library().repro_awrp_select_rows(
        f.data_ptr(), r.data_ptr(), clock.data_ptr(), valid.data_ptr(),
        out.data_ptr(), B, P, torch.cuda.current_stream(f.device).cuda_stream)
    _build.check(err, "awrp_select_rows")
    return out
