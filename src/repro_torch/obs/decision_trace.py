"""The decision-trace ring (``repro/obs/decision_trace.py``).

A fixed-capacity ring of per-decision policy events: ``on_access_counted``
pushes one access event per active row, ``decide_batch`` one admission
event per request, and ``drain`` pulls the ring to the host as a structured
numpy record array.  The ring is two int32 tensors carried beside the
``RowCounters``; pushing reads nothing back to the host, and no policy step
reads the ring, so recording cannot change a decision.  On the card the
tenancy manager's stream launch writes it inside the stream kernels
(``kernels/csrc/sweep.cu``, the ring variant of ``flat_stream_kernel`` and
``adaptive_stream_kernel``); ``ring_push`` is the plain version they are
held against.

Scatter contract: the buffer carries one extra scratch lane at index
``capacity``.  A push of R events under an R-bool mask sends masked-in
event i to slot ``(count + cumsum(mask)[i] - 1) mod capacity`` and
masked-out events to the scratch lane, so the scatter has one fixed shape
however many events are live.  ``drain`` never reads the scratch lane.
``count`` is the number of events ever recorded; ``count mod capacity`` is
the ring head, and wraparound overwrites the oldest first.  One push must
not exceed ``capacity`` events.

Float fields (the AWRP victim weight, ARC/CAR ``p``) are stored as their
int32 bit patterns, so an event is one int32 row; ``drain`` decodes them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.obs.metrics import _pull

__all__ = [
    "NF",
    "KIND_ACCESS",
    "KIND_ADMIT",
    "FIELDS",
    "DecisionRing",
    "ring_init",
    "ring_capacity",
    "pack_events",
    "ring_push",
    "drain",
    "drain_shards",
]

#: event kinds: one ring records both access and admission decisions
KIND_ACCESS = 0
KIND_ADMIT = 1

#: event field order (int32 columns of the ring buffer); ``weight`` /
#: ``p_before`` / ``p_after`` hold float32 bit patterns
FIELDS = ("kind", "row", "key", "hit", "set", "victim", "weight",
          "p_before", "p_after", "admit")
NF = len(FIELDS)

_F = {name: i for i, name in enumerate(FIELDS)}
_BITS = ("weight", "p_before", "p_after")

#: drained record dtype: float fields decoded, everything else int32
_REC_DTYPE = np.dtype([
    ("kind", np.int32), ("row", np.int32), ("key", np.int32),
    ("hit", np.int32), ("set", np.int32), ("victim", np.int32),
    ("weight", np.float32), ("p_before", np.float32),
    ("p_after", np.float32), ("admit", np.int32),
])


class DecisionRing(NamedTuple):
    """The ring on the device: ``buf`` is ``(capacity + 1, NF)`` int32 (lane
    ``capacity`` is the masked-write scratch lane), ``count`` the 0-d int32
    number of events ever recorded."""

    buf: torch.Tensor  # (capacity + 1, NF) int32
    count: torch.Tensor  # () int32


def ring_init(capacity: int, device="cuda") -> DecisionRing:
    """A fresh empty ring of the ``capacity`` most recent events on
    ``device`` (the CUDA card unless the caller asks for the CPU)."""
    cap = int(capacity)
    if cap <= 0:
        raise ValueError(f"ring capacity must be positive, got {capacity}")
    dev = resolve_device(device)
    return DecisionRing(buf=torch.zeros((cap + 1, NF), dtype=torch.int32, device=dev),
                        count=torch.zeros((), dtype=torch.int32, device=dev))


def ring_capacity(ring: DecisionRing) -> int:
    """Event capacity of ``ring`` (the scratch lane excluded)."""
    return ring.buf.shape[0] - 1


def _col(v, n: int, device, *, bits: bool = False) -> torch.Tensor:
    dtype = torch.float32 if bits else torch.int32
    t = torch.as_tensor(v, dtype=dtype, device=device).expand(n).contiguous()
    return t.view(torch.int32) if bits else t


def pack_events(n: int, *, kind, row, key, hit=-1, set_id=-1, victim=-1,
                weight=0.0, p_before=0.0, p_after=0.0, admit=-1) -> torch.Tensor:
    """``n`` events as one ``(n, NF)`` int32 tensor.  Scalar or ``(n,)``
    operands broadcast per field; ``weight`` / ``p_before`` / ``p_after``
    are float32, stored as bit patterns.  The tensor lies on the device of
    the first tensor operand (the CPU when there is none)."""
    vals = (kind, row, key, hit, set_id, victim, weight, p_before, p_after, admit)
    dev = next((v.device for v in vals if isinstance(v, torch.Tensor)), torch.device("cpu"))
    cols = [_col(v, n, dev, bits=name in _BITS) for name, v in zip(FIELDS, vals)]
    return torch.stack(cols, dim=-1)


def ring_push(ring: DecisionRing, events: torch.Tensor, mask) -> DecisionRing:
    """Masked append of ``events`` ``(R, NF)`` under ``mask`` ``(R,)`` bool:
    masked-in events land at consecutive ring slots in order, masked-out
    events in the scratch lane.  One scatter, no host read; returns a new
    ring and writes nothing it was given.  ``R`` must not exceed the
    capacity."""
    cap = ring_capacity(ring)
    m = torch.as_tensor(mask, dtype=torch.bool, device=ring.buf.device)
    off = torch.cumsum(m.to(torch.int32), dim=0, dtype=torch.int32) - 1
    idx = torch.where(m, torch.remainder(ring.count + off, cap), cap)
    return DecisionRing(buf=ring.buf.index_put((idx.long(),), events.to(torch.int32)),
                        count=ring.count + m.sum(dtype=torch.int32))


def drain(ring: DecisionRing) -> np.ndarray:
    """The ring on the host as a structured record array in chronological
    order (the oldest surviving event first), float fields decoded.  One
    pull of ``buf`` and ``count`` together, so one synchronization; the ring
    is left as it is."""
    return _records(*_pull([ring.buf, ring.count]))


def _records(buf: np.ndarray, count: np.ndarray) -> np.ndarray:
    """A pulled ring's records, oldest first, float fields decoded."""
    cap = buf.shape[0] - 1
    n = int(count)
    if n <= cap:
        rows = buf[:n]
    else:
        head = n % cap
        rows = np.concatenate([buf[head:cap], buf[:head]], axis=0)
    out = np.empty(len(rows), dtype=_REC_DTYPE)
    for name in FIELDS:
        col = np.ascontiguousarray(rows[:, _F[name]])
        out[name] = col.view(np.float32) if name in _BITS else col
    return out


def drain_shards(rings, order: np.ndarray, offsets) -> np.ndarray:
    """The records of a ring kept as one segment per shard of a rows mesh
    (a sharded tenancy manager's), merged into the one ring's order: one
    pull per device; ``order`` holds the shard of every event recorded, in
    order (at least the last capacity of them), ``offsets`` each shard's
    first row (the segments hold shard-local rows).  Each shard's segment
    keeps its own last ``capacity`` events, so it holds every one of its
    events among the last ``capacity`` of all."""
    pulled = _pull([t for r in rings for t in (r.buf, r.count)])
    order = np.asarray(order)[-ring_capacity(rings[0]):]
    out = np.empty(len(order), dtype=_REC_DTYPE)
    for i in range(len(rings)):
        rec = _records(pulled[2 * i], pulled[2 * i + 1])
        rec["row"] += offsets[i]
        mine = order == i
        n = int(mine.sum())
        if n:
            out[mine] = rec[len(rec) - n:]
    return out
