"""Each rank's piece of a placed tensor, without whole copies on the device.

A DTensor's ``Shard(d)`` over a mesh dim of size n splits tensor dim d as
``torch.chunk`` does (pieces of ``ceil(L / n)``, the last ones shorter or
empty), mesh dims in order.  ``local_box`` gives a rank's piece of a global
shape as (start, length) per dim (``cut`` views it, ``from_piece`` wraps
a piece as the DTensor); ``local_part`` cuts that piece out of a
full tensor held anywhere (the host, a numpy array's tensor) and moves only
the piece to the device, the counterpart of ``distribute_tensor`` with no
whole copy on the device.  ``whole_slices`` goes the other way one dim-0
slice at a time: a stacked leaf (n_layers, ...) whose dim 0 no mesh dim
splits is gathered slice by slice, so no rank ever holds it whole.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import torch

__all__ = ["local_box", "cut", "from_piece", "local_part", "whole_slices"]


def local_box(shape: Sequence[int], mesh, placements) -> List[Tuple[int, int]]:
    """(start, length) of this rank's piece along each dim of ``shape``."""
    from torch.distributed.tensor import Shard

    box = [(0, int(n)) for n in shape]
    coord = mesh.get_coordinate()
    for d, pl in enumerate(placements):
        if isinstance(pl, Shard):
            start, length = box[pl.dim]
            size = -(-length // mesh.size(d))
            lo = min(coord[d] * size, length)
            box[pl.dim] = (start + lo, max(0, min(size, length - lo)))
    return box


def cut(full: torch.Tensor, box) -> torch.Tensor:
    """The view of ``full`` that ``box`` (``local_box``) covers."""
    for d, (start, length) in enumerate(box):
        full = full.narrow(d, start, length)
    return full


def from_piece(piece: torch.Tensor, mesh, placements, shape):
    """A DTensor of global ``shape`` (contiguous) whose local piece on this
    rank is ``piece``.  No communication, no check."""
    from torch.distributed.tensor import DTensor

    shape = tuple(shape)
    return DTensor.from_local(piece, mesh, list(placements), run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def local_part(full: torch.Tensor, mesh, placements, device=None):
    """``full`` (the same on every rank) as a DTensor on ``mesh`` with
    ``placements``: this rank keeps a copy of its piece on ``device`` (the
    mesh's device when None).  No communication."""
    if device is None:
        device = torch.device(mesh.device_type, torch.cuda.current_device()) \
            if mesh.device_type == "cuda" else torch.device(mesh.device_type)
    piece = cut(full.detach(), local_box(full.shape, mesh, placements))
    return from_piece(piece.to(device, copy=True).contiguous(), mesh, placements, full.shape)


def whole_slices(t: torch.Tensor) -> Iterator[torch.Tensor]:
    """The pieces a whole-tensor reduction of ``t`` goes over, each whole:
    ``t[0], t[1], ...`` for a tensor of 3 or more dims (a stacked leaf),
    ``t`` itself otherwise.  A DTensor's pieces are gathered one at a time
    where no mesh dim splits its dim 0 (the stacked layer axis never is), so
    the peak is one slice; otherwise it is gathered whole first.  The same
    values come in the same order for a placed leaf and its unsharded
    tensor."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(t, DTensor):
        yield from (t.unbind(0) if t.dim() >= 3 else (t,))
        return
    if t.dim() < 3 or any(isinstance(p, Shard) and p.dim == 0 for p in t.placements):
        full = t.full_tensor()
        yield from (full.unbind(0) if full.dim() >= 3 else (full,))
        return
    pls = [Shard(p.dim - 1) if isinstance(p, Shard) else p for p in t.placements]
    local = t.to_local()
    for i in range(t.shape[0]):
        yield from_piece(local[i], t.device_mesh, pls, t.shape[1:]).full_tensor()
