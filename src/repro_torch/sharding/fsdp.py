"""FSDP over the batch axes, one piece at a time: the placed train step's
gather on use and its fixed-order gradient reduction.

The logical-axis rules split each weight's ``p_embed`` dim over the batch
axes ("data", or "pod" and "data" pod-major) and its feature dims over
"model".  The train step runs the model on the "model" sub-mesh of its
batch shard, so a weight must be whole over the batch axes where it is
used, and each shard's gradient of it must be summed back into the owner
of each piece.  Both go through ``torch.distributed._functional_collectives``
on one group over the batch axes (``BatchAxes``: the flattened sub-mesh,
pod-major), each on one rank-local tensor at a time:

* ``gather``: a functional all-gather of this shard's piece along the
  split dim (padded to the longest piece where the pieces differ);
* ``reduce_into``: an all-to-all hands every shard its rows of each
  shard's gradient (an all-gather of the whole gradient where the batch
  axes do not split the leaf), and the parts are cast to the accumulator's
  dtype and added in shard order.  So every shard's accumulator takes shard
  0's part, then shard 1's, ...: the unsharded step's sum over the same
  chunks, bit for bit.  The largest buffers are this shard's gradient piece
  and what it receives, never a stack over the shards;
* ``StackedOnUse``: a stacked leaf (n_layers, ...) of the unit's repeats,
  indexed by repeat: ``stack[i]`` gathers repeat i's slice
  (``_GatherSlice``) and wraps it as a DTensor over "model"; its backward
  reduces the slice's gradient straight into the accumulator's slice i and
  hands autograd no gradient of the leaf.  Under ``torch.utils.checkpoint``
  the recompute gathers again.  With no accumulator it serves a step with
  no backward (the placed prefill and decode step,
  ``launch.inputs.gather_on_use``): the slice as a DTensor on the whole
  mesh, so no more than one repeat's weights are whole at once.

With one batch shard every collective is skipped: the gather returns the
piece itself and the reduction is ``acc.add_(g.to(acc.dtype))``.
"""

from __future__ import annotations

import itertools
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

__all__ = ["BatchAxes", "LeafLayout", "leaf_layout", "gather", "reduce_into",
           "StackedOnUse", "BYTES"]

#: bytes this rank receives from this module's collectives: the weights'
#: gathers on use ("gather", all-gathers) and the gradients' reductions
#: ("reduce", all-to-alls and the all-gathers of leaves the batch axes do
#: not split); the dry run holds "gather" to the roofline's FSDP term
BYTES = {"gather": 0, "reduce": 0}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _wait(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed._functional_collectives import AsyncCollectiveTensor

    return t.wait() if isinstance(t, AsyncCollectiveTensor) else t


def _all_gather0(t: torch.Tensor, group) -> torch.Tensor:
    """Every shard's ``t`` concatenated along dim 0, in shard order."""
    import torch.distributed._functional_collectives as fc

    # all_gather_single replaces all_gather_tensor in newer torch; same op
    fn = getattr(fc, "all_gather_single", None) or fc.all_gather_tensor
    return _wait(fn(t.contiguous(), 0, group))


class BatchAxes:
    """The mesh's batch axes as one group: their mesh dims, sizes, this
    rank's shard index (pod-major, the order of ``Shard`` over them) and
    the process group over them (a 1-D sub-mesh; None for one shard)."""

    def __init__(self, mesh):
        from repro_torch.launch.mesh import batch_axes

        names = tuple(batch_axes(mesh))
        self.dims = tuple(mesh.mesh_dim_names.index(a) for a in names)
        self.sizes = tuple(mesh.size(d) for d in self.dims)
        self.n = math.prod(self.sizes)
        coord = mesh.get_coordinate()
        self.index = 0
        for d in self.dims:
            self.index = self.index * mesh.size(d) + coord[d]
        self.group = None
        if self.n > 1:
            sub = mesh[names[0]] if len(names) == 1 else mesh[names]._flatten()
            self.group = sub


class LeafLayout(NamedTuple):
    """How the batch axes split one tensor: the tensor dim they split
    (None: every shard holds it whole) and each shard's (start, length)
    along it, in shard order."""

    dim: Optional[int]
    spans: Tuple[Tuple[int, int], ...]

    def sliced(self) -> "LeafLayout":
        """The layout of one slice ``t[i]`` of a stacked tensor (dim 0 is
        never split)."""
        if self.dim == 0:
            raise ValueError("a stacked leaf's layer dim is split over the batch axes")
        return self if self.dim is None else LeafLayout(self.dim - 1, self.spans)


def leaf_layout(axes: BatchAxes, shape: Sequence[int], placements) -> LeafLayout:
    """The layout of a tensor of global ``shape`` placed by ``placements``
    on the mesh: each batch mesh dim must split the same tensor dim, or
    none may.  Spans nest as ``Shard`` does (``torch.chunk`` pieces over
    each batch mesh dim in mesh order)."""
    from torch.distributed.tensor import Shard

    pls = [placements[d] for d in axes.dims]
    split = {p.dim if isinstance(p, Shard) else None for p in pls}
    if split == {None}:
        return LeafLayout(None, ())
    if len(split) > 1:
        raise ValueError(f"batch axes place a tensor as {pls}: one dim over all of them "
                         "or none")
    dim = split.pop()
    model_split = [p for i, p in enumerate(placements)
                   if i not in axes.dims and isinstance(p, Shard) and p.dim == dim]
    if model_split:
        raise ValueError(f"tensor dim {dim} split over the batch axes and another mesh dim")
    spans = []
    for coords in itertools.product(*map(range, axes.sizes)):
        start, length = 0, int(shape[dim])
        for c, k in zip(coords, axes.sizes):
            size = -(-length // k)
            lo = min(c * size, length)
            start, length = start + lo, max(0, min(size, length - lo))
        spans.append((start, length))
    return LeafLayout(dim, tuple(spans))


def gather(piece: torch.Tensor, lay: LeafLayout, axes: BatchAxes) -> torch.Tensor:
    """This shard's ``piece`` made whole over the batch axes (a contiguous
    rank-local tensor; ``piece`` itself where nothing splits it)."""
    if lay.dim is None or axes.n == 1:
        return piece
    d = lay.dim
    lengths = [n for _, n in lay.spans]
    longest = max(lengths)
    if longest != piece.shape[d]:  # uneven pieces: pad to the longest
        pad = list(piece.shape)
        pad[d] = longest - piece.shape[d]
        piece = torch.cat([piece, piece.new_zeros(pad)], dim=d)
    stacked = _all_gather0(piece.unsqueeze(0), axes.group)  # (n, ..., longest, ...)
    BYTES["gather"] += _nbytes(stacked)
    parts = [stacked[s].narrow(d, 0, n) for s, n in enumerate(lengths)]
    return torch.cat(parts, dim=d)


def reduce_into(acc: torch.Tensor, g: torch.Tensor, lay: LeafLayout, axes: BatchAxes) -> None:
    """Add every shard's part of its gradient ``g`` (whole over the batch
    axes, this rank's "model" piece) to ``acc`` (this rank's piece), each
    cast to ``acc``'s dtype, in shard order."""
    import torch.distributed._functional_collectives as fc

    if axes.n == 1:
        acc.add_(g.to(acc.dtype))
        return
    if lay.dim is None:
        parts = _all_gather0(g.unsqueeze(0), axes.group)  # (n, *g.shape)
        BYTES["reduce"] += _nbytes(parts)
        for s in range(axes.n):
            acc.add_(parts[s].to(acc.dtype))
        return
    d = lay.dim
    mine = lay.spans[axes.index][1]
    send = g.movedim(d, 0).contiguous()
    got = _wait(fc.all_to_all_single(send, [mine] * axes.n, [n for _, n in lay.spans],
                                     axes.group))
    del send
    BYTES["reduce"] += _nbytes(got)
    for s in range(axes.n):
        acc.add_(got.narrow(0, s * mine, mine).movedim(0, d).to(acc.dtype))


def contiguous_stride(shape: Sequence[int]) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape`` (as torch gives
    them, a dim of size 0 counted as 1), with no tensor made."""
    out, step = [], 1
    for n in reversed(shape):
        out.append(step)
        step *= max(int(n), 1)
    return tuple(reversed(out))


class _GatherSlice(torch.autograd.Function):
    """forward: repeat ``i``'s slice of a stacked leaf, gathered over the
    batch axes; backward: its gradient reduced into the accumulator's slice
    ``i`` (``reduce_into``), and no gradient for the leaf.  ``anchor`` is a
    0-d tensor that requires grad, so that autograd runs the backward."""

    @staticmethod
    def forward(ctx, anchor, piece, stack, i):
        ctx.stack, ctx.i = stack, i
        out = gather(piece, stack.layout, stack.axes)
        return out.view_as(out) if out is piece else out

    @staticmethod
    def backward(ctx, grad):
        stack = ctx.stack
        reduce_into(stack.acc[ctx.i], grad, stack.layout, stack.axes)
        return torch.zeros((), dtype=torch.float32, device=grad.device), None, None, None


class StackedOnUse:
    """A stacked placed leaf (its batch-axes ``layout``) seen by the model
    as the sequence of its layers: ``self[i]`` is repeat i's slice,
    gathered over the batch axes now, as a DTensor on ``mesh``, which keeps
    the leaf's mesh dims ``dims`` (the train step: the "model" sub-mesh;
    the placed prefill and decode step: the leaf's whole mesh), replicated
    over the batch axes, the other placements kept.  With an accumulator
    (``acc``, this rank's piece of the leaf's, and the step's ``anchor``)
    the slice's gradient goes into ``acc[i]`` when autograd reaches it;
    without one (a step with no backward) the slice carries no gradient."""

    def __init__(self, leaf, layout: LeafLayout, axes: BatchAxes, mesh, dims: Sequence[int],
                 acc: Optional[torch.Tensor] = None, anchor: Optional[torch.Tensor] = None):
        from torch.distributed.tensor import Replicate, Shard

        self.local = leaf.to_local().detach()
        self.acc = acc
        self.axes = axes
        self.layout = layout.sliced()
        self.mesh = mesh
        self.placements = [Replicate() if d in axes.dims
                           else Shard(p.dim - 1) if isinstance(p, Shard) else p
                           for d, p in enumerate(leaf.placements) if d in dims]
        self.shape = tuple(leaf.shape[1:])
        self.anchor = anchor
        self._stride = contiguous_stride(self.shape)

    def __getitem__(self, i: int):
        from torch.distributed.tensor import DTensor

        if self.acc is None:
            whole = gather(self.local[i], self.layout, self.axes)
        else:
            whole = _GatherSlice.apply(self.anchor, self.local[i], self, i)
        return DTensor.from_local(whole, self.mesh, self.placements, run_check=False,
                                  shape=self.shape, stride=self._stride)
