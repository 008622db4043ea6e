"""Logical-axis sharding rules as DTensor placements
(``repro/sharding/specs.py``).

Every parameter and every constrained activation carries *logical* axis
names (``"p_embed"``, ``"act_batch"``, ...); a rules table maps each name to
a tuple of mesh axes (``"pod"``, ``"data"``, ``"model"``) or to None
(replicated).  The table is the reference's, keyword for keyword
(``make_rules``).

Where the reference builds a ``PartitionSpec`` / ``NamedSharding`` for XLA's
partitioner, the port builds one DTensor placement per dimension of a
``torch.distributed.device_mesh.DeviceMesh`` (``placements_for``): mesh
dimension ``d`` is ``Shard(i)`` when tensor dim ``i``'s logical name maps to
a tuple that holds ``d``'s name, else ``Replicate()``.  A tuple of several
mesh axes on one tensor dim (``("pod", "data")``) shards that dim over each
of them, major to minor in mesh order, as the ``PartitionSpec`` entry does.
Mesh axes that the mesh lacks are skipped: the train step's compute runs on
the ``"model"`` sub-mesh of each data shard, where the batch is already the
shard's own rows, so ``"act_batch"`` places nothing there.

``logical_shard(x, *names)`` is the counterpart of the reference's
``with_sharding_constraint``: an identity outside ``activate`` or on a plain
tensor, otherwise ``x.redistribute`` to the placements the active rules give
on ``x``'s own mesh.  Unlike GSPMD, DTensor does not pad: a constraint that
would split a dimension the model later views per head is the caller's to
avoid (``models/layers.py`` replicates heads that do not divide the
``"model"`` axis).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch

__all__ = [
    "AxisRules",
    "make_rules",
    "activate",
    "active_mesh_rules",
    "logical_shard",
    "spec_for",
    "placements_for",
    "shards_of",
]

AxisRules = Dict[str, Optional[Tuple[str, ...]]]

_local = threading.local()


def make_rules(
    *,
    multi_pod: bool = False,
    moe_sharding: str = "tp",
    shard_pages: bool = False,
    fsdp: bool = True,
    param_mode: str = "fsdp",
    tp_feat: bool = True,
    seq_parallel: bool = False,
) -> AxisRules:
    """The logical -> mesh-axes table, the reference's for every keyword.

    ``moe_sharding``: ``"tp"`` shards every expert's d_ff over "model",
    ``"ep"`` the expert axis.  ``shard_pages``: long-context decode (batch 1)
    shards the resident KV pages over the batch axes.  ``param_mode``:
    ``"fsdp"`` shards every weight's non-feature dim over the batch axes
    (gathered on use); ``"tp2d"`` shards feature dims over (batch x model)
    jointly with no gather."""
    batch: Tuple[str, ...] = ("pod", "data") if multi_pod else ("data",)
    tp2d = param_mode == "tp2d"
    fsdp_axes = None if tp2d else (batch if fsdp else None)
    model_axes = ("model",) if tp_feat else None
    feat_axes = (batch + ("model",)) if tp2d else model_axes
    ep = moe_sharding == "ep"
    act_batch = None if shard_pages else batch
    return {
        # ---- parameters ----
        "p_vocab": ("model",),
        "p_embed": fsdp_axes,
        "p_feat": feat_axes,
        "p_experts": ("model",) if ep else None,
        "p_expert_ff": (batch if ep else feat_axes) if tp2d else (
            None if ep else ("model",)),
        "p_noshard": None,
        "layers": None,
        # ---- activations ----
        "act_batch": act_batch,
        "act_seq": None,
        "act_embed": None,
        "act_res_seq": ("model",) if seq_parallel else None,
        "act_heads": model_axes,
        "act_kv_heads": model_axes,
        "act_feat": model_axes,
        "act_vocab": ("model",),
        "act_experts": ("model",) if ep else None,
        "act_expert_ff": None if ep else ("model",),
        "act_capacity": act_batch,
        "act_pages": batch if shard_pages else None,
        "act_noshard": None,
    }


@contextlib.contextmanager
def activate(mesh, rules: AxisRules) -> Iterator[None]:
    """Make ``(mesh, rules)`` the active pair of this thread."""
    prev = getattr(_local, "ctx", None)
    _local.ctx = (mesh, rules)
    try:
        yield
    finally:
        _local.ctx = prev


def active_mesh_rules():
    """The active ``(mesh, rules)``, or None outside ``activate``."""
    return getattr(_local, "ctx", None)


def spec_for(rules: AxisRules, names: Sequence[Optional[str]]
             ) -> Tuple[Optional[Tuple[str, ...]], ...]:
    """The entries of the reference's ``PartitionSpec``: per tensor dim the
    mesh-axis tuple its name maps to, or None.  An unknown name raises a
    ``KeyError``."""
    parts: List[Optional[Tuple[str, ...]]] = []
    for n in names:
        if n is None:
            parts.append(None)
            continue
        if n not in rules:
            raise KeyError(f"unknown logical axis {n!r}")
        parts.append(rules[n])
    return tuple(parts)


def placements_for(mesh, rules: AxisRules, names: Sequence[Optional[str]]):
    """One DTensor placement per dimension of ``mesh`` for a tensor whose
    dims carry ``names`` (the counterpart of ``named_sharding``).  Raises a
    ``ValueError`` where two tensor dims claim one mesh axis."""
    from torch.distributed.tensor import Replicate, Shard

    spec = spec_for(rules, names)
    out = []
    for axis in mesh.mesh_dim_names:
        dims = [i for i, part in enumerate(spec) if part is not None and axis in part]
        if len(dims) > 1:
            raise ValueError(f"mesh axis {axis!r} claimed by tensor dims {dims} "
                             f"of {tuple(names)}")
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def shards_of(name: str) -> int:
    """How many pieces the active rules split a dimension named ``name``
    into on the active mesh (1 outside ``activate``)."""
    ctx = active_mesh_rules()
    if ctx is None:
        return 1
    mesh, rules = ctx
    n = 1
    for axis in rules[name] or ():
        if axis in mesh.mesh_dim_names:
            n *= mesh.size(mesh.mesh_dim_names.index(axis))
    return n


def logical_shard(x: torch.Tensor, *names: Optional[str]) -> torch.Tensor:
    """Constrain ``x`` to the active rules; identity when none are active
    or when ``x`` is a plain tensor (a rank mismatch raises either way)."""
    ctx = active_mesh_rules()
    if ctx is None:
        return x
    if len(names) != x.dim():
        raise ValueError(f"{len(names)} names for rank-{x.dim()} tensor")
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    want = placements_for(x.device_mesh, ctx[1], names)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)
