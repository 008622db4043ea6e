"""Device meshes over the ``torch.distributed`` process group
(``repro/launch/mesh.py``).

``make_production_mesh`` builds the reference's protocol-fixed meshes:
(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod", "data",
"model"), one rank per device.  Nothing here touches the process group at
import.  The caller starts the group itself (``init_process_group`` with an
``init_method``, its rank and its world size); without one the world is a
single rank.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

__all__ = ["AXES", "world_size", "make_mesh", "make_production_mesh", "batch_axes",
           "batch_shards"]

#: mesh axis names by mesh rank
AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}


def world_size() -> int:
    """Ranks in the default process group (1 when none is started)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def make_mesh(shape: Sequence[int], *, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` (2-D: ("data", "model"), 3-D: ("pod",
    "data", "model")) over every rank of the started process group.  Raises
    a ``RuntimeError`` naming the world size the shape needs when the world
    is smaller."""
    shape = tuple(int(s) for s in shape)
    if len(shape) not in AXES:
        raise ValueError(f"mesh shape {shape}: 2 or 3 axes")
    n, have = math.prod(shape), world_size()
    if have < n:
        raise RuntimeError(
            f"mesh {shape} needs a world of {n} ranks, have {have}; start "
            f"torch.distributed with world_size={n} (one rank per device) first")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, shape, mesh_dim_names=AXES[len(shape)])


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The (16, 16) ("data", "model") mesh, or (2, 16, 16) with "pod"."""
    return make_mesh((2, 16, 16) if multi_pod else (16, 16), device_type=device_type)


def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def batch_shards(mesh) -> int:
    names = mesh.mesh_dim_names
    return math.prod(mesh.size(names.index(a)) for a in batch_axes(mesh))
