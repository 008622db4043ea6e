"""The rows mesh: sharding the policy core's rows axis over devices
(``repro/core/sharding.py``).

Every policy state of the port (``FlatState`` / ``AdaptiveState`` planes,
the tenancy manager's tenant rows, the per-sequence paged-KV pools, the
sweep engine's (trace, policy, capacity) grid) carries one leading *rows*
axis of independent policy instances, and every step function is row-local:
each reduction runs over the lane or set axes, each scatter uses per-row
indices.  Splitting the rows axis over a mesh of devices therefore splits
the whole program with no per-step collective: each shard steps its own
rows, and the only communication is the caller's final gather.  Decisions
are bit-identical to the unsharded run, since no row's arithmetic changes
(``tests/test_torch_sharding.py`` holds that at 1, 2 and 8 shards).

The mesh is single-controller, as the reference's ``shard_map`` over a
``Mesh``: one Python process drives a tuple of devices, and each shard's
work is enqueued on its own device and, on a CUDA device, its own stream.
A mesh may repeat a device (``rows_mesh(devices=("cuda:0",) * 4)``): the
shards then run concurrently on one card's streams, as the reference's
tests run on ``--xla_force_host_platform_device_count`` host devices.

Layer contents:

* ``rows_mesh(n)`` / ``RowsMesh``: a 1-D mesh over the ``"rows"`` axis;
* ``leaf_spec(leaf)``: the placement rule, rows (axis 0) across the mesh,
  every trailing axis replicated, a 0-d leaf replicated;
* ``shard_rows(core, state, mesh)``: place a rows-leading pytree across the
  mesh as a ``RowShards`` (shard ``i`` holds rows ``[i*k, (i+1)*k)``);
  ``gather_rows`` concatenates it back on the mesh's first device;
* ``pad_rows_to(n_rows, n)``: the padded row count even placement needs;
* ``split_rows`` / ``run_shards``: the per-shard launch of the sharded
  surfaces (each shard's work on its device and stream, joined before
  return).

Shards on the device the state was built on are row views of it
(``narrow(0, ...)``: no copy); shards on another device are copies.
``mesh=None`` everywhere is a strict no-op.

Not ported: ``state_spec`` / ``state_sharding`` / ``constrain_rows``, the
GSPMD placement objects, which have no meaning without XLA's partitioner.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.device import resolve_device

__all__ = [
    "ROWS_AXIS",
    "RowsMesh",
    "RowShards",
    "rows_mesh",
    "device_count",
    "leaf_spec",
    "pad_rows_to",
    "shard_rows",
    "gather_rows",
    "split_rows",
    "run_shards",
    "forked",
    "on_shard",
    "tree_map",
]

#: the one mesh axis name this layer shards over
ROWS_AXIS = "rows"


def _normal(device) -> torch.device:
    """``device`` resolved (no fallback) with its index filled in, so it
    compares equal to a tensor's ``.device``."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True, eq=False)
class RowsMesh:
    """A 1-D mesh over the ``"rows"`` axis: a tuple of devices (repeats
    allowed) and, on CUDA devices, one stream per shard.  Shard ``i`` runs
    on ``devices[i]`` and ``streams[i]``."""

    devices: Tuple[torch.device, ...]
    streams: Tuple[Optional[torch.cuda.Stream], ...]

    @property
    def size(self) -> int:
        """Number of shards."""
        return len(self.devices)

    @property
    def distinct_devices(self) -> Tuple[torch.device, ...]:
        """The mesh's devices, each once, in first-use order."""
        return tuple(dict.fromkeys(self.devices))


def device_count() -> int:
    """Number of visible CUDA devices (the most distinct devices a
    ``rows_mesh`` can span)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def rows_mesh(n_devices: Optional[int] = None, *,
              devices: Optional[Sequence[Any]] = None) -> RowsMesh:
    """A 1-D mesh over the ``"rows"`` axis.

    By default every visible CUDA device, or the first ``n_devices`` of
    them; ``devices=`` names the shards' devices, repeats allowed
    (``devices=("cuda:0",) * 4``, or ``("cpu",) * 8`` on the CPU), and
    ``n_devices`` then takes the first that many.  A CUDA mesh on a machine
    without CUDA raises: there is no fallback.  Moves no data."""
    if devices is None:
        resolve_device("cuda")
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = [_normal(d) for d in devices]
    n = len(devs) if n_devices is None else int(n_devices)
    if not 1 <= n <= len(devs):
        raise ValueError(f"n_devices {n} not in [1, {len(devs)}]")
    devs = tuple(devs[:n])
    streams = tuple(torch.cuda.Stream(device=d) if d.type == "cuda" else None for d in devs)
    return RowsMesh(devices=devs, streams=streams)


def leaf_spec(leaf) -> tuple:
    """The placement of one state leaf: ``(ROWS_AXIS, None, ...)`` (rows on
    the mesh, every trailing axis replicated), or ``()`` for a 0-d leaf
    (replicated)."""
    if leaf.dim() == 0:
        return ()
    return (ROWS_AXIS,) + (None,) * (leaf.dim() - 1)


def pad_rows_to(n_rows: int, n_devices: int) -> int:
    """Smallest multiple of ``n_devices`` >= ``n_rows``: the padded rows
    count even placement needs (``shard_rows``); callers keep the extra rows
    dead (``active=False`` accesses are bit-exact no-ops)."""
    if n_rows <= 0 or n_devices <= 0:
        raise ValueError(f"need positive rows/devices, got {n_rows}/{n_devices}")
    return -(-n_rows // n_devices) * n_devices


def tree_map(fn: Callable, tree):
    """``fn`` over every tensor leaf of a tree of named tuples, tuples,
    lists and dicts; other leaves (``None``, Python scalars) are kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return tree


def _leaves(tree) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    tree_map(out.append, tree)
    return out


def _zip_map(fn: Callable, trees: Sequence):
    """``fn(list of corresponding leaves)`` over trees of one structure."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return fn(list(trees))
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_zip_map(fn, parts) for parts in zip(*trees)))
    if isinstance(first, (tuple, list)):
        return type(first)(_zip_map(fn, parts) for parts in zip(*trees))
    if isinstance(first, dict):
        return {k: _zip_map(fn, [t[k] for t in trees]) for k in first}
    return first


@dataclasses.dataclass(frozen=True, eq=False)
class RowShards:
    """A rows-leading pytree placed across a ``RowsMesh``: ``shards[i]`` is
    the same pytree holding rows ``[offsets[i], offsets[i + 1])`` on
    ``mesh.devices[i]`` (0-d leaves replicated on every shard)."""

    shards: Tuple[Any, ...]
    offsets: Tuple[int, ...]  # n + 1 row offsets, 0 first, rows last
    mesh: RowsMesh

    @property
    def rows(self) -> int:
        return self.offsets[-1]

    def bounds(self, i: int) -> Tuple[int, int]:
        """Shard ``i``'s global rows ``[lo, hi)``."""
        return self.offsets[i], self.offsets[i + 1]

    def locate(self, row: int) -> Tuple[int, int]:
        """``(shard, local row)`` of global row ``row``."""
        if not 0 <= row < self.rows:
            raise IndexError(f"row {row} not in [0, {self.rows})")
        k = self.offsets[1]
        return row // k, row % k

    def replace(self, shards) -> "RowShards":
        """The same placement holding ``shards``."""
        return RowShards(tuple(shards), self.offsets, self.mesh)


def _rows_of(tree) -> int:
    for leaf in _leaves(tree):
        if leaf.dim():
            return leaf.shape[0]
    raise ValueError("a rows-leading pytree needs a leaf with a rows axis")


def _place(leaf: torch.Tensor, lo: int, k: int, dev: torch.device) -> torch.Tensor:
    """``leaf_spec``'s rule for one shard: rows ``[lo, lo + k)`` (a view on
    the leaf's own device, a copy elsewhere); a 0-d leaf whole."""
    part = leaf.narrow(0, lo, k) if leaf_spec(leaf) else leaf
    return part if part.device == dev else part.to(dev)


def _shard(tree, mesh: RowsMesh) -> RowShards:
    rows, n = _rows_of(tree), mesh.size
    if rows % n:
        raise ValueError(
            f"{rows} rows do not divide a mesh of {n}; pad them (pad_rows_to)")
    k = rows // n
    shards = tuple(tree_map(lambda x, lo=i * k, d=dev: _place(x, lo, k, d), tree)
                   for i, dev in enumerate(mesh.devices))
    return RowShards(shards, tuple(i * k for i in range(n + 1)), mesh)


def shard_rows(core, state, mesh: Optional[RowsMesh], counters=None):
    """Place ``state`` (a ``FlatState`` / ``AdaptiveState`` / any
    rows-leading pytree built for ``core``) across ``mesh``'s rows axis as a
    ``RowShards``: shard ``i`` holds rows ``[i*k, (i+1)*k)``, ``k = rows /
    n``, which requires even division (pad with ``pad_rows_to``).
    ``counters`` (a ``RowCounters``) is placed the same way and the pair
    returned.  ``mesh=None`` returns the inputs unchanged; a state already
    placed on ``mesh`` is kept as it is.  Decisions after sharding are
    bit-identical to before (the step functions are row-local)."""
    del core  # placement depends only on the pytree's shapes
    if mesh is not None:
        state = state if _on(state, mesh) else _shard(gather_rows(state), mesh)
        if counters is not None:
            counters = counters if _on(counters, mesh) else _shard(gather_rows(counters), mesh)
    return state if counters is None else (state, counters)


def _on(tree, mesh: RowsMesh) -> bool:
    return isinstance(tree, RowShards) and tree.mesh is mesh


def gather_rows(tree):
    """A ``RowShards`` concatenated back into one pytree on its mesh's first
    device (0-d leaves from shard 0); any other tree is returned as is."""
    if not isinstance(tree, RowShards):
        return tree
    dev = tree.mesh.devices[0]

    def cat(parts: List[torch.Tensor]) -> torch.Tensor:
        if parts[0].dim() == 0:
            return parts[0].to(dev)
        return torch.cat([p.to(dev) for p in parts])

    return _zip_map(cat, tree.shards)


def split_rows(tree, mesh: RowsMesh) -> list:
    """Per-shard parts of a rows-leading pytree (its shards if it is a
    ``RowShards``), placed by ``leaf_spec``'s rule: views on each leaf's own
    device, copies elsewhere."""
    if isinstance(tree, RowShards):
        return list(tree.shards)
    return list(_shard(tree, mesh).shards)


@contextlib.contextmanager
def forked(mesh: RowsMesh):
    """Fork every shard stream off its device's current stream, and join
    them back on exit: work a shard enqueues sees every earlier write, and
    work after the block sees every shard's."""
    cuda = [(s, d) for s, d in zip(mesh.streams, mesh.devices) if s is not None]
    current = {d: torch.cuda.current_stream(d) for _, d in cuda}
    for s, d in cuda:
        s.wait_stream(current[d])
    try:
        yield
    finally:
        for s, d in cuda:
            current[d].wait_stream(s)


@contextlib.contextmanager
def on_shard(mesh: RowsMesh, i: int):
    """Run the body on shard ``i``'s device and stream (no-op on the CPU)."""
    stream = mesh.streams[i]
    if stream is None:
        yield
        return
    with torch.cuda.device(mesh.devices[i]), torch.cuda.stream(stream):
        yield


def run_shards(mesh: RowsMesh, fn: Callable, *per_shard: Sequence) -> list:
    """``[fn(i, *args_i)]``: shard ``i``'s call enqueued on its own device
    and stream, all shards forked off the current streams and joined back
    before return, so the results are ready for the caller's stream."""
    out = []
    with forked(mesh):
        for i in range(mesh.size):
            with on_shard(mesh, i):
                out.append(fn(i, *(a[i] for a in per_shard)))
    return out
