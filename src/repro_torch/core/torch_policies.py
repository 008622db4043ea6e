"""The batched sweep engine: the Table-1 grid as one batch of policy rows
(the counterpart of ``repro/core/jax_policies.py``; the module name mirrors
the reference's so a reader finds it).

Every (trace, policy, capacity) config of a sweep is one row of the tensor
policy core (``core/policy_core.py``), all rows stepped together, one trace
access per step::

    # (n_traces, n_policies, n_caps, T) bool hit bits, on the card:
    hits = simulate_trace_batched(traces, ["awrp", "lru"], [30, 60, 240],
                                  num_sets=4)

Flat-state rows (awrp/lru/fifo/lfu) share one ``FlatCore``; arc and car rows
each get an ``AdaptiveCore``.  Smaller capacities are padded to the widest
config's ways with dead lanes masked out of fill and eviction.  Decisions
are bit-identical to the host oracles in ``core/policies.py``.

Two routes run the reference's ``lax.scan``:

* the trace route (``use_kernel=True``, the default on the card): each row
  group's whole trace is one call, ``kernels/ops.py`` ``flat_sweep`` for the
  flat rows and ``adaptive_sweep`` for each adaptive kind, so a sweep is at
  most three launches of the persistent trace kernels (``csrc/sweep.cu``;
  on the CPU their plain versions).  The traces go to the device once, as
  int32 (range-checked on the host); the kernels read them as they are with
  a row -> trace map, and nothing is read back before the hits: no host
  sync;
* the eager route (``use_kernel=False``, the default on the CPU and the
  card's comparison route): a Python loop over the trace calling each
  group's ``on_access`` per step, every row's block ids gathered up front
  as a ``(T, rows)`` tensor, the per-row constants (grid masks, adaptive
  capacities) built once, hits in a preallocated ``(T, rows)`` bool tensor.
  Its host syncs are one read of each group's per-row constants before the
  loop, CAR's clock-hand sweep checks and, where the trace is long enough to
  need it, the stamp renormalization check (``policy_core.HOST_SYNCS``
  counts the last two).

Rows mesh (``mesh=``, a ``core.sharding`` rows mesh): each state-layout
group pads its rows to a multiple of the shard count with rows that run real
accesses (flat: ``lru`` with 1 way; adaptive: capacity 1) and whose hits are
sliced off; each shard gets its own per-row constants and runs its own
calls (``_sharded_groups``) on its device and stream, on either route; the
hits come back on the mesh's first device in the unsharded row order, bit
for bit the unsharded run's.

Not ported yet: the ``unroll`` option, and the legacy single-cache API
(``CacheState``, ``init_state``, ``access``, ``victim_slot``,
``simulate_trace``).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import sharding
from repro_torch.core.policy_core import (
    ADAPTIVE_POLICIES,
    DEVICE_POLICIES,
    INT_MAX,
    JAX_POLICIES,
    POLICY_IDS,
    AdaptiveCore,
    AdaptiveState,
    FlatCore,
    FlatState,
    _make_masks,
    init_adaptive_state,
)
from repro_torch.device import resolve_device

__all__ = [
    "JAX_POLICIES",
    "ADAPTIVE_POLICIES",
    "DEVICE_POLICIES",
    "POLICY_IDS",
    "SetCacheState",
    "AdaptiveState",
    "init_adaptive_state",
    "init_set_state",
    "access_sets",
    "simulate_trace_sets",
    "simulate_trace_batched",
]

#: Set-associative cache state for the incremental single-cache API
#: (``init_set_state``/``access_sets``): ``(num_sets, ways)`` planes with a
#: ``(num_sets,)`` clock — the core's ``FlatState`` layout.
SetCacheState = FlatState


def init_set_state(
    capacity: int, num_sets: int = 1, *, max_ways: int | None = None,
    device="cuda",
) -> SetCacheState:
    """State for one set-associative cache: ``num_sets`` independent policy
    instances of ``capacity // num_sets`` ways each (the host simulator's
    mapping), on ``device`` (the CUDA card unless the caller asks for the
    CPU).  ``max_ways`` pads the ways axis."""
    if capacity % num_sets:
        raise ValueError(f"capacity {capacity} not divisible by num_sets {num_sets}")
    ways = capacity // num_sets
    W = ways if max_ways is None else max_ways
    if W < ways:
        raise ValueError(f"max_ways {W} < ways {ways}")
    dev = resolve_device(device)
    i32 = dict(dtype=torch.int32, device=dev)
    return SetCacheState(
        blocks=torch.full((num_sets, W), -1, **i32),
        f=torch.zeros((num_sets, W), **i32),
        r=torch.zeros((num_sets, W), **i32),
        clock=torch.zeros((num_sets,), **i32),
    )


class _Group(NamedTuple):
    """One state layout of a grid: its flat rows, its arc rows or its car
    rows, with their per-row constants on the engine's device."""

    kind: str  # "flat", "arc" or "car"
    rows: np.ndarray  # grid rows b = (n*P + p)*C + c, ascending (so by trace)
    row_trace: torch.Tensor  # (rows,) int32 trace of each row
    pids: torch.Tensor  # (rows,) int32 POLICY_IDS value
    ways: torch.Tensor  # (rows,) int32 per-set capacity


def _grid_groups(N: int, policy_ids: Tuple[int, ...], ways: Tuple[int, ...],
                 dev) -> List[_Group]:
    """Partition the (N, policies, capacities) grid by state layout:
    flat-state rows share one group, arc and car rows get one each."""
    P, C = len(policy_ids), len(ways)
    pids = np.tile(np.repeat(np.asarray(policy_ids, np.int32), C), N)
    ways_b = np.tile(np.asarray(ways, np.int32), N * P)
    parts = (("flat", np.isin(pids, [POLICY_IDS[p] for p in JAX_POLICIES])),
             ("arc", pids == POLICY_IDS["arc"]), ("car", pids == POLICY_IDS["car"]))
    groups = []
    for kind, sel in parts:
        idx = np.flatnonzero(sel)
        if len(idx):
            groups.append(_Group(kind, idx, *(
                torch.as_tensor(a.astype(np.int32), device=dev)
                for a in (idx // (P * C), pids[idx], ways_b[idx]))))
    return groups


def _sweep_groups(traces: torch.Tensor, groups: Sequence[_Group], num_sets: int, W: int,
                  renorm_at: Optional[int], *, flat=None, adaptive=None) -> list:
    """The trace route: each group's whole trace in one call of ``flat``
    (default ``ops.flat_sweep``) or ``adaptive`` (``ops.adaptive_sweep``);
    returns ``[(hits (rows, T) bool, final state)]`` in group order.  Nothing
    here reads the device back."""
    from repro_torch.kernels import ops

    flat = flat or ops.flat_sweep
    adaptive = adaptive or ops.adaptive_sweep
    out = []
    for g in groups:
        if g.kind == "flat":
            out.append(flat(traces, g.row_trace, g.pids, g.ways, num_sets=num_sets, lanes=W))
        else:
            out.append(adaptive(traces, g.row_trace, g.ways, kind=g.kind, num_sets=num_sets,
                                lanes=2 * W, renorm_at=renorm_at))
    return out


def _eager_steps(xs: torch.Tensor, groups: Sequence[_Group], num_sets: int, W: int,
                 renorm_at: Optional[int]) -> list:
    """The eager route's per-group loop state on ``xs``' device: ``[core,
    state, per-step ids (T, rows), step keyword arguments]`` per group."""
    dev = xs.device
    steps = []
    for g in groups:
        ids = xs[:, g.row_trace.long()].contiguous()
        pids_g = tuple(g.pids.tolist())
        ways_g = tuple(g.ways.tolist())
        if g.kind == "flat":
            core = FlatCore(pids=pids_g, ways=ways_g, num_sets=num_sets, lanes=W)
            masks = _make_masks(pids_g, ways_g, W, dev)
            steps.append([core, core.init(device=dev), ids, {"masks": masks}])
        else:
            core = AdaptiveCore(kind=g.kind, caps=ways_g, num_sets=num_sets, lanes=2 * W,
                                renorm_at=renorm_at)
            steps.append([core, core.init(device=dev), ids, {"caps": g.ways}])
    return steps


def _eager_step(steps: list, t: int) -> List[torch.Tensor]:
    """Step ``t`` of every group of ``_eager_steps``: the groups' (rows,)
    hits."""
    hits = []
    for st in steps:
        core, state, ids, kw = st
        st[1], h = core.on_access(state, ids[t], **kw)
        hits.append(h)
    return hits


def _simulate_batched_impl(
    traces: torch.Tensor,  # (N, T) int32, on the engine's device
    policy_ids: Tuple[int, ...],
    ways: Tuple[int, ...],  # per-capacity ways
    num_sets: int,
    use_kernel: bool,
    renorm_at: Optional[int],
    mesh=None,
) -> torch.Tensor:
    dev = traces.device
    N, T = traces.shape
    P, C = len(policy_ids), len(ways)
    W = max(ways)

    # grid flattening: b = (n*P + p)*C + c  (capacity axis fastest).  Rows
    # partition by state layout; hits re-interleave with one gather at the
    # end.
    groups = _grid_groups(N, policy_ids, ways, dev)
    inv = torch.as_tensor(np.argsort(np.concatenate([g.rows for g in groups])), device=dev)

    if mesh is not None:
        hits = _sharded_groups(traces, groups, mesh, num_sets, W, renorm_at, use_kernel)
        return hits[inv].reshape(N, P, C, T)

    if use_kernel:  # the trace route: one call per group runs its whole trace
        hits = torch.cat([h for h, _ in _sweep_groups(traces, groups, num_sets, W, renorm_at)])
        return hits[inv].reshape(N, P, C, T)

    # the eager route: every row's block id at every step, gathered once:
    # (T, rows) int32
    steps = _eager_steps(traces.T.contiguous(), groups, num_sets, W, renorm_at)
    hits = torch.empty((T, len(inv)), dtype=torch.bool, device=dev)
    for t in range(T):
        hits[t] = torch.cat(_eager_step(steps, t))

    # (T, concat-of-groups) -> original row order -> (N, P, C, T)
    return hits[:, inv].T.reshape(N, P, C, T)


def _pad_group(g: _Group, n: int) -> _Group:
    """``g`` with its rows padded to a multiple of ``n`` (on the host): pad
    rows read trace 0, as ``lru`` with 1 way (flat) or capacity 1
    (adaptive), and run real accesses whose hits the caller slices off."""
    B = len(g.rows)
    Bp = sharding.pad_rows_to(B, n)
    pad = (np.zeros(Bp - B, np.int32), np.full(Bp - B, POLICY_IDS["lru"], np.int32),
           np.ones(Bp - B, np.int32))
    cols = [np.concatenate([t.cpu().numpy(), p])
            for t, p in zip((g.row_trace, g.pids, g.ways), pad)]
    return _Group(g.kind, g.rows, *(torch.from_numpy(c) for c in cols))


def _sharded_groups(traces: torch.Tensor, groups: Sequence[_Group], mesh, num_sets: int,
                    W: int, renorm_at: Optional[int], use_kernel: bool) -> torch.Tensor:
    """The grid under a rows mesh: each group padded (``_pad_group``) and cut
    into the mesh's shards, each shard's per-row constants on its device,
    the traces copied once to each device; shard ``i`` runs its groups
    (trace route: one ``flat_sweep`` / ``adaptive_sweep`` call per group;
    eager route: the step loop) on its device and stream.  Returns the
    ``(rows, T)`` hits of the groups concatenated, pads sliced off, on the
    mesh's first device."""
    n, T = mesh.size, traces.shape[1]
    padded = [_pad_group(g, n) for g in groups]
    on_dev = {d: traces.to(d) for d in mesh.distinct_devices}
    shard_groups = []  # per shard: its part of every group
    for i, d in enumerate(mesh.devices):
        part = []
        for g in padded:
            k = len(g.row_trace) // n
            part.append(_Group(g.kind, g.rows, *(t[i * k:(i + 1) * k].to(d)
                                                 for t in (g.row_trace, g.pids, g.ways))))
        shard_groups.append(part)
    if use_kernel:
        per_shard = sharding.run_shards(
            mesh, lambda i, part: [h for h, _ in _sweep_groups(
                on_dev[mesh.devices[i]], part, num_sets, W, renorm_at)], shard_groups)
    else:
        steps = [_eager_steps(on_dev[d].T.contiguous(), part, num_sets, W, renorm_at)
                 for d, part in zip(mesh.devices, shard_groups)]
        per_shard = [[torch.empty((T, len(p.row_trace)), dtype=torch.bool, device=d)
                      for p in part] for d, part in zip(mesh.devices, shard_groups)]
        with sharding.forked(mesh):
            for t in range(T):
                for i in range(n):
                    with sharding.on_shard(mesh, i):
                        for out, h in zip(per_shard[i], _eager_step(steps[i], t)):
                            out[t] = h
        per_shard = [[h.T for h in hs] for hs in per_shard]
    dev = mesh.devices[0]
    return torch.cat([torch.cat([hs[gi].to(dev) for hs in per_shard])[:len(g.rows)]
                      for gi, g in enumerate(groups)])


def simulate_trace_batched(
    traces,
    policies: Sequence[str],
    capacities: Sequence[int],
    *,
    num_sets: int = 1,
    use_kernel: bool | None = None,
    device="cuda",
    mesh=None,
    _renorm_at: Optional[int] = None,
) -> torch.Tensor:
    """Run the full (trace, policy, capacity) grid as one batch of rows.

    Args:
      traces: ``(T,)`` or ``(N, T)`` non-negative block ids (equal lengths).
      policies: device policy names (subset of ``DEVICE_POLICIES``).
      capacities: total cache capacities; each must divide by ``num_sets``.
        Mixed sizes batch together — smaller caches get dead padding lanes
        masked out of both fill and eviction.
      num_sets: set-associative mapping ``set = block % num_sets`` (the host
        simulator's convention).
      use_kernel: run each row group's whole trace in one call of the trace
        kernels (``kernels/ops.py`` ``flat_sweep``, ``adaptive_sweep``)
        instead of the eager per-step loop.  Default: True on a CUDA device
        (the hand-written kernels), False on the CPU (where their plain
        versions would only repeat the eager loop).  Decisions are
        identical either way.
      device: where the engine runs: the CUDA card unless the caller asks
        for the CPU.
      mesh: a ``core.sharding`` rows mesh: the grid's rows run across its
        shards, each on its own device and stream (``device`` is then the
        mesh's first device); decisions are bit-identical to the unsharded
        run.  None (the default) runs unsharded.
      _renorm_at: test hook — override the adaptive stamp-renormalization
        threshold (forcing frequent renormalizations); None picks it
        automatically, and elides the check entirely for traces short
        enough that the stamp counter cannot approach int32 range.

    Returns:
      bool tensor ``(n_traces, n_policies, n_capacities, T)`` of per-access
      hits on ``device`` (a mesh's first device), bit-identical to the host
      oracles' decisions.
    """
    tr = np.asarray(traces)
    if tr.ndim == 1:
        tr = tr[None, :]
    if tr.ndim != 2:
        raise ValueError(f"traces must be (T,) or (N, T), got shape {tr.shape}")
    if tr.size and (tr.min() < 0 or tr.max() > INT_MAX):
        raise ValueError(
            "block ids must fit int32 (0 <= id <= 2**31-1); rebase or hash "
            "the address space first"
        )
    policies = tuple(policies)
    capacities = tuple(int(c) for c in capacities)
    unknown = [p for p in policies if p not in POLICY_IDS]
    if unknown:
        raise ValueError(f"not device policies: {unknown}; have {DEVICE_POLICIES}")
    if not policies or not capacities:
        raise ValueError("need at least one policy and one capacity")
    ways = []
    for c in capacities:
        if c % num_sets:
            raise ValueError(f"capacity {c} not divisible by num_sets {num_sets}")
        ways.append(c // num_sets)
    dev = resolve_device(device) if mesh is None else mesh.devices[0]
    renorm_at = _renorm_at
    if renorm_at is None and any(p in ADAPTIVE_POLICIES for p in policies):
        # ARC/CAR grant at most ways+2 stamps per access; when the whole
        # trace cannot approach the renormalization ceiling, elide the
        # per-step check (and its host sync) statically
        auto = AdaptiveCore(kind="arc", caps=(max(ways),)).renorm_at
        if tr.shape[1] * (max(ways) + 2) >= auto:
            renorm_at = auto
    if use_kernel is None:
        use_kernel = dev.type == "cuda"
    return _simulate_batched_impl(
        torch.as_tensor(tr.astype(np.int32), device=dev),
        tuple(POLICY_IDS[p] for p in policies),
        tuple(ways),
        int(num_sets),
        bool(use_kernel),
        renorm_at,
        mesh,
    )


def simulate_trace_sets(
    trace, capacity: int, *, policy: str = "awrp", num_sets: int = 1,
    use_kernel: bool | None = None, device="cuda",
) -> torch.Tensor:
    """Single-config set-associative trace simulation (batched engine, B=1)."""
    hits = simulate_trace_batched(
        np.asarray(trace)[None, :], (policy,), (capacity,),
        num_sets=num_sets, use_kernel=use_kernel, device=device,
    )
    return hits[0, 0, 0]


def access_sets(
    state: SetCacheState, block, *, policy: str = "awrp", use_kernel: bool = False,
) -> Tuple[SetCacheState, torch.Tensor]:
    """One access against a single ``(num_sets, ways)`` state (incremental
    API).  All lanes are live; flat-state policies only — ARC/CAR carry
    ``AdaptiveState`` and run through the policy core or the batched
    engine.  Returns the new state and a 0-d bool hit."""
    if policy not in JAX_POLICIES:
        raise ValueError(
            f"access_sets supports the flat-state policies {JAX_POLICIES}; "
            f"adaptive policies {ADAPTIVE_POLICIES} run via the policy core"
        )
    num_sets, W = state.blocks.shape
    core = FlatCore(
        pids=(POLICY_IDS[policy],), ways=(W,), num_sets=num_sets,
        lanes=W, use_kernel=use_kernel,
    )
    ids = torch.as_tensor(block, dtype=torch.int32, device=state.blocks.device).reshape(1)
    if num_sets == 1:
        # the (S=1, W) planes already ARE the core's squeezed (rows=1, W)
        state, is_hit = core.on_access(state, ids)
    else:
        # the single-cache (S, W) layout as the core's (rows=1, S, W)
        fstate, is_hit = core.on_access(FlatState(*(t[None] for t in state)), ids)
        state = SetCacheState(*(t[0] for t in fstate))
    return state, is_hit[0]
