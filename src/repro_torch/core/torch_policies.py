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
config's ways with dead lanes masked out of fill and eviction.  On the card
the AWRP victim search of all flat rows goes through the hand-written CUDA
rows kernel (``kernels/ops.py`` ``awrp_select_rows``), one launch per trace
step for the whole grid.  Decisions are bit-identical to the host oracles in
``core/policies.py``.

The reference's ``lax.scan`` is a Python loop over the trace here:

* the traces go to the device once, as int32 (range-checked on the host),
  and each group's per-row block ids are gathered for the whole trace up
  front, so a step reads a row of an ``(T, rows)`` tensor;
* the per-row constants (grid masks, the kernel's int32 valid plane,
  adaptive capacities) and the re-interleaving permutation are device
  tensors built once;
* hits go into a preallocated ``(T, rows)`` bool tensor on the device;
* the only host syncs are CAR's clock-hand sweep checks and, where the
  trace is long enough to need it, the stamp renormalization check
  (``policy_core.HOST_SYNCS`` counts both).

Not ported yet: the ``mesh=`` rows sharding (``_sharded_groups_scan``), the
``unroll`` option, and the legacy single-cache API (``CacheState``,
``init_state``, ``access``, ``victim_slot``, ``simulate_trace``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

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


def _simulate_batched_impl(
    traces: torch.Tensor,  # (N, T) int32, on the engine's device
    policy_ids: Tuple[int, ...],
    ways: Tuple[int, ...],  # per-capacity ways
    num_sets: int,
    use_kernel: bool,
    renorm_at: Optional[int],
) -> torch.Tensor:
    dev = traces.device
    N, T = traces.shape
    P, C = len(policy_ids), len(ways)
    PC = P * C
    W = max(ways)

    # grid flattening: b = (n*P + p)*C + c  (capacity axis fastest).  Rows
    # partition by state layout: flat-state rows share one FlatCore; arc
    # and car rows each get an AdaptiveCore.  Hits re-interleave with one
    # gather at the end.
    pids = np.tile(np.repeat(np.asarray(policy_ids, np.int32), C), N)
    ways_b = np.tile(np.asarray(ways, np.int32), N * P)
    simple_idx = np.flatnonzero(np.isin(pids, [POLICY_IDS[p] for p in JAX_POLICIES]))
    arc_idx = np.flatnonzero(pids == POLICY_IDS["arc"])
    car_idx = np.flatnonzero(pids == POLICY_IDS["car"])
    order = np.concatenate([simple_idx, arc_idx, car_idx])
    inv = torch.as_tensor(np.argsort(order), device=dev)
    L = 2 * W  # adaptive directory lanes (cache + ghosts)

    # every row's block id at every step, gathered once: (T, rows) int32
    xs = traces.T.contiguous()

    def ids_for(idx: np.ndarray) -> torch.Tensor:
        return xs[:, torch.as_tensor(idx // PC, device=dev)].contiguous()

    groups = []  # (core, state, per-step ids, step keyword arguments)
    if len(simple_idx):
        core = FlatCore(
            pids=tuple(int(p) for p in pids[simple_idx]),
            ways=tuple(int(w) for w in ways_b[simple_idx]),
            num_sets=num_sets,
            lanes=W,
            use_kernel=use_kernel,
        )
        masks = _make_masks(pids[simple_idx], ways_b[simple_idx], W, dev)
        groups.append((core, core.init(device=dev), ids_for(simple_idx),
                       {"masks": masks}))
    for kind, idx in (("arc", arc_idx), ("car", car_idx)):
        if len(idx):
            core = AdaptiveCore(
                kind=kind,
                caps=tuple(int(w) for w in ways_b[idx]),
                num_sets=num_sets,
                lanes=L,
                renorm_at=renorm_at,
            )
            caps = torch.as_tensor(ways_b[idx], dtype=torch.int32, device=dev)
            groups.append((core, core.init(device=dev), ids_for(idx), {"caps": caps}))

    hits = torch.empty((T, len(order)), dtype=torch.bool, device=dev)
    states = [g[1] for g in groups]
    for t in range(T):
        col = 0
        for gi, (core, _, ids, kw) in enumerate(groups):
            states[gi], h = core.on_access(states[gi], ids[t], **kw)
            hits[t, col:col + core.rows] = h
            col += core.rows

    # (T, concat-of-groups) -> original row order -> (N, P, C, T)
    return hits[:, inv].T.reshape(N, P, C, T)


def simulate_trace_batched(
    traces,
    policies: Sequence[str],
    capacities: Sequence[int],
    *,
    num_sets: int = 1,
    use_kernel: bool | None = None,
    device="cuda",
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
      use_kernel: route AWRP victim selection through the rows kernel
        (``kernels/ops.py`` ``awrp_select_rows``).  Default: True on a CUDA
        device (the hand-written kernel), False on the CPU (where the
        kernel's plain version would only repeat the inline search).
        Decisions are identical either way.
      device: where the engine runs: the CUDA card unless the caller asks
        for the CPU.
      _renorm_at: test hook — override the adaptive stamp-renormalization
        threshold (forcing frequent renormalizations); None picks it
        automatically, and elides the check entirely for traces short
        enough that the stamp counter cannot approach int32 range.

    Returns:
      bool tensor ``(n_traces, n_policies, n_capacities, T)`` of per-access
      hits on ``device``, bit-identical to the host oracles' decisions.
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
    dev = resolve_device(device)
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
