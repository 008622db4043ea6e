"""Tensor policy core: one protocol behind the sweep engine and the serving
caches (``repro/core/policy_core.py``).

Every device-capable policy — the flat-state quartet (awrp/lru/fifo/lfu) and
the array-encoded adaptive pair (arc/car) — is implemented once here, and
every consumer (the Table-1 sweep engine in ``core/torch_policies.py``, the
paged-KV pool) drives the same step functions.  Decisions are bit-identical
to the host oracles in ``core/policies.py``.

Protocol::

    core = make_core(policy, rows, num_sets, ways)   # static spec
    state = core.init(device="cuda")                 # FlatState | AdaptiveState
    state, hit = core.on_access(state, ids)          # ids: (rows,) int32
    lane = core.victim(state)                        # advisory next victim

``rows`` is a free batch axis of independent policy instances (one per
(trace, policy, capacity) config in the sweep engine).  ``on_access``
returns NEW state tensors and never writes the ones it was given, so a caller
may keep an old state; ``active`` masks rows to no-ops (no state change, no
clock tick, no hit).

Every plane is ``int32`` (``p`` is float32); weights are compared through
their int32 bit pattern (``w >= 0`` always, so IEEE order equals int32
order) and every selection is a first-index min, never ``argmin`` (whose tie
order torch does not promise).  The AWRP victim of the flat rows can route
through the hand-written CUDA rows kernel (``use_kernel``,
``kernels/ops.py`` ``awrp_select_rows``): a dispatch of the core, not of its
callers.

Differences from the reference, all deliberate:
* the scan-body control flow runs eagerly: CAR's clock-hand sweep is a Python
  loop that stops when no row is still sweeping (one ``any()`` sync per trip,
  at most ``max(caps) + 1`` trips), and the stamp renormalization check is a
  Python ``if`` (one sync per access while it is enabled);
* ``_GridMasks`` also carries ``valid``, the int32 live-lane plane the rows
  kernel takes, built once per batch instead of once per access;
* no ``mesh``, no ``RowCounters`` / ``on_access_counted`` / admission and no
  decision tracing yet (later slices).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = [
    "INT_MAX",
    "JAX_POLICIES",
    "ADAPTIVE_POLICIES",
    "DEVICE_POLICIES",
    "POLICY_IDS",
    "FlatState",
    "AdaptiveState",
    "PolicyState",
    "FlatCore",
    "AdaptiveCore",
    "PolicyCore",
    "make_core",
    "init",
    "init_adaptive_state",
    "awrp_weights",
    "first_min",
    "awrp_victim_rows",
    "make_cache_policy",
]

INT_MAX = 2**31 - 1

#: flat-state policies: one (blocks, F, R) slot array is their entire state
#: (the reference's name for the quartet, kept so the two modules read alike).
JAX_POLICIES = ("awrp", "lru", "fifo", "lfu")

#: list-structured adaptive policies, device-capable via the array encoding.
ADAPTIVE_POLICIES = ("arc", "car")

#: everything the core (and therefore every consumer) accepts.
DEVICE_POLICIES = JAX_POLICIES + ADAPTIVE_POLICIES

#: stable integer encoding of the device policies.
POLICY_IDS = {name: i for i, name in enumerate(DEVICE_POLICIES)}

_I32 = torch.int32


def awrp_weights(f: torch.Tensor, r: torch.Tensor, clock: torch.Tensor) -> torch.Tensor:
    """Paper eq. (1): W_i = F_i / (N - R_i), float32 IEEE division
    (callers mask empties)."""
    dt = torch.clamp(clock - r, min=1).to(torch.float32)
    return f.to(torch.float32) / dt


# ---------------------------------------------------------------------------
# victim reductions
# ---------------------------------------------------------------------------


def first_min(key: torch.Tensor) -> torch.Tensor:
    """First index achieving the row minimum of ``key`` (..., P) int32, as
    two min-reductions; returns int32."""
    P = key.shape[-1]
    lane = torch.arange(P, dtype=_I32, device=key.device)
    m = key.amin(dim=-1, keepdim=True)
    return torch.where(key == m, lane, P).amin(dim=-1).to(_I32)


def awrp_victim_rows(
    f: torch.Tensor,  # (B, P) int32
    r: torch.Tensor,  # (B, P) int32
    clock: torch.Tensor,  # (B,) int32
    valid: torch.Tensor,  # (B, P) bool, or int32 0/1
    *,
    use_kernel: bool = False,
) -> torch.Tensor:
    """Core-level AWRP victim dispatch: the rows kernel
    (``ops.awrp_select_rows``: the CUDA kernel for CUDA tensors, its plain
    version for CPU ones) or the inline bit-pattern first-index min.
    Identical decisions either way."""
    if use_kernel:
        from repro_torch.kernels.ops import awrp_select_rows

        return awrp_select_rows(f, r, clock, valid.to(_I32))
    bits = awrp_weights(f, r, clock[:, None]).view(_I32)
    return first_min(torch.where(valid != 0, bits, INT_MAX))


def _choose(cond: torch.Tensor, a, b) -> torch.Tensor:
    """``torch.where`` kept int32 (two Python-int branches would give int64)."""
    return torch.where(cond, a, b).to(_I32)


# ---------------------------------------------------------------------------
# flat-state policies (awrp / lru / fifo / lfu)
# ---------------------------------------------------------------------------


class FlatState(NamedTuple):
    """Per-row flat policy state.  Set-associative cores carry
    ``(rows, num_sets, ways)`` planes with a ``(rows, num_sets)`` clock;
    single-set cores drop the sets axis: ``(rows, ways)`` planes, ``(rows,)``
    clock.  ``blocks == -1`` marks an empty lane; dead lanes (capacity
    padding in a mixed-ways batch) are identified by the core's mask."""

    blocks: torch.Tensor  # (B[, S], W) int32, -1 = empty
    f: torch.Tensor  # (B[, S], W) int32 frequency counters
    r: torch.Tensor  # (B[, S], W) int32 recency clock (insertion clock for FIFO)
    clock: torch.Tensor  # (B[, S]) int32 per-set access clock N


class _GridMasks(NamedTuple):
    """Per-row constants of a flat-core batch, built once per batch."""

    lru_or_fifo: torch.Tensor  # (B, 1) bool
    lfu: torch.Tensor  # (B, 1) bool
    awrp_row: torch.Tensor  # (B,) bool
    fifo_row: torch.Tensor  # (B,) bool
    dead: torch.Tensor  # (B, W) bool — capacity-padding lanes
    iota: torch.Tensor  # (1, W) int32 lane indices
    valid: torch.Tensor  # (B, W) int32 ~dead, the rows kernel's valid plane


def _make_masks(pids, ways_b, W: int, device) -> _GridMasks:
    pids = np.asarray(pids)
    dead = ~(np.arange(W)[None, :] < np.asarray(ways_b)[:, None])

    def dev(a):
        return torch.as_tensor(a, device=device)

    return _GridMasks(
        lru_or_fifo=dev((pids == POLICY_IDS["lru"]) | (pids == POLICY_IDS["fifo"]))[:, None],
        lfu=dev(pids == POLICY_IDS["lfu"])[:, None],
        awrp_row=dev(pids == POLICY_IDS["awrp"]),
        fifo_row=dev(pids == POLICY_IDS["fifo"]),
        dead=dev(dead),
        iota=torch.arange(W, dtype=_I32, device=device)[None, :],
        valid=dev((~dead).astype(np.int32)),
    )


@functools.lru_cache(maxsize=64)
def _cached_masks(pids: tuple, ways: tuple, W: int, device: torch.device) -> _GridMasks:
    return _make_masks(pids, ways, W, device)


def _flat_victim(
    row_f: torch.Tensor,  # (B, W) int32
    row_r: torch.Tensor,  # (B, W) int32
    clk: torch.Tensor,  # (B,) int32 — the clock the decision is made at
    masks: _GridMasks,
    use_kernel: bool,
) -> torch.Tensor:
    """Policy-keyed victim selection over one (B, W) row batch.  Also
    performs empty-lane fill: an empty lane has F = R = 0, so its key beats
    every occupied lane under all four policies and ties break to the lowest
    lane index — the host oracles' first-empty order."""
    iota = masks.iota
    # stage 1: policy-selected primary key, min over lanes
    if use_kernel:
        v_awrp = awrp_victim_rows(row_f, row_r, clk, masks.valid, use_kernel=True)
        prim = torch.where(masks.lfu, row_f, row_r)  # awrp rows: unused filler
    else:
        wbits = awrp_weights(row_f, row_r, clk[:, None]).view(_I32)
        prim = torch.where(masks.lru_or_fifo, row_r, torch.where(masks.lfu, row_f, wbits))
    prim = torch.where(masks.dead, INT_MAX, prim)
    m1 = prim.amin(dim=-1)
    # stage 2: tie-break key (recency for LFU, lane index otherwise)
    sec = torch.where(masks.lfu, row_r, iota)
    k2 = torch.where(prim == m1[:, None], sec, INT_MAX)
    m2 = k2.amin(dim=-1)
    # stage 3: first lane achieving (m1, m2)
    W = row_f.shape[-1]
    victim = torch.where(k2 == m2[:, None], iota, W).amin(dim=-1)
    if use_kernel:
        victim = torch.where(masks.awrp_row, v_awrp, victim)
    return victim


def _row_step(
    row_blocks: torch.Tensor,  # (B, W) int32
    row_f: torch.Tensor,  # (B, W) int32
    row_r: torch.Tensor,  # (B, W) int32
    clk: torch.Tensor,  # (B,) int32 — this access's clock value per row
    block: torch.Tensor,  # (B,) int32
    masks: _GridMasks,
    use_kernel: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Shared per-access decision logic -> (slot, is_hit, new_f, new_r)."""
    W = row_blocks.shape[-1]
    iota = masks.iota
    # hit detection: one min-reduce (W = miss sentinel)
    hit_k = torch.where(row_blocks == block[:, None], iota, W).amin(dim=-1)
    is_hit = hit_k < W
    victim = _flat_victim(row_f, row_r, clk, masks, use_kernel)
    slot = torch.where(is_hit, hit_k, victim)
    idx = slot[:, None].long()
    old_f = row_f.gather(-1, idx)[:, 0]
    old_r = row_r.gather(-1, idx)[:, 0]
    new_f = torch.where(is_hit, old_f + 1, 1)
    # FIFO keeps its insertion clock in R: freeze R on hits for FIFO rows
    new_r = torch.where(is_hit & masks.fifo_row, old_r, clk)
    return slot, is_hit, new_f, new_r


def _select_state(active: torch.Tensor, new_state, old_state):
    """Row-masked select: rows where ``active`` is False keep their old
    state (the serving callers' masked no-op accesses)."""

    def pick(new, old):
        a = active.reshape(active.shape + (1,) * (new.dim() - active.dim()))
        return torch.where(a, new, old)

    return type(new_state)(*(pick(n, o) for n, o in zip(new_state, old_state)))


def _as_ids(ids, device) -> torch.Tensor:
    return torch.as_tensor(ids, dtype=_I32, device=device)


def _as_active(active, device) -> torch.Tensor:
    return torch.as_tensor(active, dtype=torch.bool, device=device)


@dataclasses.dataclass(frozen=True)
class FlatCore:
    """Static spec for a batch of flat-state policy rows (awrp/lru/fifo/lfu).

    ``pids``/``ways`` are per-row: mixed policies and mixed capacities batch
    together (smaller rows get dead padding lanes masked out of both fill
    and eviction).  ``lanes`` pads the ways axis; ``use_kernel`` routes AWRP
    victim selection through the rows kernel."""

    pids: Tuple[int, ...]  # per-row POLICY_IDS values
    ways: Tuple[int, ...]  # per-row live lanes per set
    num_sets: int = 1
    lanes: Optional[int] = None  # padded ways axis; default max(ways)
    use_kernel: bool = False

    def __post_init__(self):
        bad = [p for p in self.pids if p not in _SIMPLE_IDS]
        if bad:
            raise ValueError(
                f"FlatCore supports {JAX_POLICIES}; got policy ids {bad} "
                f"(adaptive policies run on AdaptiveCore)"
            )
        if self.lanes is not None and self.lanes < max(self.ways):
            raise ValueError(f"lanes {self.lanes} < max ways {max(self.ways)}")

    @property
    def rows(self) -> int:
        """Number of independent policy rows (the free batch axis)."""
        return len(self.pids)

    @property
    def W(self) -> int:
        """Padded lane count of the ways axis (``lanes`` or max(ways))."""
        return self.lanes if self.lanes is not None else max(self.ways)

    @property
    def row_capacity(self) -> Tuple[int, ...]:
        """Total resident capacity per row (= ways summed over sets)."""
        return tuple(w * self.num_sets for w in self.ways)

    def _masks(self, device) -> _GridMasks:
        """The spec's per-row constants on ``device`` (built once, cached)."""
        return _cached_masks(tuple(self.pids), tuple(self.ways), self.W,
                             torch.device(device))

    def occupancy(self, state: FlatState) -> torch.Tensor:
        """(rows,) int32 resident-block count (dead padding lanes excluded)."""
        live = ~self._masks(state.blocks.device).dead  # (B, W)
        occ = state.blocks >= 0
        if self.num_sets == 1:
            return (occ & live).sum(dim=-1, dtype=_I32)
        return (occ & live[:, None, :]).sum(dim=(-2, -1), dtype=_I32)

    def init(self, *, device="cuda") -> FlatState:
        """Fresh empty ``FlatState`` for this spec on ``device`` (the CUDA
        card unless the caller asks for the CPU)."""
        dev = resolve_device(device)
        B, S, W = self.rows, self.num_sets, self.W
        shape = (B, W) if S == 1 else (B, S, W)
        return FlatState(
            blocks=torch.full(shape, -1, dtype=_I32, device=dev),
            f=torch.zeros(shape, dtype=_I32, device=dev),
            r=torch.zeros(shape, dtype=_I32, device=dev),
            clock=torch.zeros(shape[:-1], dtype=_I32, device=dev),
        )

    def on_access(
        self,
        state: FlatState,
        ids,
        *,
        active=None,
        masks: Optional[_GridMasks] = None,
    ) -> Tuple[FlatState, torch.Tensor]:
        """One access per row.  ``ids`` (rows,) int32 block ids; ``active``
        optionally masks rows to no-ops.  ``masks`` overrides the
        spec-derived per-row constants (the sweep engine builds them once).
        Returns new state tensors and the (rows,) bool hits."""
        dev = state.blocks.device
        ids = _as_ids(ids, dev)
        if masks is None:
            masks = self._masks(dev)
        if self.num_sets == 1:
            clk = state.clock + 1
            slot, is_hit, new_f, new_r = _row_step(
                state.blocks, state.f, state.r, clk, ids, masks, self.use_kernel)
            idx = slot[:, None].long()
            new_state = FlatState(
                blocks=state.blocks.scatter(-1, idx, ids[:, None]),
                f=state.f.scatter(-1, idx, new_f[:, None]),
                r=state.r.scatter(-1, idx, new_r[:, None]),
                clock=clk,
            )
        else:
            bidx = torch.arange(self.rows, device=dev)
            sid = (ids % self.num_sets).long()
            clk = state.clock[bidx, sid] + 1
            slot, is_hit, new_f, new_r = _row_step(
                state.blocks[bidx, sid], state.f[bidx, sid], state.r[bidx, sid],
                clk, ids, masks, self.use_kernel)
            sl = slot.long()
            planes = [t.clone() for t in state]
            planes[0][bidx, sid, sl] = ids
            planes[1][bidx, sid, sl] = new_f
            planes[2][bidx, sid, sl] = new_r
            planes[3][bidx, sid] = clk
            new_state = FlatState(*planes)
        if active is not None:
            active = _as_active(active, dev)
            new_state = _select_state(active, new_state, state)
            is_hit = is_hit & active
        return new_state, is_hit

    def victim(self, state: FlatState) -> torch.Tensor:
        """Advisory victim lanes — ``(rows,)`` for single-set cores,
        ``(rows, num_sets)`` otherwise: the lane each set would evict (or
        fill) if the next access — at clock N+1 — were a miss."""
        dev = state.blocks.device
        if self.num_sets == 1:
            return _flat_victim(state.f, state.r, state.clock + 1,
                                self._masks(dev), self.use_kernel)
        B, S, W = state.blocks.shape
        rep = np.repeat(np.arange(B), S)
        masks = _make_masks(np.asarray(self.pids)[rep], np.asarray(self.ways)[rep], W, dev)
        v = _flat_victim(
            state.f.reshape(B * S, W),
            state.r.reshape(B * S, W),
            (state.clock + 1).reshape(B * S),
            masks,
            self.use_kernel,
        )
        return v.reshape(B, S)


# ---------------------------------------------------------------------------
# adaptive (ARC/CAR) array-encoded policies
# ---------------------------------------------------------------------------
#
# ARC's four LRU lists + p and CAR's two clocks with reference bits + two LRU
# ghost lists + p become planes over L = 2*ways lanes:
#
#   tag    — list membership: 0 free, 1 T1, 2 T2, 3 B1, 4 B2
#   stamp  — within-list order from a per-(row, set) monotone counter; a
#            list's LRU / clock hand is its min-stamp lane, its MRU / tail
#            the max.  Every insertion, MRU-move, clock rotation and ghost
#            append grants a fresh stamp, so stamps are unique per row-set
#            and every list op is a masked min-reduction.
#   ref    — CAR's reference bits (unused by ARC rows)
#   p      — the adaptation target, float32 (the host oracles keep p in
#            float32 with the same op order, so int(p) comparisons match)
#   ctr    — the stamp counter, renormalized before it can overflow

_FREE, _TAG_T1, _TAG_T2, _TAG_B1, _TAG_B2 = 0, 1, 2, 3, 4

#: POLICY_IDS values of the flat-state policies (the engine's partition)
_SIMPLE_IDS = tuple(POLICY_IDS[p] for p in JAX_POLICIES)


class AdaptiveState(NamedTuple):
    """Array-encoded ARC/CAR state for a batch of policy instances; shapes
    ``(B, num_sets, L)`` planes and ``(B, num_sets)`` scalars, L = 2*ways
    (padded to the widest config in a mixed-capacity batch — the
    first-free-lane insertion rule keeps occupancy inside each row's own
    2*ways prefix, so no dead-lane mask is needed)."""

    blocks: torch.Tensor  # (B, S, L) int32 block ids, -1 = free lane
    tag: torch.Tensor  # (B, S, L) int32 list membership (_FREE.._TAG_B2)
    stamp: torch.Tensor  # (B, S, L) int32 within-list order
    ref: torch.Tensor  # (B, S, L) int32 CAR reference bits (0/1)
    p: torch.Tensor  # (B, S) float32 ARC/CAR adaptation target
    ctr: torch.Tensor  # (B, S) int32 stamp counter


PolicyState = Union[FlatState, AdaptiveState]


def init_adaptive_state(batch: int, num_sets: int, lanes: int, *,
                        device="cuda") -> AdaptiveState:
    """Empty ``AdaptiveState`` for ``batch x num_sets`` ARC/CAR instances of
    ``lanes`` directory lanes, on ``device`` (the CUDA card unless the caller
    asks for the CPU)."""
    dev = resolve_device(device)
    shape = (batch, num_sets, lanes)
    return AdaptiveState(
        blocks=torch.full(shape, -1, dtype=_I32, device=dev),
        tag=torch.zeros(shape, dtype=_I32, device=dev),
        stamp=torch.zeros(shape, dtype=_I32, device=dev),
        ref=torch.zeros(shape, dtype=_I32, device=dev),
        p=torch.zeros((batch, num_sets), dtype=torch.float32, device=dev),
        ctr=torch.zeros((batch, num_sets), dtype=_I32, device=dev),
    )


def _list_counts(tag: torch.Tensor) -> torch.Tensor:
    """Per-list (T1, T2, B1, B2) sizes as one stacked ``(4, R)`` int32
    reduction (a bool sum is int64 in torch: summed as int32)."""
    stack = torch.arange(_TAG_T1, _TAG_T1 + 4, dtype=_I32, device=tag.device)
    return (tag[None] == stack[:, None, None]).sum(dim=-1, dtype=_I32)


def _keyed_head(tag: torch.Tensor, stamp: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """One-hot ``(R, L)`` mask of the min-stamp lane whose tag equals the
    per-row target ``want`` (R,) — the selected list's LRU end / clock hand.
    All-False for rows whose target list is empty (or ``want`` is the -1
    no-op sentinel: no lane carries tag -1)."""
    in_list = tag == want[:, None]
    m = torch.where(in_list, stamp, INT_MAX).amin(dim=-1, keepdim=True)
    return in_list & (stamp == m)


def _ghost_p(p, cap, n_b1, n_b2, in_b1, in_b2):
    """ARC/CAR's float32 ghost-hit adaptation, in the oracles' op order:
    a B1 hit sets ``p = min(c, p + max(|B2| / max(|B1|, 1), 1))``, a B2 hit
    ``p = max(0, p - max(|B1| / max(|B2|, 1), 1))`` (list sizes cast to
    float32 first; every constant is exact in float32)."""
    capf = cap.to(torch.float32)
    b1f, b2f = n_b1.to(torch.float32), n_b2.to(torch.float32)
    p_inc = torch.minimum(capf, p + torch.clamp(b2f / torch.clamp(b1f, min=1.0), min=1.0))
    p_dec = torch.clamp(p - torch.clamp(b1f / torch.clamp(b2f, min=1.0), min=1.0), min=0.0)
    return torch.where(in_b1, p_inc, torch.where(in_b2, p_dec, p))


def _arc_step(
    blocks: torch.Tensor,  # (R, L) int32
    tag: torch.Tensor,  # (R, L) int32
    stamp: torch.Tensor,  # (R, L) int32
    p: torch.Tensor,  # (R,) float32
    ctr: torch.Tensor,  # (R,) int32
    cap: torch.Tensor,  # (R,) int32 per-row capacity c
    x: torch.Tensor,  # (R,) int32 accessed block
    iota: torch.Tensor,  # (1, L) int32
    lanes: int,
) -> Tuple[torch.Tensor, ...]:
    """One ARC access, vectorized over rows; mirrors ``policies.ARC.access``
    decision for decision (float32 p, int truncation, LRU by min stamp)."""
    xcol = x[:, None]
    present = (blocks == xcol) & (tag != _FREE)
    tag_x = torch.where(present, tag, 0).amax(dim=-1)  # 0 when absent
    n1, n2, n3, n4 = _list_counts(tag)
    hit = (tag_x == _TAG_T1) | (tag_x == _TAG_T2)
    in_b1 = tag_x == _TAG_B1
    in_b2 = tag_x == _TAG_B2
    miss_new = tag_x == 0

    # ghost-hit adaptation (the oracle updates p BEFORE _replace; B1/B2
    # still contain x here)
    p_new = _ghost_p(p, cap, n3, n4, in_b1, in_b2)

    # complete-miss directory maintenance + REPLACE trigger
    l1 = n1 + n3
    total = n1 + n2 + n3 + n4
    cm1a = miss_new & (l1 == cap) & (n1 < cap)  # pop B1 LRU, then replace
    cm1b = miss_new & (l1 == cap) & (n1 == cap)  # discard T1 LRU outright
    cm2 = miss_new & (l1 != cap)
    do_repl = in_b1 | in_b2 | cm1a | (cm2 & (total >= cap))
    pop_b2 = cm2 & (total == 2 * cap)

    # the three pop targets are mutually exclusive per row (-1 = no pop)
    pop_want = _choose(cm1a, _TAG_B1, _choose(pop_b2, _TAG_B2, _choose(cm1b, _TAG_T1, -1)))
    pop = _keyed_head(tag, stamp, pop_want)
    new_tag = torch.where(pop, _FREE, tag)
    new_blocks = torch.where(pop, -1, blocks)

    # REPLACE: demote T1's LRU to B1 iff T1 nonempty and (|T1| > int(p), or
    # x in B2 with |T1| == int(p)); else demote T2's LRU to B2.  Computed on
    # the pre-pop planes, as in the reference.
    ip = p_new.to(_I32)
    cond_t1 = (n1 >= 1) & ((in_b2 & (n1 == ip)) | (n1 > ip))
    dem_t1 = do_repl & cond_t1
    dem_t2 = do_repl & ~cond_t1 & (n2 >= 1)
    dem_want = _choose(dem_t1, _TAG_T1, _choose(dem_t2, _TAG_T2, -1))
    dem = _keyed_head(tag, stamp, dem_want)
    stamp_dem = (ctr + 1)[:, None]
    stamp_x = (ctr + 2)[:, None]
    new_tag = torch.where(dem, _choose(dem_t1, _TAG_B1, _TAG_B2)[:, None], new_tag)
    new_stamp = torch.where(dem, stamp_dem, stamp)

    # x's own transition: T1 hit and ghost hits land at T2's MRU; a T2 hit
    # restamps in place (move_to_end)
    to_t2 = (tag_x == _TAG_T1) | in_b1 | in_b2
    new_tag = torch.where(present & to_t2[:, None], _TAG_T2, new_tag)
    new_stamp = torch.where(present & (hit | in_b1 | in_b2)[:, None], stamp_x, new_stamp)

    # complete miss: insert at T1's MRU in the first free lane (post-pop)
    ins = torch.where(new_tag == _FREE, iota, lanes).amin(dim=-1)
    ins_oh = (iota == ins[:, None]) & miss_new[:, None]
    new_tag = torch.where(ins_oh, _TAG_T1, new_tag)
    new_blocks = torch.where(ins_oh, xcol, new_blocks)
    new_stamp = torch.where(ins_oh, stamp_x, new_stamp)
    return new_blocks, new_tag, new_stamp, p_new, ctr + 2, hit


#: host syncs the core has made (Python ints, running totals): one per
#: ``any()`` check of CAR's clock-hand sweep and of the stamp
#: renormalization.  The eager core's only device-to-host reads.
HOST_SYNCS = {"car_sweep": 0, "renorm": 0}


def _car_step(
    blocks: torch.Tensor,  # (R, L) int32
    tag: torch.Tensor,
    stamp: torch.Tensor,
    ref: torch.Tensor,
    p: torch.Tensor,  # (R,) float32
    ctr: torch.Tensor,  # (R,) int32
    cap: torch.Tensor,  # (R,) int32
    x: torch.Tensor,  # (R,) int32
    iota: torch.Tensor,  # (1, L)
    lanes: int,
    max_iters: int,  # bound on the clock-hand sweep: max_ways + 1
) -> Tuple[torch.Tensor, ...]:
    """One CAR access, vectorized over rows; mirrors ``policies.CAR.access``.
    The clock-hand sweep runs as a masked loop — each trip either promotes
    T1's head to T2's tail, rotates T2's head (clearing its reference bit),
    or evicts to a ghost list and retires the row — that stops as soon as no
    row is still sweeping (one ``any()`` host sync per check)."""
    xcol = x[:, None]
    present = (blocks == xcol) & (tag != _FREE)
    tag_x = torch.where(present, tag, 0).amax(dim=-1)
    hit = (tag_x == _TAG_T1) | (tag_x == _TAG_T2)
    in_b1 = tag_x == _TAG_B1
    in_b2 = tag_x == _TAG_B2
    miss_new = tag_x == 0
    resident = ((tag == _TAG_T1) | (tag == _TAG_T2)).sum(dim=-1, dtype=_I32)
    full = resident == cap

    # cache hit: set the reference bit; nothing else moves
    ref = torch.where(present & hit[:, None], 1, ref)

    # REPLACE (only when the cache is full): bounded clock-hand sweep
    live = ~hit & full
    ip = torch.clamp(p.to(_I32), min=1)  # host: max(1, int(p))
    for _ in range(max_iters):
        HOST_SYNCS["car_sweep"] += 1
        if not bool(live.any()):
            break
        n1c = (tag == _TAG_T1).sum(dim=-1, dtype=_I32)
        use_t1 = n1c >= ip  # T1 hand while |T1| >= max(1, int(p))
        want = _choose(live, _choose(use_t1, _TAG_T1, _TAG_T2), -1)
        head = _keyed_head(tag, stamp, want)
        head_ref = torch.where(head, ref, 0).amax(dim=-1)
        evict = live & (head_ref == 0)
        snew = (ctr + 1)[:, None]
        # ref==0 head: evict to the matching ghost list (restamp = MRU
        # append); ref==1 T1 head: promote to T2 tail; ref==1 T2 head:
        # rotate to tail.  All three clear the ref bit and restamp.
        tag = torch.where(
            head & (evict & use_t1)[:, None], _TAG_B1,
            torch.where(
                head & (evict & ~use_t1)[:, None], _TAG_B2,
                torch.where(head & (~evict & use_t1)[:, None], _TAG_T2, tag)))
        ref = torch.where(head, 0, ref)
        stamp = torch.where(head, snew, stamp)
        ctr = torch.where(live, ctr + 1, ctr)
        live = live & ~evict

    # post-replace list lengths (x still resident in its ghost list)
    n1p, n2p, n3p, n4p = _list_counts(tag)

    # complete-miss directory discards (host order: only when full, after
    # the sweep, before the insert; the two pops are mutually exclusive)
    dir_guard = miss_new & full
    popb1 = dir_guard & (n1p + n3p == cap + 1)
    popb2 = dir_guard & (n1p + n3p != cap + 1) & (n1p + n2p + n3p + n4p >= 2 * cap)
    pop = _keyed_head(tag, stamp, _choose(popb1, _TAG_B1, _choose(popb2, _TAG_B2, -1)))
    tag = torch.where(pop, _FREE, tag)
    blocks = torch.where(pop, -1, blocks)

    # ghost-hit adaptation (the oracle updates p AFTER _replace, from the
    # post-sweep lengths), float32
    p = _ghost_p(p, cap, n3p, n4p, in_b1, in_b2)

    stamp_x = (ctr + 1)[:, None]
    # ghost hit: re-enter at T2's tail with ref bit 0
    ghost = present & (in_b1 | in_b2)[:, None]
    tag = torch.where(ghost, _TAG_T2, tag)
    stamp = torch.where(ghost, stamp_x, stamp)
    ref = torch.where(ghost, 0, ref)
    # complete miss: insert at T1's tail in the first free lane
    ins = torch.where(tag == _FREE, iota, lanes).amin(dim=-1)
    ins_oh = (iota == ins[:, None]) & miss_new[:, None]
    tag = torch.where(ins_oh, _TAG_T1, tag)
    blocks = torch.where(ins_oh, xcol, blocks)
    stamp = torch.where(ins_oh, stamp_x, stamp)
    ref = torch.where(ins_oh, 0, ref)
    ctr = torch.where(hit, ctr, ctr + 1)
    return blocks, tag, stamp, ref, p, ctr, hit


# ---------------------------------------------------------------------------
# stamp renormalization
# ---------------------------------------------------------------------------


def _renorm_stamps(state: AdaptiveState, renorm_at: int) -> AdaptiveState:
    """Compact stamps when ``ctr`` nears the int32 range: dense-rank each
    row-set's stamp plane (rank = #lanes with a strictly smaller stamp) and
    reset ``ctr`` to L.  Occupied lanes carry unique stamps, so ranking
    preserves every within-list order and therefore every future decision;
    free lanes' stamps are never compared.  The O(L^2) rank runs only when
    some row needs it (one host sync per call to decide)."""
    need = state.ctr >= renorm_at  # (B, S) bool
    HOST_SYNCS["renorm"] += 1
    if not bool(need.any()):
        return state
    s = state.stamp  # (B, S, L)
    L = s.shape[-1]
    rank = (s[..., :, None] > s[..., None, :]).sum(dim=-1, dtype=_I32)
    return state._replace(
        stamp=torch.where(need[..., None], rank, s),
        ctr=torch.where(need, L, state.ctr),
    )


@functools.lru_cache(maxsize=64)
def _lane_iota(L: int, device: torch.device) -> torch.Tensor:
    return torch.arange(L, dtype=_I32, device=device)[None, :]


@dataclasses.dataclass(frozen=True)
class AdaptiveCore:
    """Static spec for a batch of adaptive (arc/car) policy rows.

    ``caps`` is the per-row per-set capacity c; the directory spans
    ``lanes = 2*max(caps)`` lanes (cache + ghosts).  ``renorm_at`` is the
    stamp-counter ceiling that triggers in-place stamp renormalization
    (None disables the check entirely — a static guarantee the caller makes
    when the access count is bounded, e.g. a known-length sweep trace)."""

    kind: str  # "arc" | "car"
    caps: Tuple[int, ...]  # per-row per-set capacity
    num_sets: int = 1
    lanes: Optional[int] = None  # padded directory lanes; default 2*max(caps)
    renorm_at: Optional[int] = "auto"  # type: ignore[assignment]

    def __post_init__(self):
        if self.kind not in ADAPTIVE_POLICIES:
            raise ValueError(
                f"AdaptiveCore supports {ADAPTIVE_POLICIES}, got {self.kind!r}"
            )
        if self.renorm_at == "auto":
            object.__setattr__(self, "renorm_at", self.default_renorm_at())
        if self.lanes is not None and self.lanes < 2 * max(self.caps):
            raise ValueError(f"lanes {self.lanes} < 2*max caps {2 * max(self.caps)}")

    def default_renorm_at(self) -> int:
        """Ceiling with headroom for several accesses' worth of stamp grants
        (at most ``max_ways + 2`` per access) between checks."""
        return INT_MAX - 8 * (max(self.caps) + 4)

    @property
    def rows(self) -> int:
        """Number of independent policy rows (the free batch axis)."""
        return len(self.caps)

    @property
    def L(self) -> int:
        """Lane count of the tag/stamp/ref planes: 2*max(caps) — residents
        plus ghosts."""
        return self.lanes if self.lanes is not None else 2 * max(self.caps)

    def init(self, *, device="cuda") -> AdaptiveState:
        """Fresh empty ``AdaptiveState`` for this spec on ``device`` (the
        CUDA card unless the caller asks for the CPU)."""
        return init_adaptive_state(self.rows, self.num_sets, self.L, device=device)

    def on_access(
        self,
        state: AdaptiveState,
        ids,
        *,
        active=None,
        caps: Optional[torch.Tensor] = None,
    ) -> Tuple[AdaptiveState, torch.Tensor]:
        """One ARC/CAR access per row; mirrors the host oracles decision for
        decision.  Stamps renormalize automatically when ``ctr`` nears the
        int32 range.  ``caps`` overrides the spec's per-row capacities with a
        ``(rows,)`` int32 tensor already on the state's device (the sweep
        engine builds it once).  Returns new state tensors and the (rows,)
        bool hits."""
        dev = state.blocks.device
        ids = _as_ids(ids, dev)
        if self.renorm_at is not None:
            state = _renorm_stamps(state, self.renorm_at)
        L = self.L
        iota_l = _lane_iota(L, dev)
        cap = _as_ids(self.caps if caps is None else caps, dev)
        if self.num_sets == 1:
            def get(a):
                return a[:, 0]

            def put(a, new):
                return new[:, None]
        else:
            rows = torch.arange(self.rows, device=dev)
            sid = (ids % self.num_sets).long()

            def get(a):
                return a[rows, sid]

            def put(a, new):
                out = a.clone()
                out[rows, sid] = new
                return out
        blocks, tag, stamp = get(state.blocks), get(state.tag), get(state.stamp)
        p, ctr = get(state.p), get(state.ctr)
        if self.kind == "arc":
            blocks, tag, stamp, p, ctr, hit = _arc_step(
                blocks, tag, stamp, p, ctr, cap, ids, iota_l, L)
            ref = state.ref
        else:
            blocks, tag, stamp, new_ref, p, ctr, hit = _car_step(
                blocks, tag, stamp, get(state.ref), p, ctr, cap, ids, iota_l, L,
                max(self.caps) + 1)
            ref = put(state.ref, new_ref)
        new_state = AdaptiveState(
            blocks=put(state.blocks, blocks),
            tag=put(state.tag, tag),
            stamp=put(state.stamp, stamp),
            ref=ref,
            p=put(state.p, p),
            ctr=put(state.ctr, ctr),
        )
        if active is not None:
            active = _as_active(active, dev)
            new_state = _select_state(active, new_state, state)
            hit = hit & active
        return new_state, hit

    def victim(self, state: AdaptiveState) -> torch.Tensor:
        """Advisory ``(rows, 1)`` victim lanes: the lane whose page the
        policy would move out of the cache (into its ghost list) if the next
        access were a complete miss; -1 where no eviction would occur (cache
        not yet full).  Computed by probing ``on_access`` with a never-seen
        block id and diffing residency — the probe state is discarded."""
        if self.num_sets != 1:
            raise NotImplementedError(
                "AdaptiveCore.victim probes one access; with num_sets > 1 "
                "run the probe per set via on_access instead"
            )
        probe = torch.full((self.rows,), INT_MAX, dtype=_I32, device=state.blocks.device)
        probed, _ = self.on_access(state, probe)
        ev = self.resident_mask(state) & ~self.resident_mask(probed)
        L = self.L
        iota = torch.arange(L, dtype=_I32, device=state.blocks.device)
        lane = torch.where(ev, iota, L).amin(dim=-1)
        return torch.where(lane < L, lane, -1).to(_I32)

    def resident_mask(self, state: AdaptiveState) -> torch.Tensor:
        """(rows, num_sets, L) bool — lanes whose block is cache-resident
        (T1 or T2; ghost-directory entries are NOT resident)."""
        return (state.tag == _TAG_T1) | (state.tag == _TAG_T2)

    @property
    def row_capacity(self) -> Tuple[int, ...]:
        """Total resident capacity per row (= caps summed over sets)."""
        return tuple(c * self.num_sets for c in self.caps)

    def occupancy(self, state: AdaptiveState) -> torch.Tensor:
        """(rows,) int32 resident-page count (ghost entries excluded)."""
        return self.resident_mask(state).sum(dim=(-2, -1), dtype=_I32)


PolicyCore = Union[FlatCore, AdaptiveCore]


# ---------------------------------------------------------------------------
# factories
# ---------------------------------------------------------------------------


def make_core(
    policy: str,
    rows: int = 1,
    num_sets: int = 1,
    ways: int = 1,
    *,
    use_kernel: bool = False,
    renorm_at: Optional[int] = "auto",  # type: ignore[assignment]
) -> PolicyCore:
    """Uniform-policy core factory: ``rows`` independent instances of one
    device policy, each ``num_sets`` sets of ``ways`` lanes.  Mixed-policy /
    mixed-capacity batches (the sweep engine's grid) construct ``FlatCore``
    / ``AdaptiveCore`` directly with per-row tuples."""
    if policy in JAX_POLICIES:
        return FlatCore(
            pids=(POLICY_IDS[policy],) * rows,
            ways=(int(ways),) * rows,
            num_sets=int(num_sets),
            use_kernel=use_kernel,
        )
    if policy in ADAPTIVE_POLICIES:
        return AdaptiveCore(
            kind=policy,
            caps=(int(ways),) * rows,
            num_sets=int(num_sets),
            renorm_at=renorm_at,
        )
    raise ValueError(f"not a device policy: {policy!r}; have {DEVICE_POLICIES}")


def init(
    policy: str, rows: int = 1, num_sets: int = 1, ways: int = 1,
    *, device="cuda", **kw
) -> Tuple[PolicyCore, PolicyState]:
    """Protocol entry point: build the core for ``policy`` and its initial
    state in one call — ``core, state = init(policy, rows, sets, ways)``, on
    the CUDA card unless ``device`` says otherwise."""
    core = make_core(policy, rows, num_sets, ways, **kw)
    return core, core.init(device=device)


def make_cache_policy(policy, capacity: int, **kw):
    """The serving-side factory: resolve ``policy`` — a name or an
    already-built ``ReplacementPolicy`` — into a host policy instance."""
    from repro_torch.core.policies import ReplacementPolicy, make_policy

    if isinstance(policy, ReplacementPolicy):
        if policy.capacity != int(capacity):
            raise ValueError(
                f"prebuilt policy has capacity {policy.capacity} but the "
                f"cache requested {capacity}"
            )
        return policy
    return make_policy(policy, capacity, **kw)
