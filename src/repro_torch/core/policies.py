"""Host-side (numpy / pure-python) cache replacement policies: the oracles.

A copy of ``repro/core/policies.py`` (the port never imports the
reference).  The tensor policy core in ``policy_core.py`` (which the sweep
engine in ``torch_policies.py``, the paged-KV pool and the serving caches
drive) and the CUDA kernels in ``repro_torch.kernels`` are validated against
the decisions made here.

Every policy implements the same tiny protocol::

    policy = AWRP(capacity)
    hit: bool = policy.access(block_id)

``block_id`` is an opaque integer (a cache block / page / KV-page / expert id).

Paper semantics (AWRP, Swain et al. 2011):
  * global access clock ``N`` = number of accesses so far (1-indexed);
  * on HIT on block i:  ``F_i += 1``; ``R_i = N``  (weights NOT recomputed);
  * on MISS with a full buffer: recompute ``W_i = F_i / (N - R_i)`` for every
    resident (``N - R_i >= 1`` always holds for residents at miss time),
    evict ``argmin W_i``; insert the new block with ``F = 1, R = N``.

Ambiguity resolved (documented in DESIGN.md §6): the paper defines N as "the
total number of access to be made" but uses it as a running clock ("for every
N != R_i" at miss time). We take N = the running clock, the same convention as
WRP [Samiee 2009] which AWRP extends.

Tie-breaking (unspecified in the paper): lowest weight, then lowest slot
index (= first-occurrence argmin). The tensor core and the CUDA kernels reproduce this
ordering bit-exactly, which the property tests rely on.
"""

from __future__ import annotations

import random
from collections import OrderedDict, deque
from typing import Dict, List

import numpy as np

__all__ = [
    "ReplacementPolicy",
    "AWRP",
    "WRP",
    "LRU",
    "FIFO",
    "LFU",
    "RANDOM",
    "ARC",
    "CAR",
    "TwoQ",
    "OPT",
    "POLICIES",
    "make_policy",
]


class ReplacementPolicy:
    """Base class. Subclasses implement ``access``."""

    name = "base"

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = int(capacity)
        self.hits = 0
        self.accesses = 0

    # -- protocol ---------------------------------------------------------
    def access(self, block: int) -> bool:
        """Touch ``block``; True on hit.  Subclasses implement the policy
        (mutates residency/metadata and the hit/access counters)."""
        raise NotImplementedError

    # -- stats ------------------------------------------------------------
    @property
    def hit_ratio(self) -> float:
        """hits / accesses (0.0 before any access)."""
        return self.hits / self.accesses if self.accesses else 0.0

    def _count(self, hit: bool) -> bool:
        self.accesses += 1
        self.hits += int(hit)
        return hit

    # -- introspection (used by tests) -------------------------------------
    def resident_set(self) -> set:
        """Set of resident block ids (test/introspection hook; read-only)."""
        raise NotImplementedError


# ---------------------------------------------------------------------------
# AWRP — the paper's policy (slot-array formulation, mirrors the tensor core)
# ---------------------------------------------------------------------------


class AWRP(ReplacementPolicy):
    """Adaptive Weight Ranking Policy (Swain, Paikaray & Swain, 2011).

    Slot-array formulation: ``blocks[s] == -1`` marks an empty slot. This is
    deliberately identical in layout to the tensor core and kernels so decisions
    can be compared slot-by-slot.
    """

    name = "awrp"
    #: if True, weights are (re)computed on every access — this is WRP
    #: [Samiee 2009] semantics; AWRP's contribution is lazy evaluation at miss
    #: time only.  Decisions are identical; the overhead differs (benchmarked).
    eager_weights = False

    def __init__(self, capacity: int, alpha: float = 1.0, beta: float = 1.0):
        """alpha/beta generalize eq. (1) to W = F^alpha / (N-R)^beta — the
        paper's §5 future-work direction ("additional parameters and
        factors"); (1, 1) is the paper's exact policy. Benchmarked in
        benchmarks/awrp_ablation.py."""
        super().__init__(capacity)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.blocks = np.full(capacity, -1, dtype=np.int64)
        self.F = np.zeros(capacity, dtype=np.int64)
        self.R = np.zeros(capacity, dtype=np.int64)
        self.W = np.zeros(capacity, dtype=np.float64)  # advisory, lazily updated
        self.clock = 0
        self._index: Dict[int, int] = {}  # block -> slot (host-side accel only)

    def _recompute_weights(self) -> np.ndarray:
        occ = self.blocks >= 0
        dt = np.maximum(self.clock - self.R, 1)
        w = np.where(occ, self.F / dt, np.inf)
        self.W = np.where(occ, w, 0.0)
        return w

    def victim_slot(self) -> int:
        """Paper's miss rule: argmin W over residents; ties (equal rational
        weights) break to the lowest slot index.  Weights are computed in
        float32 with the exact same IEEE ops as the tensor core and kernels so
        host and device decisions are bit-identical (property-tested)."""
        self._recompute_weights()
        occ = self.blocks >= 0
        dt = np.maximum(self.clock - self.R, 1).astype(np.float32)
        if self.alpha == 1.0 and self.beta == 1.0:
            w = self.F.astype(np.float32) / dt  # paper eq. (1), bit-exact
        else:
            w = (self.F.astype(np.float32) ** np.float32(self.alpha)
                 / dt ** np.float32(self.beta))
        w = np.where(occ, w, np.float32(np.inf))
        return int(np.argmin(w))

    def access(self, block: int) -> bool:
        """Paper §3 rule: a hit bumps F and refreshes R; a miss inserts
        into a free slot or the lazy argmin-W victim (eq. (1))."""
        self.clock += 1
        slot = self._index.get(block)
        if slot is not None:  # HIT
            self.F[slot] += 1
            self.R[slot] = self.clock
            if self.eager_weights:
                self._recompute_weights()
            return self._count(True)
        # MISS
        empty = np.flatnonzero(self.blocks < 0)
        if empty.size:
            slot = int(empty[0])
        else:
            slot = self.victim_slot()
            del self._index[int(self.blocks[slot])]
        self.blocks[slot] = block
        self.F[slot] = 1
        self.R[slot] = self.clock
        self.W[slot] = 0.0  # paper: "W_k will be set to 0" on insert
        self._index[block] = slot
        if self.eager_weights:
            self._recompute_weights()
        return self._count(False)

    def resident_set(self) -> set:
        """Resident block ids (occupied slots)."""
        return set(int(b) for b in self.blocks if b >= 0)


class WRP(AWRP):
    """WRP [Samiee 2009] — the non-adaptive predecessor (ref [1] of the
    paper): identical weight function but eagerly maintained on every access.
    Same decisions as AWRP; kept to benchmark AWRP's lazy-update overhead win.
    """

    name = "wrp"
    eager_weights = True


# ---------------------------------------------------------------------------
# Classic baselines
# ---------------------------------------------------------------------------


class LRU(ReplacementPolicy):
    """Least-recently-used: hit refreshes recency, miss evicts the LRU."""
    name = "lru"

    def __init__(self, capacity: int):
        super().__init__(capacity)
        self.od: "OrderedDict[int, None]" = OrderedDict()

    def access(self, block: int) -> bool:
        """Hit moves ``block`` to MRU; miss evicts the LRU entry when full."""
        if block in self.od:
            self.od.move_to_end(block)
            return self._count(True)
        if len(self.od) >= self.capacity:
            self.od.popitem(last=False)
        self.od[block] = None
        return self._count(False)

    def resident_set(self) -> set:
        """Resident block ids."""
        return set(self.od)


class FIFO(ReplacementPolicy):
    """First-in-first-out: eviction in insertion order, hits never reorder."""
    name = "fifo"

    def __init__(self, capacity: int):
        super().__init__(capacity)
        self.q: deque = deque()
        self.s: set = set()

    def access(self, block: int) -> bool:
        """Hit leaves the queue untouched; miss evicts the oldest insert."""
        if block in self.s:
            return self._count(True)
        if len(self.q) >= self.capacity:
            self.s.discard(self.q.popleft())
        self.q.append(block)
        self.s.add(block)
        return self._count(False)

    def resident_set(self) -> set:
        """Resident block ids."""
        return set(self.s)


class LFU(ReplacementPolicy):
    """LFU with LRU tie-break (ties: least recent, then insertion order)."""

    name = "lfu"

    def __init__(self, capacity: int):
        super().__init__(capacity)
        self.freq: Dict[int, int] = {}
        self.last: Dict[int, int] = {}
        self.clock = 0

    def access(self, block: int) -> bool:
        """Hit bumps the frequency; miss evicts min (freq, recency) when full."""
        self.clock += 1
        if block in self.freq:
            self.freq[block] += 1
            self.last[block] = self.clock
            return self._count(True)
        if len(self.freq) >= self.capacity:
            victim = min(self.freq, key=lambda b: (self.freq[b], self.last[b]))
            del self.freq[victim]
            del self.last[victim]
        self.freq[block] = 1
        self.last[block] = self.clock
        return self._count(False)

    def resident_set(self) -> set:
        """Resident block ids."""
        return set(self.freq)


class RANDOM(ReplacementPolicy):
    """Uniform-random eviction (seeded) — the no-information baseline."""
    name = "random"

    def __init__(self, capacity: int, seed: int = 0):
        super().__init__(capacity)
        self.rng = random.Random(seed)
        self.items: List[int] = []
        self.s: set = set()

    def access(self, block: int) -> bool:
        """Hit is a no-op; miss overwrites a uniformly chosen resident when full."""
        if block in self.s:
            return self._count(True)
        if len(self.items) >= self.capacity:
            idx = self.rng.randrange(len(self.items))
            self.s.discard(self.items[idx])
            self.items[idx] = block
        else:
            self.items.append(block)
        self.s.add(block)
        return self._count(False)

    def resident_set(self) -> set:
        """Resident block ids."""
        return set(self.s)


# ---------------------------------------------------------------------------
# ARC — Megiddo & Modha, FAST'03
# ---------------------------------------------------------------------------


class ARC(ReplacementPolicy):
    """Adaptation parameter ``p`` is maintained in float32 with the exact op
    order of the device engine (``policy_core._arc_step``) so the
    ``int(p)`` comparisons — and therefore every decision — match the
    batched device implementation bit-for-bit (property-tested)."""

    name = "arc"

    def __init__(self, capacity: int):
        super().__init__(capacity)
        self.p = np.float32(0.0)
        # MRU at the right end of each OrderedDict
        self.T1: "OrderedDict[int, None]" = OrderedDict()
        self.T2: "OrderedDict[int, None]" = OrderedDict()
        self.B1: "OrderedDict[int, None]" = OrderedDict()
        self.B2: "OrderedDict[int, None]" = OrderedDict()

    def _replace(self, block: int) -> None:
        if self.T1 and (
            (block in self.B2 and len(self.T1) == int(self.p))
            or len(self.T1) > int(self.p)
        ):
            lru, _ = self.T1.popitem(last=False)
            self.B1[lru] = None
        else:
            lru, _ = self.T2.popitem(last=False)
            self.B2[lru] = None

    def access(self, block: int) -> bool:
        """ARC's four cases (T1/T2 hit, B1/B2 ghost hit, cold miss) with the
        float32 ``p`` adaptation — op order matches the device engine."""
        c = self.capacity
        if block in self.T1:
            del self.T1[block]
            self.T2[block] = None
            return self._count(True)
        if block in self.T2:
            self.T2.move_to_end(block)
            return self._count(True)
        f32 = np.float32
        if block in self.B1:
            delta = max(f32(len(self.B2)) / f32(max(len(self.B1), 1)), f32(1.0))
            self.p = min(f32(c), f32(self.p + delta))
            self._replace(block)
            del self.B1[block]
            self.T2[block] = None
            return self._count(False)
        if block in self.B2:
            delta = max(f32(len(self.B1)) / f32(max(len(self.B2), 1)), f32(1.0))
            self.p = max(f32(0.0), f32(self.p - delta))
            self._replace(block)
            del self.B2[block]
            self.T2[block] = None
            return self._count(False)
        # complete miss
        if len(self.T1) + len(self.B1) == c:
            if len(self.T1) < c:
                self.B1.popitem(last=False)
                self._replace(block)
            else:
                self.T1.popitem(last=False)
        else:
            total = len(self.T1) + len(self.T2) + len(self.B1) + len(self.B2)
            if total >= c:
                if total == 2 * c:
                    self.B2.popitem(last=False)
                self._replace(block)
        self.T1[block] = None
        return self._count(False)

    def resident_set(self) -> set:
        """Resident block ids: T1 ∪ T2 (ghosts B1/B2 excluded)."""
        return set(self.T1) | set(self.T2)


# ---------------------------------------------------------------------------
# CAR — Bansal & Modha, FAST'04 (clocks T1/T2 + LRU ghost lists B1/B2)
# ---------------------------------------------------------------------------


class _Clock:
    """Circular buffer with reference bits; `hand` points at the next
    candidate.  deque-based: head of deque == clock hand."""

    def __init__(self):
        self.q: deque = deque()  # items in hand order
        self.ref: Dict[int, bool] = {}

    def __len__(self):
        return len(self.q)

    def __contains__(self, b):
        return b in self.ref

    def insert_tail(self, b):  # behind the hand
        self.q.append(b)
        self.ref[b] = False

    def head(self):
        return self.q[0]

    def pop_head(self):
        b = self.q.popleft()
        del self.ref[b]
        return b

    def rotate_head_to_tail(self):
        self.q.rotate(-1)


class CAR(ReplacementPolicy):
    """``p`` kept in float32 with the device engine's exact op order
    (``policy_core._car_step``) — see the ARC docstring."""

    name = "car"

    def __init__(self, capacity: int):
        super().__init__(capacity)
        self.p = np.float32(0.0)
        self.T1 = _Clock()
        self.T2 = _Clock()
        self.B1: "OrderedDict[int, None]" = OrderedDict()
        self.B2: "OrderedDict[int, None]" = OrderedDict()

    def _replace(self) -> None:
        while True:
            if len(self.T1) >= max(1, int(self.p)):
                b = self.T1.head()
                if not self.T1.ref[b]:
                    self.T1.pop_head()
                    self.B1[b] = None
                    return
                # referenced in T1 -> promote to T2 tail with ref bit 0
                self.T1.pop_head()
                self.T2.insert_tail(b)
            else:
                b = self.T2.head()
                if not self.T2.ref[b]:
                    self.T2.pop_head()
                    self.B2[b] = None
                    return
                self.T2.ref[b] = False
                self.T2.rotate_head_to_tail()

    def access(self, block: int) -> bool:
        """CAR's clock variant of the ARC cases; ref bits instead of strict LRU,
        same float32 ``p`` discipline as the device engine."""
        c = self.capacity
        if block in self.T1:
            self.T1.ref[block] = True
            return self._count(True)
        if block in self.T2:
            self.T2.ref[block] = True
            return self._count(True)
        # cache miss
        in_b1 = block in self.B1
        in_b2 = block in self.B2
        if len(self.T1) + len(self.T2) == c:
            self._replace()
            if not in_b1 and not in_b2:
                if len(self.T1) + len(self.B1) == c + 1:
                    self.B1.popitem(last=False)
                elif (
                    len(self.T1) + len(self.T2) + len(self.B1) + len(self.B2)
                    >= 2 * c
                ):
                    self.B2.popitem(last=False)
        f32 = np.float32
        if not in_b1 and not in_b2:
            self.T1.insert_tail(block)
        elif in_b1:
            delta = max(f32(1.0), f32(len(self.B2)) / f32(max(len(self.B1), 1)))
            self.p = min(f32(c), f32(self.p + delta))
            del self.B1[block]
            self.T2.insert_tail(block)
        else:
            delta = max(f32(1.0), f32(len(self.B1)) / f32(max(len(self.B2), 1)))
            self.p = max(f32(0.0), f32(self.p - delta))
            del self.B2[block]
            self.T2.insert_tail(block)
        return self._count(False)

    def resident_set(self) -> set:
        """Resident block ids: T1 ∪ T2 clocks (ghosts excluded)."""
        return set(self.T1.ref) | set(self.T2.ref)


# ---------------------------------------------------------------------------
# 2Q — Johnson & Shasha, VLDB'94 (full version)
# ---------------------------------------------------------------------------


class TwoQ(ReplacementPolicy):
    """2Q [Johnson & Shasha, VLDB'94]: A1in FIFO probation, A1out ghost
    queue, Am LRU for proven-hot pages."""
    name = "2q"

    def __init__(self, capacity: int):
        super().__init__(capacity)
        self.kin = max(1, capacity // 4)
        self.kout = max(1, capacity // 2)
        self.a1in: deque = deque()  # FIFO of resident once-accessed
        self.a1in_set: set = set()
        self.a1out: "OrderedDict[int, None]" = OrderedDict()  # ghost FIFO
        self.am: "OrderedDict[int, None]" = OrderedDict()  # LRU of hot pages

    def _reclaim(self) -> None:
        if len(self.a1in) + len(self.am) < self.capacity:
            return
        if len(self.a1in) > self.kin or not self.am:
            victim = self.a1in.popleft()
            self.a1in_set.discard(victim)
            self.a1out[victim] = None
            if len(self.a1out) > self.kout:
                self.a1out.popitem(last=False)
        else:
            self.am.popitem(last=False)

    def access(self, block: int) -> bool:
        """2Q rule: Am hit refreshes LRU, A1in hit stays put, A1out ghost hit
        promotes to Am, cold miss enters A1in probation."""
        if block in self.am:
            self.am.move_to_end(block)
            return self._count(True)
        if block in self.a1in_set:
            return self._count(True)  # stays in A1in (2Q rule)
        if block in self.a1out:
            del self.a1out[block]  # before reclaim: reclaim may pop A1out's head
            self._reclaim()
            self.am[block] = None
            return self._count(False)
        self._reclaim()
        self.a1in.append(block)
        self.a1in_set.add(block)
        return self._count(False)

    def resident_set(self) -> set:
        """Resident block ids: A1in ∪ Am (A1out is a ghost list)."""
        return self.a1in_set | set(self.am)


# ---------------------------------------------------------------------------
# OPT — Belady's clairvoyant policy (upper bound; needs the future)
# ---------------------------------------------------------------------------


class OPT(ReplacementPolicy):
    """Belady's MIN. Call ``prepare(trace)`` before the access stream; the
    simulator does this automatically."""

    name = "opt"
    needs_future = True

    def __init__(self, capacity: int):
        super().__init__(capacity)
        self.next_use: Dict[int, deque] = {}
        self.t = 0
        self.resident: set = set()

    def prepare(self, trace) -> None:
        """Index the full future trace (next-use positions) — must be called
        before replaying the same trace through ``access``."""
        self.next_use = {}
        for i, b in enumerate(trace):
            self.next_use.setdefault(int(b), deque()).append(i)

    def access(self, block: int) -> bool:
        """Belady's rule: on a full miss, evict the resident whose next use is
        farthest in the future (requires ``prepare``)."""
        block = int(block)
        q = self.next_use.get(block)
        if q and q and q[0] == self.t:
            q.popleft()
        self.t += 1
        if block in self.resident:
            return self._count(True)
        if len(self.resident) >= self.capacity:
            # evict resident with farthest (or no) next use
            far, victim = -1, None
            for b in self.resident:
                nq = self.next_use.get(b)
                nxt = nq[0] if nq else None
                if nxt is None:
                    victim = b
                    break
                if nxt > far:
                    far, victim = nxt, b
            self.resident.discard(victim)
        self.resident.add(block)
        return self._count(False)

    def resident_set(self) -> set:
        """Resident block ids."""
        return set(self.resident)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

POLICIES = {
    cls.name: cls
    for cls in [AWRP, WRP, LRU, FIFO, LFU, RANDOM, ARC, CAR, TwoQ, OPT]
}


def make_policy(name: str, capacity: int, **kw) -> ReplacementPolicy:
    """Factory: policy ``name`` → fresh instance at ``capacity`` (extra
    kwargs forwarded, e.g. AWRP's alpha/beta).  Raises ValueError on
    unknown names."""
    try:
        return POLICIES[name](capacity, **kw)
    except KeyError:
        raise ValueError(f"unknown policy {name!r}; have {sorted(POLICIES)}")


# ---------------------------------------------------------------------------
# A-AWRP — adaptive alpha/beta (beyond paper; motivated by the ablation in
# benchmarks/awrp_ablation.py: frequency-leaning weights win on zipf-like
# traces, recency-leaning on loop traces, eq. (1) is the best fixed point)
# ---------------------------------------------------------------------------


class AAWRP(AWRP):
    """AWRP with ARC-style self-tuning of the weight exponents.

    A ladder of (alpha, beta) settings spans recency-leaning to
    frequency-leaning weightings.  At each eviction we also compute what the
    two EXTREME leanings would have evicted; if an extreme would have KEPT
    the block we evicted, the block goes into that extreme's ghost list.  A
    later miss that hits a ghost list is attributable evidence ("that lean
    was right about this block") and steps the ladder one rung toward it —
    ARC's p-adaptation signal, applied to the paper's eq. (1) exponents."""

    name = "aawrp"
    LADDER = [(0.5, 2.0), (1.0, 1.0), (2.0, 0.5)]  # recency ... frequency

    def __init__(self, capacity: int):
        super().__init__(capacity)
        self.rung = 1  # start at the paper's (1, 1)
        self.alpha, self.beta = self.LADDER[self.rung]
        self.ghost_r: "OrderedDict[int, None]" = OrderedDict()  # recency-lean
        self.ghost_f: "OrderedDict[int, None]" = OrderedDict()  # frequency-lean
        self.ghost_cap = capacity

    def _set_rung(self, rung: int) -> None:
        self.rung = max(0, min(len(self.LADDER) - 1, rung))
        self.alpha, self.beta = self.LADDER[self.rung]

    @staticmethod
    def _victim_on(F, R, blocks, clock, alpha: float, beta: float) -> int:
        occ = blocks >= 0
        dt = np.maximum(clock - R, 1).astype(np.float32)
        w = (F.astype(np.float32) ** np.float32(alpha)
             / dt ** np.float32(beta))
        return int(np.argmin(np.where(occ, w, np.float32(np.inf))))

    def access(self, block: int) -> bool:
        """AWRP access plus ghost-directed (alpha, beta) ladder moves: a ghost
        hit on the frequency (recency) side steps the exponents toward the
        lean that would have kept the block."""
        if block not in self._index:
            if block in self.ghost_f:
                del self.ghost_f[block]
                self._set_rung(self.rung + 1)  # frequency lean was right
            elif block in self.ghost_r:
                del self.ghost_r[block]
                self._set_rung(self.rung - 1)  # recency lean was right
        will_evict = block not in self._index and not (self.blocks < 0).any()
        if will_evict:  # snapshot pre-eviction metadata for attribution
            snap = (self.F.copy(), self.R.copy(), self.blocks.copy(),
                    self.clock + 1)  # the clock value the eviction will use
        hit = super().access(block)
        if will_evict:
            F, R, blocks, clk = snap
            slot = int(np.flatnonzero(blocks != self.blocks)[0])
            evicted = int(blocks[slot])
            if self._victim_on(F, R, blocks, clk, *self.LADDER[-1]) != slot:
                self.ghost_f[evicted] = None  # frequency lean kept it
                if len(self.ghost_f) > self.ghost_cap:
                    self.ghost_f.popitem(last=False)
            if self._victim_on(F, R, blocks, clk, *self.LADDER[0]) != slot:
                self.ghost_r[evicted] = None  # recency lean kept it
                if len(self.ghost_r) > self.ghost_cap:
                    self.ghost_r.popitem(last=False)
        return hit


POLICIES["aawrp"] = AAWRP
