"""Host-side (numpy / pure-python) replacement policies — the oracles.

A copy of the part of ``repro/core/policies.py`` the serving slice uses: the
``ReplacementPolicy`` protocol and the paper's AWRP.  The other host
policies (WRP, LRU, FIFO, LFU, RANDOM, ARC, CAR, 2Q, OPT, A-AWRP) come with
the Table-1 sweep slice; ``make_policy`` says so for their names.

Paper semantics (AWRP, Swain et al. 2011):
  * global access clock ``N`` = number of accesses so far (1-indexed);
  * on HIT on block i:  ``F_i += 1``; ``R_i = N``  (weights NOT recomputed);
  * on MISS with a full buffer: recompute ``W_i = F_i / (N - R_i)`` for every
    resident, evict ``argmin W_i`` (first slot on ties); insert the new block
    with ``F = 1, R = N``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["ReplacementPolicy", "AWRP", "POLICIES", "NOT_YET_PORTED", "make_policy"]


class ReplacementPolicy:
    """Base class. Subclasses implement ``access``."""

    name = "base"

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = int(capacity)
        self.hits = 0
        self.accesses = 0

    def access(self, block: int) -> bool:
        """Touch ``block``; True on hit."""
        raise NotImplementedError

    @property
    def hit_ratio(self) -> float:
        """hits / accesses (0.0 before any access)."""
        return self.hits / self.accesses if self.accesses else 0.0

    def _count(self, hit: bool) -> bool:
        self.accesses += 1
        self.hits += int(hit)
        return hit

    def resident_set(self) -> set:
        """Set of resident block ids."""
        raise NotImplementedError


class AWRP(ReplacementPolicy):
    """Adaptive Weight Ranking Policy (Swain, Paikaray & Swain, 2011).

    Slot-array formulation: ``blocks[s] == -1`` marks an empty slot, the same
    layout as the tensor decision core, so decisions compare slot by slot."""

    name = "awrp"

    def __init__(self, capacity: int):
        super().__init__(capacity)
        self.blocks = np.full(capacity, -1, dtype=np.int64)
        self.F = np.zeros(capacity, dtype=np.int64)
        self.R = np.zeros(capacity, dtype=np.int64)
        self.clock = 0
        self._index: Dict[int, int] = {}  # block -> slot

    def victim_slot(self) -> int:
        """Paper's miss rule: argmin W over residents, ties to the lowest
        slot.  float32 with the same IEEE ops as the tensor core, so host and
        device decisions are bit-identical."""
        occ = self.blocks >= 0
        dt = np.maximum(self.clock - self.R, 1).astype(np.float32)
        w = self.F.astype(np.float32) / dt  # paper eq. (1)
        w = np.where(occ, w, np.float32(np.inf))
        return int(np.argmin(w))

    def access(self, block: int) -> bool:
        """A hit bumps F and refreshes R; a miss inserts into the first free
        slot or the lazy argmin-W victim (eq. (1))."""
        self.clock += 1
        slot = self._index.get(block)
        if slot is not None:  # HIT
            self.F[slot] += 1
            self.R[slot] = self.clock
            return self._count(True)
        empty = np.flatnonzero(self.blocks < 0)
        if empty.size:
            slot = int(empty[0])
        else:
            slot = self.victim_slot()
            del self._index[int(self.blocks[slot])]
        self.blocks[slot] = block
        self.F[slot] = 1
        self.R[slot] = self.clock
        self._index[block] = slot
        return self._count(False)

    def resident_set(self) -> set:
        """Resident block ids (occupied slots)."""
        return set(int(b) for b in self.blocks if b >= 0)


POLICIES = {AWRP.name: AWRP}

#: host policies of the reference that later slices port
NOT_YET_PORTED = ("wrp", "lru", "fifo", "lfu", "random", "arc", "car", "2q",
                  "opt", "aawrp")


def make_policy(name: str, capacity: int, **kw) -> ReplacementPolicy:
    """Factory: policy ``name`` -> fresh instance at ``capacity``."""
    if name in POLICIES:
        return POLICIES[name](capacity, **kw)
    if name in NOT_YET_PORTED:
        raise ValueError(
            f"host policy {name!r} is not ported to repro_torch yet; "
            f"have {sorted(POLICIES)}")
    raise ValueError(f"unknown policy {name!r}; have {sorted(POLICIES)}")
