"""Trace-driven cache simulator, the paper's §4 experimental harness
(``repro/core/simulator.py``).

Supports fully-associative (num_sets=1) and set-associative mapping
(num_sets>1: block -> set by modulo; each set runs an independent policy
instance with capacity/num_sets slots, the paper's 'set associative'
configuration).

Two execution paths:
  * host path: any policy from ``core/policies.py`` (numpy / pure python);
    this is the ORACLE every device path is validated against;
  * device path: the batched sweep engine in ``core/torch_policies.py`` —
    the whole (policy, capacity) grid of a ``sweep()`` call runs as one
    batch of policy rows on ``torch_device`` (the CUDA card by default), its
    AWRP victims found by the hand-written rows kernel, bit-identical to the
    oracle decisions.

``sweep(device="auto")`` (the default) partitions the requested policies:
every device-capable policy (``DEVICE_POLICIES`` — awrp/lru/fifo/lfu plus
the array-encoded arc/car) goes through the batched engine in a single
batch; the rest (2Q/OPT/RANDOM/...) run on the host loop.  ``device=False``
forces the host path for everything; ``device=True`` requires every policy
to be device-capable.  ``torch_device`` is resolved only when some policy
goes to the engine, so an all-host sweep never needs a card.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Sequence

import numpy as np

from repro_torch.obs.metrics import safe_ratio

from .policies import OPT, ReplacementPolicy, make_policy

__all__ = ["SimResult", "simulate", "sweep", "hit_ratio_table"]


@dataclasses.dataclass
class SimResult:
    """One (policy, capacity, trace) replay outcome: counts."""
    policy: str
    capacity: int
    num_sets: int
    accesses: int
    hits: int

    @property
    def hit_ratio(self) -> float:
        """hits / accesses (0.0 on an empty trace — the shared
        ``obs.metrics.safe_ratio`` guard)."""
        return safe_ratio(self.hits, self.accesses)

    @property
    def miss_ratio(self) -> float:
        """1 - hit_ratio."""
        return 1.0 - self.hit_ratio


def simulate(
    policy: str,
    trace: Sequence[int],
    capacity: int,
    *,
    num_sets: int = 1,
    block_size: int = 1,
    **policy_kw,
) -> SimResult:
    """Run ``trace`` (addresses) through a cache of ``capacity`` blocks on
    the host oracle."""
    trace = np.asarray(trace, dtype=np.int64)
    if block_size > 1:
        trace = trace // block_size
    if capacity % num_sets:
        raise ValueError(f"capacity {capacity} not divisible by num_sets {num_sets}")
    per_set = capacity // num_sets

    sets: Dict[int, ReplacementPolicy] = {}
    if num_sets == 1:
        sets[0] = make_policy(policy, per_set, **policy_kw)
        if isinstance(sets[0], OPT):
            sets[0].prepare(trace)
        set_ids = np.zeros(len(trace), dtype=np.int64)
    else:
        set_ids = trace % num_sets
        for s in range(num_sets):
            sets[s] = make_policy(policy, per_set, **policy_kw)
            if isinstance(sets[s], OPT):
                sets[s].prepare(trace[set_ids == s])

    hits = 0
    for block, sid in zip(trace.tolist(), set_ids.tolist()):
        hits += sets[sid].access(block)
    return SimResult(policy, capacity, num_sets, len(trace), hits)


def sweep(
    policies: Iterable[str],
    trace: Sequence[int],
    capacities: Iterable[int],
    *,
    num_sets: int = 1,
    block_size: int = 1,
    device: bool | str = "auto",
    use_kernel: bool | None = None,
    torch_device="cuda",
) -> Dict[str, Dict[int, float]]:
    """hit-ratio[policy][capacity] — the shape of the paper's Table 1.

    ``device="auto"`` runs every device-capable policy's whole capacity row
    in one batched engine call on ``torch_device``; hit ratios are
    bit-identical to the host path either way.  ``use_kernel`` is the
    engine's (default: its trace kernels on a CUDA device)."""
    policies = list(policies)
    caps = [int(c) for c in capacities]
    if device == "auto":
        from .policy_core import DEVICE_POLICIES

        dev_pols = [p for p in policies if p in DEVICE_POLICIES]
    elif device:
        from .policy_core import DEVICE_POLICIES

        bad = [p for p in policies if p not in DEVICE_POLICIES]
        if bad:
            raise ValueError(
                f"device=True but {bad} have no device implementation; "
                f"have {DEVICE_POLICIES}"
            )
        dev_pols = policies
    else:
        dev_pols = []
    host_pols = [p for p in policies if p not in dev_pols]

    out: Dict[str, Dict[int, float]] = {p: {} for p in policies}
    if dev_pols:
        from repro_torch.device import resolve_device

        dev = resolve_device(torch_device)
    if dev_pols and len(trace):
        from repro_torch.obs.profiling import PHASES

        from .torch_policies import simulate_trace_batched

        tr = np.asarray(trace, dtype=np.int64)
        if block_size > 1:
            tr = tr // block_size
        # the span holds the pull of the hit counts: it is the device
        # route's end-to-end time
        with PHASES.span("sweep"):
            hits = simulate_trace_batched(
                tr, dev_pols, caps, num_sets=num_sets, use_kernel=use_kernel, device=dev
            )
            counts = hits[0].sum(dim=-1).cpu().numpy()  # (P, C) exact int hit counts
        for pi, p in enumerate(dev_pols):
            for ci, c in enumerate(caps):
                out[p][c] = int(counts[pi, ci]) / len(tr)
    elif dev_pols:  # empty trace: mirror SimResult's 0-access convention
        for p in dev_pols:
            out[p] = {c: 0.0 for c in caps}
    for p in host_pols:
        for c in caps:
            out[p][c] = simulate(
                p, trace, c, num_sets=num_sets, block_size=block_size
            ).hit_ratio
    return out


def hit_ratio_table(
    results: Dict[str, Dict[int, float]], capacities: Iterable[int]
) -> str:
    """Render a sweep as a Table-1-style text table (percent hit ratios)."""
    caps = list(capacities)
    names = list(results)
    lines = ["FRAME SIZE | " + " | ".join(f"{n.upper():>6}" for n in names)]
    lines.append("-" * len(lines[0]))
    for c in caps:
        row = " | ".join(f"{100 * results[n][c]:6.2f}" for n in names)
        lines.append(f"{c:>10} | {row}")
    return "\n".join(lines)
