"""Offline OPT (Belady) oracle over drained decision traces
(``repro/obs/opt_oracle.py``).

The live policy is judged against the offline optimum on the same access
stream: drain the decision-trace ring (``obs/decision_trace.py``), replay
each row's recorded key stream through the port's
``core.simulator.simulate("opt", ...)`` at that row's capacity, and report
``regret = opt hit ratio - observed hit ratio`` per row (tenant) with an
access-weighted aggregate.  The observed ratio comes from the trace's own hit
bits, so oracle and observation cover the same window: the ring's most
recent events, not all time (size the ring to the window to judge).
``ServeEngine.opt_regret()`` publishes the numbers as sticky registry gauges
(``tenant/<t>/opt_regret``, ``policy/<name>/opt_regret``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from repro_torch.obs.decision_trace import KIND_ACCESS
from repro_torch.obs.metrics import safe_ratio

__all__ = ["opt_hit_ratio", "regret_from_records"]


def opt_hit_ratio(keys, capacity: int) -> float:
    """Belady-optimal hit ratio of the ``keys`` stream at ``capacity`` (0.0
    on an empty stream), from the host OPT oracle."""
    keys = np.asarray(keys, dtype=np.int64)
    if keys.size == 0:
        return 0.0
    from repro_torch.core.simulator import simulate  # late: keeps imports acyclic

    return simulate("opt", keys, int(capacity)).hit_ratio


def regret_from_records(
    records: np.ndarray,
    capacities: Dict[int, int],
) -> Tuple[Dict[int, Dict[str, float]], Dict[str, float]]:
    """Per-row OPT regret from a drained decision trace.

    ``records`` is ``decision_trace.drain``'s record array (access events
    are those with ``kind == KIND_ACCESS``; admission events are ignored);
    ``capacities`` maps every row to judge to its capacity (a row with no
    events reports zeros).  Returns ``(per_row, aggregate)``: per row its
    ``accesses`` / ``observed`` / ``opt`` / ``regret`` over the traced
    window, and their access-weighted means over all rows (``regret`` 0.0
    when nothing was traced).  Host computation only."""
    acc_ev = records[records["kind"] == KIND_ACCESS]
    per_row: Dict[int, Dict[str, float]] = {}
    tot_acc = 0
    w_obs = 0.0
    w_opt = 0.0
    for row, cap in capacities.items():
        sel = acc_ev[acc_ev["row"] == row]
        n = int(len(sel))
        observed = safe_ratio(int(sel["hit"].sum()), n)
        opt = opt_hit_ratio(sel["key"], cap) if n else 0.0
        per_row[row] = {"accesses": n, "observed": observed, "opt": opt,
                        "regret": opt - observed}
        tot_acc += n
        w_obs += observed * n
        w_opt += opt * n
    aggregate = {
        "accesses": tot_acc,
        "observed": safe_ratio(w_obs, tot_acc),
        "opt": safe_ratio(w_opt, tot_acc),
        "regret": safe_ratio(w_opt - w_obs, tot_acc),
    }
    return per_row, aggregate
