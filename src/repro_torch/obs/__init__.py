"""Observability (``repro/obs``).

* ``obs.metrics``: the registry, one flat namespaced snapshot over every
  mounted provider, read back from the device with one synchronization;
  and the decode loop's int32 planes, advanced inside the captured decode
  step;
* ``obs.spans``: host-clock timing spans with p50 / p95 and the ``ready``
  hook of the sync discipline, mounted on the registry;
* ``obs.profiling``: the decode graphs' and the kernel library's compile
  counters, and ``torch.profiler`` trace capture;
* ``obs.export``: Prometheus text exposition and the JSONL event log;
* ``obs.server``: the background HTTP ``/metrics`` endpoint and the
  periodic JSONL snapshot loop;
* ``obs.decision_trace``: the decision-trace ring, written on the device by
  the tenancy manager's accesses (inside the stream kernels on the card) and
  admissions, drained with one synchronization;
* ``obs.opt_oracle``: OPT regret of a drained trace against the offline
  Belady oracle.

``PHASES`` (``obs.profiling``) holds the spans of code with no engine, the
sweep's ``sweep`` phase.  The names below are exported at package level;
import the other modules explicitly.
"""

from repro_torch.obs.decision_trace import (KIND_ACCESS, KIND_ADMIT, DecisionRing, drain,
                                            ring_init)
from repro_torch.obs.metrics import Derived, Registry, safe_ratio, safe_ratio_plane
from repro_torch.obs.opt_oracle import opt_hit_ratio, regret_from_records
from repro_torch.obs.profiling import PHASES

__all__ = ["Derived", "Registry", "safe_ratio", "safe_ratio_plane", "DecisionRing",
           "KIND_ACCESS", "KIND_ADMIT", "ring_init", "drain", "opt_hit_ratio",
           "regret_from_records", "PHASES"]
