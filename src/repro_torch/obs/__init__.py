"""The metrics half of observability (``repro/obs``).

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
  periodic JSONL snapshot loop.

Not ported yet: the reference's decision-trace ring (``obs.decision_trace``)
and the OPT-regret oracle (``obs.opt_oracle``).  Only ``metrics`` is
imported at package level; import the other modules explicitly.
"""

from repro_torch.obs.metrics import Derived, Registry, safe_ratio, safe_ratio_plane

__all__ = ["Derived", "Registry", "safe_ratio", "safe_ratio_plane"]
