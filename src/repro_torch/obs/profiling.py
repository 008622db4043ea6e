"""Compile counters and profiler capture (the port's part of
``repro/obs/profiling.py``).

The serving stack must see its own compile behaviour: a decode graph
captured again for every bucket shows in wall time but in no counter unless
captures are counted.  The port compiles two things, and
``compile_metrics()`` reports both under the reference's names where the
meaning is the same, mounted as the registry's ``compile`` namespace:

* ``compile/decode_loop/{count, calls, cache_size, last_trace_s}``: the
  engine's decode graphs (``serve/engine.py`` ``DecodeGraph``): graphs
  built (captured on the card), replays, live graphs and the seconds the
  last build took.  Each engine owns a ``Sentinel("decode_loop")``; live
  sentinels of one name are summed, as the reference sums its;
* ``compile/nvcc/{count, seconds}``: the kernel library's builds in this
  process (``kernels/_build.build()``): nvcc runs and their seconds, 0 when
  the library was already built.

The reference's jaxpr equation audit (``count_eqns``, ``eqns``) has no
counter here: a CUDA graph has no equations to count.

``TraceCapture`` is the opt-in ``torch.profiler`` hook:
``ServeEngine(profile_dir=...)`` writes one chrome trace per ``every``
requests under ``profile_dir``.

``PHASES`` is the module's span set for code with no engine to mount on:
``core.simulator.sweep`` times its device route there as ``sweep``.
"""

from __future__ import annotations

import contextlib
import os
import threading
import weakref
from typing import Any, Dict

import torch

from repro_torch.kernels import _build
from repro_torch.obs.spans import SpanSet

__all__ = ["Sentinel", "compile_metrics", "TraceCapture", "PHASES"]

#: phase spans of code with no engine to mount on (the sweep's device route
#: records ``sweep`` here)
PHASES = SpanSet()

#: every live sentinel, summed by name in ``compile_metrics``; the lock
#: keeps a snapshot on another thread from iterating it while an engine is
#: built
_ALL: "weakref.WeakSet[Sentinel]" = weakref.WeakSet()
_ALL_LOCK = threading.Lock()


class Sentinel:
    """Compile counters of one named entry point, kept by its owner:
    ``traces`` (builds ever made), ``calls`` (runs ever made),
    ``cache_size`` (live compiled programs) and ``last_trace_s`` (host
    seconds of the last build)."""

    def __init__(self, name: str):
        self.name = str(name)
        self.traces = 0
        self.calls = 0
        self.cache_size = 0
        self.last_trace_s = 0.0
        with _ALL_LOCK:
            _ALL.add(self)

    def metrics(self) -> Dict[str, Any]:
        """This sentinel's gauges."""
        return {"count": self.traces, "calls": self.calls,
                "cache_size": self.cache_size, "last_trace_s": self.last_trace_s}


def compile_metrics() -> Dict[str, Dict[str, Any]]:
    """Registry provider: every live sentinel summed by name (``count``,
    ``calls`` and ``cache_size`` add, ``last_trace_s`` takes the largest),
    and the kernel library's nvcc builds.  Host values only."""
    with _ALL_LOCK:
        live = list(_ALL)
    agg: Dict[str, Dict[str, Any]] = {}
    for s in sorted(live, key=lambda s: s.name):
        m = s.metrics()
        d = agg.setdefault(s.name, {"count": 0, "calls": 0, "cache_size": 0,
                                    "last_trace_s": 0.0})
        d["count"] += m["count"]
        d["calls"] += m["calls"]
        d["cache_size"] += m["cache_size"]
        d["last_trace_s"] = max(d["last_trace_s"], m["last_trace_s"])
    agg["nvcc"] = {"count": len(_build.BUILDS),
                   "seconds": sum(b.seconds for b in _build.BUILDS)}
    return agg


class TraceCapture:
    """Opt-in ``torch.profiler`` capture: one trace per ``every`` requests,
    written under ``profile_dir`` as ``generate_<n>.json`` (chrome trace
    format; open it in perfetto or ``chrome://tracing``).  Device activity
    is recorded when CUDA is available, host activity always.

    ``maybe(n)`` is the per-``generate`` hook: a context manager that runs
    the body inside a profiler session and a ``generate`` record (when the
    request counter crosses a capture boundary) or does nothing.  A capture
    that cannot start (another profiler session active, an unwritable
    directory) runs the body unprofiled: profiling never takes serving
    down."""

    def __init__(self, profile_dir: str, every: int = 16):
        self.dir = str(profile_dir)
        self.every = max(int(every), 1)
        self.seen = 0
        self.captures = 0

    @contextlib.contextmanager
    def maybe(self, n: int = 1):
        """Capture-or-passthrough for one request batch of size ``n`` (the
        first batch always captures; later batches capture each time another
        ``every`` requests have passed).  Yields True when this batch is
        captured."""
        due = self.seen // self.every != (self.seen + n) // self.every \
            or self.seen == 0
        self.seen += n
        if not due:
            yield False
            return
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        try:
            os.makedirs(self.dir, exist_ok=True)
            prof = torch.profiler.profile(activities=activities)
            prof.__enter__()
        except Exception:  # noqa: BLE001 — e.g. a session already active
            yield False
            return
        try:
            with torch.profiler.record_function(f"generate#{self.captures}"):
                yield True
        finally:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(
                os.path.join(self.dir, f"generate_{self.captures}.json"))
            self.captures += 1

    def metrics(self) -> Dict[str, Any]:
        """Registry provider: capture cadence and totals (host values)."""
        return {"dir": self.dir, "every": self.every,
                "requests_seen": self.seen, "captures": self.captures}
