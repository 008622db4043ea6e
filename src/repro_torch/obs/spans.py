"""Host-clock timing spans, mounted on the registry (``repro/obs/spans.py``).

``SpanSet.span(name)`` is a context manager that accumulates call counts and
wall seconds per named section (prefill, decode, rebalance), and
``metrics()`` is a registry provider, so the totals ride the same flat
snapshot as the cache counters (``span/<name>/calls``, ``seconds``,
``max_s``, ``p50_s``, ``p95_s``).

These are host timings around device work: they include the launches and
any synchronization the section makes, which is the number serving feels.
CUDA launches are asynchronous, so a span around bare launches times only
their enqueueing unless something in it waits.  With ``sync=True``
(``ServeEngine(profile_phases=True)``) the span's handle takes the phase's
outputs through ``ready(x)`` and the close waits for the devices they live
on (``torch.cuda.synchronize``), so the span holds the phase's own device
time.  With ``sync=False`` ``ready`` is free, so call sites never branch.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, Iterator

import torch


def _tensors(x: Any) -> Iterator[torch.Tensor]:
    """The tensors of a value: a tensor, or a dict / list / tuple (named
    tuples included) of them, at any depth."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def _wait(values: list) -> None:
    """Wait until the work that makes ``values`` is done: one
    ``torch.cuda.synchronize`` per CUDA device they live on (CPU tensors are
    ready when they exist)."""
    devices = {t.device for v in values for t in _tensors(v) if t.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)


class _Span:
    """Handle yielded by ``SpanSet.span``: ``ready(x)`` registers values the
    span waits on at its close when the owning set has ``sync=True`` (a
    no-op otherwise)."""

    __slots__ = ("_pending", "_sync")

    def __init__(self, sync: bool):
        self._sync = sync
        self._pending: list = []

    def ready(self, x: Any) -> Any:
        """Mark ``x`` (a tensor or a tree of them) to be waited on at the
        span's close in sync mode; returns ``x`` unchanged."""
        if self._sync:
            self._pending.append(x)
        return x


class SpanSet:
    """Per-name wall-clock spans: ``calls`` / ``seconds`` / ``max_s`` and
    ``p50_s`` / ``p95_s`` over a bounded window of the most recent
    ``max_samples`` durations (bounded so a long-lived server cannot grow
    without limit; the percentiles are recent).  One per engine; a lock
    makes ``metrics()`` safe to call from another thread (a ``/metrics``
    scrape) while the serving thread closes spans."""

    def __init__(self, *, max_samples: int = 512, sync: bool = False):
        self._acc: Dict[str, list] = {}
        self._samples: Dict[str, Deque[float]] = {}
        self._max_samples = int(max_samples)
        self._lock = threading.Lock()
        self.sync = bool(sync)

    @contextlib.contextmanager
    def span(self, name: str):
        """Time one ``with`` section under ``name``; an exception propagates
        and the elapsed time is still recorded.  Yields a handle whose
        ``ready(x)`` enrolls values to wait on at the close in sync mode."""
        h = _Span(self.sync)
        t0 = time.perf_counter()
        try:
            yield h
        finally:
            if h._pending:
                _wait(h._pending)
            dt = time.perf_counter() - t0
            with self._lock:
                acc = self._acc.setdefault(name, [0, 0.0, 0.0])
                acc[0] += 1
                acc[1] += dt
                acc[2] = max(acc[2], dt)
                self._samples.setdefault(name, deque(maxlen=self._max_samples)).append(dt)

    @staticmethod
    def _pct(xs: list, q: float) -> float:
        """Nearest-rank percentile of a sorted sample list."""
        return xs[min(int(q * (len(xs) - 1) + 0.5), len(xs) - 1)]

    def metrics(self) -> Dict[str, Dict[str, float]]:
        """Registry provider: ``{name: {calls, seconds, max_s, p50_s,
        p95_s}}``, host values, nothing to pull.  The percentiles cover the
        recent-sample window only."""
        with self._lock:
            acc = [(name, *a, sorted(self._samples.get(name, ())))
                   for name, a in self._acc.items()]
        out: Dict[str, Dict[str, float]] = {}
        for name, c, s, m, xs in acc:
            out[name] = {
                "calls": c,
                "seconds": s,
                "max_s": m,
                "p50_s": self._pct(xs, 0.50) if xs else 0.0,
                "p95_s": self._pct(xs, 0.95) if xs else 0.0,
            }
        return out
