"""Snapshot exporters: Prometheus text exposition + JSONL event log
(``repro/obs/export.py``).

Both take the flat namespaced snapshot dict ``Registry.snapshot()`` (and
``ServeEngine.telemetry()``) returns — ``{"tenant/alice/hit_ratio": 0.75,
"serve/loop/token_hist": array([...]), ...}`` — and serialize it:

* ``prometheus_text`` — the text exposition format: one
  ``<prefix>_<sanitized_path> <value>`` line per numeric scalar, array
  metrics (histograms, per-row planes) as indexed series with a
  ``{bucket="i"}`` label, string values as ``# info`` comments (policy
  names and the like have no numeric sample).  Every numeric metric gets
  ``# HELP`` (carrying the ORIGINAL registry path, so the pre-sanitize
  name survives into the scrape) and ``# TYPE ... gauge`` lines; two
  registry paths that collide after sanitization (``a-b`` vs ``a_b``)
  stay distinct series via a ``_dup<N>`` suffix instead of silently
  emitting duplicates.
* ``append_jsonl`` — one JSON object per call appended to a log file,
  numpy values converted and a host ``ts`` timestamp added — the event
  log a scrape-less deployment tails.

Wired into ``launch/serve.py --metrics-out`` (writes ``<path>.prom`` and
appends ``<path>.jsonl``).  Host code, a copy of ``repro/obs/export.py``:
given the same snapshot dict, both write the same bytes.
"""

from __future__ import annotations

import json
import re
import time
from typing import Any, Dict, List

import numpy as np

__all__ = ["prometheus_text", "append_jsonl"]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _metric_name(path: str, prefix: str) -> str:
    name = _NAME_RE.sub("_", f"{prefix}_{path}" if prefix else path)
    return name if not name[:1].isdigit() else f"_{name}"


def _fmt(v) -> str:
    f = float(v)
    return repr(int(f)) if f == int(f) else repr(f)


def prometheus_text(snapshot: Dict[str, Any], *, prefix: str = "awrp") -> str:
    """Render ``snapshot`` in the Prometheus text exposition format
    (path separators become underscores).  Numeric scalars are one sample
    each, 1-D arrays one sample per element with a ``bucket`` label,
    strings ``# info`` comments; each numeric metric is preceded by
    ``# HELP`` (original registry path) and ``# TYPE ... gauge`` lines.
    Sanitization collisions get a ``_dup<N>`` suffix — the HELP line
    carries the original path, so nothing is silently merged.
    Deterministic output order (sorted by path)."""
    lines: List[str] = []
    taken: Dict[str, int] = {}
    for path in sorted(snapshot):
        v = snapshot[path]
        name = _metric_name(path, prefix)
        n_prior = taken.get(name, 0)
        taken[name] = n_prior + 1
        if n_prior:
            name = f"{name}_dup{n_prior}"
        if isinstance(v, str):
            lines.append(f"# {name} info: {v}")
        elif isinstance(v, np.ndarray):
            lines.append(f"# HELP {name} {path}")
            lines.append(f"# TYPE {name} gauge")
            for i, x in enumerate(v.reshape(-1).tolist()):
                lines.append(f'{name}{{bucket="{i}"}} {_fmt(x)}')
        elif isinstance(v, (bool, np.bool_)):
            lines.append(f"# HELP {name} {path}")
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {int(v)}")
        elif isinstance(v, (int, float, np.integer, np.floating)):
            lines.append(f"# HELP {name} {path}")
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {_fmt(v)}")
        else:  # non-metric payloads (lists, None) are skipped, visibly
            lines.append(f"# {name} skipped: {type(v).__name__}")
    return "\n".join(lines) + "\n"


def _jsonable(v):
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (np.integer, np.floating, np.bool_)):
        return v.item()
    return v


def append_jsonl(path: str, snapshot: Dict[str, Any], *,
                 extra: Dict[str, Any] | None = None) -> None:
    """Append ``snapshot`` as one JSON line to ``path`` (created if
    missing), with a ``ts`` wall-clock field and optional ``extra``
    fields merged in.  One line per call — the file is an append-only
    event log."""
    rec = {"ts": time.time()}
    if extra:
        rec.update(extra)
    rec.update({k: _jsonable(v) for k, v in snapshot.items()})
    with open(path, "a") as fh:
        fh.write(json.dumps(rec) + "\n")
