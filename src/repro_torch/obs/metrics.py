"""Host-side metric helpers (the part of ``repro/obs/metrics.py`` the serving
slice needs)."""

from __future__ import annotations


def safe_ratio(num, den) -> float:
    """``num / den`` with the zero-denominator guard every telemetry surface
    shares: 0.0 when ``den`` is falsy (no accesses yet)."""
    return num / den if den else 0.0
