"""Policy-pluggable victim selection for KV pages (``repro/core/kv_policy.py``).

``page_victim`` is the classic pool's single decision point.  AWRP is the
paper's eq. (1); LRU/FIFO/LFU are its baselines on page metadata; ``arc`` and
``car`` are stateless two-segment approximations (pages referenced at most
once since insertion evict first; recency order within a segment for arc,
insertion order for car).  Every branch is a chain of first-index min
reductions, so the CUDA kernel's block reductions reproduce it bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch.core.policy_core import INT_MAX, awrp_victim_rows, first_min

__all__ = ["PAGE_POLICIES", "POLICY_ID", "first_min", "page_victim"]

PAGE_POLICIES = ("awrp", "lru", "fifo", "lfu", "arc", "car")

#: integer id of each page policy, as the fused CUDA kernel takes it
#: (``kernels/csrc/paged_attn_common.cuh``, ``page_victim``)
POLICY_ID = {name: i for i, name in enumerate(PAGE_POLICIES)}


def _masked_tiebreak(primary: torch.Tensor, secondary: torch.Tensor) -> torch.Tensor:
    """First index minimizing (primary, secondary) lexicographically."""
    m = primary.amin(dim=-1, keepdim=True)
    return first_min(torch.where(primary == m, secondary, INT_MAX))


def page_victim(
    policy: str,
    f: torch.Tensor,  # (B, P) int32 frequency
    r: torch.Tensor,  # (B, P) int32 last-reference clock
    page_start: torch.Tensor,  # (B, P) int32 token start, -1 free
    clock: torch.Tensor,  # (B,) int32
    pinned: torch.Tensor,  # (B, P) bool
) -> torch.Tensor:
    """Next-victim page slot of each row, (B,) int32."""
    valid = (page_start >= 0) & ~pinned
    if policy == "awrp":
        return awrp_victim_rows(f, r, clock, valid)
    if policy == "lru":
        return first_min(torch.where(valid, r, INT_MAX))
    if policy == "fifo":
        return first_min(torch.where(valid, page_start, INT_MAX))
    if policy == "lfu":
        return _masked_tiebreak(torch.where(valid, f, INT_MAX), r)
    if policy in ("arc", "car"):
        cold = torch.where(valid, (f > 1).to(torch.int32), INT_MAX)
        return _masked_tiebreak(cold, r if policy == "arc" else page_start)
    raise ValueError(f"unknown page policy {policy!r}; have {PAGE_POLICIES}")
