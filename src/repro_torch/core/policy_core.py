"""Tensor decision core: the victim reductions the paged pool runs.

The serving slice's subset of ``repro/core/policy_core.py``: the AWRP weight
(paper eq. (1)), the first-index min reduction, the inline AWRP victim and the
host-policy factory.  The flat / adaptive ``PolicyCore`` protocol and the
sweep engine's kernel route (``awrp_select_rows``) come with the Table-1
sweep slice.

Every plane is ``int32``; weights are compared through their int32 bit
pattern (``w >= 0`` always, so IEEE order equals int32 order) and every
selection is a first-index min, never ``argmin`` (whose tie order torch does
not promise).
"""

from __future__ import annotations

import torch

__all__ = ["INT_MAX", "awrp_weights", "first_min", "awrp_victim_rows",
           "make_cache_policy"]

INT_MAX = 2**31 - 1


def awrp_weights(f: torch.Tensor, r: torch.Tensor, clock: torch.Tensor) -> torch.Tensor:
    """Paper eq. (1): W_i = F_i / (N - R_i), float32 IEEE division
    (callers mask empties)."""
    dt = torch.clamp(clock - r, min=1).to(torch.float32)
    return f.to(torch.float32) / dt


def first_min(key: torch.Tensor) -> torch.Tensor:
    """First index achieving the row minimum of ``key`` (..., P) int32, as
    two min-reductions; returns int32."""
    P = key.shape[-1]
    lane = torch.arange(P, dtype=torch.int32, device=key.device)
    m = key.amin(dim=-1, keepdim=True)
    return torch.where(key == m, lane, P).amin(dim=-1).to(torch.int32)


def awrp_victim_rows(
    f: torch.Tensor,  # (B, P) int32
    r: torch.Tensor,  # (B, P) int32
    clock: torch.Tensor,  # (B,) int32
    valid: torch.Tensor,  # (B, P) bool
) -> torch.Tensor:
    """Inline AWRP victim per row: the bit-pattern first-index min of
    ``F / max(N - R, 1)`` over ``valid`` lanes."""
    bits = awrp_weights(f, r, clock[:, None]).view(torch.int32)
    return first_min(torch.where(valid, bits, INT_MAX))


def make_cache_policy(policy, capacity: int, **kw):
    """The serving-side factory: resolve ``policy`` — a name or an
    already-built ``ReplacementPolicy`` — into a host policy instance."""
    from repro_torch.core.policies import ReplacementPolicy, make_policy

    if isinstance(policy, ReplacementPolicy):
        if policy.capacity != int(capacity):
            raise ValueError(
                f"prebuilt policy has capacity {policy.capacity} but the "
                f"cache requested {capacity}"
            )
        return policy
    return make_policy(policy, capacity, **kw)
