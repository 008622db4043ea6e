"""Host-side prompt/prefix cache with pluggable replacement policy
(``repro/cache/prefix_cache.py``).

Prefix reuse at whole-prompt granularity (exact match on the page-aligned
prompt): a hit returns the stored payload so prefill is skipped.  Eviction
is driven by a host ``ReplacementPolicy``, AWRP by default.  Payloads are
held by reference; the serving engine stores and hands out clones, because
decoding updates its caches in place.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.core.policy_core import make_cache_policy
from repro_torch.obs.metrics import safe_ratio


def prompt_key(tokens) -> int:
    """Exact-match cache key for a token sequence (order-sensitive hash).
    Non-negative: the slot-array policies use negative ids as "empty"."""
    return hash(tuple(int(t) for t in tokens)) & 0x7FFF_FFFF_FFFF_FFFF


class PrefixCache:
    """Single-tenant prompt -> payload map with policy eviction."""

    def __init__(self, capacity: int = 16, policy: str = "awrp"):
        self.policy = make_cache_policy(policy, capacity)
        self.store: Dict[int, Any] = {}
        self.hits = 0
        self.misses = 0

    def lookup(self, tokens) -> Optional[Any]:
        """Return the stored payload or None.  A lookup is an access: it
        updates the policy and the hit/miss counters either way."""
        key = prompt_key(tokens)
        if key in self.store:
            self.policy.access(key)
            self.hits += 1
            return self.store[key]
        self.misses += 1
        return None

    def insert(self, tokens, payload: Any) -> None:
        """Store ``payload`` under the prompt's key, evicting per policy."""
        key = prompt_key(tokens)
        if key in self.store:
            self.policy.access(key)
            self.store[key] = payload
            return
        before = self.policy.resident_set()
        self.policy.access(key)  # may evict
        for evicted in before - self.policy.resident_set():
            self.store.pop(evicted, None)
        self.store[key] = payload

    @property
    def hit_ratio(self) -> float:
        return safe_ratio(self.hits, self.hits + self.misses)

    def telemetry(self) -> dict:
        return {"policy": self.policy.name, "entries": len(self.store),
                "hits": self.hits, "misses": self.misses,
                "hit_ratio": self.hit_ratio}

    def entry_bytes(self) -> int:
        """Total bytes of the tensors the stored payloads hold (accounting
        hook: the production capacity unit; entries are the repro unit)."""
        return sum(_tensor_bytes(v) for v in self.store.values())


def _tensor_bytes(tree) -> int:
    """Bytes of every tensor leaf of a payload: nested dicts, lists and
    tuples (``PagedPool`` and the other named tuples included); other leaves
    (the cache position, an int) hold none."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)):
        return 0
    return sum(_tensor_bytes(v) for v in tree)
