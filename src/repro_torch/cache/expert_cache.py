"""MoE expert cache: host->HBM expert paging with a pluggable policy
(``repro/cache/expert_cache.py``).

Serving an MoE model under a tight device-memory budget keeps only
``capacity`` experts resident per layer; the router's top-k choices form the
access stream and the policy decides which expert to evict on a miss (a
miss is one host->device weight transfer, the cost counted).

``simulate_router_trace`` reuses the core simulator, so the numbers are
comparable with the paper's Table 1 methodology.

``ExpertCacheRuntime`` has two execution paths behind one accounting
surface, chosen by ``device``:

* **device** (default ``"cuda"``; ``"cpu"`` runs the stream's plain
  version): one policy core (``policy_core.make_core``) holding all layers
  as ``n_layers`` rows of ``capacity`` ways, stepped by the trace kernels'
  stream mode (``ops.flat_stream`` for awrp/lru/fifo/lfu,
  ``ops.adaptive_stream`` for arc/car): a call is one launch over its whole
  access stream and one pull of the hit count.  ``route_step``'s stream
  lists rows 0..n_layers-1 for choice 0, then for choice 1, and so on: the
  reference's k batched steps, in its order.  Decisions equal the host
  oracles';
* **host** (``device="host"``): one ``core/policies.py`` oracle per layer,
  built through the serving factory (``policy_core.make_cache_policy``).

Nothing feeds the router into this cache yet, in the reference as here:
``ServeEngine`` only carries it and mounts its telemetry.
"""

from __future__ import annotations

from typing import Dict, Iterable

import numpy as np
import torch

from repro_torch.core.policy_core import ADAPTIVE_POLICIES, make_cache_policy, make_core
from repro_torch.core.simulator import SimResult, simulate
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.obs.metrics import safe_ratio


def router_trace_from_logits(expert_idx: np.ndarray) -> np.ndarray:
    """(steps, k) router top-k choices -> flat access stream."""
    return np.asarray(expert_idx).reshape(-1).astype(np.int64)


def simulate_router_trace(
    policies: Iterable[str],
    trace: np.ndarray,
    capacity: int,
    expert_bytes: int = 0,
) -> Dict[str, dict]:
    """Returns {policy: {hit_ratio, transfers, transfer_bytes}}."""
    out = {}
    for p in policies:
        res: SimResult = simulate(p, trace, capacity)
        misses = res.accesses - res.hits
        out[p] = {
            "hit_ratio": res.hit_ratio,
            "transfers": misses,
            "transfer_bytes": misses * expert_bytes,
        }
    return out


class ExpertCacheRuntime:
    """Online variant used by the engine: track residency per layer and count
    transfers as the router stream arrives."""

    #: EWMA rate of the stream kernels' pressure plane (unread here)
    _ALPHA = 0.1

    def __init__(self, n_layers: int, capacity: int, policy: str = "awrp",
                 *, device="cuda"):
        self.n_layers = int(n_layers)
        self.capacity = int(capacity)
        self.policy_name = policy if isinstance(policy, str) else policy.name
        self.on_host = isinstance(device, str) and device == "host"
        self.transfers = 0
        self.accesses = 0
        if self.on_host:
            if not isinstance(policy, str) and self.n_layers > 1:
                # a prebuilt instance cannot back multiple layers: they
                # would share (and corrupt) one residency set
                raise ValueError(
                    "pass a policy NAME for n_layers > 1; a prebuilt "
                    "instance would be shared across layers"
                )
            self.layers = [
                make_cache_policy(policy, self.capacity)
                for _ in range(self.n_layers)
            ]
            return
        if not isinstance(policy, str):
            raise ValueError(
                "the device path takes a policy NAME (one of "
                "DEVICE_POLICIES), not a prebuilt instance; pass "
                "device='host' for an instance"
            )
        self.device = resolve_device(device)
        self.core = make_core(policy, rows=self.n_layers, num_sets=1, ways=self.capacity)
        self.state = self.core.init(device=self.device)
        # the stream kernels' per-row accounting, which this cache does not
        # expose
        self._counters = self.core.init_counters(device=self.device)
        per_row = ((self.core.caps,) if policy in ADAPTIVE_POLICIES
                   else (self.core.pids, self.core.ways))
        self._row_consts = tuple(torch.tensor(v, dtype=torch.int32, device=self.device)
                                 for v in per_row)

    # -- device path ---------------------------------------------------------
    def stream_call(self, rows: np.ndarray, keys: np.ndarray):
        """The stream launch over ``keys`` on core rows ``rows`` (equal-length
        non-empty arrays, in access order) from the current state, as
        ``(fn, args, kwargs)``: ``fn(*args, **kwargs)`` returns (hits, state,
        counters) and leaves this runtime as it was."""
        both = torch.from_numpy(np.stack([rows, keys]).astype(np.int32)).to(self.device)
        args = (both[1], both[0], self.state, self._counters, *self._row_consts)
        if self.policy_name in ADAPTIVE_POLICIES:
            return ops.adaptive_stream, args, dict(
                kind=self.core.kind, alpha=self._ALPHA, renorm_at=self.core.renorm_at)
        return ops.flat_stream, args, dict(alpha=self._ALPHA)

    def _device_hits(self, rows: np.ndarray, keys: np.ndarray) -> int:
        """Steps the core over ``keys`` on rows ``rows`` (one launch) and
        returns the number of hits (one pull).  An empty stream launches
        nothing."""
        if not len(keys):
            return 0
        fn, args, kwargs = self.stream_call(rows, keys)
        hits, self.state, self._counters = fn(*args, **kwargs)
        return int(hits.sum())

    # -- public -------------------------------------------------------------
    def route(self, layer: int, experts: Iterable[int]) -> int:
        """Record router choices for one layer-step; returns #misses.  An
        empty list launches nothing and counts nothing."""
        experts = [int(e) for e in experts]
        if not self.on_host:
            layer = range(self.n_layers)[layer]  # the host path's IndexError
            rows = np.full(len(experts), layer, dtype=np.int32)
            misses = len(experts) - self._device_hits(rows, np.asarray(experts))
        else:
            misses = 0
            for e in experts:
                if not self.layers[layer].access(e):
                    misses += 1
        self.accesses += len(experts)
        self.transfers += misses
        return misses

    def route_step(self, expert_idx) -> int:
        """Record one full model step's router choices for ALL layers at
        once: ``expert_idx`` is ``(n_layers, k)`` top-k expert ids.  On the
        device path this is one stream launch, choice-major (all layers'
        choice 0, then choice 1, ...), instead of a Python loop of
        n_layers*k dict-oracle accesses; decisions and accounting are
        identical to calling ``route`` per layer.  Returns total #misses
        across layers."""
        expert_idx = np.asarray(expert_idx, dtype=np.int32)
        if expert_idx.ndim != 2 or expert_idx.shape[0] != self.n_layers:
            raise ValueError(
                f"expert_idx must be (n_layers={self.n_layers}, k), "
                f"got {expert_idx.shape}"
            )
        k = expert_idx.shape[1]
        if not self.on_host:
            rows = np.tile(np.arange(self.n_layers, dtype=np.int32), k)
            misses = self.n_layers * k - self._device_hits(rows, expert_idx.T.reshape(-1))
        else:
            misses = 0
            for layer in range(self.n_layers):
                for e in expert_idx[layer]:
                    if not self.layers[layer].access(int(e)):
                        misses += 1
        self.accesses += self.n_layers * k
        self.transfers += misses
        return misses

    @property
    def hit_ratio(self) -> float:
        """Fraction of expert accesses served without an HBM transfer
        (0.0 before any access: the shared ``obs.metrics.safe_ratio``
        guard)."""
        return safe_ratio(self.accesses - self.transfers, self.accesses)

    def telemetry(self) -> dict:
        """Uniform per-cache stats (the serving engine's one code path)."""
        return {
            "policy": self.policy_name,
            "backend": "host" if self.on_host else "device",
            "accesses": self.accesses,
            "transfers": self.transfers,
            "hit_ratio": self.hit_ratio,
        }
