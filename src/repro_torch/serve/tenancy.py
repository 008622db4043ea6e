"""Multi-tenant cache tenancy (``repro/serve/tenancy.py``).

One batched policy core, one row per tenant: ``FlatCore(ways=quotas)`` /
``AdaptiveCore(caps=quotas)`` mounts every tenant's cache as an independent
row of the same core, and per-tenant request streams are replayed as masked
``on_access_counted`` steps (rows of inactive tenants are exact no-ops).
Per-tenant accounting comes from the core itself (``row_telemetry``), so the
numbers the serving engine reports are those of the host oracles on the
demuxed per-tenant streams.

On the card a whole interleaved stream is ONE launch of the persistent trace
kernels' stream mode (``kernels/ops.py`` ``flat_stream`` /
``adaptive_stream``, ``csrc/sweep.cu``), starting from the manager's state
and ``RowCounters`` and leaving new ones: no host sync until the hits and the
pressure plane are pulled at the end.  ``access`` is the same launch with one
access, so the single-access path and the stream path share one pressure
EWMA in CUDA and one in the plain version (``kernels/ref.py``, the CPU
route).

Three layers:

* ``TenantCacheManager``: routing, accounting, the eviction-pressure EWMA
  (``RowCounters.pressure``), AWRP-ranked quota rebalancing.  Tenants are
  ranked by the paper's eq. (1) at tenant altitude, ``W_t = F_t / (N - R_t)``
  (F_t the tenant's accesses, R_t the clock of its last access, N the
  manager's clock); the coldest tenant donates quota lanes first.
* ``AdmissionController``: pressure -> accept / defer / shed, per request on
  the host (``decide``) or for a whole request batch on the pressure plane
  (``decide_batch``), with identical decisions: both read the same float32
  plane, the host a pulled copy.
* ``TenantPrefixCache``: one payload store per tenant over the manager,
  store contents equal to the row's resident set.

Quota rebalancing is for flat cores (awrp/lru/fifo/lfu); adaptive rows
(arc/car) carry ghost directories whose invariants do not survive a
capacity change, so their quotas are fixed.

Decision tracing: ``ring_capacity=N`` gives the manager a decision-trace
ring (``obs/decision_trace.py``) of its N most recent events.  Every access
records one ``KIND_ACCESS`` event: on the card the stream launch runs the
kernels' ring variant, which writes the ring with the state, and on the CPU
the plain version pushes it per access.  ``decide_batch`` records one
``KIND_ADMIT`` event per request.  ``drain_trace`` pulls the ring with one
synchronization.

Rows mesh: ``mesh=`` (a ``core.sharding`` rows mesh) places the tenant rows
across its shards.  Tenant counts rarely divide the shard count, so the core
pads its rows to a multiple (``sharding.pad_rows_to``) with minimum-quota
rows no access touches.  ``access`` / ``access_stream`` cut the stream by
shard and launch each shard's part on its device and stream (a shard with
no access launches nothing); ``decide_batch`` runs each shard's requests
likewise.  The decision-trace ring is one segment per shard, each of the
full capacity; the manager logs on the host which shard recorded each event,
and ``drain_trace`` merges the segments in that order, so the drained
records equal the unsharded manager's, field by field and in order.  The
reference's compile sentinels of ``decide_batch`` and the tenancy step have
no counterpart: nothing here is compiled.  The serving engine reports the rows through its
registry (``ServeEngine.telemetry``) from ``row_metrics``, un-pulled.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.cache.prefix_cache import prompt_key
from repro_torch.core import sharding
from repro_torch.core.policy_core import (
    ADAPTIVE_POLICIES,
    ADMIT_SHED,
    JAX_POLICIES,
    POLICY_IDS,
    AdaptiveCore,
    FlatCore,
    RowCounters,
    _f32,
    admission_decay,
    admission_decide,
)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.obs import decision_trace as dt
from repro_torch.obs.metrics import _pull, safe_ratio

__all__ = [
    "TenantCacheManager",
    "AdmissionController",
    "TenantPrefixCache",
    "ACCEPT",
    "DEFER",
    "SHED",
]

ACCEPT, DEFER, SHED = "accept", "defer", "shed"

_I32 = torch.int32


class TenantCacheManager:
    """One batched policy core with one row per tenant (quota = row ways), on
    ``device`` (the CUDA card unless the caller asks for the CPU).

    ``quotas`` is an ordered ``{tenant: capacity}`` mapping; ``policy`` a
    device policy name (flat: awrp/lru/fifo/lfu; adaptive: arc/car).  Flat
    cores pad every row to ``lanes = sum(quotas)`` so rebalancing can grow
    any tenant up to the whole pool without changing plane shapes.
    ``ring_capacity > 0`` records every access and admission decision in a
    decision-trace ring of that many events (``drain_trace``).  ``mesh``
    (a ``core.sharding`` rows mesh) places the tenant rows across its
    shards, padded with rows no access touches; counters and decisions are
    bit-identical to the unsharded manager's."""

    def __init__(self, quotas: Dict[str, int], policy: str = "awrp", *,
                 pressure_alpha: float = 0.1, ring_capacity: int = 0, device="cuda",
                 mesh=None):
        if not quotas:
            raise ValueError("need at least one tenant")
        for t, q in quotas.items():
            if int(q) <= 0:
                raise ValueError(f"tenant {t!r} quota must be positive, got {q}")
        self.mesh = mesh
        self.device = resolve_device(device) if mesh is None else mesh.devices[0]
        self.tenants: List[str] = list(quotas)
        self._row_of = {t: i for i, t in enumerate(self.tenants)}
        self.policy_name = policy
        self.quotas = {t: int(q) for t, q in quotas.items()}
        self.pressure_alpha = float(pressure_alpha)
        #: core rows: the tenants', padded to a multiple of the mesh's shards
        self._core_rows = (len(self.tenants) if mesh is None
                           else sharding.pad_rows_to(len(self.tenants), mesh.size))
        # host mirror of the device pressure plane: always a pulled copy,
        # never recomputed on the host
        self._pressure = np.zeros(self._core_rows, dtype=np.float32)
        # tenant-altitude AWRP metadata for ranking: F_t / R_t / clock N
        self._tf = np.zeros(len(self.tenants), dtype=np.int64)
        self._tr = np.zeros(len(self.tenants), dtype=np.int64)
        self._tclock = 0
        # the decision-trace ring: written on the device by every access and
        # admission, read only by drain_trace.  Under a mesh one segment per
        # shard, and the shard of every recorded event in order on the host
        # (the last ring_capacity of them)
        self._mount()
        self.state = self.core.init(device=self.device, mesh=mesh)
        self.counters: RowCounters = self.core.init_counters(device=self.device, mesh=mesh)
        self.ring = None
        self._ring_log = np.zeros(0, dtype=np.int32)
        if ring_capacity:
            self.ring = (dt.ring_init(ring_capacity, self.device) if mesh is None else
                         self.state.replace(dt.ring_init(ring_capacity, d)
                                            for d in mesh.devices))

    # -- core mount ---------------------------------------------------------
    @property
    def rows(self) -> int:
        """Number of tenant rows."""
        return len(self.tenants)

    @property
    def is_adaptive(self) -> bool:
        """True for arc/car mounts (ghost directories, fixed quotas)."""
        return self.policy_name in ADAPTIVE_POLICIES

    def _mount(self) -> None:
        """Build the core for the current quotas, and the stream launch's
        per-row int32 constants on the device: (caps,) for adaptive rows,
        (pids, ways) for flat ones; under a mesh each shard's on its device
        (``_row_consts`` a ``RowShards``).  Mesh padding rows have quota 1
        and are never accessed, so they stay empty and unaccounted."""
        q = tuple(self.quotas[t] for t in self.tenants)
        q += (1,) * (self._core_rows - len(q))
        if self.policy_name in JAX_POLICIES:
            self.core = FlatCore(pids=(POLICY_IDS[self.policy_name],) * len(q), ways=q,
                                 lanes=sum(self.quotas.values()))
            per_row = (self.core.pids, q)
        elif self.policy_name in ADAPTIVE_POLICIES:
            self.core = AdaptiveCore(kind=self.policy_name, caps=q)
            per_row = (q,)
        else:
            raise ValueError(
                f"not a device policy: {self.policy_name!r}; "
                f"have {JAX_POLICIES + ADAPTIVE_POLICIES}")
        self._row_consts = tuple(torch.tensor(v, dtype=_I32, device=self.device)
                                 for v in per_row)
        if self.mesh is not None:
            self._row_consts = sharding.shard_rows(None, self._row_consts, self.mesh)

    def stream_call(self, tenant_rows: np.ndarray, keys: np.ndarray):
        """The stream launch over ``keys`` on rows ``tenant_rows`` (int32
        arrays of one length, rows in [0, rows)) from the current state,
        counters and ring, as ``(fn, args, kwargs)``: ``fn(*args, **kwargs)``
        returns (hits, state, counters), and the new ring ``(buf, count)``
        fourth when the manager traces, and leaves the manager as it was.
        Unsharded managers only: a sharded one makes one such call per
        shard (``_run_stream``)."""
        if self.mesh is not None:
            raise ValueError("stream_call is the unsharded launch; a sharded manager "
                             "launches per shard")
        return self._call(tenant_rows, keys, self.state, self.counters, self._row_consts,
                          self.ring, self.device)

    def _call(self, tenant_rows, keys, state, counters, consts, ring, dev):
        both = torch.from_numpy(np.stack([tenant_rows, keys]).astype(np.int32)).to(dev)
        args = (both[1], both[0], state, counters, *consts)
        kw = dict(alpha=self.pressure_alpha, ring=ring)
        if self.is_adaptive:
            return ops.adaptive_stream, args, dict(kw, kind=self.core.kind,
                                                   renorm_at=self.core.renorm_at)
        return ops.flat_stream, args, kw

    def _log_events(self, shard_of_event: np.ndarray) -> None:
        """Append the shards of newly recorded events to the ring's log (a
        sharded tracing manager), keeping the last capacity of them."""
        if self.mesh is None or self.ring is None:
            return
        cap = dt.ring_capacity(self.ring.shards[0])
        self._ring_log = np.concatenate([self._ring_log, shard_of_event])[-cap:]

    def _run_stream(self, tenant_rows: np.ndarray, keys: np.ndarray) -> torch.Tensor:
        """One call of the stream mode over the interleaved stream: advances
        ``state``, ``counters`` (the pressure EWMA included) and the ring and
        returns the (T,) bool hits, on the device, not pulled.  Under a mesh
        each shard's accesses (in stream order, on local rows) are one call
        on its device and stream, and the hits come back in stream order."""
        if self.mesh is None:
            fn, args, kw = self.stream_call(tenant_rows, keys)
            out = fn(*args, **kw)
            hits, self.state, self.counters = out[:3]
            if self.ring is not None:
                self.ring = dt.DecisionRing(*out[3])
            return hits
        mesh, k = self.mesh, self._core_rows // self.mesh.size
        shard = tenant_rows // k
        picks = [np.flatnonzero(shard == i) for i in range(mesh.size)]
        rings = self.ring.shards if self.ring is not None else (None,) * mesh.size

        def run(i, state, counters, consts, ring):
            if not len(picks[i]):
                return None
            fn, args, kw = self._call(tenant_rows[picks[i]] - i * k, keys[picks[i]], state,
                                      counters, consts, ring, mesh.devices[i])
            return fn(*args, **kw)

        outs = sharding.run_shards(mesh, run, self.state.shards, self.counters.shards,
                                   self._row_consts.shards, rings)
        hits = torch.zeros(len(keys), dtype=torch.bool, device=self.device)
        states, counters, rings = (list(t) for t in (self.state.shards, self.counters.shards,
                                                     rings))
        for i, out in enumerate(outs):
            if out is None:  # no access on this shard: it launched nothing
                continue
            hits[torch.from_numpy(picks[i]).to(self.device)] = out[0].to(self.device)
            states[i], counters[i] = out[1], out[2]
            if self.ring is not None:
                rings[i] = dt.DecisionRing(*out[3])
        self.state, self.counters = self.state.replace(states), self.counters.replace(counters)
        if self.ring is not None:
            self.ring = self.ring.replace(rings)
            self._log_events(shard.astype(np.int32))
        return hits

    def _pull_pressure(self) -> None:
        """Refresh the host mirror from the device plane (writable copy;
        one read per device under a mesh)."""
        if self.mesh is None:
            self._pressure = self.counters.pressure.cpu().numpy().copy()
        else:
            self._pressure = np.concatenate(_pull([c.pressure for c in self.counters.shards]))

    def _local(self, r: int) -> Tuple[Optional[int], int]:
        """``(shard, local row)`` of core row ``r``: ``(None, r)`` unsharded."""
        return (None, r) if self.mesh is None else self.state.locate(r)

    def _part(self, tree, i: Optional[int]):
        """The whole ``tree`` (``i`` None) or its shard ``i``."""
        return tree if i is None else tree.shards[i]

    def _put(self, i: Optional[int], *, state=None, counters=None) -> None:
        """Replace the whole state / counters (``i`` None) or shard ``i``'s."""
        def put(tree, new):
            if new is None:
                return tree
            if i is None:
                return new
            return tree.replace(new if j == i else s for j, s in enumerate(tree.shards))

        self.state = put(self.state, state)
        self.counters = put(self.counters, counters)

    def row(self, tenant: str) -> int:
        """Core row index of ``tenant`` (raises KeyError for unknowns)."""
        try:
            return self._row_of[tenant]
        except KeyError:
            raise KeyError(f"unknown tenant {tenant!r}; have {self.tenants}") from None

    # -- access -------------------------------------------------------------
    def _resident_ids(self, state, r: int) -> set:
        i, r = self._local(r)
        state = self._part(state, i)
        if self.is_adaptive:
            blocks = state.blocks[r, 0]
            return set(blocks[self.core.resident_mask(state)[r, 0]].tolist())
        blocks = state.blocks[r]
        return set(blocks[blocks >= 0].tolist())

    def _advance_clock(self, tenant_rows: np.ndarray) -> None:
        """Tenant-altitude F (accesses) and R (clock of the last access)."""
        self._tf += np.bincount(tenant_rows, minlength=self.rows)
        last = np.full(self.rows, -1, dtype=np.int64)
        np.maximum.at(last, tenant_rows, np.arange(len(tenant_rows)))
        self._tr = np.where(last >= 0, self._tclock + last + 1, self._tr)
        self._tclock += len(tenant_rows)

    def access(self, tenant: str, key: int) -> Tuple[bool, List[int]]:
        """One access of ``key`` by ``tenant``: the stream launch with one
        access.  Returns ``(hit, evicted_keys)``; evicted keys are what the
        row's policy displaced, for payload-store coherence.  Mutates
        ``state`` / ``counters`` and the host mirrors; pulls the row's
        residency before and after, so it syncs the device every call (use
        ``access_stream`` for throughput)."""
        r = self.row(tenant)
        before = self._resident_ids(self.state, r)
        rows = np.array([r], dtype=np.int32)
        hit = bool(self._run_stream(rows, np.array([key], dtype=np.int32))[0])
        evicted = sorted(before - self._resident_ids(self.state, r))
        self._pull_pressure()
        self._advance_clock(rows)
        return hit, evicted

    def access_stream(self, tenant_rows: np.ndarray, keys: np.ndarray) -> np.ndarray:
        """Replay a whole interleaved stream on the device: access i is
        ``on_access_counted`` on row ``tenant_rows[i]`` alone, the pressure
        EWMA folded per access, so state and counters advance exactly as
        ``access`` would.  One launch, no host sync until the hits and the
        pressure plane are pulled at the end.  Returns the (T,) bool hits.
        Mutates ``state`` / ``counters`` and the host mirrors."""
        tenant_rows = np.asarray(tenant_rows, dtype=np.int32)
        keys = np.asarray(keys, dtype=np.int32)
        if tenant_rows.shape != keys.shape or tenant_rows.ndim != 1:
            raise ValueError(
                f"tenant_rows {tenant_rows.shape} and keys {keys.shape} must be "
                "equal-length 1-D arrays")
        if tenant_rows.size and not 0 <= tenant_rows.min() <= tenant_rows.max() < self.rows:
            raise ValueError(f"tenant rows must lie in [0, {self.rows})")
        hits = self._run_stream(tenant_rows, keys).cpu().numpy()
        self._pull_pressure()
        self._advance_clock(tenant_rows)
        return hits

    # -- signals ------------------------------------------------------------
    def accesses(self, tenant: str) -> int:
        """Host-side access count for ``tenant`` (the tenant-altitude F_t),
        no device sync."""
        return int(self._tf[self.row(tenant)])

    def pressure(self, tenant: str) -> float:
        """Eviction-pressure EWMA of ``tenant`` (evictions per access,
        weighted by ``pressure_alpha``), read from the host mirror."""
        return float(self._pressure[self.row(tenant)])

    def decay_pressure(self, tenant: str) -> float:
        """One EWMA step toward 0 without an access (``admission_decay`` on
        the tenant's row of the device plane); the serving engine calls it
        when it sheds, so refused work doubles as probation time.  Refreshes
        the mirror and returns the new value."""
        r = self.row(tenant)
        i, lr = self._local(r)
        counters = self._part(self.counters, i)
        mask = np.zeros(counters.pressure.shape[0], dtype=bool)
        mask[lr] = True
        self._put(i, counters=counters._replace(
            pressure=admission_decay(counters.pressure, mask, self.pressure_alpha)))
        self._pull_pressure()
        return float(self._pressure[r])

    def tenant_weights(self) -> Dict[str, float]:
        """Paper eq. (1) at tenant altitude: ``W_t = F_t / (N - R_t)``
        (never-accessed tenants weigh 0)."""
        out = {}
        for t in self.tenants:
            r = self.row(t)
            dt = max(self._tclock - self._tr[r], 1)
            out[t] = float(self._tf[r]) / float(dt) if self._tf[r] else 0.0
        return out

    def rank_tenants(self) -> List[str]:
        """Tenants coldest first (lowest weight; ties by row order), the
        order quota lanes are reclaimed in."""
        w = self.tenant_weights()
        return sorted(self.tenants, key=lambda t: (w[t], self.row(t)))

    # -- quota rebalancing (flat cores) -------------------------------------
    def _flat_keep_order(self, r: int) -> np.ndarray:
        """Occupied lanes of row ``r`` in eviction order (first = evicted
        first) under the row's own policy: the flat victim rule on the
        host."""
        i, r = self._local(r)
        st = self._part(self.state, i)
        blocks = st.blocks[r].cpu().numpy()
        f = st.f[r].cpu().numpy().astype(np.float64)
        rr = st.r[r].cpu().numpy().astype(np.float64)
        clock = float(st.clock[r])
        occ = np.where(blocks >= 0)[0]
        if self.policy_name == "awrp":
            # weights at clock N + 1, the clock every live decision is made at
            key = f[occ] / np.maximum((clock + 1.0) - rr[occ], 1.0)
            order = np.lexsort((occ, key))
        elif self.policy_name in ("lru", "fifo"):
            order = np.lexsort((occ, rr[occ]))
        else:  # lfu: min F, ties by recency then lane
            order = np.lexsort((occ, rr[occ], f[occ]))
        return occ[order]

    def rebalance(self, to: str, n: int = 1, *,
                  min_quota: int = 1) -> Tuple[int, Dict[str, List[int]]]:
        """Move up to ``n`` quota lanes to tenant ``to``, reclaiming them from
        the lowest-ranked tenants first (never below ``min_quota``, never from
        ``to``).  Shrunk rows evict their policy's worst blocks and compact
        the rest; each shrink's evictions fold into that row's pressure as
        one access evicting that many.  Returns ``(moved, evicted_by)``.
        Flat cores only."""
        if self.is_adaptive:
            raise NotImplementedError(
                "adaptive (arc/car) tenant quotas are fixed: ghost-directory "
                "invariants do not survive a capacity change")
        if n <= 0:
            raise ValueError(f"n must be positive, got {n}")
        moved, evicted_by = 0, {}
        for donor in self.rank_tenants():
            if donor == to:
                continue
            while moved < n and self.quotas[donor] > min_quota:
                self.quotas[donor] -= 1
                self.quotas[to] += 1
                moved += 1
            if moved >= n:
                break
        if moved == 0:
            return 0, {}
        old_ways = self.core.ways
        self._mount()
        for t in self.tenants:
            r = self.row(t)
            new_w = self.quotas[t]
            if new_w >= old_ways[r]:
                continue
            ev = self._shrink_flat_row(r, new_w)
            if ev:
                evicted_by[t] = ev
                # the reference's eager fold, op by op: (1 - a) * p + a * e
                i, lr = self._local(r)
                counters = self._part(self.counters, i)
                p = counters.pressure.clone()
                a, one = _f32(self.pressure_alpha, p), _f32(1.0, p)
                p[lr] = (one - a) * p[lr] + a * _f32(float(len(ev)), p)
                self._put(i, counters=counters._replace(pressure=p))
        self._pull_pressure()
        return moved, evicted_by

    def _shrink_flat_row(self, r: int, new_ways: int) -> List[int]:
        """Drop row ``r`` to ``new_ways`` live lanes: evict the policy's worst
        blocks (host replay of the flat victim rule), compact the survivors
        into lanes ``[0, new_ways)`` keeping lane order, clear the rest."""
        order = self._flat_keep_order(r)  # eviction order, worst first
        n_drop = max(len(order) - new_ways, 0)
        dropped, kept = order[:n_drop], np.sort(order[n_drop:])
        i, r = self._local(r)
        st = self._part(self.state, i)
        blocks, f, rr = (t[r].cpu().numpy() for t in (st.blocks, st.f, st.r))
        evicted = blocks[dropped].tolist()
        W = blocks.shape[0]
        planes = [np.full(W, -1, dtype=np.int32), np.zeros(W, dtype=np.int32),
                  np.zeros(W, dtype=np.int32)]
        k = len(kept)
        for new, old in zip(planes, (blocks, f, rr)):
            new[:k] = old[kept]
        out = []
        for plane, new in zip((st.blocks, st.f, st.r), planes):
            plane = plane.clone()
            plane[r] = torch.from_numpy(new).to(plane.device)
            out.append(plane)
        self._put(i, state=st._replace(blocks=out[0], f=out[1], r=out[2]))
        return evicted

    # -- telemetry ----------------------------------------------------------
    def row_metrics(self) -> Dict[str, torch.Tensor]:
        """The core's per-row accounting as ``(rows,)`` tensors, not
        pulled (under a mesh gathered on its first device, padding rows
        included)."""
        return self.core.row_telemetry(self.state, self.counters)

    def row_telemetry(self) -> Dict[str, np.ndarray]:
        """The core's per-row accounting pulled to the host with one
        synchronization: hits / misses / evictions / accesses / occupancy /
        capacity / pressure, each ``(rows,)``."""
        rows = self.row_metrics()
        return dict(zip(rows, _pull(list(rows.values()))))

    def telemetry(self) -> Dict[str, dict]:
        """Per-tenant stats dicts, the same keys for every tenant: the one
        code path the serving engine reports tenancy from."""
        rows = self.row_telemetry()
        out = {}
        for t in self.tenants:
            r = self.row(t)
            out[t] = {
                "policy": self.policy_name,
                "quota": self.quotas[t],
                "occupancy": int(rows["occupancy"][r]),
                "hits": int(rows["hits"][r]),
                "misses": int(rows["misses"][r]),
                "evictions": int(rows["evictions"][r]),
                "accesses": int(rows["accesses"][r]),
                "hit_ratio": safe_ratio(int(rows["hits"][r]), int(rows["accesses"][r])),
                "pressure": float(self._pressure[r]),
            }
        return out

    def drain_trace(self) -> np.ndarray:
        """The decision-trace ring on the host as a structured record array,
        oldest event first (``obs.decision_trace.drain``: one
        synchronization).  Needs ``ring_capacity > 0``."""
        if self.ring is None:
            raise ValueError(
                "decision tracing is off; construct the manager with ring_capacity > 0")
        if self.mesh is None:
            return dt.drain(self.ring)
        return dt.drain_shards(self.ring.shards, self._ring_log, self.ring.offsets)


@dataclasses.dataclass
class AdmissionController:
    """Pressure -> accept / defer / shed.

    ``defer_at`` and ``shed_at`` are thresholds on the manager's
    eviction-pressure EWMA; below ``warmup`` accesses a tenant is always
    accepted.  Deferred work is retried by the caller after the unpressured
    work; shed work is refused."""

    defer_at: float = 0.5
    shed_at: float = 0.85
    warmup: int = 8

    def __post_init__(self):
        if not 0.0 <= self.defer_at <= self.shed_at:
            raise ValueError(
                f"need 0 <= defer_at <= shed_at, got {self.defer_at} / {self.shed_at}")

    def decide(self, manager: TenantCacheManager, tenant: str) -> str:
        """One host-side decision for ``tenant`` from the pulled pressure
        mirror.  Read-only: the caller applies ``decay_pressure`` on shed."""
        if manager.accesses(tenant) < self.warmup:
            return ACCEPT
        p = manager.pressure(tenant)
        if p >= self.shed_at:
            return SHED
        if p >= self.defer_at:
            return DEFER
        return ACCEPT

    def decide_batch(self, manager: TenantCacheManager, tenants: List[str]) -> List[str]:
        """Admission for a whole request batch on the device pressure plane:
        ``admission_decide`` and the decay on shed, request by request, so
        later requests see the pressure decayed by earlier sheds, as the host
        loop of ``decide`` + ``decay_pressure`` does.  Mutates
        ``manager.counters.pressure`` (the sheds' decays) and refreshes the
        mirror; one pull of the codes at the end.  A tracing manager also
        records one ``KIND_ADMIT`` event per request (its row, the pressure
        before and after the request's decay, the ``ADMIT_*`` code); the
        decisions are the same either way."""
        rows = [manager.row(t) for t in tenants]
        if not rows:
            return []
        order = (ACCEPT, DEFER, SHED)  # indexed by ADMIT_* codes
        if manager.mesh is not None:
            return [order[c] for c in self._decide_sharded(manager, rows)]
        fn = _decide_batch_fn(self.defer_at, self.shed_at, self.warmup,
                              manager.pressure_alpha, manager.core.rows)
        ctr = manager.counters
        codes, new_p, manager.ring = fn(ctr.pressure, ctr.hits + ctr.misses, rows,
                                        manager.ring)
        manager.counters = ctr._replace(pressure=new_p)
        decisions = [order[c] for c in codes.tolist()]
        manager._pull_pressure()
        return decisions

    def _decide_sharded(self, manager: TenantCacheManager, rows: List[int]) -> List[int]:
        """``decide_batch`` on a sharded manager: each shard's requests, in
        order and on local rows, through the same loop on its device and
        stream (a request's decay touches its own row only); the codes in
        request order, with one pull per device."""
        mesh = manager.mesh
        where = [manager.state.locate(r) for r in rows]
        shard = np.array([i for i, _ in where], dtype=np.int32)
        fn = _decide_batch_fn(self.defer_at, self.shed_at, self.warmup,
                              manager.pressure_alpha, manager._core_rows // mesh.size)
        rings = (manager.ring.shards if manager.ring is not None else (None,) * mesh.size)

        def run(i, ctr, ring):
            local = [lr for j, lr in where if j == i]
            if not local:
                return None
            return fn(ctr.pressure, ctr.hits + ctr.misses, local, ring)

        outs = sharding.run_shards(mesh, run, manager.counters.shards, rings)
        counters, new_rings, codes = [], [], [None] * len(rows)
        for i, out in enumerate(outs):
            ctr = manager.counters.shards[i]
            counters.append(ctr if out is None else ctr._replace(pressure=out[1]))
            new_rings.append(rings[i] if out is None else out[2])
        manager.counters = manager.counters.replace(counters)
        if manager.ring is not None:
            manager.ring = manager.ring.replace(new_rings)
            manager._log_events(shard)
        pulled = _pull([out[0] for out in outs if out is not None])
        for i, got in zip([i for i, out in enumerate(outs) if out is not None], pulled):
            for slot, code in zip(np.flatnonzero(shard == i), got.tolist()):
                codes[slot] = code
        manager._pull_pressure()
        return codes


@functools.lru_cache(maxsize=None)
def _decide_batch_fn(defer_at, shed_at, warmup, alpha, rows):
    """The batch-admission loop, cached per (thresholds, alpha, rows): a
    short loop of torch ops carrying the pressure plane (a shed's decay is
    visible to every later request), returning the (n,) int32 codes, the
    final plane and the ring (None, or one ``KIND_ADMIT`` event pushed per
    request), none pulled."""

    def fn(pressure, accesses, req_rows: List[int], ring=None):
        lane = torch.arange(rows, device=pressure.device)
        one = torch.ones(1, dtype=torch.bool, device=pressure.device)
        p, codes = pressure, []
        for r in req_rows:
            code = admission_decide(p[r], accesses[r], defer_at=defer_at, shed_at=shed_at,
                                    warmup=warmup)
            p_new = admission_decay(p, (lane == r) & (code == ADMIT_SHED), alpha)
            if ring is not None:
                ev = dt.pack_events(1, kind=dt.KIND_ADMIT, row=r, key=-1, p_before=p[r],
                                    p_after=p_new[r], admit=code)
                ring = dt.ring_push(ring, ev, one)
            p = p_new
            codes.append(code)
        return torch.stack(codes), p, ring

    return fn


class TenantPrefixCache:
    """Per-tenant prefix/prompt cache over one ``TenantCacheManager`` row per
    tenant: quota-bounded payload stores whose residency is the row's
    resident set.  Exactly ONE policy access is issued per request, on the
    hit at ``lookup`` or on the miss at ``insert``, so the per-row counters
    reproduce a host oracle run on the demuxed per-tenant stream."""

    def __init__(self, quotas: Dict[str, int], policy: str = "awrp", **kw):
        self.manager = TenantCacheManager(quotas, policy, **kw)
        self.stores: Dict[str, Dict[int, Any]] = {t: {} for t in self.manager.tenants}

    def lookup(self, tenant: str, tokens) -> Optional[Any]:
        """Payload for this tenant and prompt, or None.  A hit issues the
        policy access; a miss mutates NOTHING (it is accounted when the
        caller inserts, so a shed request that never inserts leaves no
        trace)."""
        key = _prompt_key(tokens)
        store = self.stores[tenant]
        if key in store:
            self.manager.access(tenant, key)  # policy hit
            return store[key]
        return None

    def insert(self, tenant: str, tokens, payload: Any) -> None:
        """Store ``payload`` under the prompt's key: issues the miss-side
        policy access and drops the payloads the row's policy evicted."""
        key = _prompt_key(tokens)
        store = self.stores[tenant]
        _, evicted = self.manager.access(tenant, key)
        for ev in evicted:
            store.pop(ev, None)
        store[key] = payload

    def rebalance(self, to: str, n: int = 1, **kw) -> Tuple[int, Dict[str, List[int]]]:
        """Manager rebalance plus payload-store coherence for shrunk
        tenants."""
        moved, evicted_by = self.manager.rebalance(to, n, **kw)
        for t, keys in evicted_by.items():
            for k in keys:
                self.stores[t].pop(k, None)
        return moved, evicted_by

    def telemetry(self) -> Dict[str, dict]:
        """Manager telemetry plus each tenant's payload-store ``entries``."""
        out = self.manager.telemetry()
        for t, d in out.items():
            d["entries"] = len(self.stores[t])
        return out


def _prompt_key(tokens) -> int:
    """Non-negative int32 prompt key (the core's id planes are int32);
    ``% INT_MAX`` keeps INT_MAX itself free, the adaptive cores' never-seen
    probe id."""
    return prompt_key(tokens) % (2**31 - 1)
