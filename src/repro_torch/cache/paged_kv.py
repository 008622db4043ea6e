"""Paged KV cache with AWRP eviction and the true-adaptive ARC/CAR pool
(``repro/cache/paged_kv.py``).

A bounded pool of P pages (page_size tokens each) per (layer, sequence).
Page metadata mirrors the paper: frequency F_p, recency clock R_p, global
clock N; a page is *referenced* at a decode step when its attention mass is
at least tau = 1/num_resident_pages; on a pool-full allocation the victim is
``argmin W_p = F_p / (N - R_p)`` (eq. (1)), or the chosen baseline policy's
(``core/kv_policy.py`` ``page_victim``).

Differences from the reference, all deliberate:
* the pool's K/V tensors are updated IN PLACE (a token row written, a page
  zeroed on allocation); every other plane is replaced by a new tensor.  A
  caller that keeps an old pool must clone it (the serving engine's host
  loop clones prefix-cache payloads on insert and on hit; its graph loop
  copies them into the graph's own tree).

Rows mesh: ``init_pool`` / ``init_adaptive_pool`` take ``mesh=`` (a
``core.sharding`` rows mesh) and place the per-sequence batch axis across it
as a ``RowShards``; ``fused_decode_step`` / ``fused_adaptive_decode_step``
take ``mesh=`` and launch kernels 4 and 5 shard-locally, each shard's
sequences on its device and stream (the reference's ``_shard_wrap``): on a
sharded pool the outputs stay sharded; on a whole pool the shards are row
views of it and the outputs are gathered, the K/V written in place.  Like
the reference, a whole pool whose batch does not divide the mesh runs
unsharded.

The token index ``pos`` is a 0-d int32 tensor on the pool's device, shared
by the batch, as the reference's traced scalar.  Every page-boundary branch
is the reference's masked form (the allocation computed always and selected
by ``pos % page == 0``), so a decode step reads nothing back to the host and
a CUDA graph can capture it (``serve/engine.py``).

True-adaptive mode (``kv_policy`` in ``TRUE_ADAPTIVE_KV``): the pool carries
``policy_core.AdaptiveState`` planes per sequence (ghost directory, stamps,
the self-tuning ``p``) and evicts by the real ARC/CAR step functions.  Page
allocations are complete-miss accesses of the new page id, each decode
step's referenced pages are hit accesses in slot order.  Within one decode
page ids only grow, so ghost hits come from across requests: the serving
engine replays a re-prefill's page ids through the previous request's final
state (``reseed_from_ghosts``), which moves ``p``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core import sharding
from repro_torch.core.kv_policy import page_victim
from repro_torch.core.policy_core import (_TAG_B1, _TAG_B2, _TAG_T1, _TAG_T2,
                                          AdaptiveCore, AdaptiveState, first_min)
from repro_torch.device import resolve_device

__all__ = ["PagedPool", "init_pool", "allocate", "insert_token", "kv_positions",
           "referenced_pages", "score_planes", "score_update",
           "fused_decode_step", "full_cache_insert", "ring_insert",
           "ring_positions", "TRUE_ADAPTIVE_KV",
           "AdaptivePagedPool", "adaptive_core", "init_adaptive_pool",
           "seed_adaptive_state", "pool_telemetry", "replay_page_ids",
           "reseed_from_ghosts", "adaptive_allocate", "adaptive_hits",
           "adaptive_insert_token", "adaptive_score_update",
           "fused_adaptive_decode_step"]

#: kv_policy names served by the true-adaptive pool mode -> core policy
TRUE_ADAPTIVE_KV = {"arc_adaptive": "arc", "car_adaptive": "car"}


class PagedPool(NamedTuple):
    """Per-layer-per-sequence bounded KV pool (leading dims may add a
    ``(n_layers,)`` stack in front of ``B``)."""

    k: torch.Tensor  # (B, P, page, kvd)
    v: torch.Tensor  # (B, P, page, kvd)
    f: torch.Tensor  # (B, P) int32 — paper's F_i
    r: torch.Tensor  # (B, P) int32 — paper's R_i
    page_start: torch.Tensor  # (B, P) int32 token index of page start; -1 free
    clock: torch.Tensor  # (B,) int32 — paper's N
    open_slot: torch.Tensor  # (B,) int32 slot currently being written

    def clone(self) -> "PagedPool":
        return PagedPool(*(t.clone() for t in self))


def init_pool(batch: int, pages: int, page_size: int, kvd: int, dtype,
              *, device="cuda", mesh=None) -> PagedPool:
    """All-zeros pool, every page free (``page_start == -1``).  ``mesh`` (a
    ``core.sharding`` rows mesh) places the per-sequence batch axis across
    its devices instead, as a ``RowShards`` (batch must divide the mesh);
    decisions are identical because page references are sequence-local."""
    dev = resolve_device(device if mesh is None else mesh.devices[0])
    i32 = dict(dtype=torch.int32, device=dev)
    pool = PagedPool(
        k=torch.zeros((batch, pages, page_size, kvd), dtype=dtype, device=dev),
        v=torch.zeros((batch, pages, page_size, kvd), dtype=dtype, device=dev),
        f=torch.zeros((batch, pages), **i32),
        r=torch.zeros((batch, pages), **i32),
        page_start=torch.full((batch, pages), -1, **i32),
        clock=torch.zeros((batch,), **i32),
        open_slot=torch.zeros((batch,), **i32),
    )
    return sharding.shard_rows(None, pool, mesh)


def _scatter_new_token(pool: PagedPool, new_k, new_v, pos, page_size: int,
                       slot, f, r, page_start, clock, open_slot) -> PagedPool:
    """Write the token row at (slot, pos % page_size) in place, zeroing the
    page first on an allocation (a masked select); returns the pool with the
    given planes."""
    within = pos % page_size
    B = pool.k.shape[0]
    bidx = torch.arange(B, device=pool.k.device)
    sl = slot.long()
    fresh = within == 0
    pool.k[bidx, sl] = torch.where(fresh, 0, pool.k[bidx, sl])
    pool.v[bidx, sl] = torch.where(fresh, 0, pool.v[bidx, sl])
    row = within.long().expand(B)
    pool.k[bidx, sl, row] = new_k.to(pool.k.dtype)
    pool.v[bidx, sl, row] = new_v.to(pool.v.dtype)
    return PagedPool(pool.k, pool.v, f, r, page_start, clock, open_slot)


def allocate(f, r, page_start, clock, open_slot, pos, page: int, policy: str):
    """The page-boundary allocation: first free slot, else ``page_victim``
    with the open slot pinned; the chosen page is reset to F=1, R=N,
    page_start=pos (the paper's insert rule).  Computed at every step and
    selected where ``pos % page == 0``: between page boundaries the slot is
    the open slot and the planes are unchanged.  Returns ``(slot, f, r,
    page_start)``."""
    need = pos % page == 0
    iota = torch.arange(f.shape[1], dtype=torch.int32, device=f.device)[None]
    free = page_start < 0
    first_free = first_min(torch.where(free, 0, 1).to(torch.int32))
    victim = page_victim(policy, f, r, page_start, clock, iota == open_slot[:, None])
    slot = torch.where(need, torch.where(free.any(dim=-1), first_free, victim), open_slot)
    sel = (iota == slot[:, None]) & need
    return (slot,
            torch.where(sel, 1, f),
            torch.where(sel, clock[:, None], r),
            torch.where(sel, pos, page_start))


def insert_token(pool: PagedPool, new_k, new_v, pos, page_size: int,
                 policy: str = "awrp") -> PagedPool:
    """Write one token row (B, kvd) at ``pos`` (0-d int32); on a page
    boundary allocate, evicting by ``policy`` when the pool is full (paper
    insert rule: F=1, R=N).  A pool of DTensors (a placed decode step) goes
    to ``_placed_insert_token``."""
    from torch.distributed.tensor import DTensor

    if isinstance(pool.k, DTensor):
        return _placed_insert_token(pool, new_k, new_v, pos, page_size, policy)
    slot, f, r, page_start = allocate(pool.f, pool.r, pool.page_start,
                                      pool.clock, pool.open_slot, pos,
                                      page_size, policy)
    open_slot = slot.to(torch.int32)
    return _scatter_new_token(pool, new_k, new_v, pos, page_size, slot, f, r,
                              page_start, pool.clock, open_slot)


def _placed_insert_token(pool: PagedPool, new_k, new_v, pos, page_size: int,
                         policy: str) -> PagedPool:
    """``insert_token`` on a pool of DTensors (pages over the batch axes for
    a batch of 1, features over "model"): the allocation on the whole (B, P)
    planes (small; made whole on every shard, as the MoE routing), then each
    shard writes its own pages under ``local_map``: the row lands on the
    shard whose pages hold ``slot``, the others keep theirs (a masked
    select).  No K/V moves between shards; the planes keep their
    placements.  The same decisions as ``insert_token``."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.sharding.shards import local_box

    mesh = pool.k.device_mesh
    rep = [Replicate()] * mesh.ndim

    def whole(t):
        return t.redistribute(mesh, rep).to_local() if isinstance(t, DTensor) else t

    slot, f, r, page_start = allocate(whole(pool.f), whole(pool.r), whole(pool.page_start),
                                      whole(pool.clock), whole(pool.open_slot), whole(pos),
                                      page_size, policy)

    def placed(t, like):
        return DTensor.from_local(t, mesh, rep, run_check=False).redistribute(
            mesh, like.placements)

    kv_pl = list(pool.k.placements)
    # a (B, kvd) row and a (B,) slot take the pool's batch and feature splits
    row_pl = [Shard(0) if p == Shard(0) else Shard(1) if p == Shard(3) else Replicate()
              for p in kv_pl]
    slot_pl = [Shard(0) if p == Shard(0) else Replicate() for p in kv_pl]
    lo = local_box(pool.k.shape, mesh, kv_pl)[1][0]  # this shard's first page

    def write(k, v, nk, nv, sl, within):
        n = k.shape[1]
        loc = sl.long() - lo
        mine = (loc >= 0) & (loc < n)
        loc = loc.clamp(0, max(n - 1, 0))
        bidx = torch.arange(k.shape[0], device=k.device)
        row = within.long().expand(k.shape[0])
        fresh = (within == 0) & mine
        for cache, new in ((k, nk), (v, nv)):
            cache[bidx, loc] = torch.where(fresh[:, None, None], 0, cache[bidx, loc])
            cache[bidx, loc, row] = torch.where(mine[:, None], new.to(cache.dtype),
                                                cache[bidx, loc, row])
        return k, v

    args = (pool.k, pool.v,
            new_k.redistribute(mesh, row_pl), new_v.redistribute(mesh, row_pl),
            DTensor.from_local(slot, mesh, rep, run_check=False).redistribute(mesh, slot_pl),
            DTensor.from_local(whole(pos) % page_size, mesh, rep, run_check=False))
    k, v = local_map(write, out_placements=(kv_pl, kv_pl),
                     in_placements=(kv_pl, kv_pl, row_pl, row_pl, slot_pl, rep),
                     device_mesh=mesh)(*args)
    return PagedPool(k, v, placed(f, pool.f), placed(r, pool.r),
                     placed(page_start, pool.page_start), pool.clock,
                     placed(slot.to(torch.int32), pool.open_slot))


def kv_positions(pool: PagedPool, pos, page_size: int) -> torch.Tensor:
    """(B, P*page) token index per cache row; -1 for invalid rows."""
    B, P = pool.f.shape
    row = torch.arange(page_size, dtype=torch.int32, device=pool.f.device)
    tok = pool.page_start[..., None] + row
    valid = (pool.page_start[..., None] >= 0) & (tok <= pos)
    return torch.where(valid, tok, -1).reshape(B, P * page_size)


def _hit(page_mass, page_start) -> torch.Tensor:
    """Paper hit rule on pages: a resident page is referenced iff its
    attention mass >= tau = 1/resident_count (IEEE division)."""
    resident = (page_start >= 0).sum(dim=-1, keepdim=True).to(torch.float32)
    tau = 1.0 / torch.clamp(resident, min=1.0)
    return (page_mass >= tau) & (page_start >= 0)


def referenced_pages(pool: PagedPool, attn_mass, page_size: int) -> torch.Tensor:
    """The hit rule for (B, P*page) per-row softmax mass; (B, P) bool."""
    B, P = pool.f.shape
    return _hit(attn_mass.reshape(B, P, page_size).sum(dim=-1), pool.page_start)


def score_planes(page_mass, f, r, page_start, clock):
    """F += 1 and R = N + 1 on referenced pages, one clock tick; ``page_mass``
    is (B, P).  Returns ``(f', r', clock')``."""
    referenced = _hit(page_mass, page_start)
    clock_new = clock + 1
    return (torch.where(referenced, f + 1, f),
            torch.where(referenced, clock_new[:, None], r),
            clock_new)


def score_update(pool: PagedPool, attn_mass, page_size: int) -> PagedPool:
    """Apply the hit rule to (B, P*page) per-row mass: F += 1 and R = N on
    reference; one clock tick per decode step."""
    B, P = pool.f.shape
    f, r, clock = score_planes(attn_mass.reshape(B, P, page_size).sum(dim=-1),
                               pool.f, pool.r, pool.page_start, pool.clock)
    return pool._replace(f=f, r=r, clock=clock)


def _sharded(mesh, pool) -> bool:
    """Whether a fused step runs shard-locally: under a mesh, for a sharded
    pool or a whole one whose batch divides the mesh (the reference's
    ``_shard_wrap`` rule)."""
    if mesh is None:
        return False
    if isinstance(pool, sharding.RowShards):
        return True
    flat = pool.pool if isinstance(pool, AdaptivePagedPool) else pool
    return flat.f.shape[0] % mesh.size == 0


def _shard_step(step, mesh, pool, q, new_k, new_v, pos, *args):
    """``step(pool, q, new_k, new_v, pos, *args)`` (an unsharded fused
    step) on every shard of ``mesh``, each on its device and stream, ``pos``
    replicated.  A sharded pool gives sharded ``(out, mass, pool)``; a whole
    one is cut into row views, and the outputs are gathered on its device:
    the planes concatenated, the K/V written in place (copied back from a
    shard on another device)."""
    pools = sharding.split_rows(pool, mesh)
    rows = [sharding.split_rows(x, mesh) for x in (q, new_k, new_v)]
    pos_at = {d: pos.to(d) for d in mesh.distinct_devices}
    outs = sharding.run_shards(
        mesh, lambda i, pl, *x: step(pl, *x, pos_at[mesh.devices[i]], *args), pools, *rows)
    if isinstance(pool, sharding.RowShards):
        return tuple(pool.replace(o[j] for o in outs) for j in range(3))
    whole = pool.pool if isinstance(pool, AdaptivePagedPool) else pool
    k = len(outs[0][1])
    for i, (_, _, new) in enumerate(outs):
        part = new.pool if isinstance(new, AdaptivePagedPool) else new
        if part.k.device != whole.k.device:
            whole.k[i * k:(i + 1) * k].copy_(part.k)
            whole.v[i * k:(i + 1) * k].copy_(part.v)
    dev = whole.k.device

    def cat(parts):
        return torch.cat([p.to(dev) for p in parts])

    planes = PagedPool(whole.k, whole.v, *(cat([getattr(
        o[2].pool if isinstance(o[2], AdaptivePagedPool) else o[2], name) for o in outs])
        for name in PagedPool._fields[2:]))
    if isinstance(pool, AdaptivePagedPool):
        planes = AdaptivePagedPool(planes, AdaptiveState(
            *(cat(parts) for parts in zip(*(o[2].policy for o in outs)))))
    return cat([o[0] for o in outs]), cat([o[1] for o in outs]), planes


def fused_decode_step(pool: PagedPool, q, new_k, new_v, pos,
                      page_size: int, policy: str = "awrp", *, mesh=None
                      ) -> Tuple[torch.Tensor, torch.Tensor, PagedPool]:
    """One flat-policy decode step as one kernel call (kernel 4: two
    launches, ``ops.SPLIT_LAUNCHES``): equivalent to
    ``insert_token`` + ``ops.paged_attention`` + ``score_update``, with the
    policy arithmetic inside the attention kernel.  q (B, KVH, G, hd);
    new_k/new_v (B, kvd); ``pos`` 0-d int32, which the kernel reads from
    device memory.  Returns ``(out (B, KVH, G, hd), page_mass (B, P),
    new_pool)``; the pool's K/V are updated in place.  ``mesh`` launches
    the kernel shard-locally (``_shard_step``)."""
    from repro_torch.kernels import ops

    if _sharded(mesh, pool):
        return _shard_step(fused_decode_step, mesh, pool, q, new_k, new_v, pos,
                           page_size, policy)
    B, P = pool.f.shape
    KVH, G, hd = q.shape[1:]
    kp = pool.k.view(B, P, page_size, KVH, hd)
    vp = pool.v.view(B, P, page_size, KVH, hd)
    nk = new_k.reshape(B, KVH, hd).to(pool.k.dtype)
    nv = new_v.reshape(B, KVH, hd).to(pool.v.dtype)
    out, mass, slot, f2, r2, ps2, clock2, open2 = ops.policy_paged_attention(
        q, kp, vp, nk, nv, pos, pool.f, pool.r, pool.page_start, pool.clock,
        pool.open_slot, policy=policy)
    new_pool = _scatter_new_token(pool, nk.reshape(B, -1), nv.reshape(B, -1), pos,
                                  page_size, slot, f2, r2, ps2, clock2, open2)
    return out, mass, new_pool


def _write_row(cache, new, index) -> None:
    """``cache[:, index] = new[:, 0]`` in place, ``index`` a 0-d tensor.  On
    DTensors (a placed decode step), whose row dim is whole on every shard,
    each shard writes its own piece under ``local_map``."""
    from torch.distributed.tensor import DTensor, Shard

    idx = index.reshape(1).long()
    if not isinstance(cache, DTensor):
        cache.index_copy_(1, idx, new.to(cache.dtype))
        return
    from torch.distributed.tensor.experimental import local_map

    pl = list(cache.placements)
    if Shard(1) in pl:
        raise ValueError(f"a cache's row dim must be whole on every shard, placed {pl}")
    mesh = cache.device_mesh
    local_map(lambda c, n: c.index_copy_(1, idx, n.to(c.dtype)), out_placements=pl,
              in_placements=(pl, pl), device_mesh=mesh)(cache, new.redistribute(mesh, pl))


def full_cache_insert(k_cache, v_cache, new_k, new_v, pos):
    """Unbounded-cache baseline: write the token row (B, 1, kvd) at index
    ``pos`` (0-d int32) of (B, T, kvd), in place."""
    _write_row(k_cache, new_k, pos)
    _write_row(v_cache, new_v, pos)
    return k_cache, v_cache


def ring_insert(k_cache, v_cache, new_k, new_v, pos):
    """Sliding-window cache (B, W, kvd): write the token row (B, 1, kvd) at
    ring slot ``pos % W`` (evicting the token W steps back), in place."""
    slot = pos % k_cache.shape[1]
    _write_row(k_cache, new_k, slot)
    _write_row(v_cache, new_v, slot)
    return k_cache, v_cache


def ring_positions(pos, window: int) -> torch.Tensor:
    """(W,) int32 token index each ring slot holds after inserting ``pos``
    (0-d int32): the latest index <= pos congruent to the slot mod W, or
    -1."""
    slots = torch.arange(window, dtype=torch.int32, device=pos.device)
    cand = pos - torch.remainder(pos - slots, window)
    return torch.where(cand >= 0, cand, -1).to(torch.int32)


# ---------------------------------------------------------------------------
# true-adaptive (ARC/CAR) pool mode: AdaptiveState planes per sequence
# ---------------------------------------------------------------------------


class AdaptivePagedPool(NamedTuple):
    """Paged pool plus the policy core's ARC/CAR planes (leading dims may
    add a ``(n_layers,)`` stack in front of ``B``).  The pool's F/R/clock
    keep ticking for telemetry; eviction decisions come from ``policy``."""

    pool: PagedPool
    policy: AdaptiveState  # (B, 1, 2P) planes, (B, 1) p and ctr

    def clone(self) -> "AdaptivePagedPool":
        return AdaptivePagedPool(self.pool.clone(),
                                 AdaptiveState(*(t.clone() for t in self.policy)))


def adaptive_core(kv_policy: str, batch: int, pages: int, *,
                  masked_renorm: bool = False) -> AdaptiveCore:
    """The pool's policy core: one ARC/CAR instance per sequence, capacity
    the pool size.  Takes the serving names (``arc_adaptive`` /
    ``car_adaptive``) or the core names (``arc`` / ``car``);
    ``masked_renorm`` as ``AdaptiveCore``'s (the decode step's core)."""
    kind = TRUE_ADAPTIVE_KV.get(kv_policy, kv_policy)
    return AdaptiveCore(kind=kind, caps=(pages,) * batch, masked_renorm=masked_renorm)


def init_adaptive_pool(batch: int, pages: int, page_size: int, kvd: int, dtype,
                       kv_policy: str, *, device="cuda", mesh=None) -> AdaptivePagedPool:
    """Empty pool and freshly initialised ARC/CAR planes.  ``mesh`` (a
    ``core.sharding`` rows mesh) places the per-sequence pools across its
    devices, as a ``RowShards`` of ``AdaptivePagedPool``s."""
    apool = AdaptivePagedPool(
        pool=init_pool(batch, pages, page_size, kvd, dtype, device=device if mesh is None
                       else mesh.devices[0]),
        policy=adaptive_core(kv_policy, batch, pages).init(device=device if mesh is None
                                                           else mesh.devices[0]))
    return sharding.shard_rows(None, apool, mesh)


def seed_adaptive_state(batch: int, pages: int, first_page: int, n_res: int,
                        *, device="cuda") -> AdaptiveState:
    """``pool_from_prefill``'s seeding for the policy: the ``n_res`` resident
    pages (ids ``first_page..first_page+n_res-1``) as complete-miss inserts
    in order (all in T1, stamps in insertion order, ``p = 0``, no ghosts),
    the state the host ARC/CAR oracles reach on that access stream."""
    dev = resolve_device(device)
    L = 2 * pages
    lane = torch.arange(L, dtype=torch.int32, device=dev)
    res = lane < n_res

    def one_seq(a):
        return a.to(torch.int32).expand(batch, 1, L).contiguous()

    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return AdaptiveState(
        blocks=one_seq(torch.where(res, first_page + lane, -1)),
        tag=one_seq(torch.where(res, _TAG_T1, zero)),
        stamp=one_seq(torch.where(res, lane + 1, zero)),
        ref=torch.zeros((batch, 1, L), dtype=torch.int32, device=dev),
        p=torch.zeros((batch, 1), dtype=torch.float32, device=dev),
        ctr=torch.full((batch, 1), n_res, dtype=torch.int32, device=dev))


def pool_telemetry(state: AdaptiveState) -> Dict[str, torch.Tensor]:
    """The self-tuning ``p`` (mean and max over rows) and the mean resident
    pages of a persisted policy state, as 0-d tensors, not pulled.  Takes
    ``(B, 1, L)`` and stacked ``(n_rep, B, 1, L)`` planes alike."""
    resident = (state.tag == _TAG_T1) | (state.tag == _TAG_T2)
    return {"p_mean": state.p.mean(), "p_max": state.p.amax(),
            "resident_mean": resident.sum(dim=-1).to(torch.float32).mean()}


# -- ghost-hit feed: cross-request re-references ----------------------------


def _flatten_adaptive(state: AdaptiveState):
    """Collapse the leading dims to one rows axis: planes ``(..., 1, L) ->
    (R, 1, L)``.  Single-set planes (the serving pools') only."""
    lead = tuple(state.p.shape[:-1])
    if state.p.shape[-1] != 1:
        raise ValueError(f"expected single-set planes, got p shape {tuple(state.p.shape)}")
    L = state.blocks.shape[-1]
    R = int(np.prod(lead)) if lead else 1
    flat = AdaptiveState(*(t.reshape(R, 1, L) for t in state[:4]),
                         p=state.p.reshape(R, 1), ctr=state.ctr.reshape(R, 1))
    return flat, lead, L


def _unflatten_adaptive(flat: AdaptiveState, lead, L: int) -> AdaptiveState:
    return AdaptiveState(*(t.reshape(lead + (1, L)) for t in flat[:4]),
                         p=flat.p.reshape(lead + (1,)),
                         ctr=flat.ctr.reshape(lead + (1,)))


def replay_page_ids(state: AdaptiveState, kind: str, pages: int, page_ids
                    ) -> Tuple[AdaptiveState, torch.Tensor]:
    """Replay ``page_ids`` in order through a persisted state, one real
    ``on_access`` each on the state's device, so ghost hits move ``p`` with
    the host oracles' arithmetic.  Takes ``(B, 1, L)`` and stacked
    ``(n_rep, B, 1, L)`` planes.  Returns ``(new_state, ghost_hits)``, the
    hits counted per row (int32, leading dims kept)."""
    flat, lead, L = _flatten_adaptive(state)
    R = flat.p.shape[0]
    dev = flat.blocks.device
    core = AdaptiveCore(kind=TRUE_ADAPTIVE_KV.get(kind, kind), caps=(pages,) * R)
    ghosts = torch.zeros((R,), dtype=torch.int32, device=dev)
    for pid in (int(x) for x in page_ids):
        ghost = ((flat.blocks[:, 0] == pid)
                 & ((flat.tag[:, 0] == _TAG_B1) | (flat.tag[:, 0] == _TAG_B2)))
        ghosts += ghost.any(dim=-1).to(torch.int32)
        flat, _ = core.on_access(flat, torch.full((R,), pid, dtype=torch.int32,
                                                  device=dev))
    return _unflatten_adaptive(flat, lead, L), ghosts.reshape(lead)


def reseed_from_ghosts(prev: AdaptiveState, kind: str, pages: int, n_have: int,
                       n_res: int) -> Tuple[AdaptiveState, np.ndarray]:
    """Cross-request reseed of the pool policy: replay the re-prefill's page
    stream (ids ``0..n_have-1``) through the previous request's final state
    (previously evicted pages ghost-hit and move ``p``), then rebuild the
    residency of the freshly seeded pool (its last ``n_res`` pages):

    * target pages resident after the replay keep their list, stamp and
      reference bit;
    * target pages the replay evicted re-enter as fresh T1 inserts;
    * other residents are demoted to their ghost list at the MRU end;
    * ghost lists are trimmed LRU-first to ``|T1|+|B1| <= c`` and a total of
      at most ``2c``.

    Host numpy after the replay: a request-boundary operation.  Returns
    ``(state on prev's device, ghost_hits per row)``."""
    replayed, ghost_hits = replay_page_ids(prev, kind, pages, range(n_have))
    flat, lead, L = _flatten_adaptive(replayed)
    dev = flat.blocks.device
    blocks = flat.blocks[:, 0].cpu().numpy()
    tag = flat.tag[:, 0].cpu().numpy()
    stamp = flat.stamp[:, 0].cpu().numpy()
    ref = flat.ref[:, 0].cpu().numpy()
    p = flat.p[:, 0].cpu().numpy()
    R = blocks.shape[0]
    cap = pages
    target = set(range(n_have - n_res, n_have))

    nb = np.full((R, L), -1, dtype=np.int32)
    nt = np.zeros((R, L), dtype=np.int32)
    ns = np.zeros((R, L), dtype=np.int32)
    nf = np.zeros((R, L), dtype=np.int32)
    nctr = np.zeros(R, dtype=np.int32)
    for r in range(R):
        res, ghosts, demoted = [], [], []  # (id, tag, stamp, ref)
        for lane in range(L):
            t = int(tag[r, lane])
            if t == 0:
                continue
            bid, st_, rf = int(blocks[r, lane]), int(stamp[r, lane]), int(ref[r, lane])
            if t in (_TAG_T1, _TAG_T2):
                if bid in target:
                    res.append((bid, t, st_, rf))
                else:  # the pool dropped it: demote to its ghost list
                    demoted.append((bid, _TAG_B1 if t == _TAG_T1 else _TAG_B2, st_, 0))
            elif bid not in target:  # a ghost survives unless re-resident
                ghosts.append((bid, t, st_, 0))
        hi = max([e[2] for e in res + ghosts + demoted], default=0)
        for bid, t, _, _ in sorted(demoted, key=lambda e: e[2]):
            hi += 1
            ghosts.append((bid, t, hi, 0))
        for pid in sorted(target - {e[0] for e in res}):
            hi += 1
            res.append((pid, _TAG_T1, hi, 0))

        def count(entries, *tags):
            return sum(1 for e in entries if e[1] in tags)

        while count(res, _TAG_T1) + count(ghosts, _TAG_B1) > cap:
            b1 = [e for e in ghosts if e[1] == _TAG_B1]
            ghosts.remove(min(b1, key=lambda e: e[2]))
        while len(res) + len(ghosts) > 2 * cap:
            b2 = [e for e in ghosts if e[1] == _TAG_B2]
            if not b2:
                b2 = [e for e in ghosts if e[1] == _TAG_B1]
            ghosts.remove(min(b2, key=lambda e: e[2]))
        for lane, (bid, t, st_, rf) in enumerate(res + ghosts):
            nb[r, lane], nt[r, lane], ns[r, lane], nf[r, lane] = bid, t, st_, rf
        nctr[r] = hi

    def plane(a):
        return torch.from_numpy(a)[:, None].to(dev)

    out = AdaptiveState(plane(nb), plane(nt), plane(ns), plane(nf),
                        p=torch.from_numpy(p.astype(np.float32))[:, None].to(dev),
                        ctr=torch.from_numpy(nctr)[:, None].to(dev))
    return (_unflatten_adaptive(out, lead, L),
            ghost_hits.cpu().numpy().reshape(lead if lead else (1,)))


# -- the adaptive decode step ----------------------------------------------


def adaptive_allocate(core: AdaptiveCore, state: AdaptiveState, f, r, page_start,
                      clock, open_slot, pos, page: int):
    """The page-boundary allocation of the true-adaptive pool: one
    complete-miss access of the new page id; the page the policy's REPLACE
    moved out of the cache (resident before, not after; the largest id if
    several) gives up its pool slot, else the first free slot is taken.  The
    slot gets F=1, R=N, page_start=pos.  As in the reference, the access is
    issued at every step with the core's ``active`` mask set where ``pos %
    page == 0``: between page boundaries only the stamp renormalization
    check, which ``AdaptiveCore.on_access`` runs before the mask, changes
    the state, and the slot is the open slot.  Returns ``(slot, f, r,
    page_start, state)``."""
    B = f.shape[0]
    dev = f.device
    need = pos % page == 0
    ids = (pos // page).expand(B)
    new_state, _ = core.on_access(state, ids, active=need.expand(B))
    evicted = core.resident_mask(state)[:, 0] & ~core.resident_mask(new_state)[:, 0]
    ev_id = torch.where(evicted, state.blocks[:, 0], -1).amax(dim=-1)
    pool_pid = torch.where(page_start >= 0, page_start // page, -2)
    victim = first_min(torch.where(pool_pid == ev_id[:, None], 0, 1).to(torch.int32))
    first_free = first_min(torch.where(page_start < 0, 0, 1).to(torch.int32))
    slot = torch.where(need, torch.where(ev_id >= 0, victim, first_free), open_slot)
    iota = torch.arange(f.shape[1], dtype=torch.int32, device=dev)[None]
    sel = (iota == slot[:, None]) & need
    return (slot, torch.where(sel, 1, f), torch.where(sel, clock[:, None], r),
            torch.where(sel, pos, page_start), new_state)


def adaptive_hits(core: AdaptiveCore, state: AdaptiveState, page_start,
                  referenced, page: int) -> AdaptiveState:
    """Each referenced page (B, P) bool is one policy hit access, issued in
    slot order: P masked ``on_access`` calls (hits never evict)."""
    page_ids = torch.where(page_start >= 0, page_start // page, 0)
    for s in range(page_start.shape[1]):
        state, _ = core.on_access(state, page_ids[:, s], active=referenced[:, s])
    return state


def adaptive_insert_token(apool: AdaptivePagedPool, new_k, new_v, pos,
                          page_size: int, core: AdaptiveCore) -> AdaptivePagedPool:
    """``insert_token`` with true ARC/CAR eviction (``adaptive_allocate``);
    the pool's K/V are written in place."""
    pool, state = apool
    slot, f, r, page_start, state = adaptive_allocate(
        core, state, pool.f, pool.r, pool.page_start, pool.clock, pool.open_slot,
        pos, page_size)
    pool = _scatter_new_token(pool, new_k, new_v, pos, page_size, slot, f, r,
                              page_start, pool.clock, slot.to(torch.int32))
    return AdaptivePagedPool(pool, state)


def adaptive_score_update(apool: AdaptivePagedPool, attn_mass, page_size: int,
                          core: AdaptiveCore) -> AdaptivePagedPool:
    """``score_update`` (F/R/clock telemetry) plus ARC/CAR bookkeeping: every
    referenced page (mass >= 1/residents) is one hit access, in slot order
    (``adaptive_hits``).  ``attn_mass`` is the (B, P*page) per-row mass."""
    pool, state = apool
    referenced = referenced_pages(pool, attn_mass, page_size)
    state = adaptive_hits(core, state, pool.page_start, referenced, page_size)
    return AdaptivePagedPool(score_update(pool, attn_mass, page_size), state)


def fused_adaptive_decode_step(apool: AdaptivePagedPool, q, new_k, new_v, pos,
                               page_size: int, core: AdaptiveCore, *, mesh=None):
    """One true-adaptive decode step as one kernel call (kernel 5: two
    launches, ``ops.SPLIT_LAUNCHES``): equivalent to
    ``adaptive_insert_token`` + ``ops.paged_attention`` +
    ``adaptive_score_update``, with the P+1 policy accesses inside the
    attention kernel.  Returns ``(out, page_mass, new_apool)``; the pool's
    K/V are updated in place.  ``mesh`` launches the kernel shard-locally
    (``_shard_step``; ``core`` is per sequence, so every shard uses it)."""
    from repro_torch.kernels import ops

    if _sharded(mesh, apool):
        return _shard_step(fused_adaptive_decode_step, mesh, apool, q, new_k, new_v, pos,
                           page_size, core)
    pool, st = apool
    B, P = pool.f.shape
    KVH, G, hd = q.shape[1:]
    kp = pool.k.view(B, P, page_size, KVH, hd)
    vp = pool.v.view(B, P, page_size, KVH, hd)
    nk = new_k.reshape(B, KVH, hd).to(pool.k.dtype)
    nv = new_v.reshape(B, KVH, hd).to(pool.v.dtype)
    (out, mass, slot, f2, r2, ps2, clock2, open2,
     blk2, tag2, stp2, ref2, p2, ctr2) = ops.adaptive_policy_paged_attention(
        q, kp, vp, nk, nv, pos, pool.f, pool.r, pool.page_start, pool.clock,
        pool.open_slot, st.blocks[:, 0], st.tag[:, 0], st.stamp[:, 0],
        st.ref[:, 0], st.p[:, 0], st.ctr[:, 0], kind=core.kind,
        renorm_at=core.renorm_at)
    new_pool = _scatter_new_token(pool, nk.reshape(B, -1), nv.reshape(B, -1), pos,
                                  page_size, slot, f2, r2, ps2, clock2, open2)
    state = AdaptiveState(blk2[:, None], tag2[:, None], stp2[:, None],
                          ref2[:, None], p2[:, None], ctr2[:, None])
    return out, mass, AdaptivePagedPool(new_pool, state)
