"""Paged KV cache with AWRP eviction (the classic pool of
``repro/cache/paged_kv.py``).

A bounded pool of P pages (page_size tokens each) per (layer, sequence).
Page metadata mirrors the paper: frequency F_p, recency clock R_p, global
clock N; a page is *referenced* at a decode step when its attention mass is
at least tau = 1/num_resident_pages; on a pool-full allocation the victim is
``argmin W_p = F_p / (N - R_p)`` (eq. (1)), or the chosen baseline policy's
(``core/kv_policy.py`` ``page_victim``).

Differences from the reference, all deliberate:
* the pool's K/V tensors are updated IN PLACE (a token row written, a page
  zeroed on allocation); every other plane is replaced by a new tensor.  A
  caller that keeps an old pool must clone it (the serving engine clones
  prefix-cache payloads on insert and on hit);
* the token index ``pos`` is a Python int (the engine knows it on the host),
  shared by the batch;
* no ``mesh`` (XLA layout hints) and no true-adaptive ARC/CAR mode yet.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core.kv_policy import page_victim
from repro_torch.core.policy_core import first_min
from repro_torch.device import resolve_device

__all__ = ["PagedPool", "init_pool", "allocate", "insert_token", "kv_positions",
           "referenced_pages", "score_planes", "score_update",
           "fused_decode_step", "full_cache_insert"]


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
              *, device="cuda") -> PagedPool:
    """All-zeros pool, every page free (``page_start == -1``)."""
    dev = resolve_device(device)
    i32 = dict(dtype=torch.int32, device=dev)
    return PagedPool(
        k=torch.zeros((batch, pages, page_size, kvd), dtype=dtype, device=dev),
        v=torch.zeros((batch, pages, page_size, kvd), dtype=dtype, device=dev),
        f=torch.zeros((batch, pages), **i32),
        r=torch.zeros((batch, pages), **i32),
        page_start=torch.full((batch, pages), -1, **i32),
        clock=torch.zeros((batch,), **i32),
        open_slot=torch.zeros((batch,), **i32),
    )


def _scatter_new_token(pool: PagedPool, new_k, new_v, pos: int, page_size: int,
                       slot, f, r, page_start, clock, open_slot) -> PagedPool:
    """Write the token row at (slot, pos % page_size) in place, zeroing the
    page first on an allocation; returns the pool with the given planes."""
    within = pos % page_size
    bidx = torch.arange(pool.k.shape[0], device=pool.k.device)
    sl = slot.long()
    if within == 0:
        pool.k[bidx, sl] = 0
        pool.v[bidx, sl] = 0
    pool.k[bidx, sl, within] = new_k.to(pool.k.dtype)
    pool.v[bidx, sl, within] = new_v.to(pool.v.dtype)
    return PagedPool(pool.k, pool.v, f, r, page_start, clock, open_slot)


def allocate(f, r, page_start, clock, open_slot, pos: int, page: int, policy: str):
    """The page-boundary allocation: first free slot, else ``page_victim``
    with the open slot pinned; the chosen page is reset to F=1, R=N,
    page_start=pos (the paper's insert rule).  Returns ``(slot, f, r,
    page_start)``, the planes unchanged between page boundaries."""
    if pos % page:
        return open_slot, f, r, page_start
    iota = torch.arange(f.shape[1], dtype=torch.int32, device=f.device)[None]
    free = page_start < 0
    first_free = first_min(torch.where(free, 0, 1).to(torch.int32))
    victim = page_victim(policy, f, r, page_start, clock, iota == open_slot[:, None])
    slot = torch.where(free.any(dim=-1), first_free, victim)
    sel = iota == slot[:, None]
    return (slot,
            torch.where(sel, 1, f),
            torch.where(sel, clock[:, None], r),
            torch.where(sel, pos, page_start))


def insert_token(pool: PagedPool, new_k, new_v, pos: int, page_size: int,
                 policy: str = "awrp") -> PagedPool:
    """Write one token row (B, kvd); on a page boundary allocate, evicting by
    ``policy`` when the pool is full (paper insert rule: F=1, R=N)."""
    slot, f, r, page_start = allocate(pool.f, pool.r, pool.page_start,
                                      pool.clock, pool.open_slot, pos,
                                      page_size, policy)
    open_slot = slot.to(torch.int32)
    return _scatter_new_token(pool, new_k, new_v, pos, page_size, slot, f, r,
                              page_start, pool.clock, open_slot)


def kv_positions(pool: PagedPool, pos: int, page_size: int) -> torch.Tensor:
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


def fused_decode_step(pool: PagedPool, q, new_k, new_v, pos: int,
                      page_size: int, policy: str = "awrp"
                      ) -> Tuple[torch.Tensor, torch.Tensor, PagedPool]:
    """One flat-policy decode step as a single kernel launch: equivalent to
    ``insert_token`` + ``ops.paged_attention`` + ``score_update``, with the
    policy arithmetic inside the attention kernel.  q (B, KVH, G, hd);
    new_k/new_v (B, kvd).  Returns ``(out (B, KVH, G, hd), page_mass (B, P),
    new_pool)``; the pool's K/V are updated in place."""
    from repro_torch.kernels import ops

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


def full_cache_insert(k_cache, v_cache, new_k, new_v, pos: int):
    """Unbounded-cache baseline: write the token row (B, 1, kvd) at index
    ``pos`` of (B, T, kvd), in place."""
    k_cache[:, pos:pos + 1] = new_k
    v_cache[:, pos:pos + 1] = new_v
    return k_cache, v_cache
