"""Serving engine: prefill -> decode over AWRP-managed caches
(``repro/serve/engine.py`` without the jitted decode loop and the obs
registry).

  * length-bucketed batching: requests with equal page-aligned prompt
    lengths run together, sharing one token position per step;
  * prompt cache: exact-match prefix reuse through ``PrefixCache``
    (``prefix_policy``, AWRP by default); a hit skips prefill.  Decoding
    updates the caches in place, so stored payloads are cloned on insert and
    again on every hit;
  * multi-tenant mode: ``tenants={name: quota}`` mounts the prompt cache as
    one policy-core row per tenant (``serve/tenancy.py``) with per-tenant
    accounting, an eviction-pressure admission controller (accept / defer /
    shed, decided on the device pressure plane by ``decide_batch``) and
    optional AWRP-ranked quota rebalancing (``auto_rebalance``).  A shed
    request touches no cache, counter or session;
  * bounded-KV mode: ``kv_mode="paged"`` serves in a fixed page pool with
    the paper's eviction rule (``cfg.kv_policy``, including the true-adaptive
    ``arc_adaptive`` / ``car_adaptive`` pool mode); ``fused=True`` runs each
    paged layer's decode step as one CUDA launch
    (``kernels/csrc/policy_attn.cu``, ``adaptive_attn.cu``);
  * ghost-hit feed: in the true-adaptive mode the engine keeps the final
    pool policy state of every adaptive cache position (gemma3: its global
    layers' ``u5``) of the last single request and, on a prefix-cache miss,
    replays the new prompt's page ids through each
    (``paged_kv.reseed_from_ghosts``): previously evicted pages ghost-hit and
    move ARC/CAR's ``p`` across requests.  One session per tenant (the
    single-tenant engine's is ``"default"``);
  * expert cache: ``expert_cache=`` carries an MoE model's
    ``ExpertCacheRuntime`` and mounts its stats under ``expert/...``; nothing
    feeds the router into it yet (in the reference neither);
  * the decode loop is a plain Python loop: one ``decode_step`` per token,
    tokens stay on the device until the bucket ends.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import torch

from repro_torch.cache import paged_kv
from repro_torch.cache.prefix_cache import PrefixCache
from repro_torch.core.policy_core import AdaptiveState
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.serve.sampling import sample
from repro_torch.serve.tenancy import DEFER, SHED, AdmissionController, TenantPrefixCache


@dataclasses.dataclass
class Request:
    """One generation request: ``prompt`` token ids (page-aligned by the
    engine), a decode budget, a sampling temperature, and the ``tenant_id``
    admission and quota accounting charge it to (ignored by single-tenant
    engines)."""

    rid: int
    prompt: List[int]
    max_new_tokens: int = 16
    temperature: float = 0.0
    tenant_id: str = "default"


@dataclasses.dataclass
class Result:
    """Outcome of one request.  ``status``: ``"ok"`` ran in the first pass,
    ``"deferred"`` ran after the unpressured work (tokens and counters as an
    ``"ok"`` run of the same stream), ``"shed"`` was refused: no tokens, and
    no cache or tenancy state touched on its behalf."""

    rid: int
    tokens: List[int]
    prefill_cached: bool
    latency_s: float
    status: str = "ok"  # "ok" | "deferred" | "shed"


class ServeEngine:
    """Batched generation over AWRP-managed caches on one device.

    ``stats`` counts prefills, decode steps and tokens, the KV evictions
    (page allocations made while a sequence's pool was full, summed over
    layers and sequences), the ghost hits of the true-adaptive pool's
    cross-request feed, logits that were not finite, the host-clock seconds
    of prefill and decode (each ends in a device synchronize), and the
    multi-tenant engine's shed and deferred requests and rebalanced quota
    lanes.

    ``prefix_policy`` is a policy name or a prebuilt host policy (through
    ``make_cache_policy``) for the single-tenant prompt cache, a device
    policy name (awrp/lru/fifo/lfu/arc/car) for the tenants' core."""

    def __init__(self, cfg, params, *, max_len: int = 512, kv_mode: str = "full",
                 prefix_cache_entries: int = 8, prefix_policy="awrp", seed: int = 0,
                 tenants: Optional[Dict[str, int]] = None,
                 admission: Optional[AdmissionController] = None,
                 auto_rebalance: bool = False, fused: bool = False, expert_cache=None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.kv_mode = kv_mode
        self.fused = bool(fused)
        self.tenants = dict(tenants) if tenants else None
        self.auto_rebalance = bool(auto_rebalance)
        self.expert_cache = expert_cache
        if self.tenants is None:
            self.prefix_cache = PrefixCache(prefix_cache_entries, prefix_policy)
            self.tenant_cache = None
            self.admission = None
        else:
            self.prefix_cache = None
            self.tenant_cache = TenantPrefixCache(self.tenants, prefix_policy,
                                                  device=self.device)
            self.admission = admission or AdmissionController()
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.stats = {"prefills": 0, "decode_steps": 0, "tokens": 0,
                      "kv_evictions": 0, "kv_ghost_hits": 0,
                      "nonfinite_logits": 0, "prefill_s": 0.0, "decode_s": 0.0,
                      "shed": 0, "deferred": 0, "rebalances": 0}
        #: ghost-hit feed, per tenant: the tenant's last single request's
        #: final pool policy state of each adaptive position (stacked over
        #: layers), and the ghost hits its re-prefills replayed
        self._kv_sessions: Dict[str, Dict[str, AdaptiveState]] = {}
        self._kv_ghost_hits: Dict[str, int] = {}

    # -- internals ----------------------------------------------------------
    def _align(self, prompt: List[int]) -> List[int]:
        """Page-align by left-trimming (left-padding a prompt shorter than a
        page)."""
        page = self.cfg.page_size
        n = max((len(prompt) // page) * page, page)
        if len(prompt) < page:
            prompt = [0] * (page - len(prompt)) + prompt
        return prompt[-n:]

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _prefill(self, prompts: List[List[int]]):
        tokens = torch.tensor(prompts, dtype=torch.int32, device=self.device)
        t0 = time.perf_counter()
        logits, caches = M.prefill(self.params, self.cfg, tokens, self.max_len,
                                   kv_mode=self.kv_mode)
        self._sync()
        self.stats["prefill_s"] += time.perf_counter() - t0
        self.stats["prefills"] += 1
        # a copy of the last position, so the (B, S, V) logits are freed
        return logits[:, -1:].clone(), caches

    def _evictions_at(self, caches) -> torch.Tensor:
        """Allocations the next step makes into a full pool, summed over the
        pool positions (0-d tensor, not pulled)."""
        total = torch.zeros((), dtype=torch.int64, device=self.device)
        if self.kv_mode != "paged" or caches["pos"] % self.cfg.page_size:
            return total
        for pool in caches["blocks"].values():
            if isinstance(pool, paged_kv.AdaptivePagedPool):
                pool = pool.pool
            if isinstance(pool, paged_kv.PagedPool):
                total = total + (pool.page_start >= 0).all(dim=-1).sum()
        return total

    # -- ghost-hit feed (true-adaptive paged KV) ---------------------------
    @property
    def _ghost_feed_on(self) -> bool:
        return (self.kv_mode == "paged"
                and self.cfg.kv_policy in paged_kv.TRUE_ADAPTIVE_KV)

    def _kv_reseed(self, caches, tenant: str, plen: int):
        """On a re-prefill, replay the prompt's page ids through the tenant's
        persisted pool policy state: previously evicted pages ghost-hit and
        move ``p``; the rebuilt state seeds the new pool."""
        prev_session = self._kv_sessions.get(tenant)
        if prev_session is None:
            return caches
        page, P = self.cfg.page_size, self.cfg.bounded_kv_pages
        n_have = plen // page
        blocks = dict(caches["blocks"])
        for name, prev in prev_session.items():
            state, gh = paged_kv.reseed_from_ghosts(
                prev, self.cfg.kv_policy, P, n_have, min(n_have, P))
            n = int(gh.sum())
            self.stats["kv_ghost_hits"] += n
            self._kv_ghost_hits[tenant] = self._kv_ghost_hits.get(tenant, 0) + n
            blocks[name] = paged_kv.AdaptivePagedPool(blocks[name].pool, state)
        return {"pos": caches["pos"], "blocks": blocks}

    def _kv_persist(self, caches, tenant: str) -> None:
        """Keep the request's final pool policy states (ghost lists, ``p``),
        one per adaptive position, for the tenant's next re-prefill to replay
        into."""
        states = {name: AdaptiveState(*(t.clone() for t in c.policy))
                  for name, c in caches["blocks"].items()
                  if isinstance(c, paged_kv.AdaptivePagedPool)}
        if states:
            self._kv_sessions[tenant] = states

    # -- prefix cache and tenancy -------------------------------------------
    def _lookup_prefix(self, req: Request):
        if self.tenants is None:
            return self.prefix_cache.lookup(req.prompt)
        return self.tenant_cache.lookup(req.tenant_id, req.prompt)

    def _insert_prefix(self, req: Request, payload) -> None:
        if self.tenants is None:
            self.prefix_cache.insert(req.prompt, payload)
        else:
            self.tenant_cache.insert(req.tenant_id, req.prompt, payload)
            self._maybe_rebalance(req.tenant_id)

    def _maybe_rebalance(self, tenant: str) -> None:
        """AWRP-ranked quota rebalancing: when a tenant's pressure reaches the
        defer threshold, move one quota lane to it from the coldest tenant
        (flat prefix policies only; adaptive quotas are fixed)."""
        if not (self.auto_rebalance and self.tenants is not None):
            return
        mgr = self.tenant_cache.manager
        if mgr.is_adaptive or mgr.pressure(tenant) < self.admission.defer_at:
            return
        if mgr.rank_tenants()[0] == tenant:
            return
        moved, _ = self.tenant_cache.rebalance(tenant, 1)
        self.stats["rebalances"] += moved

    def _admit(self, requests: List[Request]) -> List[str]:
        """Admission decisions for ``requests`` in order, with the decay on
        shed applied: ``decide_batch`` on the device pressure plane (the
        reference's default route)."""
        return self.admission.decide_batch(self.tenant_cache.manager,
                                           [r.tenant_id for r in requests])

    def _run_bucket(self, plen: int, reqs: List[Request]) -> Dict[int, Result]:
        t0 = time.perf_counter()
        max_new = max(r.max_new_tokens for r in reqs)
        single = len(reqs) == 1
        cached = self._lookup_prefix(reqs[0]) if single else None
        if cached is not None:
            logits, caches = cached[0], M.clone_caches(cached[1])
        else:
            logits, caches = self._prefill([r.prompt for r in reqs])
            if single:
                if self._ghost_feed_on:
                    # a prefix miss re-references page positions the tenant's
                    # previous request's pool may have evicted
                    caches = self._kv_reseed(caches, reqs[0].tenant_id, plen)
                self._insert_prefix(reqs[0], (logits, M.clone_caches(caches)))

        temperature = reqs[0].temperature
        t1 = time.perf_counter()
        nonfinite = (~torch.isfinite(logits)).sum()
        evictions = torch.zeros((), dtype=torch.int64, device=self.device)
        tok = sample(logits, self.generator, temperature=0.0, vocab=self.cfg.vocab)
        generated = [tok]
        for _ in range(max_new - 1):
            evictions += self._evictions_at(caches)
            logits, caches = M.decode_step(self.params, self.cfg, tok, caches,
                                           kv_mode=self.kv_mode, fused=self.fused)
            nonfinite += (~torch.isfinite(logits)).sum()
            tok = sample(logits, self.generator, temperature=temperature,
                         vocab=self.cfg.vocab)
            generated.append(tok)
        gen = torch.cat(generated, dim=1).cpu()  # the one pull of the bucket
        if single and self._ghost_feed_on:
            self._kv_persist(caches, reqs[0].tenant_id)
        self.stats["decode_s"] += time.perf_counter() - t1
        self.stats["decode_steps"] += max_new - 1
        self.stats["tokens"] += gen.numel()
        self.stats["kv_evictions"] += int(evictions)
        self.stats["nonfinite_logits"] += int(nonfinite)
        dt = time.perf_counter() - t0
        return {
            r.rid: Result(rid=r.rid, tokens=gen[i, :r.max_new_tokens].tolist(),
                          prefill_cached=cached is not None, latency_s=dt)
            for i, r in enumerate(reqs)
        }

    # -- public -------------------------------------------------------------
    def _shed(self, r: Request) -> Result:
        self.stats["shed"] += 1
        return Result(rid=r.rid, tokens=[], prefill_cached=False, latency_s=0.0,
                      status="shed")

    def generate(self, requests: List[Request]) -> Dict[int, Result]:
        """Length-bucketed batched generation; aligns each request's prompt
        in place.  Multi-tenant engines run an admission pass first: shed
        requests return at once with ``status="shed"`` and touch nothing;
        deferred requests run after the unpressured work, shed only if their
        tenant is still at shed pressure by then, else completed with
        ``status="deferred"``.  Mutates the sampling generator, ``stats``,
        the prompt caches and the KV sessions."""
        out: Dict[int, Result] = {}
        for r in requests:
            r.prompt = self._align(r.prompt)
        if self.tenants is None:
            phases = [list(requests)]
        else:
            accepted, deferred = [], []
            for r, decision in zip(requests, self._admit(requests)):
                if decision == SHED:
                    out[r.rid] = self._shed(r)
                elif decision == DEFER:
                    self.stats["deferred"] += 1
                    deferred.append(r)
                else:
                    accepted.append(r)
            phases = [accepted, deferred]
        for phase_i, phase in enumerate(phases):
            if phase_i == 1 and phase:
                # the deferred retry: shed only if still critical
                kept = []
                for r, decision in zip(phase, self._admit(phase)):
                    if decision == SHED:
                        out[r.rid] = self._shed(r)
                    else:
                        kept.append(r)
                phase = kept
            buckets: Dict[int, List[Request]] = {}
            for r in phase:
                buckets.setdefault(len(r.prompt), []).append(r)
            for plen, reqs in sorted(buckets.items()):
                res = self._run_bucket(plen, reqs)
                if phase_i == 1:
                    for v in res.values():
                        v.status = "deferred"
                out.update(res)
        return out

    def telemetry(self) -> dict:
        """Engine counters; the prompt cache's stats (``prefix/...``, or
        ``tenant/<t>/...`` per tenant); an attached expert cache's
        (``expert/...``); in the paged mode the pool's policy
        and size (``kv/pool/...``) and, per tenant with a persisted session,
        its ghost hits and ``p`` (``kv/<t>/...``), with ``p`` and residency
        over every session (``kv/p_mean``, ``kv/p_max``,
        ``kv/resident_mean``), namespaced."""
        out = {f"serve/{k}": v for k, v in self.stats.items()}
        if self.tenants is None:
            out.update({f"prefix/{k}": v for k, v in self.prefix_cache.telemetry().items()})
        else:
            for t, d in self.tenant_cache.telemetry().items():
                out.update({f"tenant/{t}/{k}": v for k, v in d.items()})
        if self.expert_cache is not None:
            out.update({f"expert/{k}": v for k, v in self.expert_cache.telemetry().items()})
        if self.kv_mode != "paged":
            return out
        out.update({"kv/pool/policy": self.cfg.kv_policy,
                    "kv/pool/pages": self.cfg.bounded_kv_pages})
        every = []
        for t, states in self._kv_sessions.items():
            tel = [paged_kv.pool_telemetry(s) for s in states.values()]
            every += tel
            out.update({f"kv/{t}/policy": self.cfg.kv_policy,
                        f"kv/{t}/ghost_hits": self._kv_ghost_hits.get(t, 0),
                        f"kv/{t}/p_mean": float(torch.stack([x["p_mean"] for x in tel]).mean()),
                        f"kv/{t}/p_max": float(torch.stack([x["p_max"] for x in tel]).max())})
        if every:
            out.update({"kv/p_mean": float(torch.stack([x["p_mean"] for x in every]).mean()),
                        "kv/p_max": float(torch.stack([x["p_max"] for x in every]).max()),
                        "kv/resident_mean": float(torch.stack(
                            [x["resident_mean"] for x in every]).mean())})
        return out
