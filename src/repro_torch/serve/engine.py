"""Single-tenant serving engine: prefill -> decode over AWRP-managed caches
(``repro/serve/engine.py`` without tenants, admission or the obs registry).

  * length-bucketed batching: requests with equal page-aligned prompt
    lengths run together, sharing one token position per step;
  * prompt cache: exact-match prefix reuse through ``PrefixCache`` (AWRP
    eviction); a hit skips prefill.  Decoding updates the caches in place,
    so stored payloads are cloned on insert and again on every hit;
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
    move ARC/CAR's ``p`` across requests.  One session, the reference's
    ``"default"`` tenant;
  * the decode loop is a plain Python loop: one ``decode_step`` per token,
    tokens stay on the device until the bucket ends.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import torch

from repro_torch.cache import paged_kv
from repro_torch.cache.prefix_cache import PrefixCache
from repro_torch.core.policy_core import AdaptiveState
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.serve.sampling import sample


@dataclasses.dataclass
class Request:
    """One generation request: ``prompt`` token ids (page-aligned by the
    engine), a decode budget and a sampling temperature."""

    rid: int
    prompt: List[int]
    max_new_tokens: int = 16
    temperature: float = 0.0


@dataclasses.dataclass
class Result:
    rid: int
    tokens: List[int]
    prefill_cached: bool
    latency_s: float


class ServeEngine:
    """Batched generation over AWRP-managed caches on one device.

    ``stats`` counts prefills, decode steps and tokens, the KV evictions
    (page allocations made while a sequence's pool was full, summed over
    layers and sequences), the ghost hits of the true-adaptive pool's
    cross-request feed, logits that were not finite, and the host-clock
    seconds of prefill and decode (each ends in a device synchronize)."""

    def __init__(self, cfg, params, *, max_len: int = 512, kv_mode: str = "full",
                 prefix_cache_entries: int = 8, seed: int = 0,
                 fused: bool = False, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.kv_mode = kv_mode
        self.fused = bool(fused)
        self.prefix_cache = PrefixCache(prefix_cache_entries, "awrp")
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.stats = {"prefills": 0, "decode_steps": 0, "tokens": 0,
                      "kv_evictions": 0, "kv_ghost_hits": 0,
                      "nonfinite_logits": 0, "prefill_s": 0.0, "decode_s": 0.0}
        #: ghost-hit feed: the last single request's final pool policy
        #: state of each adaptive position (stacked over layers), or None
        self._kv_session = None

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

    def _kv_reseed(self, caches, plen: int):
        """On a re-prefill, replay the prompt's page ids through the persisted
        pool policy state: previously evicted pages ghost-hit and move ``p``;
        the rebuilt state seeds the new pool."""
        if self._kv_session is None:
            return caches
        page, P = self.cfg.page_size, self.cfg.bounded_kv_pages
        n_have = plen // page
        blocks = dict(caches["blocks"])
        for name, prev in self._kv_session.items():
            state, gh = paged_kv.reseed_from_ghosts(
                prev, self.cfg.kv_policy, P, n_have, min(n_have, P))
            self.stats["kv_ghost_hits"] += int(gh.sum())
            blocks[name] = paged_kv.AdaptivePagedPool(blocks[name].pool, state)
        return {"pos": caches["pos"], "blocks": blocks}

    def _kv_persist(self, caches) -> None:
        """Keep the request's final pool policy states (ghost lists, ``p``),
        one per adaptive position, for the next re-prefill to replay into."""
        self._kv_session = {
            name: AdaptiveState(*(t.clone() for t in c.policy))
            for name, c in caches["blocks"].items()
            if isinstance(c, paged_kv.AdaptivePagedPool)}

    def _run_bucket(self, plen: int, reqs: List[Request]) -> Dict[int, Result]:
        t0 = time.perf_counter()
        max_new = max(r.max_new_tokens for r in reqs)
        single = len(reqs) == 1
        cached = self.prefix_cache.lookup(reqs[0].prompt) if single else None
        if cached is not None:
            logits, caches = cached[0], M.clone_caches(cached[1])
        else:
            logits, caches = self._prefill([r.prompt for r in reqs])
            if single:
                if self._ghost_feed_on:
                    # a prefix miss re-references page positions the previous
                    # request's pool may have evicted
                    caches = self._kv_reseed(caches, plen)
                self.prefix_cache.insert(reqs[0].prompt, (logits, M.clone_caches(caches)))

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
            self._kv_persist(caches)
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
    def generate(self, requests: List[Request]) -> Dict[int, Result]:
        """Length-bucketed batched generation; aligns each request's prompt
        in place.  Mutates the sampling generator, ``stats`` and the prefix
        cache."""
        for r in requests:
            r.prompt = self._align(r.prompt)
        buckets: Dict[int, List[Request]] = {}
        for r in requests:
            buckets.setdefault(len(r.prompt), []).append(r)
        out: Dict[int, Result] = {}
        for plen, reqs in sorted(buckets.items()):
            out.update(self._run_bucket(plen, reqs))
        return out

    def telemetry(self) -> dict:
        """Engine counters, the prefix cache's stats and, in the
        true-adaptive mode once a request has run, the persisted policy's
        ``p`` and residency, namespaced."""
        out = {f"serve/{k}": v for k, v in self.stats.items()}
        out.update({f"prefix/{k}": v for k, v in self.prefix_cache.telemetry().items()})
        if self._kv_session:
            tel = [paged_kv.pool_telemetry(s) for s in self._kv_session.values()]
            out.update({"kv/p_mean": float(torch.stack([t["p_mean"] for t in tel]).mean()),
                        "kv/p_max": float(torch.stack([t["p_max"] for t in tel]).max()),
                        "kv/resident_mean": float(torch.stack(
                            [t["resident_mean"] for t in tel]).mean())})
        return out
