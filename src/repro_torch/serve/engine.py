"""Serving engine: prefill -> decode over AWRP-managed caches
(``repro/serve/engine.py``).

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
  * the decode loop: with ``jit_loop=True`` (the default, as in the
    reference) one decode step, its sampling and the step's counters are
    captured as one CUDA graph per (cache shapes, greedy or sampled) key
    (``DecodeGraph``, the counterpart of the reference's ``_get_loop`` /
    ``_build_loop``) and a bucket replays it once per token; on the CPU the
    same runner runs the same step eagerly.  ``jit_loop=False`` is the
    eager host loop, one ``decode_step`` per token, the baseline.  In both,
    tokens stay on the device until the bucket ends and the loop reads
    nothing back to the host;
  * observability: with ``metrics=True`` (the default, as in the reference)
    the decode-loop planes (``serve/loop/{steps, tokens, token_hist}``,
    ``obs/metrics.py``) are folded after every sampling event: the first
    greedy token eagerly, every later step inside the captured step (into
    planes the graph owns, added into the engine's after the bucket) or per
    step on the host loop, integer ops only, so both loops' planes are equal
    bit for bit.  Every telemetry surface mounts a provider on one
    ``Registry`` and ``telemetry()`` is one flat snapshot with one
    synchronization; host spans (``prefill``, ``decode``, ``rebalance``),
    the decode graphs' compile counters and, with ``profile_dir``, one
    ``torch.profiler`` trace per ``profile_every`` requests ride along;
  * rows mesh: ``mesh=`` (a ``core.sharding`` rows mesh) serves a bucket
    whose request count divides the mesh shard by shard: shard ``i`` takes
    a contiguous ``1/n`` of the requests and prefills and decodes them on
    its own device and stream, with the parameters of its device (one copy
    per distinct device: shards on one device share one set), a decode
    graph of its own (captured on its stream) and a generator of its own
    seeded as the engine's; the tokens are gathered in the batch's order.
    Each shard's tokens and planes are those of an unsharded engine serving
    its requests, bit for bit.  A bucket of one request (the prompt cache's
    path) or one that does not divide the mesh runs unsharded.  The
    tenants' core rows are placed across the mesh too (``serve/tenancy.py``);
  * decision trace: ``decision_trace=N`` (multi-tenant engines only) gives
    the tenants' core a decision-trace ring of its N most recent access and
    admission events, written on the device (on the card inside the stream
    kernels); ``drain_decision_trace()`` pulls it with one synchronization
    and ``opt_regret()`` judges it against the offline OPT oracle and
    publishes the regret as registry gauges.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.cache import paged_kv
from repro_torch.cache.prefix_cache import PrefixCache
from repro_torch.core import sharding
from repro_torch.core.policy_core import AdaptiveState
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import model as M
from repro_torch.obs import profiling
from repro_torch.obs.metrics import (Derived, Registry, loop_merge_, loop_planes,
                                     loop_update_, safe_ratio)
from repro_torch.obs.opt_oracle import regret_from_records
from repro_torch.obs.profiling import Sentinel, TraceCapture
from repro_torch.obs.spans import SpanSet
from repro_torch.serve.sampling import sample, sample_traced
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


def _copy_into(dst, src) -> None:
    """Copy cache tree ``src`` into ``dst`` (the same structure) leaf by
    leaf, skipping leaves that already share storage (the K/V a decode step
    writes in place)."""
    if isinstance(dst, torch.Tensor):
        if dst.data_ptr() != src.data_ptr():
            dst.copy_(src)
    elif isinstance(dst, dict):
        for key, leaf in dst.items():
            _copy_into(leaf, src[key])
    else:  # PagedPool, AdaptivePagedPool, AdaptiveState, MambaCache
        for a, b in zip(dst, src):
            _copy_into(a, b)


def _tree_shapes(tree) -> tuple:
    """The shapes of cache tree ``tree``'s tensor leaves, in ``_copy_into``'s
    order: a decode graph's key.  Every leaf's shape is fixed by the config
    and the batch size, except the encoder-decoder's ``ck`` / ``cv``, whose
    rows follow the prompt's length."""
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape),)
    leaves = tree.values() if isinstance(tree, dict) else tree
    return tuple(shape for leaf in leaves for shape in _tree_shapes(leaf))


@dataclasses.dataclass
class _Shard:
    """One shard of a rows-mesh engine: its device, its device's
    parameters, its stream (None on the CPU) and its sampling generator."""

    index: int
    device: torch.device
    params: dict
    stream: Optional[torch.cuda.Stream]
    generator: torch.Generator


@dataclasses.dataclass
class _ShardRun:
    """One shard's share of a bucket in flight: its caches, its tokens so
    far, its (evictions, non-finite logits) counts as 0-d tensors and the
    bucket's loop planes (None with metrics off)."""

    caches: dict
    toks: List[torch.Tensor]
    counts: List[torch.Tensor]
    planes: Optional[Dict[str, torch.Tensor]]


@contextlib.contextmanager
def _sync_errors(device: torch.device):
    """Run the body with ``torch.cuda.set_sync_debug_mode("error")`` on a
    CUDA device: a host sync between graph replays raises."""
    if device.type != "cuda":
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


class DecodeGraph:
    """One decode step as a CUDA graph for one (cache shapes, greedy or
    sampled) key: the counterpart of the reference's ``_build_loop``, whose
    ``lax.scan`` body is this step.

    It owns the static inputs: the token, the cache tree (``pos``, the K/V,
    every policy plane), the temperature, the eviction and non-finite
    counters and, on an engine with ``metrics=True``, decode-loop planes of
    its own (``planes``).  One step runs ``ServeEngine._step`` on them and
    writes its results back into them: the K/V pages are written in place
    by the step, the planes ``decode_step`` restacks are copied back, the
    loop planes are folded in place.  ``load`` copies a bucket's caches in
    and zeroes the counters and loop planes (the warm-up and the capture
    run the step too); a stored prefix payload is only read, so none
    aliases the static tree (the reference's donation rule).

    On a CUDA device the step is captured once, on the engine's long-lived
    capture stream, after one eager warm-up step there (the kernel library's
    load, cuBLAS's workspace and the split kernels' arrival counters are
    set up outside the capture); a failed capture raises.  Each replay adds
    the launches the capture recorded to ``ops.LAUNCHES``, so it counts the
    launches the device ran in both loops; the warm-up and the capture
    count none.  A sampled graph draws from the engine's generator,
    registered with the graph.  On the CPU ``step`` runs the same body
    eagerly.  A rows-mesh engine's shard (``shard``) has a graph of its own,
    on its device with its parameters and generator, captured on its stream;
    it is replayed on that stream."""

    def __init__(self, engine: "ServeEngine", caches, sampled: bool,
                 shard: Optional[_Shard] = None):
        dev = engine.device if shard is None else shard.device
        self.engine = engine
        self.device = dev
        self.params = engine.params if shard is None else shard.params
        self.caches = M.clone_caches(caches)
        B = _batch_of(next(iter(caches["blocks"].values())))
        self.tok = torch.zeros((B, 1), dtype=torch.int32, device=dev)
        self.temperature = torch.zeros((), dtype=torch.float32, device=dev)
        self.evictions = torch.zeros((), dtype=torch.int64, device=dev)
        self.nonfinite = torch.zeros((), dtype=torch.int64, device=dev)
        #: the bucket's loop planes, added into the engine's after it
        self.planes = loop_planes(dev) if engine.metrics else None
        self.generator = ((engine.generator if shard is None else shard.generator)
                          if sampled else None)
        self.graph = None
        #: host-clock seconds of the build: clone, warm-up and capture
        self.build_s = 0.0
        #: ops.LAUNCHES the captured step makes, added once per replay
        self.launches: Dict[str, int] = {}
        if dev.type == "cuda":
            self._capture(engine.capture_stream() if shard is None else shard.stream)

    def _body(self, generator) -> None:
        tok, caches, evictions, nonfinite = self.engine._step(
            self.tok, self.caches, generator, self.temperature, self.planes, self.params)
        self.tok.copy_(tok)
        self.evictions += evictions
        self.nonfinite += nonfinite
        _copy_into(self.caches, caches)

    def _capture(self, stream) -> None:
        dev = self.device
        before = dict(ops.LAUNCHES)
        # the warm-up draws from a generator of its own: the engine's stream
        # of draws is the host loop's
        warm_gen = (torch.Generator(device=dev).manual_seed(0)
                    if self.generator is not None else None)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            self._body(warm_gen)
        torch.cuda.current_stream(dev).wait_stream(stream)
        warmed = dict(ops.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        # no garbage collection inside the capture: a collected cycle may hold
        # a dropped engine's decode graph, whose destruction (the executable
        # graph's destroy) is not permitted while a stream captures and
        # invalidates this capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, stream=stream):
                self._body(self.generator)
        finally:
            if collecting:
                gc.enable()
        self.launches = {k: n - warmed[k] for k, n in ops.LAUNCHES.items()
                         if n != warmed[k]}
        ops.LAUNCHES.update(before)
        self.graph = graph

    def load(self, caches, tok: torch.Tensor, temperature: float) -> None:
        """A bucket's starting state: its caches, its first token, its
        temperature, the counters and loop planes at 0."""
        _copy_into(self.caches, caches)
        self.tok.copy_(tok)
        self.temperature.fill_(temperature)
        self.evictions.zero_()
        self.nonfinite.zero_()
        for plane in (self.planes or {}).values():
            plane.zero_()

    def step(self) -> None:
        """One decode step: a graph replay on the card, the body on the CPU."""
        self.engine._loop_sentinel.calls += 1
        if self.graph is None:
            self._body(self.generator)
            return
        self.graph.replay()
        for name, n in self.launches.items():
            ops.LAUNCHES[name] += n


def _same_device(a: torch.device, b: torch.device) -> bool:
    """``a`` and ``b`` name one device (``cuda`` without an index is the
    current one)."""
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device
    return (cur() if a.index is None else a.index) == (cur() if b.index is None else b.index)


def _batch_of(cache) -> int:
    """The batch size of one position's decode cache (stacked or not): a
    pool, a ``{"k", "v"}`` cache (B, T, kvd) (the encoder-decoder's ``dec``
    position adds ``ck`` / ``cv``) or a ``MambaCache`` (state (B, H, P,
    N))."""
    if isinstance(cache, paged_kv.AdaptivePagedPool):
        cache = cache.pool
    if isinstance(cache, paged_kv.PagedPool):
        return cache.f.shape[-2]
    if isinstance(cache, M.MambaCache):
        return cache.state.shape[-4]
    return cache["k"].shape[-3]


class ServeEngine:
    """Batched generation over AWRP-managed caches on one device, or under
    ``mesh`` (a ``core.sharding`` rows mesh) shard by shard across its
    devices and streams (``_run_sharded``).

    ``stats`` counts prefills, decode steps and tokens, the KV evictions
    (page allocations made while a sequence's pool was full, summed over
    layers and sequences), the ghost hits of the true-adaptive pool's
    cross-request feed, logits that were not finite, the host-clock seconds
    of prefill and decode (each ends in a device synchronize), the
    multi-tenant engine's shed and deferred requests and rebalanced quota
    lanes, and the decode graphs built (``loop_captures``: one per cache
    tree's shapes and sampling mode, the reference's ``compile/decode_loop`` count;
    on the CPU the runner is built but nothing is captured; the seconds a
    build took are its ``DecodeGraph.build_s``, not in ``decode_s``).

    ``jit_loop=True`` (the default) decodes by replaying ``DecodeGraph``;
    ``jit_loop=False`` runs the eager host loop.  On a CUDA device the
    unfused true-adaptive pool (``arc_adaptive`` / ``car_adaptive`` with
    ``fused=False``) is refused with ``jit_loop=True``: its eager policy
    core reads the host (CAR's clock-hand sweep, the core's capacities), so
    it cannot be captured; it is the correctness reference of kernel 5.

    ``prefix_policy`` is a policy name or a prebuilt host policy (through
    ``make_cache_policy``) for the single-tenant prompt cache, a device
    policy name (awrp/lru/fifo/lfu/arc/car) for the tenants' core.

    ``metrics=False`` drops the loop planes (no fold in the graph, tokens and
    stats unchanged); ``profile_phases=True`` makes each span wait for its
    phase's outputs; ``profile_dir`` turns on ``torch.profiler`` capture;
    ``decision_trace=N`` (needs ``tenants``) records the tenants' last N
    access and admission decisions (``drain_decision_trace``,
    ``opt_regret``).  ``telemetry()`` may be called from another thread (``obs/server.py``):
    the engine's lock, held while a decode graph is captured and while a
    bucket's graph loop runs under sync debug mode ``"error"``, makes a
    snapshot wait for both to end, so its one synchronization neither
    raises in that mode nor breaks a capture."""

    def __init__(self, cfg, params, *, max_len: int = 512, kv_mode: str = "full",
                 prefix_cache_entries: int = 8, prefix_policy="awrp", seed: int = 0,
                 tenants: Optional[Dict[str, int]] = None,
                 admission: Optional[AdmissionController] = None,
                 auto_rebalance: bool = False, fused: bool = False, expert_cache=None,
                 jit_loop: bool = True, metrics: bool = True, decision_trace: int = 0,
                 profile_dir: Optional[str] = None, profile_every: int = 16,
                 profile_phases: bool = False, device="cuda", mesh=None):
        self.device = resolve_device(device)
        #: optional ``core.sharding`` rows mesh: multi-request buckets that
        #: divide it are served shard by shard (``_run_sharded``)
        self.mesh = mesh
        self.jit_loop = bool(jit_loop)
        if (self.jit_loop and self.device.type == "cuda" and kv_mode == "paged"
                and cfg.kv_policy in paged_kv.TRUE_ADAPTIVE_KV and not fused):
            raise ValueError(
                f"kv_policy {cfg.kv_policy!r} with fused=False reads the host in "
                "its eager policy core and cannot be captured as a decode graph; "
                "serve it with fused=True, or with jit_loop=False")
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.kv_mode = kv_mode
        self.fused = bool(fused)
        self.tenants = dict(tenants) if tenants else None
        self.auto_rebalance = bool(auto_rebalance)
        self.expert_cache = expert_cache
        if decision_trace and self.tenants is None:
            raise ValueError(
                "decision_trace records the tenancy core's per-access events; "
                "construct the engine with tenants={...}")
        if self.tenants is None:
            self.prefix_cache = PrefixCache(prefix_cache_entries, prefix_policy)
            self.tenant_cache = None
            self.admission = None
        else:
            self.prefix_cache = None
            self.tenant_cache = TenantPrefixCache(self.tenants, prefix_policy,
                                                  ring_capacity=int(decision_trace),
                                                  device=self.device, mesh=mesh)
            self.admission = admission or AdmissionController()
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._shards = self._mesh_shards(seed) if mesh is not None else []
        #: per shard of the last sharded bucket: its final caches and the
        #: bucket's loop planes (``None`` with metrics off)
        self.last_shards: List[dict] = []
        self.stats = {"prefills": 0, "decode_steps": 0, "tokens": 0,
                      "kv_evictions": 0, "kv_ghost_hits": 0,
                      "nonfinite_logits": 0, "prefill_s": 0.0, "decode_s": 0.0,
                      "shed": 0, "deferred": 0, "rebalances": 0, "loop_captures": 0}
        #: decode graphs by (cache shapes, sampled), and the stream they are
        #: captured on (one per engine, so the split kernels' per-stream
        #: arrival counters are set up once)
        self._graphs: Dict[tuple, DecodeGraph] = {}
        self._capture_stream = None
        #: ghost-hit feed, per tenant: the tenant's last single request's
        #: final pool policy state of each adaptive position (stacked over
        #: layers), and the ghost hits its re-prefills replayed
        self._kv_sessions: Dict[str, Dict[str, AdaptiveState]] = {}
        self._kv_ghost_hits: Dict[str, int] = {}
        # -- observability ---------------------------------------------------
        #: held while a decode graph is captured and while a graph loop runs
        #: (sync debug mode "error"); ``telemetry()`` takes it
        self._lock = threading.RLock()
        #: the decode-loop planes, None with metrics off
        self.metrics = bool(metrics)
        self._planes = loop_planes(self.device) if self.metrics else None
        #: the decode graphs' compile counters (``compile/decode_loop/...``)
        self._loop_sentinel = Sentinel("decode_loop")
        #: host spans around prefill, decode and rebalance; with
        #: ``profile_phases`` each waits for its phase's outputs
        self.spans = SpanSet(sync=bool(profile_phases))
        self._capture = TraceCapture(profile_dir, profile_every) if profile_dir else None
        self.registry = Registry()
        self._mount_providers()

    # -- internals ----------------------------------------------------------
    def _align(self, prompt: List[int]) -> List[int]:
        """Page-align by left-trimming (left-padding a prompt shorter than a
        page)."""
        page = self.cfg.page_size
        n = max((len(prompt) // page) * page, page)
        if len(prompt) < page:
            prompt = [0] * (page - len(prompt)) + prompt
        return prompt[-n:]

    def _mesh_shards(self, seed: int) -> List[_Shard]:
        """The mesh's shards: the parameters copied once to each distinct
        device other than the engine's (shards on one device share them),
        a generator per shard seeded as the engine's."""
        params = {self.device: self.params}
        shards = []
        for i, (dev, stream) in enumerate(zip(self.mesh.devices, self.mesh.streams)):
            key = next((d for d in params if _same_device(d, dev)), None)
            if key is None:
                key = dev
                params[dev] = sharding.tree_map(lambda t, d=dev: t.to(d), self.params)
            shards.append(_Shard(i, dev, params[key], stream,
                                 torch.Generator(device=dev).manual_seed(seed)))
        return shards

    def _sync(self) -> None:
        devices = ([self.device] if self.mesh is None
                   else [self.device, *self.mesh.distinct_devices])
        for dev in devices:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def _prefill_call(self, prompts: List[List[int]], params, device):
        """The batch's prefill on ``device``: ``(logits of the last position
        (B, 1, V), caches)``.  The stub frontends get zeros in the activation
        dtype, as the reference's ``_batch_prefill`` gives them: a VLM's
        ``n_patch_tokens`` patch embeddings, an encoder-decoder's ``S //
        enc_seq_divisor`` frames."""
        tokens = torch.tensor(prompts, dtype=torch.int32, device=device)
        B, S = tokens.shape
        cfg, stub = self.cfg, {}
        dtype = M.torch_dtype(cfg.dtype)
        if cfg.family == "vlm":
            stub["patches"] = torch.zeros((B, cfg.n_patch_tokens, cfg.d_model),
                                          dtype=dtype, device=device)
        if cfg.family == "encdec":
            stub["frames"] = torch.zeros((B, S // cfg.enc_seq_divisor, cfg.d_model),
                                         dtype=dtype, device=device)
        logits, caches = M.prefill(params, cfg, tokens, self.max_len, kv_mode=self.kv_mode,
                                   **stub)
        # a copy of the last position, so the (B, S, V) logits are freed
        return logits[:, -1:].clone(), caches

    def _prefill(self, prompts: List[List[int]], parts: bool = False):
        """The batch's prefill, under the ``prefill`` span, ending in a
        device synchronize.  With ``parts`` (a sharded bucket) ``prompts``
        holds one list per shard, each prefilled on its shard's device and
        stream: a list of ``(logits, caches)``."""
        t0 = time.perf_counter()
        with self.spans.span("prefill") as sp:
            if parts:
                out = sharding.run_shards(
                    self.mesh, lambda i, p: self._prefill_call(p, self._shards[i].params,
                                                               self._shards[i].device),
                    prompts)
                sp.ready([o[0] for o in out])
            else:
                out = self._prefill_call(prompts, self.params, self.device)
                sp.ready(out[0])
            self._sync()
        self.stats["prefill_s"] += time.perf_counter() - t0
        self.stats["prefills"] += 1
        return out

    def _evictions_at(self, caches) -> torch.Tensor:
        """Allocations the next step makes into a full pool, summed over the
        pool positions: counted on every step and kept where ``pos`` is a
        page boundary (0-d tensor, computed on the device, not pulled)."""
        total = torch.zeros((), dtype=torch.int64, device=caches["pos"].device)
        if self.kv_mode != "paged":
            return total
        for pool in caches["blocks"].values():
            if isinstance(pool, paged_kv.AdaptivePagedPool):
                pool = pool.pool
            if isinstance(pool, paged_kv.PagedPool):
                total = total + (pool.page_start >= 0).all(dim=-1).sum()
        return total * (caches["pos"] % self.cfg.page_size == 0)

    # -- the decode loop ----------------------------------------------------
    def capture_stream(self) -> torch.cuda.Stream:
        """The engine's stream for graph warm-ups and captures, made once."""
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(device=self.device)
        return self._capture_stream

    def _step(self, tok, caches, generator, temperature, planes=None, params=None):
        """One decode step on the device: the evictions its allocation makes
        into a full pool, the step, its non-finite logits and the next token
        (``sample_traced``), folded into the loop ``planes`` in place when
        given.  ``params`` defaults to the engine's (a shard passes its
        device's).  Returns ``(tok, caches, evictions, nonfinite)``; nothing
        is read back to the host."""
        evictions = self._evictions_at(caches)
        logits, caches = M.decode_step(self.params if params is None else params, self.cfg,
                                       tok, caches, kv_mode=self.kv_mode, fused=self.fused)
        nonfinite = (~torch.isfinite(logits)).sum()
        tok = sample_traced(logits, generator, temperature, vocab=self.cfg.vocab)
        if planes is not None:
            loop_update_(planes, tok, vocab=self.cfg.vocab)
        return tok, caches, evictions, nonfinite

    def decode_graph(self, caches, sampled: bool, shard: Optional[_Shard] = None
                     ) -> DecodeGraph:
        """The decode graph of ``caches``' shapes (the batch size and, for
        the encoder-decoder, the cross K/V's rows), the sampling mode and
        the mesh shard (None unsharded), built (and on the card captured) at
        its first use."""
        key = (_tree_shapes(caches), bool(sampled), None if shard is None else shard.index)
        graph = self._graphs.get(key)
        if graph is None:
            with self._lock:
                t0 = time.perf_counter()
                graph = DecodeGraph(self, caches, sampled, shard)
                self._sync()
                graph.build_s = time.perf_counter() - t0
            self._graphs[key] = graph
            self.stats["loop_captures"] += 1
            sentinel = self._loop_sentinel
            sentinel.traces += 1
            sentinel.cache_size = len(self._graphs)
            sentinel.last_trace_s = graph.build_s
        return graph

    def _graph_loop(self, graph: DecodeGraph, tok, caches, temperature: float,
                    steps: int):
        """``steps`` replays of the bucket's decode graph: the generated
        tokens (each a copy of the static token), the final caches (the
        graph's static tree) and the counters, all on the device; the
        graph's loop planes are added into the engine's."""
        with self._lock:
            graph.load(caches, tok, temperature)
            generated = []
            with _sync_errors(self.device):
                for _ in range(steps):
                    graph.step()
                    generated.append(graph.tok.clone())
            if self._planes is not None:
                loop_merge_(self._planes, graph.planes)
        return generated, graph.caches, graph.evictions, graph.nonfinite

    def _host_loop(self, tok, caches, temperature: float, steps: int):
        """``steps`` eager decode steps (``jit_loop=False``, the baseline):
        the same outputs as ``_graph_loop``."""
        counts = [torch.zeros((), dtype=torch.int64, device=self.device) for _ in range(2)]
        generated = []
        for _ in range(steps):
            tok, caches = self._host_step(tok, caches, self.params, self.generator,
                                          temperature, self._planes, counts)
            generated.append(tok)
        return generated, caches, *counts

    def _host_step(self, tok, caches, params, generator, temperature: float, planes,
                   counts):
        """One eager decode step: adds its evictions and non-finite logits
        into ``counts`` and folds its token into ``planes`` (when given);
        returns ``(tok, caches)``."""
        counts[0] += self._evictions_at(caches)
        logits, caches = M.decode_step(params, self.cfg, tok, caches,
                                       kv_mode=self.kv_mode, fused=self.fused)
        counts[1] += (~torch.isfinite(logits)).sum()
        tok = sample(logits, generator, temperature=temperature, vocab=self.cfg.vocab)
        if planes is not None:
            loop_update_(planes, tok, vocab=self.cfg.vocab)
        return tok, caches

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
        with self.spans.span("rebalance"):
            moved, _ = self.tenant_cache.rebalance(tenant, 1)
        self.stats["rebalances"] += moved

    def drain_decision_trace(self) -> np.ndarray:
        """The decision-trace ring (``decision_trace=N`` engines) on the host
        as a structured record array, oldest event first: the tenants' access
        and admission events (``obs.decision_trace``).  One synchronization,
        under the ``trace_drain`` span."""
        if self.tenants is None:
            raise ValueError("decision tracing needs a multi-tenant engine")
        with self.spans.span("trace_drain"):
            return self.tenant_cache.manager.drain_trace()

    def opt_regret(self) -> Dict[str, dict]:
        """OPT regret: drain the decision trace, replay each tenant's
        recorded key stream through the offline Belady oracle at the
        tenant's quota, and publish ``opt - observed`` hit-ratio regret as
        sticky registry gauges (``tenant/<t>/opt_regret`` and the
        access-weighted ``policy/<name>/opt_regret``).  Returns the
        per-tenant numbers and ``"aggregate"``
        (``obs.opt_oracle.regret_from_records``)."""
        records = self.drain_decision_trace()
        mgr = self.tenant_cache.manager
        caps = {mgr.row(t): mgr.quotas[t] for t in mgr.tenants}
        per_row, aggregate = regret_from_records(records, caps)
        out = {}
        for t in mgr.tenants:
            info = per_row[mgr.row(t)]
            self.registry.set_gauge(f"tenant/{t}/opt_regret", info["regret"])
            out[t] = info
        self.registry.set_gauge(f"policy/{mgr.policy_name}/opt_regret", aggregate["regret"])
        out["aggregate"] = aggregate
        return out

    def _admit(self, requests: List[Request]) -> List[str]:
        """Admission decisions for ``requests`` in order, with the decay on
        shed applied: ``decide_batch`` on the device pressure plane (the
        reference's default route)."""
        return self.admission.decide_batch(self.tenant_cache.manager,
                                           [r.tenant_id for r in requests])

    def _run_sharded(self, reqs: List[Request]) -> Dict[int, Result]:
        """A bucket under the rows mesh: shard ``i`` prefills and decodes
        requests ``[i*k, (i+1)*k)`` on its device and stream (its own decode
        graph, or the eager loop), the shards interleaved step by step; the
        tokens gathered in the batch's order with the bucket's one pull.
        Stats count the bucket once, as an unsharded run of it; the engine's
        loop planes take every shard's tokens and the sampling events
        once (shard 0's), so they equal the unsharded run's too."""
        t0 = time.perf_counter()
        mesh, shards = self.mesh, self._shards
        k = len(reqs) // mesh.size
        prefilled = self._prefill([[r.prompt for r in reqs[i * k:(i + 1) * k]]
                                   for i in range(mesh.size)], parts=True)
        max_new = max(r.max_new_tokens for r in reqs)
        temperature, steps = reqs[0].temperature, max_new - 1
        graphs = ([self.decode_graph(c, temperature > 0.0, s)
                   for (_, c), s in zip(prefilled, shards)]
                  if self.jit_loop and steps else None)
        vocab = self.cfg.vocab
        t1 = time.perf_counter()
        with self.spans.span("decode") as sp, self._lock:
            runs = []
            with sharding.forked(mesh):
                for s, (logits, caches) in zip(shards, prefilled):
                    with sharding.on_shard(mesh, s.index):
                        run = _ShardRun(caches, [sample(logits, s.generator, temperature=0.0,
                                                        vocab=vocab)],
                                        [torch.zeros((), dtype=torch.int64, device=s.device),
                                         (~torch.isfinite(logits)).sum()],
                                        loop_planes(s.device) if self.metrics else None)
                        if run.planes is not None:
                            loop_update_(run.planes, run.toks[0], vocab=vocab)
                        if graphs is not None:
                            graphs[s.index].load(caches, run.toks[0], temperature)
                        runs.append(run)
                with (_sync_errors(self.device) if graphs is not None
                      else contextlib.nullcontext()):
                    for _ in range(steps):
                        for s, run in zip(shards, runs):
                            with sharding.on_shard(mesh, s.index):
                                if graphs is None:
                                    tok, run.caches = self._host_step(
                                        run.toks[-1], run.caches, s.params, s.generator,
                                        temperature, run.planes, run.counts)
                                else:
                                    graphs[s.index].step()
                                    tok = graphs[s.index].tok.clone()
                                run.toks.append(tok)
                for s, run, g in zip(shards, runs, graphs or ()):
                    with sharding.on_shard(mesh, s.index):
                        if run.planes is not None:
                            loop_merge_(run.planes, g.planes)
                        run.caches = g.caches
                        run.counts = [run.counts[0] + g.evictions, run.counts[1] + g.nonfinite]
            sp.ready([run.caches for run in runs])
            # the bucket's one pull
            gen = torch.cat([torch.cat(run.toks, dim=1).to(self.device) for run in runs]).cpu()
            evictions = sum(int(run.counts[0]) for run in runs)
            nonfinite = sum(int(run.counts[1]) for run in runs)
        if self._planes is not None:
            for i, run in enumerate(runs):
                for name in ("steps", "tokens", "token_hist")[0 if i == 0 else 1:]:
                    self._planes[name].add_(run.planes[name].to(self.device))
        self.last_shards = [{"caches": run.caches, "planes": run.planes} for run in runs]
        self.stats["decode_s"] += time.perf_counter() - t1
        self.stats["decode_steps"] += steps
        self.stats["tokens"] += gen.numel()
        self.stats["kv_evictions"] += evictions
        self.stats["nonfinite_logits"] += nonfinite
        dt = time.perf_counter() - t0
        return {r.rid: Result(rid=r.rid, tokens=gen[i, :r.max_new_tokens].tolist(),
                              prefill_cached=False, latency_s=dt)
                for i, r in enumerate(reqs)}

    def _run_bucket(self, plen: int, reqs: List[Request]) -> Dict[int, Result]:
        if self.mesh is not None and len(reqs) > 1 and len(reqs) % self.mesh.size == 0:
            return self._run_sharded(reqs)
        t0 = time.perf_counter()
        max_new = max(r.max_new_tokens for r in reqs)
        single = len(reqs) == 1
        # the graph loop copies the caches into its static tree and never
        # writes a stored payload; the host loop decodes in place, so it
        # takes a copy on a hit and stores a copy on a miss
        own = M.clone_caches if not self.jit_loop else (lambda c: c)
        cached = self._lookup_prefix(reqs[0]) if single else None
        if cached is not None:
            logits, caches = cached[0], own(cached[1])
        else:
            logits, caches = self._prefill([r.prompt for r in reqs])
            if single:
                if self._ghost_feed_on:
                    # a prefix miss re-references page positions the tenant's
                    # previous request's pool may have evicted
                    caches = self._kv_reseed(caches, reqs[0].tenant_id, plen)
                self._insert_prefix(reqs[0], (logits, own(caches)))

        temperature = reqs[0].temperature
        steps = max_new - 1
        graph = (self.decode_graph(caches, temperature > 0.0)
                 if self.jit_loop and steps else None)
        t1 = time.perf_counter()
        with self.spans.span("decode") as sp:
            tok = sample(logits, self.generator, temperature=0.0, vocab=self.cfg.vocab)
            if self._planes is not None:
                loop_update_(self._planes, tok, vocab=self.cfg.vocab)
            if graph is None:
                generated, caches, evictions, nonfinite = self._host_loop(
                    tok, caches, temperature, steps)
            else:
                generated, caches, evictions, nonfinite = self._graph_loop(
                    graph, tok, caches, temperature, steps)
            sp.ready(caches)
            nonfinite = nonfinite + (~torch.isfinite(logits)).sum()
            gen = torch.cat([tok, *generated], dim=1).cpu()  # the one pull of the bucket
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
        the prompt caches and the KV sessions.  With ``profile_dir`` set, one
        call per ``profile_every`` requests runs inside a ``torch.profiler``
        capture."""
        if self._capture is None:
            return self._generate(requests)
        with self._capture.maybe(len(requests)):
            return self._generate(requests)

    def _generate(self, requests: List[Request]) -> Dict[int, Result]:
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

    # -- observability mounts -----------------------------------------------
    def _mount_providers(self) -> None:
        """Mount every telemetry surface the engine holds on the registry.
        Providers read ``self`` when the snapshot runs (an expert cache
        attached after construction appears at the next snapshot) and return
        tensors un-pulled: the snapshot's one ``_pull`` is the only read."""
        self.registry.mount("serve", self._serve_provider)
        if self.tenants is None:
            self.registry.mount("prefix", lambda: self.prefix_cache.telemetry())
        else:
            self.registry.mount("tenant", self._tenant_provider)
        self.registry.mount("kv", self._kv_provider)
        self.registry.mount("expert", lambda: (self.expert_cache.telemetry()
                                               if self.expert_cache is not None else {}))
        self.registry.mount("span", self.spans.metrics)
        # process-wide compile counters: every engine mounts the same sums
        self.registry.mount("compile", profiling.compile_metrics)
        if self._capture is not None:
            self.registry.mount("profiler", self._capture.metrics)

    def _serve_provider(self) -> dict:
        out: dict = dict(self.stats)
        if self._planes is not None:
            out["loop"] = dict(self._planes)
        return out

    def _tenant_provider(self) -> dict:
        mgr = self.tenant_cache.manager
        rows = mgr.row_metrics()  # (rows,) device planes, not pulled
        ratio = Derived(lambda g: safe_ratio(g["hits"], g["accesses"]))
        out = {}
        for t in mgr.tenants:
            r = mgr.row(t)
            out[t] = {
                "policy": mgr.policy_name,
                "quota": mgr.quotas[t],
                "entries": len(self.tenant_cache.stores[t]),
                "occupancy": rows["occupancy"][r],
                "hits": rows["hits"][r],
                "misses": rows["misses"][r],
                "evictions": rows["evictions"][r],
                "accesses": rows["accesses"][r],
                "pressure": rows["pressure"][r],
                "hit_ratio": ratio,
            }
        return out

    def _kv_provider(self) -> dict:
        """The paged pool's policy and size and, per tenant with a persisted
        session, its ghost hits and ``p``; ``p`` and residency over every
        session.  The reductions run on the device, not pulled."""
        if self.kv_mode != "paged":
            return {}
        out: dict = {"pool": {"policy": self.cfg.kv_policy,
                              "pages": self.cfg.bounded_kv_pages}}
        every = []
        # a copy: the serving thread may add a tenant's session meanwhile
        for t, states in list(self._kv_sessions.items()):
            tel = [paged_kv.pool_telemetry(s) for s in states.values()]
            every += tel
            out[t] = {"policy": self.cfg.kv_policy,
                      "ghost_hits": self._kv_ghost_hits.get(t, 0),
                      "p_mean": torch.stack([x["p_mean"] for x in tel]).mean(),
                      "p_max": torch.stack([x["p_max"] for x in tel]).amax()}
        if every:
            out["p_mean"] = torch.stack([x["p_mean"] for x in every]).mean()
            out["p_max"] = torch.stack([x["p_max"] for x in every]).amax()
            out["resident_mean"] = torch.stack([x["resident_mean"] for x in every]).mean()
        return out

    def telemetry(self) -> dict:
        """One flat namespaced snapshot of every surface the engine serves
        from (``Registry.snapshot``): engine counters and the decode-loop
        planes (``serve/...``, ``serve/loop/...``), the prompt cache
        (``prefix/...``, or ``tenant/<t>/...`` per tenant, whose
        ``hit_ratio`` is the exact float64 division of the pulled counters),
        in the paged mode the pool (``kv/pool/...``) and per tenant with a
        persisted session its ghost hits and ``p`` (``kv/<t>/...``) with
        ``p`` and residency over every session (``kv/p_mean``, ``kv/p_max``,
        ``kv/resident_mean``), an attached expert cache (``expert/...``), the
        host spans (``span/...``), the compile counters (``compile/...``)
        and the profiler's cadence (``profiler/...``).  One synchronization
        in all; it waits for a capture or graph loop in progress (the
        engine's lock)."""
        with self._lock:
            return self.registry.snapshot()
