"""On-card smoke run of the PyTorch / CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``.  Phase by phase, each printing one JSON
line, any failure raising (non-zero exit, no result line).  Kernels 4 and 5
take the token position as a 0-d int32 tensor they read from device memory.
Every served phase (``serve``, ``serve_adaptive``, ``serve_gemma3``,
``serve_phi35``, ``serve_qwen25``, ``serve_zamba2``, ``serve_mamba2``,
``serve_whisper``, ``serve_internvl2``) runs
its requests through the engine's decode graph
(``jit_loop=True``: one captured CUDA graph per batch size, replayed once per
token under sync debug mode ``"error"``) and then the same requests through
the host loop (``jit_loop=False``) on the same parameters: greedy tokens,
stats (but the clocks and the graph count), launch counts after every
request list, the final policy planes of every decode loop (bitwise), the
snapshot's decode-loop planes ``serve/loop/*`` after every request list
(bitwise; ``steps`` == the sampling events) and the ghost sessions must be
equal (``loops_agree``), and the decode-step profile runs both loops side by
side:

1. ``build``: compile the CUDA kernels with nvcc (sm_90a) from the sources in
   this checkout; print the seconds taken and the card's name and power
   limit (``nvidia-smi``).  Then the checks that need no card (host
   oracles, plain versions and the sweep's eager route on the CPU) start
   in worker processes (``submit_host_jobs``), for the phases that read
   them later.
2. ``paged_attention``: the decode-attention kernel (kernel 3) at the
   slice's decode shape with the default pool (B=4, P=256, page=64, KVH=5,
   G=3, hd=64, bf16), at the serve phase's (P=16) and at gemma3-27b's global
   layers' (B=4, P=16, page=64, KVH=16, G=2, hd=128), against its plain
   PyTorch version (bf16 out within one bf16 ulp, f32 mass within
   MASS_RTOL), its output repeated bit for bit over 6 launches; kernel,
   plain and SDPA times beside the byte bound, with the grid's CTA count,
   the achieved GB/s and bound_ms / ms; the same at zamba2-7b's shared
   attention (B=4, P=16, page=64, KVH=32, G=1, hd=112: the fold's second
   64-dim slice is partial); then a ragged pool (5 free pages, each
   sequence's ``cur`` elsewhere mid-page) at P=256, gemma3's and zamba2's
   shapes.
3. ``policy_attn``: the fused policy-attention step from a full pool,
   AWRP over 3*page decode steps so every page boundary evicts at P=16
   and over two evicting boundaries at P=256, and each other page policy
   over two evicting boundaries at P=16: (a) bitwise equal to the unfused chain insert_token +
   paged_attention kernel + score_update, (b) within phase 2's tolerances
   of its plain version, planes equal except at steps where a page's plain
   mass lies within EPS_TAU of tau (counted); the AWRP runs timed like
   phase 2, the timed (evicting) step repeated bit for bit over 6
   launches; AWRP again at gemma3's decode shape, at phi3.5-moe's (B=4,
   P=16, page=64, KVH=8, G=4, hd=128), and over one evicting boundary
   (page steps; the timed step the next boundary) at qwen2.5-14b's (KVH=8,
   G=5), yi-34b's (KVH=8, G=7), zamba2-7b's (KVH=32, G=1, hd=112) and
   internvl2-26b's (KVH=8, G=6).
3a. ``flash_attn``: kernel 6, the prefill attention, against its plain
   version (bf16 within one bf16 ulp, f32 within F32_OUT_RTOL) at gemma3's
   prefill shape (4, 2048, 16, 2, 128) with window 1024 and 0, smollm's
   (4, 1024, 5, 3, 64), phi3.5-moe's (4, 2048, 8, 4, 128) causal, a ragged
   S=1000 with window 48, non-causal, a ``kv_len`` mask, f32 and hd=256,
   qwen2.5's (4, 2048, 8, 5, 128), yi's (4, 2048, 8, 7, 128) and zamba2's
   (4, 2048, 32, 1, 112) causal, f32 at hd=112 with window 100, whisper's
   encoder (4, 1500, 20, 1, 64) non-causal (a ragged last tile), its
   cross-attention (4, 448, 20, 1, 64) over 1500 keys (Sq != Skv,
   non-causal), internvl2's (4, 2048, 8, 6, 128) causal, and whisper at
   the shapes serve_whisper gives it: the encoder (4, 1504, 20, 1, 64),
   the decoder's self-attention (4, 3008, 20, 1, 64) causal and its
   cross-attention over 1504 keys; each row's inputs from a generator of
   its own (seeded by its label), each repeated bit for bit over 6
   launches; kernel, plain and SDPA times (same mask; SDPA without a mask
   where every key is attended) beside the bound over the unmasked (query
   head, key) pairs; the HMMA instructions of each bf16 instantiation in
   the built library (``cuobjdump -sass``); every row also with the rows'
   log-sum-exp on (``return_lse``): ``out`` bit for bit the same, lse within
   LSE_RTOL/ATOL of the plain version's.  Then ``flash_gate_draws``:
   every row's gate again at FLASH_DRAWS further draws of its inputs.
3b. ``flash_bwd``: the backward kernel (``csrc/flash_attn_bwd.cu``: the
   preprocess, dK/dV and dQ launches) against its plain version at
   smollm's training microbatch (4, 4096, 5, 3, 64) causal, gemma3's (1,
   4096, 16, 2, 128) with window 1024 and 0, zamba2's (1, 2048, 32, 1, 112),
   a ragged (1, 1000, 4, 2, 64) with window 48 and a non-causal (2, 300,
   4, 3, 128), each in f32 and in bf16; the train_families cells' G = 6
   (internvl2, (1, 4096, 8, 6, 128)) and G = 4 (phi3.5-moe, (1, 4096, 8, 4,
   128)), causal, each in bf16 and f32; then at Sq != Skv and under a
   ``kv_len`` mask, each in bf16 and f32: whisper's training
   cross-attention at its cell's microbatch (1, 448, 20, 1, 64) and at (8,
   448, 20, 1, 64) over its 1500 encoder keys, non-causal, a causal (2,
   1000, 4, 2, 128) over 700 keys and a (2, 500, 4, 3, 112) over 1000 keys
   with kv_len 700: the plain version takes the
   kernel's own out and lse; bf16 dq / dk / dv within BWD_REL_L2 relative
   L2 of the plain f32 result, f32 elementwise within BWD_F32_RTOL *
   max|plain| + BWD_F32_ATOL, lse within LSE_RTOL/ATOL, ``out`` bit for bit
   with lse on and off, the gradients bit for bit over 6 launches; kernel,
   plain and SDPA-backward times beside the bound (10 * hd flops per
   unmasked pair, or the bytes); kernel 6 with lse off and on at smollm's
   training shape; the HMMA instructions of every backward function in the
   built library (each bf16 dK/dV and dQ function must hold some) and
   their registers, spills and static shared memory from ptxas's log.
3c. ``train``: smollm-360m at published widths (32 layers, d 960, vocab
   49152; bf16 parameters, f32 master and Adam states, remat full, 2
   microbatches) trained at train_4k's 4096 tokens, its global batch cut
   from 256 to 8, on ``SyntheticLM`` seed 0 with the launcher's
   ``OptConfig``: a warm-up step and 4 timed steps (the last profiled), each
   with its wall and event ms, tokens/s, peak GB and launches (kernel 6:
   layers x microbatches x 2, the forward and remat's recompute; the
   backward: layers x microbatches; no plain attention), losses and grad
   norms finite, the parameters changing every step, beside the step's
   flop bound (the function's flops; remat's recompute reported apart);
   then smollm's SMOKE_CONFIG (hd 64) in f32: 3 steps on the card
   against the same 3 on the CPU (TRAIN_CPU_RTOL), two card runs bit for
   bit, ``run_resilient`` with a failure injected at step 4 bit for bit
   equal to an uninterrupted run, and a checkpoint round trip of the card's
   trained state, its parameters cast to bf16, bit for
   bit.
3c'. ``train_mesh``: the placed train step (``make_train_step(mesh=)``:
   DTensor parameters placed by the logical-axis rules, the model on
   DTensors, kernel 6 and its backward on the local heads under
   ``local_map``) on smollm-360m as ``train`` runs it, in a world of one
   NCCL rank on a (1, 1) ("data", "model") mesh: 2 placed steps against 2
   plain steps from the same initial state, parameters, master, m, v and
   losses bit for bit, kernel 6 and backward launches equal; ms a step,
   tokens/s and peak GB beside ``train``'s.  Two gloo ranks sharing the
   card are not run (the functional collectives' all-gather faults on a
   gloo group with CUDA tensors); the CPU tests hold the multi-rank meshes.
3d. ``train_families``: the other families' training at published widths
   (bf16 parameters, the config's optimizer rule, remat full, its
   microbatches), one warm-up and 2 timed steps each, with wall and event
   ms, tokens/s, peak GB and kernel 6 / backward launches (gated at the
   counts reckoned from the config), losses and grad norms finite, every
   master leaf changing, beside the step's flop bound: whisper-large-v3
   whole (32 + 32 layers) on 8 sequences of its 1500 zero frames and 448
   tokens (kernel 6 non-causal in the encoder, causal in the decoder and
   at 448 over 1500 in the cross-attention, each with its backward);
   mamba2-370m whole at 16 x 4096 (no kernel runs); zamba2-7b at 9 of 81
   blocks (one repeat of its unit and its tail) at 4 x 4096; phi3.5-moe at
   1 of 32 layers and internvl2-26b at 2 of 48 (its 256 patch positions),
   8 x 4096; grok-1 is not run (one layer at published width is ~4.8 B
   parameters).  Then every moe, ssm, hybrid, vlm and enc-dec family's
   SMOKE_CONFIG in f32 (hd 64 where it has attention): 2 steps of 4 x 128
   tokens on the card against the same 2 on the CPU (the CPU runs in the
   worker processes): losses, grad norms and the first batch's gradients
   leaf by leaf within TRAIN_CPU_RTOL, and the final parameters within it
   on the elements whose first-batch gradient is 0 or at least
   TRAIN_PARAMS_GRAD_FLOOR (every element's distance reported); two card
   runs bit for bit (the moe family's repeatability reported, not gated).
4. ``serve``: ``ServeEngine`` on smollm-360m at published widths, bf16,
   paged KV with AWRP through the fused kernel (kernel 4: two launches per
   layer per decode step, ``ops.SPLIT_LAUNCHES``), 4 requests of 1024 seeded
   tokens and 96 greedy new tokens, then one repeated prompt that must hit
   the prefix cache; kernel 6 launched once per layer per prefill; the
   split kernels' arrival counters of the engine's capture stream are 0
   after the replays.  Then the fold's cost: the 4 prompts served for 64
   tokens with ``metrics=True`` and ``metrics=False`` (tokens equal), each
   one's graph ms per step, and the decode graph profiled both ways (wall ms
   and kernels per step); and one ``telemetry()`` snapshot under
   ``torch.profiler``: exactly one synchronizing CUDA call and one ``_pull``
   per snapshot, the device-to-host copies and the snapshot's wall ms.
4a. ``adaptive_attn``: kernel 5, the fused true-adaptive ARC/CAR step, for
   arc and car from a full pool over two evicting page boundaries at the
   serve shape (from the prefill seeding, with a forced stamp
   renormalization, and from a ghost-hit reseed with p != 0) and at P=256
   (L=512) across one: bitwise equal to the unfused chain
   adaptive_insert_token + paged_attention kernel + adaptive_score_update,
   and within phase 2's tolerances of its plain version with every plane
   equal except at near-tau steps (counted); timed at the serve shape and
   at gemma3's, phi3.5-moe's, qwen2.5's, yi's, zamba2's and internvl2's
   decode shapes
   (arc; the last six over two steps, an evicting boundary and a mid-page
   step: gemma3's and phi3.5's were cut from two evicting boundaries to
   make room for train_families in the time limit), at a page boundary and
   mid-page, both repeated bit for bit over 6 launches, as at P=256.
4b. ``serve_adaptive``: the serve phase's model and pool with
   ``kv_policy`` arc_adaptive and car_adaptive: 4 x 1024-token prompts and 64
   greedy tokens (cut from 96 for the time limit), then single requests A
   and B (distinct 1024-token prompts),
   B's follow-up turn (its re-prefill ghost-hits the pages B's decode
   evicted and moves p) and A again (a prefix hit); kernel 5 called once
   per layer per decode step (two launches, ``ops.SPLIT_LAUNCHES``).
4c. ``serve_gemma3``: gemma3-27b at published widths and all 62 layers (10
   x (5 local + 1 global) + 2 local, window 1024), bf16, random weights from
   SEED drawn on the card, a 16-page pool (the one cut): 4 prompts of 2048
   seeded tokens and 64 greedy new tokens (AWRP, kernel 4 on the 10 global
   layers, sliding-window rings on the 52 local ones, kernel 6 in every
   layer of every prefill), one prompt alone twice (a prefix hit), then
   ``arc_adaptive`` (kernel 5) on the same weights: a 1024-token request and
   its follow-up turn, whose re-prefill ghost-hits the pages the first
   turn's decode evicted; a decode-step profile and the peak memory.
4e. ``serve_phi35``: phi3.5-moe (16 SwiGLU experts of d_ff 6400, top-2,
   capacity factor 1.0; d 4096, 32/8 heads, hd 128, vocab 32064) at
   published widths, bf16, random weights from SEED drawn on the card, cut
   to 24 of 32 layers (the 32 layers' 83.7 GB of weights do not fit the
   card) and a 16-page pool: 4 prompts of 2048 seeded tokens and 64 greedy
   tokens (AWRP: kernel 4 twice per layer per decode step, kernel 6 in
   every layer of every prefill; the MoE FFN in torch ops, every expert
   over its capacity buffer, as in the reference; first, layer 0's MoE FFN
   at the prefill shape (4, 2048, 4096): its routing bitwise equal to the
   CPU's on the same f32 logits, with pairs dropped by capacity, and its
   output within one bf16 ulp plus MOE_ROW_TOL of a plain loop over the
   routed experts), one prompt alone twice
   (a prefix hit whose ``entry_bytes`` equals the payload's tensor bytes),
   then ``arc_adaptive`` (kernel 5): a 1024-token request and its follow-up
   turn (ghost hits); a decode-step profile beside the step's byte bound,
   prefill seconds, decode tokens/s and the peak memory.
4f. ``serve_qwen25``: qwen2.5-14b (QKV bias; d 5120, 40/8 heads, G 5, hd
   128, d_ff 13824, vocab 152064) at published widths and all 48 layers,
   bf16, random weights from SEED drawn on the card with the q/k/v biases
   drawn nonzero (N(0, QKV_BIAS_STD); the reference inits them to zeros),
   a 16-page pool (the one cut): 4 prompts of 2048 seeded tokens and 32
   greedy tokens (AWRP: kernel 6 in every layer of every prefill, kernel 4
   twice per layer per decode step), then one ``arc_adaptive`` request of
   1024 tokens (kernel 5 at G = 5); a decode-step profile beside the step's
   byte bound (``step_bound``), prefill seconds, tokens/s, peak memory.
4g. ``serve_zamba2``: zamba2-7b (13 x (5 Mamba-2 + 1 shared-attention
   block, whose one parameter set all 13 occurrences run) + 3 Mamba-2; d
   3584, 32 heads of hd 112, G 1; SSM d_inner 7168, 112 heads of 64, state
   64, chunk 256) at published widths and all 81 blocks, bf16, random
   weights from SEED, 16 pages per shared-attention occurrence (the one
   cut): first ``mamba_layer_check`` (block 0's ``mamba2_block`` at (4,
   2048, 3584) against a plain f32 token-by-token recurrence from the same
   weights, then one ``mamba2_decode_step`` from its state, each within
   MAMBA_REL_TOL relative L2), then 4 prompts of 2048 seeded tokens and 32
   greedy tokens (AWRP: kernel 6 at hd = 112 in each occurrence of every
   prefill, kernel 4 twice per occurrence per decode step); a decode-step
   profile beside its byte bound, prefill seconds, tokens/s, peak memory.
4h. ``serve_mamba2``: mamba2-370m (48 Mamba-2 blocks, d 1024, 32 heads of
   64, state 128) at published widths and depth, bf16, random weights from
   SEED: 4 prompts of 1024 seeded tokens and 16 greedy tokens (32 until the
   rows_mesh phase took their seconds), then one of
   them alone twice: the second hits the prefix cache (the SSM states
   after prefill), skips its prefill and repeats its tokens, the cache's
   ``entry_bytes`` == the payload's bytes from its shapes.  Attention-free:
   no kernel of the port runs (every launch count 0, said in the kernel
   summary).  In 4g and 4h both loops' final SSM states are also equal bit
   for bit, position by position.
4i. ``serve_whisper``: whisper-large-v3 (32 encoder + 32 decoder layers, d
   1280, 20 heads of hd 64, G 1, GELU, sinusoidal positions, vocab 51866)
   at published widths and depth, bf16, random weights from SEED, with full
   KV caches (``kv_mode="full"``: the decode graph captures the self cache's
   row write at the device ``pos``): 4 prompts of 3008 seeded tokens, so
   the encoder runs over 1504 zero frames, and 32 greedy tokens; kernel 6
   launched 96 times a prefill (encoder non-causal, decoder self causal,
   cross-attention at Sq = 3008 over Skv = 1504; whisper itself decodes at
   most 448 tokens, so the decoder's context here is 6.7 times its own);
   the decode attention, self
   and cross, is plain torch (the reference's is jnp); then one prompt
   alone twice (a prefix hit that skips its prefill) and the cross K/V
   held bit for bit over graph and eager steps; a decode-step profile
   beside its byte bound (decoder weights, self K/V rows at or before the
   position, cross K/V), prefill seconds, tokens/s, peak memory.
4j. ``serve_internvl2``: internvl2-26b's language backbone (d 6144, 48 / 8
   heads of hd 128, G 6, d_ff 16384, vocab 92553; 256 patch positions) at
   published widths and INTERNVL2_LAYERS layers, bf16, random weights from
   SEED, a 16-page pool (the cut): 4 prompts of 2048 seeded tokens whose
   first 256 positions take the engine's zero patch embeddings, 32 greedy
   tokens (AWRP: kernel 6 in every layer of every prefill, kernel 4 twice
   per layer per decode step); a decode-step profile beside its byte
   bound, prefill seconds, tokens/s, peak memory.
5. ``awrp_select``: the two AWRP victim-selection kernels against their
   plain versions, exact equality of the victims, at the sweep's shapes
   (kernel 2) and the serve pool's (kernel 1), tie-heavy and all-invalid
   rows included; timed beside their byte bound.
6. ``sweep``: the paper's Table 1 through ``repro_torch.core.sweep`` on the
   card on the engine's trace route (one ``flat_sweep`` and two
   ``adaptive_sweep`` launches, no kernel-2 launch, no host sync; equal to
   the host oracles' table), a 64-trace grid and a num_sets=2 grid (with and
   without forced renormalization): trace route == eager route (on the
   CPU, in worker processes, but for Table 1) == host oracles, each trace
   kernel's final planes == its plain version's on the card; the
   sweep benchmark's 10k- and 100k-access zipf traces (hit counts == host
   oracles'); kernel 2 on its per-step path (``FlatCore(use_kernel=True)``,
   200 steps) == the trace kernel; the trace kernels timed alone; a profile
   of the trace route on the grid.
4d. ``serve_tenants`` (after ``serve_adaptive``): multi-tenant serving of
   smollm-360m at published widths, tenants {calm: 2, busy: 2, hog: 1}
   behind the admission controller with ``auto_rebalance``, 1024-token
   single requests: AWRP pages (kernel 4) with the awrp prefix core (the
   flat stream kernel), then ``arc_adaptive`` pages (kernel 5) with the arc
   prefix core (the ARC/CAR stream kernel); the hog goes ok -> deferred ->
   shed, a shed request touches nothing, per-tenant counters == host
   oracles and a CPU replay, ``decide_batch`` == the host loop, A's ghost
   hits == a single-tenant engine's, deferred tokens == an unpressured
   engine's; the snapshot's ``tenant/<t>/{hits, misses, evictions,
   accesses}`` == the host oracles and the CPU replay, one synchronization
   per snapshot (as in ``serve``); in the AWRP run, a ``MetricsServer``
   polled by a client thread while the engine captures a new decode graph
   (a batch of 2) and replays it: no error, no 500, the batch's tokens == a
   fresh engine's, and ``/metrics.json`` == ``telemetry()`` afterwards.  Both
   runs serve ring-off; then each run's requests are served again, in order,
   on a fresh engine that traces decisions (``decision_trace=256``: every
   prefix-cache access launches the stream kernels' ring variant): statuses,
   tokens, rebalances, final planes and counters == the ring-off run's; the
   drained access events == a CPU replay's (which carries a ring too),
   bitwise; the admission events' codes == the decisions ``decide_batch``
   returned; one synchronizing CUDA call per drain (``torch.profiler``);
   ``opt_regret()``'s gauges in ``telemetry()`` == ``regret_from_records``
   on the replay's records.
6a. ``rows_mesh`` (after ``sweep``): the rows mesh (``core/sharding.py``)
   on meshes that repeat the card, each shard on a stream of its own, every
   sharded run held bitwise to the unsharded port on the card: (a) the
   64-trace grid of ``sweep`` (b) on the trace route at 2 and 8 shards, hits
   == ``sweep``'s unsharded hits, n flat_sweep and 2n adaptive_sweep
   launches, no host sync, the seconds beside the unsharded call's; (b)
   kernels 4 (awrp) and 5 (arc_adaptive) at the serve shape at 2 and 4
   shards from a full pool over two evicting page boundaries: out, mass
   and every plane == the unsharded step's, n x its launches per call;
   (c) the serve phase's model, parameters (kept in host memory from
   ``serve_tenants`` on) and 4 prompts of 1024 tokens at 2 shards, AWRP
   fused, the graph loop, 32 tokens: each shard's tokens, loop planes and
   pool planes == an unsharded engine serving its two requests, n x the
   launches, one synchronizing call per snapshot (its K/V, and equality
   with the unsharded engine on all four requests, reported); (d) tenancy:
   3 tenants padded to 4 rows on 2 shards, the 6000-access stream with a
   4096-event ring, then ``decide_batch``: hits, counters, codes and the
   drained records == the unsharded manager's.
7. ``tenancy``: the trace kernels' stream mode (the tenancy manager's
   ``access_stream`` and ``access``) == its plain version (the same manager
   on the CPU, in worker processes) on the tenancy benchmark's 6000-access
   stream for all six policies, in 8 chunks with rebalances, at quotas
   (200, 100, 40), with forced renormalization, access by access; == the
   host oracles there and at 100 000 accesses; one launch and no host sync
   per call; timed through the manager's own launch (``stream_call``).
   The ring variant: the six policies on the 6000-access stream with a
   4096-event ring (it wraps): hits, planes and counters == the ring-off
   run's, bitwise, the drained row / key / hit == the stream's tail and the
   ring-off hits; on a 600-access prefix (100, then 500) into a 256-event
   ring, the new ring (``buf[:cap]``, ``count``) == the plain version's on
   the card, bitwise, for the six policies at quotas 16/16/16, arc and car
   with ``renorm_at=64``, awrp and lfu at quotas (200, 100, 40); ms per call
   with the ring on and off, at 6000 accesses and at one access (rings of
   256 and 65 536 events).
8. ``expert_cache``: ``ExpertCacheRuntime(device="cuda")`` on the card for
   awrp, lru, fifo, lfu, arc and car: the expert-cache benchmark's three
   20 000-access router traces, each as one ``route(0, trace)`` (one stream
   launch) == the host path's hits and transfers; its runtime section (16
   layers x top-2 x 400 steps of zipf(1.3) % 16, capacity 8): every
   ``route_step`` (one launch each) == the host path, and ``route`` layer
   by layer == ``route_step``; microseconds per ``route_step`` on both
   paths.

Then both loops of every served phase side by side (``decode_loops``), the
``telemetry`` line (a snapshot's key count, one pull's ms, its
synchronizing calls, the kernel library's nvcc seconds, the fold's cost,
the live endpoint), the total seconds, the kernel summary line, the
``nvidia-smi`` line and, last, the result line.  Every kernel time is a median of CUDA-event
timings on this card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import re
import json
import math
import statistics
import subprocess
import sys
import threading
import time
import zlib
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.cache import paged_kv  # noqa: E402
from repro_torch.configs.gemma3_27b import CONFIG as GEMMA3  # noqa: E402
from repro_torch.configs.internvl2_26b import CONFIG as INTERNVL2  # noqa: E402
from repro_torch.configs.mamba2_370m import CONFIG as MAMBA2  # noqa: E402
from repro_torch.configs.phi35_moe import CONFIG as PHI35  # noqa: E402
from repro_torch.configs.qwen25_14b import CONFIG as QWEN25  # noqa: E402
from repro_torch.configs.smollm_360m import CONFIG  # noqa: E402
from repro_torch.configs.whisper_large_v3 import CONFIG as WHISPER  # noqa: E402
from repro_torch.configs.zamba2_7b import CONFIG as ZAMBA2  # noqa: E402
from repro_torch.core.kv_policy import PAGE_POLICIES  # noqa: E402
from repro_torch.core.sharding import tree_map  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.models.model import MambaCache  # noqa: E402
from repro_torch.kernels.paged_attn import (  # noqa: E402
    paged_attention_kernel, split_ctas)
from repro_torch.kernels.policy_attn import (  # noqa: E402
    adaptive_policy_paged_attention_kernel, policy_paged_attention_kernel)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_FLOPS = 67e12  # H100 SXM float32 peak outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
# bf16 output: kernel and plain round f32 sums that differ only in summation
# order, so they may differ by one bf16 ulp of the value (8-bit significand:
# at most 2**-7 of |value|), plus an f32-level floor for values near 0
OUT_RTOL = 2.0 ** -7
OUT_ATOL = 1e-6
# f32 mass (each row sums to KVH*G over its pages): summation order and exp
# ulps only, a few f32 ulps of the value
MASS_RTOL = 1e-5
MASS_ATOL = 1e-7
# f32 flash attention: kernel and plain differ in summation order over up to
# 2048 keys (tile by tile with a running max against one softmax), some
# f32 ulps of the terms
F32_OUT_RTOL = 1e-4
F32_OUT_ATOL = 1e-5
EPS_TAU = 1e-5  # a plain mass this close to tau may flip a decision
# the backward's gates: bf16 gradients (f32 sums of bf16 inputs, rounded
# once) within this relative L2 of the plain f32 result; f32 gradients
# elementwise within BWD_F32_RTOL * max|plain| + BWD_F32_ATOL (summation
# order over up to 4096 rows); the forward's lse within LSE_RTOL * |plain| +
# LSE_ATOL (m + log(l) in f32 against one softmax)
BWD_REL_L2 = 2.0 ** -6
BWD_F32_RTOL = 1e-4
BWD_F32_ATOL = 1e-5
LSE_RTOL = 1e-5
LSE_ATOL = 1e-6
# MoE gates (f32, K choices normalised): ``exp`` rounds differently on the
# card and the CPU, a few f32 ulps of the gate
MOE_GATE_RTOL = 2.0 ** -20
# MoE FFN output beside its plain loop: the two round the same f32 products
# to bf16 where only the summation order differs, so a product may land one
# bf16 ulp apart and carry into the down projection; bounded by this share
# of the token's contribution scale (rms over d of |c0| + |c1|), where a
# pair routed, dropped or weighted wrongly is off by about a whole one
MOE_ROW_TOL = 2.0 ** -5
SEED = 0


#: the script's start, for each phase line's ``t_s``
T0 = time.perf_counter()


def emit(obj) -> None:
    """Print ``obj`` as one JSON line; a phase line also gets ``t_s``, the
    seconds since the script started."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T0}
    print(json.dumps(obj), flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


#: worker processes for the checks that need no card (host oracles, plain
#: versions on the CPU): ``main`` submits them right after the build, so they
#: run while the card works through the phases before the ones that read
#: them (``host_jobs``)
HOST_WORKERS = 4
_HOST_POOL = None
_HOST_JOBS: dict = {}


def host_job(fn, *args):
    """The future of ``fn(*args)`` in a worker process: the one
    ``submit_host_jobs`` submitted ahead, else one submitted now.  ``fn``
    must be a module-level function (the workers are spawned and import this
    file)."""
    global _HOST_POOL
    key = (fn.__name__, repr(args))
    if key in _HOST_JOBS:
        return _HOST_JOBS.pop(key)
    if _HOST_POOL is None:
        import concurrent.futures
        import multiprocessing

        _HOST_POOL = concurrent.futures.ProcessPoolExecutor(
            max_workers=HOST_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    return _HOST_POOL.submit(fn, *args)


def submit_host_jobs() -> None:
    """Submit every later phase's card-free check (``host_jobs``)."""
    for fn, *args in host_jobs():
        _HOST_JOBS[(fn.__name__, repr(tuple(args)))] = host_job(fn, *args)


def stop_host_workers() -> None:
    """Drop what was not yet started and stop the worker processes."""
    global _HOST_POOL
    _HOST_JOBS.clear()
    if _HOST_POOL is not None:
        _HOST_POOL.shutdown(wait=True, cancel_futures=True)
        _HOST_POOL = None


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of CUDA-event timings of ``fn()`` on the current stream."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def excess(got, plain, rtol: float, atol: float) -> float:
    """Largest |got - plain| over its limit ``rtol * |plain| + atol``: at most
    1 when the two agree within tolerance."""
    g, p = got.float(), plain.float()
    return ((g - p).abs() / (rtol * p.abs() + atol)).max().item()


def valid_rows(page_start, cur_pos, page: int) -> int:
    """Key rows the decode step must read: resident rows at or before cur."""
    row = torch.arange(page, device=page_start.device)
    tok = page_start[..., None] + row
    return int(((page_start[..., None] >= 0) & (tok <= cur_pos[:, None, None])).sum())


def decode_bytes(q, k_pages, rows: int, extra_bytes: int = 0) -> int:
    """Bytes one decode step over ``rows`` key rows must move: each K/V row,
    the query, the output, the planes and ``extra_bytes`` once."""
    B, P, page, KVH, hd = k_pages.shape
    esz = k_pages.element_size()
    return (rows * KVH * hd * 2 * esz + 2 * q.numel() * esz + B * P * 4 * 5
            + extra_bytes)


def bound(q, k_pages, rows: int, extra_bytes: int = 0):
    """(bound_ms, bound_by) of one decode step over ``rows`` key rows:
    ``decode_bytes`` at the HBM rate against the flops of the two products
    at the float32 peak."""
    B, P, page, KVH, hd = k_pages.shape
    G = q.shape[2]
    nbytes = decode_bytes(q, k_pages, rows, extra_bytes)
    flops = rows * KVH * G * hd * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa_ms(q, k_pages, v_pages, page_start, cur_pos) -> float:
    """One PyTorch call computing the same ``out`` (the yardstick; the port
    never calls it)."""
    import torch.nn.functional as F

    B, P, page, KVH, hd = k_pages.shape
    G = q.shape[2]
    kk = k_pages.reshape(B, P * page, KVH, hd).transpose(1, 2).contiguous()
    vv = v_pages.reshape(B, P * page, KVH, hd).transpose(1, 2).contiguous()
    row = torch.arange(page, device=q.device)
    tok = page_start[..., None] + row
    mask = ((page_start[..., None] >= 0) & (tok <= cur_pos[:, None, None]))
    mask = mask.reshape(B, 1, 1, P * page)
    qq = q.reshape(B, KVH * G, 1, hd)
    return time_ms(lambda: F.scaled_dot_product_attention(
        qq, kk, vv, attn_mask=mask, enable_gqa=True))


def split_fields(q, k_pages, rows: int, ms: float, bound_ms: float) -> dict:
    """Kernels 3 and 4: the CTAs of both grids (partials and fold), the
    achieved rate of the bytes the step must move, and bound_ms / ms (the
    share of the byte bound)."""
    B, P, page, KVH, hd = k_pages.shape
    return {"ctas": split_ctas(B, P, KVH, q.shape[2], hd),
            "gb_per_s": decode_bytes(q, k_pages, rows) / (ms * 1e-3) / 1e9,
            "bound_over_ms": bound_ms / ms}


def assert_repeatable(fn, reps: int = 5) -> int:
    """``fn()`` ``reps`` more times gives the first call's bits on every
    output (the result must not depend on which CTA folds)."""
    first = fn()
    for _ in range(reps):
        for a, b in zip(first, fn()):
            assert torch.equal(a, b), "a repeated launch changed its output"
    return reps + 1


def dpos(pos: int, dev) -> torch.Tensor:
    """A decode position as kernels 4 and 5 take it: a 0-d int32 tensor on
    the card, read by the kernels from device memory."""
    return torch.tensor(pos, dtype=torch.int32, device=dev)


def decode_inputs(gen, B, P, page, KVH, G, hd, dtype, dev, *, n_free=0):
    """A full (or ``n_free``-short) pool of seeded K/V with shuffled pages,
    its query and the next token's K/V row."""
    def rnd(*shape, s=1.0):
        return (torch.randn(*shape, generator=gen) * s).to(dtype).to(dev)

    q = rnd(B, KVH, G, hd)
    k = rnd(B, P, page, KVH, hd, s=0.5)
    v = rnd(B, P, page, KVH, hd, s=0.5)
    order = torch.stack([torch.randperm(P, generator=gen) for _ in range(B)])
    ps = (order * page).to(torch.int32)
    if n_free:
        ps[:, :n_free] = -1
    return q, k, v, ps.to(dev), rnd(B, KVH, hd, s=0.3), rnd(B, KVH, hd, s=0.3)


def phase_build() -> dict:
    t0 = time.perf_counter()
    info = _build.build()
    _build.library()
    # disassembled meanwhile for phases flash_attn and flash_bwd
    threading.Thread(target=_sass, args=(info.path,), daemon=True).start()
    res = {"phase": "build", "seconds": time.perf_counter() - t0,
           "nvcc_seconds": info.seconds, "library": str(info.path.name),
           "card": smi()}
    usage = [ln.strip() for ln in info.log.splitlines()
             if "registers" in ln or "spill" in ln]
    res["ptxas"] = usage
    emit(res)
    return res


DECODE_SHAPE = (4, 256, 64, 5, 3, 64)  # B, P, page, KVH, G, hd


def phase_paged_attention(dev, shape=DECODE_SHAPE, *, ragged: bool = False,
                          timed: bool = True) -> dict:
    """Kernel 3 against its plain version on a pool with 3 free pages and
    every sequence at its last row (a full last page), or with ``ragged`` 5
    free pages and each sequence's ``cur`` elsewhere mid-page (partly filled
    pages, whole pages past ``cur``); timed and checked for repeatable bits."""
    B, P, page, KVH, G, hd = shape
    gen = torch.Generator().manual_seed(SEED + (11 if ragged else 0))
    q, k, v, ps, _, _ = decode_inputs(gen, B, P, page, KVH, G, hd,
                                      torch.bfloat16, dev, n_free=5 if ragged else 3)
    last = P * page - 1
    if ragged:
        back = [page // 2 + 1, 3, page + 7, 2 * page + 31]
        cur = torch.tensor([last - back[b % 4] % (P * page // 2) for b in range(B)],
                           dtype=torch.int32, device=dev)
    else:
        cur = torch.full((B,), last, dtype=torch.int32, device=dev)
    out, mass = paged_attention_kernel(q, k, v, ps, cur)
    out_p, mass_p = ref.paged_attention_plain(q, k, v, ps, cur)
    torch.cuda.synchronize()
    err_out = (out.float() - out_p.float()).abs().max().item()
    err_mass = (mass - mass_p).abs().max().item()
    out_x = excess(out, out_p, OUT_RTOL, OUT_ATOL)
    mass_x = excess(mass, mass_p, MASS_RTOL, MASS_ATOL)
    assert torch.isfinite(out.float()).all() and torch.isfinite(mass).all()
    assert out_x <= 1.0 and mass_x <= 1.0, (err_out, out_x, err_mass, mass_x)
    rows = valid_rows(ps, cur, page)
    res = {"phase": "paged_attention", "shape": [B, P, page, KVH, G, hd],
           "dtype": "bfloat16", "pool": "ragged" if ragged else "full last page",
           "cur_pos": cur.tolist(), "free_pages": 5 if ragged else 3,
           "valid_rows": rows, "max_abs_err_out": err_out,
           "out_err_over_tol": out_x, "mean_abs_out": out_p.float().abs().mean().item(),
           "max_abs_err_mass": err_mass, "mass_err_over_tol": mass_x,
           "max_mass": mass_p.max().item(), "tol_out": [OUT_RTOL, OUT_ATOL],
           "tol_mass": [MASS_RTOL, MASS_ATOL],
           "repeat_launches_equal": assert_repeatable(
               lambda: paged_attention_kernel(q, k, v, ps, cur))}
    if timed:
        bnd, by = bound(q, k, rows)
        ms = time_ms(lambda: paged_attention_kernel(q, k, v, ps, cur))
        res.update({
            "ms": ms,
            "plain_ms": time_ms(lambda: ref.paged_attention_plain(q, k, v, ps, cur),
                                reps=5, warmup=1),
            "bound_ms": bnd, "bound_by": by,
            "library_ms": sdpa_ms(q, k, v, ps, cur),
            **split_fields(q, k, rows, ms, bnd)})
    emit(res)
    return res


def _unfused_step(pool, q, nk, nv, pos, page, policy):
    """insert_token + paged_attention kernel + score_update; the page mass
    goes in row 0 of each page so the hit rule's per-page sum is exact."""
    B, P = pool.f.shape
    KVH, G, hd = q.shape[1:]
    pool = paged_kv.insert_token(pool, nk.reshape(B, -1), nv.reshape(B, -1),
                                 dpos(pos, q.device), page, policy)
    cur = torch.full((B,), pos, dtype=torch.int32, device=q.device)
    out, mass = ops.paged_attention(q, pool.k.view(B, P, page, KVH, hd),
                                    pool.v.view(B, P, page, KVH, hd),
                                    pool.page_start, cur)
    row_mass = torch.zeros((B, P, page), dtype=torch.float32, device=q.device)
    row_mass[:, :, 0] = mass
    return out, mass, paged_kv.score_update(pool, row_mass.reshape(B, -1), page)


def phase_policy_attn(dev, policy: str = "awrp", shape=DECODE_SHAPE,
                      steps: int | None = None, timed: bool = True) -> dict:
    """``steps`` (default 3*page) fused decode steps from a full pool; the
    first allocates at a page boundary, so every ``page``-th step evicts."""
    B, P, page, KVH, G, hd = shape
    gen = torch.Generator().manual_seed(SEED + 1)
    _, k, v, ps, _, _ = decode_inputs(gen, B, P, page, KVH, G, hd,
                                      torch.bfloat16, dev)
    clock0 = 300
    pool = paged_kv.PagedPool(
        k=k.reshape(B, P, page, KVH * hd).contiguous(),
        v=v.reshape(B, P, page, KVH * hd).contiguous(),
        f=torch.randint(1, 9, (B, P), generator=gen, dtype=torch.int32).to(dev),
        r=torch.randint(1, clock0, (B, P), generator=gen, dtype=torch.int32).to(dev),
        page_start=ps,
        clock=torch.full((B,), clock0, dtype=torch.int32, device=dev),
        open_slot=torch.full((B,), P - 1, dtype=torch.int32, device=dev))
    pool_u = pool.clone()
    steps = 3 * page if steps is None else steps
    near_tau, err_out, out_x, err_mass, mass_x, abs_out = 0, 0.0, 0.0, 0.0, 0.0, 0.0
    ops.reset_launches()
    for i in range(steps):
        pos = P * page + i
        q = (torch.randn(B, KVH, G, hd, generator=gen)).to(torch.bfloat16).to(dev)
        nk = (torch.randn(B, KVH, hd, generator=gen) * 0.3).to(torch.bfloat16).to(dev)
        nv = (torch.randn(B, KVH, hd, generator=gen) * 0.3).to(torch.bfloat16).to(dev)
        plain = ref.policy_paged_attention_plain(
            q, pool.k.view(B, P, page, KVH, hd), pool.v.view(B, P, page, KVH, hd),
            nk, nv, dpos(pos, dev), pool.f, pool.r, pool.page_start, pool.clock,
            pool.open_slot, policy=policy)
        out_f, mass_f, pool = paged_kv.fused_decode_step(pool, q, nk, nv, dpos(pos, dev),
                                                         page, policy)
        out_u, mass_u, pool_u = _unfused_step(pool_u, q, nk, nv, pos, page, policy)
        # (a) fused == unfused, bitwise
        assert torch.equal(out_f, out_u), f"out differs at pos {pos}"
        assert torch.equal(mass_f, mass_u), f"mass differs at pos {pos}"
        for name, a, b in zip(pool._fields, pool, pool_u):
            assert torch.equal(a, b), f"plane {name} differs at pos {pos}"
        # (b) against the plain version
        err_out = max(err_out, (out_f.float() - plain[0].float()).abs().max().item())
        out_x = max(out_x, excess(out_f, plain[0], OUT_RTOL, OUT_ATOL))
        err_mass = max(err_mass, (mass_f - plain[1]).abs().max().item())
        mass_x = max(mass_x, excess(mass_f, plain[1], MASS_RTOL, MASS_ATOL))
        abs_out += plain[0].float().abs().mean().item() / steps
        psa = plain[5]
        tau = 1.0 / torch.clamp((psa >= 0).sum(dim=-1, keepdim=True).float(), min=1.0)
        close = ((plain[1] - tau).abs() < EPS_TAU) & (psa >= 0)
        planes_equal = all(torch.equal(a, b) for a, b in zip(
            plain[3:], (pool.f, pool.r, pool.page_start, pool.clock, pool.open_slot)))
        if bool(close.any()):
            near_tau += 1
        else:
            assert planes_equal, f"planes differ from the plain version at pos {pos}"
    launches = dict(ops.LAUNCHES)
    assert launches["policy_paged_attention"] == ops.SPLIT_LAUNCHES * steps, launches
    assert launches["paged_attention"] == ops.SPLIT_LAUNCHES * steps, launches
    assert out_x <= 1.0 and mass_x <= 1.0, (err_out, out_x, err_mass, mass_x)
    assert int((pool.clock - clock0).min()) == steps
    res = {"phase": "policy_attn", "policy": policy,
           "shape": [B, P, page, KVH, G, hd], "dtype": "bfloat16",
           "steps": steps, "evicting_steps": -(-steps // page),
           "fused_equals_unfused_bitwise": True,
           "launches": launches, "max_abs_err_out": err_out,
           "out_err_over_tol": out_x, "mean_abs_out": abs_out,
           "max_abs_err_mass": err_mass, "mass_err_over_tol": mass_x,
           "tol_out": [OUT_RTOL, OUT_ATOL], "tol_mass": [MASS_RTOL, MASS_ATOL],
           "eps_tau": EPS_TAU, "near_tau_steps": near_tau}
    if timed:
        # time the next step from the final pool (a page boundary: it evicts)
        q = torch.randn(B, KVH, G, hd, generator=gen).to(torch.bfloat16).to(dev)
        nk = torch.randn(B, KVH, hd, generator=gen).to(torch.bfloat16).to(dev)
        kp, vp = pool.k.view(B, P, page, KVH, hd), pool.v.view(B, P, page, KVH, hd)
        pos = P * page + steps
        args = (q, kp, vp, nk, nk, dpos(pos, dev), pool.f, pool.r, pool.page_start,
                pool.clock, pool.open_slot)
        cur = torch.full((B,), pos, dtype=torch.int32, device=dev)
        # rows read: the pages resident after the allocation, the new row
        # counted once at its page
        after = policy_paged_attention_kernel(*args, policy=policy)[5]
        rows = valid_rows(after, cur, page)
        bnd, by = bound(q, kp, rows)
        ms = time_ms(lambda: policy_paged_attention_kernel(*args, policy=policy))
        res.update({
            "ms": ms,
            "plain_ms": time_ms(lambda: ref.policy_paged_attention_plain(
                *args, policy=policy), reps=5, warmup=1),
            "bound_ms": bnd, "bound_by": by,
            "library_ms": sdpa_ms(q, kp, vp, after, cur),
            **split_fields(q, kp, rows, ms, bnd),
            "repeat_launches_equal": assert_repeatable(
                lambda: policy_paged_attention_kernel(*args, policy=policy))})
    emit(res)
    return res


#: (label, (B, S, KVH, G, hd), key length or None (= S), causal, window,
#: kv_len or None, dtype)
FLASH_CASES = [
    ("gemma3_local", (4, 2048, 16, 2, 128), None, True, 1024, None, torch.bfloat16),
    ("gemma3_global", (4, 2048, 16, 2, 128), None, True, 0, None, torch.bfloat16),
    ("smollm", (4, 1024, 5, 3, 64), None, True, 0, None, torch.bfloat16),
    ("phi35", (4, 2048, 8, 4, 128), None, True, 0, None, torch.bfloat16),
    ("ragged_window48", (2, 1000, 4, 2, 128), None, True, 48, None, torch.bfloat16),
    ("non_causal", (2, 512, 5, 3, 64), None, False, 0, None, torch.bfloat16),
    ("kv_len_mask", (2, 256, 2, 4, 64), None, False, 0, 150, torch.bfloat16),
    ("f32_window100", (1, 300, 2, 4, 64), None, True, 100, None, torch.float32),
    ("hd256", (1, 384, 2, 4, 256), None, True, 0, None, torch.bfloat16),
    ("qwen25", (4, 2048, 8, 5, 128), None, True, 0, None, torch.bfloat16),
    ("yi34", (4, 2048, 8, 7, 128), None, True, 0, None, torch.bfloat16),
    ("zamba2", (4, 2048, 32, 1, 112), None, True, 0, None, torch.bfloat16),
    ("f32_hd112_window100", (1, 300, 4, 1, 112), None, True, 100, None, torch.float32),
    # whisper's encoder (1500 frames: a ragged last tile of 28 rows) and its
    # decoder's cross-attention (448 queries over the 1500 encoder rows), both
    # non-causal at G = 1, hd = 64; internvl2's causal prefill at G = 6
    ("whisper_encoder", (4, 1500, 20, 1, 64), None, False, 0, None, torch.bfloat16),
    ("whisper_cross", (4, 448, 20, 1, 64), 1500, False, 0, None, torch.bfloat16),
    ("internvl2", (4, 2048, 8, 6, 128), None, True, 0, None, torch.bfloat16),
    # whisper at the shapes serve_whisper gives kernel 6: the encoder over the
    # engine's 1504 frames, the decoder's self-attention over its 3008
    # tokens (G = 1, hd = 64, causal) and its cross-attention over the 1504
    ("whisper_enc_served", (4, 1504, 20, 1, 64), None, False, 0, None, torch.bfloat16),
    ("whisper_self", (4, 3008, 20, 1, 64), None, True, 0, None, torch.bfloat16),
    ("whisper_cross_served", (4, 3008, 20, 1, 64), 1504, False, 0, None, torch.bfloat16),
]


def flash_inputs(label, shape, Skv: int, dtype, dev, draw: int = 0):
    """A FLASH_CASES row's q ~ N(0, 1) and k, v ~ 0.5 N(0, 1), drawn from a
    generator of the row's own (its label and ``draw``), so that no row's
    inputs depend on the rows before it."""
    B, S, KVH, G, hd = shape
    gen = torch.Generator().manual_seed(SEED + zlib.crc32(f"{label}/{draw}".encode()))
    q = torch.randn(B, S, KVH, G, hd, generator=gen).to(dtype).to(dev)
    k = (torch.randn(B, Skv, KVH, hd, generator=gen) * 0.5).to(dtype).to(dev)
    v = (torch.randn(B, Skv, KVH, hd, generator=gen) * 0.5).to(dtype).to(dev)
    return q, k, v


def flash_gate(out, plain, label, dtype) -> tuple:
    """Kernel 6's gate: ``out`` finite and within one bf16 ulp of ``plain``
    (f32: F32_OUT_RTOL/ATOL); returns (max |out - plain|, its excess, the
    tolerance)."""
    rtol, atol = ((OUT_RTOL, OUT_ATOL) if dtype == torch.bfloat16
                  else (F32_OUT_RTOL, F32_OUT_ATOL))
    err = (out.float() - plain.float()).abs().max().item()
    over = excess(out, plain, rtol, atol)
    assert torch.isfinite(out.float()).all(), label
    assert over <= 1.0, (label, err, over)
    return err, over, [rtol, atol]


#: further draws of every FLASH_CASES row's inputs that the run gates
FLASH_DRAWS = 2


def flash_gate_draws(dev, draws: int) -> dict:
    """Kernel 6's gate on every FLASH_CASES row at ``draws`` further draws of
    its inputs (draws 1..``draws``; phase flash_attn holds draw 0): the
    largest excess over the gate per row, untimed."""
    from repro_torch.kernels.flash_attn import flash_attention_kernel

    t0 = time.perf_counter()
    worst = {}
    for label, shape, skv, causal, window, kv_len, dtype in FLASH_CASES:
        Skv = shape[1] if skv is None else skv
        kw = {"causal": causal, "window": window, "kv_len": Skv if kv_len is None else kv_len}
        for draw in range(1, draws + 1):
            q, k, v = flash_inputs(label, shape, Skv, dtype, dev, draw)
            out = flash_attention_kernel(q, k, v, **kw)
            plain = ref.flash_attention_plain(q, k, v, **kw)
            err, over, _ = flash_gate(out, plain, (label, draw), dtype)
            prev = worst.get(label, {"err_over_tol": -1.0})
            if over > prev["err_over_tol"]:
                worst[label] = {"err_over_tol": over, "max_abs_err": err, "draw": draw}
            del q, k, v, out, plain
    torch.cuda.empty_cache()
    res = {"phase": "flash_gate_draws", "draws": draws, "worst": worst,
           "seconds": time.perf_counter() - t0}
    emit(res)
    return res


def attended_pairs(Sq: int, Skv: int, causal: bool, window: int, kv_len: int) -> int:
    """(query, key) position pairs the masks leave: what the flash kernel
    must compute, per batch row and query head."""
    i = np.arange(Sq)
    hi = np.full(Sq, kv_len - 1)
    if causal:
        hi = np.minimum(hi, i)
    lo = np.maximum(i - window + 1, 0) if window else np.zeros(Sq, dtype=np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def sdpa_call(q, k, v, causal: bool, window: int, kv_len: int, *, grad: bool = False):
    """(call, (qq, kk, vv)): one PyTorch ``scaled_dot_product_attention``
    call computing the same attention over the same mask in the (B, H, S,
    hd) layout, GQA (the yardstick; the port never calls it): ``is_causal``
    at Sq == Skv, no mask where every key is attended (an encoder, a
    cross-attention), else the boolean mask.  ``grad``: the inputs require
    a gradient."""
    import torch.nn.functional as F

    B, Sq, KVH, G, hd = q.shape
    Skv = k.shape[1]
    qq = q.reshape(B, Sq, KVH * G, hd).transpose(1, 2).contiguous().requires_grad_(grad)
    kk = k.transpose(1, 2).contiguous().requires_grad_(grad)
    vv = v.transpose(1, 2).contiguous().requires_grad_(grad)
    kw = {"enable_gqa": True}
    if causal and not window and kv_len == Skv and Sq == Skv:
        kw["is_causal"] = True
    elif causal or window or kv_len != Skv:
        i = torch.arange(Sq, device=q.device)[:, None]
        j = torch.arange(Skv, device=q.device)[None, :]
        mask = j < kv_len
        if causal:
            mask = mask & (j <= i)
        if window:
            mask = mask & (i - j < window)
        kw["attn_mask"] = mask
    return (lambda: F.scaled_dot_product_attention(qq, kk, vv, **kw)), (qq, kk, vv)


def sdpa_flash_ms(q, k, v, causal: bool, window: int, kv_len: int) -> float:
    """One PyTorch call computing the same attention over the same mask
    (``sdpa_call``), timed."""
    return time_ms(sdpa_call(q, k, v, causal, window, kv_len)[0])


_SASS_LOCK = threading.Lock()


@functools.lru_cache(maxsize=None)
def _disassemble(lib: Path) -> str:
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout


def _sass(lib: Path) -> str:
    """``cuobjdump -sass`` of the built library, disassembled once (the
    build phase starts it in a thread)."""
    with _SASS_LOCK:
        return _disassemble(lib)


def sass_hmma(lib: Path, name: str) -> dict:
    """HMMA (tensor-core) instructions in each function of the built library
    whose mangled name contains ``name``, counted in ``cuobjdump -sass``."""
    text = _sass(lib)
    counts: dict = {}
    cur = None
    for line in text.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            cur = fn if name in fn else None
            if cur is not None:
                counts[cur] = 0
        elif cur is not None and "HMMA" in line:
            counts[cur] += 1
    return counts


def phase_flash_attn(dev) -> dict:
    """Kernel 6 against its plain version on FLASH_CASES: bf16 within one
    bf16 ulp, f32 within F32_OUT_RTOL/ATOL, each repeated bit for bit over 6
    launches; each case timed (kernel, plain, SDPA over the same mask) beside
    its bound: q read and out written once, the K/V rows below kv_len read
    once, at the HBM rate, against 4*hd flops per unmasked (query head, key)
    pair at the type's peak (bf16 tensor cores; f32 outside them).  The bf16
    path's tensor-core use is read from the built library: every bf16
    instantiation (hd 64, 112, 128, 256) must hold HMMA instructions."""
    from repro_torch.kernels.flash_attn import HEAD_DIMS, flash_attention_kernel

    t0 = time.perf_counter()
    hmma = sass_hmma(_build.build().path, "flash_attention_bf16_kernel")
    assert len(hmma) == len(HEAD_DIMS) and min(hmma.values()) > 0, hmma
    res = {"phase": "flash_attn", "hmma_per_bf16_function": hmma, "cases": []}
    for label, (B, S, KVH, G, hd), skv, causal, window, kv_len, dtype in FLASH_CASES:
        Skv = S if skv is None else skv
        q, k, v = flash_inputs(label, (B, S, KVH, G, hd), Skv, dtype, dev)
        kl = Skv if kv_len is None else kv_len
        kw = {"causal": causal, "window": window, "kv_len": kl}
        out = flash_attention_kernel(q, k, v, **kw)
        out_lse, lse = flash_attention_kernel(q, k, v, **kw, return_lse=True)
        assert torch.equal(out, out_lse), (label, "out changed with lse on")
        plain, plain_lse = ref.flash_attention_plain(q, k, v, **kw, return_lse=True)
        lse_over = excess(lse, plain_lse, LSE_RTOL, LSE_ATOL)
        assert torch.isfinite(lse).all() and lse_over <= 1.0, (label, lse_over)
        del out_lse, lse, plain_lse
        err, over, tol = flash_gate(out, plain, label, dtype)
        pairs = attended_pairs(S, Skv, causal, window, kl)
        flops = 4 * hd * pairs * B * KVH * G
        nbytes = (2 * q.numel() + (k.numel() + v.numel()) * kl // Skv) * q.element_size()
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / (BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS) * 1e3
        ms = time_ms(lambda: flash_attention_kernel(q, k, v, **kw))
        res["cases"].append({
            "label": label, "shape": [B, S, KVH, G, hd], "kv_seq": Skv, "causal": causal,
            "window": window, "kv_len": kl, "dtype": str(dtype).split(".")[-1],
            "max_abs_err": err, "err_over_tol": over, "tol": tol,
            "out_equal_lse_on_off": True, "lse_err_over_tol": lse_over,
            "mean_abs_out": plain.float().abs().mean().item(),
            "repeat_launches_equal": assert_repeatable(
                lambda: (flash_attention_kernel(q, k, v, **kw),)),
            "pairs_per_head": pairs, "flops": flops, "ms": ms,
            "achieved_tflops": flops / ms / 1e9,
            "plain_ms": time_ms(lambda: ref.flash_attention_plain(q, k, v, **kw),
                                reps=5, warmup=1),
            "library_ms": sdpa_flash_ms(q, k, v, causal, window, kl),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
        del q, k, v, out, plain
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0
    emit(res)
    return res


#: (label, (B, Sq, KVH, G, hd), key length or None (= Sq), causal, window,
#: kv_len or None, dtype): the backward kernel's rows, self-attention (the
#: training cells' shapes among them), then cross-attention at Sq != Skv and a
#: ``kv_len`` mask
FLASH_BWD_CASES = [
    ("smollm_train", (4, 4096, 5, 3, 64), None, True, 0, None, torch.bfloat16),
    ("gemma3_local_train", (1, 4096, 16, 2, 128), None, True, 1024, None, torch.bfloat16),
    ("gemma3_global_train", (1, 4096, 16, 2, 128), None, True, 0, None, torch.bfloat16),
    ("zamba2_train", (1, 2048, 32, 1, 112), None, True, 0, None, torch.bfloat16),
    ("ragged_f32_window48", (1, 1000, 4, 2, 64), None, True, 48, None, torch.float32),
    ("non_causal_f32", (2, 300, 4, 3, 128), None, False, 0, None, torch.float32),
    ("ragged_bf16_window48", (1, 1000, 4, 2, 64), None, True, 48, None, torch.bfloat16),
    ("non_causal_bf16", (2, 300, 4, 3, 128), None, False, 0, None, torch.bfloat16),
    # the train_families cells' own per-microbatch shapes where no row above
    # has their group: internvl2's G = 6 (a 64-row query tile holds 10
    # positions, 60 rows and 4 empty) and phi3.5-moe's G = 4, causal at 4096
    ("internvl2_train", (1, 4096, 8, 6, 128), None, True, 0, None, torch.bfloat16),
    ("internvl2_train_f32", (1, 4096, 8, 6, 128), None, True, 0, None, torch.float32),
    ("phi35_train", (1, 4096, 8, 4, 128), None, True, 0, None, torch.bfloat16),
    ("phi35_train_f32", (1, 4096, 8, 4, 128), None, True, 0, None, torch.float32),
    # whisper's training cross-attention: its 448 decoder queries over the
    # 1500 encoder keys (a ragged last key tile of 28), at the cell's
    # microbatch of one sequence and at 8; a causal row with more queries
    # than keys; a kv_len mask ending inside a key tile (700 = 10 tiles + 60)
    # at hd 112
    ("whisper_cross_train", (1, 448, 20, 1, 64), 1500, False, 0, None, torch.bfloat16),
    ("whisper_cross_train_f32", (1, 448, 20, 1, 64), 1500, False, 0, None, torch.float32),
    ("whisper_cross_b8", (8, 448, 20, 1, 64), 1500, False, 0, None, torch.bfloat16),
    ("whisper_cross_b8_f32", (8, 448, 20, 1, 64), 1500, False, 0, None, torch.float32),
    ("cross_causal", (2, 1000, 4, 2, 128), 700, True, 0, None, torch.bfloat16),
    ("cross_causal_f32", (2, 1000, 4, 2, 128), 700, True, 0, None, torch.float32),
    ("cross_kv_len", (2, 500, 4, 3, 112), 1000, False, 0, 700, torch.bfloat16),
    ("cross_kv_len_f32", (2, 500, 4, 3, 112), 1000, False, 0, 700, torch.float32),
]

#: the backward's kernels in the built library: (bf16 tensor-core, f32 CUDA-core)
BWD_FUNCTIONS = (("flash_bwd_dkdv_bf16_kernel", "flash_bwd_dq_bf16_kernel"),
                 ("flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel"))


def _fn_label(mangled: str, name: str) -> str:
    """``name<hd>`` (``name<f32, hd>`` for the f32 template) of a mangled
    kernel name."""
    m = re.search(r"I(f?)Li(\d+)E", mangled.split(name, 1)[1])
    return f"{name}<{'f32, ' if m.group(1) else ''}{m.group(2)}>" if m else mangled


def ptxas_usage(log: str, name: str) -> dict:
    """Registers, stack, spills and static shared memory of every function
    whose mangled name contains ``name``, from nvcc's ``-Xptxas -v`` log."""
    out: dict = {}
    cur = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = _fn_label(m.group(1), name) if name in m.group(1) else None
            if cur is not None:
                out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[cur].update(stack_bytes=int(m.group(1)), spill_store_bytes=int(m.group(2)),
                            spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[cur]["static_smem_bytes"] = int(sm.group(1)) if sm else 0
    return out


def bwd_functions() -> dict:
    """The backward's functions in the built library: each one's HMMA count
    (``cuobjdump -sass``) and, when this process ran nvcc, its ptxas usage.
    Every bf16 dK/dV and dQ function (hd 64, 112, 128) must hold HMMA
    instructions; the f32 ones are reported beside them."""
    from repro_torch.kernels.flash_attn import BWD_HEAD_DIMS

    lib = _build.build().path
    log = "".join(b.log for b in _build.BUILDS)
    res: dict = {}
    for kind, names in zip(("bf16", "f32"), BWD_FUNCTIONS):
        for name in names:
            hmma = {_fn_label(fn, name): n for fn, n in sass_hmma(lib, name).items()}
            if kind == "bf16":
                assert len(hmma) == len(BWD_HEAD_DIMS) and min(hmma.values()) > 0, hmma
            usage = ptxas_usage(log, name) if log else {}
            for fn, n in hmma.items():
                res[fn] = {"hmma": n, **usage.get(fn, {"ptxas": "not in this run's build log"})}
    return res


def rel_l2(got, want) -> float:
    g, w = got.float(), want.float()
    return (torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w)).item()


def sdpa_bwd_ms(q, k, v, dout, causal: bool, window: int, kv_len: int) -> float:
    """The backward alone of the same attention's one PyTorch call
    (``sdpa_call``), through ``torch.autograd.grad`` on a retained graph
    (the yardstick; the port never calls it)."""
    B, Sq, KVH, G, hd = q.shape
    call, inputs = sdpa_call(q, k, v, causal, window, kv_len, grad=True)
    gg = dout.reshape(B, Sq, KVH * G, hd).transpose(1, 2).contiguous()
    out = call()
    ms = time_ms(lambda: torch.autograd.grad(out, inputs, gg, retain_graph=True))
    del out
    return ms


def phase_flash_bwd(dev) -> dict:
    """The backward kernel (``csrc/flash_attn_bwd.cu``) against its plain
    version on FLASH_BWD_CASES: the forward's ``out`` bit for bit with lse on
    and off, its lse within LSE_RTOL/ATOL of the plain forward's, then
    dq / dk / dv from the kernel's own out and lse against the plain
    backward in f32 from the same out and lse (bf16 within BWD_REL_L2
    relative L2 each, f32 elementwise within BWD_F32_RTOL * max|plain| +
    BWD_F32_ATOL), repeated bit for bit over 6 launches; timed (kernel,
    plain, SDPA's backward) beside the bound: 10 * hd flops per unmasked
    (query head, key) pair at the type's peak, or q, k, v, out, dout and
    lse read and dq, dk, dv written once at the HBM rate (the K / V rows
    below kv_len read).  Rows at Sq != Skv and under a ``kv_len`` mask
    come last.  At smollm's training shape the forward is timed with lse
    off and on.  First the
    built library's backward functions (``bwd_functions``): every bf16 one
    must run its products on the tensor cores."""
    from repro_torch.kernels.flash_attn import (flash_attention_backward_kernel,
                                                flash_attention_kernel)

    t0 = time.perf_counter()
    res = {"phase": "flash_bwd", "card": smi(), "functions": bwd_functions(), "cases": []}
    for label, (B, S, KVH, G, hd), skv, causal, window, kv_len, dtype in FLASH_BWD_CASES:
        t_row = time.perf_counter()
        Skv = S if skv is None else skv
        kl = Skv if kv_len is None else kv_len
        q, k, v = flash_inputs(label, (B, S, KVH, G, hd), Skv, dtype, dev)
        gen = torch.Generator().manual_seed(SEED + zlib.crc32(f"{label}/dout".encode()))
        dout = torch.randn(B, S, KVH, G, hd, generator=gen).to(dtype).to(dev)
        kw = {"causal": causal, "window": window, "kv_len": kl}
        out_off = flash_attention_kernel(q, k, v, **kw)
        out, lse = flash_attention_kernel(q, k, v, **kw, return_lse=True)
        out_equal = torch.equal(out_off, out)
        assert out_equal, (label, "out changed with lse on")
        del out_off
        _, plain_lse = ref.flash_attention_plain(q, k, v, **kw, return_lse=True)
        lse_over = excess(lse, plain_lse, LSE_RTOL, LSE_ATOL)
        assert torch.isfinite(lse).all() and lse_over <= 1.0, (label, lse_over)
        del plain_lse
        grads = flash_attention_backward_kernel(q, k, v, out, lse, dout, **kw)
        f32 = [t.float() for t in (q, k, v, out)]
        plain = ref.flash_attention_backward_plain(*f32, lse, dout.float(), **kw)
        del f32
        row = {"label": label, "shape": [B, S, KVH, G, hd], "kv_seq": Skv, "kv_len": kl,
               "causal": causal, "window": window, "dtype": str(dtype).split(".")[-1],
               "out_equal_lse_on_off": out_equal, "lse_err_over_tol": lse_over,
               "lse_tol": [LSE_RTOL, LSE_ATOL]}
        errs = []
        for name, g, p in zip(("dq", "dk", "dv"), grads, plain):
            assert torch.isfinite(g.float()).all(), (label, name)
            err = (g.float() - p).abs().max().item()
            errs.append(err)
            if dtype == torch.bfloat16:
                r = rel_l2(g, p)
                row[f"{name}_rel_l2"] = r
                assert r <= BWD_REL_L2, (label, name, r)
            else:
                tol = BWD_F32_RTOL * p.abs().max().item() + BWD_F32_ATOL
                row[f"{name}_err_over_tol"] = err / tol
                assert err <= tol, (label, name, err, tol)
        row["max_abs_err"] = max(errs)
        row["gate"] = ({"rel_l2": BWD_REL_L2} if dtype == torch.bfloat16
                       else {"rtol_of_max": BWD_F32_RTOL, "atol": BWD_F32_ATOL})
        del plain
        run = lambda: flash_attention_backward_kernel(q, k, v, out, lse, dout, **kw)  # noqa: E731
        row["repeat_launches_equal"] = assert_repeatable(run)
        pairs = attended_pairs(S, Skv, causal, window, kl)
        flops = 10 * hd * pairs * B * KVH * G
        # q, out, dout read, dq written; the K / V rows below kv_len read,
        # every dk / dv row written; lse read
        nbytes = ((4 * q.numel() + 2 * k.numel() + 2 * k.numel() * kl // Skv)
                  * q.element_size() + 4 * lse.numel())
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / (BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS) * 1e3
        ms = time_ms(run)
        f32_in = [t.float() for t in (q, k, v, out)] + [lse, dout.float()]
        row.update({
            "pairs_per_head": pairs, "flops": flops, "ms": ms,
            "achieved_tflops": flops / ms / 1e9,
            "plain_ms": time_ms(lambda: ref.flash_attention_backward_plain(*f32_in, **kw),
                                reps=3, warmup=1),
            "library_ms": sdpa_bwd_ms(q, k, v, dout, causal, window, kl),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
        del f32_in
        if label == "smollm_train":  # kernel 6 at the training shape, lse off and on
            row["fwd_ms"] = time_ms(lambda: flash_attention_kernel(q, k, v, **kw))
            row["fwd_lse_ms"] = time_ms(lambda: flash_attention_kernel(
                q, k, v, **kw, return_lse=True))
            row["fwd_plain_ms"] = time_ms(lambda: ref.flash_attention_plain(
                q, k, v, **kw, return_lse=True), reps=3, warmup=1)
            row["fwd_library_ms"] = sdpa_flash_ms(q, k, v, causal, window, kl)
        row["seconds"] = time.perf_counter() - t_row
        res["cases"].append(row)
        del q, k, v, dout, out, lse, grads, run
        torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0
    emit(res)
    return res


#: the train phase's global batch: train_4k's 256 sequences of 4096 cut to 8
#: (its f32 logits alone would be ~100 GB a microbatch on one card)
TRAIN_BATCH = 8
TRAIN_TIMED_STEPS = 4  # after one warm-up step; the last one profiled
#: smollm's SMOKE_CONFIG in float32 for the card-vs-CPU, repeatability,
#: resilient-loop and checkpoint checks, at hd 64: its hd 32 is not an
#: instantiation of kernel 6 (64, 112, 128, 256)
TRAIN_SMOKE_BATCH, TRAIN_SMOKE_SEQ = 8, 256
TRAIN_CPU_RTOL = 1e-4  # card vs CPU: loss and grad norm per step, final params (rel L2)


def train_flops(cfg, params, batch: int, seq: int, enc_seq: int = 0) -> tuple[float, float]:
    """Operations of one train step, as (the function's, remat's recompute).
    The function's forward: 2 flops per parameter per row it multiplies (the
    tokens; an expert's parameters its capacity buffer's C rows a sequence,
    as the MoE FFN computes every expert over its buffer; a lookup-only
    embedding none; whisper's encoder and cross K / V projections the
    ``enc_seq`` frames), each Mamba-2 block's chunked SSD products (2 * S *
    (Q * N + Q * H * P + 2 * N * H * P) a sequence, chunk Q) and attention's
    4 * hd per unmasked (query head, key) pair; its backward twice the
    forward's products and 10 * hd a pair.  With ``remat="full"`` the
    forward runs again in the backward, which the step's bound leaves
    out."""
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.optim import optimizer as O

    def numel(tree) -> int:
        return sum(t.numel() for t in O.tree_leaves(tree))

    lookup = 0 if cfg.tie_embeddings else params["embed"].numel()
    heads_hd = batch * cfg.n_heads * cfg.head_dim
    ssd = 0
    if cfg.family == "encdec":
        enc, cross_kv = numel(params["enc"]), 2 * params["dec"]["cross_wk"].numel()
        rows = (enc + cross_kv) * enc_seq + (numel(params) - enc - cross_kv - lookup) * seq
        pair_hd = heads_hd * (
            cfg.enc_layers * attended_pairs(enc_seq, enc_seq, False, 0, enc_seq)
            + cfg.dec_layers * (attended_pairs(seq, seq, True, 0, seq)
                                + attended_pairs(seq, enc_seq, False, 0, enc_seq)))
    else:
        unit, _, tail = M.scan_plan(cfg)
        expert = sum(params[pos][name].numel() for pos, kind in unit + tail if kind == "moe"
                     for name in ("w_up", "w_gate", "w_down") if name in params[pos])
        rows = ((numel(params) - lookup - expert) * seq
                + expert * (L.moe_capacity(seq, cfg) if expert else 0))
        pair_hd = 0
        for kind in cfg.layer_pattern:
            if kind != "mamba":
                window = cfg.sliding_window if kind == "local" else 0
                pair_hd += heads_hd * attended_pairs(seq, seq, True, window, seq)
        n_mamba = cfg.layer_pattern.count("mamba")
        if n_mamba:
            Q, N, H, P = cfg.ssm_chunk, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
            s_pad = -(-seq // Q) * Q
            ssd = 2 * s_pad * (Q * N + Q * H * P + 2 * N * H * P) * n_mamba
    fwd = 2 * rows * batch + ssd * batch + 4 * pair_hd
    need = 3 * fwd + 2 * pair_hd
    return float(need), float(fwd if cfg.remat == "full" else 0)


def _with_stub_inputs(cfg, data, enc_seq: int = 0):
    """``data``'s batches with the stub frontend's input the family needs
    (``launch.train.STUB_INPUTS``), in f32 numpy: the VLM's ``patches`` (B,
    n_patch_tokens, D) and the enc-dec's ``frames`` (B, S //
    enc_seq_divisor, D), N(0, 1) * 0.02 from numpy seed SEED, so that the
    card's and the CPU's runs see the same batches; with ``enc_seq`` the
    frames are (B, enc_seq, D) zeros instead, as ``serve_whisper`` feeds its
    encoder; other families' batches as they are."""
    from repro_torch.launch.train import STUB_INPUTS

    key = STUB_INPUTS.get(cfg.family)
    if key is None:
        return data
    rng = np.random.default_rng(SEED)

    def batches():
        for b in data:
            B, S = b["tokens"].shape
            if key == "frames" and enc_seq:
                b[key] = np.zeros((B, enc_seq, cfg.d_model), np.float32)
            else:
                rows = S // cfg.enc_seq_divisor if key == "frames" else cfg.n_patch_tokens
                b[key] = (rng.standard_normal((B, rows, cfg.d_model))
                          * 0.02).astype(np.float32)
            yield b

    return batches()


def _train_setup(cfg, batch: int, seq: int, steps: int, enc_seq: int = 0):
    """The launcher's ``OptConfig`` for ``steps``, the microbatched train step
    (updating its state in place) and ``SyntheticLM`` seed 0 at ``batch`` x
    ``seq`` (``_with_stub_inputs`` at ``enc_seq``): (oc, step, data)."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.train import default_opt_config
    from repro_torch.train.train_step import effective_microbatches, make_train_step

    oc = default_opt_config(cfg, steps)
    step = make_train_step(cfg, oc, effective_microbatches(cfg, batch, 1))
    return oc, step, _with_stub_inputs(cfg, SyntheticLM(cfg.vocab, batch, seq, seed=0),
                                       enc_seq)


def _train_run(cfg, params, dev, steps: int, batch: int = TRAIN_SMOKE_BATCH,
               seq: int = TRAIN_SMOKE_SEQ) -> dict:
    """``steps`` of ``make_train_step`` from ``params`` (moved to ``dev``) on
    ``SyntheticLM`` seed 0 at ``batch`` x ``seq``: per-step loss and grad
    norm, final params."""
    from repro_torch.launch.train import batch_to
    from repro_torch.optim import optimizer as O

    oc, step, data = _train_setup(cfg, batch, seq, steps)
    params = O.tree_map(lambda t: t.to(dev, copy=True), params)
    opt = O.init_opt_state(params, oc)
    losses, gnorms = [], []
    for _ in range(steps):
        params, opt, m = step(params, opt, batch_to(next(data), dev))
        losses.append(m["loss"].item())
        gnorms.append(m["grad_norm"].item())
    return {"loss": losses, "grad_norm": gnorms, "params": params, "opt": opt}


def leaf_names(tree, prefix: str = "") -> list:
    """The paths of a nested dict's leaves, in ``tree_leaves``' order."""
    return [n for k, v in tree.items() for n in (
        leaf_names(v, f"{prefix}{k}/") if isinstance(v, dict) else [prefix + k])]


def _leaves_equal(a, b) -> bool:
    from repro_torch.optim import optimizer as O

    la, lb = O.tree_leaves(a), O.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y.to(x.device))
        for x, y in zip(la, lb))


def _resilient_pair(cfg, params0, dev, root: Path) -> dict:
    """``run_resilient`` over 8 smoke steps with one injected failure at step
    4 and a checkpoint every 3, against an uninterrupted run: restarts,
    final params and loss."""
    from repro_torch.launch.train import batch_to
    from repro_torch.optim import optimizer as O
    from repro_torch.train import fault_tolerance as FT

    steps = 8

    def run(name, **kw):
        oc, step, data = _train_setup(cfg, TRAIN_SMOKE_BATCH, TRAIN_SMOKE_SEQ, steps)
        last = {}

        def init_fn():
            p = O.tree_map(lambda t: t.to(dev, copy=True), params0)
            return p, O.init_opt_state(p, oc)

        def step_fn(p, o, b):
            last["params"], last["opt"], m = step(p, o, batch_to(b, dev))
            return last["params"], last["opt"], m

        report = FT.run_resilient(
            ckpt_dir=str(root / name), total_steps=steps, init_fn=init_fn, step_fn=step_fn,
            data_iter=data, **kw)
        return report, last

    r1, last1 = run("uninterrupted", ckpt_every=100)
    r2, last2 = run("failed_at_4", ckpt_every=3, injector=FT.FailureInjector(fail_at=[4]))
    res = {"steps": steps, "fail_at": [4], "ckpt_every": 3, "restarts": r2.restarts,
           "steps_done": [r1.steps_done, r2.steps_done],
           "loss": [r1.final_metrics["loss"], r2.final_metrics["loss"]],
           "params_equal_bitwise": _leaves_equal(last1["params"], last2["params"]),
           "opt_equal_bitwise": _leaves_equal(last1["opt"], last2["opt"])}
    assert r1.restarts == 0 and r2.restarts == 1, res
    assert r1.steps_done == r2.steps_done == steps, res
    assert res["params_equal_bitwise"] and res["opt_equal_bitwise"], res
    assert r1.final_metrics["loss"] == r2.final_metrics["loss"], res
    return res


def _checkpoint_roundtrip(params, opt, root: Path) -> dict:
    """``save`` / ``restore`` of a trained SMOKE state with its parameters
    cast to bf16: every leaf back bit for bit, in its dtype, on its device."""
    from repro_torch.optim import optimizer as O
    from repro_torch.train import checkpoint as C

    params = O.tree_map(lambda t: t.to(torch.bfloat16), params)
    dev = O.tree_leaves(params)[0].device
    d = str(root / "roundtrip")
    C.save(d, 3, params, opt, data_state={"step": 3, "epoch": 0})
    p2, o2, ds, _ = C.restore(d, C.latest_step(d), params, opt)
    res = {"latest_step": C.latest_step(d), "data_state": ds,
           "params_equal_bitwise": _leaves_equal(params, p2),
           "opt_equal_bitwise": _leaves_equal(opt, o2),
           "param_dtypes": sorted({str(t.dtype) for t in O.tree_leaves(p2)}),
           "on_device": all(t.device.type == dev.type for t in O.tree_leaves((p2, o2)))}
    assert res["params_equal_bitwise"] and res["opt_equal_bitwise"] and res["on_device"], res
    assert "torch.bfloat16" in res["param_dtypes"], res
    return res


def phase_train(dev, cfg=CONFIG, batch: int = TRAIN_BATCH,
                timed_steps: int = TRAIN_TIMED_STEPS) -> dict:
    """The training path end to end.  (a) ``cfg`` (smollm-360m at its
    published width: 32 layers, d 960, vocab 49152, bf16 parameters, f32
    master and Adam states, remat full, 2 microbatches) at train_4k's 4096
    tokens, global batch cut to ``batch``, ``SyntheticLM`` seed 0, the
    launcher's ``OptConfig``: one warm-up step and ``timed_steps`` timed
    (the last under ``torch.profiler``), each step's wall ms, CUDA-event ms,
    tokens/s, peak GB and kernel 6 / backward launches (gated at the counts
    reckoned from the config), every loss and grad norm finite, the
    parameters changing at every step, beside the step's flop bound.
    (b) the SMOKE config in f32 for 3 steps on the card against the same
    steps on the CPU; (c) two card runs bit-identical; (d) the resilient
    loop with a failure injected at step 4 equal bit for bit to an
    uninterrupted run; (e) a bf16 checkpoint round trip bit-exact."""
    import tempfile

    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.train import batch_to
    from repro_torch.models import model as M
    from repro_torch.optim import optimizer as O
    from repro_torch.train.train_step import effective_microbatches

    t_phase = time.perf_counter()
    seq = SHAPES["train_4k"].seq_len
    steps = timed_steps + 1
    oc, step, data = _train_setup(cfg, batch, seq, steps)
    n_micro = effective_microbatches(cfg, batch, 1)
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    opt = O.init_opt_state(params, oc)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in O.tree_leaves(params))
    flops, remat_flops = train_flops(cfg, params, batch, seq)
    n_attn = attention_calls(cfg)
    expect = {"flash_attention": n_attn * n_micro * (2 if cfg.remat == "full" else 1),
              "flash_attention_bwd": n_attn * n_micro}
    res = {"phase": "train", "card": smi(), "config": cfg.name,
           "reduced": {"global_batch": [SHAPES["train_4k"].global_batch, batch]},
           "seq": seq, "n_micro": n_micro, "remat": cfg.remat, "n_params": n_params,
           "param_dtype": cfg.param_dtype, "adam_dtype": cfg.adam_dtype,
           "opt_master": cfg.opt_master, "init_s": init_s,
           "step_flops": flops, "step_bound_ms": flops / BF16_FLOPS * 1e3,
           "remat_recompute_flops": remat_flops,
           "launches_per_step_expected": expect, "steps": []}
    ops.reset_launches()
    for i in range(steps):
        b = batch_to(next(data), dev)
        before = [t.clone() for t in O.tree_leaves(params)]
        before_master = [t.clone() for t in O.tree_leaves(opt.master)]
        launched = {k: ops.LAUNCHES[k] for k in expect}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        profiled = i == steps - 1
        prof = None
        if profiled:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.__enter__()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        ev0.record()
        params, opt, metrics = step(params, opt, b)
        ev1.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if prof is not None:
            prof.__exit__(None, None, None)
        row = {"step": i + 1, "warm_up": i == 0, "profiled": profiled,
               "wall_ms": wall * 1e3, "event_ms": ev0.elapsed_time(ev1),
               "tokens_per_s": batch * seq / wall,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "loss": metrics["loss"].item(), "grad_norm": metrics["grad_norm"].item(),
               "lr": metrics["lr"].item(),
               "launches": {k: ops.LAUNCHES[k] - launched[k] for k in expect},
               "leaves_changed": sum(not torch.equal(a, c) for a, c in
                                     zip(before, O.tree_leaves(params))),
               "master_leaves_changed": sum(not torch.equal(a, c) for a, c in
                                            zip(before_master, O.tree_leaves(opt.master)))}
        del before, before_master, b
        n_leaves = len(O.tree_leaves(params))
        if prof is not None:
            from torch.autograd import DeviceType

            kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
            if kern:
                busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
                by_name: dict = {}
                for e in kern:
                    by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
                bwd = sum(ms for n, ms in by_name.items() if "flash_bwd" in n)
                fwd = sum(ms for n, ms in by_name.items() if "flash_attention" in n)
                row.update({"device_ms": busy, "device_busy_share": busy / row["wall_ms"],
                            "kernels": len(kern), "flash_bwd_ms": bwd,
                            "flash_bwd_share": bwd / busy, "flash_fwd_ms": fwd,
                            "top_kernels_ms": [[n[:80], ms] for n, ms in sorted(
                                by_name.items(), key=lambda kv: -kv[1])[:8]]})
            else:
                row["device_ms"] = "not measured"
            del prof
        assert math.isfinite(row["loss"]) and math.isfinite(row["grad_norm"]), row
        assert row["launches"] == expect, (row["launches"], expect)
        assert row["leaves_changed"] >= 1 and row["master_leaves_changed"] == n_leaves, row
        res["steps"].append(row)
    res["launches"] = {k: ops.LAUNCHES[k] for k in expect}
    timed = [r for r in res["steps"] if not r["warm_up"] and not r["profiled"]]
    res["wall_ms_per_step"] = statistics.median(r["wall_ms"] for r in timed)
    res["tokens_per_s"] = batch * seq / res["wall_ms_per_step"] * 1e3
    res["peak_gb"] = max(r["peak_gb"] for r in res["steps"])
    res["bound_over_wall"] = res["step_bound_ms"] / res["wall_ms_per_step"]
    del params, opt, metrics
    gc.collect()
    torch.cuda.empty_cache()

    # (b) and (c): the SMOKE config, card against the CPU (a worker's job),
    # card twice
    scfg = _smoke_family_cfg("smollm_360m")
    p0 = M.init_params(scfg, torch.Generator().manual_seed(SEED), device="cpu")
    card = _train_run(scfg, p0, dev, 3)
    card2 = _train_run(scfg, p0, dev, 3)
    cpu = host_job(_smoke_train_cpu, "smollm_360m", 3, TRAIN_SMOKE_BATCH,
                   TRAIN_SMOKE_SEQ).result()
    leaf_rel = [rel_l2(a.cpu(), torch.from_numpy(c))
                for a, c in zip(O.tree_leaves(card["params"]), cpu["params"])]
    loss_rel = [abs(a - c) / abs(c) for a, c in zip(card["loss"], cpu["loss"])]
    gn_rel = [abs(a - c) / abs(c) for a, c in zip(card["grad_norm"], cpu["grad_norm"])]
    res["smoke_vs_cpu"] = {
        "config": {"n_layers": scfg.n_layers, "d_model": scfg.d_model, "head_dim": 64,
                   "dtype": "float32", "batch": TRAIN_SMOKE_BATCH, "seq": TRAIN_SMOKE_SEQ},
        "loss_card": card["loss"], "loss_cpu": cpu["loss"], "loss_rel": loss_rel,
        "grad_norm_rel": gn_rel, "params_rel_l2_max": max(leaf_rel), "tol": TRAIN_CPU_RTOL}
    assert max(loss_rel) <= TRAIN_CPU_RTOL and max(gn_rel) <= TRAIN_CPU_RTOL, res["smoke_vs_cpu"]
    assert max(leaf_rel) <= TRAIN_CPU_RTOL, res["smoke_vs_cpu"]
    res["repeat_runs_equal_bitwise"] = (_leaves_equal(card["params"], card2["params"])
                                        and card["loss"] == card2["loss"])
    assert res["repeat_runs_equal_bitwise"]

    # (d) and (e): the resilient loop and a checkpoint round trip of (b)'s state
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        res["resilient"] = _resilient_pair(scfg, p0, dev, Path(tmp))
        res["checkpoint"] = _checkpoint_roundtrip(card["params"], card["opt"], Path(tmp))
    del cpu, card, card2
    gc.collect()
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_phase
    emit(res)
    return res


#: train_mesh: the placed step's steps, from the same state as the plain ones
TRAIN_MESH_STEPS = 2


@contextlib.contextmanager
def _world_of_one(backend: str, store: Path):
    """A ``torch.distributed`` world of one rank, started through a file
    store."""
    import torch.distributed as dist

    dist.init_process_group(backend, init_method=f"file://{store}", rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _full_state(params, opt) -> dict:
    """{path: full tensor} of parameters and optimizer state (DTensor leaves
    gathered)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.optim import optimizer as O

    out = {}
    for prefix, tree in (("params", params), ("m", opt.m), ("v", opt.v),
                         ("master", opt.master)):
        for name, t in zip(leaf_names(tree), O.tree_leaves(tree)):
            out[f"{prefix}/{name}"] = t.full_tensor() if isinstance(t, DTensor) else t
    out["step"] = opt.step
    return out


def _mesh_steps(params, oc, step, batches, dev) -> dict:
    """Run ``step`` over ``batches`` from ``params`` (its optimizer state
    fresh): per step wall / event ms, peak GB, loss, grad norm and kernel 6 /
    backward launches; the final full state."""
    from repro_torch.launch.train import batch_to
    from repro_torch.optim import optimizer as O

    opt = O.init_opt_state(params, oc)
    rows = []
    for b in batches:
        b = batch_to(b, dev)
        launched = {k: ops.LAUNCHES[k] for k in ("flash_attention", "flash_attention_bwd")}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        ev0.record()
        params, opt, m = step(params, opt, b)
        ev1.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rows.append({"wall_ms": wall * 1e3, "event_ms": ev0.elapsed_time(ev1),
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(),
                     "launches": {k: ops.LAUNCHES[k] - v for k, v in launched.items()}})
    return {"steps": rows, "state": _full_state(params, opt)}


def phase_train_mesh(dev, tr: dict) -> dict:
    """The placed train step (``train_step.make_train_step(mesh=...)``):
    smollm-360m as ``train`` runs it (published width, bf16 parameters, f32
    master and Adam, remat, 2 microbatches of SyntheticLM seed 0 at 4096
    tokens, ``train``'s global batch) in a world of one NCCL rank on a (1,
    1) mesh (DTensor parameters drawn by ``init_params(mesh=...)`` as the
    launcher draws them, the model on DTensors, kernel 6 and its backward
    under ``local_map``): TRAIN_MESH_STEPS placed steps against as many
    plain steps from the same seed, parameters, master, m, v
    and losses bit for bit, kernel 6 and backward launches equal; wall /
    event ms a step, tokens/s and peak GB beside ``train``'s.  Two gloo
    ranks sharing the card are not run: DTensor's redistribute goes through
    the functional collectives, whose all-gather faults (SIGSEGV) on a gloo
    group with CUDA tensors (torch 2.11); the CPU tests hold the multi-rank
    meshes."""
    import tempfile

    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.inputs import params_shardings
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.sharding.specs import make_rules
    from repro_torch.train.train_step import effective_microbatches, make_train_step

    t_phase = time.perf_counter()
    cfg, batch, seq = CONFIG, TRAIN_BATCH, SHAPES["train_4k"].seq_len
    oc, plain_step, data = _train_setup(cfg, batch, seq, TRAIN_MESH_STEPS)
    batches = [next(data) for _ in range(TRAIN_MESH_STEPS)]
    n_micro = effective_microbatches(cfg, batch, 1)
    p0 = M.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    plain = _mesh_steps(tree_map(lambda t: t.clone(), p0), oc, plain_step, batches, dev)
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root) as tmp, \
            _world_of_one("nccl", Path(tmp) / "store"):
        mesh = make_mesh((1, 1), device_type="cuda")
        rules = make_rules(moe_sharding=cfg.moe_sharding)
        del p0  # the placed state is drawn as the launcher draws it
        params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev,
                               mesh=mesh, shardings=params_shardings(cfg, mesh, rules))
        step = make_train_step(cfg, oc, n_micro, mesh=mesh, rules=rules)
        ops.reset_launches()  # the placed path's run
        placed = _mesh_steps(params, oc, step, batches, dev)
        launches = {k: ops.LAUNCHES[k] for k in ("flash_attention", "flash_attention_bwd")}
        del params
    same = {k: torch.equal(v, plain["state"][k]) for k, v in placed["state"].items()}
    keys = ("wall_ms", "event_ms", "peak_gb", "loss", "grad_norm", "launches")
    res = {"phase": "train_mesh", "card": smi(), "config": cfg.name, "seq": seq,
           "reduced": {"global_batch": [SHAPES["train_4k"].global_batch, batch]},
           "mesh": [1, 1], "backend": "nccl", "world": 1, "n_micro": n_micro,
           "launches": launches,
           "steps": [{k: r[k] for k in keys} for r in placed["steps"]],
           "plain_steps": [{k: r[k] for k in keys} for r in plain["steps"]],
           "tokens_per_s": [batch * seq / r["wall_ms"] * 1e3 for r in placed["steps"]],
           "plain_tokens_per_s": [batch * seq / r["wall_ms"] * 1e3 for r in plain["steps"]],
           "train_wall_ms_per_step": tr["wall_ms_per_step"],
           "train_tokens_per_s": tr["tokens_per_s"], "train_peak_gb": tr["peak_gb"],
           "leaves_equal_bitwise": sum(same.values()), "leaves": len(same),
           "losses_equal": [r["loss"] for r in placed["steps"]]
           == [r["loss"] for r in plain["steps"]],
           "two_ranks_on_the_card": "not run: the functional collectives' all-gather "
                                    "faults on a gloo group with CUDA tensors"}
    del plain, placed
    gc.collect()
    torch.cuda.empty_cache()
    assert all(same.values()), [k for k, v in same.items() if not v][:8]
    assert res["losses_equal"], res
    assert all(r["launches"] == p["launches"]
               for r, p in zip(res["steps"], res["plain_steps"])), res
    assert all(v > 0 for v in launches.values()), launches
    res["seconds"] = time.perf_counter() - t_phase
    emit(res)
    return res


#: the families train_families trains at their SMOKE_CONFIG, card against CPU,
#: for 2 steps of 4 x 128 tokens (whisper's 64 frames, internvl2's 8 patches,
#: 4 SSD chunks of 32)
TRAIN_FAMILY_ARCHS = ("phi35_moe", "grok1_314b", "mamba2_370m", "zamba2_7b",
                      "internvl2_26b", "whisper_large_v3")
TRAIN_FAMILY_SMOKE_STEPS = 2
TRAIN_FAMILY_SMOKE_BATCH, TRAIN_FAMILY_SMOKE_SEQ = 4, 128
TRAIN_FAMILY_TIMED_STEPS = 2  # after one warm-up step
#: the families' final parameters are held to TRAIN_CPU_RTOL on the elements
#: whose first-batch gradient on the CPU is 0 or at least this, 100 x Adam's
#: eps: below it the first update g / (|g| + eps) turns f32 rounding of g into
#: a share of the step (zamba2's zero-initialized u0/ln1 lands 5.5e-4 relative
#: L2 from the CPU's over all its elements, 2.6e-6 over these)
TRAIN_PARAMS_GRAD_FLOOR = 1e-6


def _smoke_family_cfg(arch: str):
    """``arch``'s SMOKE_CONFIG in f32, at hd 64 where it has attention (its
    hd 32 is not an instantiation of kernel 6 or its backward): the card
    against CPU checks of ``train`` (smollm) and ``train_families``."""
    from repro_torch.configs.base import load_smoke_config

    cfg = load_smoke_config(arch)
    return dataclasses.replace(cfg, dtype="float32", param_dtype="float32",
                               **({"head_dim": 64} if cfg.n_heads else {}))


def _smoke_grads(cfg, params, dev, batch: int, seq: int) -> list:
    """Each leaf's gradient of ``loss_fn`` at ``params`` (copied to ``dev``)
    on the first batch of ``_train_setup``'s data, on the CPU."""
    from repro_torch.launch.train import batch_to
    from repro_torch.models import model as M
    from repro_torch.optim import optimizer as O

    data = _train_setup(cfg, batch, seq, 1)[2]
    leaves = [t.to(dev, copy=True).requires_grad_(True) for t in O.tree_leaves(params)]
    it = iter(leaves)
    loss = M.loss_fn(O.tree_map(lambda _: next(it), params), cfg, batch_to(next(data), dev))
    return [g.cpu() for g in torch.autograd.grad(loss, leaves)]


def _smoke_train_cpu(arch: str, steps: int, batch: int, seq: int) -> dict:
    """``steps`` of ``arch``'s f32 smoke training (``_smoke_family_cfg``) at
    ``batch`` x ``seq`` on the CPU from SEED's parameters (a worker's job):
    per-step loss and grad norm, the final parameters and the first batch's
    gradients (``_smoke_grads``) as numpy, seconds."""
    from repro_torch.models import model as M
    from repro_torch.optim import optimizer as O

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    cfg = _smoke_family_cfg(arch)
    p0 = M.init_params(cfg, torch.Generator().manual_seed(SEED), device="cpu")
    run = _train_run(cfg, p0, torch.device("cpu"), steps, batch, seq)
    return {"loss": run["loss"], "grad_norm": run["grad_norm"],
            "params": [t.numpy() for t in O.tree_leaves(run["params"])],
            "grads": [g.numpy() for g in _smoke_grads(cfg, p0, torch.device("cpu"), batch,
                                                      seq)],
            "seconds": time.perf_counter() - t0}


def train_family_cells() -> list:
    """The train_families phase's cells: (label, config, global batch,
    decoder / token sequence, encoder frames, reduced).  Published widths;
    batch 256 x 4096 (train_4k) fits neither one card's memory nor the
    script's time.  A parameter holds 14 bytes of state (bf16 weight, f32
    master, m and v) and 4 of f32 gradient accumulator through the step
    (the step updates its state in place: no second copy at the update)."""
    from repro_torch.configs.base import SHAPES

    gb, seq = SHAPES["train_4k"].global_batch, SHAPES["train_4k"].seq_len
    return [
        # whole: 32 + 32 layers; its own lengths: 1500 frames, 448 tokens
        ("whisper-large-v3", WHISPER, 8, 448, 1500,
         {"global_batch": [gb, 8], "seq": [seq, "448 decoder tokens over 1500 frames, "
                                                "whisper's published lengths"]}),
        # whole (48 blocks); 16 a step, 8 a microbatch: at 16 a microbatch
        # the loss's f32 logits (50304 wide) and their gradients alone would
        # take ~53 GB
        ("mamba2-370m", MAMBA2, 16, seq, 0, {"global_batch": [gb, 16]}),
        # one repeat of the unit (5 Mamba-2 + the shared attention) and the
        # 3-block tail: 9 of 81 blocks; 4 a step, 1 a microbatch (the tail
        # runs outside remat, its SSD activations kept)
        ("zamba2-7b", dataclasses.replace(ZAMBA2, n_repeats=1, n_layers=9), 4, seq, 0,
         {"blocks": [81, 9], "global_batch": [gb, 4]}),
        # one of 32 layers (16 experts; 1.56 B parameters with the
        # embeddings): two (2.8 B) would hold ~61 GB through the backward
        # before the update's f32 temporaries of a 3.4 GB expert leaf, too
        # near the card's 79.6 GB
        ("phi3.5-moe", dataclasses.replace(PHI35, n_layers=1), 8, seq, 0,
         {"layers": [32, 1], "global_batch": [gb, 8]}),
        # two of 48 layers (1.92 B parameters, 1.14 B of them the 92 672-row
        # embedding and unembedding), its 256 patch positions
        ("internvl2-26b", dataclasses.replace(INTERNVL2, n_layers=2), 8, seq, 0,
         {"layers": [48, 2], "global_batch": [gb, 8]}),
    ]


def attention_calls(cfg) -> int:
    """Kernel-6 calls of one forward over one microbatch: one per attention
    block (every ``shared_attn`` occurrence), and for the encoder-decoder
    one per encoder layer and two per decoder layer (self, cross)."""
    if cfg.family == "encdec":
        return cfg.enc_layers + 2 * cfg.dec_layers
    return sum(kind != "mamba" for kind in cfg.layer_pattern)


def _train_family_cell(dev, label, cfg, batch, seq, enc_seq, reduced) -> dict:
    """One cell: bf16 parameters from SEED drawn on the card, the config's
    optimizer rule (f32 master and Adam, or grok's bf16), remat full; one
    warm-up step and TRAIN_FAMILY_TIMED_STEPS timed on ``SyntheticLM`` seed
    0 (``_with_stub_inputs``: whisper's frames zeros, internvl2's patches
    N(0, 1) * 0.02, cast to the config's dtype on the card); each
    step's wall and event ms, tokens/s, peak GB and launches (gated at the
    counts reckoned from the config), loss and grad norm finite, every
    master leaf changing, beside the step's flop bound."""
    from repro_torch.launch.train import batch_to
    from repro_torch.models import model as M
    from repro_torch.optim import optimizer as O
    from repro_torch.train.train_step import effective_microbatches

    t_cell = time.perf_counter()
    steps = TRAIN_FAMILY_TIMED_STEPS + 1
    oc, step, data = _train_setup(cfg, batch, seq, steps, enc_seq)
    n_micro = effective_microbatches(cfg, batch, 1)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    opt = O.init_opt_state(params, oc)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in O.tree_leaves(params))
    flops, remat_flops = train_flops(cfg, params, batch, seq, enc_seq)
    calls = attention_calls(cfg) * n_micro
    expect = {"flash_attention": calls * (2 if cfg.remat == "full" else 1),
              "flash_attention_bwd": calls}
    res = {"config": label, "family": cfg.family, "reduced": reduced,
           "batch": batch, "seq": seq, "n_micro": n_micro, "remat": cfg.remat,
           "n_params": n_params, "param_dtype": cfg.param_dtype,
           "adam_dtype": cfg.adam_dtype, "opt_master": cfg.opt_master, "init_s": init_s,
           "step_flops": flops, "step_bound_ms": flops / BF16_FLOPS * 1e3,
           "remat_recompute_flops": remat_flops,
           "launches_per_step_expected": expect, "steps": []}
    if enc_seq:
        res["enc_seq"] = enc_seq
    dt = M.torch_dtype(cfg.dtype)
    for i in range(steps):
        b = {k: t.to(dt) if t.is_floating_point() else t
             for k, t in batch_to(next(data), dev).items()}
        before_master = [t.clone() for t in O.tree_leaves(
            opt.master if opt.master is not None else params)]
        launched = dict(ops.LAUNCHES)
        torch.cuda.synchronize()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        ev0.record()
        params, opt, metrics = step(params, opt, b)
        ev1.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = O.tree_leaves(opt.master if opt.master is not None else params)
        row = {"step": i + 1, "warm_up": i == 0, "wall_ms": wall * 1e3,
               "event_ms": ev0.elapsed_time(ev1), "tokens_per_s": batch * seq / wall,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "loss": metrics["loss"].item(), "grad_norm": metrics["grad_norm"].item(),
               "launches": {k: ops.LAUNCHES[k] - launched[k] for k in expect},
               "master_leaves_changed": sum(not torch.equal(a, c)
                                            for a, c in zip(before_master, after)),
               "other_launches": {k: ops.LAUNCHES[k] - launched[k] for k in ops.LAUNCHES
                                  if k not in expect and ops.LAUNCHES[k] != launched[k]}}
        del before_master, after, b
        assert math.isfinite(row["loss"]) and math.isfinite(row["grad_norm"]), (label, row)
        assert row["launches"] == expect, (label, row["launches"], expect)
        assert row["master_leaves_changed"] == len(O.tree_leaves(params)), (label, row)
        res["steps"].append(row)
    timed = [r for r in res["steps"] if not r["warm_up"]]
    res["wall_ms_per_step"] = statistics.median(r["wall_ms"] for r in timed)
    res["event_ms_per_step"] = statistics.median(r["event_ms"] for r in timed)
    res["tokens_per_s"] = batch * seq / res["wall_ms_per_step"] * 1e3
    if enc_seq:
        res["frames_per_s"] = batch * enc_seq / res["wall_ms_per_step"] * 1e3
    res["peak_gb"] = max(r["peak_gb"] for r in res["steps"])
    res["bound_over_wall"] = res["step_bound_ms"] / res["wall_ms_per_step"]
    del params, opt, metrics
    gc.collect()
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_cell
    return res


def phase_train_families(dev, cells=None) -> dict:
    """Training for the moe, ssm, hybrid, vlm and enc-dec families on the
    card.  (a) Each of ``train_family_cells`` at published widths
    (``_train_family_cell``).  (b) Every family's SMOKE_CONFIG in f32 at hd
    64 (``_smoke_family_cfg``): TRAIN_FAMILY_SMOKE_STEPS steps on the card
    against the same steps on the CPU (a worker's job), loss and grad norm
    per step within TRAIN_CPU_RTOL, and every leaf's gradient on the first
    batch (``_smoke_grads``) within TRAIN_CPU_RTOL relative L2, and every
    leaf's final parameters within TRAIN_CPU_RTOL relative L2 on the
    elements whose first-batch gradient is 0 or at least
    TRAIN_PARAMS_GRAD_FLOOR (the share left out, and the largest distance
    over all elements, reported beside it); a second card run
    bit for bit equal to the first for the ssm, hybrid, vlm and enc-dec
    families; for the moe family whether it repeats is reported, not gated
    (the backward of its index gathers may add with atomics on the card)."""
    from repro_torch.models import model as M
    from repro_torch.optim import optimizer as O

    t_phase = time.perf_counter()
    smoke = (TRAIN_FAMILY_SMOKE_STEPS, TRAIN_FAMILY_SMOKE_BATCH, TRAIN_FAMILY_SMOKE_SEQ)
    jobs = {a: host_job(_smoke_train_cpu, a, *smoke) for a in TRAIN_FAMILY_ARCHS}
    res = {"phase": "train_families", "card": smi(), "cells": [], "smoke": {}}
    for cell in (train_family_cells() if cells is None else cells):
        res["cells"].append(_train_family_cell(dev, *cell))
    for arch in TRAIN_FAMILY_ARCHS:
        cfg = _smoke_family_cfg(arch)
        p0 = M.init_params(cfg, torch.Generator().manual_seed(SEED), device="cpu")
        ops.reset_launches()
        card = _train_run(cfg, p0, dev, *smoke)
        launches = {k: n for k, n in ops.LAUNCHES.items() if n}
        card2 = _train_run(cfg, p0, dev, *smoke)
        cpu = jobs[arch].result()
        names = leaf_names(p0)
        leaf_rel, gated_rel, left_out = [], [], 0
        for a, c, g in zip(O.tree_leaves(card["params"]), cpu["params"], cpu["grads"]):
            a, c = a.cpu(), torch.from_numpy(c)
            keep = torch.from_numpy((np.abs(g) >= TRAIN_PARAMS_GRAD_FLOOR) | (g == 0))
            leaf_rel.append(rel_l2(a, c))
            gated_rel.append(rel_l2(a[keep], c[keep]) if keep.any() else 0.0)
            left_out += int((~keep).sum())
        grad_rel = [rel_l2(g, torch.from_numpy(c)) for g, c in zip(
            _smoke_grads(cfg, p0, dev, *smoke[1:]), cpu["grads"])]
        row = {"family": cfg.family, "head_dim": cfg.head_dim,
               "batch": TRAIN_FAMILY_SMOKE_BATCH, "seq": TRAIN_FAMILY_SMOKE_SEQ,
               "loss_card": card["loss"], "loss_cpu": cpu["loss"],
               "loss_rel": [abs(a - c) / abs(c) for a, c in zip(card["loss"], cpu["loss"])],
               "grad_norm_rel": [abs(a - c) / abs(c) for a, c in
                                 zip(card["grad_norm"], cpu["grad_norm"])],
               "grads_rel_l2_max": max(grad_rel),
               "grads_rel_l2_worst_leaf": names[grad_rel.index(max(grad_rel))],
               "params_rel_l2_max": max(leaf_rel),
               "params_rel_l2_worst_leaf": names[leaf_rel.index(max(leaf_rel))],
               "params_gated_rel_l2_max": max(gated_rel),
               "params_gated_worst_leaf": names[gated_rel.index(max(gated_rel))],
               "params_grad_floor": TRAIN_PARAMS_GRAD_FLOOR,
               "params_left_out_share": left_out / sum(c.size for c in cpu["params"]),
               "tol": TRAIN_CPU_RTOL, "launches": launches, "cpu_seconds": cpu["seconds"],
               "repeat_runs_equal_bitwise": (_leaves_equal(card["params"], card2["params"])
                                             and card["loss"] == card2["loss"])}
        res["smoke"][arch] = row
        assert max(row["loss_rel"]) <= TRAIN_CPU_RTOL, (arch, row)
        assert max(row["grad_norm_rel"]) <= TRAIN_CPU_RTOL, (arch, row)
        assert row["grads_rel_l2_max"] <= TRAIN_CPU_RTOL, (arch, row)
        assert row["params_gated_rel_l2_max"] <= TRAIN_CPU_RTOL, (arch, row)
        if cfg.family != "moe":
            assert row["repeat_runs_equal_bitwise"], (arch, row)
        del card, card2, cpu
    res["launches"] = {k: sum(r["launches"][k] for c in res["cells"] for r in c["steps"])
                       for k in ("flash_attention", "flash_attention_bwd")}
    gc.collect()
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_phase
    emit(res)
    return res


SERVE_SHAPE = (4, 16, 64, 5, 3, 64)  # the serve phase's pool: 16 pages of 64
#: gemma3-27b's global layers' pool in the serve_gemma3 phase
GEMMA3_DECODE_SHAPE = (4, 16, 64, 16, 2, 128)
#: phi3.5-moe's pool in the serve_phi35 phase (GQA group G = 4)
PHI35_DECODE_SHAPE = (4, 16, 64, 8, 4, 128)
#: qwen2.5-14b's pool in the serve_qwen25 phase (G = 5), yi-34b's at the same
#: 16 pages (G = 7; yi is held at its kernel shapes, not served), and
#: zamba2-7b's shared-attention pool in serve_zamba2 (G = 1, hd = 112)
QWEN25_DECODE_SHAPE = (4, 16, 64, 8, 5, 128)
YI34_DECODE_SHAPE = (4, 16, 64, 8, 7, 128)
ZAMBA2_DECODE_SHAPE = (4, 16, 64, 32, 1, 112)
#: internvl2-26b's pool in serve_internvl2 (G = 6)
INTERNVL2_DECODE_SHAPE = (4, 16, 64, 8, 6, 128)


def serve_params(dev):
    """smollm-360m's random parameters from SEED on the card, and the seconds
    their init took."""
    from repro_torch.models import model as M

    t0 = time.perf_counter()
    params = M.init_params(CONFIG, torch.Generator(device=dev).manual_seed(SEED),
                           device=dev)
    torch.cuda.synchronize()
    return params, time.perf_counter() - t0


#: engine stats that are host-clock seconds or differ by loop by design
LOOP_STATS = ("prefill_s", "decode_s", "loop_captures")
#: the decode-loop planes of a snapshot (``obs/metrics.py``)
LOOP_KEYS = ("serve/loop/steps", "serve/loop/tokens", "serve/loop/token_hist")


def _ssm_states_of(caches) -> dict:
    """The Mamba positions' SSM states of a decode-cache tree (copies), by
    position name."""
    return {name: c.state.clone() for name, c in caches["blocks"].items()
            if isinstance(c, MambaCache)}


def _planes_of(caches) -> list:
    """``pos`` and every policy plane of a decode-cache tree (copies; the
    K/V are left out)."""
    out = [caches["pos"].clone()]
    for _, c in sorted(caches["blocks"].items()):
        if isinstance(c, paged_kv.AdaptivePagedPool):
            out += [t.clone() for t in (*c.pool[2:], *c.policy)]
        elif isinstance(c, paged_kv.PagedPool):
            out += [t.clone() for t in c[2:]]
    return out


class Drive:
    """An engine's request lists in order: per list the results, and the
    engine's stats, ``ops.LAUNCHES``, the decode loops run so far and the
    snapshot's ``serve/loop/*`` planes after it (counted from 0 at the
    start); per decode loop the final planes (``_planes_of``) and SSM states
    (``_ssm_states_of``); at the end the ghost sessions.  ``replay`` sends
    the same lists to another engine."""

    def __init__(self, engine):
        self.engine = engine
        self.calls: list = []
        self.planes: list = []
        self.states: list = []
        self.sessions: dict = {}
        self.graphs: list = []
        for name in ("_graph_loop", "_host_loop"):
            orig = getattr(engine, name)

            def wrapped(*args, _orig=orig, **kwargs):
                out = _orig(*args, **kwargs)
                self.planes.append(_planes_of(out[1]))
                self.states.append(_ssm_states_of(out[1]))
                return out

            setattr(engine, name, wrapped)
        ops.reset_launches()

    def generate(self, reqs):
        asked = [(r.rid, list(r.prompt), r.max_new_tokens, r.temperature) for r in reqs]
        res = self.engine.generate(_requests(asked))
        tel = self.engine.telemetry()
        self.calls.append({
            "asked": asked, "stats": dict(self.engine.stats), "launches": dict(ops.LAUNCHES),
            "loops": len(self.planes), "planes": {k: tel[k] for k in LOOP_KEYS},
            "results": {rid: (r.tokens, r.prefill_cached, r.status) for rid, r in res.items()}})
        self.sessions = {t: dict(s) for t, s in self.engine._kv_sessions.items()}
        # each decode graph's build seconds and static-tree bytes
        self.graphs = [(g.build_s, sum(t.numel() * t.element_size() for t in _leaves(g.caches)))
                       for g in self.engine._graphs.values()]
        return res

    def replay(self, engine) -> "Drive":
        other = Drive(engine)
        for call in self.calls:
            other.generate(_requests(call["asked"]))
        return other


def _requests(asked):
    from repro_torch.serve.engine import Request

    return [Request(rid, list(p), max_new_tokens=n, temperature=t) for rid, p, n, t in asked]


def loops_agree(graph: Drive, host: Drive) -> dict:
    """The graph loop's run against the host loop's on the same requests and
    parameters: greedy tokens, every stat but the clocks and the graph
    count, the launch counts after every request list, the final planes and
    SSM states of every decode loop and the ghost sessions, all equal
    (planes and states bitwise, each position by its name);
    after every request list the snapshot's ``serve/loop/*`` equal bit for
    bit, ``steps`` the sampling events (each loop's first token and its
    decode steps) and ``tokens`` the engine's.  Returns both loops' decode
    seconds and ms per step, and the graphs' build seconds and static-tree
    sizes."""
    assert len(graph.calls) == len(host.calls)
    for i, (g, h) in enumerate(zip(graph.calls, host.calls)):
        assert g["results"] == h["results"], f"request list {i}: tokens differ"
        strip = [{k: v for k, v in c["stats"].items() if k not in LOOP_STATS} for c in (g, h)]
        assert strip[0] == strip[1], (i, strip)
        assert g["launches"] == h["launches"], (i, g["launches"], h["launches"])
        gp, hp = g["planes"], h["planes"]
        hist = gp["serve/loop/token_hist"]
        assert hist.dtype == hp["serve/loop/token_hist"].dtype == np.int32
        assert hist.tobytes() == hp["serve/loop/token_hist"].tobytes(), (i, "token_hist")
        for k in LOOP_KEYS[:2]:
            assert gp[k] == hp[k], (i, k, gp[k], hp[k])
        assert g["loops"] == h["loops"]
        assert gp["serve/loop/steps"] == g["stats"]["decode_steps"] + g["loops"], (i, gp)
        assert gp["serve/loop/tokens"] == g["stats"]["tokens"] == int(hist.sum()), (i, gp)
    assert g["stats"]["nonfinite_logits"] == 0 and h["stats"]["loop_captures"] == 0
    assert len(graph.planes) == len(host.planes) > 0
    for i, (a, b) in enumerate(zip(graph.planes, host.planes)):
        assert all(torch.equal(x, y) for x, y in zip(a, b, strict=True)), \
            f"decode loop {i}: final planes differ"
    gs, hs = graph.sessions, host.sessions
    assert gs.keys() == hs.keys()
    for t in gs:
        for name, st in gs[t].items():
            assert all(torch.equal(x, y) for x, y in zip(st, hs[t][name])), (t, name)
    steps = g["stats"]["decode_steps"]
    tokens = sum(len(r[0]) for c in graph.calls for r in c["results"].values())
    for i, (a, b) in enumerate(zip(graph.states, host.states, strict=True)):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a), \
            f"decode loop {i}: final SSM states differ"
    # a stacked state (n, B, H, P, N) holds n layers
    ssm_layers = sum(t.shape[0] if t.dim() == 5 else 1
                     for s in graph.states for t in s.values())
    return {"tokens_equal": True, "stats_equal": True, "launches_equal": True,
            "planes_equal_bitwise": True, "loop_planes_equal_bitwise": True,
            "loop_steps": gp["serve/loop/steps"], "loop_tokens": gp["serve/loop/tokens"],
            "decode_loops": len(graph.planes),
            "ghost_sessions_equal": bool(gs), "decode_steps": steps, "tokens": tokens,
            "loop_captures": g["stats"]["loop_captures"],
            "graph_build_s": [b for b, _ in graph.graphs],
            "static_tree_gb": [n / 1e9 for _, n in graph.graphs],
            "graph_decode_s": g["stats"]["decode_s"], "host_decode_s": h["stats"]["decode_s"],
            "graph_ms_per_step": g["stats"]["decode_s"] * 1e3 / steps,
            "host_ms_per_step": h["stats"]["decode_s"] * 1e3 / steps,
            "ssm_states_equal_bitwise": True if ssm_layers else None,
            "ssm_layer_states_compared": ssm_layers}


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    vals = tree.values() if isinstance(tree, dict) else tree
    return [t for v in vals for t in _leaves(v)]


#: CUDA runtime calls that block the host until the device is done
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy", "cudaMemcpy2D")


def _host_events_in(events, name: str) -> list:
    """The host-side profiler events that start inside the first
    ``record_function(name)`` range of ``events``."""
    from torch.autograd import DeviceType

    host = [e for e in events if e.device_type != DeviceType.CUDA]
    span = min((e for e in host if e.name == name), key=lambda e: e.time_range.start)
    lo, hi = span.time_range.start, span.time_range.end
    return [e for e in host if lo <= e.time_range.start <= hi]


def one_pull(engine, reps: int = 5) -> dict:
    """One ``telemetry()`` snapshot's cost: its host wall ms (median of
    ``reps`` after a warm-up), then one snapshot under ``torch.profiler``
    inside a ``record_function``: the synchronizing CUDA runtime calls made
    in that range (gated: exactly one) and the device-to-host copies the
    device ran; every snapshot makes one ``_pull``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.obs import metrics as obs_metrics

    pulls = []
    orig = obs_metrics._pull
    obs_metrics._pull = lambda leaves: (pulls.append(len(leaves)), orig(leaves))[1]
    try:
        engine.telemetry()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            tel = engine.telemetry()
            times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function("telemetry_snapshot"):
                engine.telemetry()
            torch.cuda.synchronize()
    finally:
        obs_metrics._pull = orig
    events = prof.events()
    inside = _host_events_in(events, "telemetry_snapshot")
    syncs = [e.name for e in inside if e.name in SYNC_CALLS]
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    d2h = sum(1 for e in device if "DtoH" in e.name or "Device -> Pageable" in e.name)
    assert len(pulls) == reps + 2 and set(pulls) == {pulls[0]}, pulls
    assert len(syncs) == 1, syncs
    return {"keys": len(tel), "device_leaves": pulls[0], "pulls_per_snapshot": 1,
            "sync_calls": len(syncs), "sync_call": syncs[0],
            "memcpy_calls": sum(1 for e in inside if e.name.startswith("cudaMemcpy")),
            "device_to_host_copies": d2h if device else "not measured",
            "snapshot_ms": statistics.median(times), "snapshot_ms_all": times,
            "nvcc_seconds": tel["compile/nvcc/seconds"], "nvcc_builds": tel["compile/nvcc/count"]}


def fold_cost(params, cfg, prompts, dev, new_tokens: int = 64) -> dict:
    """The loop-plane fold's cost in the graph step: the same requests
    served for ``new_tokens`` by an engine with ``metrics=True`` and one with
    ``metrics=False`` (tokens equal, the stats but the clocks equal, no
    planes in the second), each one's graph ms per step, then the decode
    graph profiled both ways (``profile_decode``, graph only): wall ms and
    kernels per step."""
    from repro_torch.serve.engine import Request, ServeEngine

    out, tokens, stats = {}, {}, {}
    for metrics in (True, False):
        eng = ServeEngine(cfg, params, max_len=len(prompts[0]) + new_tokens, kv_mode="paged",
                          fused=True, seed=SEED, metrics=metrics, device=dev)
        res = eng.generate([Request(i, list(p), max_new_tokens=new_tokens)
                            for i, p in enumerate(prompts)])
        tokens[metrics] = [res[i].tokens for i in range(len(prompts))]
        stats[metrics] = {k: v for k, v in eng.stats.items() if k not in LOOP_STATS}
        tel = eng.telemetry()
        assert any(k.startswith("serve/loop/") for k in tel) == metrics
        assert eng._graphs and all((g.planes is not None) == metrics
                                   for g in eng._graphs.values())
        steps = eng.stats["decode_steps"]
        prof = profile_decode(params, cfg, prompts, dev, KERNEL4_CUDA, metrics=metrics,
                              eager=False)["graph"]
        out["metrics_on" if metrics else "metrics_off"] = {
            "engine_graph_ms_per_step": eng.stats["decode_s"] * 1e3 / steps,
            "decode_steps": steps,
            **{k: prof.get(k) for k in ("wall_ms_per_step", "device_ms_per_step",
                                        "kernels_per_step", "graph_launches_per_step")}}
        del eng
    assert tokens[True] == tokens[False], "metrics=False changed the tokens"
    assert stats[True] == stats[False], stats
    on, off = out["metrics_on"], out["metrics_off"]
    out.update({"tokens_equal": True, "new_tokens": new_tokens, "card": smi()})
    if isinstance(on["kernels_per_step"], (int, float)) and \
            isinstance(off["kernels_per_step"], (int, float)):
        out["fold_kernels_per_step"] = on["kernels_per_step"] - off["kernels_per_step"]
    return out


def phase_serve(dev, params, init_s, base_cfg=CONFIG, n_req=4, prompt_len=1024,
                new_tokens=96, pages=16) -> dict:
    """smollm-360m at published widths through ServeEngine(fused=True).  The
    one cut: a 16-page pool (1024 tokens), full after prefill, so AWRP
    evicts during decode."""
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = dataclasses.replace(base_cfg, bounded_kv_pages=pages, kv_policy="awrp")
    reduced = {"bounded_kv_pages": [base_cfg.bounded_kv_pages, cfg.bounded_kv_pages]}
    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(1, cfg.vocab, size=prompt_len).tolist() for _ in range(n_req)]
    max_len = prompt_len + new_tokens
    engine = ServeEngine(cfg, params, max_len=max_len, kv_mode="paged", fused=True,
                         seed=SEED, device=dev)
    drive = Drive(engine)
    results = drive.generate([Request(i, list(p), max_new_tokens=new_tokens)
                              for i, p in enumerate(prompts)])
    launches = drive.calls[0]["launches"]
    stats = drive.calls[0]["stats"]
    expect = ops.SPLIT_LAUNCHES * cfg.n_layers * (new_tokens - 1)
    assert launches["policy_paged_attention"] == expect, (launches, expect)
    assert launches["flash_attention"] == cfg.n_layers * stats["prefills"], launches
    for r in results.values():
        assert len(r.tokens) == new_tokens
        assert all(0 <= tok < cfg.vocab for tok in r.tokens)
    assert stats["nonfinite_logits"] == 0, stats
    assert stats["kv_evictions"] > 0, stats
    assert stats["loop_captures"] == 1, stats

    # one prompt alone twice: the second run must hit the prefix cache
    first = drive.generate([Request(10, list(prompts[0]), max_new_tokens=new_tokens)])
    again = drive.generate([Request(11, list(prompts[0]), max_new_tokens=new_tokens)])
    assert not first[10].prefill_cached and again[11].prefill_cached
    assert engine.prefix_cache.hits == 1
    assert engine.stats["nonfinite_logits"] == 0
    # the split kernels' arrival counters of the engine's capture stream are
    # back at 0 after the last replay
    from repro_torch.kernels import paged_attn

    handle = engine.capture_stream().cuda_stream
    (counters,) = [c for (_, st), c in paged_attn._COUNTERS.items() if st == handle]
    assert int(counters.abs().sum()) == 0
    # the same requests through the host loop, on the same parameters
    host = ServeEngine(cfg, params, max_len=max_len, kv_mode="paged", fused=True,
                       seed=SEED, jit_loop=False, device=dev)
    loops = loops_agree(drive, drive.replay(host))
    del host

    unfused = ServeEngine(cfg, params, max_len=max_len, kv_mode="paged", fused=False,
                          seed=SEED, device=dev)
    ref_res = unfused.generate([Request(i, list(p), max_new_tokens=new_tokens)
                                for i, p in enumerate(prompts)])
    profile = profile_decode(params, cfg, prompts, dev, KERNEL4_CUDA)
    fold = fold_cost(params, cfg, prompts, dev)
    snapshot = one_pull(engine)
    same = sum(a == b for i in results
               for a, b in zip(results[i].tokens, ref_res[i].tokens))
    res = {"phase": "serve", "model": cfg.name, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
           "vocab": cfg.vocab, "dtype": cfg.dtype, "kv_mode": "paged",
           "kv_policy": cfg.kv_policy, "page_size": cfg.page_size,
           "reduced": reduced, "requests": n_req, "prompt_len": prompt_len,
           "new_tokens": new_tokens, "param_init_s": init_s,
           "prefill_s": stats["prefill_s"], "decode_s": stats["decode_s"],
           "decode_tokens_per_s": n_req * (new_tokens - 1) / stats["decode_s"],
           "launches": launches, "launches_expected": expect,
           "flash_launches_per_prefill": launches["flash_attention"] / stats["prefills"],
           "kv_evictions": stats["kv_evictions"],
           "prefix_hit": True, "repeat_tokens_equal": first[10].tokens == again[11].tokens,
           "greedy_agreement_fused_vs_unfused": same / (n_req * new_tokens),
           "unfused_decode_tokens_per_s":
               n_req * (new_tokens - 1) / unfused.stats["decode_s"],
           "loops": loops, "decode_step_profile": profile, "fold_cost": fold,
           "snapshot": snapshot}
    emit(res)
    return res


#: kernels 4-5 held at the QKV-bias, hybrid and VLM families' decode shapes
NEW_DECODE_SHAPES = (QWEN25_DECODE_SHAPE, YI34_DECODE_SHAPE, ZAMBA2_DECODE_SHAPE,
                     INTERNVL2_DECODE_SHAPE)

#: the CUDA kernels of one kernel-4 call (csrc/policy_attn.cu): partials, fold
KERNEL4_CUDA = ("policy_partials_kernel", "policy_fold_kernel")
#: the CUDA kernels of one kernel-5 call (csrc/adaptive_attn.cu)
KERNEL5_CUDA = ("adaptive_partials_kernel", "adaptive_fold_kernel")


def profile_decode(params, cfg, prompts, dev, kernel: tuple, steps: int = 8, *,
                   metrics: bool = True, eager: bool = True) -> dict:
    """Where a decode step's time goes (paged and fused, or full caches for
    the encoder-decoder: ``cell_kv_mode``), in both loops: the eager step
    (``jit_loop=False``'s body) and one replay of the engine's captured
    decode graph (``jit_loop=True``;
    with ``metrics`` the loop-plane fold is in it), from the same prefill
    (the engine's, with its stub inputs), each by ``_profile_steps``;
    ``eager=False`` profiles the graph only.  ``kernel`` names the fused
    step's CUDA kernels (kernel 4 runs as two: its partials and its fold),
    whose share is reported."""
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeEngine

    kv_mode = cell_kv_mode(cfg)
    fused = kv_mode == "paged"
    max_len = len(prompts[0]) + 3 * steps
    engine = ServeEngine(cfg, params, max_len=max_len, kv_mode=kv_mode, fused=fused,
                         metrics=metrics, device=dev)
    logits, caches = engine._prefill([list(p) for p in prompts])
    tok = logits[:, -1:].argmax(dim=-1).to(torch.int32)
    del logits
    graph = engine.decode_graph(caches, sampled=False)
    graph.load(caches, tok, 0.0)
    state = {"tok": tok, "caches": caches}
    del caches

    def run_eager(n):
        for _ in range(n):
            lg, state["caches"] = M.decode_step(params, cfg, state["tok"], state["caches"],
                                                kv_mode=kv_mode, fused=fused)
            state["tok"] = lg.argmax(dim=-1).to(torch.int32)

    def replay(n):
        for _ in range(n):
            graph.step()

    res = {"eager": _profile_steps(run_eager, steps, kernel)} if eager else {}
    res["graph"] = _profile_steps(replay, steps, kernel, sync_errors=True)
    res["graph"]["build_s"] = graph.build_s
    return res


def _profile_steps(run, steps: int, kernel: tuple, *, sync_errors: bool = False) -> dict:
    """``run(steps)`` after a warm-up of as many: the synchronized host wall
    per step, without the profiler (its tracing slows the host side), then
    ``torch.profiler`` over ``run(steps)``.  Device time is the sum of the
    kernels' own intervals (one stream, so they do not overlap); the busy
    share is that over the wall; graph launches are the host's
    ``cudaGraphLaunch`` calls.  With ``sync_errors`` (graph replays) the
    unprofiled runs go under sync debug mode ``"error"``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error" if sync_errors else prev)
    try:
        run(steps)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(steps)
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(steps)
        torch.cuda.synchronize()
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    graph_launches = sum(1 for e in events if e.device_type != DeviceType.CUDA
                         and "cudaGraphLaunch" in e.name)
    if not kernels:
        return {"wall_ms_per_step": wall_ms, "device_ms_per_step": "not measured"}
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / steps
    mine = [e for e in kernels if any(k in e.name for k in kernel)]
    fused = sum(e.time_range.elapsed_us() for e in mine) / 1e3 / steps
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms_per_step": wall_ms, "device_ms_per_step": busy,
            "device_busy_share": busy / wall_ms,
            "fused_kernel": list(kernel), "fused_kernel_ms_per_step": fused,
            "fused_kernel_launches_per_step": len(mine) / steps,
            "fused_kernel_share_of_device": fused / busy if busy else 0.0,
            "kernels_per_step": len(kernels) / steps,
            "graph_launches_per_step": graph_launches / steps,
            "top_kernels_ms_per_step": [[n[:80], ms / steps] for n, ms in top]}


def _adaptive_unfused_step(apool, q, nk, nv, pos, page, core):
    """adaptive_insert_token + paged_attention kernel + adaptive_score_update;
    the page mass goes in row 0 of each page so the hit rule's per-page sum
    is exact."""
    B, P = apool.pool.f.shape
    KVH, G, hd = q.shape[1:]
    apool = paged_kv.adaptive_insert_token(apool, nk.reshape(B, -1),
                                           nv.reshape(B, -1), dpos(pos, q.device),
                                           page, core)
    cur = torch.full((B,), pos, dtype=torch.int32, device=q.device)
    out, mass = ops.paged_attention(q, apool.pool.k.view(B, P, page, KVH, hd),
                                    apool.pool.v.view(B, P, page, KVH, hd),
                                    apool.pool.page_start, cur)
    row_mass = torch.zeros((B, P, page), dtype=torch.float32, device=q.device)
    row_mass[:, :, 0] = mass
    return out, mass, paged_kv.adaptive_score_update(apool, row_mass.reshape(B, -1),
                                                     page, core)


def adaptive_start(gen, kind: str, shape, dev, *, ghost: bool):
    """A full true-adaptive pool as ``pool_from_prefill`` leaves it after a
    P-page prompt (pages 0..P-1 in slots 0..P-1, seeded K/V), the next token
    at a page boundary.  The policy is the prefill seeding, or with ``ghost``
    the cross-request reseed of a previous request that churned pages P..3P-1
    with re-references (ghost hits move ``p``).  Returns ``(apool, pos)``."""
    B, P, page, KVH, G, hd = shape
    _, k, v, _, _, _ = decode_inputs(gen, B, P, page, KVH, G, hd, torch.bfloat16, dev)
    order = torch.arange(P, dtype=torch.int32, device=dev)
    pool = paged_kv.PagedPool(
        k=k.reshape(B, P, page, KVH * hd).contiguous(),
        v=v.reshape(B, P, page, KVH * hd).contiguous(),
        f=torch.ones((B, P), dtype=torch.int32, device=dev),
        r=(order + 1).expand(B, P).contiguous(),
        page_start=(order * page).expand(B, P).contiguous(),
        clock=torch.full((B,), P, dtype=torch.int32, device=dev),
        open_slot=torch.full((B,), P - 1, dtype=torch.int32, device=dev))
    state = paged_kv.seed_adaptive_state(B, P, 0, P, device=dev)
    if ghost:
        churn = [x for y in range(P, 3 * P) for x in (y, y - 1, y - 3)]
        prev, _ = paged_kv.replay_page_ids(state, kind, P, churn)
        state, hits = paged_kv.reseed_from_ghosts(prev, kind, P, P, P)
        assert int(hits.sum()) > 0 and float(state.p.max()) > 0.0, (hits, state.p)
    return paged_kv.AdaptivePagedPool(pool, state), P * page


def phase_adaptive_attn(dev, kind: str, shape=SERVE_SHAPE, steps: int | None = None,
                        *, ghost: bool = False, renorm_at: int | None = None,
                        timed: bool = False, repeat: bool = False) -> dict:
    """Kernel 5, the fused ARC/CAR step, over ``steps`` (default page + 1:
    two evicting page boundaries) decode steps from a full pool: (a) bitwise
    equal to the unfused chain adaptive_insert_token + paged_attention kernel
    + adaptive_score_update on every output and plane; (b) within phase 2's
    tolerances of its plain version, every pool and ARC/CAR plane equal
    except at steps where a page's plain mass lies within EPS_TAU of tau
    (counted).  ``renorm_at`` forces the stamp renormalization: the stamp
    counter starts one below it, so the first access's grant makes the next
    check fire.  With ``repeat`` (implied by ``timed``), the next page
    boundary step and the next mid-page step from the final pool are each
    launched 6 times for equal bits; with ``timed`` both are timed like
    kernels 3 and 4 (the boundary step's times are the phase's)."""
    B, P, page, KVH, G, hd = shape
    gen = torch.Generator().manual_seed(SEED + 7)
    core = paged_kv.adaptive_core(kind, B, P)
    ap, pos0 = adaptive_start(gen, kind, shape, dev, ghost=ghost)
    if renorm_at is not None:
        core = dataclasses.replace(core, renorm_at=renorm_at)
        ap = ap._replace(policy=ap.policy._replace(
            ctr=torch.full_like(ap.policy.ctr, renorm_at - 1)))
    ap_u = ap.clone()
    p_start = float(ap.policy.p.max())
    steps = page + 1 if steps is None else steps
    near_tau, renorms, hits = 0, 0, 0
    err_out, out_x, err_mass, mass_x, abs_out = 0.0, 0.0, 0.0, 0.0, 0.0
    ops.reset_launches()
    for i in range(steps):
        pos = pos0 + i
        q = torch.randn(B, KVH, G, hd, generator=gen).to(torch.bfloat16).to(dev)
        nk = (torch.randn(B, KVH, hd, generator=gen) * 0.3).to(torch.bfloat16).to(dev)
        nv = (torch.randn(B, KVH, hd, generator=gen) * 0.3).to(torch.bfloat16).to(dev)
        ctr_before = ap.policy.ctr.clone()
        plain = ref.adaptive_policy_paged_attention_plain(
            q, ap.pool.k.view(B, P, page, KVH, hd), ap.pool.v.view(B, P, page, KVH, hd),
            nk, nv, dpos(pos, dev), *ap.pool[2:], *(x[:, 0] for x in ap.policy),
            kind=core.kind, renorm_at=core.renorm_at)
        out_f, mass_f, ap = paged_kv.fused_adaptive_decode_step(ap, q, nk, nv,
                                                                dpos(pos, dev), page, core)
        out_u, mass_u, ap_u = _adaptive_unfused_step(ap_u, q, nk, nv, pos, page, core)
        # (a) fused == unfused, bitwise
        assert torch.equal(out_f, out_u), f"{kind}: out differs at pos {pos}"
        assert torch.equal(mass_f, mass_u), f"{kind}: mass differs at pos {pos}"
        for part_f, part_u in ((ap.pool, ap_u.pool), (ap.policy, ap_u.policy)):
            for name, a, b in zip(part_f._fields, part_f, part_u):
                assert torch.equal(a, b), f"{kind}: plane {name} differs at pos {pos}"
        # (b) against the plain version
        err_out = max(err_out, (out_f.float() - plain[0].float()).abs().max().item())
        out_x = max(out_x, excess(out_f, plain[0], OUT_RTOL, OUT_ATOL))
        err_mass = max(err_mass, (mass_f - plain[1]).abs().max().item())
        mass_x = max(mass_x, excess(mass_f, plain[1], MASS_RTOL, MASS_ATOL))
        abs_out += plain[0].float().abs().mean().item() / steps
        psa = plain[5]
        tau = 1.0 / torch.clamp((psa >= 0).sum(dim=-1, keepdim=True).float(), min=1.0)
        close = ((plain[1] - tau).abs() < EPS_TAU) & (psa >= 0)
        got = (*ap.pool[2:], *(x[:, 0] for x in ap.policy))
        planes_equal = all(torch.equal(a, b) for a, b in zip(plain[3:], got))
        if bool(close.any()):
            near_tau += 1
        else:
            assert planes_equal, f"{kind}: planes differ from the plain version at pos {pos}"
        renorms += int((ap.policy.ctr < ctr_before).any())
        hits += int((ap.pool.r == ap.pool.clock[:, None]).sum())
    launches = dict(ops.LAUNCHES)
    assert launches["adaptive_policy_paged_attention"] == ops.SPLIT_LAUNCHES * steps, launches
    assert launches["paged_attention"] == ops.SPLIT_LAUNCHES * steps, launches
    assert out_x <= 1.0 and mass_x <= 1.0, (err_out, out_x, err_mass, mass_x)
    assert hits > 0, "no page was referenced"
    if renorm_at is not None:
        assert renorms > 0, "the forced renormalization never fired"
    res = {"phase": "adaptive_attn", "kind": kind, "shape": [B, P, page, KVH, G, hd],
           "dtype": "bfloat16", "steps": steps, "start_pos": pos0,
           "evicting_steps": -(-steps // page), "start": "ghost reseed" if ghost
           else "prefill seed", "p_at_start": p_start,
           "p_at_end": float(ap.policy.p.max()), "renorm_at": core.renorm_at,
           "renorm_steps": renorms, "hit_accesses": hits,
           "fused_equals_unfused_bitwise": True, "launches": launches,
           "max_abs_err_out": err_out, "out_err_over_tol": out_x,
           "mean_abs_out": abs_out, "max_abs_err_mass": err_mass,
           "mass_err_over_tol": mass_x, "tol_out": [OUT_RTOL, OUT_ATOL],
           "tol_mass": [MASS_RTOL, MASS_ATOL], "eps_tau": EPS_TAU,
           "near_tau_steps": near_tau}
    if timed or repeat:
        # from the final pool: the next page boundary (it evicts; every
        # partials CTA runs the miss) and the next mid-page step (the hit
        # pass alone)
        q = torch.randn(B, KVH, G, hd, generator=gen).to(torch.bfloat16).to(dev)
        nk = torch.randn(B, KVH, hd, generator=gen).to(torch.bfloat16).to(dev)
        kp, vp = ap.pool.k.view(B, P, page, KVH, hd), ap.pool.v.view(B, P, page, KVH, hd)
        kw = {"kind": core.kind, "renorm_at": core.renorm_at}
        L = ap.policy.blocks.shape[-1]
        pos_mid = pos0 + steps + (0 if (pos0 + steps) % page else 1)
        for label, pos in (("boundary", pos0 + -(-steps // page) * page),
                           ("mid_page", pos_mid)):
            args = (q, kp, vp, nk, nk, dpos(pos, dev), *ap.pool[2:],
                    *(x[:, 0] for x in ap.policy))

            def call(args=args):
                return adaptive_policy_paged_attention_kernel(*args, **kw)

            entry = {"pos": pos, "repeat_launches_equal": assert_repeatable(call)}
            if timed:
                cur = torch.full((B,), pos, dtype=torch.int32, device=dev)
                after = call()[5]
                rows = valid_rows(after, cur, page)
                # the directory (4 planes of L int32, p, ctr) read once and
                # written once
                bnd, by = bound(q, kp, rows, extra_bytes=2 * B * (4 * L * 4 + 8))
                ms = time_ms(call)
                entry.update({
                    "ms": ms,
                    "plain_ms": time_ms(lambda args=args: ref.adaptive_policy_paged_attention_plain(
                        *args, **kw), reps=5, warmup=1),
                    "bound_ms": bnd, "bound_by": by,
                    "library_ms": sdpa_ms(q, kp, vp, after, cur),
                    **split_fields(q, kp, rows, ms, bnd)})
            res[label] = entry
        if timed:
            res.update({k: res["boundary"][k] for k in
                        ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    emit(res)
    return res


def phase_serve_adaptive(dev, params, kv_policy: str, *, profile: bool, n_req=4,
                         prompt_len=1024, new_tokens=64, pages=16) -> dict:
    """smollm-360m at published widths, the true-adaptive pool through
    ServeEngine(fused=True), a 16-page pool as in the serve phase: 4 prompts
    of 1024 seeded tokens and 64 greedy new tokens (cut from 96 for the
    time limit); then single requests:
    A and a distinct B of 1024 tokens each, B's follow-up turn (B and the
    tokens B generated: its re-prefill re-references the page positions B's
    decode evicted, so they ghost-hit), and A again (a prefix hit).  Kernel 5
    is called once per layer per decode step (``ops.SPLIT_LAUNCHES``
    launches).  ``p`` is recorded after each
    single request, not gated: it moves only on a B1 ghost hit (a page
    evicted before any reference), and random weights spread attention so
    evenly that every resident page is referenced (page mass near
    1/residents), so pages leave through T2 and B2, where a ghost hit moves
    ``p`` down from 0, as in the reference."""
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = dataclasses.replace(CONFIG, bounded_kv_pages=pages, kv_policy=kv_policy)
    rng = np.random.RandomState(SEED + 11)
    prompts = [rng.randint(1, cfg.vocab, size=prompt_len).tolist() for _ in range(n_req)]
    a, b = (rng.randint(1, cfg.vocab, size=prompt_len).tolist() for _ in range(2))
    def make(jit_loop):
        return ServeEngine(cfg, params, max_len=prompt_len + 2 * new_tokens,
                           kv_mode="paged", fused=True, seed=SEED, jit_loop=jit_loop,
                           device=dev)

    engine = make(True)
    drive = Drive(engine)

    def single(rid, prompt):
        before = engine.stats["kv_ghost_hits"]
        res = drive.generate([Request(rid, list(prompt), max_new_tokens=new_tokens)])[rid]
        tel = engine.telemetry()
        return res, {"prompt_len": len(prompt), "prefix_hit": res.prefill_cached,
                     "kv_ghost_hits": tel["serve/kv_ghost_hits"] - before,
                     "p_max": tel["kv/p_max"], "p_mean": tel["kv/p_mean"]}

    results = drive.generate([Request(i, list(p), max_new_tokens=new_tokens)
                              for i, p in enumerate(prompts)])
    batch_stats = dict(engine.stats)
    res_a, info_a = single(10, a)
    res_b, info_b = single(11, b)
    res_c, info_c = single(12, b + res_b.tokens)
    res_a2, info_a2 = single(13, a)
    launches = dict(ops.LAUNCHES)
    stats = dict(engine.stats)
    assert stats["loop_captures"] == 2, stats  # batch sizes 4 and 1
    # the same requests through the host loop, on the same parameters
    loops = loops_agree(drive, drive.replay(make(False)))
    expect = ops.SPLIT_LAUNCHES * cfg.n_layers * stats["decode_steps"]
    assert stats["decode_steps"] == 5 * (new_tokens - 1), stats
    assert launches["adaptive_policy_paged_attention"] == expect, (launches, expect)
    assert launches["policy_paged_attention"] == 0 and launches["paged_attention"] == 0
    for r in (*results.values(), res_a, res_b, res_c, res_a2):
        assert len(r.tokens) == new_tokens
        assert all(0 <= tok < cfg.vocab for tok in r.tokens)
    assert stats["nonfinite_logits"] == 0, stats
    assert batch_stats["kv_evictions"] > 0, batch_stats
    assert info_c["kv_ghost_hits"] > 0, info_c
    assert not (info_a["prefix_hit"] or info_b["prefix_hit"] or info_c["prefix_hit"])
    assert info_a2["prefix_hit"] and engine.prefix_cache.hits == 1
    res = {"phase": "serve_adaptive", "model": cfg.name, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
           "vocab": cfg.vocab, "dtype": cfg.dtype, "kv_mode": "paged",
           "kv_policy": kv_policy, "page_size": cfg.page_size,
           "reduced": {"bounded_kv_pages": [CONFIG.bounded_kv_pages, pages]},
           "requests": n_req, "prompt_len": prompt_len, "new_tokens": new_tokens,
           "prefill_s_batch": batch_stats["prefill_s"],
           "decode_s_batch": batch_stats["decode_s"],
           "decode_tokens_per_s": n_req * (new_tokens - 1) / batch_stats["decode_s"],
           "single_decode_tokens_per_s":
               4 * (new_tokens - 1) / (stats["decode_s"] - batch_stats["decode_s"]),
           "singles": {"A": info_a, "B": info_b, "B_follow_up": info_c, "A_again": info_a2},
           "decode_steps": stats["decode_steps"], "launches": launches,
           "launches_expected": expect, "kv_evictions": stats["kv_evictions"],
           "kv_ghost_hits": stats["kv_ghost_hits"],
           "repeat_tokens_equal": res_a.tokens == res_a2.tokens, "loops": loops}
    if profile:
        res["decode_step_profile"] = profile_decode(params, cfg, prompts, dev, KERNEL5_CUDA)
    emit(res)
    return res


def _numel(tree) -> int:
    return sum(_numel(v) if isinstance(v, dict) else v.numel() for v in tree.values())


# -- the serve cells' scaffold: one model at published widths per phase ------

#: the block kinds whose decode attends over a paged pool (kernels 4-5)
POOL_KINDS = ("attn", "global", "moe", "shared_attn")


def _pool_layers(cfg) -> int:
    """Layers whose decode attends over a paged pool: none in the
    encoder-decoder, which keeps full caches in every kv_mode."""
    if cfg.family == "encdec":
        return 0
    return sum(k in POOL_KINDS for k in cfg.layer_pattern)


def _init_cell(cfg, dev):
    """``cfg``'s random weights from SEED drawn on the card, the peak
    counter reset first; returns (params, init seconds, the init's peak
    bytes above what was allocated before it)."""
    from repro_torch.models import model as M

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    torch.cuda.synchronize()
    return params, time.perf_counter() - t0, torch.cuda.max_memory_allocated() - before


def cell_kv_mode(cfg) -> str:
    """A serve cell's ``kv_mode``: paged and fused, but full caches for the
    encoder-decoder, which keeps them in every kv_mode (as the reference)."""
    return "full" if cfg.family == "encdec" else "paged"


def _engine_maker(params, dev):
    from repro_torch.serve.engine import ServeEngine

    def make(c, max_len, jit_loop=True):
        kv_mode = cell_kv_mode(c)
        return ServeEngine(c, params, max_len=max_len, kv_mode=kv_mode,
                           fused=kv_mode == "paged", seed=SEED, jit_loop=jit_loop,
                           device=dev)

    return make


def step_bound(cfg, params, pages: int, batch: int, self_rows: int = 0,
               cross_rows: int = 0) -> dict:
    """Least time of one decode step of ``cfg`` at ``batch`` sequences, at
    the HBM rate: every weight the step reads (all but the embedding table,
    of which it reads one row per sequence, unless the table is tied and
    read whole as the unembedding; the shared-attention set once per
    occurrence, as it is far larger than L2; a MoE layer's every expert, as
    the reference's step runs each over its capacity buffer), each pool
    layer's ``pages``-page K/V and each local layer's window ring read once,
    and each Mamba layer's f32 state and conv window read and written
    once.  The encoder-decoder's step reads the decoder's weights and the
    unembedding (not the encoder's), each layer's ``self_rows`` self K/V
    rows (those at or before the step's position) and its ``cross_rows``
    cross K/V rows."""
    def nbytes(tree):
        return sum(nbytes(v) if isinstance(v, dict) else v.numel() * v.element_size()
                   for v in tree.values())

    encdec = cfg.family == "encdec"
    kinds = cfg.layer_pattern
    unread = ("embed", "enc", "enc_final_norm") if encdec else ("embed",)
    weights = nbytes({k: v for k, v in params.items() if k not in unread})
    if cfg.tie_embeddings:
        weights += params["embed"].numel() * params["embed"].element_size()
    if "shared_attn" in params:
        weights += (kinds.count("shared_attn") - 1) * nbytes(params["shared_attn"])
    row = cfg.kv_dim * 2 * 2  # one token's K and V in bf16
    if encdec:
        kv = batch * row * cfg.dec_layers * (self_rows + cross_rows)
    else:
        kv = batch * row * (sum(k in POOL_KINDS for k in kinds) * pages * cfg.page_size
                            + kinds.count("local") * cfg.sliding_window)
    state = kinds.count("mamba") * batch * 2 * (
        cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4
        + (cfg.d_conv - 1) * (cfg.d_inner + 2 * cfg.ssm_state) * 2)
    total = weights + kv + state
    out = {"weight_bytes": weights, "kv_bytes": kv, "ssm_state_bytes": state,
           "bytes": total, "bound_ms": total / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    if encdec:
        out.update({"self_rows": self_rows, "cross_rows": cross_rows})
    if cfg.n_experts:
        out["expert_bytes"] = sum(nbytes({k: v for k, v in blk.items()
                                          if k in ("w_up", "w_gate", "w_down")})
                                  for blk in params.values()
                                  if isinstance(blk, dict) and "w_router" in blk)
    return out


def _serve_batch(make, cfg, prompts, new_tokens, *, flash: int):
    """The cell's batch through a graph-loop engine under a ``Drive``: every
    request's tokens in range, no non-finite logits; kernel 6 launched
    ``flash`` times (its prefill's attention layers), kernel 4
    ``ops.SPLIT_LAUNCHES`` times per pool layer per decode step, kernel 5
    never; evictions exactly when the cell has a pool.  Returns (drive,
    results, launches, stats)."""
    from repro_torch.serve.engine import Request

    n_pool = _pool_layers(cfg)
    drive = Drive(make(cfg, len(prompts[0]) + new_tokens))
    results = drive.generate([Request(i, list(p), max_new_tokens=new_tokens)
                              for i, p in enumerate(prompts)])
    launches, stats = dict(ops.LAUNCHES), dict(drive.engine.stats)
    for r in results.values():
        assert len(r.tokens) == new_tokens
        assert all(0 <= tok < cfg.vocab for tok in r.tokens)
    assert stats["nonfinite_logits"] == 0, stats
    assert launches["flash_attention"] == flash, launches
    assert launches["policy_paged_attention"] == \
        ops.SPLIT_LAUNCHES * n_pool * (new_tokens - 1), launches
    assert launches["adaptive_policy_paged_attention"] == 0, launches
    assert (stats["kv_evictions"] > 0) == (n_pool > 0), stats
    return drive, results, launches, stats


def _prefix_repeat(drive, prompt, new_tokens) -> None:
    """One prompt of the batch alone twice through the drive's engine: the
    first misses the prefix cache, the second hits it, skips its prefill
    and repeats the first's tokens."""
    from repro_torch.serve.engine import Request

    first = drive.generate([Request(10, list(prompt), max_new_tokens=new_tokens)])
    prefills = drive.engine.stats["prefills"]
    again = drive.generate([Request(11, list(prompt), max_new_tokens=new_tokens)])
    assert not first[10].prefill_cached and again[11].prefill_cached
    assert drive.engine.stats["prefills"] == prefills  # the hit skipped its prefill
    assert first[10].tokens == again[11].tokens
    assert drive.engine.prefix_cache.hits == 1
    assert drive.engine.stats["nonfinite_logits"] == 0


def _cell_loops(drive, make, params, cfg, prompts, new_tokens, pages, dev,
                profile_steps: int) -> dict:
    """After the cell's requests: the graph peak, the decode step profiled
    in both loops (``profile_decode``), its bound (``step_bound``), then
    the drive's requests replayed through a host-loop engine and held
    against the graph loop's (``loops_agree``); the drive's engine is
    dropped first (its static tree and prefix payloads).  The
    encoder-decoder's bound counts the first step's self K/V rows and the
    encoder's frames as its cross rows."""
    n_pool = _pool_layers(cfg)
    graph_peak = torch.cuda.max_memory_allocated()
    plen = len(prompts[0])
    profile = profile_decode(params, cfg, prompts, dev, KERNEL4_CUDA if n_pool else (),
                             steps=profile_steps)
    rows = ({"self_rows": plen + 1, "cross_rows": plen // cfg.enc_seq_divisor}
            if cfg.family == "encdec" else {})
    bound = step_bound(cfg, params, pages if n_pool else 0, len(prompts), **rows)
    drive.engine = None
    loops = loops_agree(drive, drive.replay(make(cfg, len(prompts[0]) + new_tokens, False)))
    return {"graph_peak_memory_allocated_gb": graph_peak / 1e9,
            "decode_step_profile": profile, "decode_step_bound": bound, "loops": loops}


def _adaptive_turns(make, cfg, rng, single_len, new_tokens, *, flash: int,
                    follow_up: bool) -> dict:
    """``arc_adaptive`` on the cell's weights (kernel 5 in place of kernel
    4): a request of ``single_len`` seeded tokens and, with ``follow_up``,
    its follow-up turn (the prompt and its tokens), whose re-prefill
    ghost-hits the pages the first turn's decode evicted; kernel 6 launched
    ``flash`` times a prefill, kernel 5 ``ops.SPLIT_LAUNCHES`` times per
    pool layer per decode step, kernel 4 never; then both loops on the same
    turns (``loops_agree``)."""
    from repro_torch.serve.engine import Request

    acfg = dataclasses.replace(cfg, kv_policy="arc_adaptive")
    n_pool = _pool_layers(cfg)
    turns, steps = 1 + follow_up, new_tokens - 1
    max_len = single_len + turns * new_tokens
    drive = Drive(make(acfg, max_len))
    a = rng.randint(1, cfg.vocab, size=single_len).tolist()
    got = [drive.generate([Request(20, list(a), max_new_tokens=new_tokens)])[20]]
    out = {"kv_policy": acfg.kv_policy, "prompt_len": single_len}
    if follow_up:
        gh0 = drive.engine.stats["kv_ghost_hits"]
        got.append(drive.generate([Request(21, a + got[0].tokens,
                                           max_new_tokens=new_tokens)])[21])
        ghost_hits = drive.engine.stats["kv_ghost_hits"] - gh0
        assert not got[1].prefill_cached and ghost_hits > 0, (ghost_hits, drive.engine.stats)
        out.update({"follow_up_len": len(a) + len(got[0].tokens),
                    "kv_ghost_hits_follow_up": ghost_hits})
    launches, stats = dict(ops.LAUNCHES), dict(drive.engine.stats)
    assert launches["flash_attention"] == turns * flash, launches
    assert launches["adaptive_policy_paged_attention"] == \
        ops.SPLIT_LAUNCHES * turns * n_pool * steps, launches
    assert launches["policy_paged_attention"] == 0, launches
    assert stats["nonfinite_logits"] == 0, stats
    assert all(len(r.tokens) == new_tokens for r in got)
    out.update({"launches": launches,
                "adaptive_launches_per_decode_step":
                    launches["adaptive_policy_paged_attention"] / (turns * steps),
                "kv_evictions": stats["kv_evictions"], "prefill_s": stats["prefill_s"],
                "decode_tokens_per_s": turns * steps / stats["decode_s"],
                "p_max": drive.engine.telemetry()["kv/p_max"]})
    drive.engine = None
    out["loops"] = loops_agree(drive, drive.replay(make(acfg, max_len, False)))
    return out


def _cell_result(phase, cfg, base, params, stats, launches, *, n_req, prompt_len,
                 new_tokens, init_s) -> dict:
    """The fields every serve cell reports: its model (``reduced``: each
    cut from ``base``, the published config) and its batch of ``n_req``
    prompts."""
    from repro_torch.models import model as M

    steps = new_tokens - 1
    res = {"phase": phase, "model": cfg.name, "family": cfg.family,
           "layers": cfg.n_layers,
           "layer_kinds": {k: cfg.layer_pattern.count(k) for k in sorted(set(cfg.layer_pattern))},
           "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
           "head_dim": cfg.head_dim, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
           "qkv_bias": cfg.qkv_bias, "params": _numel(params),
           "param_bytes": M.param_bytes(cfg), "dtype": cfg.dtype,
           "kv_mode": cell_kv_mode(cfg), "page_size": cfg.page_size,
           "reduced": {f: [getattr(base, f), getattr(cfg, f)]
                       for f in ("n_layers", "bounded_kv_pages")
                       if getattr(base, f) != getattr(cfg, f)},
           "requests": n_req, "prompt_len": prompt_len, "new_tokens": new_tokens,
           "param_init_s": init_s, "prefill_s": stats["prefill_s"],
           "decode_s": stats["decode_s"],
           "decode_tokens_per_s": n_req * steps / stats["decode_s"],
           "launches": launches, "kv_evictions": stats["kv_evictions"],
           "flash_launches_per_prefill": launches["flash_attention"] / stats["prefills"],
           "policy_launches_per_decode_step": launches["policy_paged_attention"] / steps}
    if cfg.sliding_window:
        res["sliding_window"] = cfg.sliding_window
    if cfg.n_experts:
        res.update({"experts": cfg.n_experts, "top_k": cfg.top_k,
                    "capacity_factor": cfg.capacity_factor})
    if cfg.family == "encdec":
        res.update({"enc_layers": cfg.enc_layers, "dec_layers": cfg.dec_layers,
                    "encoder_frames": prompt_len // cfg.enc_seq_divisor})
        del res["layer_kinds"]
    if cfg.family == "vlm":
        res["n_patch_tokens"] = cfg.n_patch_tokens
    if "mamba" in cfg.layer_pattern:
        res["ssm"] = {"d_inner": cfg.d_inner, "heads": cfg.ssm_heads,
                      "head_dim": cfg.ssm_head_dim, "state": cfg.ssm_state,
                      "chunk": cfg.ssm_chunk, "d_conv": cfg.d_conv}
    return res


def _finish_cell(res, t_phase) -> dict:
    """The phase's peak memory and seconds; the card's memory released."""
    res["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    gc.collect()
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_phase
    emit(res)
    return res


#: decode steps each loop of a PR-24 cell's decode-step profile runs (after
#: as many of warm-up); the earlier cells profile 8
CELL_PROFILE_STEPS = 4


def phase_serve_gemma3(dev, n_req=4, prompt_len=2048, new_tokens=64, pages=16,
                       single_len=1024, unfused_tokens=32) -> dict:
    """gemma3-27b at published widths and all 62 layers through
    ServeEngine(kv_mode="paged", fused=True): the global layers' KV in a
    16-page pool (the one cut, so decode evicts), the local layers' in
    1024-row rings.  AWRP: 4 prompts of 2048 seeded tokens (longer than the
    window) and 64 greedy tokens, then one of them alone twice (the second
    hits the prefix cache and repeats its tokens), and the batch again
    through the unfused engine for ``unfused_tokens`` tokens, whose greedy
    agreement with the fused tokens is recorded (the first token, from the
    shared prefill, must agree); ``arc_adaptive`` on the same weights: a request
    of ``single_len`` tokens (the pool's size, all resident) and its
    follow-up turn (the prompt and its tokens), whose re-prefill ghost-hits
    the pages the first turn's decode evicted.  Kernel 6 launches once per
    layer per prefill, kernel 4 (kernel 5) is called once per global layer
    per AWRP (adaptive) decode step, ``ops.SPLIT_LAUNCHES`` launches each."""
    from repro_torch.serve.engine import Request, ServeEngine

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(GEMMA3, bounded_kv_pages=pages, kv_policy="awrp")
    n_global = cfg.layer_pattern.count("global")
    params, init_s, _ = _init_cell(cfg, dev)
    rng = np.random.RandomState(SEED + 21)
    prompts = [rng.randint(1, cfg.vocab, size=prompt_len).tolist() for _ in range(n_req)]
    make = _engine_maker(params, dev)
    steps = new_tokens - 1
    drive, results, launches, stats = _serve_batch(make, cfg, prompts, new_tokens,
                                                   flash=cfg.n_layers)
    _prefix_repeat(drive, prompts[0], new_tokens)
    total = dict(ops.LAUNCHES)
    assert total["flash_attention"] == 2 * cfg.n_layers, total
    assert total["policy_paged_attention"] == 3 * ops.SPLIT_LAUNCHES * n_global * steps, total
    loops = _cell_loops(drive, make, params, cfg, prompts, new_tokens, pages, dev, 8)
    del drive
    unfused = ServeEngine(cfg, params, max_len=prompt_len + new_tokens, kv_mode="paged",
                          fused=False, seed=SEED, device=dev)
    ref_res = unfused.generate([Request(i, list(p), max_new_tokens=unfused_tokens)
                                for i, p in enumerate(prompts)])
    assert all(ref_res[i].tokens[0] == results[i].tokens[0] for i in results)
    assert unfused.stats["nonfinite_logits"] == 0, unfused.stats
    same = sum(a == b for i in results
               for a, b in zip(results[i].tokens, ref_res[i].tokens))
    unfused_tps = n_req * (unfused_tokens - 1) / unfused.stats["decode_s"]
    del unfused, ref_res
    adaptive = _adaptive_turns(make, cfg, rng, single_len, new_tokens, flash=cfg.n_layers,
                               follow_up=True)
    res = _cell_result("serve_gemma3", cfg, GEMMA3, params, stats, launches, n_req=n_req,
                       prompt_len=prompt_len, new_tokens=new_tokens, init_s=init_s)
    res.update({"launches_with_singles": total, "prefix_hit": True,
                "repeat_tokens_equal": True,
                "greedy_agreement_fused_vs_unfused": same / (n_req * unfused_tokens),
                "unfused_tokens": unfused_tokens, "unfused_decode_tokens_per_s": unfused_tps,
                "adaptive": adaptive, **loops})
    del params
    return _finish_cell(res, t_phase)


PHI35_LAYERS = 24  # of 32: the 32 layers' 83.7 GB of bf16 weights exceed the card


def moe_layer_check(params, cfg, dev, batch: int, seq: int) -> dict:
    """Layer 0's ``layers.moe`` on the card at the prefill shape (batch, seq,
    d_model), bf16, on seeded unit-normal inputs, held against (a) the same
    routing on the CPU from the card's own f32 router logits (the port's
    CPU routing equals the reference's bitwise in the tests): top-k ids,
    dispatch order, ranks and keep mask bitwise, gates within MOE_GATE_RTOL;
    and (b) a plain loop over experts and sequences on the card, written
    from the reference's rule and not from the layer's dispatch: each
    expert's first C pairs in (token, choice) order through its FFN, in f32
    from the same bf16 weights, rounded to bf16 where the layer rounds (the
    products, the activation, the gate product, the sum of the K rows);
    within one bf16 ulp of the value plus MOE_ROW_TOL of the token's
    contribution scale.  At least one pair must be dropped by capacity."""
    import torch.nn.functional as F

    from repro_torch.models import layers as L

    E, K, D = cfg.n_experts, cfg.top_k, cfg.d_model
    C = L.moe_capacity(seq, cfg)
    unit = params["u0"]
    p = {k: unit[k][0] for k in ("w_router", "w_up", "w_gate", "w_down") if k in unit}
    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    x = torch.randn((batch, seq, D), generator=gen, device=dev).to(torch.bfloat16)
    y = L.moe(p, x, cfg)
    t_moe = time_ms(lambda: L.moe(p, x, cfg), reps=5, warmup=1)

    # (a) routing: the layer's logits, routed on the card and on the CPU
    logits = torch.einsum("bsd,de->bse", x, p["w_router"]).to(torch.float32)
    r, rc = L.route(logits, K, C), L.route(logits.cpu(), K, C)
    for field in ("expert_idx", "order", "sorted_e", "rank", "keep"):
        assert torch.equal(getattr(r, field).cpu(), getattr(rc, field)), field
    gate_x = excess(r.gate.cpu(), rc.gate, MOE_GATE_RTOL, 1e-12)
    assert gate_x <= 1, gate_x
    top = torch.sort(logits.cpu(), dim=-1, descending=True).values

    # (b) the plain loop, from the CPU routing's choices and gates
    def mm(a, w):
        return (a.float() @ w.float()).to(torch.bfloat16)

    eidx, gate = rc.expert_idx.to(dev), rc.gate.to(dev)
    contrib = torch.zeros((K, batch, seq, D), dtype=torch.bfloat16, device=dev)
    dropped = 0
    for e in range(E):
        for b in range(batch):
            pairs = (eidx[b] == e).reshape(-1).nonzero()[:, 0]  # s * K + k, ascending
            dropped += max(len(pairs) - C, 0)
            pairs = pairs[:C]
            tok, k = pairs // K, pairs % K
            rows = x[b, tok]
            if cfg.act == "swiglu":
                h = F.silu(mm(rows, p["w_gate"][e])) * mm(rows, p["w_up"][e])
            else:
                h = F.gelu(mm(rows, p["w_up"][e]), approximate="tanh")
            out = mm(h, p["w_down"][e])
            contrib[k, b, tok] = out * gate[b, tok, k].to(torch.bfloat16)[:, None]
    plain = contrib[0] if K == 1 else contrib[0] + contrib[1]
    scale = contrib.float().abs().sum(0).pow(2).mean(-1, keepdim=True).sqrt()
    limit = OUT_RTOL * plain.float().abs() + MOE_ROW_TOL * scale + OUT_ATOL
    out_x = ((y.float() - plain.float()).abs() / limit).max().item()
    assert out_x <= 1, out_x
    assert dropped > 0 and dropped == int((~rc.keep).sum()), dropped
    assert torch.isfinite(y).all()
    return {"shape": [batch, seq, D], "experts": E, "top_k": K, "capacity": C,
            "pairs": batch * seq * K, "dropped_pairs": dropped,
            "tied_top_k_boundary": int((top[..., K - 1] == top[..., K]).sum()),
            "tied_within_top_k": int((top[..., :K - 1] == top[..., 1:K]).sum()),
            "routing_bitwise_to_cpu": True, "gate_excess": gate_x,
            "out_excess": out_x,
            "max_abs_err": (y.float() - plain.float()).abs().max().item(),
            "tol_out": [OUT_RTOL, MOE_ROW_TOL, OUT_ATOL], "tol_gate": MOE_GATE_RTOL,
            "ms": t_moe}


def phase_serve_phi35(dev, n_req=4, prompt_len=2048, new_tokens=64, pages=16,
                      single_len=1024) -> dict:
    """phi3.5-moe at its published widths through ServeEngine(kv_mode="paged",
    fused=True), cut to PHI35_LAYERS layers and a 16-page pool.  AWRP: 4
    prompts of 2048 seeded tokens and 64 greedy tokens (kernel 6 in every
    layer of every prefill, kernel 4 once per layer per decode step,
    ``ops.SPLIT_LAUNCHES`` launches each), then one of them alone twice: the
    second hits the prefix cache, repeats its tokens, and the cache's
    ``entry_bytes`` equals the payload's tensor bytes counted from the
    shapes; ``arc_adaptive`` on the same weights: a request of
    ``single_len`` tokens and its follow-up turn, whose re-prefill
    ghost-hits the pages the first turn's decode evicted (kernel 5).  First,
    layer 0's MoE FFN alone at the prefill shape against the CPU's routing
    and a plain loop (``moe_layer_check``)."""
    from repro_torch.models import model as M

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(PHI35, n_layers=PHI35_LAYERS, bounded_kv_pages=pages,
                              kv_policy="awrp")
    L = cfg.n_layers
    params, init_s, param_peak = _init_cell(cfg, dev)
    # no f32 copy of a stacked leaf: the peak is the weights and one matrix
    assert param_peak < M.param_bytes(cfg) + (1 << 30), (param_peak, M.param_bytes(cfg))
    moe_check = moe_layer_check(params, cfg, dev, n_req, prompt_len)
    rng = np.random.RandomState(SEED + 31)
    prompts = [rng.randint(1, cfg.vocab, size=prompt_len).tolist() for _ in range(n_req)]
    make = _engine_maker(params, dev)
    steps = new_tokens - 1
    drive, _, launches, stats = _serve_batch(make, cfg, prompts, new_tokens, flash=L)
    _prefix_repeat(drive, prompts[0], new_tokens)
    # the stored payload: (last logits (1, 1, Vpad) f32, the caches: the
    # int32 position and one stacked pool of L layers, K/V bf16 and five
    # int32 planes)
    P, page, kvd = pages, cfg.page_size, cfg.kv_dim
    want_bytes = (M.pad_vocab(cfg) * 4 + 4
                  + L * (2 * P * page * kvd * 2 + 3 * P * 4 + 2 * 4))
    entry_bytes = drive.engine.prefix_cache.entry_bytes()
    assert entry_bytes == want_bytes, (entry_bytes, want_bytes)
    total = dict(ops.LAUNCHES)
    assert total["flash_attention"] == 2 * L, total
    assert total["policy_paged_attention"] == 3 * ops.SPLIT_LAUNCHES * L * steps, total
    loops = _cell_loops(drive, make, params, cfg, prompts, new_tokens, pages, dev, 8)
    del drive
    adaptive = _adaptive_turns(make, cfg, rng, single_len, new_tokens, flash=L,
                               follow_up=True)
    res = _cell_result("serve_phi35", cfg, PHI35, params, stats, launches, n_req=n_req,
                       prompt_len=prompt_len, new_tokens=new_tokens, init_s=init_s)
    res.update({"param_init_peak_gb": param_peak / 1e9, "launches_with_singles": total,
                "prefix_hit": True, "repeat_tokens_equal": True,
                "prefix_entry_bytes": entry_bytes, "adaptive": adaptive, **loops,
                "moe_layer": moe_check})
    del params
    return _finish_cell(res, t_phase)


#: std of the QKV biases drawn into qwen2.5's random weights (the reference
#: initialises them to zeros, which would leave the bias path untested)
QKV_BIAS_STD = 0.5
# mamba2_block in bf16 on the card against a plain f32 recurrence: bf16
# rounds the in-projection, the conv's taps and their sum, the C.B products,
# y, the gate and the norm's output, each by up to 2**-9 of the value; the
# conv's 4-tap sum and the norm's division can lift an element's error to a
# few of those, so each token's output row and each (sequence, head) slice
# of the state is held to this relative L2 error, where a wrong decay, skip
# or chunk carry is off by a whole one
MAMBA_REL_TOL = 2.0 ** -4


def _rel_l2(got, want, dims) -> torch.Tensor:
    """Relative L2 error of ``got`` against ``want`` over ``dims``."""
    d = (got.float() - want.float()).pow(2).sum(dims).sqrt()
    return d / want.float().pow(2).sum(dims).sqrt().clamp_min(1e-30)


def _plain_mamba_recurrence(p, x, cfg, state=None, conv=None):
    """The Mamba-2 block in f32 from the same (bf16) weights, token by token
    with ``mamba2_decode_step``'s arithmetic and none of the port's layer
    code: the in-projection, the causal depthwise conv over a sliding
    window, dt = softplus(. + dt_bias), state = state * exp(dt A) + dt B x,
    y = C . state + D x, the gated RMS norm and the out-projection.
    x (B, S, D); returns (y (B, S, D) f32, state (B, H, P, N), conv window)."""
    import torch.nn.functional as F

    B, S, _ = x.shape
    d_in, H, P, N = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    ch = d_in + 2 * N
    w = {k: v.float() for k, v in p.items()}
    zxbcdt = x.float() @ w["w_in"]
    z, xbc, dt_raw = zxbcdt[..., :d_in], zxbcdt[..., d_in:d_in + ch], zxbcdt[..., d_in + ch:]
    window = (torch.zeros((B, cfg.d_conv - 1, ch), device=x.device) if conv is None
              else conv.float())
    state = (torch.zeros((B, H, P, N), device=x.device) if state is None
             else state.float().clone())
    A = -torch.exp(w["a_log"])
    ys = []
    for t in range(S):
        full = torch.cat([window, xbc[:, t:t + 1]], dim=1)  # (B, d_conv, ch)
        window = full[:, 1:]
        u = F.silu((full * w["w_conv"]).sum(1) + w["b_conv"])
        xs, Bm, Cm = u[:, :d_in].reshape(B, H, P), u[:, d_in:d_in + N], u[:, d_in + N:]
        dt = F.softplus(dt_raw[:, t] + w["dt_bias"])  # (B, H)
        state = state * torch.exp(dt * A)[..., None, None] \
            + dt[..., None, None] * xs[..., None] * Bm[:, None, None, :]
        ys.append((state * Cm[:, None, None, :]).sum(-1) + xs * w["d_skip"][:, None])
    y = torch.stack(ys, dim=1).reshape(B, S, d_in) * F.silu(z)
    y = y * torch.rsqrt(y.pow(2).mean(-1, keepdim=True) + cfg.norm_eps) * (1 + w["norm_scale"])
    return y @ w["w_out"], state, window


def mamba_layer_check(params, cfg, dev, batch: int, seq: int) -> dict:
    """Block 0's ``layers.mamba2_block`` on the card at the prefill shape
    (batch, seq, d_model), bf16, on seeded unit-normal inputs, against
    ``_plain_mamba_recurrence`` in f32 from the same weights: each token's
    output row, each (sequence, head) slice of the final state and each row
    of the conv window within MAMBA_REL_TOL relative L2; then one
    ``layers.mamba2_decode_step`` from the block's state and conv window
    against one plain step from the plain ones, the same bound."""
    from repro_torch.models import layers as L
    from repro_torch.models.model import torch_dtype

    p = {k: v[0] for k, v in params["u0"].items()}
    dtype = torch_dtype(cfg.dtype)
    gen = torch.Generator(device=dev).manual_seed(SEED + 51)
    x = torch.randn((batch, seq, cfg.d_model), generator=gen, device=dev).to(dtype)
    y, state, conv = L.mamba2_block(p, x, cfg)
    t_block = time_ms(lambda: L.mamba2_block(p, x, cfg), reps=5, warmup=1)
    t0 = time.perf_counter()
    y_p, state_p, conv_p = _plain_mamba_recurrence(p, x, cfg)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    assert torch.isfinite(y.float()).all() and torch.isfinite(state).all()
    assert state.dtype == torch.float32
    y_x = _rel_l2(y, y_p, -1).max().item()
    st_x = _rel_l2(state, state_p, (-2, -1)).max().item()
    cv_x = _rel_l2(conv, conv_p, -1).max().item()
    assert max(y_x, st_x, cv_x) <= MAMBA_REL_TOL, (y_x, st_x, cv_x)
    xt = torch.randn((batch, 1, cfg.d_model), generator=gen, device=dev).to(dtype)
    y1, state1, conv1 = L.mamba2_decode_step(p, xt, cfg, state=state, conv_state=conv)
    y1_p, state1_p, conv1_p = _plain_mamba_recurrence(p, xt, cfg, state_p, conv_p)
    y1_x = _rel_l2(y1, y1_p, -1).max().item()
    st1_x = _rel_l2(state1, state1_p, (-2, -1)).max().item()
    assert y1_x <= MAMBA_REL_TOL and st1_x <= MAMBA_REL_TOL, (y1_x, st1_x)
    cv1_x = _rel_l2(conv1, conv1_p, -1).max().item()
    assert cv1_x <= MAMBA_REL_TOL and not torch.equal(state1, state), cv1_x
    return {"shape": [batch, seq, cfg.d_model], "ssm_heads": cfg.ssm_heads,
            "ssm_head_dim": cfg.ssm_head_dim, "ssm_state": cfg.ssm_state,
            "chunk": cfg.ssm_chunk, "tol_rel_l2": MAMBA_REL_TOL,
            "block_out_rel_l2_max": y_x, "block_state_rel_l2_max": st_x,
            "block_conv_rel_l2_max": cv_x, "step_out_rel_l2_max": y1_x,
            "step_state_rel_l2_max": st1_x, "step_conv_rel_l2_max": cv1_x,
            "max_abs_err": (y.float() - y_p).abs().max().item(),
            "mean_abs_out": y_p.abs().mean().item(),
            "block_ms": t_block, "plain_recurrence_s": plain_s}


def phase_serve_qwen25(dev, n_req=4, prompt_len=2048, new_tokens=32, pages=16,
                       single_len=1024) -> dict:
    """qwen2.5-14b at published widths and all 48 layers (QKV bias, GQA
    group G = 5) through ServeEngine(kv_mode="paged", fused=True), random
    bf16 weights from SEED drawn on the card with the q/k/v biases drawn
    nonzero (N(0, QKV_BIAS_STD)), a 16-page pool: 4 prompts of 2048 seeded
    tokens and 32 greedy tokens (AWRP: kernel 6 in every layer of every
    prefill, kernel 4 once per layer per decode step, ``ops.SPLIT_LAUNCHES``
    launches each), then one ``arc_adaptive`` request of ``single_len``
    tokens (kernel 5 at G = 5); both decode loops on the same requests."""
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(QWEN25, bounded_kv_pages=pages, kv_policy="awrp")
    params, init_s, _ = _init_cell(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 61)
    for name in ("bq", "bk", "bv"):
        leaf = params["u0"][name]
        leaf.copy_(torch.randn(leaf.shape, generator=gen, device=dev) * QKV_BIAS_STD)
    rng = np.random.RandomState(SEED + 61)
    prompts = [rng.randint(1, cfg.vocab, size=prompt_len).tolist() for _ in range(n_req)]
    make = _engine_maker(params, dev)
    drive, _, launches, stats = _serve_batch(make, cfg, prompts, new_tokens,
                                             flash=cfg.n_layers)
    loops = _cell_loops(drive, make, params, cfg, prompts, new_tokens, pages, dev,
                        CELL_PROFILE_STEPS)
    del drive
    adaptive = _adaptive_turns(make, cfg, rng, single_len, new_tokens, flash=cfg.n_layers,
                               follow_up=False)
    res = _cell_result("serve_qwen25", cfg, QWEN25, params, stats, launches, n_req=n_req,
                       prompt_len=prompt_len, new_tokens=new_tokens, init_s=init_s)
    res.update({"gqa_group": cfg.n_heads // cfg.n_kv_heads, "qkv_bias_std": QKV_BIAS_STD,
                "adaptive": adaptive, **loops})
    del params
    return _finish_cell(res, t_phase)


def phase_serve_zamba2(dev, n_req=4, prompt_len=2048, new_tokens=32, pages=16) -> dict:
    """zamba2-7b at published widths and all 81 blocks (13 x (5 Mamba-2 + 1
    shared-attention block, one parameter set for the 13) + 3 Mamba-2; 32
    heads of hd = 112, G = 1) through ServeEngine(kv_mode="paged",
    fused=True), random bf16 weights from SEED drawn on the card, 16 pages
    per shared-attention occurrence: 4 prompts of 2048 seeded tokens and 32
    greedy tokens (AWRP: kernel 6 at hd = 112 in each occurrence of every
    prefill, kernel 4 once per occurrence per decode step; the Mamba blocks'
    SSD scan and recurrent step in torch ops); both decode loops on the same
    requests.  First, block 0's Mamba-2 layer against a plain f32
    recurrence (``mamba_layer_check``)."""
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(ZAMBA2, bounded_kv_pages=pages, kv_policy="awrp")
    n_shared = cfg.layer_pattern.count("shared_attn")
    params, init_s, _ = _init_cell(cfg, dev)
    mamba_check = mamba_layer_check(params, cfg, dev, n_req, prompt_len)
    rng = np.random.RandomState(SEED + 71)
    prompts = [rng.randint(1, cfg.vocab, size=prompt_len).tolist() for _ in range(n_req)]
    make = _engine_maker(params, dev)
    drive, _, launches, stats = _serve_batch(make, cfg, prompts, new_tokens, flash=n_shared)
    loops = _cell_loops(drive, make, params, cfg, prompts, new_tokens, pages, dev,
                        CELL_PROFILE_STEPS)
    del drive
    res = _cell_result("serve_zamba2", cfg, ZAMBA2, params, stats, launches, n_req=n_req,
                       prompt_len=prompt_len, new_tokens=new_tokens, init_s=init_s)
    res.update({"shared_attn_occurrences": n_shared, "shared_attn_param_sets": 1,
                **loops, "mamba_layer": mamba_check})
    del params
    return _finish_cell(res, t_phase)


def phase_serve_mamba2(dev, n_req=4, prompt_len=1024, new_tokens=16) -> dict:
    """mamba2-370m at published widths and all 48 Mamba-2 blocks through
    ServeEngine(kv_mode="paged", fused=True): attention-free, so no pool and
    no kernel of the port runs (every launch count stays 0; the SSD scan and
    the recurrent step are torch ops, as the reference leaves them to XLA).
    4 prompts of 1024 seeded tokens and 16 greedy tokens (cut from 32 to
    pay for the rows_mesh phase), then one of them alone twice: the second hits the prefix cache (the SSM states after
    prefill), skips its prefill and repeats its tokens, and the cache's
    ``entry_bytes`` equals the payload's tensor bytes counted from the
    shapes; both decode loops on the same requests."""
    from repro_torch.models import model as M

    t_phase = time.perf_counter()
    cfg = MAMBA2
    params, init_s, _ = _init_cell(cfg, dev)
    rng = np.random.RandomState(SEED + 81)
    prompts = [rng.randint(1, cfg.vocab, size=prompt_len).tolist() for _ in range(n_req)]
    make = _engine_maker(params, dev)
    drive, _, launches, stats = _serve_batch(make, cfg, prompts, new_tokens, flash=0)
    _prefix_repeat(drive, prompts[0], new_tokens)
    # the stored payload: the last logits (1, 1, Vpad) f32, the int32
    # position, and per layer the f32 state and the conv window
    want_bytes = M.pad_vocab(cfg) * 4 + 4 + cfg.n_layers * (
        cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4
        + (cfg.d_conv - 1) * (cfg.d_inner + 2 * cfg.ssm_state) * 2)
    entry_bytes = drive.engine.prefix_cache.entry_bytes()
    assert entry_bytes == want_bytes, (entry_bytes, want_bytes)
    total = dict(ops.LAUNCHES)
    assert not any(total.values()), total
    loops = _cell_loops(drive, make, params, cfg, prompts, new_tokens, 0, dev,
                        CELL_PROFILE_STEPS)
    del drive
    res = _cell_result("serve_mamba2", cfg, MAMBA2, params, stats, launches, n_req=n_req,
                       prompt_len=prompt_len, new_tokens=new_tokens, init_s=init_s)
    res.update({"kernels_launched": 0, "prefix_hit": True, "prefix_hit_skipped_prefill": True,
                "repeat_tokens_equal": True, "prefix_entry_bytes": entry_bytes, **loops})
    del params
    return _finish_cell(res, t_phase)


def cross_kv_read_only(engine, prompts, steps: int) -> dict:
    """The encoder-decoder's cross K/V are projected once at prefill and
    only read by a decode step: a prefill through the engine, then
    ``steps`` replays of its decode graph and as many eager steps, after
    which ``ck`` / ``cv`` equal the prefill's bit for bit in the graph's
    static tree (the loads copy them in once) and in the eager caches."""
    from repro_torch.models import model as M

    logits, caches = engine._prefill([list(p) for p in prompts])
    tok = logits.argmax(dim=-1).to(torch.int32)
    want = {n: caches["blocks"]["dec"][n].clone() for n in ("ck", "cv")}
    graph = engine.decode_graph(caches, sampled=False)
    graph.load(caches, tok, 0.0)
    for _ in range(steps):
        graph.step()
    state = M.clone_caches(caches)
    for _ in range(steps):
        lg, state = M.decode_step(engine.params, engine.cfg, tok, state)
        tok = lg.argmax(dim=-1).to(torch.int32)
    for tree in (graph.caches, state):
        for n, t in want.items():
            assert torch.equal(tree["blocks"]["dec"][n], t), n
    assert int(graph.caches["pos"]) == int(state["pos"]) == len(prompts[0]) + steps
    return {"steps": steps, "cross_rows": want["ck"].shape[2],
            "cross_kv_equal_bitwise": True}


def phase_serve_whisper(dev, n_req=4, prompt_len=3008, new_tokens=32) -> dict:
    """whisper-large-v3 at published widths and all 32 + 32 layers (d 1280,
    20 heads of hd = 64, G = 1, GELU, sinusoidal positions) through
    ServeEngine(kv_mode="full"), random bf16 weights from SEED drawn on the
    card: 4 prompts of 3008 seeded tokens (47 pages of 64), so the encoder
    runs over the engine's 1504 zero frames (the page-aligned count nearest
    whisper's 1500), and 32 greedy tokens; kernel 6 launches 96 times a
    prefill (32 encoder layers non-causal, 32 decoder self-attentions
    causal, 32 cross-attentions at Sq = 3008 over Skv = 1504); the decode
    step (self and cross attention over full caches) is plain torch, as the
    reference's jnp, and the decode graph captures ``full_cache_insert``'s
    write at the device ``pos``.  Then one prompt alone twice (a prefix hit
    that skips its prefill), the cross K/V held read-only over decode
    (``cross_kv_read_only``) and both decode loops on the same requests."""
    t_phase = time.perf_counter()
    cfg = WHISPER
    flash = cfg.enc_layers + 2 * cfg.dec_layers
    params, init_s, _ = _init_cell(cfg, dev)
    rng = np.random.RandomState(SEED + 91)
    prompts = [rng.randint(1, cfg.vocab, size=prompt_len).tolist() for _ in range(n_req)]
    make = _engine_maker(params, dev)
    drive, _, launches, stats = _serve_batch(make, cfg, prompts, new_tokens, flash=flash)
    _prefix_repeat(drive, prompts[0], new_tokens)
    total = dict(ops.LAUNCHES)
    assert total["flash_attention"] == 2 * flash, total  # the hit skipped its prefill
    assert not any(v for k, v in total.items() if k != "flash_attention"), total
    cross = cross_kv_read_only(drive.engine, prompts, steps=4)
    loops = _cell_loops(drive, make, params, cfg, prompts, new_tokens, 0, dev,
                        CELL_PROFILE_STEPS)
    del drive
    res = _cell_result("serve_whisper", cfg, WHISPER, params, stats, launches, n_req=n_req,
                       prompt_len=prompt_len, new_tokens=new_tokens, init_s=init_s)
    res.update({"launches_with_singles": total, "prefix_hit": True,
                "prefix_hit_skipped_prefill": True, "repeat_tokens_equal": True,
                "cross_kv": cross, **loops})
    del params
    return _finish_cell(res, t_phase)


#: internvl2-26b's layers served: all 48 (19.86 B parameters, 39.7 GB in bf16)
INTERNVL2_LAYERS = 48


def phase_serve_internvl2(dev, n_req=4, prompt_len=2048, new_tokens=32, pages=16) -> dict:
    """internvl2-26b's language backbone at published widths (d 6144, 48 / 8
    heads of hd = 128, G = 6, d_ff 16384, vocab 92553) and INTERNVL2_LAYERS
    layers through ServeEngine(kv_mode="paged", fused=True), random bf16
    weights from SEED drawn on the card, a 16-page pool: 4 prompts of 2048
    seeded tokens, whose first 256 positions take the engine's zero patch
    embeddings (the vision stub), and 32 greedy tokens (AWRP: kernel 6 in
    every layer of every prefill, kernel 4 once per layer per decode step,
    ``ops.SPLIT_LAUNCHES`` launches each); both decode loops on the same
    requests.  Kernel 5 at G = 6 is held by its rows in ``adaptive_attn``."""
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(INTERNVL2, n_layers=INTERNVL2_LAYERS, bounded_kv_pages=pages,
                              kv_policy="awrp")
    params, init_s, _ = _init_cell(cfg, dev)
    rng = np.random.RandomState(SEED + 101)
    prompts = [rng.randint(1, cfg.vocab, size=prompt_len).tolist() for _ in range(n_req)]
    make = _engine_maker(params, dev)
    drive, _, launches, stats = _serve_batch(make, cfg, prompts, new_tokens,
                                             flash=cfg.n_layers)
    loops = _cell_loops(drive, make, params, cfg, prompts, new_tokens, pages, dev,
                        CELL_PROFILE_STEPS)
    del drive
    res = _cell_result("serve_internvl2", cfg, INTERNVL2, params, stats, launches,
                       n_req=n_req, prompt_len=prompt_len, new_tokens=new_tokens,
                       init_s=init_s)
    res.update({"gqa_group": cfg.n_heads // cfg.n_kv_heads, **loops})
    del params
    return _finish_cell(res, t_phase)


def select_inputs(gen, B, P, dev, *, pinned: bool):
    """Seeded AWRP metadata at (B, P): F in 1..49, R below the clock, ~90 %
    of lanes valid; rows 1 and 2 tie-heavy (F in 1..3, R in a window of 4,
    so many weights are exactly equal), row 0 (when B > 3) all invalid."""
    f = torch.randint(1, 50, (B, P), generator=gen, dtype=torch.int32)
    r = torch.randint(0, 1000, (B, P), generator=gen, dtype=torch.int32)
    clock = torch.randint(1001, 2000, (B,), generator=gen, dtype=torch.int32)
    valid = (torch.rand(B, P, generator=gen) < 0.9).to(torch.int32)
    for b in (1, 2):
        if b < B:
            f[b] = torch.randint(1, 4, (P,), generator=gen, dtype=torch.int32)
            r[b] = torch.randint(0, 4, (P,), generator=gen, dtype=torch.int32)
            clock[b] = 6
    if B > 3:
        valid[0] = 0
    args = [f, r, clock, valid]
    if pinned:
        args.append((torch.rand(B, P, generator=gen) < 0.1).to(torch.int32) * valid)
    return [a.to(dev) for a in args]


def phase_awrp_select(dev) -> dict:
    """Kernels 1 and 2 against their plain versions, exact equality of the
    (B,) victims: kernel 2 at the sweep's shapes (Table 1: 32 flat rows of
    240 lanes; the 64-trace grid: 2048), kernel 1 at the serve pool's (B=4,
    P=16 and 256) with pinned lanes; plus ragged P (30, 1) and B not a
    multiple of 8.  Times at the main shapes: kernel (CUDA events), plain
    version, and the byte bound (each input read once, the victims written
    once, at 3.35 TB/s).  No single PyTorch call computes a first-index
    bit-pattern min, so there is no library time."""
    from repro_torch.kernels.awrp_select import (awrp_select_kernel,
                                                 awrp_select_rows_kernel)

    gen = torch.Generator().manual_seed(SEED + 5)
    cases = {"awrp_select_rows": [(32, 240), (2048, 240), (13, 30), (5, 1), (9, 240)],
             "awrp_select": [(4, 16), (4, 256), (13, 30), (3, 1)]}
    kern = {"awrp_select_rows": (awrp_select_rows_kernel, ref.awrp_select_rows_plain, 12),
            "awrp_select": (awrp_select_kernel, ref.awrp_select_plain, 16)}
    res = {"phase": "awrp_select", "kernels": {}}
    for name, shapes in cases.items():
        fn, plain, row_bytes = kern[name]
        runs = []
        for B, P in shapes:
            args = select_inputs(gen, B, P, dev, pinned=name == "awrp_select")
            got = fn(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            assert got.dtype == torch.int32 and got.shape == (B,), (name, B, P)
            assert torch.equal(got, want), (name, B, P, got, want)
            if B > 3:
                assert int(got[0]) == 0  # every lane invalid: lane 0
            run = {"B": B, "P": P, "equal": True}
            if len(runs) < 2:  # the main path's shapes: timed
                run.update({
                    "ms": time_ms(lambda: fn(*args), reps=200, warmup=10),
                    "plain_ms": time_ms(lambda: plain(*args), reps=50, warmup=5),
                    "bound_ms": (B * P * row_bytes + 8 * B) / HBM_BYTES_PER_S * 1e3,
                    "bound_by": "bytes", "library_ms": None})
            runs.append(run)
        res["kernels"][name] = runs
    emit(res)
    return res


TABLE1_CAPS = [30, 60, 90, 120, 150, 180, 210, 240]


def _host_hits(policy, trace, cap, num_sets=1) -> np.ndarray:
    """Per-access hit bits of the host oracles under the simulator's set
    mapping (one oracle instance per set)."""
    from repro_torch.core.policies import make_policy

    insts = [make_policy(policy, cap // num_sets) for _ in range(num_sets)]
    return np.array([insts[b % num_sets].access(b) for b in trace.tolist()], dtype=bool)


def _host_counts(pols, trace, caps) -> tuple:
    """(hit counts (policies, caps) of the host oracles, seconds)."""
    t0 = time.perf_counter()
    counts = np.array([[int(_host_hits(p, trace, c).sum()) for c in caps] for p in pols])
    return counts, time.perf_counter() - t0


#: the sweep benchmark's zipf trace at its smoke size and at its large one
ZIPF_N = 10_000
ZIPF_BIG = 100_000


def zipf_trace(n: int) -> np.ndarray:
    """The sweep benchmark's trace (``benchmarks/policy_overhead.py``):
    ``trace_zipf(n, 2_000, 0.9, seed=5)``."""
    from repro_torch.core.traces import trace_zipf

    return trace_zipf(n, 2_000, 0.9, seed=5)


def _zipf_host_row(policy: str, n: int) -> tuple:
    """One policy's row of ``_host_counts`` on ``zipf_trace(n)`` (a worker's
    job)."""
    counts, seconds = _host_counts([policy], zipf_trace(n), TABLE1_CAPS)
    return counts[0], seconds


def _zipf_host_counts(pols, n: int) -> tuple:
    """``_host_counts(pols, zipf_trace(n), TABLE1_CAPS)``, a worker process
    per policy: (counts, the workers' seconds summed)."""
    rows = [f.result() for f in [host_job(_zipf_host_row, p, n) for p in pols]]
    return np.stack([c for c, _ in rows]), sum(t for _, t in rows)


def sweep_traces(kind: str, n: int) -> np.ndarray:
    """The sweep phase's traces: ``zipf_trace(n)`` (kind ``"zipf"``) or the
    paper traces of seeds 0..n-1, (n, 1000) (kind ``"paper"``)."""
    from repro_torch.core.traces import paper_trace

    if kind == "zipf":
        return zipf_trace(n)
    return np.stack([paper_trace(seed=s) for s in range(n)])


def _eager_cpu(kind: str, n: int, num_sets: int = 1, renorm_at=None) -> tuple:
    """The engine's eager route (``use_kernel=False``) on the CPU over
    ``sweep_traces(kind, n)`` x the device policies x TABLE1_CAPS (a
    worker's job): (hits as ``_engine`` returns them, seconds)."""
    from repro_torch.core.policy_core import DEVICE_POLICIES
    from repro_torch.core.torch_policies import simulate_trace_batched

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    hits = simulate_trace_batched(sweep_traces(kind, n), list(DEVICE_POLICIES), TABLE1_CAPS,
                                  num_sets=num_sets, use_kernel=False, device="cpu",
                                  _renorm_at=renorm_at)
    return hits.numpy(), time.perf_counter() - t0


def host_jobs() -> list:
    """Every check of a later phase that needs no card, as the phases call
    ``host_job``: [(function, *args)]; the training phases' CPU runs first
    (the earliest phases to read one), then the longest first."""
    from repro_torch.core.policy_core import DEVICE_POLICIES

    return [(_smoke_train_cpu, "smollm_360m", 3, TRAIN_SMOKE_BATCH, TRAIN_SMOKE_SEQ),
            *((_smoke_train_cpu, a, TRAIN_FAMILY_SMOKE_STEPS, TRAIN_FAMILY_SMOKE_BATCH,
               TRAIN_FAMILY_SMOKE_SEQ) for a in TRAIN_FAMILY_ARCHS),
            (_eager_cpu, "paper", 64, 1, None), (_eager_cpu, "paper", 8, 2, 64),
            (_eager_cpu, "zipf", ZIPF_N, 1, None), (_eager_cpu, "paper", 8, 2, None),
            *((_zipf_host_row, p, n) for n in (ZIPF_BIG, ZIPF_N) for p in DEVICE_POLICIES),
            *((_cpu_drive, c) for c in tenancy_cases())]


def _syncs() -> int:
    from repro_torch.core import policy_core

    return sum(policy_core.HOST_SYNCS.values())


def _engine(traces, policies, caps, **kw):
    """One engine call on the card: (hits on the host, seconds, launches of
    the kernels, host syncs of the core)."""
    from repro_torch.core.torch_policies import simulate_trace_batched

    syncs0 = _syncs()
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    hits = simulate_trace_batched(traces, policies, caps, device="cuda", **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    return hits.cpu().numpy(), seconds, launches, _syncs() - syncs0


def _assert_trace_route(launches, syncs) -> None:
    """One call of the trace route over the six device policies: one
    flat_sweep launch, one adaptive_sweep launch per adaptive kind (arc,
    car), no kernel-2 launch, no host sync."""
    assert launches["flat_sweep"] == 1, launches
    assert launches["adaptive_sweep"] == 2, launches
    assert launches["awrp_select_rows"] == 0, launches
    assert syncs == 0, syncs


def _groups(traces, pols, caps, num_sets, dev):
    """The engine's row groups of a grid on the card, and its traces there."""
    from repro_torch.core.policy_core import POLICY_IDS
    from repro_torch.core.torch_policies import _grid_groups

    ways = tuple(c // num_sets for c in caps)
    tr = torch.as_tensor(np.atleast_2d(traces).astype(np.int32), device=dev)
    return _grid_groups(tr.shape[0], tuple(POLICY_IDS[p] for p in pols), ways, dev), tr, \
        max(ways)


def _planes_equal_plain(traces, pols, caps, dev, *, num_sets=1, renorm_at=None) -> dict:
    """Both trace kernels against their plain versions on the card, over the
    engine's groups of this grid: hits and every final plane bitwise (``p``
    as its int32 bits).  Returns the plain versions' seconds."""
    from repro_torch.core.torch_policies import _sweep_groups

    groups, tr, W = _groups(traces, pols, caps, num_sets, dev)
    got = _sweep_groups(tr, groups, num_sets, W, renorm_at)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = _sweep_groups(tr, groups, num_sets, W, renorm_at, flat=ref.flat_sweep_plain,
                         adaptive=ref.adaptive_sweep_plain)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    for g, (gh, gs), (wh, ws) in zip(groups, got, want):
        assert torch.equal(gh, wh), ("hits", g.kind)
        for name, a, b in zip(gs._fields, gs, ws):
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b), ("final plane", g.kind, name)
    return {"plain_seconds": plain_s, "planes_equal_plain": [g.kind for g in groups]}


def _sweep_bound(traces, rows: int, hits, plane_ints: int, lanes_per_access: np.ndarray,
                 extra_ops: float = 0.0) -> tuple:
    """(bound_ms, bound_by) of one trace-kernel call: the bytes it must move
    (the traces it reads, 4 per-row int32s, the (rows, T) bool hits, the
    final planes, each once) at the HBM rate, against its 32-bit operations
    at the f32 peak: per access one comparison per live lane (the hit
    search), per miss two more (the victim key and its minimum), plus
    ``extra_ops``."""
    nbytes = traces.numel() * 4 + rows * 16 + hits.numel() + plane_ints * 4
    misses = (~hits).sum(dim=1).cpu().numpy()
    n_ops = float((lanes_per_access * (hits.shape[1] + 2 * misses)).sum()) + extra_ops
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_trace_kernels(dev, pols, caps) -> dict:
    """Each trace kernel timed alone on Table 1's groups (one row group's
    whole 1000-step trace per call) and on the 64-trace grid's, beside its
    plain version at Table 1's and its bound; ``ms_per_step`` is the call's
    time over T (each row's steps are a serial chain)."""
    from repro_torch.core.traces import paper_trace

    out = {"flat_sweep": [], "adaptive_sweep": []}
    for label, traces in (("table1", paper_trace()),
                          ("grid64", np.stack([paper_trace(seed=s) for s in range(64)]))):
        groups, tr, W = _groups(traces, pols, caps, 1, dev)
        T = tr.shape[1]
        for g in groups:
            if g.kind == "flat":
                name = "flat_sweep"
                args, kw = (tr, g.row_trace, g.pids, g.ways), dict(num_sets=1, lanes=W)
                fn, plain = ops.flat_sweep, ref.flat_sweep_plain
            else:
                name = "adaptive_sweep"
                args = (tr, g.row_trace, g.ways)
                kw = dict(kind=g.kind, num_sets=1, lanes=2 * W, renorm_at=None)
                fn, plain = ops.adaptive_sweep, ref.adaptive_sweep_plain
            hits, state = fn(*args, **kw)
            ms = time_ms(lambda: fn(*args, **kw), reps=10, warmup=2)
            ways = g.ways.cpu().numpy()
            lanes = ways if g.kind == "flat" else 2 * ways
            plane_ints = sum(t.numel() for t in state)
            bound_ms, bound_by = _sweep_bound(tr, len(ways), hits, plane_ints, lanes)
            run = {"grid": label, "kind": g.kind, "rows": len(ways), "steps": T,
                   "lanes": W if g.kind == "flat" else 2 * W, "ms": ms,
                   "ms_per_step": ms / T, "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": None}
            if label == "table1" and g.kind in ("flat", "arc"):
                # one call: the plain version (a loop over the trace) has run
                # in (b) and (c) already
                run["plain_ms"] = time_ms(lambda: plain(*args, **kw), reps=1, warmup=0)
            out[name].append(run)
    return out


def phase_sweep(dev) -> dict:
    """The Table-1 sweep on the card through ``repro_torch.core.sweep`` and
    the batched engine's trace route (one launch per row group runs its
    whole trace: ``flat_sweep`` for the flat rows, ``adaptive_sweep`` per
    adaptive kind); the eager route (``use_kernel=False``) beside it:
    (a) Table 1: six device policies x frame sizes 30..240 on
        ``paper_trace()``, equal to the host oracles' table on both routes
        on the card; 1 flat_sweep and 2 adaptive_sweep launches, no kernel-2
        launch, no host sync;
    (b) a 64-trace grid (``paper_trace(seed=s)``, s < 64) x 6 x 8 = 3072
        rows: trace route == eager route in every hit bit, seeds 0-3 == the
        host oracles, each kernel's hits and final planes == its plain
        version's on the card, bitwise;
    (c) the same at num_sets=2 on 8 seeds, and again with ``_renorm_at=64``
        (stamps renormalize in sets the step does not access);
    (d) the sweep benchmark's trace (``zipf_trace(ZIPF_N)``) x 6 x 8: hit
        counts equal to the host oracles', on both routes;
    (e) its 100k-access size (``zipf_trace(ZIPF_BIG)``) x 6 x 8 on the trace
        route: hit counts equal to the host oracles';
    in (b)-(d) the eager route runs on the CPU, and the host oracles of (d)
    and (e) too, in worker processes (``host_job``) while the card works;
    then kernel 2 on its per-step path (``FlatCore(use_kernel=True)``) over
    the first 200 steps of (a)'s flat rows, equal to the trace kernel's hits
    and planes at step 200; the trace kernels timed alone; and a
    ``torch.profiler`` view of the trace route on (b)."""
    from repro_torch.core import hit_ratio_table, sweep
    from repro_torch.core.policy_core import DEVICE_POLICIES, FlatCore
    from repro_torch.core.traces import paper_trace

    pols, caps = list(DEVICE_POLICIES), TABLE1_CAPS
    res = {"phase": "sweep", "policies": pols, "caps": caps}

    # (a) Table 1 through the user's entry point, both routes
    tr = paper_trace()
    syncs0 = _syncs()
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    table = sweep(pols, tr, caps, torch_device="cuda")
    seconds = time.perf_counter() - t0  # ends in the host pull of the counts
    launches = dict(ops.LAUNCHES)
    syncs = _syncs() - syncs0
    t0 = time.perf_counter()
    host = sweep(pols, tr, caps, device=False)
    host_s = time.perf_counter() - t0
    assert table == host, (table, host)
    _assert_trace_route(launches, syncs)
    t0 = time.perf_counter()  # again, the kernels and torch's ops loaded
    assert sweep(pols, tr, caps, torch_device="cuda") == host
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    eager = sweep(pols, tr, caps, torch_device="cuda", use_kernel=False)
    eager_s = time.perf_counter() - t0
    assert eager == host
    res["table1"] = {"seconds": seconds, "ms_per_step": seconds * 1e3 / len(tr),
                     "seconds_second_call": warm_s,
                     "steps": len(tr), "launches": launches, "host_syncs": syncs,
                     "eager_seconds": eager_s, "host_oracle_seconds": host_s,
                     "equal_to_host_table": True,
                     "hit_ratios": {p: [table[p][c] for c in caps] for p in pols}}
    res["table1_text"] = hit_ratio_table(table, caps).splitlines()

    # kernel 2 on its per-step path: FlatCore(use_kernel=True).on_access over
    # the first 200 steps of (a)'s flat rows == the trace kernel at step 200
    groups, tr_a, W = _groups(tr, pols, caps, 1, dev)
    g = groups[0]
    core = FlatCore(pids=tuple(g.pids.tolist()), ways=tuple(g.ways.tolist()), lanes=W,
                    use_kernel=True)
    state, ids = core.init(device=dev), tr_a[0, :200]
    ops.reset_launches()
    steps_hits = []
    for t in range(200):
        state, h = core.on_access(state, ids[t].expand(core.rows))
        steps_hits.append(h)
    k2_launches = ops.LAUNCHES["awrp_select_rows"]
    assert k2_launches == 200, ops.LAUNCHES
    kh, ks = ops.flat_sweep(tr_a[:, :200].contiguous(), g.row_trace, g.pids, g.ways,
                            num_sets=1, lanes=W)
    assert torch.equal(torch.stack(steps_hits, dim=1), kh)
    assert all(torch.equal(a, b) for a, b in zip(state, ks))
    res["kernel2_path"] = {"rows": core.rows, "steps": 200, "launches": k2_launches,
                           "equal_to_trace_kernel": True}

    # (b) the 64-trace grid: trace route == eager route; seeds 0-3 == host;
    # final planes == the plain versions'
    grid = sweep_traces("paper", 64)
    eager = host_job(_eager_cpu, "paper", 64, 1, None)
    hk, sk, lk, yk = _engine(grid, pols, caps, use_kernel=True)
    _assert_trace_route(lk, yk)
    hi, si = eager.result()
    assert (hk == hi).all(), "trace and eager routes differ on the 64-trace grid"
    t0 = time.perf_counter()
    for n in range(4):
        for pi, p in enumerate(pols):
            for ci, c in enumerate(caps):
                assert (hk[n, pi, ci] == _host_hits(p, grid[n], c)).all(), (n, p, c)
    host_s = time.perf_counter() - t0
    res["grid64"] = {"rows": int(np.prod(hk.shape[:3])), "steps": grid.shape[1],
                     "trace": {"seconds": sk, "ms_per_step": sk * 1e3 / grid.shape[1],
                               "launches": lk, "host_syncs": yk},
                     "eager": {"device": "cpu", "seconds": si,
                               "ms_per_step": si * 1e3 / grid.shape[1]},
                     "trace_equals_eager": True, "host_checked_traces": 4,
                     "host_oracle_seconds_4_traces": host_s,
                     **_planes_equal_plain(grid, pols, caps, dev)}

    # (c) num_sets=2 on 8 seeds, then with renormalization forced
    g8 = grid[:8]
    res["sets2"] = []
    for renorm_at in (None, 64):
        kw = {"num_sets": 2, "_renorm_at": renorm_at}
        hk2, sk2, lk2, yk2 = _engine(g8, pols, caps, use_kernel=True, **kw)
        _assert_trace_route(lk2, yk2)
        hi2, si2 = host_job(_eager_cpu, "paper", 8, 2, renorm_at).result()
        assert (hk2 == hi2).all(), ("trace and eager routes differ at num_sets=2", renorm_at)
        for n in range(8):
            for pi, p in enumerate(pols):
                for ci, c in enumerate(caps):
                    assert (hk2[n, pi, ci] == _host_hits(p, g8[n], c, 2)).all(), (n, p, c)
        res["sets2"].append({
            "renorm_at": renorm_at, "rows": int(np.prod(hk2.shape[:3])), "steps": g8.shape[1],
            "trace": {"seconds": sk2, "launches": lk2},
            "eager": {"device": "cpu", "seconds": si2},
            "trace_equals_eager_equals_host": True,
            **_planes_equal_plain(g8, pols, caps, dev, num_sets=2, renorm_at=renorm_at)})

    # (d) the sweep benchmark's trace at its smoke size: both routes == host
    # (the eager route and the oracles run in worker processes, on the CPU)
    z = zipf_trace(ZIPF_N)
    eager = host_job(_eager_cpu, "zipf", ZIPF_N, 1, None)
    hz, sz, lz, yz = _engine(z, pols, caps)
    _assert_trace_route(lz, yz)
    hze, sze = eager.result()
    counts = hz[0].sum(-1)
    host_counts, host_s = _zipf_host_counts(pols, len(z))
    assert (counts == host_counts).all(), (counts, host_counts)
    assert (hze == hz).all(), "trace and eager routes differ on the 10k zipf trace"
    res["zipf10k"] = {"steps": len(z), "seconds": sz, "ms_per_step": sz * 1e3 / len(z),
                      "launches": lz, "host_syncs": yz, "eager_device": "cpu",
                      "eager_seconds": sze, "host_oracle_seconds": host_s,
                      "counts_equal_to_host": True, "hit_counts": counts.tolist()}

    # (e) the 100k-access size, trace route only
    z = zipf_trace(ZIPF_BIG)
    hz, sz, lz, yz = _engine(z, pols, caps)
    _assert_trace_route(lz, yz)
    counts = hz[0].sum(-1)
    host_counts, host_s = _zipf_host_counts(pols, len(z))
    assert (counts == host_counts).all(), (counts, host_counts)
    res["zipf100k"] = {"steps": len(z), "seconds": sz, "ms_per_step": sz * 1e3 / len(z),
                       "launches": lz, "host_syncs": yz, "host_oracle_seconds": host_s,
                       "counts_equal_to_host": True, "hit_counts": counts.tolist()}

    res["kernels"] = time_trace_kernels(dev, pols, caps)
    res["profile_grid64"] = profile_sweep(grid, pols, caps)
    emit(res)
    res["_grid64_hits"] = hk  # for rows_mesh (a), not printed
    return res


def profile_sweep(traces, pols, caps) -> dict:
    """Where a trace-route sweep's time goes: one engine call on ``traces``
    timed on the host clock between two synchronizes, with CUDA events
    recorded on the stream just before and after it (the device span of the
    call, its idle gaps included), then the same call under
    ``torch.profiler`` (a schedule whose one active cycle is a second call,
    after a warm-up cycle).  Device time is the sum of the profiled kernels'
    intervals (one stream, so they do not overlap); the busy share is that
    over the host wall of the unprofiled call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    _engine(traces, pols, caps)  # warm
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    _, wall_s, launches, syncs = _engine(traces, pols, caps)
    end.record()
    end.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as p:
        for _ in range(2):
            _engine(traces, pols, caps)
            p.step()
    T = traces.shape[1]
    # the schedule's own "ProfilerStep#" annotations also carry the CUDA
    # device type and span each whole cycle: not kernels
    kernels = [e for e in p.events() if e.device_type == DeviceType.CUDA
               and not e.name.startswith("ProfilerStep")]
    out = {"rows": int(traces.shape[0] * len(pols) * len(caps)), "steps": T,
           "wall_ms": wall_s * 1e3, "device_span_ms": start.elapsed_time(end),
           "launches": launches, "host_syncs": syncs}
    if not kernels:
        out["device_ms"] = "not measured"
        return out
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    out.update({"device_ms": busy, "device_ms_per_step": busy / T,
                "device_busy_share": busy / out["wall_ms"], "kernels": len(kernels),
                "top_kernels_ms": [[n[:80], ms] for n, ms in top]})
    return out


# ---- tenancy: the stream mode of the trace kernels ---------------------------

#: the tenancy benchmark's tenants and stream (benchmarks/tenancy_bench.py)
TENANCY_TENANTS = ("hot", "mid", "scan")
TENANCY_N = 6000
TENANCY_BIG = 100_000
TENANCY_POLICIES = ("awrp", "lru", "fifo", "lfu", "arc", "car")


def tenancy_trace(n: int):
    """``trace_multi_tenant(n, 3 tenants, working_set=120, alphas (1.2, 0.8,
    0.0), mix (0.5, 0.3, 0.2), seed=0)``, keys mod INT_MAX: (rows, keys)
    int32."""
    from repro_torch.core.traces import trace_multi_tenant

    rows, addrs = trace_multi_tenant(n, n_tenants=3, working_set=120, alphas=(1.2, 0.8, 0.0),
                                     mix=(0.5, 0.3, 0.2), seed=0)
    return rows.astype(np.int32), (addrs % (2**31 - 1)).astype(np.int32)


def tenancy_drive(case: dict, device) -> dict:
    """One tenancy case through a ``TenantCacheManager`` on ``device`` (on
    the card the stream kernels, on the CPU their plain versions): the
    stream in one ``access_stream`` call, in 8 chunks with the benchmark's
    AWRP-ranked ``rebalance`` between them, or access by access through
    ``access`` (``case["mode"]``).  Returns the hits, every final plane,
    the counters and the quotas as numpy arrays."""
    from repro_torch.serve.tenancy import TenantCacheManager

    rows, keys = tenancy_trace(case["n"])
    mgr = TenantCacheManager(dict(zip(TENANCY_TENANTS, case["quotas"])), case["policy"],
                             device=device)
    if case.get("renorm_at"):
        mgr.core = dataclasses.replace(mgr.core, renorm_at=case["renorm_at"])
    moves = 0
    if case["mode"] == "access":
        hits = np.array([mgr.access(TENANCY_TENANTS[r], int(k))[0]
                         for r, k in zip(rows, keys)])
    elif case["mode"] == "chunks":  # tenancy_bench._rebalanced
        hits = np.zeros(len(keys), dtype=bool)
        bounds = np.linspace(0, len(keys), 9, dtype=int)
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            hits[lo:hi] = mgr.access_stream(rows[lo:hi], keys[lo:hi])
            ranked = mgr.rank_tenants()
            for cand in reversed(ranked):
                if cand != ranked[0] and mgr.pressure(cand) > 0.05:
                    moves += mgr.rebalance(cand, 1)[0]
                    break
    else:
        hits = mgr.access_stream(rows, keys)
    return {"hits": hits, "planes": [t.cpu().numpy() for t in (*mgr.state, *mgr.counters)],
            "quotas": dict(mgr.quotas), "moves": moves}


def tenancy_cases() -> list:
    """The cases ``phase_tenancy`` drives on the card and on the CPU."""
    q16 = (16, 16, 16)
    cases = [dict(label=f"stream_{p}", policy=p, quotas=q16, n=TENANCY_N, mode="stream")
             for p in TENANCY_POLICIES]
    cases += [dict(label="chunks_awrp", policy="awrp", quotas=q16, n=TENANCY_N, mode="chunks")]
    cases += [dict(label=f"wide_{p}", policy=p, quotas=(200, 100, 40), n=TENANCY_N,
                   mode="stream") for p in ("awrp", "lfu")]
    cases += [dict(label=f"renorm_{p}", policy=p, quotas=q16, n=TENANCY_N, mode="stream",
                   renorm_at=64) for p in ("arc", "car")]
    cases += [dict(label=f"{mode}300_{p}", policy=p, quotas=q16, n=300, mode=mode)
              for p in ("awrp", "car") for mode in ("access", "stream")]
    return cases


def _cpu_drive(case: dict) -> dict:
    """``tenancy_drive`` on the CPU in a worker process."""
    torch.set_num_threads(1)
    return tenancy_drive(case, "cpu")


def _tenant_oracles(policy, quotas, rows, keys) -> tuple:
    """(per-tenant (hits, misses, evictions) of the host oracles on the
    demuxed streams, seconds)."""
    from repro_torch.core.policies import make_policy

    t0 = time.perf_counter()
    oracles = [make_policy(policy, q) for q in quotas]
    stats = np.zeros((len(quotas), 3), dtype=np.int64)
    for r, k in zip(rows.tolist(), keys.tolist()):
        o = oracles[r]
        before = o.resident_set()
        hit = o.access(k)
        stats[r] += (hit, not hit, len(before - o.resident_set()))
    return stats, time.perf_counter() - t0


def _assert_rows_match_oracles(planes, stats, label) -> None:
    """The manager's per-row hits / misses / evictions (the first three
    counters, after the state planes) equal the oracles'."""
    got = np.stack(planes[-4:-1], axis=1)
    assert (got == stats).all(), (label, got.tolist(), stats.tolist())


def _stream_bound(rows, keys, hits, planes, lanes, ring_cap=None) -> tuple:
    """(bound_ms, bound_by) of one stream-kernel call: the bytes it must
    move (the (T, 2) records, the hits, every plane and counter in and out,
    each once) at the HBM rate, against its 32-bit operations at the f32
    peak: per access one comparison per live lane of its row (the hit
    search), per miss two more (the victim key and its minimum).  With
    ``ring_cap`` the ring variant's: the new ring's cap + 1 slots written,
    the max(cap - T, 0) + 1 slots of the given ring that no event
    overwrites read, the count read and written; the victim's two
    operations per lane also for a hit whose event survives (t >= T -
    cap)."""
    T = len(keys)
    nbytes = 8 * T + len(hits) + 2 * sum(p.nbytes for p in planes)
    victim = ~hits
    if ring_cap is not None:
        from repro_torch.kernels.sweep import RING_FIELDS

        slot = 4 * RING_FIELDS
        nbytes += (ring_cap + 1) * slot + (max(ring_cap - T, 0) + 1) * slot + 8
        victim = victim | (np.arange(T) >= T - ring_cap)
    acc = np.bincount(rows, minlength=len(lanes))
    miss = np.bincount(rows, weights=victim, minlength=len(lanes))
    n_ops = float((np.asarray(lanes) * (acc + 2 * miss)).sum())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


#: the decision-trace ring of the tenancy phase's ring-variant runs: smaller
#: than the stream, so it wraps
TENANCY_RING = 4096


def ring_prefix_equal(policy: str, quotas, rows, keys, dev, renorm_at=None) -> float:
    """The first 600 accesses of (rows, keys), 100 then 500, through a
    manager with a 256-event ring (``renorm_at`` forced when given): after
    each call the kernel's new ring (``buf[:cap]``, ``count``) == its plain
    version's on the card (``ref.*_stream_plain(ring=...)`` on the same
    inputs), bitwise.  Returns the plain version's seconds."""
    from repro_torch.serve.tenancy import TenantCacheManager

    mgr = TenantCacheManager(dict(zip(TENANCY_TENANTS, quotas)), policy, device=dev,
                             ring_capacity=256)
    if renorm_at is not None:
        mgr.core = dataclasses.replace(mgr.core, renorm_at=renorm_at)
    plain_fn = ref.adaptive_stream_plain if mgr.is_adaptive else ref.flat_stream_plain
    plain_s = 0.0
    for lo, hi in ((0, 100), (100, 600)):
        fn, args, kw = mgr.stream_call(rows[lo:hi], keys[lo:hi])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        *_, want = plain_fn(*args, **kw)
        torch.cuda.synchronize()
        plain_s += time.perf_counter() - t0
        mgr.access_stream(rows[lo:hi], keys[lo:hi])
        got = mgr.ring
        assert got.buf[:256].cpu().numpy().tobytes() == want.buf[:256].cpu().numpy().tobytes(), \
            (policy, quotas, renorm_at, lo)
        assert int(got.count) == int(want.count) == hi, (policy, quotas, renorm_at, lo)
    return plain_s


def tenancy_ring(policy: str, ring_off: dict, rows, keys, dev) -> tuple:
    """The stream kernels' ring variant on the tenancy stream: a manager
    with a ``TENANCY_RING`` ring through ``access_stream`` (one ``*_ring``
    launch, no host sync) == ``ring_off`` (``tenancy_drive``'s ring-off run
    of the same stream on the card) in hits, planes and counters, bitwise;
    the drained events == the stream's tail with the ring-off hits; then
    ``ring_prefix_equal`` at quotas 16/16/16.  Returns (the results, the
    manager's launch from its fresh state as ``stream_call`` gives it, for
    timing)."""
    from repro_torch.obs import decision_trace as dt
    from repro_torch.serve.tenancy import TenantCacheManager

    quotas = dict(zip(TENANCY_TENANTS, (16, 16, 16)))
    mgr = TenantCacheManager(quotas, policy, device=dev, ring_capacity=TENANCY_RING)
    name = ("adaptive_stream" if mgr.is_adaptive else "flat_stream") + "_ring"
    launch = mgr.stream_call(rows, keys)
    ops.reset_launches()
    syncs0 = _syncs()
    hits = mgr.access_stream(rows, keys)
    assert ops.LAUNCHES[name] == 1 and sum(ops.LAUNCHES.values()) == 1, dict(ops.LAUNCHES)
    assert _syncs() == syncs0, policy
    assert np.array_equal(hits, ring_off["hits"]), policy
    for i, (a, b) in enumerate(zip((*mgr.state, *mgr.counters), ring_off["planes"])):
        assert a.cpu().numpy().tobytes() == b.tobytes(), (policy, i)
    rec = mgr.drain_trace()
    cap = TENANCY_RING
    assert len(rec) == cap and int(mgr.ring.count) == len(keys) > cap, policy
    assert (rec["kind"] == dt.KIND_ACCESS).all() and (rec["admit"] == -1).all()
    assert np.array_equal(rec["row"], rows[-cap:]) and np.array_equal(rec["key"], keys[-cap:])
    assert np.array_equal(rec["hit"], ring_off["hits"][-cap:].astype(np.int32)), policy

    plain_s = ring_prefix_equal(policy, (16, 16, 16), rows, keys, dev)
    victims = rec["victim"]
    return {"launches": 1, "host_syncs": 0, "events": int(len(rec)), "stream_len": len(keys),
            "equal_to_ring_off": True, "drained_equal_to_stream_tail": True,
            "prefix_ring_equal_to_plain": True, "prefix_accesses": 600, "prefix_capacity": 256,
            "plain_ms_per_access": plain_s * 1e3 / 600,
            "victims_minus_one": int((victims == -1).sum()), "max_victim": int(victims.max()),
            "hit_ratio_in_window": float(rec["hit"].mean())}, launch


def phase_tenancy(dev) -> dict:
    """The trace kernels' stream mode (the tenancy manager's
    ``access_stream`` and ``access``) on the card against its plain version
    (the same manager on the CPU, run in worker processes meanwhile): hit
    bits, every final plane and counter equal, pressure bitwise, for
    (a) each of the six policies on the tenancy benchmark's stream
        (``tenancy_trace(6000)``, quotas 16/16/16);
    (b) the same stream in 8 chunks with the benchmark's AWRP-ranked
        ``rebalance`` between them (awrp), the state carried across calls;
    (c) quotas (200, 100, 40): flat rows of 340 lanes, above the register
        path (awrp, lfu);
    (d) arc and car with a forced ``renorm_at=64``;
    (e) ``access`` against ``access_stream`` on the first 300 accesses (awrp,
        car);
    and per-tenant hits / misses / evictions equal to the host oracles on the
    demuxed streams in (a), (c) and (f) 100 000 accesses of the same
    generator in one call (awrp, arc, car).  One launch per call, no host
    sync in the call (``policy_core.HOST_SYNCS``); seconds per call at 6000
    and 100 000, the eager plain route on the card at 6000 (awrp), the host
    oracles, the kernels timed alone as the manager launches them
    (``stream_call``) and their bound.  Then the ring variant for each
    policy (``tenancy_ring``), timed beside the ring-off launch."""
    from repro_torch.serve.tenancy import TenantCacheManager

    t_phase = time.perf_counter()
    q16 = (16, 16, 16)
    cases = tenancy_cases()
    res = {"phase": "tenancy", "tenants": list(TENANCY_TENANTS), "stream_len": TENANCY_N,
           "cases": {}}
    plain = {c["label"]: host_job(_cpu_drive, c) for c in cases}
    card = {}
    for c in cases:
        syncs0 = _syncs()
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card[c["label"]] = tenancy_drive(c, dev)
        seconds = time.perf_counter() - t0
        launches = ops.LAUNCHES["flat_stream"] + ops.LAUNCHES["adaptive_stream"]
        calls = {"stream": 1, "chunks": 8, "access": c["n"]}[c["mode"]]
        assert launches == calls, (c["label"], dict(ops.LAUNCHES))
        assert _syncs() == syncs0, c["label"]
        res["cases"][c["label"]] = {"policy": c["policy"], "quotas": list(c["quotas"]),
                                    "accesses": c["n"], "mode": c["mode"],
                                    "seconds": seconds, "launches": launches,
                                    "host_syncs": _syncs() - syncs0}
    t_wait = time.perf_counter()
    plain = {k: f.result() for k, f in plain.items()}
    res["plain_wait_s"] = time.perf_counter() - t_wait
    for c in cases:
        label = c["label"]
        got = card[label]
        wants = [plain[label]]
        if c["mode"] == "access":  # access() == access_stream on the card and on the CPU
            twin = f"stream300_{c['policy']}"
            wants += [card[twin], plain[twin]]
        for want in wants:
            assert np.array_equal(got["hits"], want["hits"]), label
            for i, (a, b) in enumerate(zip(got["planes"], want["planes"])):
                assert a.tobytes() == b.tobytes(), (label, i)
            assert got["quotas"] == want["quotas"], label
        res["cases"][label].update(equal_to_plain=True, quotas_after=got["quotas"],
                                   rebalance_moves=got["moves"],
                                   pressure=got["planes"][-1].tolist())
    rows, keys = tenancy_trace(TENANCY_N)
    for c in cases:
        if c["mode"] == "stream" and c["n"] == TENANCY_N:
            stats, host_s = _tenant_oracles(c["policy"], c["quotas"], rows, keys)
            _assert_rows_match_oracles(card[c["label"]]["planes"], stats, c["label"])
            res["cases"][c["label"]].update(host_oracle_seconds=host_s,
                                            counts_equal_to_host=True)

    # (f) 100k accesses in one call, against the host oracles
    big_rows, big_keys = tenancy_trace(TENANCY_BIG)
    res["stream_100k"] = {}
    for p in ("awrp", "arc", "car"):
        mgr = TenantCacheManager(dict(zip(TENANCY_TENANTS, q16)), p, device=dev)
        ops.reset_launches()
        syncs0 = _syncs()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.access_stream(big_rows, big_keys)
        seconds = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        assert launches["flat_stream"] + launches["adaptive_stream"] == 1, launches
        stats, host_s = _tenant_oracles(p, q16, big_rows, big_keys)
        planes = [t.cpu().numpy() for t in (*mgr.state, *mgr.counters)]
        _assert_rows_match_oracles(planes, stats, f"100k_{p}")
        res["stream_100k"][p] = {"seconds": seconds, "us_per_access": seconds * 1e6 / TENANCY_BIG,
                                 "host_syncs": _syncs() - syncs0, "host_oracle_seconds": host_s,
                                 "counts_equal_to_host": True}

    # the kernels alone (CUDA events) at 6000, as the manager launches them
    # (stream_call), beside the eager plain route on the card (awrp) and the
    # bound; the ring variant likewise, into a 4096-event ring
    res["kernels"] = {"flat_stream": [], "adaptive_stream": []}
    res["ring"] = {}
    for p in TENANCY_POLICIES:
        mgr = TenantCacheManager(dict(zip(TENANCY_TENANTS, q16)), p, device=dev)
        core = mgr.core
        name = "adaptive_stream" if mgr.is_adaptive else "flat_stream"
        lanes = [2 * c for c in core.caps] if mgr.is_adaptive else list(core.ways)
        fn, args, kw = mgr.stream_call(rows, keys)
        hits, state, ctr = fn(*args, **kw)
        ms = time_ms(lambda: fn(*args, **kw), reps=10, warmup=2)
        planes = [t.cpu().numpy() for t in (*state, *ctr)]
        bound_ms, bound_by = _stream_bound(rows, keys, hits.cpu().numpy(), planes, lanes)
        ring, (fn_r, args_r, kw_r) = tenancy_ring(p, card[f"stream_{p}"], rows, keys, dev)
        hits_r = fn_r(*args_r, **kw_r)[0]
        ring_ms = time_ms(lambda: fn_r(*args_r, **kw_r), reps=10, warmup=2)
        ring_bound_ms, ring_bound_by = _stream_bound(rows, keys, hits_r.cpu().numpy(), planes,
                                                     lanes, ring_cap=TENANCY_RING)
        ring.update(ring_ms=ring_ms, ring_off_ms=ms, ring_bound_ms=ring_bound_ms,
                    ring_bound_by=ring_bound_by)
        res["ring"][p] = ring
        # the call again on a fresh manager (the case above was this kind's
        # first launch in the process)
        warm = TenantCacheManager(dict(zip(TENANCY_TENANTS, q16)), p, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        warm.access_stream(rows, keys)
        warm_s = time.perf_counter() - t0
        run = {"policy": p, "rows": 3, "accesses": TENANCY_N, "lanes": max(lanes),
               "plane_lanes": mgr.state.blocks.shape[-1], "ms": ms,
               "us_per_access": ms * 1e3 / TENANCY_N, "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": None, "ring_ms": ring_ms,
               "ring_bound_ms": ring_bound_ms, "ring_bound_by": ring_bound_by,
               "seconds_per_access_stream_call": res["cases"][f"stream_{p}"]["seconds"],
               "seconds_per_access_stream_call_again": warm_s}
        if p == "awrp":
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref.flat_stream_plain(*args, **kw)
            torch.cuda.synchronize()
            run["plain_ms"] = (time.perf_counter() - t0) * 1e3
        run["ring_plain_ms_per_access"] = ring["plain_ms_per_access"]
        res["kernels"][name].append(run)

    # the ring variant == its plain version also with forced renormalization
    # (arc, car) and at quotas (200, 100, 40), flat rows of 340 lanes in
    # shared memory (awrp, lfu)
    res["ring_prefix"] = {}
    for label, p, quotas, renorm_at in (("renorm_arc", "arc", q16, 64),
                                        ("renorm_car", "car", q16, 64),
                                        ("wide_awrp", "awrp", (200, 100, 40), None),
                                        ("wide_lfu", "lfu", (200, 100, 40), None)):
        plain_s = ring_prefix_equal(p, quotas, rows, keys, dev, renorm_at=renorm_at)
        res["ring_prefix"][label] = {"policy": p, "quotas": list(quotas), "renorm_at": renorm_at,
                                     "accesses": 600, "capacity": 256,
                                     "equal_to_plain": True,
                                     "plain_ms_per_access": plain_s * 1e3 / 600}

    # one access per call, as the serving path's prefix core makes it: ms per
    # call ring-off and with rings of 256 (serve_tenants') and 65 536 events
    res["ring_one_access"] = {}
    for p in ("awrp", "arc"):
        per = {}
        for cap in (0, TRACE_RING, 65536):
            mgr = TenantCacheManager(dict(zip(TENANCY_TENANTS, q16)), p, device=dev,
                                     ring_capacity=cap)
            fn, args, kw = mgr.stream_call(rows[:1], keys[:1])
            per[f"ring_{cap}_ms" if cap else "ring_off_ms"] = time_ms(
                lambda: fn(*args, **kw), reps=20, warmup=3)
        res["ring_one_access"][p] = per
    res["seconds"] = time.perf_counter() - t_phase
    emit(res)
    return res


def _tenancy_snapshot(engine) -> dict:
    """Every piece of tenancy and cache state a shed request must leave as
    it was: the manager's planes and counters, the stores, the KV sessions,
    the stats."""
    mgr = engine.tenant_cache.manager
    return {"planes": [t.clone() for t in (*mgr.state, *mgr.counters)],
            "quotas": dict(mgr.quotas), "tf": mgr._tf.copy(), "tr": mgr._tr.copy(),
            "stores": {t: dict(s) for t, s in engine.tenant_cache.stores.items()},
            "sessions": {t: {n: [x.clone() for x in s] for n, s in d.items()}
                         for t, d in engine._kv_sessions.items()},
            "stats": {k: v for k, v in engine.stats.items() if k != "shed"}}


def _assert_shed_touched_nothing(before: dict, engine, tenant: str) -> None:
    """A shed request changed nothing but one probation decay of its
    tenant's pressure (one float32 multiply by 1 - a)."""
    mgr = engine.tenant_cache.manager
    after = _tenancy_snapshot(engine)
    r = mgr.row(tenant)
    *same, p_before = before["planes"]
    *same_after, p_after = after["planes"]
    for a, b in zip(same, same_after):
        assert torch.equal(a, b), "a shed request changed a plane or counter"
    one_a = torch.ones((), device=p_before.device) - torch.tensor(
        mgr.pressure_alpha, dtype=torch.float32, device=p_before.device)
    want = p_before.clone()
    want[r] = p_before[r] * one_a
    assert torch.equal(p_after.view(torch.int32), want.view(torch.int32))
    assert before["quotas"] == after["quotas"] and before["stats"] == after["stats"]
    assert (before["tf"] == after["tf"]).all() and (before["tr"] == after["tr"]).all()
    assert before["stores"].keys() == after["stores"].keys()
    for t in before["stores"]:
        assert before["stores"][t].keys() == after["stores"][t].keys()
        assert all(before["stores"][t][k] is after["stores"][t][k] for k in before["stores"][t])
    assert before["sessions"].keys() == after["sessions"].keys()
    for t, d in before["sessions"].items():
        for n, s in d.items():
            assert all(torch.equal(a, b) for a, b in zip(s, after["sessions"][t][n]))


def _decide_batch_equals_host_loop(mgr, adm) -> list:
    """``decide_batch`` on a copy of ``mgr`` == the host loop of ``decide`` +
    ``decay_pressure`` on another copy: decisions and pressure bits."""
    import copy

    from repro_torch.serve.tenancy import SHED

    batch = ["hog", "calm", "hog", "busy", "hog", "hog", "calm"]
    host, dev = copy.deepcopy(mgr), copy.deepcopy(mgr)
    want = []
    for t in batch:
        d = adm.decide(host, t)
        if d == SHED:
            host.decay_pressure(t)
        want.append(d)
    got = adm.decide_batch(dev, batch)
    assert got == want, (got, want)
    assert torch.equal(host.counters.pressure.view(torch.int32),
                       dev.counters.pressure.view(torch.int32))
    assert host._pressure.tobytes() == dev._pressure.tobytes()
    return got


def live_endpoint(eng, make_plain, prompts, new_tokens: int) -> dict:
    """``MetricsServer(eng.telemetry)`` on a free port while ``eng`` builds a
    new decode graph (a batch of ``len(prompts)``, calm's) and replays it: a
    client thread GETs ``/metrics`` in a loop the whole time.  Every poll
    answers 200 with the loop planes in it and none raises (the engine's lock
    keeps snapshots out of the capture and out of the graph loop's sync
    debug mode); the capture is whole (one more graph; the batch's tokens ==
    a fresh single-tenant engine's); after the loop ``/metrics.json`` ==
    ``telemetry()`` taken without the server."""
    import threading
    import urllib.request

    from repro_torch.obs.server import MetricsServer
    from repro_torch.serve.engine import Request

    reqs = [Request(900 + i, list(p), max_new_tokens=new_tokens, tenant_id="calm")
            for i, p in enumerate(prompts)]
    captures = eng.stats["loop_captures"]
    polls, errors, stop = [], [], threading.Event()
    with MetricsServer(eng.telemetry, port=0) as srv:
        url = f"http://127.0.0.1:{srv.port}"

        def client():
            while not stop.is_set():
                try:
                    with urllib.request.urlopen(url + "/metrics", timeout=120) as r:
                        body = r.read()
                        polls.append((r.status, time.perf_counter()))
                    if b"awrp_serve_loop_steps" not in body:
                        errors.append("a scrape without the loop planes")
                except Exception as e:  # noqa: BLE001 — every failure is gated below
                    errors.append(repr(e))

        thread = threading.Thread(target=client, name="metrics-client", daemon=True)
        thread.start()
        while len(polls) < 2 and not errors and thread.is_alive():
            time.sleep(0.001)
        t0 = time.perf_counter()
        out = eng.generate(reqs)
        t1 = time.perf_counter()
        stop.set()
        thread.join(timeout=120)
        assert not thread.is_alive(), "the metrics client did not stop"
        gc.collect()  # no engine's sentinel may drop out between the two snapshots
        gc.disable()
        try:
            with urllib.request.urlopen(url + "/metrics.json", timeout=120) as r:
                via_server = json.loads(r.read())
            direct = eng.telemetry()
        finally:
            gc.enable()
    assert not errors, errors[:3]
    during = sum(1 for _, t in polls if t0 <= t <= t1)
    assert polls and {c for c, _ in polls} == {200} and during >= 1, (len(polls), during)
    assert all(r.status == "ok" for r in out.values())
    assert eng.stats["loop_captures"] == captures + 1, eng.stats
    plain = make_plain()
    want = plain.generate([Request(r.rid, list(r.prompt), max_new_tokens=new_tokens)
                           for r in reqs])
    assert [out[r.rid].tokens for r in reqs] == [want[r.rid].tokens for r in reqs]
    del plain
    assert via_server.keys() == direct.keys()
    for k, v in direct.items():
        assert via_server[k] == (v.tolist() if isinstance(v, np.ndarray) else v), k
    return {"polls": len(polls), "polls_during_generate": during,
            "generate_s": t1 - t0, "errors": 0, "new_graph_captured": True,
            "tokens_equal_to_plain_engine": True, "json_snapshot_equals_direct": True,
            "keys": len(direct)}


#: the serve_tenants engines' decision-trace ring: more than the phase's
#: events, so none is overwritten and all are held to the CPU replay's
TRACE_RING = 256


def _drain_syncs(eng) -> tuple:
    """``eng.drain_decision_trace()`` under ``torch.profiler`` inside a
    ``record_function``: (the records, the synchronizing CUDA runtime calls
    made in that range)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("trace_drain"):
            rec = eng.drain_decision_trace()
        torch.cuda.synchronize()
    return rec, [e.name for e in _host_events_in(prof.events(), "trace_drain")
                 if e.name in SYNC_CALLS]


def decision_trace_checks(eng, replay, decided) -> dict:
    """The engine's decision trace against the CPU replay ``replay`` of the
    same accesses, decays and rebalances (a manager with a ring): the
    drained access events == the replay's, bitwise, nothing overwritten;
    the admission events' codes == ``decided``; one synchronizing call per
    drain; ``opt_regret()``'s gauges in ``telemetry()`` ==
    ``regret_from_records`` on the replay's records, ``span/trace_drain``
    counted."""
    from repro_torch.obs import decision_trace as dt
    from repro_torch.obs.opt_oracle import regret_from_records

    mgr = eng.tenant_cache.manager
    rec, syncs = _drain_syncs(eng)
    assert len(syncs) == 1, syncs
    assert len(rec) == int(mgr.ring.count) < dt.ring_capacity(mgr.ring), len(rec)
    acc = rec[rec["kind"] == dt.KIND_ACCESS]
    want = replay.drain_trace()
    assert acc.tobytes() == want.tobytes(), "card's access events != the CPU replay's"
    codes = rec[rec["kind"] == dt.KIND_ADMIT]["admit"].tolist()
    assert codes == [("accept", "defer", "shed").index(d) for d in decided], (codes, decided)
    regret = eng.opt_regret()
    per_row, agg = regret_from_records(want, {replay.row(t): replay.quotas[t]
                                              for t in replay.tenants})
    tel = eng.telemetry()
    for t in replay.tenants:
        assert tel[f"tenant/{t}/opt_regret"] == per_row[replay.row(t)]["regret"] == \
            regret[t]["regret"], t
    assert tel[f"policy/{mgr.policy_name}/opt_regret"] == agg["regret"]
    assert tel["span/trace_drain/calls"] >= 1
    return {"events": len(rec), "access_events": len(acc), "admit_events": len(codes),
            "equal_to_cpu_replay": True, "admit_codes_equal_to_decisions": True,
            "sync_calls_per_drain": len(syncs), "sync_call": syncs[0],
            "trace_drain_calls": tel["span/trace_drain/calls"],
            "trace_drain_p50_s": tel["span/trace_drain/p50_s"],
            "victims": acc["victim"].tolist(), "opt_regret": regret}


def replay_events(mgr, events):
    """``mgr`` (a CPU tenancy manager) driven by a served run's prefix-core
    events in order: ("access", tenant, key), ("decay", tenant) for a shed
    request, ("rebalance", tenant) for a one-page move to it."""
    for ev in events:
        if ev[0] == "access":
            mgr.access(ev[1], ev[2])
        elif ev[0] == "decay":
            mgr.decay_pressure(ev[1])
        else:
            mgr.rebalance(ev[1], 1)
    return mgr


def traced_reserve(engine, quotas, prefix_policy, log, events, stream_kernel, ring_off) -> dict:
    """A served run's requests again, in order, on a fresh engine that
    traces decisions (``decision_trace=TRACE_RING``: every prefix-core
    access launches the stream kernels' ring variant): each request's
    status, tokens and rebalance count == the ring-off run's (``log``), the
    final planes and counters == the ring-off manager ``ring_off``'s,
    bitwise, one ``*_ring`` launch per prefix access and none ring-off; then
    ``decision_trace_checks`` against a CPU replay of ``events`` that
    carries a ring."""
    from repro_torch.serve.engine import Request
    from repro_torch.serve.tenancy import AdmissionController, TenantCacheManager

    adm = AdmissionController(defer_at=0.3, shed_at=0.5, warmup=4)
    eng = engine(tenants=quotas, admission=adm, auto_rebalance=True, decision_trace=TRACE_RING)
    mgr = eng.tenant_cache.manager
    # the decisions decide_batch returned for this engine's manager (the
    # admission events' codes are held to them)
    decided = []

    def logged(m, tenants, decide=adm.decide_batch):
        out = decide(m, tenants)
        if m is mgr:
            decided.extend(out)
        return out

    adm.decide_batch = logged
    ops.reset_launches()
    for e in log:
        out = eng.generate([Request(e["rid"], list(e["prompt"]), max_new_tokens=e["new"],
                                    tenant_id=e["tenant"])])[e["rid"]]
        assert (out.status, out.tokens, eng.stats["rebalances"]) == \
            (e["status"], e["tokens"], e["rebalances"]), e["rid"]
    launches = dict(ops.LAUNCHES)
    n_access = sum(ev[0] == "access" for ev in events)
    assert launches[stream_kernel + "_ring"] == n_access and launches[stream_kernel] == 0, \
        launches
    for x, y in zip((*mgr.state, *mgr.counters), (*ring_off.state, *ring_off.counters)):
        assert x.cpu().numpy().tobytes() == y.cpu().numpy().tobytes(), "ring on != ring off"
    assert mgr.quotas == ring_off.quotas
    replay = replay_events(TenantCacheManager(quotas, prefix_policy, device="cpu",
                                              ring_capacity=TRACE_RING), events)
    checks = decision_trace_checks(eng, replay, decided)
    return {**checks, "requests": len(log), "launches": launches,
            "equal_to_ring_off": True}


def phase_serve_tenants(dev, params, base_cfg=CONFIG, prompt_len=1024, new_tokens=16,
                        pages=16, rounds=(6, 5)) -> dict:
    """Multi-tenant serving of smollm-360m at published widths, bf16, paged
    KV in a 16-page pool through the fused kernels: tenants {calm: 2, busy:
    2, hog: 1} behind ``AdmissionController(defer_at=0.3, shed_at=0.5,
    warmup=4)`` (default alpha 0.1) with ``auto_rebalance``; single requests,
    one ``generate`` each, of 1024 seeded tokens (the pool's size, so the
    first decode token evicts a page) and 16 greedy new tokens, in rounds of
    calm (two prompts, each three rounds running: prefix hits), busy (three
    prompts, each two rounds running, through quota 2) and two hog requests
    (distinct prompts, so its pressure climbs until it defers and then
    sheds); ``rounds`` per run.  Two runs: AWRP pages (kernel 4) with the awrp
    prefix policy (flat stream kernel, rebalances), and ``arc_adaptive``
    pages (kernel 5) with the arc prefix policy (ARC/CAR stream kernel, fixed
    quotas), whose first requests are A's (calm's) first turn, B's (busy's)
    first request and A's follow-up turn.  Checks: the hog goes ok ->
    deferred -> shed and the others stay ok; every shed request leaves every
    plane, counter, store and session as it was (but its tenant's one
    decay); the per-tenant counters equal the host oracles on the demuxed
    prompt-key streams of the admitted requests (tenants whose quota a
    rebalance changed: a CPU replay of the same accesses, decays and
    rebalances, bitwise); ``decide_batch`` == the host loop on copies of the
    manager at the first shed; A's ghost hits, ``p`` and session planes ==
    a single-tenant engine's running A's two turns alone (A's first turn
    decodes ``page_size + 8`` tokens, so its pool leaves a ghost); each
    deferred-then-completed request's tokens == an unpressured engine's
    (AWRP run); the stream kernel launched once per prefix-cache access.
    The host oracles are checked after every request up to the first
    rebalance, and at the end for every tenant whose quota never moved."""
    import copy

    from repro_torch.core.policies import make_policy
    from repro_torch.obs.metrics import safe_ratio
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.tenancy import AdmissionController, TenantCacheManager, _prompt_key

    t_phase = time.perf_counter()
    quotas = {"calm": 2, "busy": 2, "hog": 1}
    rng = np.random.RandomState(SEED + 31)

    def new_prompt():
        return rng.randint(1, base_cfg.vocab, size=prompt_len).tolist()

    calm, busy = [new_prompt() for _ in range(2)], [new_prompt() for _ in range(3)]
    # A's first turn decodes past two page boundaries: the first eviction
    # discards T1's LRU outright, the second leaves a ghost for the
    # follow-up's re-prefill to hit
    a_new = base_cfg.page_size + 8
    res = {"phase": "serve_tenants", "model": base_cfg.name, "layers": base_cfg.n_layers,
           "d_model": base_cfg.d_model, "dtype": base_cfg.dtype, "kv_mode": "paged",
           "reduced": {"bounded_kv_pages": [base_cfg.bounded_kv_pages, pages]},
           "tenants": quotas, "prompt_len": prompt_len, "new_tokens": new_tokens,
           "admission": {"defer_at": 0.3, "shed_at": 0.5, "warmup": 4, "alpha": 0.1},
           "runs": []}
    for kv_policy, prefix_policy, stream_kernel, n_rounds in (
            ("awrp", "awrp", "flat_stream", rounds[0]),
            ("arc_adaptive", "arc", "adaptive_stream", rounds[1])):
        cfg = dataclasses.replace(base_cfg, bounded_kv_pages=pages, kv_policy=kv_policy)
        adm = AdmissionController(defer_at=0.3, shed_at=0.5, warmup=4)

        def engine(**kw):
            return ServeEngine(cfg, params, max_len=prompt_len + a_new + new_tokens,
                               kv_mode="paged",
                               fused=True, seed=SEED, prefix_policy=prefix_policy,
                               device=dev, **kw)

        eng = engine(tenants=quotas, admission=adm, auto_rebalance=True)
        mgr = eng.tenant_cache.manager
        events, log, rid = [], [], 0
        first_shed = None

        def send(tenant, prompt, new=new_tokens):
            nonlocal rid, first_shed
            rid += 1
            before = _tenancy_snapshot(eng)
            pre = copy.deepcopy(mgr) if first_shed is None else None
            reb = eng.stats["rebalances"]
            out = eng.generate([Request(rid, list(prompt), max_new_tokens=new,
                                        tenant_id=tenant)])[rid]
            if out.status == "shed":
                assert out.tokens == []
                _assert_shed_touched_nothing(before, eng, tenant)
                events.append(("decay", tenant))
                if first_shed is None:
                    first_shed = _decide_batch_equals_host_loop(pre, adm)
            else:
                assert len(out.tokens) == new
                events.append(("access", tenant, _prompt_key(eng._align(list(prompt)))))
                if eng.stats["rebalances"] > reb:
                    events.append(("rebalance", tenant))
            rows = mgr.row_telemetry()
            log.append({"rid": rid, "tenant": tenant, "status": out.status, "new": new,
                        "rebalances": eng.stats["rebalances"],
                        "prefill_cached": out.prefill_cached, "latency_s": out.latency_s,
                        "pressure_after": mgr.pressure(tenant), "prompt": prompt,
                        "tokens": out.tokens, "n_events": len(events),
                        "counts": np.stack([rows[k] for k in ("hits", "misses", "evictions")],
                                           axis=1)})
            return out

        ops.reset_launches()
        run = {"kv_policy": kv_policy, "prefix_policy": prefix_policy}
        if kv_policy == "arc_adaptive":
            # A's follow-up turn interleaved with B's first request; held below
            # to a single-tenant engine running A's two turns alone
            prompt_a = new_prompt()
            a1 = send("calm", prompt_a, a_new)
            send("busy", new_prompt())
            send("calm", prompt_a + a1.tokens)
            tel = eng.telemetry()
            follow = {"tokens": [a1.tokens, log[-1]["tokens"]],
                      "tel": {k: tel[f"kv/calm/{k}"] for k in ("ghost_hits", "p_max", "p_mean")},
                      "session": {n: [x.clone() for x in s]
                                  for n, s in eng._kv_sessions["calm"].items()}}
            assert follow["tel"]["ghost_hits"] > 0, tel
        for i in range(n_rounds):
            send("calm", calm[i // 3 % 2])
            send("busy", busy[i // 2 % 3])
            send("hog", new_prompt())
            send("hog", new_prompt())
        launches = dict(ops.LAUNCHES)
        stats = dict(eng.stats)

        statuses = {t: [e["status"] for e in log if e["tenant"] == t] for t in quotas}
        hog = statuses["hog"]
        assert all(s == "ok" for t in ("calm", "busy") for s in statuses[t]), statuses
        assert "deferred" in hog and "shed" in hog, hog
        assert hog.index("ok") < hog.index("deferred") < hog.index("shed"), hog
        assert first_shed is not None and stats["nonfinite_logits"] == 0

        # per-tenant counters: host oracles where the quota never changed, a
        # CPU replay of the whole event stream for every tenant
        replay = replay_events(TenantCacheManager(quotas, prefix_policy, device="cpu"), events)
        demux = {t: [ev[2] for ev in events if ev[0] == "access" and ev[1] == t]
                 for t in quotas}
        for x, y in zip((*mgr.state, *mgr.counters), (*replay.state, *replay.counters)):
            assert x.cpu().numpy().tobytes() == y.numpy().tobytes(), "card != CPU replay"
        assert mgr.quotas == replay.quotas
        # host oracles: after every request up to the first rebalance; at the
        # end for the tenants whose quota never moved
        oracles = {t: make_policy(prefix_policy, q) for t, q in quotas.items()}
        counts = np.zeros((len(quotas), 3), dtype=np.int64)
        checked_requests, done = 0, 0
        first_reb = next((i for i, ev in enumerate(events) if ev[0] == "rebalance"),
                         len(events))
        for entry in log:
            for ev in events[done:entry["n_events"]]:
                if ev[0] == "access":
                    o = oracles[ev[1]]
                    before = o.resident_set()
                    hit = o.access(ev[2])
                    counts[mgr.row(ev[1])] += (hit, not hit, len(before - o.resident_set()))
            done = entry["n_events"]
            if done > first_reb:
                break
            assert (entry["counts"] == counts).all(), (entry["rid"], counts.tolist())
            checked_requests += 1
        tel = eng.telemetry()
        oracle_checked = []
        for t, q in quotas.items():
            if mgr.quotas[t] != q or any(ev == ("rebalance", t) for ev in events):
                continue
            o = make_policy(prefix_policy, q)
            h = e = 0
            for k in demux[t]:
                before = o.resident_set()
                h += o.access(k)
                e += len(before - o.resident_set())
            assert (tel[f"tenant/{t}/hits"], tel[f"tenant/{t}/misses"],
                    tel[f"tenant/{t}/evictions"], tel[f"tenant/{t}/accesses"]) == \
                (h, len(demux[t]) - h, e, len(demux[t])), t
            oracle_checked.append(t)
        # the one-pull snapshot's tenant rows == the CPU replay (== the card's
        # planes, bitwise, above) for every tenant, hit_ratio exact
        replayed = replay.row_telemetry()
        for t in quotas:
            r = replay.row(t)
            for k in ("hits", "misses", "evictions", "accesses"):
                assert tel[f"tenant/{t}/{k}"] == int(replayed[k][r]), (t, k)
            assert tel[f"tenant/{t}/hit_ratio"] == safe_ratio(
                tel[f"tenant/{t}/hits"], tel[f"tenant/{t}/accesses"])
        run["snapshot"] = one_pull(eng)
        if prefix_policy == "arc":
            assert oracle_checked == list(quotas), oracle_checked
        assert checked_requests > 0

        # launches: the stream kernel once per prefix-cache access, the
        # decode kernel twice per layer per decode step, kernel 6 once per
        # layer per prefill
        steps = stats["decode_steps"]
        decode_kernel = ("policy_paged_attention" if kv_policy == "awrp"
                         else "adaptive_policy_paged_attention")
        assert launches[stream_kernel] == len(demux["calm"] + demux["busy"] + demux["hog"]), \
            launches
        assert launches[stream_kernel + "_ring"] == 0, launches
        assert launches[decode_kernel] == ops.SPLIT_LAUNCHES * cfg.n_layers * steps, launches
        assert launches["flash_attention"] == cfg.n_layers * stats["prefills"], launches
        run["decision_trace"] = traced_reserve(engine, quotas, prefix_policy, log, events,
                                               stream_kernel, mgr)

        if kv_policy == "awrp":  # deferred-then-completed == an unpressured engine
            plain = engine()
            deferred = [e for e in log if e["status"] == "deferred"]
            for e in deferred:
                o = plain.generate([Request(e["rid"], list(e["prompt"]),
                                            max_new_tokens=new_tokens)])[e["rid"]]
                assert o.tokens == e["tokens"], e["rid"]
            run["deferred_equal_to_unpressured"] = len(deferred)
            del plain
            live_rng = np.random.RandomState(SEED + 41)
            run["live_endpoint"] = live_endpoint(
                eng, engine, [live_rng.randint(1, base_cfg.vocab, size=prompt_len).tolist()
                              for _ in range(2)], new_tokens)
        else:  # A's two turns alone
            solo = engine()
            s1 = solo.generate([Request(0, list(prompt_a), max_new_tokens=a_new)])[0]
            s2 = solo.generate([Request(1, prompt_a + s1.tokens, max_new_tokens=new_tokens)])[1]
            assert [s1.tokens, s2.tokens] == follow["tokens"]
            alone = solo.telemetry()
            assert follow["tel"] == {k: alone[f"kv/default/{k}"] for k in follow["tel"]}
            for n, x in follow["session"].items():
                assert all(torch.equal(u, v) for u, v in zip(x, solo._kv_sessions["default"][n]))
            run["follow_up"] = {**follow["tel"], "equal_to_single_tenant_engine": True}
            del solo
        for e in log:
            del e["prompt"], e["tokens"], e["counts"], e["new"]
        lat = [e["latency_s"] for e in log if e["status"] != "shed"]
        run.update({"statuses": statuses, "requests": len(log), "stats": stats,
                    "quotas_after": dict(mgr.quotas), "launches": launches,
                    "oracle_checked_tenants": oracle_checked, "cpu_replay_equal": True,
                    "oracle_checked_requests_before_first_rebalance": checked_requests,
                    "decide_batch_at_first_shed": first_shed,
                    "tenants": {t: {k: tel[f"tenant/{t}/{k}"] for k in
                                    ("quota", "hits", "misses", "evictions", "pressure",
                                     "hit_ratio")} for t in quotas},
                    "latency_s": {"median": statistics.median(lat), "max": max(lat),
                                  "per_request": [[e["tenant"], e["status"], e["latency_s"]]
                                                  for e in log]},
                    "decode_tokens_per_s": stats["decode_steps"] / stats["decode_s"],
                    "prefill_s": stats["prefill_s"]})
        res["runs"].append(run)
        del eng
    res["seconds"] = time.perf_counter() - t_phase
    emit(res)
    return res


#: benchmarks/expert_cache_bench.py's CASES: (name, experts, capacity,
#: expert MB, zipf a, phases)
EXPERT_CASES = [
    ("grok1_8e_cache6", 8, 6, 805, 1.2, 1),
    ("phi35_16e_cache8", 16, 8, 105, 1.3, 2),
    ("fine_grained_64e_cache16", 64, 16, 25, 1.1, 3),
]
EXPERT_POLICIES = ("awrp", "lru", "fifo", "lfu", "arc", "car")


def expert_trace(E, alpha, phases, n=20_000, seed=0):
    """benchmarks/expert_cache_bench.py's ``_trace``: a Zipf router stream
    whose hot set drifts by E/4 experts per phase."""
    rng = np.random.RandomState(seed)
    per = n // phases
    parts = []
    for ph in range(phases):
        t = rng.zipf(alpha, size=per) % E
        parts.append((t + ph * max(E // 4, 1)) % E)
    return np.concatenate(parts)


def _time_expert_stream(policy: str, n_layers: int, cap: int, rows: np.ndarray,
                        keys: np.ndarray, dev) -> dict:
    """The stream launch of an expert cache's device path alone (CUDA
    events), as the runtime makes it (``ExpertCacheRuntime.stream_call``)
    from a fresh core of ``n_layers`` rows of ``cap`` ways over ``keys`` on
    core rows ``rows``, beside its bound (``_stream_bound``)."""
    from repro_torch.cache.expert_cache import ExpertCacheRuntime

    rt = ExpertCacheRuntime(n_layers, cap, policy, device=dev)
    fn, args, kw = rt.stream_call(rows, keys)
    hits, state, ctr = fn(*args, **kw)
    ms = time_ms(lambda: fn(*args, **kw), reps=10, warmup=2)
    lanes = ([2 * c for c in rt.core.caps] if policy in ("arc", "car")
             else list(rt.core.ways))
    planes = [t.cpu().numpy() for t in (*state, *ctr)]
    bound_ms, bound_by = _stream_bound(rows, keys, hits.cpu().numpy(), planes, lanes)
    return {"policy": policy, "rows": n_layers, "accesses": len(keys), "lanes": max(lanes),
            "ms": ms, "us_per_access": ms * 1e3 / len(keys), "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def phase_expert_cache(dev, n_layers=16, cap=8, k=2, steps=400, by_layer_steps=100) -> dict:
    """``ExpertCacheRuntime(device="cuda")`` on the card against its host path
    for the six device policies: (a) each of the expert-cache benchmark's
    three traces as one ``route(0, trace)``: one stream launch, misses ==
    the host oracle's; (b) its runtime section, ``steps`` router steps of
    ``n_layers`` layers x top-``k`` at capacity ``cap``: every
    ``route_step`` one launch with misses == the host path's, both timed on
    the host clock per call (the device call ends in its pull of the hit
    count); ``route`` layer by layer == ``route_step`` over the first
    ``by_layer_steps`` steps.  The launches are read from ``ops.LAUNCHES``:
    a device path that ran its stream on the host would count none."""
    from repro_torch.cache.expert_cache import ExpertCacheRuntime

    t_phase = time.perf_counter()
    res = {"phase": "expert_cache", "policies": list(EXPERT_POLICIES), "traces": [],
           "runtime": {"layers": n_layers, "capacity": cap, "top_k": k, "steps": steps,
                       "policies": {}}, "kernels": []}
    route = np.random.RandomState(1).zipf(1.3, size=(steps, n_layers, k)) % 16
    _, phi_e, phi_cap, _, phi_alpha, phi_phases = EXPERT_CASES[1]
    phi_trace = expert_trace(phi_e, phi_alpha, phi_phases)
    launched = {"flat_stream": 0, "adaptive_stream": 0}
    for policy in EXPERT_POLICIES:
        stream = "adaptive_stream" if policy in ("arc", "car") else "flat_stream"
        for name, E, ecap, mb, alpha, phases in EXPERT_CASES:
            trace = expert_trace(E, alpha, phases)
            host = ExpertCacheRuntime(1, ecap, policy, device="host")
            t0 = time.perf_counter()
            want = host.route(0, trace.tolist())
            host_s = time.perf_counter() - t0
            rt = ExpertCacheRuntime(1, ecap, policy, device=dev)
            ops.reset_launches()
            t0 = time.perf_counter()
            got = rt.route(0, trace.tolist())
            dev_s = time.perf_counter() - t0
            assert ops.LAUNCHES[stream] == 1, (policy, name, ops.LAUNCHES)
            assert got == want, (policy, name, got, want)
            launched[stream] += 1
            res["traces"].append({"case": name, "policy": policy, "experts": E,
                                  "capacity": ecap, "accesses": len(trace),
                                  "transfers": got, "hit_ratio": rt.hit_ratio,
                                  "transfer_gb": got * (mb << 20) / 2**30,
                                  "device_s": dev_s, "host_s": host_s})
        host = ExpertCacheRuntime(n_layers, cap, policy, device="host")
        rt = ExpertCacheRuntime(n_layers, cap, policy, device=dev)
        layered = ExpertCacheRuntime(n_layers, cap, policy, device=dev)
        host_t, dev_t = [], []
        ops.reset_launches()
        for s in range(steps):
            t0 = time.perf_counter()
            m_host = host.route_step(route[s])
            t1 = time.perf_counter()
            m_dev = rt.route_step(route[s])
            t2 = time.perf_counter()
            host_t.append(t1 - t0)
            dev_t.append(t2 - t1)
            assert m_dev == m_host, (policy, s, m_dev, m_host)
        assert ops.LAUNCHES[stream] == steps, (policy, ops.LAUNCHES)
        launched[stream] += steps
        # route layer by layer == route_step, misses and final planes
        by_step = ExpertCacheRuntime(n_layers, cap, policy, device=dev)
        ops.reset_launches()
        for s in range(by_layer_steps):
            m = sum(layered.route(layer, route[s, layer]) for layer in range(n_layers))
            assert m == by_step.route_step(route[s]), (policy, s)
        assert all(torch.equal(a, b) for a, b in zip(layered.state, by_step.state)), policy
        assert ops.LAUNCHES[stream] == by_layer_steps * (n_layers + 1), ops.LAUNCHES
        launched[stream] += by_layer_steps * (n_layers + 1)
        res["runtime"]["policies"][policy] = {
            "hit_ratio": rt.hit_ratio, "transfers": rt.transfers,
            "equal_to_host": True, "launches_per_route_step": 1,
            "host_us_per_route_step": statistics.median(host_t) * 1e6,
            "device_us_per_route_step": statistics.median(dev_t) * 1e6,
            "device_us_first_route_step": dev_t[0] * 1e6,
            "kernel_ms_route_step": _time_expert_stream(
                policy, n_layers, cap, np.tile(np.arange(n_layers), k),
                route[0].T.reshape(-1), dev)["ms"]}
        # the stream kernel alone on the phi3.5 case's trace (one row)
        res["kernels"].append(_time_expert_stream(
            policy, 1, phi_cap, np.zeros(len(phi_trace), np.int64), phi_trace, dev))
    res["launches"] = launched
    res["seconds"] = time.perf_counter() - t_phase
    emit(res)
    return res


# -- the rows mesh ---------------------------------------------------------------

#: shard counts of the rows_mesh phase: the sweep grid, kernels 4-5, the engine
ROWS_MESH_SWEEP = (2, 8)
ROWS_MESH_FUSED = (2, 4)
ROWS_MESH_SERVE = 2


def card_mesh(n: int):
    """A rows mesh of ``n`` shards that repeats the card: each shard has a
    stream of its own on it."""
    from repro_torch.core import sharding

    return sharding.rows_mesh(devices=("cuda:0",) * n)


def rows_mesh_sweep(grid, want, unsharded: dict) -> list:
    """(a) The 64-trace grid x 6 policies x TABLE1_CAPS on the trace route
    under a mesh of n: hits == the unsharded hits of ``phase_sweep``, bitwise;
    n launches of flat_sweep and 2n of adaptive_sweep (the unsharded call's
    1 and 2, once per shard), no kernel-2 launch, no host sync; the call's
    seconds beside the unsharded call's."""
    from repro_torch.core.policy_core import DEVICE_POLICIES

    out = []
    for n in ROWS_MESH_SWEEP:
        mesh = card_mesh(n)
        calls = []
        for _ in range(2):
            hits, s, launches, syncs = _engine(grid, list(DEVICE_POLICIES), TABLE1_CAPS,
                                               use_kernel=True, mesh=mesh)
            assert (hits == want).all(), f"the grid under a mesh of {n} differs"
            assert launches["flat_sweep"] == n and launches["adaptive_sweep"] == 2 * n, launches
            assert launches["awrp_select_rows"] == 0 and syncs == 0, (launches, syncs)
            calls.append(s)
        out.append({"shards": n, "rows": int(np.prod(want.shape[:3])), "steps": grid.shape[1],
                    "seconds": calls[0], "seconds_second_call": calls[1],
                    "unsharded_seconds": unsharded["seconds"],
                    "launches": {k: launches[k] for k in ("flat_sweep", "adaptive_sweep")},
                    "launches_unsharded": {k: unsharded["launches"][k]
                                           for k in ("flat_sweep", "adaptive_sweep")},
                    "host_syncs": syncs, "hits_equal_unsharded_bitwise": True})
    return out


def rows_mesh_fused(dev) -> list:
    """(b) Kernels 4 (awrp) and 5 (arc_adaptive) at the serve shape under a
    mesh of n, from a full pool over two evicting page boundaries (page + 1
    steps): each sharded step (a whole pool cut into row views, as
    ``decode_step(mesh=)`` runs it) against the unsharded step on a copy,
    out, mass and every pool and policy plane (K/V included) bitwise; n x
    the unsharded launches per call; the step timed both ways."""
    B, P, page, KVH, G, hd = SERVE_SHAPE
    out = []
    for n in ROWS_MESH_FUSED:
        mesh = card_mesh(n)
        for policy in ("awrp", "arc_adaptive"):
            gen = torch.Generator().manual_seed(SEED + 11)
            if policy == "awrp":
                _, k, v, ps, _, _ = decode_inputs(gen, B, P, page, KVH, G, hd,
                                                  torch.bfloat16, dev)
                pool = paged_kv.PagedPool(
                    k=k.reshape(B, P, page, KVH * hd).contiguous(),
                    v=v.reshape(B, P, page, KVH * hd).contiguous(),
                    f=torch.randint(1, 9, (B, P), generator=gen, dtype=torch.int32).to(dev),
                    r=torch.randint(1, 300, (B, P), generator=gen, dtype=torch.int32).to(dev),
                    page_start=ps, clock=torch.full((B,), 300, dtype=torch.int32, device=dev),
                    open_slot=torch.full((B,), P - 1, dtype=torch.int32, device=dev))
                pos0, name = P * page, "policy_paged_attention"
                step = functools.partial(paged_kv.fused_decode_step, page_size=page,
                                         policy="awrp")
            else:
                pool, pos0 = adaptive_start(gen, "arc", SERVE_SHAPE, dev, ghost=False)
                name = "adaptive_policy_paged_attention"
                core = paged_kv.adaptive_core(policy, B, P, masked_renorm=True)
                step = functools.partial(paged_kv.fused_adaptive_decode_step, page_size=page,
                                         core=core)
            pool_m = pool.clone()
            launches = []
            for i in range(page + 1):
                q = torch.randn(B, KVH, G, hd, generator=gen).to(torch.bfloat16).to(dev)
                nk = (torch.randn(B, KVH * hd, generator=gen) * 0.3).to(torch.bfloat16).to(dev)
                nv = (torch.randn(B, KVH * hd, generator=gen) * 0.3).to(torch.bfloat16).to(dev)
                pos = dpos(pos0 + i, dev)
                o1, m1, pool = step(pool, q, nk, nv, pos)
                ops.reset_launches()
                o2, m2, pool_m = step(pool_m, q, nk, nv, pos, mesh=mesh)
                torch.cuda.synchronize()
                launches.append(ops.LAUNCHES[name])
                assert torch.equal(o1, o2) and torch.equal(m1, m2), (policy, n, i)
                assert all(torch.equal(a, b) for a, b in zip(_leaves(pool), _leaves(pool_m))), \
                    (policy, n, i)
            assert set(launches) == {n * ops.SPLIT_LAUNCHES}, launches
            row = {"shards": n, "kv_policy": policy, "shape": list(SERVE_SHAPE),
                   "steps": page + 1, "first_pos": pos0, "evicting_boundaries": 2,
                   "launches_per_call": launches[0],
                   "launches_per_call_unsharded": ops.SPLIT_LAUNCHES,
                   "out_mass_planes_equal_bitwise": True}
            if policy == "awrp":
                pos = dpos(pos0 + page + 1, dev)
                row["ms"] = time_ms(lambda: step(pool_m, q, nk, nv, pos, mesh=mesh))
                row["unsharded_ms"] = time_ms(lambda: step(pool, q, nk, nv, pos))
            out.append(row)
    return out


def rows_mesh_serve(dev, params, n_req=4, prompt_len=1024, new_tokens=32, pages=16) -> dict:
    """(c) smollm-360m at published widths under a mesh of ROWS_MESH_SERVE
    shards: ``kv_mode="paged"``, ``fused=True``, AWRP, the graph loop, the
    serve phase's parameters and prompts.  Gated: each shard's tokens, its
    loop planes and its final pool planes (pos, F, R, page_start, clock,
    open_slot) bitwise equal to an unsharded engine serving that shard's
    requests; n x the unsharded launches (kernel 6 once per layer per
    shard's prefill, kernel 4 twice per layer per step per shard); one
    synchronizing call per snapshot.  Reported: the K/V of each shard's pools
    equal too, and tokens and planes equal to the unsharded engine on all
    the requests (cuBLAS may pick other GEMM kernels at another M)."""
    from repro_torch.serve.engine import Request, ServeEngine

    n = ROWS_MESH_SERVE
    cfg = dataclasses.replace(CONFIG, bounded_kv_pages=pages, kv_policy="awrp")
    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(1, cfg.vocab, size=prompt_len).tolist() for _ in range(n_req)]

    def serve(batch, **kw):
        eng = ServeEngine(cfg, params, max_len=prompt_len + new_tokens, kv_mode="paged",
                          fused=True, seed=SEED, device=dev, **kw)
        final = {}
        orig = eng._graph_loop

        def loop(*a, **k):
            res = orig(*a, **k)
            final["planes"] = _planes_of(res[1])
            final["kv"] = [t.clone() for c in res[1]["blocks"].values() for t in c[:2]]
            return res

        eng._graph_loop = loop
        ops.reset_launches()
        t0 = time.perf_counter()
        res = eng.generate([Request(i, list(p), max_new_tokens=new_tokens)
                            for i, p in enumerate(batch)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        tel = eng.telemetry()
        return eng, {"tokens": [res[i].tokens for i in range(len(batch))],
                     "launches": dict(ops.LAUNCHES), "seconds": seconds,
                     "loop": {k: tel[k] for k in LOOP_KEYS}, **final}

    eng, got = serve(prompts, mesh=card_mesh(n))
    assert eng.stats["loop_captures"] == n and eng.stats["nonfinite_logits"] == 0, eng.stats
    assert eng.stats["kv_evictions"] > 0, eng.stats
    per_call = ops.SPLIT_LAUNCHES * cfg.n_layers * (new_tokens - 1)
    assert got["launches"]["policy_paged_attention"] == n * per_call, got["launches"]
    assert got["launches"]["flash_attention"] == n * cfg.n_layers, got["launches"]
    snapshot = one_pull(eng)
    k = n_req // n
    shards, kv_equal = [], True
    for i, shard in enumerate(eng.last_shards):
        sub_eng, sub = serve(prompts[i * k:(i + 1) * k])
        assert got["tokens"][i * k:(i + 1) * k] == sub["tokens"], f"shard {i}: tokens differ"
        for key in LOOP_KEYS:
            want = sub["loop"][key]
            have = shard["planes"][key.rsplit("/", 1)[1]].cpu().numpy()
            assert np.array_equal(have, want), (i, key)
        planes = _planes_of(shard["caches"])
        assert len(planes) == len(sub["planes"])
        assert all(torch.equal(a, b) for a, b in zip(planes, sub["planes"])), \
            f"shard {i}: pool planes differ"
        kv = [t for c in shard["caches"]["blocks"].values() for t in c[:2]]
        kv_equal &= all(torch.equal(a, b) for a, b in zip(kv, sub["kv"]))
        shards.append({"requests": k, "tokens_equal": True, "loop_planes_equal": True,
                       "pool_planes_equal_bitwise": True, "seconds": sub["seconds"],
                       "launches": {x: sub["launches"][x] for x in (
                           "policy_paged_attention", "flash_attention")}})
        del sub_eng
    whole_eng, whole = serve(prompts)
    del whole_eng
    # the whole batch's planes are (layers, 4, P); a shard's (layers, 2, P)
    gathered = [torch.cat([_planes_of(s["caches"])[j] for s in eng.last_shards], dim=1)
                for j in range(1, len(whole["planes"]))]
    return {"shards": n, "model": cfg.name, "layers": cfg.n_layers, "requests": n_req,
            "prompt_len": prompt_len, "new_tokens": new_tokens, "pages": pages,
            "seconds": got["seconds"], "unsharded_seconds": whole["seconds"],
            "decode_s": eng.stats["decode_s"], "prefill_s": eng.stats["prefill_s"],
            "launches": {x: got["launches"][x] for x in ("policy_paged_attention",
                                                         "flash_attention")},
            "launches_unsharded": {x: whole["launches"][x] for x in (
                "policy_paged_attention", "flash_attention")},
            "per_shard": shards, "shard_kv_equal_bitwise": bool(kv_equal),
            "tokens_equal_unsharded_whole_batch": got["tokens"] == whole["tokens"],
            "loop_planes_equal_unsharded_whole_batch": all(
                np.array_equal(got["loop"][key], whole["loop"][key]) for key in LOOP_KEYS),
            "pool_planes_equal_unsharded_whole_batch": all(
                torch.equal(a, b) for a, b in zip(gathered, whole["planes"][1:])),
            "snapshot": {x: snapshot[x] for x in ("sync_calls", "sync_call", "keys",
                                                  "snapshot_ms")}}


def rows_mesh_tenancy(dev) -> list:
    """(d) The tenancy benchmark's 6000-access stream, 3 tenants (16 each)
    padded to 4 core rows on a mesh of 2, ``access_stream`` with a
    TENANCY_RING-event ring (it wraps), then ``decide_batch``: hits,
    counters, the admission codes and the drained records (access and
    admission events, field by field, in order) == the unsharded manager's
    on the card; one ring launch per shard."""
    from repro_torch.serve.tenancy import AdmissionController, TenantCacheManager

    rows, keys = tenancy_trace(TENANCY_N)
    quotas = dict(zip(TENANCY_TENANTS, (16, 16, 16)))
    batch = ["mid", "scan", "hot", "scan", "mid"]
    out = []
    for policy in ("awrp", "car"):
        stream = "adaptive_stream_ring" if policy == "car" else "flat_stream_ring"
        adm = AdmissionController(defer_at=0.2, shed_at=0.5, warmup=0)
        base = TenantCacheManager(quotas, policy, ring_capacity=TENANCY_RING, device=dev)
        mgr = TenantCacheManager(quotas, policy, ring_capacity=TENANCY_RING,
                                 mesh=card_mesh(2))
        want = base.access_stream(rows, keys)
        ops.reset_launches()
        got = mgr.access_stream(rows, keys)
        launches = ops.LAUNCHES[stream]
        assert np.array_equal(got, want) and launches == 2, (policy, launches)
        assert adm.decide_batch(mgr, batch) == adm.decide_batch(base, batch), policy
        tb, tm = base.row_telemetry(), mgr.row_telemetry()
        for key in ("hits", "misses", "evictions", "pressure", "occupancy"):
            assert np.array_equal(tm[key][:3], tb[key]), (policy, key)
        assert not tm["hits"][3:].any() and not tm["occupancy"][3:].any(), policy
        a, b = mgr.drain_trace(), base.drain_trace()
        assert len(a) == len(b) == TENANCY_RING, (len(a), len(b))
        assert all(np.array_equal(a[f], b[f]) for f in a.dtype.names), policy
        out.append({"policy": policy, "tenants": 3, "core_rows": mgr.core.rows, "shards": 2,
                    "accesses": len(keys), "ring_capacity": TENANCY_RING,
                    "launches": launches, "launches_unsharded": 1,
                    "hits_counters_decisions_trace_equal": True})
    return out


def phase_rows_mesh(dev, params, sweep: dict) -> dict:
    """The rows mesh on the card (``core/sharding.py``): meshes that repeat
    the card, one stream per shard; every sharded run held bitwise to the
    unsharded port on the card: (a) the sweep grid, (b) kernels 4 and 5,
    (c) the serving engine, (d) tenancy with the decision-trace ring."""
    t0 = time.perf_counter()
    res = {"phase": "rows_mesh", "card": smi(),
           "sweep": rows_mesh_sweep(sweep_traces("paper", 64), sweep["_grid64_hits"],
                                    sweep["grid64"]["trace"]),
           "fused": rows_mesh_fused(dev), "serve": rows_mesh_serve(dev, params),
           "tenancy": rows_mesh_tenancy(dev)}
    res["seconds"] = time.perf_counter() - t0
    emit(res)
    return res


KERNELS = {
    "paged_attention": ("src/repro_torch/kernels/csrc/paged_attn.cu",
                        "src/repro/kernels/paged_attn.py:86"),
    "policy_paged_attention": ("src/repro_torch/kernels/csrc/policy_attn.cu",
                               "src/repro/kernels/policy_attn.py:185"),
    "adaptive_policy_paged_attention": ("src/repro_torch/kernels/csrc/adaptive_attn.cu",
                                        "src/repro/kernels/policy_attn.py:382"),
    "awrp_select": ("src/repro_torch/kernels/csrc/awrp_select.cu",
                    "src/repro/kernels/awrp_select.py:50"),
    "awrp_select_rows": ("src/repro_torch/kernels/csrc/awrp_select.cu",
                         "src/repro/kernels/awrp_select.py:89"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attn.cu",
                        "src/repro/kernels/flash_attn.py:80"),
    # port-only: the gradient XLA derives for the reference's jnp
    # flash_attention, which has no Pallas kernel of its own
    "flash_attention_bwd": ("src/repro_torch/kernels/csrc/flash_attn_bwd.cu",
                            "src/repro/models/layers.py:100"),
    # kernel 2 redesigned: the whole trace around the per-step victim search
    "flat_sweep": ("src/repro_torch/kernels/csrc/sweep.cu",
                   "src/repro/kernels/awrp_select.py:89"),
    # port-only: the ARC/CAR rows of the same lax.scan, which has no Pallas
    # kernel of its own (its body is the core's on_access)
    "adaptive_sweep": ("src/repro_torch/kernels/csrc/sweep.cu",
                       "src/repro/core/jax_policies.py:329"),
}


def serving_summary(runs) -> list:
    """Per served phase the two loops side by side: the engine's decode
    ms/step of the graph and the host loop (``loops_agree``), and the
    profiled step of each (``profile_decode``)."""
    keys = ("wall_ms_per_step", "device_ms_per_step", "device_busy_share",
            "kernels_per_step", "graph_launches_per_step")
    out = []
    for label, r in runs:
        row = {"phase": label, **{k: r["loops"][k] for k in (
            "graph_ms_per_step", "host_ms_per_step", "decode_steps", "loop_captures",
            "graph_build_s", "static_tree_gb")}}
        prof = r.get("decode_step_profile")
        if prof:
            row.update({f"{loop}_{k}": prof[loop].get(k) for loop in ("eager", "graph")
                        for k in keys})
        for k in ("max_memory_allocated_gb", "graph_peak_memory_allocated_gb"):
            if k in r:
                row[k] = r[k]
        if "adaptive" in r and "loops" in r["adaptive"]:
            row["adaptive"] = {k: r["adaptive"]["loops"][k] for k in (
                "graph_ms_per_step", "host_ms_per_step", "decode_steps")}
        out.append(row)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    submit_host_jobs()
    try:
        return _phases(dev, t_start)
    finally:
        stop_host_workers()


def _phases(dev, t_start: float) -> int:
    """Every phase after the build, the kernels line and the result line."""
    pa = phase_paged_attention(dev)
    phase_paged_attention(dev, SERVE_SHAPE)
    pa_g3 = phase_paged_attention(dev, GEMMA3_DECODE_SHAPE)
    pa_z2 = phase_paged_attention(dev, ZAMBA2_DECODE_SHAPE)
    for shape in (DECODE_SHAPE, GEMMA3_DECODE_SHAPE, ZAMBA2_DECODE_SHAPE):
        phase_paged_attention(dev, shape, ragged=True, timed=False)
    # at P=256 over two evicting page boundaries; at the serve shape: awrp
    # as the serve phase runs it (3 evicting page boundaries), every other
    # page policy over two evicting boundaries
    page = SERVE_SHAPE[2]
    pol = phase_policy_attn(dev, steps=DECODE_SHAPE[2] + 1)
    at_serve = [phase_policy_attn(dev, p, SERVE_SHAPE,
                                  steps=3 * page if p == "awrp" else page + 1,
                                  timed=p == "awrp")
                for p in PAGE_POLICIES]
    pol_g3 = phase_policy_attn(dev, "awrp", GEMMA3_DECODE_SHAPE)
    pol_phi = phase_policy_attn(dev, "awrp", PHI35_DECODE_SHAPE)
    # the QKV-bias and hybrid families' groups: G = 5, G = 7, (G = 1, hd = 112),
    # over one evicting page boundary each, the timed step the next one
    pol_new = [phase_policy_attn(dev, "awrp", shape, steps=SERVE_SHAPE[2])
               for shape in NEW_DECODE_SHAPES]
    fl = phase_flash_attn(dev)
    fl_draws = flash_gate_draws(dev, FLASH_DRAWS)
    fb = phase_flash_bwd(dev)
    tr = phase_train(dev)
    trm = phase_train_mesh(dev, tr)
    trf = phase_train_families(dev)
    params, init_s = serve_params(dev)
    srv = phase_serve(dev, params, init_s)
    # kernel 5 at the serve shape from the prefill seeding (timed), with a
    # forced stamp renormalization and from a ghost-hit reseed (p != 0),
    # each over two evicting page boundaries; at P=256 (L=512) across one;
    # at the other families' decode shapes (timed) an evicting page boundary
    # and a mid-page step, then both timed
    ada = [phase_adaptive_attn(dev, kind, timed=kind == "arc") for kind in ("arc", "car")]
    ada += [phase_adaptive_attn(dev, kind, renorm_at=64) for kind in ("arc", "car")]
    ada += [phase_adaptive_attn(dev, kind, ghost=True) for kind in ("arc", "car")]
    ada += [phase_adaptive_attn(dev, kind, DECODE_SHAPE, steps=2, repeat=True)
            for kind in ("arc", "car")]
    ada_g3 = phase_adaptive_attn(dev, "arc", GEMMA3_DECODE_SHAPE, steps=2, timed=True)
    ada_phi = phase_adaptive_attn(dev, "arc", PHI35_DECODE_SHAPE, steps=2, timed=True)
    ada_new = [phase_adaptive_attn(dev, "arc", shape, steps=2, timed=True)
               for shape in NEW_DECODE_SHAPES]
    ada += [ada_g3, ada_phi, *ada_new]
    srv_ada = [phase_serve_adaptive(dev, params, p, profile=p == "arc_adaptive")
               for p in ("arc_adaptive", "car_adaptive")]
    srv_ten = phase_serve_tenants(dev, params)
    # the serve phases' parameters wait in host memory for rows_mesh
    params_host = tree_map(lambda t: t.to("cpu"), params)
    del params
    g3 = phase_serve_gemma3(dev)
    phi = phase_serve_phi35(dev)
    qwen = phase_serve_qwen25(dev)
    zamba = phase_serve_zamba2(dev)
    mamba = phase_serve_mamba2(dev)
    whisper = phase_serve_whisper(dev)
    internvl = phase_serve_internvl2(dev)
    sel = phase_awrp_select(dev)
    swp = phase_sweep(dev)
    rows = phase_rows_mesh(dev, tree_map(lambda t: t.to(dev), params_host), swp)
    del params_host
    ten = phase_tenancy(dev)
    ec = phase_expert_cache(dev)
    emit({"phase": "decode_loops", "card": smi(), "cells": serving_summary(
        [("serve", srv), *((r["kv_policy"], r) for r in srv_ada), ("serve_gemma3", g3),
         ("serve_phi35", phi), ("serve_qwen25", qwen), ("serve_zamba2", zamba),
         ("serve_mamba2", mamba), ("serve_whisper", whisper),
         ("serve_internvl2", internvl)])})
    # the metrics half of observability: one snapshot's keys, pull and syncs
    # (serve and both serve_tenants runs), the fold's cost in the graph step,
    # the live endpoint over a capture, the kernel library's nvcc seconds
    snap = srv["snapshot"]
    emit({"phase": "telemetry", "card": smi(), "keys": snap["keys"],
          "pull_ms": snap["snapshot_ms"], "sync_calls": snap["sync_calls"],
          "nvcc_seconds": snap["nvcc_seconds"], "nvcc_builds": snap["nvcc_builds"],
          "serve": snap, "serve_tenants": [r["snapshot"] for r in srv_ten["runs"]],
          "fold_cost": srv["fold_cost"], "live_endpoint": srv_ten["runs"][0]["live_endpoint"],
          "trace_drain": [{k: r["decision_trace"][k] for k in (
              "events", "sync_calls_per_drain", "sync_call", "trace_drain_p50_s")}
              for r in srv_ten["runs"]],
          "loop_planes_equal_bitwise": {label: r["loops"]["loop_planes_equal_bitwise"]
                                        for label, r in [("serve", srv), *(
                                            (x["kv_policy"], x) for x in srv_ada),
                                            ("serve_gemma3", g3), ("serve_phi35", phi),
                                            ("serve_qwen25", qwen),
                                            ("serve_zamba2", zamba),
                                            ("serve_mamba2", mamba),
                                            ("serve_whisper", whisper),
                                            ("serve_internvl2", internvl)]}})
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    # launches: each kernel's count on its path in this run: the flat fused
    # kernel in the serve phase, the adaptive one in serve_adaptive (both
    # policies), the unfused kernel in phase 3's unfused chain (the serve
    # loop's fused route does not launch it, as in the reference), kernel 6
    # in serve_gemma3's AWRP batch (one prefill), the rows kernel on its
    # per-step path (FlatCore(use_kernel=True), 200 steps of (a)'s flat rows),
    # the trace kernels in the Table-1 sweep (a) and, in their stream mode,
    # in serve_tenants (the AWRP run's prefix cache: flat, the arc run's:
    # ARC/CAR); kernel 1 is on no path of the port (as in the reference, only
    # tests reach it): 0.  Kernels 4-6 also give their counts in
    # serve_phi35, serve_qwen25 and serve_zamba2 (serve_mamba2 is
    # attention-free: none of them runs there, 0), the stream kernels theirs
    # in expert_cache.
    timed_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = []
    for name, runs, launches, times, shape, others in (
            ("paged_attention", [pa, pa_g3, pa_z2], pol["launches"]["paged_attention"], pa,
             DECODE_SHAPE, [pa_g3, pa_z2]),
            ("policy_paged_attention", at_serve + [pol_g3, pol_phi, *pol_new],
             srv["launches"]["policy_paged_attention"], at_serve[0], SERVE_SHAPE,
             [pol_g3, pol_phi, *pol_new]),
            ("adaptive_policy_paged_attention", ada,
             sum(r["launches"]["adaptive_policy_paged_attention"] for r in srv_ada),
             ada[0], SERVE_SHAPE, [ada_g3, ada_phi, *ada_new])):
        source, replaces = KERNELS[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches,
            "max_abs_err": max(max(r["max_abs_err_out"], r["max_abs_err_mass"])
                               for r in runs),
            **{k: times[k] for k in timed_keys}, "shape": list(shape),
            "other_shapes": [{"shape": o["shape"], **{k: o[k] for k in timed_keys}}
                             for o in others]})
    kernels[1]["launches_serve_phi35"] = phi["launches"]["policy_paged_attention"]
    kernels[2]["launches_serve_phi35"] = \
        phi["adaptive"]["launches"]["adaptive_policy_paged_attention"]
    kernels[1]["launches_serve_qwen25"] = qwen["launches"]["policy_paged_attention"]
    kernels[1]["launches_serve_zamba2"] = zamba["launches"]["policy_paged_attention"]
    kernels[2]["launches_serve_qwen25"] = \
        qwen["adaptive"]["launches"]["adaptive_policy_paged_attention"]
    kernels[2]["launches_serve_zamba2"] = zamba["launches"]["adaptive_policy_paged_attention"]
    for k in kernels:
        k["launches_serve_mamba2"] = mamba["launches"][k["name"]]  # attention-free: 0
        # whisper's decode attention is plain torch (0), internvl2's kernel 4
        k["launches_serve_whisper"] = whisper["launches"][k["name"]]
        k["launches_serve_internvl2"] = internvl["launches"][k["name"]]
    # launches under the rows mesh: kernel 4 in rows_mesh (c)'s engine
    # (n x the unsharded count), kernel 5 per call of (b) at the largest mesh
    kernels[1]["launches_rows_mesh"] = rows["serve"]["launches"]["policy_paged_attention"]
    kernels[1]["launches_rows_mesh_unsharded"] = \
        rows["serve"]["launches_unsharded"]["policy_paged_attention"]
    kernels[2]["launches_rows_mesh_per_call"] = {
        f"{r['shards']}_shards": r["launches_per_call"] for r in rows["fused"]
        if r["kv_policy"] == "arc_adaptive"}
    main_case, *other_cases = fl["cases"]
    source, replaces = KERNELS["flash_attention"]
    kernels.append({
        "name": "flash_attention", "route": "cuda", "source": source,
        "replaces": replaces, "launches": g3["launches"]["flash_attention"],
        "launches_serve_phi35": phi["launches"]["flash_attention"],
        "launches_serve_qwen25": qwen["launches"]["flash_attention"],
        "launches_serve_zamba2": zamba["launches"]["flash_attention"],
        "launches_serve_mamba2": mamba["launches"]["flash_attention"],
        "launches_serve_whisper": whisper["launches"]["flash_attention"],
        "launches_serve_internvl2": internvl["launches"]["flash_attention"],
        "launches_rows_mesh": rows["serve"]["launches"]["flash_attention"],
        # the train phase's main path: each layer's forward and remat's
        # recompute, per microbatch, with lse on; likewise the other
        # families' cells (whisper's encoder, decoder self and cross)
        "launches_train": tr["launches"]["flash_attention"],
        # the placed step on a (1, 1) mesh, each rank's local heads under
        # local_map: as many as the plain step's
        "launches_train_mesh": trm["launches"]["flash_attention"],
        "launches_train_families": trf["launches"]["flash_attention"],
        "smollm_train": {k: fb["cases"][0][k] for k in (
            "fwd_ms", "fwd_lse_ms", "fwd_plain_ms", "fwd_library_ms")},
        "max_abs_err": max(c["max_abs_err"] for c in fl["cases"]),
        **{k: main_case[k] for k in timed_keys},
        "shape": main_case["shape"], "window": main_case["window"],
        "other_shapes": [{k: c[k] for k in ("label", "shape", "kv_seq", "window", "dtype",
                                            *timed_keys)} for c in other_cases]})
    bwd_main, *bwd_others = fb["cases"]
    source, replaces = KERNELS["flash_attention_bwd"]
    kernels.append({
        "name": "flash_attention_bwd", "route": "cuda", "source": source,
        "replaces": replaces, "launches": tr["launches"]["flash_attention_bwd"],
        "launches_train_mesh": trm["launches"]["flash_attention_bwd"],
        "launches_train_families": trf["launches"]["flash_attention_bwd"],
        "max_abs_err": max(c["max_abs_err"] for c in fb["cases"]),
        **{k: bwd_main[k] for k in timed_keys}, "shape": bwd_main["shape"],
        "other_shapes": [{k: c[k] for k in ("label", "shape", "kv_seq", "kv_len", "causal",
                                            "window", "dtype", *timed_keys)}
                         for c in bwd_others]})
    for name in ("awrp_select", "awrp_select_rows"):
        source, replaces = KERNELS[name]
        main_run = sel["kernels"][name][0]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": swp["kernel2_path"]["launches"] if name == "awrp_select_rows" else 0,
            "max_abs_err": 0,  # integer victims, compared for equality
            "ms": main_run["ms"], "plain_ms": main_run["plain_ms"],
            "bound_ms": main_run["bound_ms"], "bound_by": main_run["bound_by"],
            "library_ms": None, "shape": [main_run["B"], main_run["P"]],
            "other_shapes": [{k: r[k] for k in ("B", "P", "ms", "plain_ms", "bound_ms")}
                             for r in sel["kernels"][name][1:2]]})
    for name, stream in (("flat_sweep", "flat_stream"), ("adaptive_sweep", "adaptive_stream")):
        source, replaces = KERNELS[name]
        main_run, *others = swp["kernels"][name]
        s_main, *s_others = ten["kernels"][stream]
        stream_keys = ("policy", "rows", "accesses", "lanes", *timed_keys, "us_per_access")
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": swp["table1"]["launches"][name],
            "launches_rows_mesh": {f"{r['shards']}_shards": r["launches"][name]
                                   for r in rows["sweep"]},
            "max_abs_err": 0,  # hit bits and integer planes, compared for equality
            **{k: main_run[k] for k in timed_keys}, "ms_per_step": main_run["ms_per_step"],
            "shape": {k: main_run[k] for k in ("grid", "kind", "rows", "steps", "lanes")},
            "other_shapes": [{k: r.get(k) for k in ("grid", "kind", "rows", "steps", "lanes",
                                                    *timed_keys, "ms_per_step")}
                             for r in others],
            # the stream mode (the tenancy manager's access_stream / access)
            "stream": {"name": stream, "max_abs_err": 0,
                       "launches": sum(r["launches"][stream] for r in srv_ten["runs"]),
                       "launches_tenancy_phase": sum(
                           c["launches"] for c in ten["cases"].values()
                           if (c["policy"] in ("arc", "car")) == (stream == "adaptive_stream")),
                       "launches_expert_cache_phase": ec["launches"][stream],
                       **{k: s_main.get(k) for k in stream_keys},
                       "other_shapes": [{k: r.get(k) for k in stream_keys} for r in s_others]
                       + [{"label": "expert_cache", **{k: r.get(k) for k in stream_keys}}
                          for r in ec["kernels"]
                          if (r["policy"] in ("arc", "car")) == (stream == "adaptive_stream")],
                       # the ring variant: the same kernel writing the
                       # decision-trace ring (a compile-time variant), launched
                       # by serve_tenants' traced re-serves
                       "ring": {"name": f"{stream}_ring", "route": "cuda", "source": source,
                                "launches": sum(r["decision_trace"]["launches"][f"{stream}_ring"]
                                                for r in srv_ten["runs"]),
                                "launches_rows_mesh": sum(
                                    r["launches"] for r in rows["tenancy"]
                                    if (r["policy"] == "car") == (stream == "adaptive_stream")),
                                "max_abs_err": 0, "policy": s_main["policy"],
                                "accesses": s_main["accesses"],
                                "ring_capacity": TENANCY_RING, "ms": s_main["ring_ms"],
                                "ring_off_ms": s_main["ms"],
                                "plain_ms_per_access": s_main["ring_plain_ms_per_access"],
                                "bound_ms": s_main["ring_bound_ms"],
                                "bound_by": s_main["ring_bound_by"], "library_ms": None,
                                "one_access_ms": ten["ring_one_access"][s_main["policy"]],
                                "other_policies": [
                                    {k: r[k] for k in ("policy", "ms", "ring_ms",
                                                       "ring_plain_ms_per_access",
                                                       "ring_bound_ms")} for r in s_others]}}})
    emit({"kernels": kernels,
          "serve_mamba2": "attention-free: no kernel of the port runs in its serve "
                          "phase (its launches_serve_mamba2 are 0)",
          "serve_whisper": "kernel 6 in every encoder, decoder-self and cross "
                           "attention of a prefill; its decode attention is plain "
                           "torch, as the reference's jnp (kernels 3-5: 0)"})
    print(smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
