"""Serving driver: batched requests through the port's AWRP-managed engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --requests 4 \
      --new-tokens 32 --kv-mode paged --kv-policy awrp --fused

``--kv-policy arc_adaptive`` / ``car_adaptive`` serves the true-adaptive
ARC/CAR pool; with ``--repeat-prompts`` the requests run one at a time and
the ghost-hit feed carries the policy across them (``kv_ghost_hits``).

``--tenants a=2,b=2`` mounts the prompt cache as one policy-core row per
tenant (quota = row capacity) with the admission controller in front:
requests round-robin the tenants, run one at a time, and the last lines give
each tenant's quota, hit ratio, evictions and pressure and the shed /
deferred / rebalanced counts; ``--auto-rebalance`` moves quota lanes to a
pressured tenant from the coldest.  ``--decision-trace N`` (needs
``--tenants``) records the tenants' last N access and admission decisions in
the on-device trace ring and reports their OPT regret, also as the
``tenant/<t>/opt_regret`` and ``policy/<name>/opt_regret`` gauges of the
final snapshot.

``--arch`` picks the model: ``smollm_360m`` (default), ``gemma3_27b`` (5
sliding-window local layers per global layer; the pool bounds the global
layers' KV, the local layers keep ``sliding_window``-row rings), or the MoE
family's ``phi35_moe`` (16 SwiGLU experts, top-2) and ``grok1_314b`` (8 GELU
experts, top-2), the QKV-bias GQA ``qwen25_14b`` (G = 5), the GQA
``yi_34b`` (G = 7), the attention-free ``mamba2_370m`` (48 Mamba-2 blocks:
no KV cache, the pool flags are moot and the prefix cache holds the SSM
states) and the hybrid ``zamba2_7b`` (13 x (5 Mamba-2 + 1 shared-attention
block, one parameter set for the 13) + 3 Mamba-2; each shared-attention
occurrence has its own pool), the VLM ``internvl2_26b`` (G = 6; the
engine's zero patch embeddings take the first ``n_patch_tokens`` positions)
and the encoder-decoder ``whisper_large_v3`` (32 encoder + 32 decoder
layers over the engine's zero frame embeddings, half the prompt's length;
full self and cross K/V caches in every ``--kv-mode``, as the reference).
A configuration whose weights exceed the
device's memory is refused (grok-1's full config on one card): its
``--smoke`` config runs.

The decode loop replays one captured CUDA graph per step (the engine's
``jit_loop=True``, the reference's default); ``--host-loop`` runs the eager
per-step loop instead, the baseline.

Observability: ``--metrics-out PATH`` writes the final telemetry snapshot
as ``PATH.prom`` (Prometheus text) and appends it to ``PATH.jsonl``;
``--metrics-port`` serves live snapshots over HTTP while generating
(``/metrics``, ``/metrics.json``, ``/healthz``; 0 picks a free port);
``--snapshot-every S`` appends a JSONL snapshot every S seconds meanwhile;
``--profile-dir`` writes ``torch.profiler`` chrome traces, one per
``--profile-every`` requests; ``--profile-phases`` makes the phase spans
wait for their own device work:

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke \
      --dtype float32 --metrics-out /tmp/m

Runs on the CUDA card by default (``--device cuda``; raises when CUDA is not
available).  ``--device cpu`` runs the plain PyTorch versions of the kernels
on the CPU.  Weights are random, from ``--seed``; nothing is downloaded.
``--smoke`` serves the arch's reduced smoke configuration instead of the
published widths.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from repro_torch.cache.paged_kv import TRUE_ADAPTIVE_KV
from repro_torch.configs import (gemma3_27b, grok1_314b, internvl2_26b, mamba2_370m,
                                 phi35_moe, qwen25_14b, smollm_360m, whisper_large_v3,
                                 yi_34b, zamba2_7b)
from repro_torch.core.kv_policy import PAGE_POLICIES
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.obs.export import append_jsonl, prometheus_text
from repro_torch.obs.server import MetricsServer, SnapshotLogger
from repro_torch.serve.engine import Request, ServeEngine

ARCHS = {"smollm_360m": smollm_360m, "gemma3_27b": gemma3_27b,
         "phi35_moe": phi35_moe, "grok1_314b": grok1_314b, "qwen25_14b": qwen25_14b,
         "yi_34b": yi_34b, "mamba2_370m": mamba2_370m, "zamba2_7b": zamba2_7b,
         "whisper_large_v3": whisper_large_v3, "internvl2_26b": internvl2_26b}


def device_memory_bytes(device: torch.device) -> int:
    """Memory a model's weights may take on ``device``: the card's total, or
    the host's physical memory for the CPU."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def main(argv=None):
    """Serve the requests ``argv`` describes, print the summary lines from
    one telemetry snapshot, export it as asked; returns the results by
    request id."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_360m", choices=tuple(ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="serve the arch's reduced SMOKE_CONFIG")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default=None, choices=("bfloat16", "float32"),
                    help="activation and parameter dtype (default: the config's)")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--kv-mode", default="full", choices=("full", "paged"))
    ap.add_argument("--kv-policy", default="awrp",
                    choices=PAGE_POLICIES + tuple(TRUE_ADAPTIVE_KV))
    ap.add_argument("--kv-pages", type=int, default=None,
                    help="bounded pool size in pages (default: the config's)")
    ap.add_argument("--fused", action="store_true",
                    help="paged decode through the fused CUDA policy kernel")
    ap.add_argument("--max-len", type=int, default=512)
    ap.add_argument("--repeat-prompts", action="store_true",
                    help="send duplicate prompts to exercise the prefix cache")
    ap.add_argument("--tenants", default=None, metavar="NAME=QUOTA,...",
                    help="multi-tenant mode: per-tenant prompt-cache quotas (one "
                    "policy-core row each); requests round-robin the tenants")
    ap.add_argument("--auto-rebalance", action="store_true",
                    help="move quota lanes to pressured tenants from the coldest "
                    "(AWRP tenant ranking)")
    ap.add_argument("--host-loop", action="store_true",
                    help="decode with the eager per-step host loop instead of "
                    "replaying the captured decode graph")
    ap.add_argument("--decision-trace", type=int, default=0, metavar="N",
                    help="multi-tenant only: record the last N policy decisions in the "
                    "on-device trace ring and report OPT-regret gauges in the final "
                    "snapshot")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="export the final telemetry snapshot: writes PATH.prom "
                    "(Prometheus text exposition) and appends one JSON line to "
                    "PATH.jsonl")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                    help="serve live telemetry over HTTP from a background thread "
                    "while generating: /metrics (Prometheus text), /metrics.json, "
                    "/healthz (0 = a free port, printed at startup)")
    ap.add_argument("--snapshot-every", type=float, default=0.0, metavar="SECONDS",
                    help="with --metrics-out: append a JSONL telemetry snapshot every "
                    "SECONDS from a background thread while generating (plus the "
                    "final snapshot)")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="write torch.profiler chrome traces under DIR, one per "
                    "--profile-every requests")
    ap.add_argument("--profile-every", type=int, default=16, metavar="N",
                    help="requests between profiler captures (with --profile-dir)")
    ap.add_argument("--profile-phases", action="store_true",
                    help="each phase span waits for its own device work, so span/* "
                    "holds per-phase device time")
    args = ap.parse_args(argv)
    if args.snapshot_every and not args.metrics_out:
        ap.error("--snapshot-every needs --metrics-out")
    if args.decision_trace and not args.tenants:
        ap.error("--decision-trace needs --tenants")

    tenants = None
    if args.tenants:
        tenants = {}
        for part in args.tenants.split(","):
            name, _, quota = part.partition("=")
            tenants[name.strip()] = int(quota)

    device = resolve_device(args.device)
    arch = ARCHS[args.arch]
    cfg = arch.SMOKE_CONFIG if args.smoke else arch.CONFIG
    cfg = dataclasses.replace(cfg, kv_policy=args.kv_policy)
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype, param_dtype=args.dtype)
    if args.kv_pages:
        cfg = dataclasses.replace(cfg, bounded_kv_pages=args.kv_pages)
    need, have = M.param_bytes(cfg), device_memory_bytes(device)
    if need > have:
        ap.error(f"{cfg.name}: its {cfg.param_dtype} weights take {need / 1e9:.1f} GB, "
                 f"more than the {have / 1e9:.1f} GB of {device}; serve its --smoke "
                 "config instead")
    gen = torch.Generator().manual_seed(args.seed)
    params = M.init_params(cfg, gen, device=device)
    engine = ServeEngine(cfg, params, max_len=args.max_len, kv_mode=args.kv_mode,
                         fused=args.fused, seed=args.seed, tenants=tenants,
                         auto_rebalance=args.auto_rebalance,
                         jit_loop=not args.host_loop, decision_trace=args.decision_trace,
                         profile_dir=args.profile_dir,
                         profile_every=args.profile_every,
                         profile_phases=args.profile_phases, device=device)
    # live export: both run on daemon threads and take the same one-pull
    # snapshot telemetry() takes
    server = logger = None
    if args.metrics_port is not None:
        server = MetricsServer(engine.telemetry, port=args.metrics_port).start()
        print(f"metrics: serving http://127.0.0.1:{server.port}/metrics")
    extra = {"arch": cfg.name, "kv_mode": args.kv_mode}
    if args.snapshot_every:
        logger = SnapshotLogger(engine.telemetry, args.metrics_out + ".jsonl",
                                interval_s=args.snapshot_every, extra=extra).start()

    rng = np.random.RandomState(args.seed)
    names = list(tenants) if tenants else ["default"]
    reqs = []
    for i in range(args.requests):
        if args.repeat_prompts and i >= 2 * len(names):
            # repeat an earlier prompt of the same tenant (prefix reuse)
            prompt = reqs[i - 2 * len(names)].prompt[:]
        else:
            prompt = rng.randint(1, cfg.vocab, size=args.prompt_len).tolist()
        reqs.append(Request(i, prompt, max_new_tokens=args.new_tokens,
                            tenant_id=names[i % len(names)]))

    t0 = time.perf_counter()
    if args.repeat_prompts or tenants:
        # one request at a time: the prefix path and the admission
        # controller act request by request
        results = {}
        for r in reqs:
            results.update(engine.generate([r]))
    else:
        results = engine.generate(reqs)
    dt = time.perf_counter() - t0
    total = sum(len(r.tokens) for r in results.values())
    regret = engine.opt_regret() if args.decision_trace else None  # sets the gauges
    tel = engine.telemetry()  # one flat snapshot, one synchronization
    print(f"arch={cfg.name} device={device} kv_mode={args.kv_mode} "
          f"policy={args.kv_policy} fused={args.fused} "
          f"loop={'host' if args.host_loop else 'graph'}")
    print(f"{len(reqs)} requests, {total} tokens in {dt:.2f}s "
          f"(prefill {tel['serve/prefill_s']:.3f}s, decode {tel['serve/decode_s']:.3f}s)")
    print(f"kv evictions={tel['serve/kv_evictions']} "
          f"kv_ghost_hits={tel['serve/kv_ghost_hits']}", end=" ")
    if tenants is None:
        print(f"prefix cache: hits={tel['prefix/hits']} misses={tel['prefix/misses']}")
    else:
        print()
        for name in names:
            print(f"tenant {name}: quota={tel[f'tenant/{name}/quota']} "
                  f"hit_ratio={tel[f'tenant/{name}/hit_ratio']:.2f} "
                  f"evictions={tel[f'tenant/{name}/evictions']} "
                  f"pressure={tel[f'tenant/{name}/pressure']:.2f}")
        print(f"admission: shed={tel['serve/shed']} deferred={tel['serve/deferred']} "
              f"rebalances={tel['serve/rebalances']}")
    if regret is not None:
        agg = regret["aggregate"]
        print(f"opt regret ({agg['accesses']} traced accesses): "
              f"observed={agg['observed']:.2f} opt={agg['opt']:.2f} "
              f"regret={agg['regret']:.2f}")
    print(f"decode graphs: built={tel['compile/decode_loop/count']} "
          f"replays={tel['compile/decode_loop/calls']} "
          f"loop steps={tel.get('serve/loop/steps', 'off')} "
          f"nvcc builds={tel['compile/nvcc/count']}")
    if args.metrics_out:
        with open(args.metrics_out + ".prom", "w") as fh:
            fh.write(prometheus_text(tel))
        if logger is not None:
            logger.stop()  # appends the final JSONL snapshot itself
        else:
            append_jsonl(args.metrics_out + ".jsonl", tel, extra=extra)
        print(f"metrics: wrote {args.metrics_out}.prom, appended {args.metrics_out}.jsonl")
    if server is not None:
        server.stop()
    for rid in sorted(results)[:4]:
        r = results[rid]
        print(f"  req {rid}: cached={r.prefill_cached} status={r.status} "
              f"tokens={r.tokens[:8]}...")
    return results


if __name__ == "__main__":
    main()
