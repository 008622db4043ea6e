"""On-card smoke run of the PyTorch / CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``.  Phase by phase, each printing one JSON
line, any failure raising (non-zero exit, no result line):

1. ``build``: compile the CUDA kernels with nvcc (sm_90a) from the sources in
   this checkout; print the seconds taken and the card's name and power
   limit (``nvidia-smi``).
2. ``paged_attention``: the decode-attention kernel at the slice's decode
   shape with the default pool (B=4, P=256, page=64, KVH=5, G=3, hd=64,
   bf16) and at the serve phase's (P=16), against its plain PyTorch
   version (bf16 out within one bf16 ulp, f32 mass within MASS_RTOL);
   kernel, plain and SDPA times beside the byte bound.
3. ``policy_attn``: the fused policy-attention step from a full pool,
   AWRP over 3*page decode steps so every page boundary evicts, at P=256
   and at P=16, and each other page policy over two evicting boundaries at
   P=16: (a) bitwise equal to the unfused chain insert_token +
   paged_attention kernel + score_update, (b) within phase 2's tolerances
   of its plain version, planes equal except at steps where a page's plain
   mass lies within EPS_TAU of tau (counted); the AWRP runs timed like
   phase 2.
4. ``serve``: ``ServeEngine`` on smollm-360m at published widths, bf16,
   paged KV with AWRP through the fused kernel, 4 requests of 1024 seeded
   tokens and 192 greedy new tokens, then one repeated prompt that must hit
   the prefix cache.
5. ``awrp_select``: the two AWRP victim-selection kernels against their
   plain versions, exact equality of the victims, at the sweep's shapes
   (kernel 2) and the serve pool's (kernel 1), tie-heavy and all-invalid
   rows included; timed beside their byte bound.
6. ``sweep``: the paper's Table 1 through ``repro_torch.core.sweep`` on the
   card (equal to the host oracles' table, one kernel-2 launch per trace
   step), a 64-trace grid and a num_sets=2 grid (kernel route == inline
   route == host oracles), the sweep benchmark's 10k-access zipf trace (hit
   counts == host oracles'), and a profile of 50 steady-state grid steps.

Then the kernel summary line, the ``nvidia-smi`` line and, last, the result
line.  Every time is a median of CUDA-event timings on this card.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.cache import paged_kv  # noqa: E402
from repro_torch.configs.smollm_360m import CONFIG  # noqa: E402
from repro_torch.core.kv_policy import PAGE_POLICIES  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.paged_attn import paged_attention_kernel  # noqa: E402
from repro_torch.kernels.policy_attn import policy_paged_attention_kernel  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_FLOPS = 67e12  # H100 SXM float32 peak outside the tensor cores
# bf16 output: kernel and plain round f32 sums that differ only in summation
# order, so they may differ by one bf16 ulp of the value (8-bit significand:
# at most 2**-7 of |value|), plus an f32-level floor for values near 0
OUT_RTOL = 2.0 ** -7
OUT_ATOL = 1e-6
# f32 mass (each row sums to KVH*G over its pages): summation order and exp
# ulps only, a few f32 ulps of the value
MASS_RTOL = 1e-5
MASS_ATOL = 1e-7
EPS_TAU = 1e-5  # a plain mass this close to tau may flip a decision
SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


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


def bound(q, k_pages, rows: int):
    """(bound_ms, bound_by) of one decode step over ``rows`` key rows: each
    K/V row, the query, the output and the planes moved once, against the
    flops of the two products at the float32 peak."""
    B, P, page, KVH, hd = k_pages.shape
    G = q.shape[2]
    esz = k_pages.element_size()
    nbytes = rows * KVH * hd * 2 * esz + 2 * q.numel() * esz + B * P * 4 * 5
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
    res = {"phase": "build", "seconds": time.perf_counter() - t0,
           "nvcc_seconds": info.seconds, "library": str(info.path.name),
           "card": smi()}
    usage = [ln.strip() for ln in info.log.splitlines()
             if "registers" in ln or "spill" in ln]
    res["ptxas"] = usage
    emit(res)
    return res


DECODE_SHAPE = (4, 256, 64, 5, 3, 64)  # B, P, page, KVH, G, hd


def phase_paged_attention(dev, shape=DECODE_SHAPE) -> dict:
    B, P, page, KVH, G, hd = shape
    gen = torch.Generator().manual_seed(SEED)
    q, k, v, ps, _, _ = decode_inputs(gen, B, P, page, KVH, G, hd,
                                      torch.bfloat16, dev, n_free=3)
    cur = torch.full((B,), P * page - 1, dtype=torch.int32, device=dev)
    out, mass = paged_attention_kernel(q, k, v, ps, cur)
    out_p, mass_p = ref.paged_attention_plain(q, k, v, ps, cur)
    torch.cuda.synchronize()
    err_out = (out.float() - out_p.float()).abs().max().item()
    err_mass = (mass - mass_p).abs().max().item()
    out_x = excess(out, out_p, OUT_RTOL, OUT_ATOL)
    mass_x = excess(mass, mass_p, MASS_RTOL, MASS_ATOL)
    assert torch.isfinite(out.float()).all() and torch.isfinite(mass).all()
    assert out_x <= 1.0 and mass_x <= 1.0, (err_out, out_x, err_mass, mass_x)
    bnd, by = bound(q, k, valid_rows(ps, cur, page))
    res = {"phase": "paged_attention", "shape": [B, P, page, KVH, G, hd],
           "dtype": "bfloat16", "max_abs_err_out": err_out,
           "out_err_over_tol": out_x, "mean_abs_out": out_p.float().abs().mean().item(),
           "max_abs_err_mass": err_mass, "mass_err_over_tol": mass_x,
           "max_mass": mass_p.max().item(), "tol_out": [OUT_RTOL, OUT_ATOL],
           "tol_mass": [MASS_RTOL, MASS_ATOL],
           "ms": time_ms(lambda: paged_attention_kernel(q, k, v, ps, cur)),
           "plain_ms": time_ms(lambda: ref.paged_attention_plain(q, k, v, ps, cur),
                               reps=5, warmup=1),
           "bound_ms": bnd, "bound_by": by,
           "library_ms": sdpa_ms(q, k, v, ps, cur)}
    emit(res)
    return res


def _unfused_step(pool, q, nk, nv, pos, page, policy):
    """insert_token + paged_attention kernel + score_update; the page mass
    goes in row 0 of each page so the hit rule's per-page sum is exact."""
    B, P = pool.f.shape
    KVH, G, hd = q.shape[1:]
    pool = paged_kv.insert_token(pool, nk.reshape(B, -1), nv.reshape(B, -1),
                                 pos, page, policy)
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
            nk, nv, pos, pool.f, pool.r, pool.page_start, pool.clock,
            pool.open_slot, policy=policy)
        out_f, mass_f, pool = paged_kv.fused_decode_step(pool, q, nk, nv, pos,
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
    assert launches["policy_paged_attention"] == steps, launches
    assert launches["paged_attention"] == steps, launches
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
        args = (q, kp, vp, nk, nk, pos, pool.f, pool.r, pool.page_start,
                pool.clock, pool.open_slot)
        cur = torch.full((B,), pos, dtype=torch.int32, device=dev)
        # rows read: the pages resident after the allocation, the new row
        # counted once at its page
        after = policy_paged_attention_kernel(*args, policy=policy)[5]
        bnd, by = bound(q, kp, valid_rows(after, cur, page))
        res.update({
            "ms": time_ms(lambda: policy_paged_attention_kernel(*args, policy=policy)),
            "plain_ms": time_ms(lambda: ref.policy_paged_attention_plain(
                *args, policy=policy), reps=5, warmup=1),
            "bound_ms": bnd, "bound_by": by,
            "library_ms": sdpa_ms(q, kp, vp, after, cur)})
    emit(res)
    return res


SERVE_SHAPE = (4, 16, 64, 5, 3, 64)  # the serve phase's pool: 16 pages of 64


def phase_serve(dev, base_cfg=CONFIG, n_req=4, prompt_len=1024, new_tokens=192,
                pages=16) -> dict:
    """smollm-360m at published widths through ServeEngine(fused=True).  The
    one cut: a 16-page pool (1024 tokens), full after prefill, so AWRP
    evicts during decode."""
    from repro_torch.models import model as M
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = dataclasses.replace(base_cfg, bounded_kv_pages=pages, kv_policy="awrp")
    reduced = {"bounded_kv_pages": [base_cfg.bounded_kv_pages, cfg.bounded_kv_pages]}
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(1, cfg.vocab, size=prompt_len).tolist() for _ in range(n_req)]
    max_len = prompt_len + new_tokens
    engine = ServeEngine(cfg, params, max_len=max_len, kv_mode="paged", fused=True,
                         seed=SEED, device=dev)

    ops.reset_launches()
    results = engine.generate([Request(i, list(p), max_new_tokens=new_tokens)
                               for i, p in enumerate(prompts)])
    launches = dict(ops.LAUNCHES)
    stats = dict(engine.stats)
    expect = cfg.n_layers * (new_tokens - 1)
    assert launches["policy_paged_attention"] == expect, (launches, expect)
    for r in results.values():
        assert len(r.tokens) == new_tokens
        assert all(0 <= tok < cfg.vocab for tok in r.tokens)
    assert stats["nonfinite_logits"] == 0, stats
    assert stats["kv_evictions"] > 0, stats

    # one prompt alone twice: the second run must hit the prefix cache
    first = engine.generate([Request(10, list(prompts[0]), max_new_tokens=new_tokens)])
    again = engine.generate([Request(11, list(prompts[0]), max_new_tokens=new_tokens)])
    assert not first[10].prefill_cached and again[11].prefill_cached
    assert engine.prefix_cache.hits == 1
    assert engine.stats["nonfinite_logits"] == 0

    unfused = ServeEngine(cfg, params, max_len=max_len, kv_mode="paged", fused=False,
                          seed=SEED, device=dev)
    ref_res = unfused.generate([Request(i, list(p), max_new_tokens=new_tokens)
                                for i, p in enumerate(prompts)])
    profile = profile_decode(params, cfg, prompts, dev)
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
           "kv_evictions": stats["kv_evictions"],
           "prefix_hit": True, "repeat_tokens_equal": first[10].tokens == again[11].tokens,
           "greedy_agreement_fused_vs_unfused": same / (n_req * new_tokens),
           "unfused_decode_tokens_per_s":
               n_req * (new_tokens - 1) / unfused.stats["decode_s"],
           "decode_step_profile": profile}
    emit(res)
    return res


def profile_decode(params, cfg, prompts, dev, steps: int = 8) -> dict:
    """Where a paged fused decode step's time goes: ``torch.profiler`` over
    ``steps`` steps after a warm-up.  Device time is the sum of the kernels'
    own intervals (one stream, so they do not overlap); the busy share is
    that over the synchronized host wall of the same steps, without the
    profiler (its tracing slows the host side)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import model as M

    tokens = torch.tensor(prompts, dtype=torch.int32, device=dev)
    logits, caches = M.prefill(params, cfg, tokens, tokens.shape[1] + 3 * steps,
                               kv_mode="paged")
    tok = logits[:, -1:].argmax(dim=-1).to(torch.int32)

    def run(n):
        nonlocal caches, tok
        for _ in range(n):
            lg, caches = M.decode_step(params, cfg, tok, caches, kv_mode="paged",
                                       fused=True)
            tok = lg.argmax(dim=-1).to(torch.int32)

    run(steps)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(steps)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(steps)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return {"wall_ms_per_step": wall_ms, "device_ms_per_step": "not measured"}
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / steps
    fused = sum(e.time_range.elapsed_us() for e in kernels
                if "policy_paged_attention" in e.name) / 1e3 / steps
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms_per_step": wall_ms, "device_ms_per_step": busy,
            "device_busy_share": busy / wall_ms,
            "fused_kernel_ms_per_step": fused,
            "kernels_per_step": len(kernels) / steps,
            "top_kernels_ms_per_step": [[n[:80], ms / steps] for n, ms in top]}


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


def _engine(traces, policies, caps, **kw):
    """One engine call on the card: (hits on the host, seconds, launches of
    the rows kernel, host syncs of the core)."""
    from repro_torch.core import policy_core
    from repro_torch.core.torch_policies import simulate_trace_batched

    syncs0 = sum(policy_core.HOST_SYNCS.values())
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    hits = simulate_trace_batched(traces, policies, caps, device="cuda", **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    syncs = sum(policy_core.HOST_SYNCS.values()) - syncs0
    return hits.cpu().numpy(), seconds, launches, syncs


def phase_sweep(dev) -> dict:
    """The Table-1 sweep on the card through ``repro_torch.core.sweep`` and
    the batched engine, AWRP victims through kernel 2; four runs:
    (a) Table 1: six device policies x frame sizes 30..240 on
        ``paper_trace()``, equal to the host oracles' table, one kernel-2
        launch per trace step;
    (b) a 64-trace grid (``paper_trace(seed=s)``, s < 64) x 6 x 8 = 3072
        rows: kernel route == inline route in every hit bit, seeds 0-3 ==
        the host oracles;
    (c) the same at num_sets=2 on 8 seeds: kernel, inline and host agree;
    (d) the sweep benchmark's trace (``trace_zipf(10_000, 2_000, 0.9,
        seed=5)``, ``benchmarks/policy_overhead.py``) x 6 x 8: hit counts
        equal to the host oracles';
    then a ``torch.profiler`` view of 50 steady-state steps of (b)."""
    from repro_torch.core import hit_ratio_table, policy_core, sweep
    from repro_torch.core.policy_core import DEVICE_POLICIES
    from repro_torch.core.traces import paper_trace, trace_zipf

    pols, caps = list(DEVICE_POLICIES), TABLE1_CAPS
    res = {"phase": "sweep", "policies": pols, "caps": caps}

    # (a) Table 1 through the user's entry point
    tr = paper_trace()
    syncs0 = sum(policy_core.HOST_SYNCS.values())
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    table = sweep(pols, tr, caps, torch_device="cuda")
    seconds = time.perf_counter() - t0  # ends in the host pull of the counts
    launches = dict(ops.LAUNCHES)
    syncs = sum(policy_core.HOST_SYNCS.values()) - syncs0
    host = sweep(pols, tr, caps, device=False)
    assert table == host, (table, host)
    assert launches["awrp_select_rows"] == len(tr), launches
    res["table1"] = {"seconds": seconds, "ms_per_step": seconds * 1e3 / len(tr),
                     "steps": len(tr), "launches": launches,
                     "host_syncs_per_step": syncs / len(tr),
                     "equal_to_host_table": True,
                     "hit_ratios": {p: [table[p][c] for c in caps] for p in pols}}
    res["table1_text"] = hit_ratio_table(table, caps).splitlines()

    # (b) the 64-trace grid: kernel route == inline route; seeds 0-3 == host
    grid = np.stack([paper_trace(seed=s) for s in range(64)])
    hk, sk, lk, yk = _engine(grid, pols, caps, use_kernel=True)
    hi, si, li, yi = _engine(grid, pols, caps, use_kernel=False)
    assert (hk == hi).all(), "kernel and inline routes differ on the 64-trace grid"
    assert lk["awrp_select_rows"] == grid.shape[1] and li["awrp_select_rows"] == 0
    for n in range(4):
        for pi, p in enumerate(pols):
            for ci, c in enumerate(caps):
                assert (hk[n, pi, ci] == _host_hits(p, grid[n], c)).all(), (n, p, c)
    res["grid64"] = {"rows": int(np.prod(hk.shape[:3])), "steps": grid.shape[1],
                     "kernel": {"seconds": sk, "ms_per_step": sk * 1e3 / grid.shape[1],
                                "launches": lk, "host_syncs_per_step": yk / grid.shape[1]},
                     "inline": {"seconds": si, "ms_per_step": si * 1e3 / grid.shape[1],
                                "host_syncs_per_step": yi / grid.shape[1]},
                     "kernel_equals_inline": True, "host_checked_traces": 4}

    # (c) num_sets=2 on 8 seeds
    g8 = grid[:8]
    hk2, sk2, lk2, _ = _engine(g8, pols, caps, num_sets=2, use_kernel=True)
    hi2, si2, _, _ = _engine(g8, pols, caps, num_sets=2, use_kernel=False)
    assert (hk2 == hi2).all(), "kernel and inline routes differ at num_sets=2"
    for n in range(8):
        for pi, p in enumerate(pols):
            for ci, c in enumerate(caps):
                assert (hk2[n, pi, ci] == _host_hits(p, g8[n], c, 2)).all(), (n, p, c)
    res["sets2"] = {"rows": int(np.prod(hk2.shape[:3])), "steps": g8.shape[1],
                    "kernel": {"seconds": sk2, "ms_per_step": sk2 * 1e3 / g8.shape[1],
                               "launches": lk2},
                    "inline": {"seconds": si2, "ms_per_step": si2 * 1e3 / g8.shape[1]},
                    "kernel_equals_inline_equals_host": True}

    # (d) the sweep benchmark's trace at its smoke size: hit counts == host
    z = trace_zipf(10_000, 2_000, 0.9, seed=5)
    hz, sz, lz, yz = _engine(z, pols, caps)
    counts = hz[0].sum(-1)
    t0 = time.perf_counter()
    host_counts = np.array([[int(_host_hits(p, z, c).sum()) for c in caps] for p in pols])
    host_s = time.perf_counter() - t0
    assert (counts == host_counts).all(), (counts, host_counts)
    assert lz["awrp_select_rows"] == len(z), lz
    res["zipf10k"] = {"steps": len(z), "seconds": sz, "ms_per_step": sz * 1e3 / len(z),
                      "launches": lz, "host_syncs_per_step": yz / len(z),
                      "host_oracle_seconds": host_s, "counts_equal_to_host": True,
                      "hit_counts": counts.tolist()}
    res["profile_grid64"] = profile_sweep(grid, pols, caps)
    emit(res)
    return res


def profile_sweep(traces, pols, caps, start: int = 500, steps: int = 50) -> dict:
    """Where a sweep step's time goes, in the steady state: steps
    ``[start, start + steps)`` of an engine call on ``traces`` (kernel
    route), once timed on the host clock between two synchronizes and once
    under ``torch.profiler`` (a schedule whose active window is those steps;
    the step counter is a wrapper around ``FlatCore.on_access``, which runs
    once per step).  Device time is the sum of the kernels' intervals (one
    stream, so they do not overlap); the busy share is that over the
    synchronized host wall of the same steps without the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.core import policy_core
    from repro_torch.core.policy_core import FlatCore

    traces = traces[:, :start + steps + 1]
    orig = FlatCore.on_access
    marks, calls, prof = {}, [0], [None]

    def counted(self, *args, **kwargs):
        i = calls[0]
        calls[0] += 1
        if i in (start, start + steps):
            torch.cuda.synchronize()
            marks[i] = (time.perf_counter(), sum(policy_core.HOST_SYNCS.values()),
                        ops.LAUNCHES["awrp_select_rows"])
        if prof[0] is not None:
            prof[0].step()
        return orig(self, *args, **kwargs)

    FlatCore.on_access = counted
    try:
        _engine(traces, pols, caps)
        t0, s0, l0 = marks[start]
        t1, s1, l1 = marks[start + steps]
        calls[0] = 0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=start - 1, warmup=1, active=steps,
                                       repeat=1)) as p:
            prof[0] = p
            _engine(traces, pols, caps)
    finally:
        FlatCore.on_access = orig
    # the schedule's own "ProfilerStep#" annotations also carry the CUDA
    # device type and span each whole step: not kernels
    kernels = [e for e in p.events() if e.device_type == DeviceType.CUDA
               and not e.name.startswith("ProfilerStep")]
    wall_ms = (t1 - t0) * 1e3 / steps
    out = {"rows": int(traces.shape[0] * len(pols) * len(caps)),
           "window": [start, start + steps], "wall_ms_per_step": wall_ms,
           "host_syncs_per_step": (s1 - s0) / steps,
           "awrp_select_rows_launches_per_step": (l1 - l0) / steps}
    if not kernels:
        out["device_ms_per_step"] = "not measured"
        return out
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / steps
    sel = sum(e.time_range.elapsed_us() for e in kernels
              if "awrp_select" in e.name) / 1e3 / steps
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    out.update({"device_ms_per_step": busy, "device_busy_share": busy / wall_ms,
                "kernels_per_step": len(kernels) / steps,
                "awrp_select_rows_ms_per_step": sel,
                "awrp_select_rows_share_of_device": sel / busy if busy else 0.0,
                "top_kernels_ms_per_step": [[n[:80], ms / steps] for n, ms in top]})
    return out


KERNELS = {
    "paged_attention": ("src/repro_torch/kernels/csrc/paged_attn.cu",
                        "src/repro/kernels/paged_attn.py:86"),
    "policy_paged_attention": ("src/repro_torch/kernels/csrc/policy_attn.cu",
                               "src/repro/kernels/policy_attn.py:185"),
    "awrp_select": ("src/repro_torch/kernels/csrc/awrp_select.cu",
                    "src/repro/kernels/awrp_select.py:50"),
    "awrp_select_rows": ("src/repro_torch/kernels/csrc/awrp_select.cu",
                         "src/repro/kernels/awrp_select.py:89"),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    pa = phase_paged_attention(dev)
    phase_paged_attention(dev, SERVE_SHAPE)
    pol = phase_policy_attn(dev)
    # at the serve shape: awrp as the serve phase runs it (3 evicting page
    # boundaries), every other page policy over two evicting boundaries
    page = SERVE_SHAPE[2]
    at_serve = [phase_policy_attn(dev, p, SERVE_SHAPE,
                                  steps=3 * page if p == "awrp" else page + 1,
                                  timed=p == "awrp")
                for p in PAGE_POLICIES]
    srv = phase_serve(dev)
    sel = phase_awrp_select(dev)
    swp = phase_sweep(dev)
    # launches: each kernel's count on its path in this run: the fused kernel
    # in the serve phase, the unfused kernel in phase 3's unfused chain (the
    # serve loop's fused route does not launch it, as in the reference), the
    # rows kernel in the Table-1 sweep (a); kernel 1 is on no path of the
    # port (as in the reference, only tests reach it): 0
    kernels = []
    for name, runs, launches, times, shape in (
            ("paged_attention", [pa], pol["launches"]["paged_attention"], pa,
             DECODE_SHAPE),
            ("policy_paged_attention", at_serve,
             srv["launches"]["policy_paged_attention"], at_serve[0], SERVE_SHAPE)):
        source, replaces = KERNELS[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches,
            "max_abs_err": max(max(r["max_abs_err_out"], r["max_abs_err_mass"])
                               for r in runs),
            "ms": times["ms"], "plain_ms": times["plain_ms"],
            "bound_ms": times["bound_ms"], "bound_by": times["bound_by"],
            "library_ms": times["library_ms"], "shape": list(shape)})
    for name in ("awrp_select", "awrp_select_rows"):
        source, replaces = KERNELS[name]
        main_run = sel["kernels"][name][0]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": swp["table1"]["launches"][name],
            "max_abs_err": 0,  # integer victims, compared for equality
            "ms": main_run["ms"], "plain_ms": main_run["plain_ms"],
            "bound_ms": main_run["bound_ms"], "bound_by": main_run["bound_by"],
            "library_ms": None, "shape": [main_run["B"], main_run["P"]],
            "other_shapes": [{k: r[k] for k in ("B", "P", "ms", "plain_ms", "bound_ms")}
                             for r in sel["kernels"][name][1:2]]})
    emit({"kernels": kernels})
    print(smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
