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


KERNELS = {
    "paged_attention": ("src/repro_torch/kernels/csrc/paged_attn.cu",
                        "src/repro/kernels/paged_attn.py:86"),
    "policy_paged_attention": ("src/repro_torch/kernels/csrc/policy_attn.cu",
                               "src/repro/kernels/policy_attn.py:185"),
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
    # launches: each kernel's count on its path in this run: the fused kernel
    # in the serve phase, the unfused kernel in phase 3's unfused chain (the
    # serve loop's fused route does not launch it, as in the reference)
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
    emit({"kernels": kernels})
    print(smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
