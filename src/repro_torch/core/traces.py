"""Deterministic memory-address trace generators (a numpy-only copy of
``repro/core/traces.py``; the port keeps its own so it never imports the
reference).

The paper evaluates on "a list of one thousand memory addresses produced by a
real program" (data addresses only). That trace is unpublished, so we generate
address streams by *actually running* small real algorithms and recording the
data addresses they touch, plus standard synthetic locality models used in the
replacement-policy literature (zipf, markov working-set, sequential-scan
pollution).

All generators are deterministic given their arguments (no global RNG).
Addresses are abstract word addresses; the simulator maps them to blocks with
``block_size``.
"""

from __future__ import annotations

from typing import List

import numpy as np

__all__ = [
    "trace_matmul",
    "trace_mergesort",
    "trace_hashjoin",
    "trace_zipf",
    "trace_markov",
    "trace_scan_mix",
    "trace_multi_tenant",
    "paper_trace",
    "TRACES",
]


# ---------------------------------------------------------------------------
# "real program" traces — record data addresses of actual algorithm runs
# ---------------------------------------------------------------------------


def trace_matmul(n: int = 12, tile: int = 0, base_stride: int = 4096) -> np.ndarray:
    """Data-address trace of (optionally blocked) n×n matrix multiply
    C = A @ B.  Row-major layout; one address per scalar access, in the exact
    order a naive 3-loop (or tiled 6-loop) implementation touches memory."""
    A, B, C = 0 * base_stride, 1 * base_stride, 2 * base_stride
    out: List[int] = []
    rng = range(n)
    if tile <= 0:
        for i in rng:
            for j in rng:
                for k in rng:
                    out.append(A + i * n + k)
                    out.append(B + k * n + j)
                out.append(C + i * n + j)
    else:
        t = tile
        for ii in range(0, n, t):
            for jj in range(0, n, t):
                for kk in range(0, n, t):
                    for i in range(ii, min(ii + t, n)):
                        for j in range(jj, min(jj + t, n)):
                            for k in range(kk, min(kk + t, n)):
                                out.append(A + i * n + k)
                                out.append(B + k * n + j)
                            out.append(C + i * n + j)
    return np.asarray(out, dtype=np.int64)


def trace_mergesort(n: int = 256, seed: int = 0, base: int = 0) -> np.ndarray:
    """Data-address trace of bottom-up mergesort on an n-element array (reads
    of the two runs + writes of the merged output into a scratch buffer)."""
    rng = np.random.RandomState(seed)
    arr = rng.randint(0, 1 << 30, size=n).tolist()
    scratch_base = base + n
    out: List[int] = []
    width = 1
    a = arr
    while width < n:
        b = [0] * n
        for lo in range(0, n, 2 * width):
            mid, hi = min(lo + width, n), min(lo + 2 * width, n)
            i, j, k = lo, mid, lo
            while i < mid and j < hi:
                out.append(base + i)
                out.append(base + j)
                if a[i] <= a[j]:
                    b[k] = a[i]
                    i += 1
                else:
                    b[k] = a[j]
                    j += 1
                out.append(scratch_base + k)
                k += 1
            while i < mid:
                out.append(base + i)
                b[k] = a[i]
                out.append(scratch_base + k)
                i += 1
                k += 1
            while j < hi:
                out.append(base + j)
                b[k] = a[j]
                out.append(scratch_base + k)
                j += 1
                k += 1
        a = b
        width *= 2
    return np.asarray(out, dtype=np.int64)


def trace_hashjoin(
    n_build: int = 128, n_probe: int = 512, n_buckets: int = 64, seed: int = 1
) -> np.ndarray:
    """Hash-join: build phase writes a bucket table, probe phase does random
    reads into it — a classic mixed sequential/random database access pattern
    (the paper motivates database servers as an application)."""
    rng = np.random.RandomState(seed)
    build_base, table_base, probe_base = 0, 10_000, 20_000
    out: List[int] = []
    keys = rng.randint(0, 1 << 20, size=n_build)
    for i, k in enumerate(keys):
        out.append(build_base + i)  # read build tuple
        out.append(table_base + int(k) % n_buckets)  # write bucket head
    probes = rng.choice(keys, size=n_probe, replace=True)
    for i, k in enumerate(probes):
        out.append(probe_base + i)  # read probe tuple
        out.append(table_base + int(k) % n_buckets)  # read bucket
        out.append(build_base + int(np.where(keys == k)[0][0]))  # fetch match
    return np.asarray(out, dtype=np.int64)


# ---------------------------------------------------------------------------
# synthetic locality models
# ---------------------------------------------------------------------------


def trace_zipf(
    n_accesses: int = 10_000, n_blocks: int = 1_000, alpha: float = 0.8, seed: int = 0
) -> np.ndarray:
    """Zipf(alpha)-distributed accesses over ``universe`` blocks — the
    skewed-popularity workload (alpha=0 degenerates to uniform)."""
    rng = np.random.RandomState(seed)
    ranks = np.arange(1, n_blocks + 1, dtype=np.float64)
    p = ranks ** (-alpha)
    p /= p.sum()
    return rng.choice(n_blocks, size=n_accesses, p=p).astype(np.int64)


def trace_markov(
    n_accesses: int = 10_000,
    n_regions: int = 8,
    region_size: int = 64,
    p_stay: float = 0.95,
    seed: int = 0,
) -> np.ndarray:
    """Working-set model: the program lives in one region (uniform accesses
    within it) and occasionally jumps to another — phase-change behaviour that
    frequency-only policies (LFU) handle badly."""
    rng = np.random.RandomState(seed)
    out = np.empty(n_accesses, dtype=np.int64)
    region = 0
    for t in range(n_accesses):
        if rng.rand() > p_stay:
            region = rng.randint(n_regions)
        out[t] = region * region_size + rng.randint(region_size)
    return out


def trace_scan_mix(
    n_accesses: int = 10_000,
    hot_blocks: int = 100,
    scan_blocks: int = 500,
    scan_every: int = 1_000,
    scan_len: int = 250,
    alpha: float = 1.0,
    seed: int = 0,
) -> np.ndarray:
    """Zipf-hot working set polluted by periodic one-time sequential scans —
    the scan-resistance scenario where LRU famously collapses (paper §2)."""
    rng = np.random.RandomState(seed)
    ranks = np.arange(1, hot_blocks + 1, dtype=np.float64)
    p = ranks ** (-alpha)
    p /= p.sum()
    out: List[int] = []
    scan_pos = hot_blocks
    while len(out) < n_accesses:
        out.extend(
            rng.choice(hot_blocks, size=min(scan_every, n_accesses - len(out)), p=p)
        )
        remaining = n_accesses - len(out)
        if remaining <= 0:
            break
        for i in range(min(scan_len, remaining)):
            out.append(hot_blocks + (scan_pos - hot_blocks + i) % scan_blocks)
        scan_pos += scan_len
    return np.asarray(out[:n_accesses], dtype=np.int64)


def trace_multi_tenant(
    n_accesses: int = 10_000,
    n_tenants: int = 3,
    working_set: int = 200,
    alphas=(1.2, 0.8, 0.0),
    mix=None,
    phase_at: float = 0.5,
    phase_shift: int = 97,
    seed: int = 0,
):
    """Interleaved multi-tenant stream: ``n_tenants`` competing request
    streams with DISJOINT working sets (tenant t lives in
    ``[t*working_set, (t+1)*working_set)``) and per-tenant zipf skews
    (``alphas[t]``; 0.0 = uniform — the no-locality tenant adaptive
    policies should learn to stop caching for).  ``mix`` is the per-tenant
    interleave probability (default uniform).  At ``phase_at`` every
    tenant's hot set rotates by ``phase_shift`` addresses within its own
    region — the phase-change moment where frequency-only rankings go
    stale and the adaptive/tenancy machinery has to re-rank.

    Returns ``(tenant_ids, addresses)`` — two aligned int64 arrays; demux
    with ``addresses[tenant_ids == t]`` to replay one tenant's stream
    against a host oracle (the property-test contract for the tenancy
    manager's per-row accounting)."""
    if len(alphas) < n_tenants:
        raise ValueError(f"need {n_tenants} alphas, got {len(alphas)}")
    rng = np.random.RandomState(seed)
    mix = np.full(n_tenants, 1.0 / n_tenants) if mix is None else np.asarray(
        mix, dtype=np.float64)
    mix = mix / mix.sum()
    probs = []
    for t in range(n_tenants):
        a = float(alphas[t])
        ranks = np.arange(1, working_set + 1, dtype=np.float64)
        p = ranks ** (-a) if a > 0 else np.ones(working_set)
        probs.append(p / p.sum())
    tenant_ids = rng.choice(n_tenants, size=n_accesses, p=mix)
    offsets = rng.rand(n_accesses)  # one uniform draw per access, reused
    out = np.empty(n_accesses, dtype=np.int64)
    switch = int(n_accesses * phase_at)
    for t in range(n_tenants):
        sel = tenant_ids == t
        # inverse-CDF sampling from this tenant's zipf ranks
        cdf = np.cumsum(probs[t])
        local = np.searchsorted(cdf, offsets[sel], side="right")
        local = np.minimum(local, working_set - 1)
        # phase change: rotate the rank->address map within the region
        idx = np.where(sel)[0]
        shifted = (local + phase_shift) % working_set
        local = np.where(idx >= switch, shifted, local)
        out[idx] = t * working_set + local
    return tenant_ids.astype(np.int64), out


# ---------------------------------------------------------------------------
# the paper-scale trace
# ---------------------------------------------------------------------------


def paper_trace(
    seed: int = 0,
    n: int = 1000,
    hot: int = 130,
    alpha: float = 0.8,
    scan_frac: float = 0.12,
    burst: int = 15,
) -> np.ndarray:
    """A 1000-address data trace standing in for the paper's unpublished
    'real program' trace: a zipf-skewed hot working set (database buffer /
    loop-nest reuse) polluted by periodic one-time sequential scans.

    Calibrated (EXPERIMENTS.md §Repro) so frame sizes 30..240 span the
    paper's hit-ratio band (39%..75.7% here vs Table 1's 41.9%..75.4%) and
    the paper's qualitative ordering holds at seed 0: AWRP ≥ LRU and FIFO at
    every frame size, AWRP ≈ CAR with ties at 180/210 (the paper itself
    reports a CAR win at 180 and a tie at 210)."""
    rng = np.random.RandomState(seed)
    ranks = np.arange(1, hot + 1, dtype=np.float64)
    p = ranks ** (-alpha)
    p /= p.sum()
    n_scan = int(n * scan_frac)
    n_hot = n - n_scan
    hot_stream = rng.choice(hot, size=n_hot, p=p)
    n_bursts = max(1, n_scan // burst)
    out: List[int] = []
    hi, sp = 0, 0
    gap = n_hot // (n_bursts + 1)
    for _ in range(n_bursts):
        out.extend(hot_stream[hi : hi + gap])
        hi += gap
        out.extend(hot + sp + i for i in range(burst))  # one-time addresses
        sp += burst
    out.extend(hot_stream[hi:])
    return np.asarray(out[:n], dtype=np.int64)


TRACES = {
    "matmul": trace_matmul,
    "mergesort": trace_mergesort,
    "hashjoin": trace_hashjoin,
    "zipf": trace_zipf,
    "markov": trace_markov,
    "scan_mix": trace_scan_mix,
    "paper": paper_trace,
}
