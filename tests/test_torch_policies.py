"""The port's host oracles and trace generators (``repro_torch.core.policies``
/ ``traces``) against the reference's, exactly, plus the reference's own
policy suites (``tests/test_policies.py``, ``tests/test_adaptive_policies.py``)
run on the port's classes.

Every comparison is exact: generator outputs array-equal, hit sequences and
resident sets equal, ARC/CAR's float32 ``p`` equal."""

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import policies as jpol  # noqa: E402
from repro.core import traces as jtr  # noqa: E402
from repro_torch.core import (  # noqa: E402
    ARC,
    AWRP,
    CAR,
    OPT,
    POLICIES,
    make_policy,
    simulate,
    sweep,
)
from repro_torch.core import traces as ttr  # noqa: E402

ALL = sorted(POLICIES)

#: two argument sets per generator beside its defaults
TRACE_ARGS = {
    "matmul": [dict(n=6), dict(n=8, tile=3, base_stride=512)],
    "mergesort": [dict(n=64, seed=3), dict(n=100, seed=1, base=7)],
    "hashjoin": [dict(n_build=40, n_probe=90, n_buckets=16, seed=2),
                 dict(n_build=10, n_probe=30, n_buckets=4, seed=9)],
    "zipf": [dict(n_accesses=2000, n_blocks=300, alpha=1.1, seed=4),
             dict(n_accesses=500, n_blocks=50, alpha=0.0, seed=1)],
    "markov": [dict(n_accesses=1500, n_regions=4, region_size=16, p_stay=0.8, seed=2),
               dict(n_accesses=700, seed=5)],
    "scan_mix": [dict(n_accesses=3000, hot_blocks=40, scan_blocks=200, scan_every=400,
                      scan_len=90, alpha=0.7, seed=3),
                 dict(n_accesses=999, seed=8)],
    "paper": [dict(seed=5), dict(seed=1, n=700, hot=60, alpha=1.0, scan_frac=0.2, burst=9)],
}


def test_trace_registry_matches():
    assert list(ttr.TRACES) == list(jtr.TRACES)
    assert set(TRACE_ARGS) == set(ttr.TRACES)


@pytest.mark.parametrize("which", [0, 1, 2])
@pytest.mark.parametrize("name", sorted(TRACE_ARGS))
def test_trace_generators_equal_reference(name, which):
    kw = {} if which == 0 else TRACE_ARGS[name][which - 1]
    got = ttr.TRACES[name](**kw)
    want = jtr.TRACES[name](**kw)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_multi_tenant_trace_equals_reference():
    for kw in ({}, dict(n_accesses=900, n_tenants=2, working_set=50, alphas=(0.9, 0.0),
                        mix=(0.7, 0.3), phase_at=0.3, phase_shift=11, seed=4)):
        for a, b in zip(ttr.trace_multi_tenant(**kw), jtr.trace_multi_tenant(**kw)):
            np.testing.assert_array_equal(a, b)


def _replay(module, name, trace, cap):
    p = module.make_policy(name, cap)
    if isinstance(p, module.OPT):
        p.prepare(trace)
    hits = [p.access(int(b)) for b in trace]
    return hits, p


@pytest.mark.parametrize("cap", [4, 30, 120])
@pytest.mark.parametrize("name", ALL)
def test_host_oracles_equal_reference(name, cap):
    """Every host oracle's hit sequence, resident set and counters equal
    the reference's on every TRACES generator (first 1500 accesses)."""
    assert set(POLICIES) == set(jpol.POLICIES)
    from repro_torch.core import policies as tpol

    for trace_name, gen in ttr.TRACES.items():
        trace = gen()[:1500]
        got_hits, got = _replay(tpol, name, trace, cap)
        want_hits, want = _replay(jpol, name, trace, cap)
        assert got_hits == want_hits, (trace_name, name, cap)
        assert got.resident_set() == want.resident_set(), (trace_name, name, cap)
        assert (got.hits, got.accesses) == (want.hits, want.accesses)
        if name in ("arc", "car"):
            assert np.float32(got.p).view(np.int32) == np.float32(want.p).view(np.int32)


def test_unknown_policy_message():
    with pytest.raises(ValueError, match="unknown policy"):
        make_policy("bogus", 4)


# ---------------------------------------------------------------------------
# tests/test_policies.py, on the port's oracles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ALL)
def test_cold_miss_then_hit(name):
    p = make_policy(name, 4)
    if isinstance(p, OPT):
        p.prepare([1, 1])
    assert p.access(1) is False
    assert p.access(1) is True
    assert p.hit_ratio == 0.5


@pytest.mark.parametrize("name", ALL)
def test_capacity_never_exceeded(name):
    rng = np.random.RandomState(0)
    trace = rng.randint(0, 50, size=500)
    p = make_policy(name, 8)
    if isinstance(p, OPT):
        p.prepare(trace)
    for b in trace:
        p.access(int(b))
    assert len(p.resident_set()) <= 8


@pytest.mark.parametrize("name", ALL)
def test_fits_entirely_no_capacity_misses(name):
    trace = [0, 1, 2, 3] * 25
    p = make_policy(name, 8)
    if isinstance(p, OPT):
        p.prepare(trace)
    assert sum(0 if p.access(b) else 1 for b in trace) == 4


def test_awrp_weight_function_matches_paper_eq1():
    p = AWRP(2)
    p.access(10)
    p.access(11)
    p.access(10)
    # clock 4 miss: W(10) = 2/(4-3) = 2.0 ; W(11) = 1/(4-2) = 0.5 -> evict 11
    p.access(12)
    assert p.resident_set() == {10, 12}


def test_awrp_prefers_frequent_over_recent_scan():
    p = AWRP(3)
    for _ in range(10):
        p.access(1)
    p.access(2)
    p.access(3)
    p.access(4)
    assert 1 in p.resident_set() and 2 not in p.resident_set()


def test_awrp_scan_resistance_beats_lru():
    tr = ttr.trace_scan_mix(6000, hot_blocks=64, scan_blocks=400, seed=3)
    assert simulate("awrp", tr, 96).hit_ratio > simulate("lru", tr, 96).hit_ratio


def test_opt_dominates_everything():
    tr = ttr.trace_zipf(3000, 300, 0.9, seed=7)
    opt = simulate("opt", tr, 64).hit_ratio
    for name in ("lru", "fifo", "awrp", "car", "arc", "lfu"):
        assert opt >= simulate(name, tr, 64).hit_ratio - 1e-12


def test_paper_qualitative_claims_hold_on_paper_trace():
    """AWRP >= LRU and FIFO at every Table-1 frame size (host path)."""
    tr = ttr.paper_trace()
    caps = [30, 60, 90, 120, 150, 180, 210]
    res = sweep(["lru", "fifo", "car", "awrp"], tr, caps, device=False)
    for c in caps:
        assert res["awrp"][c] >= res["lru"][c] and res["awrp"][c] >= res["fifo"][c]
    assert abs(np.mean([res["awrp"][c] - res["car"][c] for c in caps])) < 0.05


@pytest.mark.parametrize("num_sets", [1, 4])
def test_simulate_equals_reference(num_sets):
    from repro.core.simulator import simulate as jsimulate

    tr = ttr.paper_trace()
    for name in ("awrp", "2q", "opt", "random"):
        for block_size in (1, 3):
            got = simulate(name, tr, 120, num_sets=num_sets, block_size=block_size)
            want = jsimulate(name, tr, 120, num_sets=num_sets, block_size=block_size)
            assert (got.hits, got.accesses, got.hit_ratio, got.miss_ratio) == (
                want.hits, want.accesses, want.hit_ratio, want.miss_ratio)
    with pytest.raises(ValueError, match="not divisible"):
        simulate("awrp", tr, 10, num_sets=4)
    assert simulate("awrp", [], 4).hit_ratio == 0.0


@pytest.mark.parametrize("seed", range(6))
def test_property_protocol(seed):
    """Random traces and caps (the reference's hypothesis properties,
    sampled): resident bound, counters, the last block resident, hit iff
    resident before, AWRP == WRP decisions, OPT an upper bound."""
    rng = np.random.RandomState(seed)
    trace = rng.randint(0, 41, size=rng.randint(1, 400)).tolist()
    cap = int(rng.randint(2, 17))
    for name in ("awrp", "lru", "fifo", "lfu", "arc", "car", "2q", "aawrp"):
        p = make_policy(name, cap)
        hits = 0
        for b in trace:
            was = b in p.resident_set()
            h = p.access(b)
            assert h == was, (name, b)
            hits += h
        assert len(p.resident_set()) <= cap and p.hits == hits
        assert p.accesses == len(trace) and trace[-1] in p.resident_set()
    a, w = make_policy("awrp", cap), make_policy("wrp", cap)
    assert [a.access(b) for b in trace] == [w.access(b) for b in trace]
    opt = simulate("opt", np.array(trace), cap).hits
    for name in ("awrp", "lru", "fifo", "lfu", "arc", "car"):
        assert simulate(name, np.array(trace), cap).hits <= opt


def test_aawrp_adapts_and_stays_correct():
    from repro_torch.core.policies import AAWRP

    zipf = ttr.trace_zipf(3000, 200, 1.1, seed=3)
    loop = np.tile(np.arange(90), 34)[:3000]
    trace = np.concatenate([zipf, loop, zipf[::-1], loop])
    a = AAWRP(64)
    hits_a = sum(a.access(int(b)) for b in trace)
    assert len(a.resident_set()) <= 64 and a.rung in (0, 1, 2)
    p = make_policy("awrp", 64)
    hits_p = sum(p.access(int(b)) for b in trace)
    assert hits_a >= hits_p * 0.80, (hits_a, hits_p)


# ---------------------------------------------------------------------------
# tests/test_adaptive_policies.py, on the port's oracles
# ---------------------------------------------------------------------------


def test_arc_ghost_hit_p_updates_and_list_moves():
    a = ARC(2)
    a.access(1)
    a.access(2)
    assert list(a.T1) == [1, 2] and not a.T2
    assert a.access(1) is True
    assert list(a.T1) == [2] and list(a.T2) == [1]
    assert a.access(3) is False
    assert list(a.T1) == [3] and list(a.T2) == [1]
    assert list(a.B1) == [2] and a.p == 0.0
    assert a.access(2) is False
    assert a.p == 1.0
    assert list(a.T1) == [3] and list(a.T2) == [2]
    assert list(a.B1) == [] and list(a.B2) == [1]
    assert a.access(1) is False
    assert a.p == 0.0
    assert list(a.T2) == [2, 1] and list(a.B2) == []


def test_arc_ghost_delta_is_ratio_of_ghost_sizes():
    a = ARC(3)
    for b in (1, 2, 3):
        a.access(b)
        a.access(b)
    for b in (4, 5, 6, 7, 8):
        a.access(b)
    assert list(a.T1) == [8] and list(a.T2) == [2, 3]
    assert list(a.B1) == [6, 7] and list(a.B2) == [1]
    a.access(6)
    assert a.p == 1.0 and list(a.B1) == [7] and list(a.B2) == [1, 2]
    a.access(7)
    assert a.p == 3.0 and list(a.B1) == [] and list(a.B2) == [1, 2, 3]
    a.access(1)
    assert a.p == 2.0


def test_car_ref_bit_promotion_and_ghost_hit():
    c = CAR(2)
    c.access(1)
    c.access(2)
    assert c.access(1) is True
    assert c.T1.ref == {1: True, 2: False} and list(c.T1.q) == [1, 2]
    assert c.access(3) is False
    assert list(c.T1.q) == [3] and list(c.T2.q) == [1] and list(c.B1) == [2]
    assert c.access(2) is False  # B1 ghost hit: sweep first, then p
    assert c.p == 1.0 and list(c.T2.q) == [1, 2] and list(c.B1) == [3]


def test_adaptive_bounds_and_directory_invariants():
    a, c = ARC(4), CAR(4)
    rng = np.random.RandomState(1)
    for b in rng.randint(0, 16, size=800):
        a.access(int(b))
        c.access(int(b))
        for x in (a, c):
            assert 0.0 <= x.p <= 4
            assert len(x.T1) + len(x.T2) <= 4
            assert len(x.T1) + len(x.T2) + len(x.B1) + len(x.B2) <= 8
        assert len(c.T1) + len(c.B1) <= 5
