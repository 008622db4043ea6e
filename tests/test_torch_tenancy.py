"""The port's tenancy layer (``repro_torch/serve/tenancy.py``) against the JAX
reference (``repro/serve/tenancy.py``) and the host oracles, on the CPU.

The same seeded streams go through the port's ``TenantCacheManager`` (on the
CPU the stream mode's plain version, ``ref.flat_stream_plain`` /
``ref.adaptive_stream_plain``: a loop of masked ``on_access_counted``
calls) and the JAX manager (one jitted ``lax.scan``).  Hit bits, every
state plane, the counters and the pressure plane (bitwise), quotas and
evicted keys must be equal: for all six policies, after rebalances, with a
forced stamp renormalization, for ``access`` against ``access_stream``, and
for ``decide_batch`` against the host loop and JAX's.  The pressure EWMA's
rounding (one fused multiply-add, as XLA compiles the reference's step) is
pinned on its own.  The ``cuda``-marked cases hold the stream kernels to
their plain versions on a card and skip without one."""

import dataclasses
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _propcheck import given, settings, st  # noqa: E402
from repro.core.traces import trace_multi_tenant  # noqa: E402
from repro.serve import tenancy as jt  # noqa: E402
from repro_torch.core.policies import make_policy  # noqa: E402
from repro_torch.core.policy_core import (AdaptiveCore, FlatCore, _f32_of_sum,  # noqa: E402
                                          pressure_ewma)
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.serve.tenancy import (ACCEPT, DEFER, SHED, AdmissionController,  # noqa: E402
                                       TenantCacheManager, TenantPrefixCache)

torch.set_num_threads(2)

POLICIES = ["awrp", "lru", "fifo", "lfu", "arc", "car"]
TENANTS = ("alpha", "beta", "gamma")


def managers(quotas, policy, **kw):
    """(port manager on the CPU, JAX manager) with the same spec."""
    q = dict(zip(TENANTS, quotas)) if not isinstance(quotas, dict) else quotas
    return (TenantCacheManager(q, policy, device="cpu", **kw),
            jt.TenantCacheManager(q, policy, **kw))


def assert_same(tm, jm, where=""):
    """Planes, counters (pressure as its bits), host mirrors, quotas and
    tenant-altitude metadata of the two managers are equal."""
    for name, a, b in zip(tm.state._fields, tm.state, jm.state):
        assert np.array_equal(a.numpy(), np.asarray(b)), (where, name)
    for name, a, b in zip(tm.counters._fields, tm.counters, jm.counters):
        assert np.array_equal(a.numpy(), np.asarray(b)), (where, name)
    assert tm._pressure.tobytes() == jm._pressure.tobytes(), where
    assert tm.quotas == jm.quotas, where
    assert tm._tclock == jm._tclock and (tm._tf == jm._tf).all() and (tm._tr == jm._tr).all()


def oracle_replay(policy, quotas, tenant_rows, keys):
    """Host ground truth: one port host oracle per tenant on its demuxed
    stream; per-tenant (hits, misses, evictions)."""
    oracles = [make_policy(policy, q) for q in quotas]
    stats = [[0, 0, 0] for _ in quotas]
    for r, k in zip(tenant_rows, keys):
        o = oracles[r]
        before = o.resident_set()
        hit = o.access(int(k))
        stats[r][0] += int(hit)
        stats[r][1] += int(not hit)
        stats[r][2] += len(before - o.resident_set())
    return stats


def assert_rows_match_oracles(tm, policy, quotas, tenant_rows, keys):
    rows = tm.row_telemetry()
    for r, (h, m, e) in enumerate(oracle_replay(policy, quotas, tenant_rows, keys)):
        assert (int(rows["hits"][r]), int(rows["misses"][r]), int(rows["evictions"][r])) \
            == (h, m, e), (policy, r)


def stream(n=600, seed=11, working_set=40):
    rows, addrs = trace_multi_tenant(n, n_tenants=3, working_set=working_set, seed=seed)
    return rows, addrs % 1000


# ---------------------------------------------------------------------------
# access_stream == the JAX manager == the host oracles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", POLICIES)
def test_stream_equals_reference_and_host_oracles(policy):
    rows, keys = stream()
    quotas = (4, 7, 3)
    tm, jm = managers(quotas, policy)
    th, jh = tm.access_stream(rows, keys), jm.access_stream(rows, keys)
    assert th.dtype == np.bool_ and np.array_equal(th, np.asarray(jh))
    assert_same(tm, jm)
    assert_rows_match_oracles(tm, policy, quotas, rows, keys)
    assert tm.telemetry() == jm.telemetry()
    assert float(tm._pressure.max()) > 0.2  # the signal moved


@pytest.mark.parametrize("policy", ["awrp", "lfu", "arc"])
def test_wide_quotas_equal_reference(policy):
    """Quotas (200, 100, 40): the flat rows pad to 340 lanes, above the
    stream kernel's 256-lane register path."""
    rows, keys = stream(900, seed=3, working_set=400)
    tm, jm = managers((200, 100, 40), policy)
    assert np.array_equal(tm.access_stream(rows, keys), np.asarray(jm.access_stream(rows, keys)))
    assert_same(tm, jm)
    assert_rows_match_oracles(tm, policy, (200, 100, 40), rows, keys)


@settings(max_examples=6, deadline=None)
@given(
    seed=st.integers(min_value=0, max_value=10_000),
    q0=st.integers(min_value=1, max_value=6),
    q1=st.integers(min_value=1, max_value=6),
    q2=st.integers(min_value=1, max_value=6),
    universe=st.integers(min_value=4, max_value=30),
)
def test_row_accounting_property_flat_and_adaptive(seed, q0, q1, q2, universe):
    rng = np.random.RandomState(seed)
    rows = rng.randint(0, 3, size=160)
    keys = rng.randint(0, universe, size=160)
    for policy in ("awrp", "arc"):
        tm, jm = managers((q0, q1, q2), policy)
        assert np.array_equal(tm.access_stream(rows, keys),
                              np.asarray(jm.access_stream(rows, keys)))
        assert_same(tm, jm, (policy, seed))
        assert_rows_match_oracles(tm, policy, (q0, q1, q2), rows, keys)


@pytest.mark.parametrize("policy", ["arc", "car"])
def test_forced_renormalization_equals_reference(policy):
    """``renorm_at=64``: stamps renormalize every few accesses, in rows the
    access does not touch too; the stream ends with one tenant alone, so the
    others end renormalized by its accesses only."""
    rows, keys = stream(500, seed=5)
    rows = np.concatenate([rows, np.zeros(40, dtype=rows.dtype)])
    keys = np.concatenate([keys, np.arange(40) % 9])
    tm, jm = managers((4, 7, 3), policy)
    tm.core = dataclasses.replace(tm.core, renorm_at=64)
    jm.core = dataclasses.replace(jm.core, renorm_at=64)
    jm._step, jm._stream = jm._jit_step(), jm._jit_stream()
    assert np.array_equal(tm.access_stream(rows, keys), np.asarray(jm.access_stream(rows, keys)))
    assert_same(tm, jm)
    assert int(tm.state.ctr.max()) < 64 + 2 * max(tm.core.caps) + 4
    assert_rows_match_oracles(tm, policy, (4, 7, 3), rows, keys)


@pytest.mark.parametrize("policy", ["awrp", "lru", "fifo", "lfu"])
def test_chunks_with_rebalances_equal_reference(policy):
    """The stream in 6 chunks, a rebalance toward the most pressured tenant
    between chunks: quotas, evicted keys, planes, counters and the
    rebalance's pressure fold equal JAX's."""
    rows, keys = stream(600, seed=7)
    tm, jm = managers((6, 6, 6), policy)
    moved_any = False
    for i, (r, k) in enumerate(zip(np.array_split(rows, 6), np.array_split(keys, 6))):
        assert np.array_equal(tm.access_stream(r, k), np.asarray(jm.access_stream(r, k)))
        to = TENANTS[int(np.argmax(jm._pressure))]
        got, want = tm.rebalance(to, 2), jm.rebalance(to, 2)
        assert got == want, i
        moved_any |= bool(got[1])
        assert_same(tm, jm, i)
    assert moved_any  # some shrink evicted, so the pressure fold ran


def test_rebalance_fold_is_the_unfused_expression():
    """The rebalance's fold runs op by op in the reference (eager, outside
    jit): two float32 roundings, not the access step's fused one.  A shrink
    that evicts 3 keys from a row at pressure p: JAX's bits are
    ``f32(f32((1 - a) * p) + f32(a * 3))``, and the port's equal them."""
    tm, jm = managers({"v": 6, "w": 1}, "lru")
    rng = np.random.RandomState(1)
    r, k = np.zeros(30, np.int32), rng.randint(0, 12, size=30)
    tm.access_stream(r, k), jm.access_stream(r, k)
    p = np.float32(jm._pressure[0])
    a = np.float32(0.1)
    assert tm.rebalance("w", 3) == jm.rebalance("w", 3)
    unfused = np.float32(np.float32((np.float32(1) - a) * p) + np.float32(a * np.float32(3)))
    assert jm._pressure[0] == unfused
    assert tm._pressure.tobytes() == jm._pressure.tobytes()


# ---------------------------------------------------------------------------
# the pressure EWMA's rounding
# ---------------------------------------------------------------------------


def fma32(a, b, c) -> np.float32:
    """fma(a, b, c) of float32 values, rounded once (exact rationals)."""
    ex = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    f = np.float32(float(ex))
    near = [np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))]
    return min(near, key=lambda x: (abs(Fraction(float(x)) - ex),
                                    int(np.array(x).view(np.int32)) & 1))


def test_pressure_ewma_is_one_fused_multiply_add():
    """The JAX manager's pressure at the default alpha = 0.1, access by
    access, is ``fma(1 - a, p, a * e)`` rounded once; the unfused
    ``(1 - a) * p + a * e`` and ``fma(a, e, (1 - a) * p)`` miss its bits on
    this stream.  The port's ``pressure_ewma`` gives the fused bits."""
    jm = jt.TenantCacheManager({"a": 3, "b": 2}, "lru")
    rng = np.random.RandomState(0)
    a = np.float32(0.1)
    one_a = np.float32(1) - a
    fused, unfused, other = (np.zeros(2, np.float32) for _ in range(3))
    same = {"fused": True, "unfused": True, "other": True}
    for r, k in zip(rng.randint(0, 2, 400), rng.randint(0, 9, 400)):
        before = int(np.asarray(jm.counters.evictions)[r])
        p_before = np.float32(jm._pressure[r])
        jm.access(jm.tenants[r], int(k))
        e = np.float32(int(np.asarray(jm.counters.evictions)[r]) - before)
        fused[r] = fma32(one_a, fused[r], a * e)
        unfused[r] = np.float32(one_a * unfused[r]) + np.float32(a * e)
        other[r] = fma32(a, e, np.float32(one_a * other[r]))
        port = pressure_ewma(torch.tensor([p_before]), torch.tensor([int(e)], dtype=torch.int32),
                             0.1)
        assert port.numpy().tobytes() == np.float32(jm._pressure[r]).tobytes()
        for name, v in (("fused", fused), ("unfused", unfused), ("other", other)):
            same[name] &= v.tobytes() == jm._pressure.tobytes()
    assert same == {"fused": True, "unfused": False, "other": False}


def test_fused_sum_rounds_once_through_float64_ties():
    """Where the float64 sum lands on a float32 midpoint that the exact sum
    is not on, a plain float64 -> float32 conversion rounds twice and picks
    the wrong neighbour; ``_f32_of_sum`` rounds the float64 sum to odd and
    gets the correctly rounded value."""
    x = torch.tensor([2.0**-24 + 2.0**-60, 2.0**-24 - 2.0**-60, 2.0**-24, 3 * 2.0**-24,
                      0.0], dtype=torch.float64)
    y = torch.tensor([1.0, 1.0, 1.0, 1.0, 0.25], dtype=torch.float64)
    assert (x + y).to(torch.float32)[0].item() == 1.0  # the double rounding
    assert _f32_of_sum(x, y).tolist() == [1 + 2.0**-23, 1.0, 1.0, 1 + 2.0**-22, 0.25]
    rng = np.random.RandomState(4)
    p = rng.rand(4000).astype(np.float32) * np.float32(2.0) ** rng.randint(-30, 1, 4000)
    e = rng.randint(0, 3, 4000).astype(np.int32)
    for alpha in (0.1, 0.3, 0.37, 0.5):
        a = np.float32(alpha)
        got = pressure_ewma(torch.from_numpy(p), torch.from_numpy(e), alpha).numpy()
        want = np.array([fma32(np.float32(1) - a, pi, a * np.float32(ei))
                         for pi, ei in zip(p, e)], dtype=np.float32)
        assert got.tobytes() == want.tobytes(), alpha


# ---------------------------------------------------------------------------
# access == access_stream; the stream mode's plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["awrp", "lfu", "car"])
def test_access_equals_access_stream_and_reference(policy):
    """The single-access path (the same stream launch with one access) and
    the stream path give the same states, counters and hit bits; evicted
    keys equal the JAX manager's."""
    rng = np.random.RandomState(5)
    rows, keys = rng.randint(0, 2, size=120), rng.randint(0, 9, size=120)
    q = {"a": 3, "b": 2}
    one, _ = managers(q, policy)
    many, jm = managers(q, policy)
    got = [one.access(one.tenants[r], int(k)) for r, k in zip(rows, keys)]
    want = [jm.access(jm.tenants[r], int(k)) for r, k in zip(rows, keys)]
    assert got == want
    assert [h for h, _ in got] == many.access_stream(rows, keys).tolist()
    assert_same(one, jm)
    assert_same(many, jm)


@pytest.mark.parametrize("policy", ["lfu", "arc", "car"])
def test_stream_plain_is_a_loop_of_on_access_counted(policy):
    """``ops.flat_stream`` / ``ops.adaptive_stream`` on CPU tensors (the plain
    version, no launch counted) from a state and counters already under way
    equal a hand loop of masked ``on_access_counted`` calls."""
    rng = np.random.RandomState(8)
    caps = (3, 5, 2)
    if policy in ("arc", "car"):
        core = AdaptiveCore(kind=policy, caps=caps)
    else:
        core = FlatCore(pids=(3,) * 3, ways=caps, lanes=10)
    state, ctr = core.init(device="cpu"), core.init_counters(device="cpu")
    for t in range(40):  # a state under way
        state, ctr, _ = core.on_access_counted(state, ctr, torch.full((3,), t % 7),
                                               active=torch.arange(3) == t % 3)
    rows = rng.randint(0, 3, size=90).astype(np.int32)
    keys = rng.randint(0, 12, size=90).astype(np.int32)
    s2, c2, hits = state, ctr, []
    for r, k in zip(rows, keys):
        s2, c2, h = core.on_access_counted(s2, c2, torch.full((3,), int(k)),
                                           active=torch.arange(3) == int(r), pressure_alpha=0.2)
        hits.append(bool(h[r]))
    before = dict(ops.LAUNCHES)
    args = (torch.from_numpy(keys), torch.from_numpy(rows), state, ctr)
    per_row = torch.tensor(caps, dtype=torch.int32)
    if policy in ("arc", "car"):
        got = ops.adaptive_stream(*args, per_row, kind=policy, alpha=0.2,
                                  renorm_at=core.renorm_at)
    else:
        got = ops.flat_stream(*args, torch.full((3,), 3, dtype=torch.int32), per_row, alpha=0.2)
    assert ops.LAUNCHES == before
    assert got[0].tolist() == hits
    for a, b in zip((*got[1], *got[2]), (*s2, *c2)):
        assert a.numpy().tobytes() == b.numpy().tobytes()


def test_stream_mode_takes_one_set():
    core = FlatCore(pids=(0, 0), ways=(2, 2), num_sets=2)
    state, ctr = core.init(device="cpu"), core.init_counters(device="cpu")
    z = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="num_sets == 1"):
        ref.flat_stream_plain(z, z, state, ctr, z[:2], z[:2] + 2, alpha=0.1)
    acore = AdaptiveCore(kind="arc", caps=(2, 2), num_sets=2)
    with pytest.raises(ValueError, match="num_sets == 1"):
        ref.adaptive_stream_plain(z, z, acore.init(device="cpu"), ctr, z[:2] + 2, kind="arc",
                                  alpha=0.1, renorm_at=None)


# ---------------------------------------------------------------------------
# manager mechanics, as the reference's tests hold them
# ---------------------------------------------------------------------------


def test_manager_validation():
    with pytest.raises(ValueError, match="at least one tenant"):
        TenantCacheManager({}, device="cpu")
    with pytest.raises(ValueError, match="quota must be positive"):
        TenantCacheManager({"a": 0}, device="cpu")
    with pytest.raises(ValueError, match="not a device policy"):
        TenantCacheManager({"a": 2}, policy="opt", device="cpu")
    m = TenantCacheManager({"a": 2}, device="cpu")
    with pytest.raises(KeyError, match="unknown tenant"):
        m.access("nope", 1)
    with pytest.raises(ValueError, match="equal-length"):
        m.access_stream(np.zeros(3, np.int32), np.zeros(4, np.int32))
    with pytest.raises(ValueError, match="tenant rows"):
        m.access_stream(np.ones(3, np.int32), np.zeros(3, np.int32))


def test_evicted_keys_and_pressure_decay():
    m = TenantCacheManager({"a": 2, "b": 2}, "lru", device="cpu")
    assert m.access("a", 1) == (False, [])
    assert m.access("a", 2) == (False, [])
    assert m.access("a", 3) == (False, [1])  # LRU evicts 1
    assert m.access("b", 1)[0] is False  # rows are independent
    assert m.access("a", 3)[0] is True
    h = TenantCacheManager({"hog": 1, "idle": 4}, "lru", pressure_alpha=0.5, device="cpu")
    for k in range(6):
        h.access("hog", k)
    assert h.pressure("hog") > 0.9 and h.pressure("idle") == 0.0
    p = np.float32(h.pressure("hog"))
    assert h.decay_pressure("hog") == p * np.float32(0.5)


def test_tenant_awrp_ranking_equals_reference():
    tm, jm = managers({"hot": 2, "cold": 2, "never": 2}, "awrp")
    for m in (tm, jm):
        for i in range(10):
            m.access("hot", i % 3)
        m.access("cold", 1)
        for i in range(5):
            m.access("hot", i % 3)
    assert tm.tenant_weights() == jm.tenant_weights()
    assert tm.rank_tenants() == jm.rank_tenants() == ["never", "cold", "hot"]


def test_rebalance_rules_equal_reference():
    tm, jm = managers({"a": 1, "b": 2, "c": 3}, "lru")
    assert tm.rebalance("c", 5, min_quota=1) == jm.rebalance("c", 5, min_quota=1) == (1, {})
    assert tm.quotas == {"a": 1, "b": 1, "c": 4}
    with pytest.raises(ValueError, match="n must be positive"):
        tm.rebalance("a", 0)
    arc = TenantCacheManager({"a": 2, "b": 2}, "arc", device="cpu")
    with pytest.raises(NotImplementedError, match="quotas are fixed"):
        arc.rebalance("a", 1)


# ---------------------------------------------------------------------------
# admission
# ---------------------------------------------------------------------------


def host_admission_loop(adm, mgr, batch):
    out = []
    for t in batch:
        d = adm.decide(mgr, t)
        if d == SHED:
            mgr.decay_pressure(t)
        out.append(d)
    return out


@settings(max_examples=8, deadline=None)
@given(
    seed=st.integers(min_value=0, max_value=10_000),
    d20=st.integers(min_value=0, max_value=14),
    s20=st.integers(min_value=0, max_value=6),
    warmup=st.integers(min_value=0, max_value=20),
)
def test_decide_batch_equals_host_loop_and_reference(seed, d20, s20, warmup):
    """``decide_batch`` on the device plane == the host loop of ``decide`` +
    ``decay_pressure`` == JAX's ``decide_batch``: decisions and pressure
    bits, over rounds interleaved with access streams."""
    defer_at, shed_at = d20 / 20.0, (d20 + s20) / 20.0
    adm = AdmissionController(defer_at=defer_at, shed_at=shed_at, warmup=warmup)
    jadm = jt.AdmissionController(defer_at=defer_at, shed_at=shed_at, warmup=warmup)
    rng = np.random.RandomState(seed)
    quotas = dict(zip(TENANTS, (2, 1, 3)))
    host = TenantCacheManager(quotas, "lru", pressure_alpha=0.3, device="cpu")
    dev, jm = managers(quotas, "lru", pressure_alpha=0.3)
    for _ in range(3):
        rows, keys = rng.randint(0, 3, size=25), rng.randint(0, 7, size=25)
        for m in (host, dev, jm):
            m.access_stream(rows, keys)
        batch = [TENANTS[i] for i in rng.randint(0, 3, size=10)]
        want = host_admission_loop(adm, host, batch)
        assert adm.decide_batch(dev, batch) == want == jadm.decide_batch(jm, batch)
        assert host._pressure.tobytes() == dev._pressure.tobytes() == jm._pressure.tobytes()
        assert_same(dev, jm)
    assert adm.decide_batch(dev, []) == []


def test_threshold_edge_follows_reference():
    """Where ``f32(shed_at) < shed_at`` (0.7) and the pressure is exactly
    ``f32(0.7)``, the reference's host ``decide`` (float64 compare of the
    pulled mirror) defers and its ``decide_batch`` (float32 compare on the
    plane) sheds; the port reproduces both paths as they are."""
    adm = AdmissionController(defer_at=0.5, shed_at=0.7, warmup=0)
    jadm = jt.AdmissionController(defer_at=0.5, shed_at=0.7, warmup=0)
    tm, jm = managers({"a": 2}, "lru")
    p = np.float32(0.7)
    assert float(p) < 0.7
    for m in (tm, jm):
        m.access_stream(np.zeros(4, np.int32), np.arange(4, dtype=np.int32))
        m.counters = m.counters._replace(pressure=m.counters.pressure * 0 + p)
        m._pull_pressure()
    assert adm.decide(tm, "a") == jadm.decide(jm, "a") == DEFER
    assert adm.decide_batch(tm, ["a"]) == jadm.decide_batch(jm, ["a"]) == [SHED]


def test_admission_thresholds_and_warmup():
    with pytest.raises(ValueError, match="defer_at <= shed_at"):
        AdmissionController(defer_at=0.9, shed_at=0.5)
    adm = AdmissionController(defer_at=0.4, shed_at=0.8, warmup=4)
    m = TenantCacheManager({"t": 1, "u": 2}, "lru", pressure_alpha=0.5, device="cpu")
    assert adm.decide(m, "t") == ACCEPT
    for k in range(3):
        m.access("t", k)
    assert adm.decide(m, "t") == ACCEPT  # still inside warmup
    m.access("t", 3)
    assert m.pressure("t") > 0.8 and adm.decide(m, "t") == SHED
    while m.pressure("t") >= 0.4:
        m.decay_pressure("t")
    assert adm.decide(m, "t") == ACCEPT
    m._pressure[m.row("t")] = 0.6
    assert adm.decide(m, "t") == DEFER
    assert adm.decide(m, "u") == ACCEPT


# ---------------------------------------------------------------------------
# tenant prefix cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", POLICIES)
def test_tenant_prefix_cache_equals_reference(policy):
    """The same lookups and inserts into both tenant prefix caches: every
    lookup agrees, the stores equal the rows' resident sets and JAX's
    stores, and the telemetry is equal."""
    rng = np.random.RandomState(3)
    tc = TenantPrefixCache({"a": 3, "b": 2}, policy, device="cpu")
    jc = jt.TenantPrefixCache({"a": 3, "b": 2}, policy)
    prompts = [[i, i + 1] for i in range(7)]
    for step in range(120):
        t = "a" if rng.rand() < 0.6 else "b"
        p = prompts[int(rng.randint(len(prompts)))]
        got, want = tc.lookup(t, p), jc.lookup(t, p)
        assert got == want, (policy, step)
        if got is None:
            tc.insert(t, p, (t, tuple(p)))
            jc.insert(t, p, (t, tuple(p)))
        for tt in ("a", "b"):
            r = tc.manager.row(tt)
            assert set(tc.stores[tt]) == tc.manager._resident_ids(tc.manager.state, r)
            assert tc.stores[tt] == jc.stores[tt]
    assert tc.telemetry() == jc.telemetry()
    assert_same(tc.manager, jc.manager)


def test_tenant_prefix_rebalance_equals_reference():
    tc = TenantPrefixCache({"a": 1, "b": 3}, "awrp", device="cpu")
    jc = jt.TenantPrefixCache({"a": 1, "b": 3}, "awrp")
    for c in (tc, jc):
        for k in range(3):
            c.insert("b", [k], k)
    assert tc.rebalance("a", 2) == jc.rebalance("a", 2)
    assert tc.stores == jc.stores and len(tc.stores["b"]) == 1
    assert_same(tc.manager, jc.manager)


# ---------------------------------------------------------------------------
# on a card: the stream kernels == their plain versions
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("policy", POLICIES)
def test_cuda_stream_kernels_match_plain(cuda_device, policy):
    """The stream kernel in two calls (state and counters carried in) ==
    the plain version: hits, every plane, the counters, pressure bitwise;
    one launch per call."""
    rows, keys = stream(800, seed=2)
    quotas = (200, 100, 40) if policy == "lfu" else (4, 7, 3)
    card = TenantCacheManager(dict(zip(TENANTS, quotas)), policy, device=cuda_device)
    cpu = TenantCacheManager(dict(zip(TENANTS, quotas)), policy, device="cpu")
    name = "adaptive_stream" if policy in ("arc", "car") else "flat_stream"
    for part in (slice(0, 300), slice(300, None)):
        before = ops.LAUNCHES[name]
        got = card.access_stream(rows[part], keys[part])
        assert ops.LAUNCHES[name] == before + 1
        assert np.array_equal(got, cpu.access_stream(rows[part], keys[part]))
    for a, b in zip((*card.state, *card.counters), (*cpu.state, *cpu.counters)):
        assert a.cpu().numpy().tobytes() == b.numpy().tobytes()
