"""The port's decision-trace ring (``repro_torch/obs/decision_trace.py``) and
its writers against the JAX reference (``repro/obs/decision_trace.py``), on
the CPU.

The same seeded pushes and streams go through the port and the reference;
drained records are compared field by field, float fields by their bits, and
the raw ring (``buf[:capacity]``, ``count``) bitwise.  Covered: the ring's
init validation, round trip, several laps with push sizes 1-5 and the masked
scatter; the tenancy manager's ring for all six policies (the stream longer
than the ring, a flat ``rebalance`` mid-stream, the single ``access`` path),
which changes no decision; ``decide_batch``'s admission events.  The
``cuda``-marked cases hold the stream kernels' ring variant to its plain
version on a card and skip without one."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.traces import trace_multi_tenant  # noqa: E402
from repro.obs import decision_trace as jdt  # noqa: E402
from repro.serve import tenancy as jt  # noqa: E402
from repro_torch.kernels import ops, ref, sweep  # noqa: E402
from repro_torch.obs import decision_trace as dt  # noqa: E402
from repro_torch.serve.tenancy import AdmissionController, TenantCacheManager  # noqa: E402

torch.set_num_threads(2)

POLICIES = ["awrp", "lru", "fifo", "lfu", "arc", "car"]
TENANTS = ("alpha", "beta", "gamma")


def assert_records_equal(got: np.ndarray, want: np.ndarray, where=""):
    """Two drained record arrays: the same dtype and length, every field
    equal, floats by their bits."""
    assert got.dtype == want.dtype and len(got) == len(want), (where, got.dtype, len(got),
                                                               len(want))
    for name in want.dtype.names:
        assert got[name].tobytes() == want[name].tobytes(), (where, name, got[name],
                                                             want[name])


def assert_ring_equal(ring, jring, where=""):
    """The raw rings: every event slot and the count, bitwise (the scratch
    lane, a masked-write sink, is not part of the contract)."""
    cap = dt.ring_capacity(ring)
    assert cap == jdt.ring_capacity(jring)
    assert np.array_equal(ring.buf[:cap].numpy(), np.asarray(jring.buf)[:cap]), where
    assert int(ring.count) == int(jring.count), where


def stream(n, seed, working_set=30):
    rows, addrs = trace_multi_tenant(n, n_tenants=3, working_set=working_set, seed=seed)
    return rows.astype(np.int32), (addrs % 1000).astype(np.int32)


# ---------------------------------------------------------------------------
# the ring: scatter contract, against the reference
# ---------------------------------------------------------------------------


def test_layout_is_the_references():
    assert dt.FIELDS == jdt.FIELDS and dt.NF == jdt.NF
    assert sweep.RING_FIELDS == dt.NF  # the kernels' event width
    assert (dt.KIND_ACCESS, dt.KIND_ADMIT) == (jdt.KIND_ACCESS, jdt.KIND_ADMIT)
    assert dt._REC_DTYPE == jdt._REC_DTYPE


def test_ring_init_validation_and_capacity():
    for bad in (0, -3):
        with pytest.raises(ValueError, match="capacity"):
            dt.ring_init(bad, device="cpu")
    ring = dt.ring_init(5, device="cpu")
    assert dt.ring_capacity(ring) == 5
    assert ring.buf.shape == (6, dt.NF) and ring.buf.dtype == torch.int32
    assert ring.count.shape == () and ring.count.dtype == torch.int32
    assert_records_equal(dt.drain(ring), jdt.drain(jdt.ring_init(5)))


def test_ring_init_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        dt.ring_init(4)


def test_ring_push_drain_roundtrip_and_wraparound():
    ring, jring = dt.ring_init(4, device="cpu"), jdt.ring_init(4)
    for i in range(7):  # 7 events through a 4-slot ring
        kw = dict(kind=dt.KIND_ACCESS, row=i % 2, key=100 + i, hit=i % 2, weight=1.5 * i)
        ring = dt.ring_push(ring, dt.pack_events(1, **kw), torch.ones(1, dtype=torch.bool))
        jring = jdt.ring_push(jring, jdt.pack_events(1, **kw), jnp.ones((1,), dtype=bool))
    rec = dt.drain(ring)
    assert rec["key"].tolist() == [103, 104, 105, 106]  # chronological
    assert rec["hit"].tolist() == [1, 0, 1, 0]
    assert rec["weight"].tolist() == [4.5, 6.0, 7.5, 9.0]
    assert np.all(rec["admit"] == -1)
    assert_records_equal(rec, jdt.drain(jring))
    assert_ring_equal(ring, jring)


@pytest.mark.parametrize("seed", [42, 7])
def test_ring_drain_after_multiple_full_wraparounds(seed):
    """More than four laps with push sizes 1-5 straddling the wrap: the
    drained window is the last ``capacity`` events, oldest first, equal to
    the reference's; draining leaves the ring as it was."""
    cap = 8
    ring, jring = dt.ring_init(cap, device="cpu"), jdt.ring_init(cap)
    rng = np.random.RandomState(seed)
    pushed, serial = [], 0
    while serial < cap * 4 + 3:
        n = int(rng.randint(1, 6))
        keys = np.arange(serial, serial + n, dtype=np.int32)
        hits = (keys % 3 == 0).astype(np.int32)
        w = keys.astype(np.float32) * np.float32(0.25)
        p = rng.standard_normal(n).astype(np.float32)
        ring = dt.ring_push(ring, dt.pack_events(
            n, kind=dt.KIND_ACCESS, row=torch.from_numpy(keys % 2), key=torch.from_numpy(
                1000 + keys), hit=torch.from_numpy(hits), weight=torch.from_numpy(w),
            p_before=torch.from_numpy(p)), torch.ones(n, dtype=torch.bool))
        jring = jdt.ring_push(jring, jdt.pack_events(
            n, kind=jdt.KIND_ACCESS, row=jnp.asarray(keys % 2), key=jnp.asarray(1000 + keys),
            hit=jnp.asarray(hits), weight=jnp.asarray(w), p_before=jnp.asarray(p)),
            jnp.ones((n,), dtype=bool))
        pushed.extend((1000 + keys).tolist())
        serial += n
    rec = dt.drain(ring)
    assert len(rec) == cap and int(ring.count) == serial
    assert rec["key"].tolist() == pushed[-cap:]
    assert_records_equal(rec, jdt.drain(jring))
    assert_ring_equal(ring, jring)
    assert_records_equal(dt.drain(ring), rec)  # non-destructive


def test_ring_push_masked_scatter_skips_masked_out_rows():
    ring, jring = dt.ring_init(8, device="cpu"), jdt.ring_init(8)
    mask = [True, False, True, False]
    for _ in range(3):  # the third push wraps
        ring = dt.ring_push(ring, dt.pack_events(
            4, kind=dt.KIND_ACCESS, row=torch.arange(4, dtype=torch.int32),
            key=torch.tensor([10, 11, 12, 13], dtype=torch.int32)), torch.tensor(mask))
        jring = jdt.ring_push(jring, jdt.pack_events(
            4, kind=jdt.KIND_ACCESS, row=jnp.arange(4, dtype=jnp.int32),
            key=jnp.asarray([10, 11, 12, 13], jnp.int32)), jnp.asarray(mask))
    rec = dt.drain(ring)
    assert rec["key"].tolist() == [10, 12] * 3 and rec["row"].tolist() == [0, 2] * 3
    assert int(ring.count) == 6
    assert_records_equal(rec, jdt.drain(jring))
    assert_ring_equal(ring, jring)


def test_drain_is_one_pull_of_buf_and_count(monkeypatch):
    """``drain`` reads the ring back with one ``_pull`` of both tensors (one
    synchronization on a card) and no other host read."""
    ring = dt.ring_init(4, device="cpu")
    ring = dt.ring_push(ring, dt.pack_events(3, kind=dt.KIND_ACCESS, row=0, key=5),
                        torch.ones(3, dtype=torch.bool))
    calls = []
    orig = dt._pull
    monkeypatch.setattr(dt, "_pull", lambda leaves: (calls.append(leaves), orig(leaves))[1])
    rec = dt.drain(ring)
    assert len(calls) == 1 and calls[0][0] is ring.buf and calls[0][1] is ring.count
    assert rec["key"].tolist() == [5, 5, 5]


def test_pack_events_float_fields_are_the_references_bits():
    """Every float the ring may carry (negative, -0.0, subnormal, inf, nan,
    values rounded to float32) is stored as the reference stores it."""
    f = np.array([0.1, -0.0, 1e-40, np.inf, -np.inf, np.nan, 3.0, -2.5], dtype=np.float64)
    got = dt.pack_events(8, kind=dt.KIND_ADMIT, row=3, key=-1,
                         weight=torch.from_numpy(f.astype(np.float32)), p_before=0.1,
                         p_after=torch.from_numpy(f[::-1].astype(np.float32)), admit=2)
    want = jdt.pack_events(8, kind=jdt.KIND_ADMIT, row=3, key=-1,
                           weight=jnp.asarray(f.astype(np.float32)), p_before=0.1,
                           p_after=jnp.asarray(f[::-1].astype(np.float32)), admit=2)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the tenancy manager's ring == the reference manager's
# ---------------------------------------------------------------------------


def managers(quotas, policy, **kw):
    q = dict(zip(TENANTS, quotas))
    return (TenantCacheManager(q, policy, device="cpu", **kw),
            jt.TenantCacheManager(q, policy, **kw))


@pytest.mark.parametrize("policy", POLICIES)
def test_manager_ring_equals_reference_and_changes_no_decision(policy):
    """All six policies: a stream longer than the ring in two calls (flat
    rows: a ``rebalance`` between them), then single ``access`` calls.  The
    port's drained records and raw ring == the JAX manager's; the twin
    without a ring makes the same decisions, bit for bit."""
    rows, keys = stream(170, seed=3)
    quotas = (4, 6, 3)
    tm, jm = managers(quotas, policy, ring_capacity=64)
    off = TenantCacheManager(dict(zip(TENANTS, quotas)), policy, device="cpu")
    for part in (slice(0, 90), slice(90, None)):
        h = tm.access_stream(rows[part], keys[part])
        assert np.array_equal(h, np.asarray(jm.access_stream(rows[part], keys[part])))
        assert np.array_equal(h, off.access_stream(rows[part], keys[part]))
        if part.start == 0 and policy not in ("arc", "car"):
            moved = [m.rebalance("beta", 2) for m in (tm, jm, off)]
            assert moved[0] == moved[1] == moved[2] and moved[0][0] == 2
    for t, k in [("alpha", 7), ("gamma", 900), ("alpha", 7), ("beta", 31)]:
        got = [m.access(t, k) for m in (tm, jm, off)]
        assert got[0] == got[1] == got[2], (t, k)
    rec = tm.drain_trace()
    assert len(rec) == 64 and np.all(rec["kind"] == dt.KIND_ACCESS)
    assert rec["key"][-4:].tolist() == [7, 900, 7, 31]
    assert_records_equal(rec, jm.drain_trace(), policy)
    assert_ring_equal(tm.ring, jm.ring, policy)
    for a, b in zip((*tm.state, *tm.counters), (*off.state, *off.counters)):
        assert a.numpy().tobytes() == b.numpy().tobytes(), policy
    assert tm.telemetry() == off.telemetry() and tm.quotas == off.quotas
    if policy in ("arc", "car"):
        assert (rec["weight"] == 0).all() and (rec["victim"] >= -1).all()
    else:
        assert (rec["p_before"] == 0).all() and (rec["victim"] >= 0).all()
    with pytest.raises(ValueError, match="ring_capacity"):
        off.drain_trace()


@pytest.mark.parametrize("policy", ["awrp", "car"])
def test_manager_ring_wraps_within_one_stream_call(policy):
    """One call of more accesses than the ring holds, from a ring already
    part full: the survivors are the stream's tail, equal to the
    reference's."""
    rows, keys = stream(150, seed=8)
    tm, jm = managers((3, 3, 3), policy, ring_capacity=40)
    for m in (tm, jm):
        m.access_stream(rows[:13], keys[:13])
    h = tm.access_stream(rows[13:], keys[13:])
    jm.access_stream(rows[13:], keys[13:])
    rec = tm.drain_trace()
    assert rec["row"].tolist() == rows[-40:].tolist()
    assert rec["key"].tolist() == keys[-40:].tolist()
    assert rec["hit"].tolist() == h[-40:].astype(np.int32).tolist()
    assert_records_equal(rec, jm.drain_trace(), policy)
    assert_ring_equal(tm.ring, jm.ring, policy)


def test_stream_call_leaves_the_manager_as_it_was():
    rows, keys = stream(40, seed=4)
    tm = TenantCacheManager(dict(zip(TENANTS, (3, 3, 3))), "awrp", device="cpu",
                            ring_capacity=16)
    before = [t.clone() for t in (*tm.state, *tm.counters, *tm.ring)]
    fn, args, kw = tm.stream_call(rows, keys)
    hits, state, counters, ring = fn(*args, **kw)
    for a, b in zip((*tm.state, *tm.counters, *tm.ring), before):
        assert torch.equal(a, b)
    assert np.array_equal(hits.numpy(), tm.access_stream(rows, keys))
    assert all(torch.equal(a, b) for a, b in zip((*state, *counters, *ring),
                                                  (*tm.state, *tm.counters, *tm.ring)))


@pytest.mark.parametrize("defer_at,shed_at,warmup", [(0.0, 100.0, 0), (0.05, 0.2, 2)])
def test_decide_batch_admit_events_equal_reference(defer_at, shed_at, warmup):
    """Admission events after a pressured stream (accepts, defers and sheds
    with their decays): row, key -1, the pressure before and after each
    request's decay (bits) and the code, equal to the reference's; the
    decisions are those of the manager without a ring."""
    rows, keys = stream(120, seed=6, working_set=200)
    tm, jm = managers((2, 3, 2), "awrp", ring_capacity=32)
    off = TenantCacheManager(dict(zip(TENANTS, (2, 3, 2))), "awrp", device="cpu")
    for m in (tm, jm, off):
        m.access_stream(rows, keys)
    batch = ["alpha", "beta", "alpha", "gamma", "alpha", "alpha", "beta"]
    kw = dict(defer_at=defer_at, shed_at=shed_at, warmup=warmup)
    got = AdmissionController(**kw).decide_batch(tm, batch)
    assert got == jt.AdmissionController(**kw).decide_batch(jm, batch)
    assert got == AdmissionController(**kw).decide_batch(off, batch)
    assert tm.counters.pressure.numpy().tobytes() == off.counters.pressure.numpy().tobytes()
    rec = tm.drain_trace()
    adm = rec[rec["kind"] == dt.KIND_ADMIT]
    assert len(adm) == len(batch) and np.all(adm["key"] == -1)
    assert adm["row"].tolist() == [TENANTS.index(t) for t in batch]
    assert adm["admit"].tolist() == [("accept", "defer", "shed").index(d) for d in got]
    assert_records_equal(rec, jm.drain_trace())
    assert_ring_equal(tm.ring, jm.ring)
    if defer_at > 0:
        assert "shed" in got and (adm["p_after"] < adm["p_before"]).any()


def test_plain_stream_returns_the_ring_only_when_given():
    rows, keys = stream(20, seed=1)
    tm = TenantCacheManager(dict(zip(TENANTS, (3, 3, 3))), "lru", device="cpu")
    args = (torch.from_numpy(keys), torch.from_numpy(rows), tm.state, tm.counters,
            *tm._row_consts)
    assert len(ref.flat_stream_plain(*args, alpha=0.1)) == 3
    out = ref.flat_stream_plain(*args, alpha=0.1, ring=dt.ring_init(8, device="cpu"))
    assert len(out) == 4 and int(out[3].count) == 20
    before = dict(ops.LAUNCHES)
    ops.flat_stream(*args, alpha=0.1, ring=dt.ring_init(8, device="cpu"))
    assert ops.LAUNCHES == before  # CPU tensors: the plain version, no launch


# ---------------------------------------------------------------------------
# on a card: the ring variant == its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("policy", POLICIES)
def test_cuda_ring_variant_matches_plain(cuda_device, policy):
    """The stream kernels' ring variant in three calls (a short one, one
    that wraps, one access) == the plain version on the card: the new ring
    (``buf[:cap]``, ``count``) bitwise, and hits, planes and counters equal
    to the ring-off kernel's; one ``*_ring`` launch per call."""
    rows, keys = stream(400, seed=9)
    quotas = (200, 100, 40) if policy in ("lfu", "arc") else (4, 7, 3)
    name = ("adaptive_stream" if policy in ("arc", "car") else "flat_stream") + "_ring"
    q = dict(zip(TENANTS, quotas))
    card = TenantCacheManager(q, policy, device=cuda_device, ring_capacity=96)
    off = TenantCacheManager(q, policy, device=cuda_device)
    plain = dt.ring_init(96, device=cuda_device)
    for part in (slice(0, 50), slice(50, 399), slice(399, None)):
        fn, args, kw = card.stream_call(rows[part], keys[part])
        plain_fn = (ref.adaptive_stream_plain if policy in ("arc", "car")
                    else ref.flat_stream_plain)
        *_, plain = plain_fn(*args, **dict(kw, ring=plain))
        before = ops.LAUNCHES[name]
        got = card.access_stream(rows[part], keys[part])
        assert ops.LAUNCHES[name] == before + 1
        assert np.array_equal(got, off.access_stream(rows[part], keys[part]))
        assert card.ring.buf[:96].cpu().numpy().tobytes() == \
            plain.buf[:96].cpu().numpy().tobytes(), part
        assert int(card.ring.count) == int(plain.count) == (part.stop or 400)
    for a, b in zip((*card.state, *card.counters), (*off.state, *off.counters)):
        assert a.cpu().numpy().tobytes() == b.cpu().numpy().tobytes()
