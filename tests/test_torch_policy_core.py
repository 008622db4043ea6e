"""The port's tensor policy core (``repro_torch.core.policy_core``) against the
JAX core (``repro.core.policy_core``) and the host oracles, on the CPU.

``FlatCore`` and ``AdaptiveCore`` are driven access by access from the same
seeded streams on both sides; every plane must be equal after every access
(float32 ``p`` compared as its int32 bit pattern), and so must the hits and
the advisory victims.  Mixed policies, mixed ways, ``num_sets`` in {1, 2, 4},
``active`` masking, a forced-low ``renorm_at`` and CAR clock-stress traces.
Both routes of the flat core's AWRP victim (inline and the rows kernel's
plain version) are held to the same planes.  Every comparison is exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import policy_core as jpc  # noqa: E402
from repro_torch.core import make_policy  # noqa: E402
from repro_torch.core import policy_core as tpc  # noqa: E402

torch.set_num_threads(2)

FLAT = tpc.JAX_POLICIES
ADAPTIVE = tpc.ADAPTIVE_POLICIES


def assert_planes_equal(tstate, jstate, where=""):
    assert type(tstate).__name__ == type(jstate).__name__
    for name, a, b in zip(tstate._fields, tstate, jstate):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype, (where, name, a.dtype, b.dtype)
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=f"{where} plane {name}")


def host_hits_rows(policy, streams, capacity, num_sets=1):
    out = []
    for row in streams:
        insts = [make_policy(policy, capacity // num_sets) for _ in range(num_sets)]
        out.append([insts[int(b) % num_sets].access(int(b)) for b in row])
    return np.asarray(out, dtype=bool)


def drive_both(tcore, jcore, streams, *, active=None, check_victim=False):
    """Drive both cores over (rows, T) streams; planes compared after every
    access.  ``active`` is an optional (rows, T) bool mask."""
    tstate, jstate = tcore.init(device="cpu"), jcore.init()
    jstep = jax.jit(lambda s, i, a: jcore.on_access(s, i, active=a))
    jvictim = jax.jit(jcore.victim)
    hits = []
    for t in range(streams.shape[1]):
        ids = streams[:, t]
        act = None if active is None else active[:, t]
        tstate, th = tcore.on_access(tstate, torch.from_numpy(ids),
                                     active=None if act is None else torch.from_numpy(act))
        jstate, jh = jstep(jstate, ids, act)
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh), err_msg=f"hits t={t}")
        assert_planes_equal(tstate, jstate, f"t={t}")
        if check_victim:
            np.testing.assert_array_equal(tcore.victim(tstate).numpy(),
                                          np.asarray(jvictim(jstate)))
        hits.append(th.numpy())
    return tstate, jstate, np.stack(hits, axis=1)


# ---------------------------------------------------------------------------
# flat core: planes equal to the JAX core after every access
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_sets", [1, 2, 4])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_flat_core_planes_match_jax(num_sets, use_kernel):
    """Mixed policies x mixed ways in one batch; the port's kernel route
    (plain rows kernel on the CPU) and inline route both hold the JAX
    inline core's planes, access for access."""
    rng = np.random.RandomState(10 + num_sets)
    pids = tuple(tpc.POLICY_IDS[p] for p in FLAT) * 2
    ways = (3, 5, 2, 6, 4, 1, 6, 3)
    streams = rng.randint(0, 6 * num_sets + 12, size=(len(pids), 90)).astype(np.int32)
    tcore = tpc.FlatCore(pids=pids, ways=ways, num_sets=num_sets, use_kernel=use_kernel)
    jcore = jpc.FlatCore(pids=pids, ways=ways, num_sets=num_sets)
    _, _, hits = drive_both(tcore, jcore, streams, check_victim=True)
    for b, (pid, w) in enumerate(zip(pids, ways)):
        want = host_hits_rows(tpc.DEVICE_POLICIES[pid], streams[b:b + 1], w * num_sets,
                              num_sets)
        np.testing.assert_array_equal(hits[b], want[0])


@pytest.mark.parametrize("policy", FLAT)
def test_flat_core_active_masking_matches_jax(policy):
    """Masked no-op rows keep every plane, tick no clock and report no hit,
    exactly as the JAX core's ``active`` masking does."""
    rng = np.random.RandomState(4)
    streams = rng.randint(0, 14, size=(3, 80)).astype(np.int32)
    active = rng.rand(3, 80) < 0.7
    core = tpc.make_core(policy, rows=3, num_sets=1, ways=4)
    jcore = jpc.make_core(policy, rows=3, num_sets=1, ways=4)
    tstate, _, hits = drive_both(core, jcore, streams, active=active)
    assert not hits[~active].any()
    assert (tstate.clock.numpy() == active.sum(axis=1)).all()


def test_flat_core_lanes_padding_and_occupancy():
    """``lanes`` wider than every row's ways: dead lanes never fill; the
    occupancy counts only live lanes, as the JAX core's does."""
    rng = np.random.RandomState(8)
    pids = (0, 1, 2, 3)
    ways = (2, 3, 4, 5)
    streams = rng.randint(0, 20, size=(4, 60)).astype(np.int32)
    tcore = tpc.FlatCore(pids=pids, ways=ways, lanes=9)
    jcore = jpc.FlatCore(pids=pids, ways=ways, lanes=9)
    tstate, jstate, _ = drive_both(tcore, jcore, streams)
    np.testing.assert_array_equal(tcore.occupancy(tstate).numpy(),
                                  np.asarray(jcore.occupancy(jstate)))
    assert (tstate.blocks.numpy()[:, 5:] == -1).all()
    assert tcore.row_capacity == jcore.row_capacity


# ---------------------------------------------------------------------------
# adaptive core: planes equal to the JAX core after every access
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_sets", [1, 2])
@pytest.mark.parametrize("kind", ADAPTIVE)
def test_adaptive_core_planes_match_jax(kind, num_sets):
    """Mixed capacities in one batch (lanes padded to 2*max): tag / stamp /
    ref / blocks / p / ctr equal to the JAX core after every access, hits
    equal to the host oracles."""
    rng = np.random.RandomState(20 + num_sets)
    caps = (2, 3, 5, 4)
    streams = rng.randint(0, 9 * num_sets + 6, size=(len(caps), 150)).astype(np.int32)
    tcore = tpc.AdaptiveCore(kind=kind, caps=caps, num_sets=num_sets)
    jcore = jpc.AdaptiveCore(kind=kind, caps=caps, num_sets=num_sets)
    tstate, jstate, hits = drive_both(tcore, jcore, streams,
                                      check_victim=num_sets == 1)
    for b, c in enumerate(caps):
        want = host_hits_rows(kind, streams[b:b + 1], c * num_sets, num_sets)
        np.testing.assert_array_equal(hits[b], want[0])
    np.testing.assert_array_equal(tcore.occupancy(tstate).numpy(),
                                  np.asarray(jcore.occupancy(jstate)))
    np.testing.assert_array_equal(tcore.resident_mask(tstate).numpy(),
                                  np.asarray(jcore.resident_mask(jstate)))


@pytest.mark.parametrize("kind", ADAPTIVE)
def test_adaptive_core_active_masking_matches_jax(kind):
    rng = np.random.RandomState(6)
    streams = rng.randint(0, 10, size=(2, 70)).astype(np.int32)
    active = rng.rand(2, 70) < 0.6
    tcore = tpc.make_core(kind, rows=2, num_sets=1, ways=3)
    jcore = jpc.make_core(kind, rows=2, num_sets=1, ways=3)
    _, _, hits = drive_both(tcore, jcore, streams, active=active)
    assert not hits[~active].any()


@pytest.mark.parametrize("kind", ADAPTIVE)
def test_forced_low_renorm_matches_jax(kind):
    """``renorm_at=24``: the stamp planes renormalize every few accesses on
    both sides, and every plane stays equal to the JAX core's; decisions
    stay equal to the host oracles."""
    rng = np.random.RandomState(13)
    caps = (3, 5)
    streams = rng.randint(0, 12, size=(2, 160)).astype(np.int32)
    tcore = tpc.AdaptiveCore(kind=kind, caps=caps, renorm_at=24)
    jcore = jpc.AdaptiveCore(kind=kind, caps=caps, renorm_at=24)
    before = tpc.HOST_SYNCS["renorm"]
    tstate, _, hits = drive_both(tcore, jcore, streams)
    assert tpc.HOST_SYNCS["renorm"] - before == streams.shape[1]
    assert int(tstate.ctr.max()) < 24 + 2 * (max(caps) + 2)
    for b, c in enumerate(caps):
        np.testing.assert_array_equal(hits[b], host_hits_rows(kind, streams[b:b + 1], c)[0])


CLOCK_STRESS = np.concatenate([
    np.tile(np.arange(10), 60),  # pure loop: every T1 page re-referenced
    np.random.RandomState(5).randint(0, 12, size=600),  # ref bits saturate
    np.random.RandomState(6).randint(6, 40, size=600),  # ghost hits both ways
    np.tile(np.arange(8), 40),
]).astype(np.int32)


@pytest.mark.parametrize("kind", ADAPTIVE)
def test_clock_stress_trace_matches_host_and_jax(kind):
    """The loop + phase-change trace of ``tests/test_batched_sweep.py``
    drives CAR's clock hand through long promotion runs (and ARC's p end to
    end): hits equal to the host oracles at caps 4, 8, 16; the final planes
    equal to the JAX core's."""
    caps = (4, 8, 16)
    streams = np.tile(CLOCK_STRESS, (len(caps), 1))
    tcore = tpc.AdaptiveCore(kind=kind, caps=caps)
    jcore = jpc.AdaptiveCore(kind=kind, caps=caps)
    tstate, jstate = tcore.init(device="cpu"), jcore.init()
    jstep = jax.jit(jcore.on_access)
    hits = []
    for t in range(streams.shape[1]):
        tstate, h = tcore.on_access(tstate, torch.from_numpy(streams[:, t]))
        jstate, _ = jstep(jstate, streams[:, t])
        hits.append(h.numpy())
    hits = np.stack(hits, axis=1)
    assert_planes_equal(tstate, jstate, "final")
    for b, c in enumerate(caps):
        np.testing.assert_array_equal(hits[b], host_hits_rows(kind, CLOCK_STRESS[None], c)[0])


# ---------------------------------------------------------------------------
# tests/test_policy_core.py, on the port's core
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", tpc.DEVICE_POLICIES)
def test_victim_predicts_next_eviction(policy):
    rng = np.random.RandomState(5)
    core, state = tpc.init(policy, rows=2, num_sets=1, ways=4, device="cpu")
    if policy in ADAPTIVE:
        assert (core.victim(state).numpy()[:, 0] == -1).all()
    streams = rng.randint(0, 10, size=(2, 60)).astype(np.int32)
    for t in range(60):
        state, _ = core.on_access(state, torch.from_numpy(streams[:, t]))
    v = core.victim(state).numpy()
    fresh = torch.tensor([1000, 2000], dtype=torch.int32)
    new_state, _ = core.on_access(state, fresh)
    if policy in ADAPTIVE:
        res_b = core.resident_mask(state).numpy()[:, 0]
        res_a = core.resident_mask(new_state).numpy()[:, 0]
        for b in range(2):
            evicted = np.flatnonzero(res_b[b] & ~res_a[b])
            assert evicted.size == 1 and v[b, 0] == evicted[0]
    else:
        for b in range(2):
            assert int(new_state.blocks[b, int(v[b])]) == int(fresh[b])


def test_on_access_keeps_the_old_state():
    """``on_access`` returns new tensors; the state it was given is kept."""
    for policy, sets in (("awrp", 1), ("lfu", 2), ("arc", 1), ("car", 2)):
        core, state = tpc.init(policy, rows=2, num_sets=sets, ways=3, device="cpu")
        snap = [x.clone() for x in state]
        for b in (1, 2, 3, 4, 5, 1):
            new, _ = core.on_access(state, torch.tensor([b, b + 1], dtype=torch.int32))
        for a, b in zip(state, snap):
            assert torch.equal(a, b), policy
        assert not all(torch.equal(a, b) for a, b in zip(new, snap))


def test_factory_validation():
    with pytest.raises(ValueError, match="not a device policy"):
        tpc.make_core("2q", rows=1, num_sets=1, ways=4)
    with pytest.raises(ValueError, match="FlatCore supports"):
        tpc.FlatCore(pids=(tpc.POLICY_IDS["arc"],), ways=(4,))
    with pytest.raises(ValueError, match="AdaptiveCore supports"):
        tpc.AdaptiveCore(kind="lru", caps=(4,))
    with pytest.raises(ValueError, match="lanes"):
        tpc.FlatCore(pids=(0,), ways=(4,), lanes=3)
    with pytest.raises(NotImplementedError):
        core = tpc.AdaptiveCore(kind="arc", caps=(4,), num_sets=2)
        core.victim(core.init(device="cpu"))
    assert tpc.AdaptiveCore(kind="car", caps=(7,)).renorm_at == \
        jpc.AdaptiveCore(kind="car", caps=(7,)).renorm_at
    assert tpc.POLICY_IDS == jpc.POLICY_IDS and tpc.INT_MAX == jpc.INT_MAX


def test_renorm_near_int32_parity_and_reset():
    """Shift an adaptive state's stamps/ctr to the int32 brink mid-stream;
    decisions keep matching the host oracle and the counter comes back
    down (a renormalization really fired)."""
    rng = np.random.RandomState(13)
    streams = rng.randint(0, 14, size=(1, 300)).astype(np.int32)
    for policy in ADAPTIVE:
        want = host_hits_rows(policy, streams, 5)
        core, state = tpc.init(policy, rows=1, num_sets=1, ways=5, device="cpu")
        hits = []
        for t in range(streams.shape[1]):
            if t == 150:
                shift = core.renorm_at - int(state.ctr.max())
                state = state._replace(stamp=state.stamp + shift, ctr=state.ctr + shift)
            state, h = core.on_access(state, torch.from_numpy(streams[:, t]))
            hits.append(bool(h[0]))
        assert (np.asarray(hits) == want[0]).all(), policy
        assert int(state.ctr[0, 0]) < 10_000


def test_awrp_victim_rows_routes_agree():
    """The core-level dispatch: kernel route (plain rows kernel on the CPU)
    == inline route == the JAX inline route, bool or int32 ``valid``."""
    rng = np.random.RandomState(2)
    B, P = 7, 33
    f = rng.randint(1, 4, size=(B, P)).astype(np.int32)
    r = rng.randint(0, 5, size=(B, P)).astype(np.int32)
    clock = rng.randint(5, 9, size=(B,)).astype(np.int32)
    valid = rng.rand(B, P) < 0.8
    valid[3] = False
    want = np.asarray(jpc.awrp_victim_rows(f, r, clock, valid))
    tf, tr_, tc, tv = (torch.from_numpy(x) for x in (f, r, clock, valid))
    for v in (tv, tv.to(torch.int32)):
        for use_kernel in (False, True):
            got = tpc.awrp_victim_rows(tf, tr_, tc, v, use_kernel=use_kernel)
            np.testing.assert_array_equal(got.numpy(), want)
