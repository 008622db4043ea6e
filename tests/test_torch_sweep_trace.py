"""The sweep engine's trace route (``ops.flat_sweep`` / ``ops.adaptive_sweep``:
one call runs a row group's whole trace) against the JAX reference and the
host oracles, on the CPU.

The same seeded traces go through the port's trace route (on the CPU the
plain versions ``ref.flat_sweep_plain`` / ``ref.adaptive_sweep_plain``, the
eager per-step loop), the JAX engine ``repro.core.jax_policies.
simulate_trace_batched`` (``use_kernel=False``) and the host oracles: every
hit bit must be equal.  Each group's final planes must equal the JAX core's
after the same trace (one ``lax.scan`` of its ``on_access``), bitwise, with
``p`` compared as its float32 bits.  Cases: Table 1, mixed capacities with
dead lanes at ``num_sets`` in {1, 2, 4}, a CAR clock-stress trace, and a
forced-low ``renorm_at`` at ``num_sets=2``, where the eager core renormalizes
sets that the step does not access.  The ``cuda``-marked cases hold the
CUDA kernels to the plain versions on a card and skip without one."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import policy_core as jpc  # noqa: E402
from repro.core.jax_policies import simulate_trace_batched as jbatched  # noqa: E402
from repro_torch.core import make_policy  # noqa: E402
from repro_torch.core.policy_core import (ADAPTIVE_POLICIES, DEVICE_POLICIES,  # noqa: E402
                                          POLICY_IDS, AdaptiveCore)
from repro_torch.core.torch_policies import (_grid_groups, _sweep_groups,  # noqa: E402
                                             simulate_trace_batched)
from repro_torch.core.traces import paper_trace  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

torch.set_num_threads(2)

TABLE1_CAPS = [30, 60, 90, 120, 150, 180, 210, 240]


def host_hits(policy, trace, capacity, num_sets):
    insts = [make_policy(policy, capacity // num_sets) for _ in range(num_sets)]
    return np.array([insts[int(b) % num_sets].access(int(b)) for b in trace], dtype=bool)


def jax_core(g, num_sets, W, renorm_at):
    """The JAX core of one trace-route group, with the same per-row spec."""
    if g.kind == "flat":
        return jpc.FlatCore(pids=tuple(g.pids.tolist()), ways=tuple(g.ways.tolist()),
                            num_sets=num_sets, lanes=W)
    return jpc.AdaptiveCore(kind=g.kind, caps=tuple(g.ways.tolist()), num_sets=num_sets,
                            lanes=2 * W, renorm_at=renorm_at)


def jax_sweep(jcore, ids):
    """(final state, (rows, T) hits) of ``jcore.on_access`` scanned over the
    (T, rows) ids from an empty state."""
    def step(state, x):
        return jcore.on_access(state, x)

    state, hits = jax.jit(lambda s, xs: jax.lax.scan(step, s, xs))(jcore.init(), ids)
    return state, np.asarray(hits).T


def assert_planes_equal(tstate, jstate, where):
    assert tstate._fields == jstate._fields
    for name, a, b in zip(tstate._fields, tstate, jstate):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (where, name)
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=f"{where} plane {name}")


def check_trace_route(traces, policies, caps, *, num_sets=1, renorm_at=None, kinds=None):
    """Hits of the engine's trace route == the JAX engine's == the host
    oracles'; each group's hits and final planes from the plain versions ==
    the JAX core's."""
    traces = np.atleast_2d(np.asarray(traces, dtype=np.int32))
    got = simulate_trace_batched(traces, policies, caps, num_sets=num_sets, device="cpu",
                                 use_kernel=True, _renorm_at=renorm_at).numpy()
    want = np.asarray(jbatched(traces, policies, caps, num_sets=num_sets, use_kernel=False,
                               _renorm_at=renorm_at))
    np.testing.assert_array_equal(got, want)
    for n in range(traces.shape[0]):
        for pi, pol in enumerate(policies):
            for ci, cap in enumerate(caps):
                assert (got[n, pi, ci] == host_hits(pol, traces[n], cap, num_sets)).all(), \
                    (n, pol, cap)
    ways = [c // num_sets for c in caps]
    W = max(ways)
    tr = torch.from_numpy(traces)
    groups = _grid_groups(len(traces), tuple(POLICY_IDS[p] for p in policies), tuple(ways),
                          torch.device("cpu"))
    for g, (hits, state) in zip(groups, _sweep_groups(tr, groups, num_sets, W, renorm_at)):
        if kinds is not None and g.kind not in kinds:
            continue
        ids = traces[g.row_trace.numpy()].T.copy()
        jstate, jhits = jax_sweep(jax_core(g, num_sets, W, renorm_at), ids)
        np.testing.assert_array_equal(hits.numpy(), jhits, err_msg=g.kind)
        assert_planes_equal(state, jstate, g.kind)


@pytest.mark.parametrize("kind", ["flat", "arc", "car"])
def test_table1_trace_route_equals_jax_and_host(kind):
    """``paper_trace()`` x the six device policies x frame sizes 30..240."""
    check_trace_route(paper_trace(), DEVICE_POLICIES, TABLE1_CAPS, kinds=(kind,))


@pytest.mark.parametrize("num_sets", [1, 2, 4])
def test_mixed_caps_dead_lanes_set_associative(num_sets):
    """Every device policy x mixed capacities (the smaller ones padded with
    dead lanes) x 2 traces, one batch per layout."""
    rng = np.random.RandomState(30 + num_sets)
    check_trace_route(rng.randint(0, 80, size=(2, 400)), DEVICE_POLICIES, [8, 16, 32],
                      num_sets=num_sets)


def test_car_clock_stress():
    """Loops and phase changes at small capacities: long clock-hand sweeps
    (every page referenced) and ghost hits both ways."""
    rng = np.random.RandomState(5)
    tr = np.concatenate([np.tile(np.arange(10), 30), rng.randint(0, 12, size=300),
                         rng.randint(6, 40, size=300), np.tile(np.arange(5), 40)])
    check_trace_route(tr, ADAPTIVE_POLICIES, [3, 4, 8])


def renorms_of_other_sets(kind, caps, trace, num_sets, renorm_at):
    """How often the eager core renormalizes a set at a step that accesses
    another set (a set's ctr only falls by renormalization)."""
    core = AdaptiveCore(kind=kind, caps=caps, num_sets=num_sets, renorm_at=renorm_at)
    state, count = core.init(device="cpu"), 0
    for x in trace.tolist():
        before = state.ctr
        state, _ = core.on_access(state, torch.full((core.rows,), x, dtype=torch.int32))
        other = [s for s in range(num_sets) if s != x % num_sets]
        count += int((state.ctr[:, other] < before[:, other]).sum())
    return count


def test_forced_renorm_in_sets_not_accessed():
    """``renorm_at`` 64 at num_sets=2 over 16-lane directories: stamps
    renormalize every few dozen accesses, and the eager core checks every
    set before every access, so sets are renormalized at steps that access
    the other set.  Hits and final planes (stamps and ctr included) equal
    the JAX core's."""
    rng = np.random.RandomState(8)
    traces = rng.randint(0, 24, size=(2, 900))
    caps = [8, 12, 16]
    check_trace_route(traces, DEVICE_POLICIES, caps, num_sets=2, renorm_at=64)
    for kind in ADAPTIVE_POLICIES:
        assert renorms_of_other_sets(kind, (4, 6, 8), traces[0], 2, 64) > 0, kind


def test_cpu_tensors_take_the_plain_versions():
    """On the CPU ``ops.flat_sweep`` / ``ops.adaptive_sweep`` run the plain
    versions and count no launch; the kernel wrappers refuse CPU tensors."""
    from repro_torch.kernels.sweep import adaptive_sweep_kernel, flat_sweep_kernel

    tr = torch.from_numpy(paper_trace()[None, :200].astype(np.int32))
    rt = torch.zeros(2, dtype=torch.int32)
    pids = torch.tensor([POLICY_IDS["awrp"], POLICY_IDS["lfu"]], dtype=torch.int32)
    ways = torch.tensor([16, 8], dtype=torch.int32)
    before = dict(ops.LAUNCHES)
    hits, state = ops.flat_sweep(tr, rt, pids, ways, num_sets=1, lanes=16)
    want = ref.flat_sweep_plain(tr, rt, pids, ways, num_sets=1, lanes=16)
    ahits, astate = ops.adaptive_sweep(tr, rt, ways, kind="car", num_sets=1, lanes=32,
                                       renorm_at=None)
    assert ops.LAUNCHES == before
    assert ops.LAUNCHES["flat_sweep"] == before["flat_sweep"]
    assert ops.LAUNCHES["adaptive_sweep"] == before["adaptive_sweep"]
    assert hits.shape == ahits.shape == (2, 200) and hits.dtype == torch.bool
    assert torch.equal(hits, want[0]) and all(torch.equal(a, b) for a, b in zip(state, want[1]))
    assert state.blocks.shape == (2, 16) and astate.blocks.shape == (2, 1, 32)
    with pytest.raises(ValueError, match="expected CUDA"):
        flat_sweep_kernel(tr, rt, pids, ways, num_sets=1, lanes=16)
    with pytest.raises(ValueError, match="expected CUDA"):
        adaptive_sweep_kernel(tr, rt, ways, kind="arc", num_sets=1, lanes=32, renorm_at=None)


# ---------------------------------------------------------------------------
# on a card: the CUDA kernels == their plain versions
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("num_sets,renorm_at", [(1, None), (2, 64)])
def test_cuda_trace_kernels_match_plain(cuda_device, num_sets, renorm_at):
    """Both trace kernels == their plain versions on the card: hits and
    every final plane, ``p`` bitwise; one launch per group."""
    rng = np.random.RandomState(11 + num_sets)
    traces = np.concatenate([np.stack([paper_trace(seed=s)[:600] for s in range(2)]),
                             rng.randint(0, 60, size=(1, 600))]).astype(np.int32)
    caps = [16, 32, 64]
    ways = tuple(c // num_sets for c in caps)
    W = max(ways)
    groups = _grid_groups(3, tuple(POLICY_IDS[p] for p in DEVICE_POLICIES), ways, cuda_device)
    tr = torch.from_numpy(traces).to(cuda_device)
    before = dict(ops.LAUNCHES)
    got = _sweep_groups(tr, groups, num_sets, W, renorm_at)
    assert ops.LAUNCHES["flat_sweep"] == before["flat_sweep"] + 1
    assert ops.LAUNCHES["adaptive_sweep"] == before["adaptive_sweep"] + 2
    want = _sweep_groups(tr, groups, num_sets, W, renorm_at, flat=ref.flat_sweep_plain,
                         adaptive=ref.adaptive_sweep_plain)
    for g, (gh, gs), (wh, ws) in zip(groups, got, want):
        assert torch.equal(gh, wh), g.kind
        for name, a, b in zip(gs._fields, gs, ws):
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b), (g.kind, name)
