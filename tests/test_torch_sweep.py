"""The port's batched sweep engine and ``sweep()`` (``repro_torch.core``)
against the JAX engine (``repro.core.jax_policies``), the JAX ``sweep`` and
the host oracles, on the CPU.

Hit bits, hit ratios and the ``hit_ratio_table`` strings are compared
exactly, on both routes of the engine (the trace kernels' plain versions
and the eager loop): nothing here sums floats."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import simulator as jsim  # noqa: E402
from repro.core.jax_policies import access_sets as jaccess_sets  # noqa: E402
from repro.core.jax_policies import init_set_state as jinit_set_state  # noqa: E402
from repro.core.jax_policies import simulate_trace_batched as jbatched  # noqa: E402
from repro_torch.core import hit_ratio_table, make_policy, sweep  # noqa: E402
from repro_torch.core.torch_policies import (  # noqa: E402
    ADAPTIVE_POLICIES,
    DEVICE_POLICIES,
    JAX_POLICIES,
    access_sets,
    init_set_state,
    simulate_trace_batched,
    simulate_trace_sets,
)
from repro_torch.core.traces import paper_trace, trace_zipf  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

torch.set_num_threads(2)

TABLE1_CAPS = [30, 60, 90, 120, 150, 180, 210, 240]


def host_hits_sets(policy, trace, capacity, num_sets):
    per = capacity // num_sets
    insts = {s: make_policy(policy, per) for s in range(num_sets)}
    return np.array([insts[int(b) % num_sets].access(int(b)) for b in trace], dtype=bool)


def run(traces, policies, caps, **kw):
    return simulate_trace_batched(traces, policies, caps, device="cpu", **kw).numpy()


@pytest.fixture(scope="module")
def table1_jax():
    tr = paper_trace()
    return tr, np.asarray(jbatched(tr, DEVICE_POLICIES, TABLE1_CAPS))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_table1_grid_equals_jax(table1_jax, use_kernel):
    """``paper_trace()`` x the six device policies x caps 30..240: every hit
    bit equal to the JAX engine, on both routes."""
    tr, want = table1_jax
    got = run(tr, DEVICE_POLICIES, TABLE1_CAPS, use_kernel=use_kernel)
    assert got.shape == want.shape == (1, 6, 8, len(tr)) and got.dtype == np.bool_
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("num_sets", [1, 4, 8])
def test_mixed_caps_set_associative_equals_jax_and_host(num_sets):
    """Every device policy x mixed capacities x 2 traces in one batch
    (padded-ways masking for the smaller caps), against the JAX engine and
    the host oracles (``tests/test_batched_sweep.py`` mirrored)."""
    rng = np.random.RandomState(3)
    traces = rng.randint(0, 80, size=(2, 400))
    caps = [8, 16, 32]
    got = run(traces, DEVICE_POLICIES, caps, num_sets=num_sets, use_kernel=True)
    np.testing.assert_array_equal(
        got, np.asarray(jbatched(traces, DEVICE_POLICIES, caps, num_sets=num_sets)))
    for n in range(2):
        for pi, pol in enumerate(DEVICE_POLICIES):
            for ci, cap in enumerate(caps):
                want = host_hits_sets(pol, traces[n], cap, num_sets)
                assert (got[n, pi, ci] == want).all(), (pol, cap, num_sets, n)


def test_routes_agree_on_mixed_sets_grid():
    """Trace route == eager route on a multi-trace set-associative grid; on
    the CPU the trace route runs the trace kernels' plain versions and
    counts no launch."""
    traces = np.stack([paper_trace(seed=s)[:300] for s in range(3)])
    before = dict(ops.LAUNCHES)
    a = run(traces, DEVICE_POLICIES, [30, 60, 90], num_sets=2, use_kernel=True)
    b = run(traces, DEVICE_POLICIES, [30, 60, 90], num_sets=2, use_kernel=False)
    assert ops.LAUNCHES == before  # CPU tensors: plain version, no launches
    assert ops.LAUNCHES["flat_sweep"] == before["flat_sweep"]
    assert ops.LAUNCHES["adaptive_sweep"] == before["adaptive_sweep"]
    np.testing.assert_array_equal(a, b)


def test_padded_ways_masking_edge():
    tr = trace_zipf(500, 60, 0.9, seed=7)
    mixed = run(tr, DEVICE_POLICIES, [4, 32])
    for ci, cap in enumerate([4, 32]):
        np.testing.assert_array_equal(mixed[:, :, ci], run(tr, DEVICE_POLICIES, [cap])[:, :, 0])


def test_clock_stress_and_forced_renorm_equal_host():
    """Loop + phase-change traces for ARC/CAR at small caps, with a
    renormalization threshold low enough to fire every few accesses."""
    rng = np.random.RandomState(5)
    tr = np.concatenate([np.tile(np.arange(10), 30), rng.randint(0, 12, size=300),
                         rng.randint(6, 40, size=300)])
    got = run(tr, ADAPTIVE_POLICIES, [3, 4, 8], _renorm_at=64)
    np.testing.assert_array_equal(
        got, np.asarray(jbatched(tr, ADAPTIVE_POLICIES, [3, 4, 8], _renorm_at=64)))
    for pi, pol in enumerate(ADAPTIVE_POLICIES):
        for ci, cap in enumerate([3, 4, 8]):
            assert (got[0, pi, ci] == host_hits_sets(pol, tr, cap, 1)).all(), (pol, cap)


@pytest.mark.parametrize("policy", JAX_POLICIES)
def test_simulate_trace_sets_and_access_sets(policy):
    tr = trace_zipf(250, 40, 0.9, seed=13)
    want = host_hits_sets(policy, tr, 16, 4)
    hits = simulate_trace_sets(tr, 16, policy=policy, num_sets=4, device="cpu")
    assert (hits.numpy() == want).all()
    state = init_set_state(16, 4, device="cpu")
    jstate = jinit_set_state(16, 4)
    for i, b in enumerate(tr[:120]):
        state, h = access_sets(state, int(b), policy=policy, use_kernel=i % 2 == 0)
        jstate, jh = jaccess_sets(jstate, jnp.asarray(b), policy=policy)
        assert bool(h) == bool(jh) == want[i]
        for x, y in zip(state, jstate):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    state1 = init_set_state(8, 1, device="cpu")
    state1, h = access_sets(state1, 3, policy=policy)
    assert state1.blocks.shape == (1, 8) and not bool(h)


def test_input_validation():
    tr = np.arange(10)
    with pytest.raises(ValueError, match="not divisible"):
        simulate_trace_batched(tr, ["awrp"], [9], num_sets=4, device="cpu")
    with pytest.raises(ValueError, match="not device policies"):
        simulate_trace_batched(tr, ["2q"], [8], device="cpu")
    with pytest.raises(ValueError, match="fit int32"):
        simulate_trace_batched(np.array([1, -2]), ["awrp"], [8], device="cpu")
    with pytest.raises(ValueError, match="fit int32"):
        simulate_trace_batched(np.array([1, 2**32 - 1]), ["awrp"], [8], device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        simulate_trace_batched(tr, [], [8], device="cpu")
    with pytest.raises(ValueError, match=r"\(T,\) or \(N, T\)"):
        simulate_trace_batched(np.zeros((1, 2, 3)), ["awrp"], [8], device="cpu")
    with pytest.raises(ValueError, match="flat-state"):
        access_sets(init_set_state(8, 2, device="cpu"), 1, policy="arc")
    with pytest.raises(ValueError, match="not divisible"):
        init_set_state(9, 2, device="cpu")
    with pytest.raises(ValueError, match="max_ways"):
        init_set_state(8, 1, max_ways=4, device="cpu")


# ---------------------------------------------------------------------------
# sweep() and the Table-1 string
# ---------------------------------------------------------------------------


def test_sweep_equals_host_table_and_jax_sweep():
    """auto dispatch (engine for the six device policies, host for 2q) ==
    the port's all-host sweep == the JAX sweep, exactly, and the rendered
    Table 1 strings are equal."""
    tr = paper_trace()
    caps = TABLE1_CAPS
    pols = ["lru", "fifo", "car", "2q", "arc", "awrp", "lfu"]
    auto = sweep(pols, tr, caps, torch_device="cpu", use_kernel=True)
    host = sweep(pols, tr, caps, device=False)
    want = jsim.sweep(pols, tr, caps)
    assert auto == host == want
    assert list(auto) == pols
    assert hit_ratio_table(auto, caps) == jsim.hit_ratio_table(want, caps)


@pytest.mark.parametrize("num_sets,block_size", [(2, 1), (1, 3)])
def test_sweep_set_associative_and_block_size_equal_jax(num_sets, block_size):
    tr = paper_trace(seed=2)[:500]
    caps = [20, 40]
    kw = dict(num_sets=num_sets, block_size=block_size)
    got = sweep(["awrp", "arc", "opt"], tr, caps, torch_device="cpu", **kw)
    assert got == jsim.sweep(["awrp", "arc", "opt"], tr, caps, **kw)
    assert got == sweep(["awrp", "arc", "opt"], tr, caps, device=False, **kw)


def test_sweep_device_true_and_empty_trace():
    with pytest.raises(ValueError, match="no device implementation"):
        sweep(["awrp", "2q"], [1, 2, 3], [4], device=True, torch_device="cpu")
    res = sweep(["arc", "car"], [1, 2, 1, 3, 1, 2], [2], device=True, torch_device="cpu")
    assert res == jsim.sweep(["arc", "car"], [1, 2, 1, 3, 1, 2], [2], device=True)
    assert sweep(["awrp", "2q"], [], [4, 8], torch_device="cpu") == \
        jsim.sweep(["awrp", "2q"], [], [4, 8])
    # an all-host sweep never needs the engine's device
    assert sweep(["2q"], [1, 2], [2], torch_device="cuda:7") == {"2q": {2: 0.0}}
