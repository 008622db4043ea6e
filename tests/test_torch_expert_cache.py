"""The port's expert cache (``repro_torch.cache.expert_cache``) and the prefix
cache's ``entry_bytes`` against the JAX reference on the CPU, mirroring
``tests/test_serving.py``'s expert-cache and telemetry tests.

Hits, misses, transfers and hit ratios are integers or ratios of integers
and must be equal: the port's host path (one oracle per layer), its device
path (one policy core of ``n_layers`` rows stepped by ``ops.flat_stream`` /
``ops.adaptive_stream``, whose plain versions run here), the reference's
host path and its device path (the jitted core), for all six device
policies, through ``route`` and ``route_step``.  The device path makes one
stream call per ``route`` / ``route_step`` and none for an empty route.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.cache import paged_kv as jpk  # noqa: E402
from repro.cache.expert_cache import ExpertCacheRuntime as JRuntime  # noqa: E402
from repro.cache.expert_cache import simulate_router_trace as jsimulate  # noqa: E402
from repro.cache.prefix_cache import PrefixCache as JPrefixCache  # noqa: E402
from repro_torch.cache import paged_kv as tpk  # noqa: E402
from repro_torch.cache.expert_cache import (  # noqa: E402
    ExpertCacheRuntime, router_trace_from_logits, simulate_router_trace)
from repro_torch.cache.prefix_cache import PrefixCache  # noqa: E402
from repro_torch.configs import smollm_360m  # noqa: E402
from repro_torch.core.policies import LRU  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmarks"))
from expert_cache_bench import CASES, _trace  # noqa: E402

torch.set_num_threads(2)

POLICIES = ("awrp", "lru", "fifo", "lfu", "arc", "car")


def _device(n_layers, capacity, policy):
    return ExpertCacheRuntime(n_layers, capacity, policy, device="cpu")


def _host(n_layers, capacity, policy):
    return ExpertCacheRuntime(n_layers, capacity, policy, device="host")


@pytest.fixture
def stream_calls(monkeypatch):
    """Counts the device path's stream calls (``ops.LAUNCHES`` counts CUDA
    launches only)."""
    calls = {"n": 0}
    for name in ("flat_stream", "adaptive_stream"):
        fn = getattr(ops, name)

        def counted(*args, fn=fn, **kw):
            calls["n"] += 1
            return fn(*args, **kw)

        monkeypatch.setattr(ops, name, counted)
    return calls


def test_simulate_router_trace_equals_reference():
    rng = np.random.RandomState(0)
    # zipf-hot experts with a phase change halfway (64 experts, cache 16)
    t1 = rng.zipf(1.5, size=2000) % 64
    t2 = (rng.zipf(1.5, size=2000) % 64 + 17) % 64
    trace = np.concatenate([t1, t2])
    want = jsimulate(POLICIES, trace, capacity=16, expert_bytes=100 << 20)
    got = simulate_router_trace(POLICIES, trace, capacity=16, expert_bytes=100 << 20)
    assert got == want
    assert got["awrp"]["hit_ratio"] >= got["fifo"]["hit_ratio"]
    idx = rng.randint(0, 8, size=(5, 2))
    assert np.array_equal(router_trace_from_logits(idx), idx.reshape(-1))


@pytest.mark.parametrize("device", [False, True])
def test_runtime_counts(device):
    rt = _device(2, 2, "awrp") if device else _host(2, 2, "awrp")
    rt.route(0, [1, 2])
    rt.route(0, [1, 2])
    rt.route(1, [3, 3])
    assert rt.accesses == 6
    assert rt.transfers == 3  # 1,2 cold + 3 cold (second 3 hits)
    assert 0 < rt.hit_ratio < 1


@pytest.mark.parametrize("device", [False, True])
def test_route_miss_accounting(device, stream_calls):
    """route()'s return value, .transfers and .accesses stay consistent
    under hits, misses and evictions, per layer; an empty router step
    launches nothing and counts nothing."""
    rt = _device(2, 2, "lru") if device else _host(2, 2, "lru")
    assert rt.route(0, [1, 2]) == 2  # both cold
    assert rt.route(0, [1, 2]) == 0  # both resident
    assert rt.route(0, [3]) == 1  # evicts LRU expert 1
    assert rt.route(0, [1]) == 1  # 1 was evicted: miss again
    assert rt.route(1, [1]) == 1  # layers are independent rows
    calls = stream_calls["n"]
    assert rt.route(0, []) == 0  # empty router step: no accounting drift
    assert stream_calls["n"] == calls
    assert stream_calls["n"] == (5 if device else 0)
    assert rt.accesses == 7 and rt.transfers == 5 and rt.hit_ratio == 2 / 7
    t = rt.telemetry()
    assert t["policy"] == "lru" and t["backend"] == ("device" if device else "host")
    assert t["transfers"] == 5 and t["accesses"] == 7
    with pytest.raises(IndexError):
        rt.route(2, [1])


@pytest.mark.parametrize("policy", POLICIES)
def test_device_path_matches_host_and_reference(policy, stream_calls):
    """Interleaved per-layer routes and whole-step route_steps: the port's
    device and host paths and the reference's device and host paths return
    the same misses at every call; one stream call per call."""
    rng = np.random.RandomState(4)
    runtimes = [_host(3, 4, policy), _device(3, 4, policy),
                JRuntime(n_layers=3, capacity=4, policy=policy),
                JRuntime(n_layers=3, capacity=4, policy=policy, device=True)]
    for step in range(18):
        if step % 3 == 2:
            idx = rng.randint(0, 10, size=(3, 2))
            got = [rt.route_step(idx) for rt in runtimes]
        else:
            layer = int(rng.randint(0, 3))
            experts = rng.randint(0, 10, size=2).tolist()
            got = [rt.route(layer, experts) for rt in runtimes]
        assert len(set(got)) == 1, f"step {step}: {got}"
    assert stream_calls["n"] == 18
    for rt in runtimes[1:]:
        assert (rt.accesses, rt.transfers, rt.hit_ratio) == \
            (runtimes[0].accesses, runtimes[0].transfers, runtimes[0].hit_ratio)
    assert runtimes[1].telemetry() == {**runtimes[3].telemetry()}


@pytest.mark.parametrize("policy", POLICIES)
def test_route_by_layer_equals_route_step(policy):
    rng = np.random.RandomState(9)
    by_step, by_layer = _device(4, 3, policy), _device(4, 3, policy)
    for _ in range(6):
        idx = rng.zipf(1.3, size=(4, 2)) % 8
        m_step = by_step.route_step(idx)
        m_layer = sum(by_layer.route(layer, idx[layer]) for layer in range(4))
        assert m_step == m_layer
    for a, b in zip(by_step.state, by_layer.state):
        assert torch.equal(a, b)


@pytest.mark.parametrize("policy", POLICIES)
def test_bench_trace_device_equals_host_oracles(policy):
    """One ``route(0, trace)`` of the expert-cache benchmark's phi3.5 case
    (16 experts, capacity 8, two phases; cut to 600 accesses) equals the host
    oracle and the reference's ``simulate_router_trace``."""
    name, E, cap, _mb, alpha, phases = CASES[1]
    trace = _trace(E, alpha, phases, n=600)
    dev = _device(1, cap, policy)
    misses = dev.route(0, trace.tolist())
    want = jsimulate([policy], trace, cap)[policy]["transfers"]
    assert misses == want == simulate_router_trace([policy], trace, cap)[policy]["transfers"]


def test_route_step_shape_validation():
    rt = _device(2, 2, "awrp")
    with pytest.raises(ValueError, match="n_layers"):
        rt.route_step(np.zeros((3, 2), np.int32))
    with pytest.raises(ValueError, match="n_layers"):
        _host(2, 2, "awrp").route_step(np.zeros((2,), np.int32))


def test_rejects_shared_instance_across_layers():
    """A prebuilt policy instance can only back a single host layer, and the
    device path (the default) takes a policy name only."""
    with pytest.raises(ValueError, match="shared across layers"):
        ExpertCacheRuntime(n_layers=2, capacity=2, policy=LRU(2), device="host")
    rt = ExpertCacheRuntime(n_layers=1, capacity=2, policy=LRU(2), device="host")
    assert rt.route(0, [1]) == 1
    assert rt.telemetry()["policy"] == "lru"
    with pytest.raises(ValueError, match="NAME"):
        ExpertCacheRuntime(1, 2, LRU(2), device="cpu")
    with pytest.raises(ValueError, match="NAME"):
        ExpertCacheRuntime(1, 2, LRU(2))


def test_device_path_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError):
        ExpertCacheRuntime(2, 2, "awrp")


def test_entry_bytes_equals_reference_on_equal_payloads():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 1, 64)).astype(np.float32)
    kv = rng.standard_normal((3, 2, 8, 16)).astype(np.float32)
    jpool = jpk.init_pool(2, 4, 8, 16, jnp.bfloat16)
    tpool = tpk.init_pool(2, 4, 8, 16, torch.bfloat16, device="cpu")
    jpay = (jnp.asarray(logits), {"blocks": {"u0": jpool, "t0": {"k": jnp.asarray(kv)}}})
    tpay = (torch.from_numpy(logits),
            {"pos": 8, "blocks": {"u0": tpool, "t0": {"k": torch.from_numpy(kv)}}})
    jc, tc = JPrefixCache(capacity=2), PrefixCache(capacity=2)
    for c, pay in ((jc, jpay), (tc, tpay)):
        c.insert([1, 2], pay)
        c.insert([3, 4], pay)
    assert tc.entry_bytes() == jc.entry_bytes() > 0
    want = 2 * (logits.nbytes + kv.nbytes + sum(t.numel() * t.element_size() for t in tpool))
    assert tc.entry_bytes() == want


@pytest.fixture(scope="module")
def engine():
    cfg = dataclasses.replace(smollm_360m.SMOKE_CONFIG, dtype="float32",
                              param_dtype="float32")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    return ServeEngine(cfg, params, max_len=96, device="cpu")


def test_engine_telemetry_mounts_expert_namespace(engine):
    """``expert/...`` appears only with a runtime attached, beside
    ``prefix/...`` under the same policy name without collision."""
    engine.generate([Request(50, list(range(2, 18)), max_new_tokens=2)])
    t = engine.telemetry()
    assert t["prefix/policy"] == "awrp"
    assert not any(k.startswith("expert/") for k in t)
    rt = _host(1, 2, "awrp")
    engine.expert_cache = rt
    rt.route(0, [5])
    t = engine.telemetry()
    assert t["expert/policy"] == t["prefix/policy"] == "awrp"
    assert t["expert/transfers"] == 1 and t["expert/backend"] == "host"
    engine.expert_cache = None
    eng = ServeEngine(engine.cfg, engine.params, max_len=96, device="cpu",
                      expert_cache=_device(2, 2, "arc"))
    eng.expert_cache.route_step(np.array([[1, 2], [3, 3]]))
    t = eng.telemetry()
    assert t["expert/backend"] == "device" and t["expert/accesses"] == 4
    assert t["expert/transfers"] == 3
