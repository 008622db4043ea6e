"""The port's rows mesh (``repro_torch.core.sharding``) against the JAX
reference's unsharded runs, on the CPU.

The contract, as the reference's ``tests/test_sharding.py`` states it:
placing the rows axis across a mesh does not change a decision.  Every hit
bit, ``RowCounters`` field, state plane, drained ring record and admission
code of a sharded port run is bitwise equal to the JAX reference's
unsharded run on the same seeded inputs, for flat and adaptive cores, the
sweep grid (uneven groups and ``num_sets=2`` included), the tenancy
manager, the paged pools and their fused steps, at 1, 2 and 8 shards of
``rows_mesh(devices=("cpu",) * n)``.  Floats that the port computes on its
own (the fused steps' attention output and mass) are held to the unsharded
port bit for bit and to JAX within the paged-KV tests' tolerance.  The
engine under a mesh is held to the unsharded port engine on each shard's
sub-batch (tokens, loop planes, final caches, bit for bit) and its tokens to
the JAX engine's.

JAX is imported inside the CPU tests only: ``python -m pytest -m cuda
tests/test_torch_sharding.py`` runs the ``cuda``-marked cases (a mesh that
repeats the card) on a machine without JAX.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.cache import paged_kv as tpk  # noqa: E402
from repro_torch.core import policy_core as tpc  # noqa: E402
from repro_torch.core import sharding  # noqa: E402
from repro_torch.core.torch_policies import simulate_trace_batched  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serve.tenancy import AdmissionController, TenantCacheManager  # noqa: E402

torch.set_num_threads(2)

MESH_SIZES = (1, 2, 8)
POLICIES = ("awrp", "lru", "fifo", "lfu", "arc", "car")
KVH, G, HD = 2, 2, 8
KVD = KVH * HD
RTOL = ATOL = 2e-5  # f32 attention: summation order only
EPS_TAU = 1e-5  # |mass - tau| below this may flip a reference decision


def cpu_mesh(n: int):
    return sharding.rows_mesh(devices=("cpu",) * n)


def gathered(tree) -> list:
    """Every leaf of a (possibly sharded) tree, gathered."""
    out = []
    sharding.tree_map(out.append, sharding.gather_rows(tree))
    return out


def host(tree) -> list:
    """Every leaf of a (possibly sharded) tree as a numpy array, gathered."""
    return [x.cpu().numpy() for x in gathered(tree)]


def assert_leaves_equal(got: list, want, what: str) -> None:
    import jax

    want = [np.asarray(x) for x in jax.tree.leaves(want)]
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, (what, i, a.dtype, b.dtype)
        assert np.array_equal(a, b), (what, i)


# -- policy cores: decisions and RowCounters ----------------------------------


def _streams(rows, ways, steps, seed):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 3 * ways, size=(steps, rows)).astype(np.int32)
    act = rng.rand(steps, rows) < 0.7
    act[::2] = True
    return ids, act


@functools.lru_cache(maxsize=None)
def _jax_replay(policy, rows=8, ways=4, steps=60, seed=3):
    """The reference's unsharded jitted replay through
    ``on_access_counted``: (hits, counters, final state) on the host."""
    import jax
    import jax.numpy as jnp

    from repro.core import policy_core as jpc

    core, state = jpc.init(policy, rows=rows, ways=ways)
    counters = core.init_counters()
    step = jax.jit(core.on_access_counted)
    hits = []
    for ids, act in zip(*_streams(rows, ways, steps, seed)):
        state, counters, hit = step(state, counters, jnp.asarray(ids), active=jnp.asarray(act))
        hits.append(np.asarray(hit))
    return np.array(hits), jax.tree.map(np.asarray, counters), jax.tree.map(np.asarray, state)


def _port_replay(policy, mesh, rows=8, ways=4, steps=60, seed=3):
    core, state = tpc.init(policy, rows=rows, ways=ways, device="cpu", mesh=mesh)
    counters = core.init_counters(device="cpu", mesh=mesh)
    hits = []
    for ids, act in zip(*_streams(rows, ways, steps, seed)):
        state, counters, hit = core.on_access_counted(state, counters, ids, active=act)
        hits.append(host(hit)[0])
    return np.array(hits), host(counters), host(state), state


@pytest.mark.parametrize("n", MESH_SIZES)
@pytest.mark.parametrize("policy", POLICIES)
def test_core_sharded_replay_matches_reference(policy, n):
    """Flat and adaptive cores replayed with counters under a mesh: hit bits,
    counters and final planes == the reference's unsharded replay."""
    hits, counters, state, sharded = _port_replay(policy, cpu_mesh(n))
    want = _jax_replay(policy)
    assert isinstance(sharded, sharding.RowShards) and len(sharded.shards) == n
    assert np.array_equal(hits, want[0]), "hit bits"
    assert_leaves_equal(counters, want[1], f"{policy} RowCounters")
    assert_leaves_equal(state, want[2], f"{policy} final state")


@pytest.mark.parametrize("policy", ["awrp", "car"])
def test_core_sharded_victim_and_telemetry_match_unsharded(policy):
    core, state = tpc.init(policy, rows=8, ways=4, device="cpu")
    counters = core.init_counters(device="cpu")
    mesh = cpu_mesh(2)
    s_state, s_counters = sharding.shard_rows(core, state, mesh, counters)
    for ids, act in zip(*_streams(8, 4, 30, 1)):
        state, counters, _ = core.on_access_counted(state, counters, ids, active=act)
        s_state, s_counters, _ = core.on_access_counted(s_state, s_counters, ids, active=act)
    assert torch.equal(sharding.gather_rows(core.victim(s_state)), core.victim(state))
    assert torch.equal(sharding.gather_rows(core.occupancy(s_state)), core.occupancy(state))
    got, want = core.row_telemetry(s_state, s_counters), core.row_telemetry(state, counters)
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)


# -- the sweep grid -------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_grid(n_steps, seed, caps, num_sets):
    from repro.core.jax_policies import DEVICE_POLICIES, simulate_trace_batched as jsim
    from repro.core.traces import trace_zipf

    tr = trace_zipf(n_steps, 300, 0.9, seed=seed)
    return tr, np.asarray(jsim(tr, DEVICE_POLICIES, list(caps), num_sets=num_sets))


@pytest.mark.parametrize("n", MESH_SIZES)
def test_sweep_grid_sharded_matches_reference(n):
    tr, want = _jax_grid(600, 7, (30, 60), 1)
    before = dict(ops.LAUNCHES)
    got = simulate_trace_batched(tr, POLICIES, [30, 60], mesh=cpu_mesh(n), use_kernel=True)
    assert got.device.type == "cpu" and np.array_equal(got.numpy(), want)
    assert ops.LAUNCHES == before  # the plain versions launch nothing


@pytest.mark.parametrize("n", (2, 8))
def test_sweep_uneven_group_padding_matches_reference(n):
    """5 capacities: 20 flat rows and 5 rows per adaptive kind, none a
    multiple of 8; the pad rows run real accesses and are sliced off."""
    tr, want = _jax_grid(600, 9, (7, 13, 30, 60, 90), 1)
    got = simulate_trace_batched(tr, POLICIES, [7, 13, 30, 60, 90], mesh=cpu_mesh(n),
                                 use_kernel=True)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", (2, 8))
def test_sweep_multiset_sharded_matches_reference(n):
    tr, want = _jax_grid(500, 11, (16, 32), 2)
    got = simulate_trace_batched(tr, POLICIES, [16, 32], num_sets=2, mesh=cpu_mesh(n),
                                 use_kernel=True)
    assert np.array_equal(got.numpy(), want)


def test_sweep_eager_route_sharded_matches_reference():
    tr, want = _jax_grid(500, 11, (16, 32), 2)
    got = simulate_trace_batched(tr, POLICIES, [16, 32], num_sets=2, mesh=cpu_mesh(2),
                                 use_kernel=False)
    assert np.array_equal(got.numpy(), want)


# -- tenancy --------------------------------------------------------------------


QUOTAS = {"alpha": 4, "beta": 7, "gamma": 3}


@functools.lru_cache(maxsize=None)
def _tenant_stream():
    from repro.core.traces import trace_multi_tenant

    rows, addrs = trace_multi_tenant(300, n_tenants=3, working_set=40, seed=13)
    return np.asarray(rows, np.int32), (np.asarray(addrs) % 1000).astype(np.int32)


BATCH = ["beta", "gamma", "beta", "alpha", "gamma", "beta"]


@functools.lru_cache(maxsize=None)
def _jax_tenants(policy):
    from repro.serve.tenancy import AdmissionController as JAdmission
    from repro.serve.tenancy import TenantCacheManager as JManager

    rows, keys = _tenant_stream()
    mgr = JManager(QUOTAS, policy, ring_capacity=64)
    hits = np.asarray(mgr.access_stream(rows, keys))
    tel = {k: np.asarray(v) for k, v in mgr.row_telemetry().items()}
    adm = JAdmission(defer_at=0.2, shed_at=0.5, warmup=0)
    decided = adm.decide_batch(mgr, BATCH)
    single = [mgr.access("beta", 5), mgr.access("gamma", 999)]
    return hits, tel, decided, single, mgr.drain_trace()


@pytest.mark.parametrize("n", MESH_SIZES)
@pytest.mark.parametrize("policy", ["awrp", "car"])
def test_tenant_manager_sharded_matches_reference(policy, n):
    """3 tenants on n shards: the core pads 3 rows to a multiple of n with
    rows no access touches.  Hits, per-row telemetry, batch admission,
    single accesses and the drained ring (access and admission events,
    field by field, in order) == the reference's unsharded manager."""
    rows, keys = _tenant_stream()
    want_hits, want_tel, want_dec, want_single, want_rec = _jax_tenants(policy)
    mgr = TenantCacheManager(QUOTAS, policy, ring_capacity=64, mesh=cpu_mesh(n))
    assert mgr.core.rows == sharding.pad_rows_to(3, n)
    assert np.array_equal(mgr.access_stream(rows, keys), want_hits)
    tel = mgr.row_telemetry()
    for k in ("hits", "misses", "evictions", "pressure", "occupancy"):
        assert np.array_equal(tel[k][:3], want_tel[k][:3]), k
    assert all(tel["hits"][3:] == 0) and all(tel["occupancy"][3:] == 0)
    adm = AdmissionController(defer_at=0.2, shed_at=0.5, warmup=0)
    assert adm.decide_batch(mgr, BATCH) == want_dec
    assert [mgr.access("beta", 5), mgr.access("gamma", 999)] == want_single
    rec = mgr.drain_trace()
    assert rec.dtype == want_rec.dtype and len(rec) == len(want_rec) == 64
    for name in rec.dtype.names:
        assert np.array_equal(rec[name], want_rec[name]), name


@pytest.mark.parametrize("n", (2, 8))
def test_tenant_rebalance_sharded_matches_unsharded(n):
    rows, keys = _tenant_stream()
    base = TenantCacheManager(QUOTAS, "awrp", device="cpu")
    mgr = TenantCacheManager(QUOTAS, "awrp", mesh=cpu_mesh(n))
    for m in (base, mgr):
        m.access_stream(rows[:150], keys[:150])
    assert mgr.rebalance("beta", 2) == base.rebalance("beta", 2)
    assert np.array_equal(mgr.access_stream(rows[150:], keys[150:]),
                          base.access_stream(rows[150:], keys[150:]))
    assert mgr.decay_pressure("gamma") == base.decay_pressure("gamma")
    got, want = mgr.telemetry(), base.telemetry()
    assert got == want


# -- paged pools and the fused steps ----------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_pool_step():
    import jax

    from repro.cache import paged_kv as jpk

    return jax.jit(jpk.adaptive_core("car", 8, 4).on_access)


@pytest.mark.parametrize("n", MESH_SIZES)
def test_paged_pool_sharded_init_matches_reference(n):
    import jax.numpy as jnp

    from repro.cache import paged_kv as jpk

    mesh = cpu_mesh(n)
    want = jpk.init_adaptive_pool(8, 4, 2, 3, jnp.float32, "car")
    got = tpk.init_adaptive_pool(8, 4, 2, 3, torch.float32, "car", mesh=mesh)
    assert isinstance(got, sharding.RowShards) and len(got.shards) == n
    assert_leaves_equal(host(got), want, "adaptive pool init")
    flat = tpk.init_pool(8, 4, 2, 3, torch.float32, mesh=mesh)
    assert_leaves_equal(host(flat), jpk.init_pool(8, 4, 2, 3, jnp.float32), "pool init")
    # the pool's per-sequence core decides identically on the sharded planes
    tcore = tpk.adaptive_core("car", 8, 4)
    s_j, s_t = want.policy, got.replace([p.policy for p in got.shards])
    jstep = _jax_pool_step()
    for ids in np.random.RandomState(17).randint(0, 6, size=(25, 8)):
        s_j, hit_j = jstep(s_j, jnp.asarray(ids, jnp.int32))
        s_t, hit_t = tcore.on_access(s_t, ids.astype(np.int32))
        assert np.array_equal(host(hit_t)[0], np.asarray(hit_j))
    assert_leaves_equal(host(s_t), s_j, "pool policy state")


def _step_inputs(rng, B):
    q = rng.standard_normal((B, KVH, G, HD)).astype(np.float32)
    nk = (rng.standard_normal((B, KVD)) * 0.3).astype(np.float32)
    nv = (rng.standard_normal((B, KVD)) * 0.3).astype(np.float32)
    return q, nk, nv


def _near_tau(mass, page_start) -> bool:
    ps = np.asarray(page_start)
    tau = np.float32(1.0) / np.maximum((ps >= 0).sum(-1, keepdims=True), 1).astype(np.float32)
    return bool(np.any((np.abs(np.asarray(mass) - tau) < EPS_TAU) & (ps >= 0)))


def _to_port(tree):
    return sharding.tree_map(torch.clone, tree)


@pytest.mark.parametrize("n", MESH_SIZES)
@pytest.mark.parametrize("adaptive", [False, True], ids=["awrp", "car_adaptive"])
def test_fused_steps_sharded_match_reference(adaptive, n):
    """Kernels 4 and 5 (their plain versions here) launched shard by shard
    over evicting page boundaries: out and mass bit for bit the unsharded
    port's, within RTOL/ATOL of JAX's fused step; every plane bitwise the
    reference's (every step restarts from the JAX pool, and a step whose JAX
    mass lies within EPS_TAU of tau is counted and not compared, as in the
    paged-KV tests).  A pool placed with ``init_pool(mesh=)`` and a whole
    pool cut into row views give the same planes."""
    import jax
    import jax.numpy as jnp

    from repro.cache import paged_kv as jpk

    B, P, page = 8, 3, 4
    mesh = cpu_mesh(n)
    if adaptive:
        jcore, tcore = (m.adaptive_core("car_adaptive", B, P) for m in (jpk, tpk))
        jp = jpk.AdaptivePagedPool(jpk.init_pool(B, P, page, KVD, jnp.float32), jcore.init())
        jstep = jax.jit(lambda ap, q, k, v, pos: jpk.fused_adaptive_decode_step(
            ap, q, k, v, pos, page, jcore, interpret=True))

        def tstep(pool, q, k, v, pos, **kw):
            return tpk.fused_adaptive_decode_step(pool, q, k, v, pos, page, tcore, **kw)

        convert = lambda p: tpk.AdaptivePagedPool(  # noqa: E731
            tpk.PagedPool(*(torch.from_numpy(np.array(a)) for a in p.pool)),
            tpk.AdaptiveState(*(torch.from_numpy(np.array(a)) for a in p.policy)))
        sharded = tpk.init_adaptive_pool(B, P, page, KVD, torch.float32, "car_adaptive",
                                         mesh=mesh)
    else:
        jp = jpk.init_pool(B, P, page, KVD, jnp.float32)
        jstep = jax.jit(lambda p, q, k, v, pos: jpk.fused_decode_step(
            p, q, k, v, pos, page, "awrp", interpret=True))

        def tstep(pool, q, k, v, pos, **kw):
            return tpk.fused_decode_step(pool, q, k, v, pos, page, "awrp", **kw)

        convert = lambda p: tpk.PagedPool(*(torch.from_numpy(np.array(a))  # noqa: E731
                                            for a in p))
        sharded = tpk.init_pool(B, P, page, KVD, torch.float32, mesh=mesh)
    rng = np.random.default_rng(4)
    near_tau = 0
    for pos in range((P + 2) * page):
        q, nk, nv = (torch.from_numpy(a) for a in _step_inputs(rng, B))
        tpos = torch.tensor(pos, dtype=torch.int32)
        start = convert(jp)
        out_1, mass_1, pool_1 = tstep(_to_port(start), q, nk, nv, tpos)
        out_m, mass_m, pool_m = tstep(_to_port(start), q, nk, nv, tpos, mesh=mesh)
        assert torch.equal(out_m, out_1) and torch.equal(mass_m, mass_1), pos
        assert all(np.array_equal(a, b) for a, b in zip(host(pool_m), host(pool_1)))
        # the sharded pool from init_pool(mesh=), stepped on from the same planes
        sharded = sharding.shard_rows(None, _to_port(start), mesh)
        out_s, mass_s, sharded = tstep(sharded, q, nk, nv, tpos, mesh=mesh)
        assert isinstance(sharded, sharding.RowShards)
        assert torch.equal(sharding.gather_rows(out_s), out_1), pos
        assert all(np.array_equal(a, b) for a, b in zip(host(sharded), host(pool_1)))
        out_j, mass_j, jp = jstep(jp, jnp.asarray(q.numpy()), jnp.asarray(nk.numpy()),
                                  jnp.asarray(nv.numpy()), jnp.int32(pos))
        np.testing.assert_allclose(out_m.numpy(), out_j, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(mass_m.numpy(), mass_j, rtol=RTOL, atol=ATOL)
        flat_j = jp.pool if adaptive else jp
        if _near_tau(mass_j, flat_j.page_start):
            near_tau += 1
            continue
        got = host(pool_m)
        want = [np.asarray(x) for x in jax.tree.leaves(jp)]
        names = (tpk.PagedPool._fields + tpk.AdaptiveState._fields if adaptive
                 else tpk.PagedPool._fields)
        for name, a, b in zip(names, got, want):
            if name in ("k", "v"):
                np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
            else:
                assert a.dtype == b.dtype and np.array_equal(a, b), (pos, name)
    assert near_tau <= 2, f"{near_tau} steps near tau"


def test_fused_step_batch_not_dividing_the_mesh_runs_unsharded():
    pool = tpk.init_pool(3, 2, 4, KVD, torch.float32, device="cpu")
    rng = np.random.default_rng(0)
    q, nk, nv = (torch.from_numpy(a) for a in _step_inputs(rng, 3))
    pos = torch.tensor(0, dtype=torch.int32)
    a = tpk.fused_decode_step(pool.clone(), q, nk, nv, pos, 4, mesh=cpu_mesh(2))
    b = tpk.fused_decode_step(pool.clone(), q, nk, nv, pos, 4)
    assert all(np.array_equal(x, y) for x, y in zip(host(a), host(b)))


# -- the serving engine -------------------------------------------------------------


SMALL = dict(dtype="float32", param_dtype="float32", bounded_kv_pages=3, page_size=8)
NEW_TOKENS = 30  # 16-token prompts + 30 > 3 pages of 8: the pools evict
N_REQ = 8


def _prompts():
    rng = np.random.RandomState(0)
    return [rng.randint(1, 512, size=16).tolist() for _ in range(N_REQ)]


@pytest.fixture(scope="module")
def engine_setup():
    """The smoke config's parameters, made once: JAX's, carried across to
    the port, and the JAX engine's greedy tokens on the whole batch."""
    import jax

    from repro.configs.base import load_smoke_config
    from repro.models import model as JM
    from repro.serve.engine import Request as JRequest
    from repro.serve.engine import ServeEngine as JServeEngine
    from repro_torch.configs import smollm_360m
    from repro_torch.models.convert import params_from_jax

    jcfg = dataclasses.replace(load_smoke_config("smollm_360m"), **SMALL)
    tcfg = dataclasses.replace(smollm_360m.SMOKE_CONFIG, **SMALL)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(1))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu",
                              dtype=torch.float32)
    jeng = JServeEngine(jcfg, jparams, max_len=64, kv_mode="paged", fused=True)
    want = jeng.generate([JRequest(i, list(p), max_new_tokens=NEW_TOKENS)
                          for i, p in enumerate(_prompts())])
    return tcfg, tparams, {i: r.tokens for i, r in want.items()}


def _serve(cfg, params, prompts, **kw):
    """An engine's one bucket: its results, telemetry and the final caches
    of its decode loop."""
    from repro_torch.serve.engine import Request, ServeEngine

    eng = ServeEngine(cfg, params, max_len=64, kv_mode="paged", fused=True, device="cpu",
                      **kw)
    final = {}
    for name in ("_graph_loop", "_host_loop"):
        orig = getattr(eng, name)

        def wrapped(*a, _orig=orig, **k):
            out = _orig(*a, **k)
            final["caches"] = out[1]
            return out

        setattr(eng, name, wrapped)
    res = eng.generate([Request(i, list(p), max_new_tokens=NEW_TOKENS)
                        for i, p in enumerate(prompts)])
    return eng, {i: r.tokens for i, r in res.items()}, eng.telemetry(), final.get("caches")


LOOP = ("steps", "tokens", "token_hist")


@pytest.mark.parametrize("jit_loop", [True, False], ids=["graph", "host"])
@pytest.mark.parametrize("n", MESH_SIZES)
def test_engine_sharded_matches_unsharded_per_sub_batch(engine_setup, n, jit_loop):
    """``ServeEngine(mesh=)``: each shard's tokens, loop planes and final
    caches (pos, K/V, every pool plane) == an unsharded engine serving that
    shard's requests, bit for bit; the gathered tokens == the JAX engine's
    on the whole batch; the engine's stats and loop planes == the unsharded
    engine's on the whole batch."""
    cfg, params, want_tokens = engine_setup
    prompts = _prompts()
    eng, tokens, tel, _ = _serve(cfg, params, prompts, mesh=cpu_mesh(n), jit_loop=jit_loop)
    assert tokens == want_tokens
    assert len(eng.last_shards) == n
    k = N_REQ // n
    for i, shard in enumerate(eng.last_shards):
        _, sub_tokens, sub_tel, sub_caches = _serve(cfg, params, prompts[i * k:(i + 1) * k],
                                                    jit_loop=jit_loop)
        assert [sub_tokens[j] for j in range(k)] == [tokens[i * k + j] for j in range(k)]
        for name in LOOP:
            assert np.array_equal(shard["planes"][name].numpy(), sub_tel[f"serve/loop/{name}"])
        got, want = host(shard["caches"]), host(sub_caches)
        assert len(got) == len(want) and all(np.array_equal(a, b) for a, b in zip(got, want))
    _, _, whole_tel, _ = _serve(cfg, params, prompts, jit_loop=jit_loop)
    for key in ("serve/tokens", "serve/decode_steps", "serve/kv_evictions", "serve/prefills",
                *(f"serve/loop/{name}" for name in LOOP)):
        assert np.array_equal(tel[key], whole_tel[key]), key
    assert tel["serve/kv_evictions"] > 0


# -- the rows mesh itself ---------------------------------------------------------------


def test_pad_rows_to_rounds_up_to_device_multiples():
    assert sharding.pad_rows_to(3, 8) == 8
    assert sharding.pad_rows_to(8, 8) == 8
    assert sharding.pad_rows_to(9, 8) == 16
    assert sharding.pad_rows_to(5, 1) == 5
    with pytest.raises(ValueError):
        sharding.pad_rows_to(0, 2)


def test_mesh_none_is_the_identity():
    core, state = tpc.init("awrp", rows=4, ways=2, device="cpu")
    counters = core.init_counters(device="cpu")
    assert sharding.shard_rows(core, state, None) is state
    got = sharding.shard_rows(core, state, None, counters)
    assert got[0] is state and got[1] is counters
    assert sharding.gather_rows(state) is state
    _, base = tpc.init("car", rows=4, ways=2, device="cpu", mesh=None)
    assert isinstance(base, tpc.AdaptiveState)
    pool = tpk.init_pool(2, 2, 4, KVD, torch.float32, device="cpu", mesh=None)
    assert isinstance(pool, tpk.PagedPool)
    assert TenantCacheManager(QUOTAS, "awrp", device="cpu", mesh=None).core.rows == 3


def test_shard_rows_places_row_views_and_needs_even_division():
    core, state = tpc.init("awrp", rows=4, ways=2, device="cpu")
    placed = sharding.shard_rows(core, state, cpu_mesh(2))
    assert placed.offsets == (0, 2, 4) and placed.locate(3) == (1, 1)
    assert placed.shards[1].blocks.data_ptr() == state.blocks[2:].data_ptr()  # a view
    assert sharding.shard_rows(core, placed, placed.mesh) is placed
    assert sharding.leaf_spec(state.blocks) == (sharding.ROWS_AXIS, None)
    assert sharding.leaf_spec(torch.zeros(())) == ()
    with pytest.raises(ValueError, match="pad"):
        sharding.shard_rows(core, state, cpu_mesh(8))
    with pytest.raises(ValueError):
        sharding.rows_mesh(3, devices=("cpu",) * 2)


# -- on the card: a mesh that repeats the card ------------------------------------------


@pytest.fixture
def cuda_mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return lambda n: sharding.rows_mesh(devices=("cuda:0",) * n)


@pytest.mark.cuda
@pytest.mark.parametrize("n", (2, 8))
def test_cuda_sweep_sharded_equals_unsharded(cuda_mesh, n):
    """The trace kernels under a mesh of n on one card: n launches per row
    group, hits bitwise the unsharded launch's."""
    tr = np.random.default_rng(3).integers(0, 300, size=(4, 1000))
    want = simulate_trace_batched(tr, POLICIES, [7, 30, 60], device="cuda")
    ops.reset_launches()
    got = simulate_trace_batched(tr, POLICIES, [7, 30, 60], mesh=cuda_mesh(n))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert ops.LAUNCHES["flat_sweep"] == n and ops.LAUNCHES["adaptive_sweep"] == 2 * n


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["awrp", "car"])
def test_cuda_tenancy_sharded_equals_unsharded(cuda_mesh, policy):
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 3, size=400).astype(np.int32)
    keys = rng.integers(0, 40, size=400).astype(np.int32)
    base = TenantCacheManager(QUOTAS, policy, ring_capacity=128)
    mgr = TenantCacheManager(QUOTAS, policy, ring_capacity=128, mesh=cuda_mesh(2))
    assert np.array_equal(mgr.access_stream(rows, keys), base.access_stream(rows, keys))
    a, b = mgr.drain_trace(), base.drain_trace()
    assert all(np.array_equal(a[name], b[name]) for name in a.dtype.names)


@pytest.mark.cuda
@pytest.mark.parametrize("n", (2, 4))
def test_cuda_fused_steps_sharded_equal_unsharded(cuda_mesh, n):
    B, P, page = 4, 3, 64
    dev = torch.device("cuda")
    rng = np.random.default_rng(6)
    core = tpk.adaptive_core("arc_adaptive", B, P)
    pool = tpk.init_pool(B, P, page, KVD, torch.bfloat16, device=dev)
    apool = tpk.init_adaptive_pool(B, P, page, KVD, torch.bfloat16, "arc_adaptive",
                                   device=dev)
    pool_m, apool_m = pool.clone(), apool.clone()
    mesh = cuda_mesh(n)
    for pos in range(2 * page + 1):
        q, nk, nv = (torch.from_numpy(a).to(dev, torch.bfloat16) for a in _step_inputs(rng, B))
        tpos = torch.tensor(pos, dtype=torch.int32, device=dev)
        ops.reset_launches()
        o1, m1, pool = tpk.fused_decode_step(pool, q, nk, nv, tpos, page)
        o2, m2, pool_m = tpk.fused_decode_step(pool_m, q, nk, nv, tpos, page, mesh=mesh)
        assert ops.LAUNCHES["policy_paged_attention"] == (n + 1) * ops.SPLIT_LAUNCHES
        a1, b1, apool = tpk.fused_adaptive_decode_step(apool, q, nk, nv, tpos, page, core)
        a2, b2, apool_m = tpk.fused_adaptive_decode_step(apool_m, q, nk, nv, tpos, page, core,
                                                         mesh=mesh)
        assert torch.equal(o1, o2) and torch.equal(m1, m2) and torch.equal(a1, a2)
        assert torch.equal(b1, b2)
        assert all(torch.equal(x, y) for x, y in zip(gathered(pool), gathered(pool_m)))
        assert all(torch.equal(x, y) for x, y in zip(gathered(apool), gathered(apool_m)))
