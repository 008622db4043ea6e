"""The port's multi-tenant ``ServeEngine`` against the JAX reference engine on
the CPU (smollm-360m SMOKE_CONFIG, float32, the reference's weights carried
across), mirroring the tenant tests of ``tests/test_serving.py``.

Each test drives both engines with the same requests, one ``generate`` call
each, and holds the port to the reference on every status, ``prefill_cached``,
the per-tenant counters (hits, misses, evictions, accesses, occupancy), the
pressure plane's bits, quotas and ghost hits, and to the host oracles on the
demuxed prompt-key streams."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.base import load_smoke_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve import tenancy as jt  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import smollm_360m  # noqa: E402
from repro_torch.core.policies import make_policy  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.tenancy import AdmissionController, _prompt_key  # noqa: E402

torch.set_num_threads(2)

SMALL = dict(dtype="float32", param_dtype="float32", bounded_kv_pages=3, page_size=8)
TENANT_KEYS = ("policy", "quota", "entries", "occupancy", "hits", "misses", "evictions",
               "accesses", "pressure", "hit_ratio")


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(load_smoke_config("smollm_360m"), **SMALL)
    tcfg = dataclasses.replace(smollm_360m.SMOKE_CONFIG, **SMALL)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(1))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu",
                              dtype=torch.float32)
    return jcfg, jparams, tcfg, tparams


def engines(setup, *, tenants, kv_policy=None, admission=None, **kw):
    """(port engine on the CPU, JAX engine) with the same options."""
    jcfg, jparams, tcfg, tparams = setup
    if kv_policy:
        jcfg = dataclasses.replace(jcfg, kv_policy=kv_policy)
        tcfg = dataclasses.replace(tcfg, kv_policy=kv_policy)
    jadm = None if admission is None else jt.AdmissionController(**admission)
    tadm = None if admission is None else AdmissionController(**admission)
    return (ServeEngine(tcfg, tparams, max_len=96, tenants=tenants, admission=tadm,
                        device="cpu", **kw),
            JServeEngine(jcfg, jparams, max_len=96, tenants=tenants, admission=jadm, **kw))


def tenant_requests(n_good=6, n_hog=6, new=2):
    """A loop-heavy tenant (two prompts in turn: it hits) interleaved with a
    hog (all-distinct prompts at quota 1: pure thrash); (rid, tenant,
    prompt, new tokens) tuples."""
    good = [list(range(1, 17)), list(range(30, 46))]
    out, rid = [], 0
    for i in range(max(n_good, n_hog)):
        if i < n_good:
            out.append((rid, "good", list(good[i % 2]), new))
            rid += 1
        if i < n_hog:
            out.append((rid, "hog", [100 + 16 * i + j for j in range(16)], new))
            rid += 1
    return out


def run_both(teng, jeng, reqs):
    """One request per ``generate`` on both engines; the port's results,
    each held to the reference's status, prefill_cached and tokens."""
    results = {}
    for rid, tenant, prompt, new in reqs:
        got = teng.generate([Request(rid, list(prompt), max_new_tokens=new,
                                     tenant_id=tenant)])[rid]
        want = jeng.generate([JRequest(rid, list(prompt), max_new_tokens=new,
                                       tenant_id=tenant)])[rid]
        assert (got.status, got.prefill_cached, got.tokens) == \
            (want.status, want.prefill_cached, list(want.tokens)), rid
        results[rid] = got
    return results


def assert_tenants_equal(teng, jeng):
    """Per-tenant telemetry, quotas, pressure planes (bits) and engine
    admission counters equal the reference's."""
    got, want = teng.telemetry(), jeng.telemetry()
    for t in teng.tenants:
        for k in TENANT_KEYS:
            key = f"tenant/{t}/{k}"
            w = want[key]
            assert got[key] == (w if isinstance(w, str) else w.item()
                                if hasattr(w, "item") else w), key
    tm, jm = teng.tenant_cache.manager, jeng.tenant_cache.manager
    assert tm._pressure.tobytes() == np.asarray(jm.counters.pressure).tobytes()
    assert tm.quotas == jm.quotas
    for k in ("shed", "deferred", "rebalances", "prefills", "kv_ghost_hits"):
        assert teng.stats[k] == jeng.stats[k], k
    for name, a, b in zip(tm.state._fields, tm.state, jm.state):
        assert np.array_equal(a.numpy(), np.asarray(b)), name


def test_two_tenant_hit_ratios_equal_reference_and_host_oracles(setup):
    quotas = {"good": 3, "hog": 1}
    teng, jeng = engines(setup, tenants=quotas)
    reqs = tenant_requests()
    results = run_both(teng, jeng, reqs)
    assert all(r.status == "ok" for r in results.values())
    assert_tenants_equal(teng, jeng)
    oracles = {t: make_policy("awrp", q) for t, q in quotas.items()}
    expect = {t: [0, 0] for t in quotas}
    for _, tenant, prompt, _ in reqs:
        expect[tenant][0] += int(oracles[tenant].access(_prompt_key(teng._align(prompt))))
        expect[tenant][1] += 1
    tel = teng.telemetry()
    for t in quotas:
        assert (tel[f"tenant/{t}/hits"], tel[f"tenant/{t}/accesses"]) == tuple(expect[t])
    assert tel["tenant/hog/pressure"] > 0.3 > tel["tenant/good/pressure"]


def test_admission_sheds_hog_without_perturbing_other_tenant(setup):
    quotas = {"good": 3, "hog": 1}
    adm = dict(defer_at=0.3, shed_at=0.45, warmup=3)
    teng, jeng = engines(setup, tenants=quotas, admission=adm)
    _, _, tcfg, tparams = setup
    solo = ServeEngine(tcfg, tparams, max_len=96, tenants={"good": 3}, device="cpu")
    reqs = tenant_requests(n_good=5, n_hog=8)
    results = run_both(teng, jeng, reqs)
    for rid, tenant, prompt, new in reqs:
        if tenant == "good":
            solo.generate([Request(rid, list(prompt), max_new_tokens=new, tenant_id="good")])
    statuses = {t: [results[rid].status for rid, tt, _, _ in reqs if tt == t]
                for t in quotas}
    assert "shed" in statuses["hog"] and "deferred" in statuses["hog"]
    assert all(s == "ok" for s in statuses["good"])
    assert_tenants_equal(teng, jeng)
    both, alone = teng.telemetry(), solo.telemetry()
    for k in ("hits", "misses", "hit_ratio"):
        assert both[f"tenant/good/{k}"] == alone[f"tenant/good/{k}"]


def test_shed_request_mutates_nothing(setup):
    """A shed request leaves every plane, counter, store and KV session
    bitwise as it was; the only change is one probation decay of the shed
    tenant's pressure."""
    teng, jeng = engines(setup, tenants={"hog": 1, "calm": 2}, kv_policy="arc_adaptive",
                         admission=dict(defer_at=0.1, shed_at=0.2, warmup=1),
                         kv_mode="paged")
    reqs = [(i, "hog", [200 + 16 * i + j for j in range(16)], 2) for i in range(6)]
    run_both(teng, jeng, reqs)
    mgr = teng.tenant_cache.manager
    assert teng.admission.decide(mgr, "hog") == "shed"
    state = [t.clone() for t in mgr.state]
    ctr = [t.clone() for t in mgr.counters]
    stores = {t: dict(s) for t, s in teng.tenant_cache.stores.items()}
    sessions = {t: {n: [x.clone() for x in s] for n, s in d.items()}
                for t, d in teng._kv_sessions.items()}
    stats = dict(teng.stats)
    p = np.float32(mgr.pressure("hog"))
    out = run_both(teng, jeng, [(99, "hog", list(range(1, 17)), 4)])
    assert out[99].status == "shed" and out[99].tokens == []
    for a, b in zip(state, mgr.state):
        assert torch.equal(a, b)
    for a, b in zip(ctr[:3], mgr.counters[:3]):
        assert torch.equal(a, b)
    assert {t: dict(s) for t, s in teng.tenant_cache.stores.items()} == stores
    assert sessions.keys() == teng._kv_sessions.keys()
    for t, d in sessions.items():
        for n, s in d.items():
            assert all(torch.equal(a, b) for a, b in zip(s, teng._kv_sessions[t][n]))
    assert {k: v for k, v in teng.stats.items() if k != "shed"} == \
        {k: v for k, v in stats.items() if k != "shed"}
    assert teng.stats["shed"] == stats["shed"] + 1
    one_a = np.float32(1) - np.float32(mgr.pressure_alpha)
    assert np.float32(mgr.pressure("hog")).tobytes() == (p * one_a).tobytes()
    assert mgr.pressure("calm") == 0.0
    assert_tenants_equal(teng, jeng)


def test_deferred_then_completed_equals_unpressured(setup):
    """Every request defers (defer_at 0, warmup 0) and none sheds: each
    completes with ``status="deferred"`` and is otherwise what an accepted
    run gives: tokens, prefix hits, per-tenant telemetry, engine stats."""
    teng, jeng = engines(setup, tenants={"t": 3},
                         admission=dict(defer_at=0.0, shed_at=100.0, warmup=0))
    _, _, tcfg, tparams = setup
    plain = ServeEngine(tcfg, tparams, max_len=96, tenants={"t": 3}, device="cpu")
    prompts = [list(range(1, 17)), list(range(30, 46)), list(range(1, 17))]
    reqs = [(i, "t", p, 4) for i, p in enumerate(prompts)]
    got = run_both(teng, jeng, reqs)
    for i, p in enumerate(prompts):
        o = plain.generate([Request(i, list(p), max_new_tokens=4, tenant_id="t")])[i]
        assert got[i].status == "deferred" and o.status == "ok"
        assert (got[i].tokens, got[i].prefill_cached) == (o.tokens, o.prefill_cached)
    td, tp = teng.telemetry(), plain.telemetry()
    keys = {k for k in td if k.startswith("tenant/t/")}
    assert keys == {k for k in tp if k.startswith("tenant/t/")}
    assert {k: td[k] for k in keys} == {k: tp[k] for k in keys}
    timing = ("deferred", "prefill_s", "decode_s")
    assert teng.stats["deferred"] == len(prompts) and plain.stats["deferred"] == 0
    assert {k: v for k, v in teng.stats.items() if k not in timing} == \
        {k: v for k, v in plain.stats.items() if k not in timing}
    assert_tenants_equal(teng, jeng)


def test_auto_rebalance_equals_reference(setup):
    """``auto_rebalance``: each insert that leaves a tenant at the defer
    threshold moves a quota lane to it from the coldest tenant; quotas,
    rebalance counts, shrunk stores and counters equal the reference's."""
    adm = dict(defer_at=0.15, shed_at=0.95, warmup=100)
    quotas = {"good": 3, "idle": 2, "hog": 1}
    teng, jeng = engines(setup, tenants=quotas, admission=adm, auto_rebalance=True)
    reqs = [(100, "idle", list(range(50, 66)), 2), (101, "idle", list(range(70, 86)), 2)]
    reqs += tenant_requests(n_good=4, n_hog=7)
    run_both(teng, jeng, reqs)
    assert teng.stats["rebalances"] >= 1
    assert teng.tenant_cache.manager.quotas != quotas
    assert teng.tenant_cache.stores.keys() == jeng.tenant_cache.stores.keys()
    for t in quotas:
        assert set(teng.tenant_cache.stores[t]) == set(jeng.tenant_cache.stores[t])
    assert_tenants_equal(teng, jeng)


def test_ghost_hit_feed_is_per_tenant(setup):
    """arc_adaptive paged KV: tenant A's follow-up turn interleaved with
    tenant B's first request.  A's ghost hits and ``p`` equal the reference
    engine's and a single-tenant engine's that runs A's two turns alone:
    the sessions are per tenant."""
    teng, jeng = engines(setup, tenants={"a": 3, "b": 3}, kv_policy="arc_adaptive",
                         kv_mode="paged")
    rng = np.random.RandomState(0)
    pa, pb = (rng.randint(1, 512, size=16).tolist() for _ in range(2))
    first = run_both(teng, jeng, [(0, "a", pa, 30)])
    run_both(teng, jeng, [(1, "b", pb, 30), (2, "a", pa + first[0].tokens, 30)])
    _, _, tcfg, tparams = setup
    solo = ServeEngine(dataclasses.replace(tcfg, kv_policy="arc_adaptive"), tparams,
                       max_len=96, kv_mode="paged", device="cpu")
    r0 = solo.generate([Request(0, list(pa), max_new_tokens=30)])[0]
    solo.generate([Request(2, pa + r0.tokens, max_new_tokens=30)])
    got, want, alone = teng.telemetry(), jeng.telemetry(), solo.telemetry()
    assert got["kv/a/ghost_hits"] > 0
    for k in ("ghost_hits", "p_max", "p_mean"):
        assert got[f"kv/a/{k}"] == float(want[f"kv/a/{k}"]) == alone[f"kv/default/{k}"], k
        assert got[f"kv/b/{k}"] == float(want[f"kv/b/{k}"]), k
    assert got["kv/b/ghost_hits"] == 0
    for name, x, y in zip(jeng._kv_sessions["a"][0]._fields, teng._kv_sessions["a"]["u0"],
                          jeng._kv_sessions["a"][0]):
        assert np.array_equal(x.numpy(), np.asarray(y)), name
    assert_tenants_equal(teng, jeng)


@pytest.mark.parametrize("policy", ["lru", "prebuilt"])
def test_prefix_policy_takes_a_name_or_a_policy(setup, policy):
    _, _, tcfg, tparams = setup
    if policy == "prebuilt":
        policy = make_policy("fifo", 8)
    eng = ServeEngine(tcfg, tparams, max_len=96, prefix_policy=policy, device="cpu")
    eng.generate([Request(0, list(range(1, 17)), max_new_tokens=2)])
    tel = eng.telemetry()
    assert tel["prefix/policy"] == ("lru" if isinstance(policy, str) else "fifo")
    assert tel["serve/shed"] == tel["serve/deferred"] == tel["serve/rebalances"] == 0


def test_launch_serve_tenants_runs_on_cpu(capsys):
    results = serve_cli.main(["--device", "cpu", "--smoke", "--dtype", "float32",
                              "--requests", "6", "--new-tokens", "4", "--prompt-len", "64",
                              "--kv-mode", "paged", "--fused", "--kv-pages", "1",
                              "--repeat-prompts", "--tenants", "a=2,b=1",
                              "--auto-rebalance"])
    out = capsys.readouterr().out
    assert len(results) == 6 and all(r.status == "ok" for r in results.values())
    # a (quota 2) still holds its first prompt; b (quota 1) evicted its own
    assert results[4].prefill_cached and not results[5].prefill_cached
    assert "tenant a: quota=" in out and "admission: shed=0" in out
