"""The port's metrics registry and decode-loop planes (``repro_torch/obs``)
against the JAX reference (``repro/obs``) on the CPU, mirroring
``tests/test_obs.py`` without the decision-trace ring, the OPT oracle and the
mesh cases (not ported).

* ``safe_ratio_plane`` and ``loop_update`` (pure and in place) bitwise equal
  to JAX's on the same seeded inputs;
* the registry: namespacing, mount / replace / unmount, gauges shadowing
  provider values and outliving an unmount, ``Derived`` resolved from the
  pulled ints; a snapshot makes exactly one ``_pull`` and no other host read
  (``Tensor.item``, ``cpu``, ``numpy``, ``tolist``, ``__int__``,
  ``__float__`` and ``__bool__`` patched to raise while the providers run);
  ``_pack`` / ``_split`` round-trip every leaf dtype;
* the engine: a fresh multi-tenant engine snapshots all-zero ratios; the
  planes are equal bit for bit between ``jit_loop=True`` and ``False``;
  ``metrics=False`` drops the planes and the fold, not the behaviour; the
  port engine against the JAX engine (smollm smoke, float32, greedy, the
  same requests): ``serve/loop/*`` bitwise, the tenant counters equal,
  ``pressure`` bitwise in float32, ``hit_ratio`` with ``==``, the kv
  ``p_mean`` / ``p_max`` within P_TOL;
* the exporters: ``prometheus_text`` and ``append_jsonl`` equal to the
  reference's, byte for byte, on the same snapshot dicts;
* spans: accumulation and sync mode waiting on ``ready`` values.
"""

import dataclasses
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import load_smoke_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.obs import export as jexport  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import smollm_360m  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.obs import export, metrics, spans  # noqa: E402
from repro_torch.obs.metrics import (  # noqa: E402
    HIST_BINS, Derived, Registry, loop_planes, loop_update, loop_update_, safe_ratio,
    safe_ratio_plane)
from repro_torch.obs.spans import SpanSet  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

torch.set_num_threads(2)

SMALL = dict(dtype="float32", param_dtype="float32", bounded_kv_pages=3, page_size=8)
#: the kv provider's p_mean / p_max against the reference's (float32 means of
#: the same planes, reduced in another order)
P_TOL = 1e-7
SYNCING = ("item", "cpu", "numpy", "tolist", "__int__", "__float__", "__bool__")


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(load_smoke_config("smollm_360m"), **SMALL)
    tcfg = dataclasses.replace(smollm_360m.SMOKE_CONFIG, **SMALL)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(1))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu",
                              dtype=torch.float32)
    return jcfg, jparams, tcfg, tparams


def _engine(setup, **kw):
    _, _, tcfg, tparams = setup
    kv_policy = kw.pop("kv_policy", None)
    if kv_policy:
        tcfg = dataclasses.replace(tcfg, kv_policy=kv_policy)
    return ServeEngine(tcfg, tparams, max_len=96, device="cpu", **kw)


# -- safe_ratio -----------------------------------------------------------------


def test_safe_ratio_guards_and_exactness():
    assert safe_ratio(0, 0) == 0.0
    assert safe_ratio(3, 4) == 3 / 4
    plane = safe_ratio_plane(torch.tensor([0, 2, 5]), torch.tensor([0, 4, 5]))
    assert plane.dtype == torch.float32
    assert np.array_equal(plane.numpy(), [0.0, 0.5, 1.0])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_safe_ratio_plane_bitwise_equals_jax(seed):
    rng = np.random.RandomState(seed)
    den = rng.randint(0, 50, size=(7, 33)).astype(np.int32)
    den[rng.rand(*den.shape) < 0.3] = 0  # empty rows, no NaN either side
    num = (rng.rand(*den.shape) * (den + 1)).astype(np.int32)
    got = safe_ratio_plane(torch.from_numpy(num), torch.from_numpy(den)).numpy()
    want = np.asarray(jmetrics.safe_ratio_plane(jnp.asarray(num), jnp.asarray(den)))
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()
    assert not np.isnan(got).any()


def test_fresh_surfaces_report_zero_ratio_not_error():
    from repro_torch.cache.expert_cache import ExpertCacheRuntime
    from repro_torch.cache.prefix_cache import PrefixCache
    from repro_torch.core.simulator import SimResult
    from repro_torch.serve.tenancy import TenantCacheManager

    assert PrefixCache(capacity=2).telemetry()["hit_ratio"] == 0.0
    assert ExpertCacheRuntime(n_layers=1, capacity=2, device="host").hit_ratio == 0.0
    assert SimResult("awrp", 4, 1, 0, 0).hit_ratio == 0.0
    mgr = TenantCacheManager({"a": 2, "b": 2}, device="cpu")
    assert all(v["hit_ratio"] == 0.0 for v in mgr.telemetry().values())


# -- the loop planes --------------------------------------------------------------


@pytest.mark.parametrize("form", ["pure", "in_place"])
def test_loop_update_bitwise_equals_jax(form):
    """25 seeded batches through the port's fold and JAX's: every plane
    equal bit for bit after every batch, int32 throughout."""
    vocab, steps, batch = 640, 25, 3
    rng = np.random.RandomState(7)
    toks = rng.randint(0, vocab, size=(steps, batch, 1)).astype(np.int32)
    toks[3, 0, 0] = vocab - 1  # the top bucket's edge
    jfold = jax.jit(functools.partial(jmetrics.loop_update, vocab=vocab))
    got, want = loop_planes("cpu"), jmetrics.loop_planes()
    for t in toks:
        if form == "pure":
            before = {k: v.clone() for k, v in got.items()}
            new = loop_update(got, torch.from_numpy(t), vocab=vocab)
            assert all(torch.equal(got[k], before[k]) for k in got)  # inputs untouched
            got = new
        else:
            assert loop_update_(got, torch.from_numpy(t), vocab=vocab) is got
        want = jfold(want, jnp.asarray(t))
        for k in want:
            w = np.asarray(want[k])
            assert got[k].dtype == torch.int32 and got[k].shape == w.shape, k
            assert got[k].numpy().tobytes() == w.tobytes(), k
    hist = np.zeros(HIST_BINS, np.int64)
    for t in toks.reshape(-1):
        hist[min(t * HIST_BINS // vocab, HIST_BINS - 1)] += 1
    assert int(got["steps"]) == steps and int(got["tokens"]) == steps * batch
    assert np.array_equal(got["token_hist"].numpy(), hist)


def test_loop_planes_are_the_references():
    got, want = loop_planes("cpu"), jmetrics.loop_planes()
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].numpy().tobytes() == np.asarray(want[k]).tobytes()
        assert got[k].dtype == torch.int32


# -- the registry -----------------------------------------------------------------


def _patched_host_reads(m):
    def host_read(*args, **kwargs):
        raise AssertionError("a host read while the providers run")

    saved = {name: getattr(torch.Tensor, name) for name in SYNCING}
    for name in SYNCING:
        m.setattr(torch.Tensor, name, host_read)
    return saved


def _counting_pull(m, saved, calls):
    """Patch ``metrics._pull`` to count its calls and run the real one with
    the host reads restored."""
    orig = metrics._pull

    def pull(leaves):
        calls.append(len(leaves))
        patched = {name: getattr(torch.Tensor, name) for name in SYNCING}
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)
        try:
            return orig(leaves)
        finally:
            for name, fn in patched.items():
                setattr(torch.Tensor, name, fn)

    m.setattr(metrics, "_pull", pull)


def test_registry_snapshot_one_pull_and_no_other_host_read(monkeypatch):
    reg = Registry()
    reg.mount("a", lambda: {
        "hits": torch.tensor(3, dtype=torch.int32),
        "accesses": torch.tensor(4, dtype=torch.int32),
        "hit_ratio": Derived(lambda g: safe_ratio(g["hits"], g["accesses"])),
        "nested": {"plane": torch.arange(3, dtype=torch.int32)},
        "p": torch.tensor(0.1, dtype=torch.float32),
    })
    reg.mount("b", lambda: {"policy": "awrp", "n": 7})
    reg.set_gauge("c/regret", 0.125)
    calls = []
    with monkeypatch.context() as m:
        saved = _patched_host_reads(m)
        _counting_pull(m, saved, calls)
        snap = reg.snapshot()
    assert calls == [4]  # one pull, every tensor leaf in it
    assert snap["a/hits"] == 3 and type(snap["a/hits"]) is int
    assert snap["a/hit_ratio"] == 3 / 4  # derived after the pull, float64
    assert snap["a/p"] == float(np.float32(0.1))
    plane = snap["a/nested/plane"]
    assert isinstance(plane, np.ndarray) and plane.dtype == np.int32
    assert np.array_equal(plane, [0, 1, 2])
    assert snap["b/policy"] == "awrp" and snap["b/n"] == 7
    assert snap["c/regret"] == 0.125


def test_registry_snapshot_equals_the_references():
    """The same provider values through both registries: equal snapshots,
    types included."""
    def tree(mod):
        arr = (lambda x, dt: torch.tensor(x, dtype=dt)) if mod is metrics else \
            (lambda x, dt: jnp.asarray(x, dtype={torch.int32: jnp.int32,
                                                 torch.float32: jnp.float32}[dt]))
        return {"hits": arr(5, torch.int32), "accesses": arr(8, torch.int32),
                "hit_ratio": mod.Derived(lambda g: mod.safe_ratio(g["hits"], g["accesses"])),
                "pressure": arr(0.3, torch.float32),
                "hist": arr([1, 2, 3], torch.int32), "policy": "lru"}

    ours, theirs = Registry(), jmetrics.Registry()
    ours.mount("t", lambda: {"x": tree(metrics)})
    theirs.mount("t", lambda: {"x": tree(jmetrics)})
    a, b = ours.snapshot(), theirs.snapshot()
    assert a.keys() == b.keys()
    for k in b:
        if isinstance(b[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
        else:
            assert type(a[k]) is type(b[k]) and a[k] == b[k], k


def test_registry_mount_replace_unmount_and_gauge_shadow():
    reg = Registry()
    reg.mount("x", lambda: {"v": 1})
    reg.mount("x", lambda: {"v": 2})  # replace
    assert reg.snapshot() == {"x/v": 2}
    reg.set_gauge("x/v", 9)  # gauges shadow provider values
    assert reg.snapshot() == {"x/v": 9}
    reg.unmount("x")
    assert reg.snapshot() == {"x/v": 9}  # the sticky gauge outlives the unmount
    reg.unmount("x")  # no-op, no raise


def test_pack_split_round_trips_every_leaf_dtype():
    """The device path of ``_pull`` (one byte buffer, split on the host) on
    CPU tensors: every dtype and shape comes back bit for bit, odd byte
    offsets included."""
    leaves = [torch.tensor(True), torch.tensor([1, 0, 1], dtype=torch.bool),
              torch.tensor(-7, dtype=torch.int64), torch.arange(5, dtype=torch.int32),
              torch.tensor([3], dtype=torch.uint8), torch.tensor(0.1, dtype=torch.float32),
              torch.randn(2, 3, generator=torch.Generator().manual_seed(0)),
              torch.tensor([1.5, -2.25], dtype=torch.float16),
              torch.zeros((0,), dtype=torch.int32), torch.tensor(2.0**-60, dtype=torch.float64),
              torch.arange(6, dtype=torch.int32).reshape(2, 3)[:, 1]]  # a strided view
    got = metrics._split(metrics._pack(leaves).numpy(), leaves)
    for t, g in zip(leaves, got, strict=True):
        assert g.dtype == t.numpy().dtype and g.shape == tuple(t.shape)
        assert g.tobytes() == t.contiguous().numpy().tobytes()
        assert g.flags.writeable and g.flags.aligned
    pulled = metrics._pull(leaves + [torch.tensor(1.0, dtype=torch.bfloat16)])
    assert pulled[-1].dtype == np.float32 and float(pulled[-1]) == 1.0


# -- the engine ---------------------------------------------------------------------


def test_fresh_engine_snapshot_is_all_zero_ratios(setup):
    eng = _engine(setup, tenants={"a": 2, "b": 2})
    t = eng.telemetry()
    assert t["tenant/a/hit_ratio"] == 0.0 and t["tenant/b/hit_ratio"] == 0.0
    assert t["serve/loop/steps"] == 0 and t["serve/loop/tokens"] == 0
    assert t["serve/prefills"] == 0 and t["serve/shed"] == 0
    assert t["serve/loop/token_hist"].dtype == np.int32


@pytest.mark.parametrize("tenants", [None, {"a": 2, "b": 1}], ids=["single", "tenants"])
def test_engine_snapshot_one_pull_and_no_other_host_read(monkeypatch, setup, tenants):
    """A served engine with every provider populated (the prompt cache or
    the tenant rows, the kv sessions, the loop planes): one ``_pull`` per
    snapshot and nothing else read back while the providers run."""
    eng = _engine(setup, tenants=tenants, kv_mode="paged", fused=True,
                  kv_policy="arc_adaptive")
    prompt = list(range(1, 17))
    for i, tenant in enumerate(("a", "b", "a")):
        eng.generate([Request(i, list(prompt), max_new_tokens=12,
                              tenant_id=tenant if tenants else "default")])
    want = eng.telemetry()
    calls = []
    with monkeypatch.context() as m:
        saved = _patched_host_reads(m)
        _counting_pull(m, saved, calls)
        got = eng.telemetry()
    assert len(calls) == 1 and calls[0] >= 5
    assert "kv/p_max" in got and "serve/loop/steps" in got
    for k, v in want.items():
        if not k.startswith("span/"):
            assert np.array_equal(got[k], v), k


@pytest.mark.parametrize("kv_mode,fused,kv_policy", [
    ("full", False, "awrp"), ("paged", True, "awrp"), ("paged", True, "arc_adaptive")],
    ids=["full", "paged-awrp", "paged-arc_adaptive"])
def test_engine_loop_planes_graph_vs_host_bit_identical(setup, kv_mode, fused, kv_policy):
    """``serve/loop/*`` is folded inside the graph runner's step and per
    step on the host loop: equal bit for bit, over single requests, a
    batch, a one-token request and a sampled one; ``steps`` counts every
    sampling event."""
    snaps, outs = [], []
    for jit_loop in (True, False):
        eng = _engine(setup, kv_mode=kv_mode, fused=fused, kv_policy=kv_policy,
                      jit_loop=jit_loop)
        got = []
        for i, plen in enumerate((16, 16, 32)):
            got.append(eng.generate([Request(i, list(range(1, plen + 1)),
                                             max_new_tokens=5)])[i].tokens)
        res = eng.generate([Request(5, list(range(40, 56)), max_new_tokens=7),
                            Request(6, list(range(60, 76)), max_new_tokens=7)])
        got += [res[5].tokens, res[6].tokens]
        got.append(eng.generate([Request(7, list(range(2, 18)), max_new_tokens=1)])[7].tokens)
        got.append(eng.generate([Request(8, list(range(3, 19)), max_new_tokens=4,
                                         temperature=0.8)])[8].tokens)
        outs.append(got)
        snaps.append(eng.telemetry())
    tg, th = snaps
    assert outs[0] == outs[1]
    events = 3 * 5 + 7 + 1 + 4
    assert tg["serve/loop/steps"] == th["serve/loop/steps"] == events
    assert tg["serve/loop/tokens"] == th["serve/loop/tokens"] == 3 * 5 + 2 * 7 + 1 + 4
    assert tg["serve/loop/tokens"] == tg["serve/tokens"]
    hg, hh = tg["serve/loop/token_hist"], th["serve/loop/token_hist"]
    assert hg.dtype == hh.dtype == np.int32 and hg.tobytes() == hh.tobytes()
    assert int(hg.sum()) == tg["serve/loop/tokens"]
    assert tg["compile/decode_loop/count"] >= 3  # batch 1, batch 2, sampled


def test_engine_metrics_off_drops_planes_not_behaviour(monkeypatch, setup):
    on = _engine(setup, kv_mode="paged", fused=True)
    off = _engine(setup, kv_mode="paged", fused=True, metrics=False)
    reqs = [(0, list(range(3, 19)), 6), (1, list(range(3, 19)), 6)]
    got_on = [on.generate([Request(i, list(p), max_new_tokens=n)])[i].tokens
              for i, p, n in reqs]

    def no_fold(*args, **kwargs):
        raise AssertionError("a fold with metrics off")

    from repro_torch.serve import engine as engine_mod

    with monkeypatch.context() as m:
        m.setattr(engine_mod, "loop_update_", no_fold)
        got_off = [off.generate([Request(i, list(p), max_new_tokens=n)])[i].tokens
                   for i, p, n in reqs]
    assert got_on == got_off
    assert all(g.planes is None for g in off._graphs.values()) and off._graphs
    snap = off.telemetry()
    assert not any(k.startswith("serve/loop/") for k in snap)
    timing = ("prefill_s", "decode_s")
    assert {k: v for k, v in off.stats.items() if k not in timing} == \
        {k: v for k, v in on.stats.items() if k not in timing}
    assert snap["serve/prefills"] == 1 and snap["prefix/hits"] == 1


def _run_both(teng, jeng, reqs):
    for rid, tenant, prompt, new in reqs:
        got = teng.generate([Request(rid, list(prompt), max_new_tokens=new,
                                     tenant_id=tenant)])[rid]
        want = jeng.generate([JRequest(rid, list(prompt), max_new_tokens=new,
                                       tenant_id=tenant)])[rid]
        assert (got.status, got.prefill_cached, got.tokens) == \
            (want.status, want.prefill_cached, list(want.tokens)), rid


@pytest.mark.parametrize("kv_policy,prefix_policy", [("awrp", "awrp"), ("arc_adaptive", "arc")])
def test_engine_snapshot_equals_jax_engine(setup, kv_policy, prefix_policy):
    """The port engine and the JAX engine on the same greedy requests (a
    looping tenant, a thrashing one, a batch): ``serve/loop/*`` bitwise, the
    tenant counters equal, ``pressure`` bitwise in float32, ``hit_ratio``
    with ``==``, the kv ``p_mean`` / ``p_max`` within P_TOL."""
    jcfg, jparams, tcfg, tparams = setup
    jcfg = dataclasses.replace(jcfg, kv_policy=kv_policy)
    tcfg = dataclasses.replace(tcfg, kv_policy=kv_policy)
    quotas = {"good": 2, "hog": 1}
    kw = dict(max_len=96, kv_mode="paged", fused=True, tenants=quotas,
              prefix_policy=prefix_policy)
    teng = ServeEngine(tcfg, tparams, device="cpu", **kw)
    jeng = JServeEngine(jcfg, jparams, **kw)
    good = [list(range(1, 17)), list(range(30, 46))]
    reqs = []
    for i in range(4):
        reqs.append((2 * i, "good", good[i % 2], 12))
        reqs.append((2 * i + 1, "hog", [100 + 16 * i + j for j in range(16)], 3))
    _run_both(teng, jeng, reqs)
    batch = [Request(20, list(range(5, 21)), max_new_tokens=4, tenant_id="good"),
             Request(21, list(range(7, 23)), max_new_tokens=4, tenant_id="good")]
    jbatch = [JRequest(r.rid, list(r.prompt), max_new_tokens=4, tenant_id="good")
              for r in batch]
    got_b, want_b = teng.generate(batch), jeng.generate(jbatch)
    assert [got_b[r].tokens for r in (20, 21)] == [list(want_b[r].tokens) for r in (20, 21)]
    got, want = teng.telemetry(), jeng.telemetry()
    for k in ("steps", "tokens"):
        g, w = got[f"serve/loop/{k}"], want[f"serve/loop/{k}"]
        assert type(g) is type(w) is int and g == w, k
    g, w = got["serve/loop/token_hist"], want["serve/loop/token_hist"]
    assert g.dtype == w.dtype == np.int32 and g.tobytes() == w.tobytes()
    for t in quotas:
        for k in ("hits", "misses", "evictions", "accesses", "occupancy", "quota",
                  "entries", "policy"):
            assert got[f"tenant/{t}/{k}"] == want[f"tenant/{t}/{k}"], (t, k)
        assert got[f"tenant/{t}/hit_ratio"] == want[f"tenant/{t}/hit_ratio"]
        assert np.float32(got[f"tenant/{t}/pressure"]).tobytes() == \
            np.float32(want[f"tenant/{t}/pressure"]).tobytes()
    assert got["tenant/good/hits"] > 0 and got["tenant/hog/evictions"] > 0
    if kv_policy == "arc_adaptive":
        for t in quotas:
            assert got[f"kv/{t}/ghost_hits"] == want[f"kv/{t}/ghost_hits"]
            for k in ("p_mean", "p_max"):
                assert abs(got[f"kv/{t}/{k}"] - float(want[f"kv/{t}/{k}"])) <= P_TOL, (t, k)
    for k in ("prefills", "decode_steps", "tokens", "shed", "deferred", "kv_ghost_hits"):
        assert got[f"serve/{k}"] == want[f"serve/{k}"], k


# -- the exporters ------------------------------------------------------------------


def _snapshots():
    rng = np.random.RandomState(9)
    yield {"serve/requests": 4, "tenant/a/hit_ratio": 0.5,
           "serve/loop/token_hist": np.asarray([2, 0, 3]), "prefix/policy": "awrp",
           "serve/flag": True, "serve/junk": [1, 2], "none": None}
    yield {"serve/requests": 4, "serve-requests": 7, "tenant/a/hit_ratio": 0.5,
           "prefix/policy": "awrp", "1st/x": 3}
    yield {"a/exact_ratio": 3 / 7, "a/tiny": 5e-324, "a/neg": -0.0, "a/big_int": 2**53 - 1,
           "a/bool": True, "a/hist": rng.randint(0, 1000, size=5),
           "a/plane": rng.rand(4).astype(np.float64), "a/np_scalar": np.float32(0.1),
           "a/i32": np.int32(-3), "a/f32_plane": rng.rand(3).astype(np.float32),
           "a/np_bool": np.bool_(False)}


@pytest.mark.parametrize("i", range(3))
def test_prometheus_text_equals_reference(i):
    snap = list(_snapshots())[i]
    for prefix in ("awrp", "", "x-y"):
        assert export.prometheus_text(snap, prefix=prefix) == \
            jexport.prometheus_text(snap, prefix=prefix)


def test_engine_snapshot_exports_equal_reference(setup, tmp_path, monkeypatch):
    """A real engine snapshot through both exporters: the same bytes."""
    eng = _engine(setup, tenants={"a": 2, "b": 1}, kv_mode="paged", fused=True,
                  kv_policy="arc_adaptive")
    for i in range(3):
        eng.generate([Request(i, list(range(1, 17)), max_new_tokens=9, tenant_id="ab"[i % 2])])
    snap = eng.telemetry()
    assert export.prometheus_text(snap) == jexport.prometheus_text(snap)
    assert "awrp_serve_loop_token_hist{bucket=\"15\"}" in export.prometheus_text(snap)
    monkeypatch.setattr(export.time, "time", lambda: 1234.5)
    a, b = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    export.append_jsonl(str(a), snap, extra={"arch": "smollm"})
    export.append_jsonl(str(a), snap)
    jexport.append_jsonl(str(b), snap, extra={"arch": "smollm"})
    jexport.append_jsonl(str(b), snap)  # the same time module: the same ts
    assert a.read_bytes() == b.read_bytes()
    rec = json.loads(a.read_text().splitlines()[0])
    assert rec["ts"] == 1234.5 and rec["arch"] == "smollm"
    assert rec["serve/loop/token_hist"] == snap["serve/loop/token_hist"].tolist()


@pytest.mark.parametrize("i", range(3))
def test_append_jsonl_equals_reference(tmp_path, monkeypatch, i):
    snap = list(_snapshots())[i]
    monkeypatch.setattr(export.time, "time", lambda: 99.25)
    a, b = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    export.append_jsonl(str(a), snap, extra={"arch": "gemma3_27b"})
    jexport.append_jsonl(str(b), snap, extra={"arch": "gemma3_27b"})
    assert a.read_bytes() == b.read_bytes()
    assert len(a.read_text().splitlines()) == 1


# -- spans ------------------------------------------------------------------------------


def test_spans_accumulate():
    ss = SpanSet()
    with ss.span("decode"):
        pass
    with ss.span("decode"):
        sum(range(1000))
    with pytest.raises(RuntimeError):
        with ss.span("decode"):
            raise RuntimeError("recorded anyway")
    m = ss.metrics()
    assert m["decode"]["calls"] == 3  # the raising span still recorded
    assert m["decode"]["seconds"] >= m["decode"]["max_s"] >= 0.0


def test_spans_sync_mode_waits_on_ready_values(monkeypatch):
    waited = []
    monkeypatch.setattr(spans, "_wait", lambda values: waited.append(values))
    x = {"a": torch.ones(2), "b": [torch.zeros(1)]}
    ss = SpanSet(sync=True)
    with ss.span("decode") as sp:
        assert sp.ready(x) is x
    assert len(waited) == 1 and waited[0][0] is x
    ss2 = SpanSet(sync=False)
    with ss2.span("decode") as sp:
        sp.ready(x)  # free: nothing to wait on at the close
    assert len(waited) == 1
    assert ss.metrics()["decode"]["calls"] == ss2.metrics()["decode"]["calls"] == 1


def test_spans_wait_synchronizes_only_cuda_devices(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: synced.append(dev))
    spans._wait([{"a": torch.ones(2)}, (torch.zeros(1),)])
    assert synced == []  # CPU tensors are ready when they exist
    assert [t.shape for t in spans._tensors({"a": [torch.ones(2), (torch.ones(3),)]})] == \
        [(2,), (3,)]
