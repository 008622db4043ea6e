"""The port's OPT-regret oracle (``repro_torch/obs/opt_oracle.py``), the
engine's decision trace and ``opt_regret()``, the serving CLI's
``--decision-trace`` and the sweep's ``PHASES`` span, against the JAX
reference on the CPU.

``regret_from_records`` and ``opt_hit_ratio`` must give the reference's
numbers exactly on the same records and streams (empty ones included).  The
port engine and the JAX engine serve the same greedy multi-tenant requests
with ``decision_trace=64``: their drained records are equal field by field
(floats by their bits), and ``opt_regret()`` and its registry gauges are
equal."""

import contextlib
import dataclasses
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.base import load_smoke_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.obs import opt_oracle as jopt  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import smollm_360m  # noqa: E402
from repro_torch.core import simulator  # noqa: E402
from repro_torch.launch import serve as cli  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.obs import decision_trace as dt  # noqa: E402
from repro_torch.obs import opt_oracle  # noqa: E402
from repro_torch.obs.profiling import PHASES  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.tenancy import AdmissionController, TenantCacheManager  # noqa: E402

torch.set_num_threads(2)

SMALL = dict(dtype="float32", param_dtype="float32", bounded_kv_pages=3, page_size=8)


# -- the oracle -----------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_opt_hit_ratio_equals_reference(seed):
    rng = np.random.RandomState(seed)
    keys = rng.zipf(1.3, size=300) % 50
    for cap in (1, 3, 8, 60):
        assert opt_oracle.opt_hit_ratio(keys, cap) == jopt.opt_hit_ratio(keys, cap)
    assert opt_oracle.opt_hit_ratio([], 4) == jopt.opt_hit_ratio([], 4) == 0.0


def _traced_manager(policy, seed, cap=48):
    """A port manager on the CPU with a ring, after a pressured stream and an
    admission batch: access and admission events, wrapped."""
    rng = np.random.RandomState(seed)
    rows = rng.randint(0, 3, size=90).astype(np.int32)
    keys = (rng.zipf(1.2, size=90) % 40).astype(np.int32)
    mgr = TenantCacheManager({"a": 3, "b": 5, "c": 2}, policy, device="cpu",
                             ring_capacity=cap)
    mgr.access_stream(rows, keys)
    AdmissionController(defer_at=0.1, shed_at=0.3, warmup=2).decide_batch(
        mgr, ["a", "c", "c", "b"])
    return mgr


@pytest.mark.parametrize("policy,seed", [("awrp", 0), ("lru", 1), ("arc", 2), ("car", 3)])
def test_regret_from_records_equals_reference(policy, seed):
    """The same drained records (access and admission events, a row with no
    events) through the port's and the reference's ``regret_from_records``:
    every number equal."""
    mgr = _traced_manager(policy, seed)
    rec = mgr.drain_trace()
    assert set(rec["kind"].tolist()) == {dt.KIND_ACCESS, dt.KIND_ADMIT}
    caps = {0: 3, 1: 5, 2: 2, 7: 4}  # row 7 has no events
    got = opt_oracle.regret_from_records(rec, caps)
    assert got == jopt.regret_from_records(rec, caps)
    per_row, agg = got
    assert per_row[7] == {"accesses": 0, "observed": 0.0, "opt": 0.0, "regret": 0.0}
    assert agg["accesses"] == int((rec["kind"] == dt.KIND_ACCESS).sum())
    for info in per_row.values():  # the window starts warm: regret may be < 0
        assert info["regret"] == info["opt"] - info["observed"]


def test_regret_from_records_empty_equals_reference():
    empty = dt.drain(dt.ring_init(4, device="cpu"))
    assert opt_oracle.regret_from_records(empty, {0: 2, 1: 3}) == \
        jopt.regret_from_records(empty, {0: 2, 1: 3})
    assert opt_oracle.regret_from_records(empty, {}) == jopt.regret_from_records(empty, {})


# -- the engine -----------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(load_smoke_config("smollm_360m"), **SMALL)
    tcfg = dataclasses.replace(smollm_360m.SMOKE_CONFIG, **SMALL)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(1))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu",
                              dtype=torch.float32)
    return jcfg, jparams, tcfg, tparams


@pytest.mark.parametrize("prefix_policy", ["awrp", "arc"])
def test_engine_decision_trace_and_opt_regret_equal_jax_engine(setup, prefix_policy):
    """Tenant "a" re-sends one prompt, "b" sends new ones, then a pressured
    "b" batch: the drained records (access and admission events) equal the
    JAX engine's field by field, ``opt_regret()`` equals its numbers and the
    gauges of ``telemetry()`` carry them; the drain runs under
    ``trace_drain``."""
    jcfg, jparams, tcfg, tparams = setup
    kw = dict(max_len=96, tenants={"a": 4, "b": 2}, decision_trace=64,
              prefix_policy=prefix_policy)
    teng = ServeEngine(tcfg, tparams, device="cpu", **kw)
    jeng = JServeEngine(jcfg, jparams, **kw)
    loop = list(range(1, 17))
    rng = np.random.RandomState(3)
    reqs = []
    for i in range(4):
        reqs.append([(i, list(loop), "a")])
        reqs.append([(10 + i, rng.randint(1, tcfg.vocab, size=16).tolist(), "b")])
    reqs.append([(20 + j, rng.randint(1, tcfg.vocab, size=16).tolist(), "b")
                 for j in range(3)])
    for batch in reqs:
        got = teng.generate([Request(r, list(p), max_new_tokens=2, tenant_id=t)
                             for r, p, t in batch])
        want = jeng.generate([JRequest(r, list(p), max_new_tokens=2, tenant_id=t)
                              for r, p, t in batch])
        for r, _, _ in batch:
            assert (got[r].status, got[r].tokens) == (want[r].status, list(want[r].tokens))
    rec, jrec = teng.drain_decision_trace(), jeng.drain_decision_trace()
    assert set(rec["kind"].tolist()) == {dt.KIND_ACCESS, dt.KIND_ADMIT}
    assert rec.dtype == jrec.dtype and len(rec) == len(jrec)
    for name in rec.dtype.names:
        assert rec[name].tobytes() == jrec[name].tobytes(), name
    regret, jregret = teng.opt_regret(), jeng.opt_regret()
    assert regret == jregret
    assert set(regret) == {"a", "b", "aggregate"}
    assert regret["a"]["observed"] == 3 / 4 == regret["a"]["opt"]
    t, jtel = teng.telemetry(), jeng.telemetry()
    for k in ("tenant/a/opt_regret", "tenant/b/opt_regret",
              f"policy/{prefix_policy}/opt_regret"):
        assert t[k] == jtel[k], k
    assert t["tenant/b/opt_regret"] == regret["b"]["regret"]
    assert t[f"policy/{prefix_policy}/opt_regret"] == regret["aggregate"]["regret"]
    assert t["span/trace_drain/calls"] == 2  # drain_decision_trace + opt_regret


def test_engine_decision_trace_requires_tenants(setup):
    _, _, tcfg, tparams = setup
    with pytest.raises(ValueError, match="tenants"):
        ServeEngine(tcfg, tparams, max_len=96, decision_trace=8, device="cpu")
    eng = ServeEngine(tcfg, tparams, max_len=96, device="cpu")
    with pytest.raises(ValueError, match="multi-tenant"):
        eng.drain_decision_trace()


def test_engine_without_trace_has_no_ring_and_same_decisions(setup):
    """``decision_trace=0`` leaves the manager without a ring; the traced
    engine serves the same tokens, statuses and counters."""
    _, _, tcfg, tparams = setup
    kw = dict(max_len=96, tenants={"a": 2, "b": 1}, device="cpu")
    on, off = ServeEngine(tcfg, tparams, decision_trace=16, **kw), ServeEngine(tcfg, tparams, **kw)
    assert off.tenant_cache.manager.ring is None
    rng = np.random.RandomState(5)
    for i in range(5):
        prompt = rng.randint(1, tcfg.vocab, size=16).tolist()
        r = [e.generate([Request(i, list(prompt), max_new_tokens=3, tenant_id="ab"[i % 2])])[i]
             for e in (on, off)]
        assert (r[0].status, r[0].tokens) == (r[1].status, r[1].tokens)
    a, b = on.telemetry(), off.telemetry()
    for k in ("hits", "misses", "evictions", "pressure"):
        assert a[f"tenant/a/{k}"] == b[f"tenant/a/{k}"], k
        assert a[f"tenant/b/{k}"] == b[f"tenant/b/{k}"], k
    with pytest.raises(ValueError, match="ring_capacity"):
        off.tenant_cache.manager.drain_trace()


# -- the CLI ------------------------------------------------------------------------


def test_cli_decision_trace_reports_regret(tmp_path):
    out = io.StringIO()
    prom = tmp_path / "m"
    with contextlib.redirect_stdout(out):
        cli.main(["--device", "cpu", "--smoke", "--dtype", "float32", "--tenants", "a=2,b=1",
                  "--requests", "6", "--new-tokens", "3", "--prompt-len", "16",
                  "--repeat-prompts", "--decision-trace", "32",
                  "--metrics-out", str(prom)])
    text = out.getvalue()
    assert "opt regret (6 traced accesses)" in text, text
    exported = (tmp_path / "m.prom").read_text()
    for k in ("tenant_a_opt_regret", "tenant_b_opt_regret", "policy_awrp_opt_regret"):
        assert k in exported, k


def test_cli_decision_trace_needs_tenants(capsys):
    with pytest.raises(SystemExit) as err:
        cli.main(["--device", "cpu", "--smoke", "--decision-trace", "8"])
    assert err.value.code == 2
    assert "--decision-trace needs --tenants" in capsys.readouterr().err


# -- the sweep's phase span -----------------------------------------------------------


def test_sweep_records_its_device_route_in_phases():
    """``sweep`` times its device route (the pull of the hit counts
    included) under ``PHASES`` ``sweep``; a host-only or empty sweep adds
    no call."""
    trace = np.random.RandomState(0).randint(0, 30, size=200)

    def calls():
        return PHASES.metrics().get("sweep", {}).get("calls", 0)

    n0 = calls()
    got = simulator.sweep(["awrp", "arc", "opt"], trace, [4, 8], torch_device="cpu")
    assert calls() == n0 + 1
    assert PHASES.metrics()["sweep"]["seconds"] > 0
    assert got == simulator.sweep(["awrp", "arc", "opt"], trace, [4, 8], device=False)
    assert calls() == n0 + 1  # the host route: no span
    simulator.sweep(["awrp"], [], [4], torch_device="cpu")
    assert calls() == n0 + 1

