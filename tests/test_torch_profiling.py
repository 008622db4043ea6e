"""The port's compile counters, spans, trace capture and live export
(``repro_torch/obs/profiling.py``, ``spans.py``, ``server.py`` and
``launch/serve.py``'s metrics flags) on the CPU, mirroring
``tests/test_profiling.py`` without the jaxpr audit (no counterpart) and the
bench-history tool (not ported).

* compile counters: sentinels sum by name; ``compile/decode_loop/count``
  stays flat across same-shape batches and grows by one per new decode
  graph key (batch size, greedy or sampled), ``calls`` counts the steps,
  ``cache_size`` the live graphs; ``compile/nvcc/*`` counts the kernel
  library's builds;
* spans: p50 / p95 over the recent window; the engine's ``prefill``,
  ``decode`` and ``rebalance`` spans, waiting on their outputs with
  ``profile_phases=True``;
* ``TraceCapture`` cadence and the chrome-trace files of the CPU profiler,
  alone and through ``ServeEngine(profile_dir=...)``;
* ``MetricsServer`` (Prometheus text, JSON, ``/healthz``, 500 on a snapshot
  error without dying) and ``SnapshotLogger`` (the final line on stop), also
  over a served engine;
* the CLI: ``--metrics-out`` writes both files with ``--device cpu``,
  ``--metrics-port`` serves, ``--snapshot-every`` needs ``--metrics-out``.
"""

import dataclasses
import json
import os
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import smollm_360m  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.obs import profiling, spans  # noqa: E402
from repro_torch.obs.export import prometheus_text  # noqa: E402
from repro_torch.obs.profiling import Sentinel, TraceCapture  # noqa: E402
from repro_torch.obs.server import MetricsServer, SnapshotLogger  # noqa: E402
from repro_torch.obs.spans import SpanSet  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.tenancy import AdmissionController  # noqa: E402

torch.set_num_threads(2)

SMALL = dict(dtype="float32", param_dtype="float32", bounded_kv_pages=3, page_size=8)
CLI = ["--device", "cpu", "--smoke", "--dtype", "float32", "--kv-mode", "paged",
       "--fused", "--kv-pages", "2", "--prompt-len", "32", "--new-tokens", "6"]


@pytest.fixture(scope="module")
def cfg_params():
    cfg = dataclasses.replace(smollm_360m.SMOKE_CONFIG, **SMALL)
    return cfg, TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")


def _engine(cfg_params, **kw):
    cfg, params = cfg_params
    return ServeEngine(cfg, params, max_len=96, kv_mode="paged", fused=True,
                       device="cpu", **kw)


# -- compile counters ------------------------------------------------------------


def test_compile_metrics_sum_sentinels_by_name():
    a, b = Sentinel("t_shared"), Sentinel("t_shared")
    a.traces, a.calls, a.cache_size, a.last_trace_s = 1, 4, 1, 0.5
    b.traces, b.calls, b.cache_size, b.last_trace_s = 2, 3, 2, 0.25
    agg = profiling.compile_metrics()["t_shared"]
    assert agg == {"count": 3, "calls": 7, "cache_size": 3, "last_trace_s": 0.5}
    del a, b
    import gc

    gc.collect()
    assert "t_shared" not in profiling.compile_metrics()  # dead sentinels drop out


def test_compile_nvcc_counts_the_library_builds(monkeypatch):
    monkeypatch.setattr(_build, "BUILDS", [])
    assert profiling.compile_metrics()["nvcc"] == {"count": 0, "seconds": 0}
    _build.BUILDS.append(_build.BuildInfo(Path("a.so"), 41.5, ""))
    _build.BUILDS.append(_build.BuildInfo(Path("b.so"), 2.25, ""))
    assert profiling.compile_metrics()["nvcc"] == {"count": 2, "seconds": 43.75}


def test_engine_decode_loop_count_stays_flat_across_batches(cfg_params):
    """The capture-regression detector: same-shape batches reuse their
    decode graph; a new key (sampled, or another batch size) is one more
    build; ``calls`` counts every decode step."""
    eng = _engine(cfg_params)
    prompt = list(range(1, 17))
    eng.generate([Request(0, list(prompt), max_new_tokens=4)])
    sent = eng._loop_sentinel
    assert (sent.traces, sent.calls, sent.cache_size) == (1, 3, 1)
    for i in range(1, 4):  # repeated same-shape batches, other prompts and budgets
        eng.generate([Request(i, list(range(i, i + 16)), max_new_tokens=3 + i)])
    assert sent.traces == 1 and sent.calls == 3 + 3 + 4 + 5  # flat
    for i, temp in enumerate((0.5, 1.0, 1.5)):  # sampled: one more graph, then flat
        eng.generate([Request(10 + i, list(prompt), max_new_tokens=4, temperature=temp)])
    assert sent.traces == 2
    eng.generate([Request(20, list(prompt), max_new_tokens=4),
                  Request(21, list(range(40, 56)), max_new_tokens=4)])
    assert sent.traces == 3 and sent.cache_size == 3
    tel = eng.telemetry()
    assert tel["serve/loop_captures"] == 3
    assert tel["compile/decode_loop/count"] >= 3  # process-wide sums
    assert tel["compile/decode_loop/cache_size"] >= 3
    assert tel["compile/decode_loop/calls"] >= tel["serve/decode_steps"]
    assert tel["compile/decode_loop/last_trace_s"] > 0.0
    assert "compile/decode_loop/eqns" not in tel  # no jaxpr audit in the port
    assert {"compile/nvcc/count", "compile/nvcc/seconds"} <= tel.keys()


def test_host_loop_builds_no_decode_graph(cfg_params):
    eng = _engine(cfg_params, jit_loop=False)
    eng.generate([Request(0, list(range(1, 17)), max_new_tokens=4)])
    assert (eng._loop_sentinel.traces, eng._loop_sentinel.calls) == (0, 0)


# -- spans ---------------------------------------------------------------------------


def test_spans_percentiles_over_recent_window():
    ss = SpanSet(max_samples=4)
    for _ in range(10):
        with ss.span("phase"):
            pass
    m = ss.metrics()["phase"]
    assert m["calls"] == 10 and len(ss._samples["phase"]) == 4
    assert 0.0 <= m["p50_s"] <= m["p95_s"] <= m["max_s"] <= m["seconds"]
    assert SpanSet._pct([1.0, 2.0, 3.0, 4.0], 0.5) == 3.0  # nearest rank
    assert SpanSet._pct([1.0, 2.0, 3.0, 4.0], 0.95) == 4.0


def test_engine_spans_count_phases_and_wait_in_profile_mode(monkeypatch, cfg_params):
    waited = []
    orig = spans._wait
    monkeypatch.setattr(spans, "_wait", lambda values: (waited.append(len(values)),
                                                        orig(values)))
    for profile_phases in (False, True):
        waited.clear()
        eng = _engine(cfg_params, tenants={"hot": 1, "cold": 2}, auto_rebalance=True,
                      admission=AdmissionController(defer_at=0.15, shed_at=0.95,
                                                    warmup=100),
                      profile_phases=profile_phases)
        for i in range(6):  # the hot tenant thrashes its one lane
            eng.generate([Request(i, [50 + 16 * i + j for j in range(16)],
                                  max_new_tokens=2, tenant_id="hot")])
        tel = eng.telemetry()
        assert tel["span/prefill/calls"] == tel["serve/prefills"] == 6
        assert tel["span/decode/calls"] == 6
        assert tel["span/rebalance/calls"] >= 1 and tel["serve/rebalances"] >= 1
        # sync mode: prefill and decode wait on their outputs, rebalance has none
        assert len(waited) == (12 if profile_phases else 0)


# -- trace capture ---------------------------------------------------------------------


def test_trace_capture_cadence_and_files(tmp_path):
    cap = TraceCapture(str(tmp_path / "prof"), every=4)
    seen = []
    for _ in range(5):  # batches of 2: the first and each crossing of 4
        with cap.maybe(2) as capturing:
            seen.append(capturing)
            torch.ones(8).sum()
    assert seen == [True, True, False, True, False]
    assert cap.captures == 3 and cap.seen == 10
    assert cap.metrics() == {"dir": str(tmp_path / "prof"), "every": 4,
                             "requests_seen": 10, "captures": 3}
    files = sorted(p.name for p in (tmp_path / "prof").iterdir())
    assert files == ["generate_0.json", "generate_1.json", "generate_2.json"]
    trace = json.loads((tmp_path / "prof" / "generate_1.json").read_text())
    assert any(e.get("name") == "generate#1" for e in trace["traceEvents"])


def test_engine_profile_dir_captures_and_mounts(tmp_path, cfg_params):
    eng = _engine(cfg_params, profile_dir=str(tmp_path / "p"), profile_every=2)
    for i in range(3):
        eng.generate([Request(i, list(range(1 + i, 17 + i)), max_new_tokens=2)])
    tel = eng.telemetry()
    assert tel["profiler/captures"] == 2 and tel["profiler/requests_seen"] == 3
    assert sorted(p.name for p in (tmp_path / "p").iterdir()) == \
        ["generate_0.json", "generate_1.json"]
    assert not any(k.startswith("profiler/") for k in _engine(cfg_params).telemetry())


# -- live export ---------------------------------------------------------------------------


def test_metrics_server_serves_prometheus_and_json():
    snap = {"serve/requests": 4, "tenant/a/hit_ratio": 0.5, "plane": np.asarray([1, 2])}
    with MetricsServer(lambda: snap, port=0) as srv:
        base = f"http://127.0.0.1:{srv.port}"
        text = urllib.request.urlopen(base + "/metrics").read().decode()
        assert text == prometheus_text(snap)
        assert "# HELP awrp_serve_requests serve/requests\n" in text
        doc = json.loads(urllib.request.urlopen(base + "/metrics.json").read())
        assert doc["serve/requests"] == 4 and doc["plane"] == [1, 2]
        assert urllib.request.urlopen(base + "/healthz").read() == b"ok\n"
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(base + "/nope")
        assert ei.value.code == 404


def test_metrics_server_snapshot_error_is_500_not_fatal():
    def boom():
        raise RuntimeError("provider exploded")

    with MetricsServer(boom, port=0) as srv:
        base = f"http://127.0.0.1:{srv.port}"
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(base + "/metrics")
        assert ei.value.code == 500
        assert b"provider exploded" in ei.value.read()
        assert urllib.request.urlopen(base + "/healthz").read() == b"ok\n"


def test_metrics_server_over_a_serving_engine(cfg_params):
    """A client polls ``/metrics.json`` while the engine serves: every poll
    answers 200, and after the run the endpoint's snapshot equals
    ``telemetry()``."""
    eng = _engine(cfg_params, tenants={"a": 2, "b": 1})
    codes, stop = [], threading.Event()
    with MetricsServer(eng.telemetry, port=0) as srv:
        url = f"http://127.0.0.1:{srv.port}/metrics.json"

        def poll():
            while not stop.is_set():
                codes.append(urllib.request.urlopen(url).status)

        client = threading.Thread(target=poll)
        client.start()
        try:
            for i in range(4):
                eng.generate([Request(i, list(range(1 + i, 17 + i)), max_new_tokens=5,
                                      tenant_id="ab"[i % 2])])
        finally:
            stop.set()
            client.join()
        doc = json.loads(urllib.request.urlopen(url).read())
    assert codes and set(codes) == {200}
    tel = eng.telemetry()
    assert doc.keys() == tel.keys()
    for k, v in tel.items():
        assert doc[k] == (v.tolist() if isinstance(v, np.ndarray) else v), k


def test_telemetry_from_many_threads_while_serving(cfg_params):
    """Stress: more threads than cores snapshot in a loop, at a short
    switch interval, while the engine serves three tenants (new spans, a new KV session per
    tenant, a rebalance, a new decode graph): no snapshot raises, and the
    last one counts every sampling event."""
    import sys

    cfg, params = cfg_params
    eng = ServeEngine(dataclasses.replace(cfg, kv_policy="arc_adaptive"), params,
                      max_len=96, kv_mode="paged", fused=True, device="cpu",
                      tenants={"a": 1, "b": 2, "c": 1}, auto_rebalance=True,
                      admission=AdmissionController(defer_at=0.15, shed_at=0.95,
                                                    warmup=100))
    errors, snaps, stop = [], [], threading.Event()

    def scrape():
        while not stop.is_set():
            try:
                snaps.append(eng.telemetry()["serve/loop/steps"])
            except Exception as e:  # noqa: BLE001 — gated below
                errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    threads = [threading.Thread(target=scrape) for _ in range((os.cpu_count() or 4) + 1)]
    try:
        for t in threads:
            t.start()
        for i in range(9):
            eng.generate([Request(i, [7 + 16 * i + j for j in range(16)], max_new_tokens=3,
                                  tenant_id="abc"[i % 3])])
        eng.generate([Request(20, list(range(1, 17)), max_new_tokens=3, tenant_id="b"),
                      Request(21, list(range(2, 18)), max_new_tokens=3, tenant_id="b")])
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    tel = eng.telemetry()
    assert tel["serve/loop/steps"] == 9 * 3 + 3
    assert snaps and max(snaps) <= tel["serve/loop/steps"]
    assert {f"kv/{t}/p_max" for t in "abc"} <= tel.keys()
    assert tel["span/rebalance/calls"] >= 1 and tel["serve/loop_captures"] == 2


def test_snapshot_logger_appends_final_line_on_stop(tmp_path):
    path = tmp_path / "snap.jsonl"
    calls = []

    def snap():
        calls.append(1)
        return {"serve/requests": len(calls)}

    lg = SnapshotLogger(snap, str(path), interval_s=60.0, extra={"arch": "x"}).start()
    lg.stop()  # a long interval: only the final flush fires
    lines = path.read_text().splitlines()
    assert len(lines) == 1 and lg.lines == 1 and lg.errors == 0
    rec = json.loads(lines[0])
    assert rec["arch"] == "x" and rec["serve/requests"] == 1 and "ts" in rec


def test_snapshot_logger_counts_errors_and_keeps_going(tmp_path):
    def boom():
        raise RuntimeError("no")

    lg = SnapshotLogger(boom, str(tmp_path / "x.jsonl"), interval_s=60.0).start()
    lg.stop()
    assert (lg.lines, lg.errors) == (0, 1)


# -- the CLI ---------------------------------------------------------------------------------


@pytest.mark.parametrize("host_loop", [False, True], ids=["graph", "host"])
def test_launch_metrics_out_writes_both_files(tmp_path, capsys, host_loop):
    out = str(tmp_path / "m")
    args = CLI + ["--requests", "3", "--metrics-out", out]
    results = serve_cli.main(args + (["--host-loop"] if host_loop else []))
    assert len(results) == 3
    prom = Path(out + ".prom").read_text()
    assert "awrp_serve_loop_steps 6\n" in prom  # one batch of 3: 6 sampling events
    assert "awrp_serve_loop_tokens 18\n" in prom
    assert 'awrp_serve_loop_token_hist{bucket="0"}' in prom
    assert "# awrp_prefix_policy info: awrp" in prom
    (line,) = Path(out + ".jsonl").read_text().splitlines()
    rec = json.loads(line)
    assert rec["arch"] == "smollm-360m" and rec["kv_mode"] == "paged"
    assert rec["serve/loop/steps"] == 6 and rec["serve/loop/tokens"] == rec["serve/tokens"] == 18
    assert f"metrics: wrote {out}.prom" in capsys.readouterr().out


def test_launch_metrics_port_and_snapshot_logger(tmp_path, capsys):
    out = str(tmp_path / "m")
    serve_cli.main(CLI + ["--requests", "4", "--tenants", "a=2,b=1", "--metrics-port", "0",
                          "--metrics-out", out, "--snapshot-every", "30",
                          "--profile-dir", str(tmp_path / "prof"), "--profile-every", "2",
                          "--profile-phases"])
    text = capsys.readouterr().out
    assert "metrics: serving http://127.0.0.1:" in text
    (line,) = Path(out + ".jsonl").read_text().splitlines()  # the logger's final line
    rec = json.loads(line)
    # one request at a time, every 2: the first, then crossings at 2 and 4
    assert rec["tenant/a/accesses"] == 2 and rec["profiler/captures"] == 3
    assert rec["span/prefill/calls"] == 4


def test_launch_snapshot_every_needs_metrics_out():
    with pytest.raises(SystemExit):
        serve_cli.main(CLI + ["--snapshot-every", "1"])
