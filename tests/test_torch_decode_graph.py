"""The decode step with the token position on the device, and the engine's
decode graph (``serve/engine.py`` ``DecodeGraph``, the counterpart of the
reference's jitted ``_build_loop``), on the CPU in float32 at smoke widths,
the reference's weights carried across by ``params_from_jax``.

* (a) ``decode_step`` with ``pos`` a 0-d int32 tensor against the
  reference's ``decode_step`` over steps that cross page boundaries into a
  full pool: ``full``, paged unfused AWRP, paged fused (the plain versions
  of kernels 4 and 5), unfused ``arc_adaptive``, gemma3's local/global
  stack and phi3.5-moe.  Logits within DECODE_TOL, every int plane and ``p``
  bitwise, K/V and rings within PREFILL_TOL (the tolerances of
  ``test_torch_model.py``, ``test_torch_gemma3.py`` and
  ``test_torch_moe_model.py``); both sides are fed the reference's greedy
  token;
* (b) one decode graph step (``ServeEngine._step``: ``decode_step``,
  ``sample_traced`` and the counter updates, then the copy back into the
  static tree) reads nothing back to the host: ``Tensor.item``,
  ``__bool__``, ``__int__``, ``__index__``, ``tolist``, ``cpu`` and
  ``numpy`` raise while it runs, in each mode;
* (c) ``jit_loop=True`` and ``jit_loop=False`` give equal tokens,
  ``kv_evictions``, ``nonfinite_logits``, final caches (every plane and the
  K/V) and ghost sessions (the reference's
  ``test_jit_loop_matches_host_loop_greedy``);
* (d) a stored prefix payload outlives repeated graph loops and never
  shares storage with the static tree (the reference's
  ``test_jit_loop_prefix_payload_survives_donation``);
* (e) the port's ``jit_loop=True`` engine against the reference's
  ``jit_loop=True`` engine: greedy tokens, smollm smoke, paged;
* the runner's ownership of its buffers: one graph per (batch size,
  sampled) key, reused across buckets, its static tree disjoint from every
  cache it loads; on the CPU no capture stream is made;
* ``sample_traced`` against ``sample``; the masked renormalization check
  against the host-checked one;
* ``cuda``-marked: the graph on the card, captured once per key on the
  engine's one capture stream, whose split-kernel arrival counters are 0
  after every replay (skipped without a card).
"""

import contextlib
import dataclasses
import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import load_smoke_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.cache import paged_kv  # noqa: E402
from repro_torch.configs import gemma3_27b, phi35_moe, smollm_360m  # noqa: E402
from repro_torch.core import policy_core  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serve.engine import DecodeGraph, Request, ServeEngine  # noqa: E402
from repro_torch.serve.sampling import sample, sample_traced  # noqa: E402

torch.set_num_threads(2)

PREFILL_TOL = 1e-4
DECODE_TOL = 2e-3
F32 = dict(dtype="float32", param_dtype="float32")
#: arch -> (port config module, the reference's name, config overrides,
#: prompt length, decode steps, JAX init seed): each prompt fills part of
#: the pool and the steps cross at least two evicting page boundaries
ARCHS = {
    "smollm": (smollm_360m, "smollm_360m", dict(bounded_kv_pages=3, page_size=8), 16, 20, 0),
    "gemma3": (gemma3_27b, "gemma3_27b", {}, 48, 16, 3),
    "phi35": (phi35_moe, "phi35_moe", dict(bounded_kv_pages=3, page_size=4), 16, 8, 2),
}
#: (arch, kv_mode, fused, kv_policy) of the decode-step cases
MODES = [("smollm", "full", False, "awrp"), ("smollm", "paged", False, "awrp"),
         ("smollm", "paged", True, "awrp"), ("smollm", "paged", True, "arc_adaptive"),
         ("smollm", "paged", False, "arc_adaptive"), ("gemma3", "paged", True, "awrp"),
         ("phi35", "paged", True, "awrp")]
MODE_IDS = ["-".join(str(x) for x in m) for m in MODES]

_MODELS = {}


def models(arch):
    """(jcfg, jparams, tcfg, tparams) of ``arch``, built once."""
    if arch not in _MODELS:
        mod, name, extra, _, _, seed = ARCHS[arch]
        jcfg = dataclasses.replace(load_smoke_config(name), **F32, **extra)
        tcfg = dataclasses.replace(mod.SMOKE_CONFIG, **F32, **extra)
        jparams = JM.init_params(jcfg, jax.random.PRNGKey(seed))
        tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                  device="cpu", dtype=torch.float32)
        _MODELS[arch] = (jcfg, jparams, tcfg, tparams)
    return _MODELS[arch]


def _with_policy(arch, kv_policy):
    jcfg, jparams, tcfg, tparams = models(arch)
    return (dataclasses.replace(jcfg, kv_policy=kv_policy), jparams,
            dataclasses.replace(tcfg, kv_policy=kv_policy), tparams)


def _prompt(arch, B=2):
    plen = ARCHS[arch][3]
    base = np.arange(1, plen + 1, dtype=np.int32)[None].repeat(B, 0)
    return (base * np.array([[1], [5]])[:B]) % 500


def _assert_tree_equal(got, want, where):
    """A port cache tree against the reference's: ``pos`` a 0-d int32 tensor
    of equal value, int planes and ``p`` bitwise, K/V and rings within
    PREFILL_TOL."""
    pos = got["pos"]
    assert isinstance(pos, torch.Tensor) and pos.dim() == 0 and pos.dtype == torch.int32
    assert int(pos) == int(want["pos"]), where
    for name, tb in got["blocks"].items():
        jb = want["blocks"][name]
        if isinstance(tb, dict):  # a full cache or a local ring
            for kv in ("k", "v"):
                np.testing.assert_allclose(tb[kv].numpy(), np.asarray(jb[kv]),
                                           rtol=PREFILL_TOL, atol=PREFILL_TOL,
                                           err_msg=f"{where}: {name}.{kv}")
            continue
        parts = [(tb, jb)]
        if isinstance(tb, paged_kv.AdaptivePagedPool):
            parts = [(tb.pool, jb.pool), (tb.policy, jb.policy)]
        for tp, jp in parts:
            for field, a in zip(tp._fields, tp):
                b = np.asarray(getattr(jp, field))
                if field in ("k", "v"):
                    np.testing.assert_allclose(a.numpy(), b, rtol=PREFILL_TOL,
                                               atol=PREFILL_TOL,
                                               err_msg=f"{where}: {name}.{field}")
                else:
                    assert a.numpy().dtype == b.dtype and np.array_equal(a.numpy(), b), \
                        f"{where}: {name}.{field}"


# -- (a) decode_step with a device pos against the reference -----------------


@pytest.mark.parametrize("arch,kv_mode,fused,kv_policy", MODES, ids=MODE_IDS)
def test_decode_step_with_device_pos_matches_reference(arch, kv_mode, fused, kv_policy):
    jcfg, jparams, tcfg, tparams = _with_policy(arch, kv_policy)
    prompt, steps = _prompt(arch), ARCHS[arch][4]
    max_len = prompt.shape[1] + steps
    jl, jc = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(prompt)}, max_len=max_len,
                        kv_mode=kv_mode)
    _, tc = TM.prefill(tparams, tcfg, torch.from_numpy(prompt), max_len, kv_mode=kv_mode)
    _assert_tree_equal(tc, jc, "prefill")
    step = jax.jit(lambda p, tk, c: JM.decode_step(p, jcfg, tk, c, kv_mode=kv_mode,
                                                   fused=fused))
    tok = jnp.argmax(jl[:, -1:], -1).astype(jnp.int32)
    boundaries = 0
    for i in range(steps):
        boundaries += int(tc["pos"]) % tcfg.page_size == 0
        jl, jc = step(jparams, tok, jc)
        tl, tc = TM.decode_step(tparams, tcfg, torch.from_numpy(np.array(tok)), tc,
                                kv_mode=kv_mode, fused=fused)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=DECODE_TOL,
                                   atol=DECODE_TOL, err_msg=f"step {i}")
        _assert_tree_equal(tc, jc, f"step {i}")
        tok = jnp.argmax(jl[:, -1:], -1).astype(jnp.int32)
    assert boundaries >= 2
    if kv_mode == "paged":  # the pool is full: the later boundaries evicted
        pool = next(c for c in tc["blocks"].values() if not isinstance(c, dict))
        pool = pool.pool if isinstance(pool, paged_kv.AdaptivePagedPool) else pool
        assert bool((pool.page_start >= 0).all())
        assert int(pool.page_start.max()) >= tcfg.bounded_kv_pages * tcfg.page_size


# -- (b) no host read in a graph step ------------------------------------------


def _engine(arch, kv_mode, fused, kv_policy, **kw):
    _, _, tcfg, tparams = _with_policy(arch, kv_policy)
    return ServeEngine(tcfg, tparams, max_len=ARCHS[arch][3] + ARCHS[arch][4] + 8,
                       kv_mode=kv_mode, fused=fused, device="cpu", **kw)


def _loaded_graph(eng, arch, sampled=False):
    """A decode graph loaded with the prefill of ``_prompt(arch)``, 0.7 the
    temperature of a sampled one."""
    logits, caches = eng._prefill(_prompt(arch).tolist())
    graph = eng.decode_graph(caches, sampled)
    tok = sample(logits, vocab=eng.cfg.vocab)
    graph.load(caches, tok, 0.7 if sampled else 0.0)
    return graph


SYNCING = ("item", "__bool__", "__int__", "__index__", "tolist", "cpu", "numpy")


@pytest.mark.parametrize("arch,kv_mode,fused,kv_policy", MODES, ids=MODE_IDS)
def test_graph_step_reads_nothing_back_to_the_host(monkeypatch, arch, kv_mode, fused,
                                                   kv_policy):
    eng = _engine(arch, kv_mode, fused, kv_policy)
    graph = _loaded_graph(eng, arch)
    graph.step()  # lazy set-up (the core's lane iota) outside the patch
    pos0 = int(graph.caches["pos"])

    def host_read(*args, **kwargs):
        raise AssertionError("a host read inside the decode step")

    with monkeypatch.context() as m:
        for name in SYNCING:
            m.setattr(torch.Tensor, name, host_read)
        for _ in range(ARCHS[arch][4]):  # across page boundaries
            graph.step()
    assert int(graph.caches["pos"]) == pos0 + ARCHS[arch][4]
    assert int(graph.nonfinite) == 0


def test_sampled_graph_step_reads_nothing_back_to_the_host(monkeypatch):
    """The sampled graph's draw (``sample_traced`` with the engine's
    generator) reads nothing back either."""
    eng = _engine("smollm", "paged", True, "awrp")
    graph = _loaded_graph(eng, "smollm", sampled=True)

    def host_read(*args, **kwargs):
        raise AssertionError("a host read inside the decode step")

    with monkeypatch.context() as m:
        for name in SYNCING:
            m.setattr(torch.Tensor, name, host_read)
        for _ in range(4):
            graph.step()
    assert bool(((graph.tok >= 0) & (graph.tok < eng.cfg.vocab)).all())


# -- (c) the graph loop equals the host loop ---------------------------------


def _spy_final_caches(eng):
    """Record a copy of each bucket's final caches from either loop."""
    seen = []
    for name in ("_graph_loop", "_host_loop"):
        orig = getattr(eng, name)

        def wrapped(*args, _orig=orig, **kwargs):
            out = _orig(*args, **kwargs)
            seen.append(TM.clone_caches(out[1]))
            return out

        setattr(eng, name, wrapped)
    return seen


def _assert_same_caches(a, b, where):
    assert torch.equal(a["pos"], b["pos"]), where
    for name, ca in a["blocks"].items():
        for x, y in zip(_leaves(ca), _leaves(b["blocks"][name]), strict=True):
            assert x.dtype == y.dtype and torch.equal(x, y), (where, name)


def _leaves(cache):
    if isinstance(cache, dict):
        return (cache["k"], cache["v"])
    if isinstance(cache, paged_kv.AdaptivePagedPool):
        return (*cache.pool, *cache.policy)
    return tuple(cache)


#: the engines' traffic: a batch of two, two distinct single requests (the
#: second's prefix miss replays the first's ghosts in the true-adaptive
#: mode), then the first again (a prefix hit)
def _traffic(arch):
    plen = ARCHS[arch][3]
    rng = np.random.RandomState(7)
    a, b, c, d = (rng.randint(1, 500, size=plen).tolist() for _ in range(4))
    return [[(0, a), (1, b)], [(10, c)], [(11, d)], [(12, c)]]


LOOP_CASES = [("smollm", "full", False, "awrp"), ("smollm", "paged", False, "awrp"),
              ("smollm", "paged", True, "awrp"), ("smollm", "paged", True, "arc_adaptive"),
              ("smollm", "paged", False, "car_adaptive"), ("gemma3", "paged", True, "awrp"),
              ("phi35", "paged", True, "arc_adaptive")]


@pytest.mark.parametrize("arch,kv_mode,fused,kv_policy", LOOP_CASES,
                         ids=["-".join(str(x) for x in m) for m in LOOP_CASES])
def test_graph_loop_matches_host_loop_greedy(arch, kv_mode, fused, kv_policy):
    new = ARCHS[arch][4] + 2
    runs = {}
    for jit in (True, False):
        eng = _engine(arch, kv_mode, fused, kv_policy, jit_loop=jit)
        seen = _spy_final_caches(eng)
        tokens = []
        for run in _traffic(arch):
            res = eng.generate([Request(i, list(p), max_new_tokens=new) for i, p in run])
            tokens.append([(res[i].tokens, res[i].prefill_cached) for i, _ in run])
        runs[jit] = (eng, seen, tokens)
    (ej, seen_j, tok_j), (eh, seen_h, tok_h) = runs[True], runs[False]
    assert tok_j == tok_h
    timing = ("prefill_s", "decode_s", "loop_captures")
    assert {k: v for k, v in ej.stats.items() if k not in timing} == \
        {k: v for k, v in eh.stats.items() if k not in timing}
    assert ej.stats["loop_captures"] == 2 and eh.stats["loop_captures"] == 0  # B = 2, 1
    assert ej.stats["nonfinite_logits"] == 0
    if kv_mode == "paged":
        assert ej.stats["kv_evictions"] > 0
    assert len(seen_j) == len(seen_h) == 4
    for i, (a, b) in enumerate(zip(seen_j, seen_h)):
        _assert_same_caches(a, b, f"bucket {i}")
    assert set(ej._kv_sessions) == set(eh._kv_sessions)
    for tenant, states in ej._kv_sessions.items():
        for name, st in states.items():
            for x, y in zip(st, eh._kv_sessions[tenant][name]):
                assert torch.equal(x, y), (tenant, name)
    if kv_policy in paged_kv.TRUE_ADAPTIVE_KV:
        assert ej._kv_sessions
        # smollm's second single request re-prefills pages the first evicted
        assert arch != "smollm" or ej.stats["kv_ghost_hits"] > 0


def test_sampled_graph_loop_matches_host_loop():
    """A temperature above 0: the graph's draws come from the engine's
    generator, in the host loop's order, so the tokens are equal."""
    runs = []
    for jit in (True, False):
        eng = _engine("smollm", "paged", True, "awrp", jit_loop=jit, seed=3)
        res = eng.generate([Request(i, list(p), max_new_tokens=12, temperature=0.8)
                            for i, p in enumerate(_prompt("smollm").tolist())])
        runs.append([res[i].tokens for i in range(2)])
    assert runs[0] == runs[1]


# -- (d) stored payloads never alias the static tree -------------------------


def _ptrs(tree) -> set:
    if isinstance(tree, torch.Tensor):
        return {tree.data_ptr()}
    if isinstance(tree, dict):
        return set().union(*(_ptrs(v) for v in tree.values()))
    return set().union(*(_ptrs(v) for v in tree))


def test_graph_loop_prefix_payload_survives_repeated_loops():
    eng = _engine("smollm", "paged", True, "awrp")
    prompt = _prompt("smollm")[0].tolist()
    first = eng.generate([Request(0, list(prompt), max_new_tokens=12)])
    outs = [eng.generate([Request(i, list(prompt), max_new_tokens=12)]) for i in (1, 2, 3)]
    assert not first[0].prefill_cached
    for i, out in enumerate(outs, start=1):
        assert out[i].prefill_cached  # every reuse hit the stored payload
        assert out[i].tokens == first[0].tokens
    assert eng.stats["prefills"] == 1
    (graph,) = eng._graphs.values()
    (payload,) = eng.prefix_cache.store.values()
    assert not _ptrs(payload[1]) & _ptrs(graph.caches)


# -- (e) the port's graph loop against the reference's jitted loop -----------


def test_graph_engine_tokens_equal_reference_jit_loop():
    jcfg, jparams, tcfg, tparams = _with_policy("smollm", "awrp")
    prompts = [list(p) for p in _prompt("smollm").tolist()]
    jeng = JServeEngine(jcfg, jparams, max_len=64, kv_mode="paged", jit_loop=True)
    teng = ServeEngine(tcfg, tparams, max_len=64, kv_mode="paged", fused=True,
                       jit_loop=True, device="cpu")
    for rid, batch in ((0, prompts), (5, prompts[:1]), (6, prompts[:1])):
        want = jeng.generate([JRequest(rid + i, list(p), max_new_tokens=24)
                              for i, p in enumerate(batch)])
        got = teng.generate([Request(rid + i, list(p), max_new_tokens=24)
                             for i, p in enumerate(batch)])
        for i in range(len(batch)):
            assert got[rid + i].tokens == want[rid + i].tokens, rid + i
            assert got[rid + i].prefill_cached == want[rid + i].prefill_cached
    assert teng.stats["decode_steps"] == jeng.stats["decode_steps"]
    assert teng.stats["loop_captures"] == 2 and teng.stats["kv_evictions"] > 0


# -- the runner's ownership of its stream and buffers -------------------------


def test_capture_runs_with_garbage_collection_off(monkeypatch):
    """The capture runs with Python's garbage collector off (and the warm-up
    and the collector's state after it as before): a collection inside a
    capture may destroy a dropped engine's CUDA graph, which invalidates the
    capture.  The CUDA calls of ``DecodeGraph._capture`` are faked here, so
    the step runs eagerly on the CPU."""
    seen = []

    class Stream:
        def wait_stream(self, other):
            pass

    class Graph:
        def register_generator_state(self, gen):
            pass

    @contextlib.contextmanager
    def capture(graph, stream):
        seen.append(gc.isenabled())
        yield

    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", capture)
    eng = _engine("smollm", "paged", True, "awrp")
    graph = _loaded_graph(eng, "smollm")
    assert gc.isenabled()
    graph._capture(Stream())
    assert seen == [False] and gc.isenabled() and isinstance(graph.graph, Graph)
    gc.disable()
    try:
        graph._capture(Stream())
        assert not gc.isenabled()  # a caller's setting is kept
    finally:
        gc.enable()


def test_graph_per_key_reused_and_disjoint_from_loaded_caches():
    eng = _engine("smollm", "paged", True, "awrp")
    prompts = _prompt("smollm").tolist()
    eng.generate([Request(0, prompts[0], max_new_tokens=6)])
    (g1,) = eng._graphs.values()
    tree = _ptrs(g1.caches)
    eng.generate([Request(1, prompts[1], max_new_tokens=9)])  # same key: reused
    assert list(eng._graphs.values()) == [g1] and _ptrs(g1.caches) == tree
    eng.generate([Request(2 + i, p, max_new_tokens=5) for i, p in enumerate(prompts)])
    eng.generate([Request(4, prompts[0][::-1], max_new_tokens=5, temperature=0.5)])
    # one graph per (cache shapes: here the batch size, greedy or sampled)
    assert sorted((g.tok.shape[0], g.generator is not None)
                  for g in eng._graphs.values()) == [(1, False), (1, True), (2, False)]
    assert eng.stats["loop_captures"] == 3
    assert all(isinstance(g, DecodeGraph) and g.graph is None for g in eng._graphs.values())
    assert eng._capture_stream is None  # nothing is captured on the CPU
    _, caches = eng._prefill([prompts[0]])
    g1.load(caches, torch.zeros((1, 1), dtype=torch.int32), 0.0)
    assert not _ptrs(caches) & _ptrs(g1.caches)
    assert torch.equal(g1.caches["pos"], caches["pos"])
    assert int(g1.evictions) == int(g1.nonfinite) == 0


def test_capture_stream_is_made_once_per_engine(monkeypatch):
    """Every capture of an engine goes to one stream it owns, so the split
    kernels' per-stream arrival counters are set up once per engine."""
    made = []

    class FakeStream:
        def __init__(self, device=None):
            made.append(device)

    monkeypatch.setattr(torch.cuda, "Stream", FakeStream)
    eng = _engine("smollm", "paged", True, "awrp")
    first = eng.capture_stream()
    assert eng.capture_stream() is first and made == [eng.device]
    other = _engine("smollm", "paged", True, "awrp")
    assert other.capture_stream() is not first and len(made) == 2


def test_single_token_requests_build_no_graph():
    eng = _engine("smollm", "paged", True, "awrp")
    res = eng.generate([Request(0, _prompt("smollm")[0].tolist(), max_new_tokens=1)])
    assert len(res[0].tokens) == 1 and eng.stats["loop_captures"] == 0


def test_host_loop_flag_reaches_the_engine(monkeypatch):
    from repro_torch.launch import serve as serve_cli

    made = []
    real = serve_cli.ServeEngine

    def spy(*args, **kwargs):
        made.append(kwargs["jit_loop"])
        return real(*args, **kwargs)

    monkeypatch.setattr(serve_cli, "ServeEngine", spy)
    argv = ["--smoke", "--device", "cpu", "--dtype", "float32", "--kv-mode", "paged",
            "--fused", "--kv-pages", "2", "--prompt-len", "32", "--new-tokens", "6",
            "--requests", "2"]
    a = serve_cli.main(argv)
    b = serve_cli.main(argv + ["--host-loop"])
    assert made == [True, False]
    assert [r.tokens for r in a.values()] == [r.tokens for r in b.values()]


# -- sampling and the core's masked check --------------------------------------


def test_sample_traced_equals_sample():
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((3, 1, 256)).astype(np.float32))
    greedy = sample(logits, vocab=200)
    for t in (0.0, -1.0):
        got = sample_traced(logits, torch.Generator().manual_seed(1),
                            torch.tensor(t), vocab=200)
        assert torch.equal(got, greedy)
    assert torch.equal(sample_traced(logits, None, torch.tensor(0.9), vocab=200), greedy)
    for t in (0.3, 1.0, 2.5):
        want = sample(logits, torch.Generator().manual_seed(4), temperature=t, vocab=200)
        got = sample_traced(logits, torch.Generator().manual_seed(4), torch.tensor(t),
                            vocab=200)
        assert torch.equal(got, want) and got.dtype == torch.int32
        assert bool((got < 200).all())


@pytest.mark.parametrize("kind", ["arc", "car"])
def test_masked_renorm_equals_host_checked_renorm(kind):
    """``masked_renorm=True`` gives the host-checked core's planes bit for
    bit with the renormalization firing often, and adds no host sync of its
    own."""
    rng = np.random.RandomState(5)
    stream = rng.randint(0, 9, size=(2, 120)).astype(np.int32)
    cores = [policy_core.AdaptiveCore(kind=kind, caps=(3, 4), renorm_at=20,
                                      masked_renorm=m) for m in (False, True)]
    states = [c.init(device="cpu") for c in cores]
    for t in range(stream.shape[1]):
        ids = torch.from_numpy(stream[:, t])
        before = policy_core.HOST_SYNCS["renorm"]
        states[1], hit_m = cores[1].on_access(states[1], ids)
        assert policy_core.HOST_SYNCS["renorm"] == before
        states[0], hit = cores[0].on_access(states[0], ids)
        assert torch.equal(hit, hit_m)
        for a, b in zip(*states):
            assert torch.equal(a, b), t
    assert int(states[0].ctr.max()) < 20 + 2 * (4 + 2)


# -- on the card ------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the decode graph is captured there)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_graph_replays_equal_host_loop_on_one_stream(cuda_device):
    from repro_torch.kernels import paged_attn

    # published widths (the kernels' head rows), two layers, a 3-page pool
    cfg = dataclasses.replace(smollm_360m.CONFIG, n_layers=2, bounded_kv_pages=3,
                              page_size=8, kv_policy="awrp")
    params = TM.init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0),
                            device=cuda_device)
    prompts = [list(p) for p in _prompt("smollm").tolist()]
    toks = {}
    for jit in (True, False):
        eng = ServeEngine(cfg, params, max_len=64, kv_mode="paged", fused=True,
                          jit_loop=jit, device=cuda_device)
        ops.reset_launches()
        for rid in (0, 2):
            res = eng.generate([Request(rid + i, list(p), max_new_tokens=20)
                                for i, p in enumerate(prompts)])
        toks[jit] = ([res[i].tokens for i in (2, 3)], ops.LAUNCHES["policy_paged_attention"])
        if jit:
            assert eng.stats["loop_captures"] == 1
            handle = eng.capture_stream().cuda_stream
            (counters,) = [c for (_, st), c in paged_attn._COUNTERS.items()
                           if st == handle]
            assert int(counters.abs().sum()) == 0
    assert toks[True] == toks[False]
    assert toks[True][1] == 2 * ops.SPLIT_LAUNCHES * cfg.n_layers * 19
