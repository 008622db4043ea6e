"""gemma3-27b SMOKE_CONFIG (2 local + 1 global unit, 2 local tail, window
16, a 4-page pool of 8) through the port against the JAX reference, on the
CPU in float32, the reference's weights carried across by
``params_from_jax``:

* declarations: the reference's pattern-scanned tree (``u0``..``u2``
  stacked, ``t0``/``t1`` unstacked, GELU without ``w_gate``);
* prefill logits within PREFILL_TOL at a 48-token prompt (longer than the
  window and the pool), ring caches and pool planes equal;
* DECODE_STEPS decode steps in ``full`` and ``paged`` (unfused / fused)
  modes: logits within DECODE_TOL, pool planes bitwise, ring caches within
  PREFILL_TOL; both sides are fed the reference's greedy token;
* the engines: equal greedy tokens for paged AWRP (fused) and for
  ``arc_adaptive`` with equal ghost-hit counts.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import load_smoke_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.cache import paged_kv  # noqa: E402
from repro_torch.configs import gemma3_27b  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

torch.set_num_threads(2)

PREFILL_TOL = 1e-4
DECODE_TOL = 2e-3
DECODE_STEPS = 24  # 48 + 24 tokens: three evicting page boundaries, 4+ ring wraps
F32 = dict(dtype="float32", param_dtype="float32")
PROMPT = (np.arange(1, 49, dtype=np.int32)[None].repeat(2, 0) * np.array([[1], [5]])) % 500
NEW_TOKENS = 20


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(load_smoke_config("gemma3_27b"), **F32)
    tcfg = dataclasses.replace(gemma3_27b.SMOKE_CONFIG, **F32)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(3))
    np_params = jax.tree.map(np.asarray, jparams)
    tparams = params_from_jax(np_params, tcfg, device="cpu", dtype=torch.float32)
    return jcfg, jparams, np_params, tcfg, tparams


def _decl_shapes(tree):
    return {k: (_decl_shapes(v) if isinstance(v, dict) else tuple(v.shape))
            for k, v in tree.items()}


def test_config_copies_reference():
    jcfg = load_smoke_config("gemma3_27b")
    from repro.configs import gemma3_27b as jg

    for mine, ref_cfg in ((gemma3_27b.CONFIG, jg.CONFIG), (gemma3_27b.SMOKE_CONFIG, jcfg)):
        for f in dataclasses.fields(mine):
            assert getattr(mine, f.name) == getattr(ref_cfg, f.name), f.name
        assert mine.layer_pattern == ref_cfg.layer_pattern
    assert gemma3_27b.CONFIG.layer_pattern.count("global") == 10
    assert len(gemma3_27b.CONFIG.layer_pattern) == gemma3_27b.CONFIG.n_layers == 62


def test_param_decls_match_reference(models):
    jcfg, _, _, tcfg, _ = models
    want = _decl_shapes(JM.param_decls(jcfg))
    assert _decl_shapes(TM.param_decls(tcfg)) == want
    assert set(want) >= {"u0", "u1", "u2", "t0", "t1"}
    assert "w_gate" not in want["u2"] and "w_gate" not in want["t0"]
    assert TM.scan_plan(tcfg) == ([("u0", "local"), ("u1", "local"), ("u2", "global")],
                                  1, [("t0", "local"), ("t1", "local")])


def test_params_from_jax_carries_tree_and_refuses_missing_or_extra_position(models):
    _, jparams, np_params, tcfg, tparams = models
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        node = tparams
        for key in path:
            node = node[key.key]
        assert np.array_equal(node.numpy(), np.asarray(leaf))
    missing = {k: v for k, v in np_params.items() if k != "t1"}
    with pytest.raises(ValueError, match="keys"):
        params_from_jax(missing, tcfg, device="cpu")
    extra = dict(np_params, t2=np_params["t1"])
    with pytest.raises(ValueError, match="keys"):
        params_from_jax(extra, tcfg, device="cpu")


def test_unsupported_blocks_are_refused():
    # the enc-dec family with a local/global pattern (its blocks are dense
    # whatever the pattern) and a VLM without patch positions stay refused
    for change in (dict(pattern=("local", "mamba")), dict(family="moe", n_experts=4),
                   dict(family="encdec", enc_layers=2, dec_layers=2),
                   dict(family="vlm", n_patch_tokens=0),
                   dict(sliding_window=0)):
        cfg = dataclasses.replace(gemma3_27b.SMOKE_CONFIG, **change)
        with pytest.raises(NotImplementedError, match="ported"):
            TM.param_decls(cfg)


def test_gelu_mlp_matches_reference(models):
    _, jparams, _, _, tparams = models
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 128)).astype(np.float32)
    jp = {k: v[0] for k, v in jparams["u2"].items()}
    tp = {k: v[0] for k, v in tparams["u2"].items()}
    want = np.asarray(JL.mlp(jp, jnp.asarray(x), "gelu"))
    got = TL.mlp(tp, torch.from_numpy(x), "gelu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _assert_caches_equal(tc, jc, where):
    assert tc["pos"] == int(jc["pos"]), where
    assert set(tc["blocks"]) == set(jc["blocks"]), where
    for name, tb in tc["blocks"].items():
        jb = jc["blocks"][name]
        if isinstance(tb, dict):  # a local ring or a full cache
            for kv in ("k", "v"):
                np.testing.assert_allclose(tb[kv].numpy(), np.asarray(jb[kv]),
                                           rtol=PREFILL_TOL, atol=PREFILL_TOL,
                                           err_msg=f"{where}: {name}.{kv}")
            continue
        for field in ("f", "r", "page_start", "clock", "open_slot"):
            a, b = getattr(tb, field), np.asarray(getattr(jb, field))
            assert a.dtype == torch.int32 and np.array_equal(a.numpy(), b), \
                f"{where}: {name}.{field}"
        np.testing.assert_allclose(tb.k.numpy(), np.asarray(jb.k), rtol=PREFILL_TOL,
                                   atol=PREFILL_TOL, err_msg=f"{where}: {name}.k")


@pytest.mark.parametrize("kv_mode", ["full", "paged"])
def test_prefill_logits_and_caches_match_reference(models, kv_mode):
    jcfg, jparams, _, tcfg, tparams = models
    jl, jc = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(PROMPT)}, max_len=80,
                        kv_mode=kv_mode)
    tl, tc = TM.prefill(tparams, tcfg, torch.from_numpy(PROMPT), 80, kv_mode=kv_mode)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=PREFILL_TOL,
                               atol=PREFILL_TOL)
    _assert_caches_equal(tc, jc, "prefill")
    assert tuple(tc["blocks"]["u0"]["k"].shape) == (1, 2, 16, tcfg.kv_dim)
    assert tuple(tc["blocks"]["t1"]["k"].shape) == (2, 16, tcfg.kv_dim)


@pytest.mark.parametrize("kv_mode,fused", [("full", False), ("paged", False),
                                           ("paged", True)])
def test_decode_steps_match_reference(models, kv_mode, fused):
    jcfg, jparams, _, tcfg, tparams = models
    max_len = PROMPT.shape[1] + DECODE_STEPS
    jl, jc = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(PROMPT)},
                        max_len=max_len, kv_mode=kv_mode)
    _, tc = TM.prefill(tparams, tcfg, torch.from_numpy(PROMPT), max_len,
                       kv_mode=kv_mode)
    step = jax.jit(lambda p, tk, c: JM.decode_step(p, jcfg, tk, c, kv_mode=kv_mode,
                                                   fused=fused))
    tok = jnp.argmax(jl[:, -1:], -1).astype(jnp.int32)
    for i in range(DECODE_STEPS):
        jl, jc = step(jparams, tok, jc)
        tl, tc = TM.decode_step(tparams, tcfg, torch.from_numpy(np.array(tok)), tc,
                                kv_mode=kv_mode, fused=fused)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=DECODE_TOL,
                                   atol=DECODE_TOL, err_msg=f"step {i}")
        _assert_caches_equal(tc, jc, f"step {i}")
        tok = jnp.argmax(jl[:, -1:], -1).astype(jnp.int32)
    if kv_mode == "paged":  # the global pool evicted at every page boundary
        assert int(tc["blocks"]["u2"].clock.min()) == 4 + DECODE_STEPS


def test_ring_helpers_match_reference_through_three_wraps():
    W, B, kvd = 8, 2, 4
    rng = np.random.default_rng(1)
    jk = jnp.zeros((B, W, kvd))
    jv = jnp.zeros((B, W, kvd))
    tk, tv = torch.zeros((B, W, kvd)), torch.zeros((B, W, kvd))
    for pos in range(3 * W + 3):
        nk = rng.standard_normal((B, 1, kvd)).astype(np.float32)
        nv = rng.standard_normal((B, 1, kvd)).astype(np.float32)
        jk, jv = JM.paged_kv.ring_insert(jk, jv, jnp.asarray(nk), jnp.asarray(nv),
                                         jnp.asarray(pos, jnp.int32))
        tpos = torch.tensor(pos, dtype=torch.int32)
        tk, tv = paged_kv.ring_insert(tk, tv, torch.from_numpy(nk),
                                      torch.from_numpy(nv), tpos)
        assert np.array_equal(tk.numpy(), np.asarray(jk))
        assert np.array_equal(tv.numpy(), np.asarray(jv))
        want = np.asarray(JM.paged_kv.ring_positions(jnp.asarray(pos, jnp.int32), W))
        got = paged_kv.ring_positions(tpos, W)
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want), pos


def _prompts(seed, n, length=48, vocab=500):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, size=length).tolist() for _ in range(n)]


def test_engine_greedy_tokens_equal_reference_engine(models):
    jcfg, jparams, _, tcfg, tparams = models
    prompts = _prompts(0, 2)
    jeng = JServeEngine(jcfg, jparams, max_len=96, kv_mode="paged", fused=True)
    want = jeng.generate([JRequest(i, list(p), max_new_tokens=NEW_TOKENS)
                          for i, p in enumerate(prompts)])
    teng = ServeEngine(tcfg, tparams, max_len=96, kv_mode="paged", fused=True,
                       device="cpu")
    got = teng.generate([Request(i, list(p), max_new_tokens=NEW_TOKENS)
                         for i, p in enumerate(prompts)])
    for i in range(len(prompts)):
        assert got[i].tokens == want[i].tokens, f"request {i}"
    assert teng.stats["kv_evictions"] > 0 and teng.stats["nonfinite_logits"] == 0


def test_adaptive_engine_tokens_and_ghost_hits_equal_reference_engine(models):
    """arc_adaptive on the global layers: a single request A of 4 pages (the
    pool's size), then A's follow-up turn (its prompt and the tokens it
    generated: the re-prefill re-references page positions A's decode
    evicted, so they ghost-hit), then A again (a prefix hit).  Tokens, prefix hits, ghost hits after
    every run and the persisted policy planes equal the JAX engine's."""
    jcfg, jparams, _, tcfg, tparams = models
    jcfg = dataclasses.replace(jcfg, kv_policy="arc_adaptive")
    tcfg = dataclasses.replace(tcfg, kv_policy="arc_adaptive")
    jeng = JServeEngine(jcfg, jparams, max_len=128, kv_mode="paged", jit_loop=False)
    teng = ServeEngine(tcfg, tparams, max_len=128, kv_mode="paged", fused=True,
                       device="cpu")
    a = _prompts(4, 1, length=32)[0]  # 4 pages: the whole prompt is resident
    want_a = jeng.generate([JRequest(0, list(a), max_new_tokens=NEW_TOKENS)])[0]
    got_a = teng.generate([Request(0, list(a), max_new_tokens=NEW_TOKENS)])[0]
    assert got_a.tokens == want_a.tokens
    follow = a + got_a.tokens
    runs = [(1, follow), (2, a)]
    for rid, prompt in runs:
        want = jeng.generate([JRequest(rid, list(prompt), max_new_tokens=NEW_TOKENS)])
        got = teng.generate([Request(rid, list(prompt), max_new_tokens=NEW_TOKENS)])
        assert got[rid].tokens == want[rid].tokens, rid
        assert got[rid].prefill_cached == want[rid].prefill_cached
        assert teng.stats["kv_ghost_hits"] == jeng.stats["kv_ghost_hits"], rid
    assert teng.stats["kv_ghost_hits"] > 0
    (jstate,) = jeng._kv_sessions["default"]
    assert list(teng._kv_sessions["default"]) == ["u2"]
    for name, x, y in zip(jstate._fields, teng._kv_sessions["default"]["u2"], jstate):
        assert np.array_equal(x.numpy(), np.asarray(y)), name


def test_launch_serve_gemma3_runs_on_cpu(capsys):
    results = serve_cli.main(["--arch", "gemma3_27b", "--smoke", "--device", "cpu",
                              "--dtype", "float32", "--requests", "3",
                              "--new-tokens", "6", "--prompt-len", "40",
                              "--kv-mode", "paged", "--fused", "--repeat-prompts"])
    out = capsys.readouterr().out
    assert len(results) == 3 and all(len(r.tokens) == 6 for r in results.values())
    assert results[2].prefill_cached
    assert "arch=gemma3-27b" in out and "kv evictions=" in out
