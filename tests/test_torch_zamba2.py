"""zamba2-7b's SMOKE_CONFIG (2 x (2 Mamba-2 + 1 shared attention) + 1
Mamba-2, d 128, 4 heads of 32, a 4-page pool of 8) through the port against
the JAX reference, on the CPU in float32, the reference's weights carried
across by ``params_from_jax``:

* configs and declarations: the port's copies equal the reference's; the
  shared block is ONE unstacked parameter set (``params["shared_attn"]``),
  the very tensors every occurrence runs with;
* prefill logits within PREFILL_TOL (full and paged KV), DECODE_STEPS
  decode steps in ``full``, paged-unfused and paged-fused modes within
  DECODE_TOL with every pool plane bitwise and the Mamba states within
  DECODE_TOL (the 4-page pool evicts at every page boundary past position
  32); prefill(S - 1) plus one decode step equals the reference's
  ``forward`` at S - 1;
* the engine: greedy tokens equal to the JAX engine's (paged AWRP, fused),
  a prefix hit, ``_batch_of`` on a Mamba-first cache tree and the eviction
  count summed over the shared block's per-occurrence pools.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import zamba2_7b as jzamba  # noqa: E402
from repro.configs.base import load_smoke_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.cache import paged_kv  # noqa: E402
from repro_torch.configs import zamba2_7b  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

torch.set_num_threads(2)

PREFILL_TOL = 1e-4
DECODE_TOL = 2e-3
DECODE_STEPS = 40  # positions 32..71: five evicting page boundaries
F32 = dict(dtype="float32", param_dtype="float32")
PROMPT = (np.arange(1, 33, dtype=np.int32)[None].repeat(2, 0) * np.array([[1], [3]])) % 500


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(load_smoke_config("zamba2_7b"), **F32)
    tcfg = dataclasses.replace(zamba2_7b.SMOKE_CONFIG, **F32)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(5))
    np_params = jax.tree.map(np.asarray, jparams)
    tparams = params_from_jax(np_params, tcfg, device="cpu", dtype=torch.float32)
    return jcfg, jparams, tcfg, tparams


def test_config_copies_reference():
    for mine, want in ((zamba2_7b.CONFIG, jzamba.CONFIG),
                       (zamba2_7b.SMOKE_CONFIG, load_smoke_config("zamba2_7b"))):
        for f in dataclasses.fields(mine):
            assert getattr(mine, f.name) == getattr(want, f.name), f.name
        assert mine.layer_pattern == want.layer_pattern
    full = zamba2_7b.CONFIG
    assert len(full.layer_pattern) == full.n_layers == 81
    assert full.layer_pattern.count("shared_attn") == 13 and full.head_dim == 112


def test_shared_block_is_one_parameter_set(models):
    jcfg, _, tcfg, tparams = models
    decls = TM.param_decls(tcfg)
    want = JM.param_decls(jcfg)
    assert set(decls) == set(want) == {"embed", "final_norm", "unembed", "u0", "u1",
                                       "shared_attn", "t0"}
    for name, d in decls["shared_attn"].items():  # unstacked
        assert d.shape == want["shared_attn"][name].shape, name
    assert TM.scan_plan(tcfg) == ([("u0", "mamba"), ("u1", "mamba"),
                                   ("u2", "shared_attn")], 2, [("t0", "mamba")])
    # every occurrence runs the very same tensors
    for i in range(tcfg.n_repeats):
        layer = TM._layer(tparams, "u2", "shared_attn", i)
        assert all(layer[k] is tparams["shared_attn"][k] for k in layer)
    # and decode reads them through that one set
    seen = []
    orig = TL.decode_kv_row

    def spy(p, *a, **kw):
        seen.append(p["wk"].data_ptr())
        return orig(p, *a, **kw)

    caches = TM.decode_caches(tcfg, 1, 16, kv_mode="paged", device="cpu")
    try:
        TL.decode_kv_row = spy
        TM.decode_step(tparams, tcfg, torch.ones((1, 1), dtype=torch.int32), caches,
                       kv_mode="paged")
    finally:
        TL.decode_kv_row = orig
    assert seen == [tparams["shared_attn"]["wk"].data_ptr()] * tcfg.n_repeats


def _assert_caches(tc, jc, where, tol):
    assert tc["pos"] == int(jc["pos"]), where
    assert set(tc["blocks"]) == set(jc["blocks"]), where
    for name, tb in tc["blocks"].items():
        jb = jc["blocks"][name]
        if isinstance(tb, (dict, TM.MambaCache)):  # a Mamba cache or a full {"k", "v"}
            for key, a in (tb._asdict() if isinstance(tb, TM.MambaCache) else tb).items():
                np.testing.assert_allclose(a.numpy(), np.asarray(jb[key]), rtol=tol,
                                           atol=tol, err_msg=f"{where}: {name}.{key}")
            continue
        for field in ("f", "r", "page_start", "clock", "open_slot"):
            a, b = getattr(tb, field), np.asarray(getattr(jb, field))
            assert a.dtype == torch.int32 and np.array_equal(a.numpy(), b), \
                f"{where}: {name}.{field}"
        np.testing.assert_allclose(tb.k.numpy(), np.asarray(jb.k), rtol=tol, atol=tol,
                                   err_msg=f"{where}: {name}.k")


@pytest.mark.parametrize("kv_mode", ["full", "paged"])
def test_prefill_logits_and_caches_match_reference(models, kv_mode):
    jcfg, jparams, tcfg, tparams = models
    jl, jc = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(PROMPT)}, max_len=80,
                        kv_mode=kv_mode)
    tl, tc = TM.prefill(tparams, tcfg, torch.from_numpy(PROMPT), 80, kv_mode=kv_mode)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=PREFILL_TOL,
                               atol=PREFILL_TOL)
    _assert_caches(tc, jc, "prefill", PREFILL_TOL)
    assert isinstance(tc["blocks"]["t0"], TM.MambaCache)
    # the unit's positions, then the tail's, as decode_caches and decode_step
    assert list(tc["blocks"]) == list(
        TM.decode_caches(tcfg, 2, 80, kv_mode=kv_mode, device="cpu")["blocks"])
    assert tuple(tc["blocks"]["t0"].state.shape) == (2, tcfg.ssm_heads,
                                                        tcfg.ssm_head_dim, tcfg.ssm_state)


@pytest.mark.parametrize("kv_mode,fused", [("full", False), ("paged", False),
                                           ("paged", True)])
def test_decode_steps_match_reference(models, kv_mode, fused):
    jcfg, jparams, tcfg, tparams = models
    max_len = PROMPT.shape[1] + DECODE_STEPS
    jl, jc = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(PROMPT)}, max_len=max_len,
                        kv_mode=kv_mode)
    _, tc = TM.prefill(tparams, tcfg, torch.from_numpy(PROMPT), max_len, kv_mode=kv_mode)
    state0 = tc["blocks"]["u0"].state.clone()
    step = jax.jit(lambda p, tk, c: JM.decode_step(p, jcfg, tk, c, kv_mode=kv_mode,
                                                   fused=fused))
    tok = jnp.argmax(jl[:, -1:], -1).astype(jnp.int32)
    for i in range(DECODE_STEPS):
        jl, jc = step(jparams, tok, jc)
        tl, tc = TM.decode_step(tparams, tcfg, torch.from_numpy(np.array(tok)), tc,
                                kv_mode=kv_mode, fused=fused)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=DECODE_TOL,
                                   atol=DECODE_TOL, err_msg=f"step {i}")
        _assert_caches(tc, jc, f"step {i}", DECODE_TOL)
        tok = jnp.argmax(jl[:, -1:], -1).astype(jnp.int32)
    assert not torch.equal(tc["blocks"]["u0"].state, state0)
    if kv_mode == "paged":  # each occurrence's pool allocated past its 4 pages
        pool = tc["blocks"]["u2"]
        assert tuple(pool.clock.shape) == (tcfg.n_repeats, 2)
        assert int(pool.clock.min()) == 4 + DECODE_STEPS  # one tick a step
        # the newest page holds the last position: every boundary allocated
        last = PROMPT.shape[1] + DECODE_STEPS - 1
        assert int(pool.page_start.max(-1).values.min()) == last // tcfg.page_size * tcfg.page_size


def test_prefill_then_one_step_equals_reference_forward(models):
    jcfg, jparams, tcfg, tparams = models
    full = np.asarray(JM.forward(jparams, jcfg, {"tokens": jnp.asarray(PROMPT)}))
    _, tc = TM.prefill(tparams, tcfg, torch.from_numpy(PROMPT[:, :-1]), 40)
    tl, tc = TM.decode_step(tparams, tcfg, torch.from_numpy(PROMPT[:, -1:]), tc)
    np.testing.assert_allclose(tl[:, 0].numpy(), full[:, -1], rtol=2e-4, atol=2e-4)
    assert int(tc["pos"]) == PROMPT.shape[1]


def test_engine_greedy_tokens_equal_reference_engine(models):
    """AWRP through the fused step: a batch of two (past the pool, so it
    evicts), then one prompt twice (a prefix hit, the same tokens)."""
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 500, size=32).tolist() for _ in range(2)]
    jeng = JServeEngine(jcfg, jparams, max_len=64, kv_mode="paged", fused=True)
    teng = ServeEngine(tcfg, tparams, max_len=64, kv_mode="paged", fused=True,
                       device="cpu")
    got = {}
    for rid, batch in ((0, prompts), (5, prompts[:1]), (6, prompts[:1])):
        want = jeng.generate([JRequest(rid + i, list(p), max_new_tokens=12)
                              for i, p in enumerate(batch)])
        got.update(teng.generate([Request(rid + i, list(p), max_new_tokens=12)
                                  for i, p in enumerate(batch)]))
        for i in range(len(batch)):
            assert got[rid + i].tokens == want[rid + i].tokens, rid + i
            assert got[rid + i].prefill_cached == want[rid + i].prefill_cached
    assert got[6].prefill_cached and got[6].tokens == got[5].tokens
    assert teng.prefix_cache.hits == 1
    assert teng.stats["kv_evictions"] > 0 and teng.stats["nonfinite_logits"] == 0


def test_engine_batch_of_and_evictions_over_shared_block_pools(models):
    _, _, tcfg, tparams = models
    teng = ServeEngine(tcfg, tparams, max_len=64, kv_mode="paged", device="cpu")
    caches = TM.decode_caches(tcfg, 3, 64, kv_mode="paged", device="cpu")
    assert next(iter(caches["blocks"])) == "u0"  # a Mamba position comes first
    assert tengine._batch_of(caches["blocks"]["u0"]) == 3
    assert tengine._batch_of(caches["blocks"]["t0"]) == 3
    pool = caches["blocks"]["u2"]
    assert isinstance(pool, paged_kv.PagedPool) and tengine._batch_of(pool) == 3
    # every occurrence's pool full in one sequence: one eviction per
    # occurrence at a page boundary, none mid-page
    pool.page_start[:, 0] = torch.arange(tcfg.bounded_kv_pages, dtype=torch.int32)
    caches["pos"] = torch.tensor(4 * tcfg.page_size, dtype=torch.int32)
    assert int(teng._evictions_at(caches)) == tcfg.n_repeats
    caches["pos"] = torch.tensor(4 * tcfg.page_size + 1, dtype=torch.int32)
    assert int(teng._evictions_at(caches)) == 0
