"""mamba2-370m's SMOKE_CONFIG (4 Mamba-2 blocks, d 128, 8 SSM heads of 32,
state 16, chunk 32) and the Mamba-2 layers through the port against the JAX
reference, on the CPU in float32, the reference's weights carried across by
``params_from_jax``:

* configs and declarations: the port's copies equal the reference's; its
  ``init_params`` draws the Mamba leaves as the reference does (D skip
  ones, ``a_log`` = log(linspace(1, 16, H)), the dt bias the inverse
  softplus of a dt in [1e-3, 1e-1]) and keeps them in f32;
* layers: ``_segsum``, ``ssd_chunked`` (S no multiple of the chunk, with
  and without an initial state), ``mamba2_block`` and
  ``mamba2_decode_step`` within LAYER_RTOL + LAYER_ATOL;
* the model: prefill logits and its ``MambaCache`` (state, conv) within
  PREFILL_TOL, DECODE_STEPS decode steps within DECODE_TOL (every kv_mode:
  an SSM has no KV cache), the state advancing at every step and equal to
  JAX's; prefill(S - 1) plus one decode step equals the reference's
  ``forward`` at S - 1;
* the engine (``tests/test_serving.py``'s checks): greedy determinism, a
  prefix hit that skips the prefill and repeats the tokens, tokens equal to
  the JAX engine's on both decode loops, ``_batch_of`` and the eviction
  count with Mamba caches and no pool.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import mamba2_370m as jmamba  # noqa: E402
from repro.configs.base import load_smoke_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import mamba2_370m  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

torch.set_num_threads(2)

LAYER_RTOL, LAYER_ATOL = 1e-5, 1e-6
PREFILL_TOL = 1e-4
DECODE_TOL = 2e-3
DECODE_STEPS = 40
F32 = dict(dtype="float32", param_dtype="float32")
PROMPT = (np.arange(1, 41, dtype=np.int32)[None].repeat(2, 0) * np.array([[1], [7]])) % 500


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(load_smoke_config("mamba2_370m"), **F32)
    tcfg = dataclasses.replace(mamba2_370m.SMOKE_CONFIG, **F32)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(4))
    np_params = jax.tree.map(np.asarray, jparams)
    tparams = params_from_jax(np_params, tcfg, device="cpu", dtype=torch.float32)
    return jcfg, jparams, tcfg, tparams


def _decl_shapes(tree):
    return {k: (_decl_shapes(v) if isinstance(v, dict) else (tuple(v.shape), v.init))
            for k, v in tree.items()}


def test_config_copies_reference():
    for mine, want in ((mamba2_370m.CONFIG, jmamba.CONFIG),
                       (mamba2_370m.SMOKE_CONFIG, load_smoke_config("mamba2_370m"))):
        for f in dataclasses.fields(mine):
            assert getattr(mine, f.name) == getattr(want, f.name), f.name
        assert mine.layer_pattern == want.layer_pattern
        assert (mine.d_inner, mine.ssm_heads) == (want.d_inner, want.ssm_heads)
    assert (mamba2_370m.CONFIG.d_inner, mamba2_370m.CONFIG.ssm_heads) == (2048, 32)


def test_param_decls_and_init_match_reference(models):
    jcfg, jparams, tcfg, _ = models
    assert _decl_shapes(TM.param_decls(tcfg)) == _decl_shapes(JM.param_decls(jcfg))
    cfg = mamba2_370m.SMOKE_CONFIG  # bf16 params: the Mamba leaves stay f32
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    u0 = params["u0"]
    H = cfg.ssm_heads
    for name in ("a_log", "dt_bias", "d_skip", "norm_scale", "ln1"):
        assert u0[name].dtype == torch.float32, name
    for name in ("w_in", "w_conv", "b_conv", "w_out"):
        assert u0[name].dtype == torch.bfloat16, name
    want_alog = np.log(np.linspace(1.0, 16.0, H, dtype=np.float32))
    np.testing.assert_allclose(u0["a_log"].numpy(), np.broadcast_to(want_alog, (4, H)),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(jparams["u0"]["a_log"]), u0["a_log"].numpy(),
                               rtol=1e-6)
    assert torch.equal(u0["d_skip"], torch.ones((4, H)))
    dt = torch.nn.functional.softplus(u0["dt_bias"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5) and float(dt.max()) <= 0.1 * (1 + 1e-5)
    assert len(set(u0["dt_bias"].flatten().tolist())) == 4 * H  # drawn, not filled
    assert TM.param_bytes(cfg) == sum(
        t.numel() * t.element_size() for t in _leaves(params))


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def _close(got, want, rtol=LAYER_RTOL, atol=LAYER_ATOL, msg=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=msg)


def test_segsum_matches_reference():
    x = np.random.default_rng(0).standard_normal((2, 3, 9)).astype(np.float32)
    got, want = TL._segsum(torch.from_numpy(x)), np.asarray(JL._segsum(jnp.asarray(x)))
    assert np.array_equal(np.isinf(got.numpy()), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got.numpy()[fin], want[fin], rtol=LAYER_RTOL,
                               atol=LAYER_ATOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_reference(with_state):
    """S = 40 over chunks of 16: the last chunk is padded."""
    rng = np.random.default_rng(1)
    b, s, h, p, n, chunk = 2, 40, 3, 4, 5, 16
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(h)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((b, s, n)).astype(np.float32) for _ in range(2))
    init = rng.standard_normal((b, h, p, n)).astype(np.float32) if with_state else None
    args = (x, dt, A, Bm, Cm)
    yj, fj = JL.ssd_chunked(*map(jnp.asarray, args), chunk,
                            initial_state=None if init is None else jnp.asarray(init))
    yt, ft = TL.ssd_chunked(*map(torch.from_numpy, args), chunk,
                            initial_state=None if init is None else torch.from_numpy(init))
    assert yt.shape == (b, s, h, p) and ft.dtype == torch.float32
    _close(yt, yj, msg="y")
    _close(ft, fj, msg="final state")


@pytest.fixture(scope="module")
def layer_io(models):
    _, jparams, tcfg, tparams = models
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 37, tcfg.d_model)).astype(np.float32)
    jp = {k: v[1] for k, v in jparams["u0"].items()}
    tp = {k: v[1] for k, v in tparams["u0"].items()}
    return x, jp, tp


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba2_block_matches_reference(models, layer_io, with_state):
    jcfg, _, tcfg, _ = models
    x, jp, tp = layer_io
    rng = np.random.default_rng(3)
    kw_j, kw_t = {}, {}
    if with_state:
        st = rng.standard_normal((2, tcfg.ssm_heads, tcfg.ssm_head_dim,
                                  tcfg.ssm_state)).astype(np.float32)
        cv = rng.standard_normal((2, tcfg.d_conv - 1, tcfg.d_inner + 2 * tcfg.ssm_state)
                                 ).astype(np.float32)
        kw_j = dict(initial_state=jnp.asarray(st), initial_conv=jnp.asarray(cv))
        kw_t = dict(initial_state=torch.from_numpy(st), initial_conv=torch.from_numpy(cv))
    yj, sj, cj = JL.mamba2_block(jp, jnp.asarray(x), jcfg, **kw_j)
    yt, st_, ct = TL.mamba2_block(tp, torch.from_numpy(x), tcfg, **kw_t)
    _close(yt, yj, msg="y")
    _close(st_, sj, msg="state")
    _close(ct, cj, msg="conv tail")


def test_mamba2_decode_step_matches_reference_and_replaces_its_state(models, layer_io):
    jcfg, _, tcfg, _ = models
    x, jp, tp = layer_io
    _, sj, cj = JL.mamba2_block(jp, jnp.asarray(x), jcfg)
    _, st, ct = TL.mamba2_block(tp, torch.from_numpy(x), tcfg)
    tok = np.random.default_rng(4).standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
    for i in range(3):
        yj, sj, cj = JL.mamba2_decode_step(jp, jnp.asarray(tok), jcfg, state=sj,
                                           conv_state=cj)
        before = st.clone()
        yt, st_new, ct = TL.mamba2_decode_step(tp, torch.from_numpy(tok), tcfg, state=st,
                                               conv_state=ct)
        assert torch.equal(st, before)  # the old state is left as it was
        assert not torch.equal(st_new, st)
        st = st_new
        _close(yt, yj, msg=f"y {i}")
        _close(st, sj, msg=f"state {i}")
        _close(ct, cj, msg=f"conv {i}")
        tok = np.array(yj)


def _assert_mamba_caches(tc, jc, where, tol=PREFILL_TOL):
    assert tc["pos"] == int(jc["pos"]), where
    assert set(tc["blocks"]) == set(jc["blocks"]) == {"u0"}
    for name in ("state", "conv"):
        a, b = getattr(tc["blocks"]["u0"], name), np.asarray(jc["blocks"]["u0"][name])
        assert tuple(a.shape) == b.shape, (where, name)
        np.testing.assert_allclose(a.numpy(), b, rtol=tol, atol=tol,
                                   err_msg=f"{where}: {name}")


@pytest.mark.parametrize("kv_mode", ["full", "paged"])
def test_prefill_and_decode_match_reference(models, kv_mode):
    """Prefill, then DECODE_STEPS steps fed the reference's greedy token;
    the state is replaced at every step, advances, and equals JAX's."""
    jcfg, jparams, tcfg, tparams = models
    max_len = PROMPT.shape[1] + DECODE_STEPS
    jl, jc = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(PROMPT)}, max_len=max_len,
                        kv_mode=kv_mode)
    tl, tc = TM.prefill(tparams, tcfg, torch.from_numpy(PROMPT), max_len, kv_mode=kv_mode)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=PREFILL_TOL,
                               atol=PREFILL_TOL)
    _assert_mamba_caches(tc, jc, "prefill")
    state0 = tc["blocks"]["u0"].state.clone()
    assert tuple(state0.shape) == (tcfg.n_repeats, 2, tcfg.ssm_heads, tcfg.ssm_head_dim,
                                   tcfg.ssm_state)
    step = jax.jit(lambda p, tk, c: JM.decode_step(p, jcfg, tk, c, kv_mode=kv_mode,
                                                   fused=kv_mode == "paged"))
    tok = jnp.argmax(jl[:, -1:], -1).astype(jnp.int32)
    for i in range(DECODE_STEPS):
        jl, jc = step(jparams, tok, jc)
        prev = tc["blocks"]["u0"].state
        tl, tc = TM.decode_step(tparams, tcfg, torch.from_numpy(np.array(tok)), tc,
                                kv_mode=kv_mode, fused=kv_mode == "paged")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=DECODE_TOL,
                                   atol=DECODE_TOL, err_msg=f"step {i}")
        _assert_mamba_caches(tc, jc, f"step {i}", DECODE_TOL)
        # every layer's state moved this step
        moved = (tc["blocks"]["u0"].state != prev).flatten(1).any(1)
        assert bool(moved.all()), i
        tok = jnp.argmax(jl[:, -1:], -1).astype(jnp.int32)
    assert not torch.equal(tc["blocks"]["u0"].state, state0)


def test_prefill_then_one_step_equals_reference_forward(models):
    """The reference's ``test_prefill_decode_matches_forward`` on the port:
    prefill(S - 1) and one decode step give JAX ``forward``'s logits at
    S - 1."""
    jcfg, jparams, tcfg, tparams = models
    tokens = PROMPT[:, :32]
    full = np.asarray(JM.forward(jparams, jcfg, {"tokens": jnp.asarray(tokens)}))
    _, tc = TM.prefill(tparams, tcfg, torch.from_numpy(tokens[:, :-1]), 40)
    tl, tc = TM.decode_step(tparams, tcfg, torch.from_numpy(tokens[:, -1:]), tc)
    np.testing.assert_allclose(tl[:, 0].numpy(), full[:, -1], rtol=2e-4, atol=2e-4)
    assert int(tc["pos"]) == 32


# -- the engine ---------------------------------------------------------------


def _prompts(seed, n, length=40, vocab=500):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, size=length).tolist() for _ in range(n)]


@pytest.mark.parametrize("jit_loop", [True, False])
def test_engine_greedy_tokens_prefix_hit_and_reference_engine(models, jit_loop):
    """A batch of two, then one prompt twice: deterministic greedy tokens, the
    second a prefix hit (no prefill) with the same tokens, and every
    request's tokens == the JAX engine's; no pool, so no eviction."""
    jcfg, jparams, tcfg, tparams = models
    prompts = _prompts(0, 2)
    jeng = JServeEngine(jcfg, jparams, max_len=96, kv_mode="paged", fused=True)
    teng = ServeEngine(tcfg, tparams, max_len=96, kv_mode="paged", fused=True,
                       jit_loop=jit_loop, device="cpu")
    for rid, batch in ((0, prompts), (5, prompts[:1]), (6, prompts[:1])):
        prefills = teng.stats["prefills"]
        want = jeng.generate([JRequest(rid + i, list(p), max_new_tokens=10)
                              for i, p in enumerate(batch)])
        got = teng.generate([Request(rid + i, list(p), max_new_tokens=10)
                             for i, p in enumerate(batch)])
        for i in range(len(batch)):
            assert got[rid + i].tokens == want[rid + i].tokens, rid + i
            assert got[rid + i].prefill_cached == want[rid + i].prefill_cached
        assert teng.stats["prefills"] == prefills + (rid != 6)
    assert got[6].prefill_cached and got[6].tokens == teng.generate(
        [Request(9, list(prompts[0]), max_new_tokens=10)])[9].tokens
    assert teng.prefix_cache.hits == 2 and teng.stats["kv_evictions"] == 0
    assert teng.stats["nonfinite_logits"] == 0


def test_engine_batch_of_and_evictions_with_mamba_caches(models):
    _, _, tcfg, tparams = models
    teng = ServeEngine(tcfg, tparams, max_len=64, kv_mode="paged", device="cpu")
    caches = TM.decode_caches(tcfg, 3, 64, kv_mode="paged", device="cpu")
    assert isinstance(caches["blocks"]["u0"], TM.MambaCache)
    assert tengine._batch_of(caches["blocks"]["u0"]) == 3
    assert tengine._batch_of(TM._layer_cache(caches["blocks"]["u0"], 1)) == 3
    for pos in (0, 64, 65):
        caches["pos"] = torch.tensor(pos, dtype=torch.int32)
        ev = teng._evictions_at(caches)
        assert ev.dtype == torch.int64 and int(ev) == 0  # no pool at all
    res = teng.generate([Request(0, _prompts(1, 1, 70)[0], max_new_tokens=5)])
    assert len(res[0].tokens) == 5 and teng.stats["kv_evictions"] == 0
    assert teng.stats["loop_captures"] == 1
    assert math.isfinite(teng.telemetry()["serve/decode_s"])
