"""QKV bias through the port against the JAX reference: qwen2.5-14b's
SMOKE_CONFIG (QKV bias, GQA) and yi-34b's (no bias) on the CPU in float32,
with a 3-page pool of 4-token pages, the reference's weights carried across
by ``params_from_jax``.  The reference initialises the biases to zeros, so
the tests draw them nonzero in the numpy tree before both sides get it:

* configs and declarations: the port's copies equal the reference's,
  ``bq`` / ``bk`` / ``bv`` declared (zeros, in the param dtype) exactly
  when ``qkv_bias``;
* prefill logits within PREFILL_TOL (full and paged KV); DECODE_STEPS
  decode steps in ``full``, paged-unfused and paged-fused modes within
  DECODE_TOL with every pool plane bitwise, both sides fed the reference's
  greedy token; dropping the biases moves the logits far past the
  tolerance; prefill(S - 1) plus one decode step equals the reference's
  ``forward`` at S - 1;
* the engines: equal greedy tokens (qwen, AWRP fused, a prefix hit).
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import qwen25_14b as jqwen  # noqa: E402
from repro.configs import yi_34b as jyi  # noqa: E402
from repro.configs.base import load_smoke_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import qwen25_14b, yi_34b  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

torch.set_num_threads(2)

PREFILL_TOL = 1e-4
DECODE_TOL = 2e-3
DECODE_STEPS = 8  # positions 16..23: two evicting page boundaries
SMALL = dict(dtype="float32", param_dtype="float32", bounded_kv_pages=3, page_size=4)
PROMPT = (np.arange(1, 17, dtype=np.int32)[None].repeat(2, 0) * np.array([[1], [9]])) % 500
ARCHS = {"qwen25_14b": (qwen25_14b, jqwen), "yi_34b": (yi_34b, jyi)}
BIASES = ("bq", "bk", "bv")


def _with_biases(np_params, seed):
    """The numpy tree with every q/k/v bias drawn nonzero (the reference's
    init leaves them zero)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, leaf in np_params.items():
        if isinstance(leaf, dict):
            out[name] = _with_biases(leaf, seed + 1)
        elif name in BIASES:
            out[name] = (rng.standard_normal(leaf.shape) * 0.5).astype(leaf.dtype)
        else:
            out[name] = leaf
    return out


@functools.lru_cache(maxsize=None)
def _models(arch):
    jcfg = dataclasses.replace(load_smoke_config(arch), **SMALL)
    tcfg = dataclasses.replace(ARCHS[arch][0].SMOKE_CONFIG, **SMALL)
    np_params = _with_biases(jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                                     jax.random.PRNGKey(6))), 0)
    jparams = jax.tree.map(jnp.asarray, np_params)
    tparams = params_from_jax(np_params, tcfg, device="cpu", dtype=torch.float32)
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module", params=sorted(ARCHS))
def models(request):
    return _models(request.param)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_config_and_bias_declarations_copy_reference(arch):
    mine, ref_mod = ARCHS[arch]
    for cfg, want in ((mine.CONFIG, ref_mod.CONFIG),
                      (mine.SMOKE_CONFIG, load_smoke_config(arch))):
        for f in dataclasses.fields(cfg):
            assert getattr(cfg, f.name) == getattr(want, f.name), f.name
        tu0, ju0 = TM.param_decls(cfg)["u0"], JM.param_decls(want)["u0"]
        assert {k: (d.shape, d.init) for k, d in tu0.items()} == \
            {k: (d.shape, d.init) for k, d in ju0.items()}
        assert (set(BIASES) <= set(tu0)) == cfg.qkv_bias
    G = {a: m.CONFIG.n_heads // m.CONFIG.n_kv_heads for a, (m, _) in ARCHS.items()}
    assert G == {"qwen25_14b": 5, "yi_34b": 7}
    params = TM.init_params(qwen25_14b.SMOKE_CONFIG, torch.Generator().manual_seed(0),
                            device="cpu")
    for b in BIASES:  # the param dtype, zeros at init
        assert params["u0"][b].dtype == torch.bfloat16 and not params["u0"][b].any()


@pytest.mark.parametrize("kv_mode", ["full", "paged"])
def test_prefill_logits_match_reference(models, kv_mode):
    jcfg, jparams, tcfg, tparams = models
    jl, _ = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(PROMPT)}, max_len=32,
                       kv_mode=kv_mode)
    tl, _ = TM.prefill(tparams, tcfg, torch.from_numpy(PROMPT), 32, kv_mode=kv_mode)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=PREFILL_TOL,
                               atol=PREFILL_TOL)
    if tcfg.qkv_bias:  # the biases are live: without them the logits move
        unbiased = {**tparams, "u0": {k: (torch.zeros_like(v) if k in BIASES else v)
                                      for k, v in tparams["u0"].items()}}
        tl0, _ = TM.prefill(unbiased, tcfg, torch.from_numpy(PROMPT), 32, kv_mode=kv_mode)
        assert float((tl0 - tl).abs().max()) > 100 * PREFILL_TOL


def _assert_blocks(tc, jc, where):
    assert tc["pos"] == int(jc["pos"]), where
    tb, jb = tc["blocks"]["u0"], jc["blocks"]["u0"]
    if isinstance(tb, dict):
        for kv in ("k", "v"):
            np.testing.assert_allclose(tb[kv].numpy(), np.asarray(jb[kv]),
                                       rtol=DECODE_TOL, atol=DECODE_TOL, err_msg=where)
        return
    for name in ("f", "r", "page_start", "clock", "open_slot"):
        assert np.array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name))), \
            f"{where}: plane {name}"
    np.testing.assert_allclose(tb.k.numpy(), np.asarray(jb.k), rtol=DECODE_TOL,
                               atol=DECODE_TOL, err_msg=where)


@pytest.mark.parametrize("kv_mode,fused", [("full", False), ("paged", False),
                                           ("paged", True)])
def test_decode_steps_match_reference(models, kv_mode, fused):
    jcfg, jparams, tcfg, tparams = models
    max_len = PROMPT.shape[1] + DECODE_STEPS
    jl, jc = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(PROMPT)}, max_len=max_len,
                        kv_mode=kv_mode)
    _, tc = TM.prefill(tparams, tcfg, torch.from_numpy(PROMPT), max_len, kv_mode=kv_mode)
    step = jax.jit(lambda p, tk, c: JM.decode_step(p, jcfg, tk, c, kv_mode=kv_mode,
                                                   fused=fused))
    tok = jnp.argmax(jl[:, -1:], -1).astype(jnp.int32)
    for i in range(DECODE_STEPS):
        jl, jc = step(jparams, tok, jc)
        tl, tc = TM.decode_step(tparams, tcfg, torch.from_numpy(np.array(tok)), tc,
                                kv_mode=kv_mode, fused=fused)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=DECODE_TOL,
                                   atol=DECODE_TOL, err_msg=f"step {i}")
        _assert_blocks(tc, jc, f"step {i}")
        tok = jnp.argmax(jl[:, -1:], -1).astype(jnp.int32)
    if kv_mode == "paged":  # every pool allocated past its 3 pages
        assert int((tc["blocks"]["u0"].page_start >= 0).sum(-1).min()) == 3


def test_prefill_then_one_step_equals_reference_forward(models):
    jcfg, jparams, tcfg, tparams = models
    full = np.asarray(JM.forward(jparams, jcfg, {"tokens": jnp.asarray(PROMPT)}))
    _, tc = TM.prefill(tparams, tcfg, torch.from_numpy(PROMPT[:, :-1]), 24)
    tl, tc = TM.decode_step(tparams, tcfg, torch.from_numpy(PROMPT[:, -1:]), tc)
    np.testing.assert_allclose(tl[:, 0].numpy(), full[:, -1], rtol=2e-4, atol=2e-4)


def test_engine_greedy_tokens_equal_reference_engine():
    jcfg, jparams, tcfg, tparams = _models("qwen25_14b")
    rng = np.random.RandomState(1)
    prompts = [rng.randint(1, 500, size=16).tolist() for _ in range(2)]
    jeng = JServeEngine(jcfg, jparams, max_len=64, kv_mode="paged", fused=True)
    teng = ServeEngine(tcfg, tparams, max_len=64, kv_mode="paged", fused=True,
                       device="cpu")
    got = {}
    for rid, batch in ((0, prompts), (5, prompts[:1]), (6, prompts[:1])):
        want = jeng.generate([JRequest(rid + i, list(p), max_new_tokens=10)
                              for i, p in enumerate(batch)])
        got.update(teng.generate([Request(rid + i, list(p), max_new_tokens=10)
                                  for i, p in enumerate(batch)]))
        for i in range(len(batch)):
            assert got[rid + i].tokens == want[rid + i].tokens, rid + i
            assert got[rid + i].prefill_cached == want[rid + i].prefill_cached
    assert got[6].prefill_cached and teng.stats["kv_evictions"] > 0
