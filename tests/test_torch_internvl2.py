"""internvl2-26b's VLM backbone through the port against the JAX reference:
its SMOKE_CONFIG on the CPU in float32 (3 layers, d 128, 4 / 2 heads of 32,
so G = 2; the published G = 6 is held at kernel level in
``test_torch_kernel_shapes.py``), the reference's weights carried across by
``params_from_jax``, patches and tokens drawn from a numpy seed, with a
3-page pool of 4-token pages:

* the configs and declarations copy the reference's; the published config
  is 19.86 B parameters at G = 6;
* the patch stub: ``patches`` (B, n_patch_tokens, d) replace the first
  ``n_patch_tokens`` embedded tokens, so the logits do not depend on those
  tokens, in the reference and in the port alike, and do depend on the
  patches;
* prefill logits within PREFILL_TOL (full and paged KV);
* DECODE_STEPS paged decode steps, fused (kernel 4's plain version) and
  unfused, within DECODE_TOL with every pool plane bitwise against the
  reference's, both sides fed the reference's greedy token;
* the engines: the port's greedy tokens equal the reference engine's
  (paged, fused, AWRP; a prefix hit, evictions), the graph loop equal to
  the host loop.
"""

import dataclasses
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import internvl2_26b as jinternvl  # noqa: E402
from repro.configs.base import load_smoke_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import internvl2_26b  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

torch.set_num_threads(2)

PREFILL_TOL = 1e-4
DECODE_TOL = 2e-3
DECODE_STEPS = 8  # positions 16..23: two evicting page boundaries
SMALL = dict(dtype="float32", param_dtype="float32", bounded_kv_pages=3, page_size=4)
B, S = 2, 16
PLANES = ("f", "r", "page_start", "clock", "open_slot")


@functools.lru_cache(maxsize=None)
def _models():
    jcfg = dataclasses.replace(load_smoke_config("internvl2_26b"), **SMALL)
    tcfg = dataclasses.replace(internvl2_26b.SMOKE_CONFIG, **SMALL)
    np_params = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(8)))
    jparams = jax.tree.map(jnp.asarray, np_params)
    tparams = params_from_jax(np_params, tcfg, device="cpu", dtype=torch.float32)
    return jcfg, jparams, tcfg, tparams


def _batch(seed):
    """Random tokens (B, S) and patches (B, n_patch_tokens, d), not zeros."""
    cfg = internvl2_26b.SMOKE_CONFIG
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    patches = (rng.standard_normal((B, cfg.n_patch_tokens, cfg.d_model)) * 0.5
               ).astype(np.float32)
    return tokens, patches


def _jax_prefill(jcfg, jparams, tokens, patches, max_len, kv_mode):
    return JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens),
                                      "patches": jnp.asarray(patches)},
                      max_len=max_len, kv_mode=kv_mode)


def _port_prefill(tcfg, tparams, tokens, patches, max_len, kv_mode):
    return TM.prefill(tparams, tcfg, torch.from_numpy(tokens), max_len, kv_mode=kv_mode,
                      patches=torch.from_numpy(patches))


def test_config_and_declarations_copy_reference():
    for cfg, want in ((internvl2_26b.CONFIG, jinternvl.CONFIG),
                      (internvl2_26b.SMOKE_CONFIG, load_smoke_config("internvl2_26b"))):
        for f in dataclasses.fields(cfg):
            assert getattr(cfg, f.name) == getattr(want, f.name), f.name
        tu0, ju0 = TM.param_decls(cfg)["u0"], JM.param_decls(want)["u0"]
        assert {k: (d.shape, d.init) for k, d in tu0.items()} == \
            {k: (d.shape, d.init) for k, d in ju0.items()}
    full = internvl2_26b.CONFIG
    assert full.n_heads // full.n_kv_heads == 6 and full.n_patch_tokens == 256
    n = sum(math.prod(d.shape) for d in _leaves(TM.param_decls(full)))
    assert abs(n / 1e9 - 19.86) < 5e-3


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def test_vlm_configs_that_stay_unsupported_are_refused():
    base = internvl2_26b.SMOKE_CONFIG
    for change in (dict(n_patch_tokens=0), dict(pattern=("moe",), n_repeats=3, n_experts=4,
                                                 top_k=2)):
        with pytest.raises(NotImplementedError, match="ported"):
            TM.param_decls(dataclasses.replace(base, **change))
    params = TM.init_params(base, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="patches"):
        TM.prefill(params, base, torch.zeros((1, 64), dtype=torch.int32), 64)


def test_patches_overwrite_the_first_positions():
    """Tokens under the patches do not reach the logits (both sides); the
    patches do."""
    jcfg, jparams, tcfg, tparams = _models()
    tokens, patches = _batch(1)
    other = tokens.copy()
    other[:, :tcfg.n_patch_tokens] = (other[:, :tcfg.n_patch_tokens] + 7) % tcfg.vocab
    jl = [np.asarray(_jax_prefill(jcfg, jparams, t, patches, 24, "full")[0])
          for t in (tokens, other)]
    tl = [_port_prefill(tcfg, tparams, t, patches, 24, "full")[0].numpy()
          for t in (tokens, other)]
    assert np.array_equal(jl[0], jl[1]) and np.array_equal(tl[0], tl[1])
    moved = _port_prefill(tcfg, tparams, tokens, patches + 0.25, 24, "full")[0].numpy()
    assert np.abs(moved - tl[0]).max() > 100 * PREFILL_TOL
    # and the later tokens still do
    later = tokens.copy()
    later[:, -1] = (later[:, -1] + 7) % tcfg.vocab
    tl2 = _port_prefill(tcfg, tparams, later, patches, 24, "full")[0].numpy()
    assert np.abs(tl2[:, -1] - tl[0][:, -1]).max() > 100 * PREFILL_TOL


@pytest.mark.parametrize("kv_mode", ["full", "paged"])
def test_prefill_logits_match_reference(kv_mode):
    jcfg, jparams, tcfg, tparams = _models()
    tokens, patches = _batch(2)
    jl, _ = _jax_prefill(jcfg, jparams, tokens, patches, 24, kv_mode)
    tl, _ = _port_prefill(tcfg, tparams, tokens, patches, 24, kv_mode)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=PREFILL_TOL,
                               atol=PREFILL_TOL)


@pytest.mark.parametrize("fused", [True, False])
def test_paged_decode_matches_reference_planes_bitwise(fused):
    jcfg, jparams, tcfg, tparams = _models()
    tokens, patches = _batch(3)
    max_len = S + DECODE_STEPS
    jl, jc = _jax_prefill(jcfg, jparams, tokens, patches, max_len, "paged")
    _, tc = _port_prefill(tcfg, tparams, tokens, patches, max_len, "paged")
    step = jax.jit(lambda p, tk, c: JM.decode_step(p, jcfg, tk, c, kv_mode="paged",
                                                   fused=fused))
    tok = jnp.argmax(jl[:, -1:], -1).astype(jnp.int32)
    for i in range(DECODE_STEPS):
        jl, jc = step(jparams, tok, jc)
        tl, tc = TM.decode_step(tparams, tcfg, torch.from_numpy(np.array(tok)), tc,
                                kv_mode="paged", fused=fused)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=DECODE_TOL,
                                   atol=DECODE_TOL, err_msg=f"step {i}")
        tb, jb = tc["blocks"]["u0"], jc["blocks"]["u0"]
        for name in PLANES:
            assert np.array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name))), \
                f"step {i}: plane {name}"
        assert int(tc["pos"]) == int(jc["pos"])
        tok = jnp.argmax(jl[:, -1:], -1).astype(jnp.int32)
    np.testing.assert_allclose(tb.k.numpy(), np.asarray(jb.k), rtol=DECODE_TOL,
                               atol=DECODE_TOL)
    # every pool allocated past its 3 pages
    assert int((tc["blocks"]["u0"].page_start >= 0).sum(-1).min()) == 3


def _traffic():
    rng = np.random.RandomState(5)
    a, b = (rng.randint(1, 500, size=S).tolist() for _ in range(2))
    return [[(0, a), (1, b)], [(10, a)], [(11, a)]]


def test_engine_tokens_equal_reference_engine():
    jcfg, jparams, tcfg, tparams = _models()
    jeng = JServeEngine(jcfg, jparams, max_len=64, kv_mode="paged", fused=True)
    engines = {jit: ServeEngine(tcfg, tparams, max_len=64, kv_mode="paged", fused=True,
                                jit_loop=jit, device="cpu") for jit in (True, False)}
    for run in _traffic():
        want = jeng.generate([JRequest(i, list(p), max_new_tokens=10) for i, p in run])
        for eng in engines.values():
            got = eng.generate([Request(i, list(p), max_new_tokens=10) for i, p in run])
            for i, _ in run:
                assert got[i].tokens == want[i].tokens, i
                assert got[i].prefill_cached == want[i].prefill_cached, i
    for eng in engines.values():
        assert eng.stats["kv_evictions"] > 0 and eng.prefix_cache.hits == 1
        assert eng.stats["prefills"] == 2
    timing = ("prefill_s", "decode_s", "loop_captures")
    assert {k: v for k, v in engines[True].stats.items() if k not in timing} == \
        {k: v for k, v in engines[False].stats.items() if k not in timing}
    # the engine's zero patches, as the reference engine's
    prompt = _traffic()[0][0][1]
    tl, _ = engines[True]._prefill([prompt])
    jl, _ = _jax_prefill(jcfg, jparams, np.asarray([prompt], np.int32),
                         np.zeros((1, tcfg.n_patch_tokens, tcfg.d_model), np.float32),
                         64, "paged")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl)[:, -1:], rtol=PREFILL_TOL,
                               atol=PREFILL_TOL)
