"""smollm-360m SMOKE_CONFIG through the port against the JAX reference, on
the CPU in float32, with the reference's weights carried across by
``params_from_jax``.

* prefill logits: rtol = atol = PREFILL_TOL (f32 matmul summation order
  over three layers);
* ``decode_step`` in ``full``, ``paged`` unfused and ``paged`` fused modes,
  DECODE_STEPS steps from a 2-page prompt into a 3-page pool (so the pool
  fills and evicts): logits within 2e-3 (``tests/test_policy_attn.py``'s
  bound) and every int plane of the pool bitwise equal.  Both sides are fed
  the reference's greedy token, so a near-tie cannot fork the streams.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import load_smoke_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import smollm_360m  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

torch.set_num_threads(2)

PREFILL_TOL = 1e-4
DECODE_TOL = 2e-3
DECODE_STEPS = 40  # 16 prompt + 40 tokens: 32 steps past the 24-token pool
SMALL = dict(dtype="float32", param_dtype="float32", bounded_kv_pages=3, page_size=8)
PROMPT = np.arange(1, 17, dtype=np.int32)[None].repeat(2, 0) * np.array([[1], [3]])


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(load_smoke_config("smollm_360m"), **SMALL)
    tcfg = dataclasses.replace(smollm_360m.SMOKE_CONFIG, **SMALL)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    tparams = params_from_jax(np_params, tcfg, device="cpu", dtype=torch.float32)
    return jcfg, jparams, tcfg, tparams


def test_params_carry_across_with_reference_layout(models):
    jcfg, jparams, tcfg, tparams = models
    jleaves = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(jleaves) == sum(1 for _ in _walk(tparams))
    for path, leaf in jleaves:
        node = tparams
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape
        assert np.array_equal(node.numpy(), np.asarray(leaf))
    assert tparams["u0"]["ln1"].dtype == torch.float32
    assert tuple(tparams["u0"]["wq"].shape) == (tcfg.n_layers, tcfg.d_model, tcfg.qk_dim)


def _walk(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _walk(v)
        else:
            yield v


def test_init_params_declarations_match_reference(models):
    jcfg, jparams, tcfg, _ = models
    gen = torch.Generator().manual_seed(0)
    mine = TM.init_params(tcfg, gen, device="cpu")
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        node = mine
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path
        if "ln" in str(path[-1].key) or "norm" in str(path[-1].key):
            assert not node.any()  # zero-initialised scales


@pytest.mark.parametrize("kv_mode", ["full", "paged"])
def test_prefill_logits_match_reference(models, kv_mode):
    jcfg, jparams, tcfg, tparams = models
    jl, jc = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(PROMPT)}, max_len=64,
                        kv_mode=kv_mode)
    tl, tc = TM.prefill(tparams, tcfg, torch.from_numpy(PROMPT), 64, kv_mode=kv_mode)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=PREFILL_TOL,
                               atol=PREFILL_TOL)
    assert tc["pos"] == int(jc["pos"])
    if kv_mode == "paged":
        for name in ("f", "r", "page_start", "clock", "open_slot"):
            assert np.array_equal(getattr(tc["blocks"]["u0"], name).numpy(),
                                  np.asarray(getattr(jc["blocks"]["u0"], name))), name


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
    evicting_steps = 0
    for i in range(DECODE_STEPS):
        jl, jc = step(jparams, tok, jc)
        tl, tc = TM.decode_step(tparams, tcfg, torch.from_numpy(np.array(tok)), tc,
                                kv_mode=kv_mode, fused=fused)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=DECODE_TOL,
                                   atol=DECODE_TOL, err_msg=f"step {i}")
        assert tc["pos"] == int(jc["pos"])
        if kv_mode == "paged":
            jpool, tpool = jc["blocks"]["u0"], tc["blocks"]["u0"]
            for name in ("f", "r", "page_start", "clock", "open_slot"):
                a, b = getattr(tpool, name), np.asarray(getattr(jpool, name))
                assert a.dtype == torch.int32 and np.array_equal(a.numpy(), b), \
                    f"step {i}: plane {name} differs"
            np.testing.assert_allclose(tpool.k.numpy(), np.asarray(jpool.k),
                                       rtol=PREFILL_TOL, atol=PREFILL_TOL)
            pos = tc["pos"] - 1
            evicting_steps += pos % tcfg.page_size == 0 and \
                pos >= tcfg.bounded_kv_pages * tcfg.page_size
        tok = jnp.argmax(jl[:, -1:], -1).astype(jnp.int32)
    if kv_mode == "paged":
        assert evicting_steps >= 4  # allocations into the full 3-page pool
