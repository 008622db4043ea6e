"""whisper-large-v3's encoder-decoder through the port against the JAX
reference: its SMOKE_CONFIG on the CPU in float32 (2 + 2 layers, d 128,
4 heads of 32), the reference's weights carried across by
``params_from_jax``, frames and tokens drawn from a numpy seed:

* the configs and declarations copy the reference's (``enc`` / ``dec``
  stacks, a decoder block's ``self_*`` / ``cross_*`` sets and three norms,
  ``enc_final_norm``; ``ln3`` and ``enc_final_norm`` in f32);
* ``sinusoidal_positions`` within SINUSOID_TOL over the smoke decoder's
  positions (the reference's f32 ``exp`` is one ulp off torch's at 5 of the
  64 frequencies, so the difference grows with the position);
* ``layers.attention`` non-causal without RoPE, and with ``kv_override``
  (cross-attention, Skv != S), within LAYER_RTOL / LAYER_ATOL;
* ``prefill`` logits within PREFILL_TOL, its ``k``, ``v``, ``ck``, ``cv``
  and ``pos`` against the reference's; ``kv_mode="paged"`` gives the same
  tree as ``"full"`` (the reference keeps full caches for enc-dec too);
  prefill(S - 1) plus one decode step equals the reference's ``forward`` at
  S - 1 (its own parity test); DECODE_STEPS decode steps within
  DECODE_TOL, the cross K/V never written;
* ``params_from_jax`` refuses a missing, extra or misshapen leaf;
* the engines: ``jit_loop=True`` and ``False`` give the same tokens, stats
  and final caches; the port's greedy tokens equal the reference engine's;
  a repeated prompt hits the prefix cache and skips its prefill.  At this
  size the sinusoid outweighs the token embedding and the greedy tokens
  hardly depend on the prompt, so the engine's logits and caches are also
  held to the reference's at the float tolerances.
"""

import dataclasses
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import whisper_large_v3 as jwhisper  # noqa: E402
from repro.configs.base import load_smoke_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import whisper_large_v3  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

torch.set_num_threads(2)

SINUSOID_TOL = 1e-6
LAYER_RTOL, LAYER_ATOL = 1e-5, 1e-6
PREFILL_TOL = 1e-4
DECODE_TOL = 2e-3
DECODE_STEPS = 40
F32 = dict(dtype="float32", param_dtype="float32")
B, S = 2, 40  # decoder tokens; the encoder sees S // enc_seq_divisor frames


def _settle_torch_exp():
    """One einsum and exp first: on this torch (CPU, two intra-op threads)
    the first ``torch.exp`` after a process's first ``einsum`` is sometimes
    one thread's half ~1e-4 off (``test_torch_flash.py``)."""
    rng = np.random.default_rng(0)
    q, k = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((1, 128, 2, 2, 32), (1, 128, 2, 32)))
    torch.exp(torch.einsum("bqkgh,bckh->bkgqc", q, k))


@functools.lru_cache(maxsize=None)
def _models():
    _settle_torch_exp()
    jcfg = dataclasses.replace(load_smoke_config("whisper_large_v3"), **F32)
    tcfg = dataclasses.replace(whisper_large_v3.SMOKE_CONFIG, **F32)
    np_params = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(4)))
    jparams = jax.tree.map(jnp.asarray, np_params)
    tparams = params_from_jax(np_params, tcfg, device="cpu", dtype=torch.float32)
    return jcfg, jparams, tcfg, tparams, np_params


def _batch(seed, S=S, frames_len=None):
    """Random tokens (B, S) and frames (B, Se, d), not zeros."""
    cfg = whisper_large_v3.SMOKE_CONFIG
    rng = np.random.default_rng(seed)
    Se = S // cfg.enc_seq_divisor if frames_len is None else frames_len
    tokens = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    frames = (rng.standard_normal((B, Se, cfg.d_model)) * 0.5).astype(np.float32)
    return tokens, frames


def _jax_prefill(jcfg, jparams, tokens, frames, max_len, kv_mode="full"):
    return JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens),
                                      "frames": jnp.asarray(frames)},
                      max_len=max_len, kv_mode=kv_mode)


def _port_prefill(tcfg, tparams, tokens, frames, max_len, kv_mode="full"):
    return TM.prefill(tparams, tcfg, torch.from_numpy(tokens), max_len, kv_mode=kv_mode,
                      frames=torch.from_numpy(frames))


def _assert_dec_caches(tc, jc, tol, where):
    assert int(tc["pos"]) == int(jc["pos"]), where
    assert tc["pos"].dtype == torch.int32 and tc["pos"].dim() == 0
    assert set(tc["blocks"]) == set(jc["blocks"]) == {"dec"}, where
    tb, jb = tc["blocks"]["dec"], jc["blocks"]["dec"]
    assert set(tb) == set(jb) == {"k", "v", "ck", "cv"}, where
    for name in ("k", "v", "ck", "cv"):
        assert tuple(tb[name].shape) == np.asarray(jb[name]).shape, (where, name)
        np.testing.assert_allclose(tb[name].numpy(), np.asarray(jb[name]), rtol=tol,
                                   atol=tol, err_msg=f"{where}: {name}")


# -- configs and declarations -------------------------------------------------


def test_config_and_declarations_copy_reference():
    for cfg, want in ((whisper_large_v3.CONFIG, jwhisper.CONFIG),
                      (whisper_large_v3.SMOKE_CONFIG, load_smoke_config("whisper_large_v3"))):
        for f in dataclasses.fields(cfg):
            assert getattr(cfg, f.name) == getattr(want, f.name), f.name
        tdecl, jdecl = TM.param_decls(cfg), JM.param_decls(want)
        assert set(tdecl) == set(jdecl) == {"embed", "final_norm", "unembed", "enc", "dec",
                                            "enc_final_norm"}
        for pos in ("enc", "dec"):
            assert {k: (d.shape, d.init) for k, d in tdecl[pos].items()} == \
                {k: (d.shape, d.init) for k, d in jdecl[pos].items()}, pos
        assert {"self_wq", "cross_wk", "ln3", "w_up", "w_down"} <= set(tdecl["dec"])
    cfg = whisper_large_v3.SMOKE_CONFIG
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert params["dec"]["ln3"].dtype == torch.float32
    assert params["enc_final_norm"].dtype == torch.float32
    assert params["dec"]["self_wq"].dtype == torch.bfloat16
    assert TM.param_bytes(cfg) == sum(t.numel() * t.element_size()
                                      for t in _leaves(params))
    # the published config: 1.601 B parameters, as the reference counts them
    assert abs(sum(math.prod(d.shape) for d in _leaves(TM.param_decls(jwhisper.CONFIG)))
               / 1e9 - 1.601) < 1e-3


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


# -- layers -------------------------------------------------------------------


def test_sinusoidal_positions_match_reference():
    d = whisper_large_v3.SMOKE_CONFIG.d_model
    rng = np.random.default_rng(1)
    for pos in (np.arange(64, dtype=np.int32)[None],
                rng.integers(0, 64, size=(3, 17)).astype(np.int32)):
        want = np.asarray(JL.sinusoidal_positions(jnp.asarray(pos), d))
        got = TL.sinusoidal_positions(torch.from_numpy(pos), d)
        assert got.dtype == torch.float32 and tuple(got.shape) == pos.shape + (d,)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SINUSOID_TOL)


@pytest.mark.parametrize("cross", [False, True])
def test_attention_non_causal_and_cross_match_reference(cross):
    """The encoder's attention (non-causal, no RoPE) and the decoder's
    cross-attention (``kv_override``: K/V of the encoder's 24 rows for 40
    queries), through ``ops.flash_attention``'s plain version."""
    jcfg, jparams, tcfg, tparams, _ = _models()
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    if cross:
        jp = {k[6:]: v[1] for k, v in jparams["dec"].items() if k.startswith("cross_")}
        tp = {k[6:]: v[1] for k, v in tparams["dec"].items() if k.startswith("cross_")}
        enc = rng.standard_normal((B, 24, tcfg.d_model)).astype(np.float32)
        ek, ev = (enc @ np.asarray(jp[w]) for w in ("wk", "wv"))
        shape = (B, 24, tcfg.n_kv_heads, tcfg.head_dim)
        jkw = {"kv_override": (jnp.asarray(ek.reshape(shape)), jnp.asarray(ev.reshape(shape)))}
        tkw = {"kv_override": (torch.from_numpy(ek.reshape(shape)),
                               torch.from_numpy(ev.reshape(shape)))}
    else:
        jp = {k: v[0] for k, v in jparams["enc"].items()}
        tp = {k: v[0] for k, v in tparams["enc"].items()}
        jkw, tkw = {}, {}
    want, (jk, jv) = JL.attention(jp, jnp.asarray(x), jcfg, positions=jnp.arange(S),
                                  causal=False, use_rope=False, **jkw)
    before = dict(ops.LAUNCHES)
    got, (tk, tv) = TL.attention(tp, torch.from_numpy(x), tcfg, causal=False,
                                 use_rope=False, **tkw)
    assert ops.LAUNCHES == before  # CPU tensors: the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LAYER_RTOL,
                               atol=LAYER_ATOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=LAYER_RTOL, atol=LAYER_ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=LAYER_RTOL, atol=LAYER_ATOL)
    # causal over the same keys is another function
    if not cross:
        causal, _ = TL.attention(tp, torch.from_numpy(x), tcfg, causal=True, use_rope=False)
        assert float((causal - got).abs().max()) > 100 * LAYER_ATOL


# -- the model ------------------------------------------------------------------


@pytest.mark.parametrize("kv_mode", ["full", "paged"])
def test_prefill_logits_and_caches_match_reference(kv_mode):
    jcfg, jparams, tcfg, tparams, _ = _models()
    tokens, frames = _batch(3)
    max_len = S + 8
    jl, jc = _jax_prefill(jcfg, jparams, tokens, frames, max_len, kv_mode)
    tl, tc = _port_prefill(tcfg, tparams, tokens, frames, max_len, kv_mode)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (B, S, TM.pad_vocab(tcfg))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=PREFILL_TOL,
                               atol=PREFILL_TOL)
    _assert_dec_caches(tc, jc, PREFILL_TOL, f"prefill {kv_mode}")
    assert not tc["blocks"]["dec"]["k"][:, :, S:].any()  # zero-padded to max_len
    # the frames are live: other frames move the logits
    tl2, _ = _port_prefill(tcfg, tparams, tokens, frames * 0.0, max_len, kv_mode)
    assert float((tl2 - tl).abs().max()) > 100 * PREFILL_TOL


def test_paged_kv_mode_keeps_the_full_tree():
    """The reference ignores ``kv_mode`` for enc-dec (full caches in both);
    so does the port: prefill and ``decode_caches`` give the same tree."""
    _, _, tcfg, tparams, _ = _models()
    tokens, frames = _batch(4)
    trees = [_port_prefill(tcfg, tparams, tokens, frames, S + 8, m)[1]
             for m in ("full", "paged")]
    for name in ("k", "v", "ck", "cv"):
        assert torch.equal(trees[0]["blocks"]["dec"][name], trees[1]["blocks"]["dec"][name])
    empty = [TM.decode_caches(tcfg, B, S + 8, kv_mode=m, device="cpu") for m in ("full", "paged")]
    jempty = JM.decode_caches(load_smoke_config("whisper_large_v3"), B, S + 8, kv_mode="paged")
    for name in ("k", "v", "ck", "cv"):
        rows = S + 8 if name in ("k", "v") else tcfg.cross_kv_len
        shape = (tcfg.dec_layers, B, rows, tcfg.kv_dim)
        assert tuple(empty[0]["blocks"]["dec"][name].shape) == shape
        assert tuple(empty[1]["blocks"]["dec"][name].shape) == shape
        assert np.asarray(jempty["blocks"]["dec"][name]).shape == shape


def test_prefill_then_one_step_equals_reference_forward():
    jcfg, jparams, tcfg, tparams, _ = _models()
    tokens, frames = _batch(5, S=32)
    full = np.asarray(JM.forward(jparams, jcfg, {"tokens": jnp.asarray(tokens),
                                                 "frames": jnp.asarray(frames)}))
    # frames unchanged: the encoder's context is the whole clip's
    _, tc = TM.prefill(tparams, tcfg, torch.from_numpy(tokens[:, :-1]), 40,
                       frames=torch.from_numpy(frames))
    tl, tc = TM.decode_step(tparams, tcfg, torch.from_numpy(tokens[:, -1:]), tc)
    np.testing.assert_allclose(tl[:, 0].numpy(), full[:, -1], rtol=2e-4, atol=2e-4)
    assert int(tc["pos"]) == 32


def test_decode_steps_match_reference():
    jcfg, jparams, tcfg, tparams, _ = _models()
    tokens, frames = _batch(6)
    max_len = S + DECODE_STEPS
    jl, jc = _jax_prefill(jcfg, jparams, tokens, frames, max_len)
    _, tc = _port_prefill(tcfg, tparams, tokens, frames, max_len)
    cross = [tc["blocks"]["dec"][n].clone() for n in ("ck", "cv")]
    step = jax.jit(lambda p, tk, c: JM.decode_step(p, jcfg, tk, c))
    tok = jnp.argmax(jl[:, -1:], -1).astype(jnp.int32)
    for i in range(DECODE_STEPS):
        jl, jc = step(jparams, tok, jc)
        tl, tc = TM.decode_step(tparams, tcfg, torch.from_numpy(np.array(tok)), tc,
                                kv_mode="paged", fused=True)  # both ignored
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=DECODE_TOL,
                                   atol=DECODE_TOL, err_msg=f"step {i}")
        tok = jnp.argmax(jl[:, -1:], -1).astype(jnp.int32)
    _assert_dec_caches(tc, jc, DECODE_TOL, "after decode")
    assert int(tc["pos"]) == S + DECODE_STEPS
    # the cross K/V are read, never written
    assert torch.equal(tc["blocks"]["dec"]["ck"], cross[0])
    assert torch.equal(tc["blocks"]["dec"]["cv"], cross[1])


@pytest.mark.parametrize("change", ["missing", "extra", "shape"])
def test_params_from_jax_refuses_bad_trees(change):
    _, _, tcfg, _, np_params = _models()
    tree = {k: (dict(v) if isinstance(v, dict) else v) for k, v in np_params.items()}
    if change == "missing":
        del tree["dec"]["ln3"]
    elif change == "extra":
        tree["enc"]["ln3"] = tree["dec"]["ln3"]
    else:
        tree["enc_final_norm"] = np.zeros((3,), np.float32)
    with pytest.raises(ValueError):
        params_from_jax(tree, tcfg, device="cpu", dtype=torch.float32)


def test_encdec_configs_that_stay_unsupported_are_refused():
    base = whisper_large_v3.SMOKE_CONFIG
    TM.param_decls(base)
    for change in (dict(enc_layers=0), dict(dec_layers=0), dict(n_experts=4, top_k=2),
                   dict(pattern=("attn",), n_repeats=2), dict(act="relu")):
        with pytest.raises(NotImplementedError, match="ported"):
            TM.param_decls(dataclasses.replace(base, **change))
    with pytest.raises(ValueError, match="frames"):
        TM.prefill(TM.init_params(base, torch.Generator().manual_seed(0), device="cpu"),
                   base, torch.zeros((1, 64), dtype=torch.int32), 64)


# -- the engines ----------------------------------------------------------------


def _prompts():
    rng = np.random.RandomState(3)
    return [rng.randint(1, 500, size=64).tolist() for _ in range(3)]


def _traffic():
    """A batch of two, then one prompt alone twice (the second a prefix
    hit)."""
    a, b, _ = _prompts()
    return [[(0, a), (1, b)], [(10, a)], [(11, a)]]


def _spy_final_caches(eng):
    seen = []
    for name in ("_graph_loop", "_host_loop"):
        orig = getattr(eng, name)

        def wrapped(*args, _orig=orig, **kw):
            out = _orig(*args, **kw)
            seen.append(TM.clone_caches(out[1]))
            return out

        setattr(eng, name, wrapped)
    return seen


def test_engine_graph_loop_equals_host_loop():
    _, _, tcfg, tparams, _ = _models()
    runs = {}
    for jit in (True, False):
        eng = ServeEngine(tcfg, tparams, max_len=96, kv_mode="full", device="cpu",
                          jit_loop=jit)
        seen = _spy_final_caches(eng)
        out = []
        for run in _traffic():
            res = eng.generate([Request(i, list(p), max_new_tokens=12) for i, p in run])
            out.append([(res[i].tokens, res[i].prefill_cached) for i, _ in run])
        runs[jit] = (eng, seen, out)
    (ej, seen_j, out_j), (eh, seen_h, out_h) = runs[True], runs[False]
    assert out_j == out_h
    timing = ("prefill_s", "decode_s", "loop_captures")
    assert {k: v for k, v in ej.stats.items() if k not in timing} == \
        {k: v for k, v in eh.stats.items() if k not in timing}
    assert ej.stats["loop_captures"] == 2 and ej.stats["prefills"] == 2
    assert out_j[2][0][1] and out_j[2][0][0] == out_j[1][0][0]  # the hit repeats
    assert len(seen_j) == len(seen_h) == 3
    for a, b in zip(seen_j, seen_h):
        assert torch.equal(a["pos"], b["pos"])
        for name in ("k", "v", "ck", "cv"):
            assert torch.equal(a["blocks"]["dec"][name], b["blocks"]["dec"][name]), name


@pytest.mark.parametrize("jit_loop", [True, False])
def test_engine_serves_two_prompt_lengths_at_one_batch_size(jit_loop):
    """Two length buckets of the same batch size, in one call and across
    calls: the cross K/V's rows follow the prompt's length, so each length
    gets a decode graph of its own, and the tokens are the reference
    engine's."""
    jcfg, jparams, tcfg, tparams, _ = _models()
    rng = np.random.RandomState(5)
    longs = [rng.randint(1, 500, size=128).tolist() for _ in range(2)]
    shorts = [p[-64:] for p in longs]
    traffic = [[(0, longs[0]), (1, longs[1]), (2, shorts[0]), (3, shorts[1])],
               [(4, longs[1]), (5, longs[0])],
               [(6, shorts[1]), (7, shorts[0])]]
    jeng = JServeEngine(jcfg, jparams, max_len=160, kv_mode="full")
    teng = ServeEngine(tcfg, tparams, max_len=160, kv_mode="full", device="cpu",
                       jit_loop=jit_loop)
    for run in traffic:
        want = jeng.generate([JRequest(i, list(p), max_new_tokens=8) for i, p in run])
        got = teng.generate([Request(i, list(p), max_new_tokens=8) for i, p in run])
        for i, _ in run:
            assert got[i].tokens == want[i].tokens, i
            assert got[i].prefill_cached == want[i].prefill_cached, i
    assert teng.stats["loop_captures"] == (2 if jit_loop else 0)


@pytest.mark.parametrize("kv_mode", ["full", "paged"])
def test_engine_tokens_equal_reference_engine(kv_mode):
    jcfg, jparams, tcfg, tparams, _ = _models()
    jeng = JServeEngine(jcfg, jparams, max_len=96, kv_mode=kv_mode,
                        fused=kv_mode == "paged")
    teng = ServeEngine(tcfg, tparams, max_len=96, kv_mode=kv_mode,
                       fused=kv_mode == "paged", device="cpu")
    got = {}
    for run in _traffic():
        want = jeng.generate([JRequest(i, list(p), max_new_tokens=12) for i, p in run])
        got.update(teng.generate([Request(i, list(p), max_new_tokens=12) for i, p in run]))
        for i, _ in run:
            assert got[i].tokens == want[i].tokens, i
            assert got[i].prefill_cached == want[i].prefill_cached, i
    assert got[11].prefill_cached and teng.stats["prefills"] == jeng.stats["prefills"] == 2
    assert teng.stats["kv_evictions"] == 0
    # the engine's prefill (zero frames of half the prompt's length): its
    # last logits and caches against the reference's, at the float tolerance
    a, b, _ = _prompts()
    tokens = np.asarray([a, b], np.int32)
    zeros = np.zeros((2, 32, tcfg.d_model), np.float32)
    jl, jc = _jax_prefill(jcfg, jparams, tokens, zeros, 96, kv_mode)
    tl, tc = teng._prefill([a, b])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl)[:, -1:], rtol=PREFILL_TOL,
                               atol=PREFILL_TOL)
    _assert_dec_caches(tc, jc, PREFILL_TOL, "engine prefill")
