"""The MoE family through the port against the JAX reference on the CPU, in
float32: phi3.5-moe's (SwiGLU experts) and grok-1's (GELU experts)
SMOKE_CONFIG with a 3-page pool of 4-token pages, the reference's weights
carried across by ``params_from_jax``.

* configs: the port's copies equal the reference's field by field;
* declarations and ``params_from_jax``: the reference's ``_moe_decls``
  (``w_router``, stacked ``w_up`` / ``w_gate`` / ``w_down``) carry across
  unchanged; ``init_params`` draws matrix by matrix (no f32 copy of a whole
  stacked expert leaf);
* prefill logits within PREFILL_TOL (full and paged KV), DECODE_STEPS decode
  steps within DECODE_TOL (full KV, paged fused AWRP, paged fused
  ``arc_adaptive``) with every pool and ARC/CAR plane bitwise equal; both
  sides are fed the reference's greedy token.  The 16-token prompt routes
  32 pairs into 4 experts of capacity 8, so prefill drops pairs;
* the engines: equal greedy tokens (phi3.5 AWRP fused, grok-1
  ``arc_adaptive`` with equal ghost hits);
* the CLI: phi3.5's smoke config served on the CPU; grok-1's full config
  refused;
* ``cuda``-marked: kernels 4, 5 and 6 at phi3.5's GQA group (G = 4, hd =
  128) against their plain versions, skipped without a card.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import grok1_314b as jgrok  # noqa: E402
from repro.configs import phi35_moe as jphi  # noqa: E402
from repro.configs.base import load_smoke_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.cache import paged_kv  # noqa: E402
from repro_torch.configs import grok1_314b, phi35_moe  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

torch.set_num_threads(2)

PREFILL_TOL = 1e-4
DECODE_TOL = 2e-3
DECODE_STEPS = 8  # positions 16..23: two evicting page boundaries
SMALL = dict(dtype="float32", param_dtype="float32", bounded_kv_pages=3, page_size=4)
PROMPT = (np.arange(1, 17, dtype=np.int32)[None].repeat(2, 0) * np.array([[1], [7]])) % 500
ARCHS = {"phi35_moe": (phi35_moe, jphi), "grok1_314b": (grok1_314b, jgrok)}


@pytest.fixture(scope="module", params=sorted(ARCHS))
def models(request):
    arch = request.param
    jcfg = dataclasses.replace(load_smoke_config(arch), **SMALL)
    tcfg = dataclasses.replace(ARCHS[arch][0].SMOKE_CONFIG, **SMALL)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(2))
    np_params = jax.tree.map(np.asarray, jparams)
    tparams = params_from_jax(np_params, tcfg, device="cpu", dtype=torch.float32)
    return jcfg, jparams, tcfg, tparams


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_configs_copy_reference(arch):
    mine, ref_mod = ARCHS[arch]
    for cfg, want in ((mine.CONFIG, ref_mod.CONFIG),
                      (mine.SMOKE_CONFIG, load_smoke_config(arch))):
        for f in dataclasses.fields(cfg):
            assert getattr(cfg, f.name) == getattr(want, f.name), f.name
        assert cfg.layer_pattern == want.layer_pattern
        assert set(cfg.layer_pattern) == {"moe"}


def _decl_shapes(tree):
    return {k: (_decl_shapes(v) if isinstance(v, dict) else tuple(v.shape))
            for k, v in tree.items()}


def test_moe_leaves_carry_across_with_reference_layout(models):
    jcfg, jparams, tcfg, tparams = models
    assert _decl_shapes(TM.param_decls(tcfg)) == _decl_shapes(JM.param_decls(jcfg))
    assert TM.scan_plan(tcfg) == ([("u0", "moe")], tcfg.n_layers, [])
    E, d, ff = tcfg.n_experts, tcfg.d_model, tcfg.d_ff
    assert tuple(tparams["u0"]["w_up"].shape) == (tcfg.n_layers, E, d, ff)
    assert tuple(tparams["u0"]["w_router"].shape) == (tcfg.n_layers, d, E)
    assert ("w_gate" in tparams["u0"]) == (tcfg.act == "swiglu")
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        node = tparams
        for key in path:
            node = node[key.key]
        assert np.array_equal(node.numpy(), np.asarray(leaf)), path


def test_init_params_draws_matrix_by_matrix(models, monkeypatch):
    """No f32 draw is larger than one (d, ff) matrix, the leaves come out
    in the parameter dtype with the reference's shapes, and the scale is
    min(0.02, 1/sqrt(fan_in))."""
    _, _, tcfg, _ = models
    cfg = dataclasses.replace(tcfg, param_dtype="bfloat16")
    drawn = []
    randn = torch.randn

    def spy(*args, **kw):
        out = randn(*args, **kw)
        drawn.append(out.numel())
        return out

    monkeypatch.setattr(torch, "randn", spy)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    monkeypatch.undo()
    V = TM.pad_vocab(cfg)
    assert max(drawn) == V * cfg.d_model  # the embedding, a plain matrix
    experts = cfg.n_layers * cfg.n_experts
    assert drawn.count(cfg.d_model * cfg.d_ff) >= 2 * experts
    w_up = params["u0"]["w_up"]
    assert w_up.dtype == torch.bfloat16 and params["u0"]["ln1"].dtype == torch.float32
    assert _decl_shapes(params) == _decl_shapes(TM.param_decls(cfg))
    want = min(0.02, 1 / np.sqrt(cfg.d_model))
    assert abs(float(w_up.float().std()) - want) < 0.05 * want
    assert TM.param_bytes(cfg) == sum(t.numel() * t.element_size() for t in _leaves(params))


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def test_moe_config_checks():
    base = phi35_moe.SMOKE_CONFIG
    TM.param_decls(base)
    for change in (dict(family="dense"), dict(top_k=3), dict(top_k=0),
                   # the enc-dec family with experts (its blocks are dense)
                   dict(family="encdec", enc_layers=2, dec_layers=2),
                   dict(pattern=("moe", "mamba"), n_repeats=1)):
        with pytest.raises(NotImplementedError, match="ported"):
            TM.param_decls(dataclasses.replace(base, **change))


def _assert_blocks_equal(tc, jc, where):
    assert tc["pos"] == int(jc["pos"]), where
    tb, jb = tc["blocks"]["u0"], jc["blocks"]["u0"]
    if isinstance(tb, dict):
        for kv in ("k", "v"):
            np.testing.assert_allclose(tb[kv].numpy(), np.asarray(jb[kv]),
                                       rtol=PREFILL_TOL, atol=PREFILL_TOL, err_msg=where)
        return
    parts = [(tb, jb)]
    if isinstance(tb, paged_kv.AdaptivePagedPool):
        parts = [(tb.pool, jb.pool), (tb.policy, jb.policy)]
    for t_part, j_part in parts:
        for name, a in zip(t_part._fields, t_part):
            if name in ("k", "v"):
                continue
            assert np.array_equal(a.numpy(), np.asarray(getattr(j_part, name))), \
                f"{where}: plane {name}"
    pool = parts[0][0]
    np.testing.assert_allclose(pool.k.numpy(), np.asarray(parts[0][1].k), rtol=PREFILL_TOL,
                               atol=PREFILL_TOL, err_msg=where)


@pytest.mark.parametrize("kv_mode", ["full", "paged"])
def test_prefill_logits_match_reference(models, kv_mode, monkeypatch):
    jcfg, jparams, tcfg, tparams = models
    jl, jc = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(PROMPT)}, max_len=32,
                        kv_mode=kv_mode)
    dropped, route = [], TL.route

    def spy(*args):
        r = route(*args)
        dropped.append(int((~r.keep).sum()))
        return r

    monkeypatch.setattr(TL, "route", spy)
    tl, tc = TM.prefill(tparams, tcfg, torch.from_numpy(PROMPT), 32, kv_mode=kv_mode)
    assert len(dropped) == tcfg.n_layers and sum(dropped) > 0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=PREFILL_TOL,
                               atol=PREFILL_TOL)
    _assert_blocks_equal(tc, jc, "prefill")


@pytest.mark.parametrize("kv_mode,kv_policy", [("full", "awrp"), ("paged", "awrp"),
                                               ("paged", "arc_adaptive")])
def test_decode_steps_match_reference(models, kv_mode, kv_policy):
    jcfg, jparams, tcfg, tparams = models
    jcfg = dataclasses.replace(jcfg, kv_policy=kv_policy)
    tcfg = dataclasses.replace(tcfg, kv_policy=kv_policy)
    fused = kv_mode == "paged"
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
        _assert_blocks_equal(tc, jc, f"step {i}")
        tok = jnp.argmax(jl[:, -1:], -1).astype(jnp.int32)
    if kv_mode == "paged":  # every pool allocated past its 3 pages
        pool = tc["blocks"]["u0"]
        pool = pool.pool if isinstance(pool, paged_kv.AdaptivePagedPool) else pool
        assert int((pool.page_start >= 0).sum(-1).min()) == tcfg.bounded_kv_pages


def _prompts(seed, n, length=16, vocab=500):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, size=length).tolist() for _ in range(n)]


def test_engine_greedy_tokens_equal_reference_engine(models):
    """AWRP, fused, a batch of two, then one prompt again (a prefix hit);
    then arc_adaptive: a single request, its follow-up turn (ghost hits) and
    the same again."""
    jcfg, jparams, tcfg, tparams = models
    prompts = _prompts(0, 2)
    jeng = JServeEngine(jcfg, jparams, max_len=64, kv_mode="paged", fused=True)
    teng = ServeEngine(tcfg, tparams, max_len=64, kv_mode="paged", fused=True,
                       device="cpu")
    for rid, batch in ((0, prompts), (5, prompts[:1]), (6, prompts[:1])):
        want = jeng.generate([JRequest(rid + i, list(p), max_new_tokens=10)
                              for i, p in enumerate(batch)])
        got = teng.generate([Request(rid + i, list(p), max_new_tokens=10)
                             for i, p in enumerate(batch)])
        for i in range(len(batch)):
            assert got[rid + i].tokens == want[rid + i].tokens, rid + i
            assert got[rid + i].prefill_cached == want[rid + i].prefill_cached
    assert teng.prefix_cache.hits == 1 and teng.stats["kv_evictions"] > 0

    jcfg = dataclasses.replace(jcfg, kv_policy="arc_adaptive")
    tcfg = dataclasses.replace(tcfg, kv_policy="arc_adaptive")
    jeng = JServeEngine(jcfg, jparams, max_len=64, kv_mode="paged", jit_loop=False)
    teng = ServeEngine(tcfg, tparams, max_len=64, kv_mode="paged", fused=True,
                       device="cpu")
    a = _prompts(3, 1, length=12)[0]
    first = teng.generate([Request(0, list(a), max_new_tokens=12)])[0]
    want = jeng.generate([JRequest(0, list(a), max_new_tokens=12)])[0]
    assert first.tokens == want.tokens
    for rid, prompt in ((1, a + first.tokens), (2, a + first.tokens)):
        want = jeng.generate([JRequest(rid, list(prompt), max_new_tokens=12)])[rid]
        got = teng.generate([Request(rid, list(prompt), max_new_tokens=12)])[rid]
        assert got.tokens == want.tokens and got.prefill_cached == want.prefill_cached
        assert teng.stats["kv_ghost_hits"] == jeng.stats["kv_ghost_hits"], rid
    assert teng.stats["kv_ghost_hits"] > 0


def test_launch_serve_phi35_smoke_runs_on_cpu(capsys):
    results = serve_cli.main(["--arch", "phi35_moe", "--smoke", "--device", "cpu",
                              "--dtype", "float32", "--requests", "3", "--new-tokens", "6",
                              "--prompt-len", "64", "--kv-mode", "paged", "--fused",
                              "--kv-pages", "2", "--repeat-prompts"])
    out = capsys.readouterr().out
    assert len(results) == 3 and all(len(r.tokens) == 6 for r in results.values())
    assert results[2].prefill_cached
    assert "arch=phi3.5-moe-42b-a6.6b" in out and "kv evictions=" in out


def test_launch_serve_refuses_grok1_full_config(capsys):
    with pytest.raises(SystemExit) as exc:
        serve_cli.main(["--arch", "grok1_314b", "--device", "cpu"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "grok-1-314b" in err and "--smoke" in err


# -- on the card: kernels 4, 5, 6 at phi3.5's GQA group ----------------------

PHI_DECODE = (2, 4, 16, 8, 4, 128)  # B, P, page, KVH, G, hd


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _decode_pool(dev, seed):
    B, P, page, KVH, G, hd = PHI_DECODE
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, s=1.0):
        return (torch.randn(*shape, generator=g) * s).to(torch.bfloat16).to(dev)

    q, k, v = rnd(B, KVH, G, hd), rnd(B, P, page, KVH, hd, s=0.5), rnd(B, P, page, KVH, hd, s=0.5)
    ps = torch.stack([torch.randperm(P, generator=g) * page for _ in range(B)])
    return q, k, v, ps.to(torch.int32).to(dev), rnd(B, KVH, hd, s=0.3)


@pytest.mark.cuda
def test_cuda_policy_kernel_at_phi35_group(cuda_device):
    B, P, page, KVH, G, hd = PHI_DECODE
    q, k, v, ps, nk = _decode_pool(cuda_device, 1)
    f = torch.randint(1, 9, (B, P), dtype=torch.int32).to(cuda_device)
    r = torch.randint(1, 60, (B, P), dtype=torch.int32).to(cuda_device)
    clock = torch.full((B,), 64, dtype=torch.int32, device=cuda_device)
    open_slot = ps.argmax(dim=-1).to(torch.int32)
    args = (q, k, v, nk, nk, P * page, f, r, ps, clock, open_slot)
    got = ops.policy_paged_attention(*args, policy="awrp")
    want = ref.policy_paged_attention_plain(*args, policy="awrp")
    # one bf16 ulp of the output, f32 summation order for the mass
    torch.testing.assert_close(got[0].float(), want[0].float(), rtol=2.0 ** -7, atol=1e-6)
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-7)
    for a, b in zip(got[2:], want[2:]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_adaptive_kernel_at_phi35_group(cuda_device):
    B, P, page, KVH, G, hd = PHI_DECODE
    q, k, v, ps, nk = _decode_pool(cuda_device, 2)
    pool = paged_kv.PagedPool(k=k.reshape(B, P, page, -1), v=v.reshape(B, P, page, -1),
                              f=torch.ones((B, P), dtype=torch.int32, device=cuda_device),
                              r=torch.ones((B, P), dtype=torch.int32, device=cuda_device),
                              page_start=ps, clock=torch.full((B,), P, dtype=torch.int32,
                                                              device=cuda_device),
                              open_slot=ps.argmax(dim=-1).to(torch.int32))
    seed = paged_kv.seed_adaptive_state(B, P, 0, P, device=cuda_device)
    core = paged_kv.adaptive_core("arc_adaptive", B, P)
    args = (q, k, v, nk, nk, P * page, *pool[2:], *(x[:, 0] for x in seed))
    got = ops.adaptive_policy_paged_attention(*args, kind="arc", renorm_at=core.renorm_at)
    want = ref.adaptive_policy_paged_attention_plain(*args, kind="arc",
                                                     renorm_at=core.renorm_at)
    torch.testing.assert_close(got[0].float(), want[0].float(), rtol=2.0 ** -7, atol=1e-6)
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-7)
    for a, b in zip(got[2:], want[2:]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_flash_attention_at_phi35_group(cuda_device):
    g = torch.Generator().manual_seed(3)
    B, S, KVH, G, hd = 1, 256, 8, 4, 128
    q = torch.randn(B, S, KVH, G, hd, generator=g).to(torch.bfloat16).to(cuda_device)
    k, v = ((torch.randn(B, S, KVH, hd, generator=g) * 0.5).to(torch.bfloat16).to(cuda_device)
            for _ in range(2))
    out = ops.flash_attention(q, k, v, causal=True)
    want = ref.flash_attention_plain(q, k, v, causal=True)
    torch.testing.assert_close(out.float(), want.float(), rtol=2.0 ** -7, atol=1e-6)
