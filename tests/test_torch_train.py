"""The port's training path on the CPU against the JAX reference.

* ``models/model.py`` ``forward`` / ``loss_fn``: the loss within 1e-5
  relative of ``M.loss_fn`` and every leaf's gradient within relative L2
  1e-4 of ``jax.grad``'s, at the reference's ``_tiny_setup`` smollm config
  (``tests/test_train_substrate.py``), gemma3's SMOKE_CONFIG (local and
  global layers), qwen2.5's (QKV bias, biases drawn nonzero) and the
  other families' SMOKE_CONFIGs in f32: phi3.5-moe and grok-1 (MoE, SwiGLU
  and GELU experts), mamba2 (SSD blocks), zamba2 (Mamba-2 + the shared
  attention set), internvl2 (``patches``) and whisper (``frames``: the
  encoder, the decoder and its cross-attention at Sq != Skv);
  ``forward``'s logits equal the prefill's bit for bit; remat on and off
  give the same gradients, whisper's included; ``layers.moe_aux_loss``
  against the reference's;
* ``optim``: ``apply_updates`` against ``O.apply_updates`` from the same
  grads and state (``opt_state_from_jax``), per leaf within 1e-6 * max|p|;
  ``quantize_int8`` / ``maybe_compress_grads`` bit for bit;
* ``train/train_step.py``: ``effective_microbatches`` equal on a grid;
  three microbatched steps (n_micro = 2) against the reference's jitted
  step, the loss per step within 1e-5 relative, also for whisper (its
  ``frames`` split with the tokens);
* ``data/pipeline.py``: the same batches bit for bit, also after ``state``
  / ``restore`` and across epochs;
* ``train/checkpoint.py``: a bit-exact round trip (bf16 included); a
  reference-written f32 checkpoint restores in the port equal to
  ``params_from_jax`` of the same, and the reverse;
* ``train/fault_tolerance.py``: ``run_resilient`` survives failures at 7 and
  23, a resumed run reproduces the uninterrupted one bit for bit, the
  straggler detector;
* ``launch/train.py``: a tiny CPU run (smollm, and the moe and ssm
  families), ``--device cuda`` without a card, ``--mesh single`` / ``multi``
  in a world of one rank (the mesh's error) and the enc-dec / VLM families
  (``SyntheticLM`` has no frames or patches) raise; ``--mesh none`` keeps
  the loss sequence it had.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import load_config as jload_config  # noqa: E402
from repro.configs.base import load_smoke_config as jload_smoke  # noqa: E402
from repro.data import pipeline as JP  # noqa: E402
from repro.launch.train import tiny_config as jtiny_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import grad_compress as JGC  # noqa: E402
from repro.optim import optimizer as JO  # noqa: E402
from repro.train import checkpoint as JC  # noqa: E402
from repro.train import train_step as JTS  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.data import pipeline as TP  # noqa: E402
from repro_torch.launch import train as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import opt_state_from_jax, params_from_jax  # noqa: E402
from repro_torch.optim import grad_compress as TGC  # noqa: E402
from repro_torch.optim import optimizer as TO  # noqa: E402
from repro_torch.train import checkpoint as TC  # noqa: E402
from repro_torch.train import fault_tolerance as TFT  # noqa: E402
from repro_torch.train import train_step as TTS  # noqa: E402

torch.set_num_threads(2)

LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-4
OPT_TOL = 1e-6  # of max|p|, per leaf
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _settle_torch_exp():
    """One einsum and exp before the comparisons (``test_torch_flash.py``)."""
    rng = np.random.default_rng(0)
    q, k = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((1, 128, 2, 2, 32), (1, 128, 2, 32)))
    torch.exp(torch.einsum("bqkgh,bckh->bkgqc", q, k))


def _tiny(jax_side: bool, **kw):
    """The reference's ``_tiny_setup`` config (tests/test_train_substrate.py)."""
    if jax_side:
        cfg = jtiny_config(jload_config("smollm_360m"))
    else:
        cfg = TL.tiny_config(TB.load_config("smollm_360m"))
    return dataclasses.replace(cfg, n_layers=2, d_model=128, d_ff=512, vocab=256, **kw)


def _smoke_f32(arch: str, jax_side: bool):
    cfg = jload_smoke(arch) if jax_side else TB.load_smoke_config(arch)
    return dataclasses.replace(cfg, dtype="float32", param_dtype="float32")


def _jax_params(cfg, seed: int = 0, bias_std: float = 0.0):
    """Reference parameters as numpy; biases drawn N(0, bias_std) when asked
    (the reference inits them to zeros)."""
    params = jax.tree.map(np.asarray, JM.init_params(cfg, jax.random.PRNGKey(seed)))
    if bias_std:
        rng = np.random.default_rng(seed + 100)

        def draw(tree):
            for k, v in tree.items():
                if isinstance(v, dict):
                    draw(v)
                elif k in ("bq", "bk", "bv"):
                    tree[k] = (rng.standard_normal(v.shape) * bias_std).astype(v.dtype)

        draw(params)
    return params


def _stub_inputs(cfg, B: int, S: int, rng) -> dict:
    """The stub frontend's input of ``cfg``'s family: for the enc-dec
    ``frames`` (B, S // enc_seq_divisor, D), for the VLM ``patches`` (B,
    n_patch_tokens, D), N(0, 1) * 0.02 in f32 from ``rng``, as
    ``tests/test_models.py`` draws them; none for the other families."""
    family = getattr(cfg, "family", None)
    if family == "encdec":
        return {"frames": (rng.standard_normal((B, S // cfg.enc_seq_divisor, cfg.d_model))
                           * 0.02).astype(np.float32)}
    if family == "vlm":
        return {"patches": (rng.standard_normal((B, cfg.n_patch_tokens, cfg.d_model))
                            * 0.02).astype(np.float32)}
    return {}


def _batch(vocab: int, B: int, S: int, seed: int = 0, cfg=None):
    """Seeded tokens and labels, then the family's ``_stub_inputs``."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
           "labels": rng.integers(0, vocab, (B, S)).astype(np.int32)}
    return {**out, **_stub_inputs(cfg, B, S, rng)}


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _flat(tree, prefix=""):
    """{path: leaf} of nested dicts (numpy or torch), sorted by path."""
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, p) if isinstance(v, dict) else {p: v})
    return dict(sorted(out.items()))


# -- forward / loss_fn -----------------------------------------------------

LOSS_CASES = {
    "tiny_smollm": (lambda side: _tiny(side), 0.0, 4, 64),
    "gemma3_smoke": (lambda side: _smoke_f32("gemma3_27b", side), 0.0, 2, 40),
    "qwen25_smoke": (lambda side: _smoke_f32("qwen25_14b", side), 0.5, 2, 32),
    # the other families (S = 64: whisper's 32 frames, internvl2's 8 patches,
    # two SSD chunks of 32 for mamba2 and zamba2)
    **{f"{arch}_smoke": (lambda side, a=arch: _smoke_f32(a, side), 0.0, 2, 64)
       for arch in ("phi35_moe", "grok1_314b", "mamba2_370m", "zamba2_7b", "internvl2_26b",
                    "whisper_large_v3")},
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_and_grads_match_reference(case):
    make, bias_std, B, S = LOSS_CASES[case]
    jcfg, tcfg = make(True), make(False)
    npp = _jax_params(jcfg, bias_std=bias_std)
    batch = _batch(jcfg.vocab, B, S, seed=1, cfg=jcfg)
    jl, jg = jax.jit(jax.value_and_grad(lambda p, b: JM.loss_fn(p, jcfg, b)))(
        jax.tree.map(jnp.asarray, npp), {k: jnp.asarray(v) for k, v in batch.items()})
    tp = params_from_jax(npp, tcfg, "cpu", torch.float32)
    leaves = TO.tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    tl = TM.loss_fn(tp, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(tl, leaves)
    assert abs(tl.item() - float(jl)) <= LOSS_RTOL * abs(float(jl))
    it = iter(grads)
    tgrads = _flat(TO.tree_map(lambda _: next(it), tp))
    jgrads = _flat(jax.tree.map(np.asarray, jg))
    assert tgrads.keys() == jgrads.keys()
    for name, g in tgrads.items():
        assert _rel_l2(g.numpy(), jgrads[name]) <= GRAD_REL_L2, name


def test_forward_logits_equal_the_prefill_logits():
    cfg = _smoke_f32("gemma3_27b", False)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.from_numpy(_batch(cfg.vocab, 2, 40)["tokens"])
    with torch.no_grad():
        a = TM.forward(params, cfg, {"tokens": tokens})
        b, _ = TM.prefill(params, cfg, tokens, max_len=48)
    assert a.dtype == torch.float32 and torch.equal(a, b)


def _remat_runs(cfg):
    """(loss, grads) with ``remat`` "full" and "none" from the same
    parameters and batch."""
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg.vocab, 2, 32, cfg=cfg).items()}
    params = TM.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    out = []
    for remat in ("full", "none"):
        c = dataclasses.replace(cfg, remat=remat)
        leaves = [p.detach().requires_grad_(True) for p in TO.tree_leaves(params)]
        it = iter(leaves)
        tree = TO.tree_map(lambda _: next(it), params)
        loss = TM.loss_fn(tree, c, batch)
        out.append((loss, torch.autograd.grad(loss, leaves)))
    return out


def test_remat_changes_no_gradient():
    out = _remat_runs(_tiny(False))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_remat_changes_no_gradient_of_the_encoder_decoder():
    """whisper's encoder and decoder layers, each checkpointed apart."""
    out = _remat_runs(_smoke_f32("whisper_large_v3", False))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_loss_ignores_negative_labels_and_vocab_padding():
    cfg = dataclasses.replace(_tiny(False), vocab=200)  # padded to 256
    params = TM.init_params(cfg, torch.Generator().manual_seed(2), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg.vocab, 2, 16).items()}
    with torch.no_grad():
        logits = TM.forward(params, cfg, batch)
        full = TM.loss_fn(params, cfg, batch)
        labels = batch["labels"].clone()
        labels[:, 8:] = -1
        half = TM.loss_fn(params, cfg, {"tokens": batch["tokens"], "labels": labels})
    lg = logits[..., :200]
    nll = torch.logsumexp(lg, -1) - lg.gather(-1, batch["labels"].long()[..., None])[..., 0]
    torch.testing.assert_close(full, nll.mean(), rtol=1e-6, atol=0)
    torch.testing.assert_close(half, nll[:, :8].mean(), rtol=1e-6, atol=0)
    with torch.no_grad():
        none = TM.loss_fn(params, cfg, {"tokens": batch["tokens"],
                                        "labels": torch.full_like(labels, -1)})
    assert none.item() == 0.0


@pytest.mark.parametrize("arch", ["phi35_moe", "grok1_314b"])
def test_moe_aux_loss_matches_reference(arch):
    """``layers.moe_aux_loss`` (which no loss adds, in either package)
    against the reference's, from the same router and inputs; its gradient
    to the router within GRAD_REL_L2 of ``jax.grad``'s."""
    from repro.models import layers as JL
    from repro_torch.models import layers as TLy

    jcfg, tcfg = _smoke_f32(arch, True), _smoke_f32(arch, False)
    rng = np.random.default_rng(4)
    w = (rng.standard_normal((jcfg.d_model, jcfg.n_experts)) * 0.3).astype(np.float32)
    x = rng.standard_normal((3, 40, jcfg.d_model)).astype(np.float32)
    jl, jg = jax.value_and_grad(lambda w_: JL.moe_aux_loss({"w_router": w_}, jnp.asarray(x),
                                                           jcfg))(jnp.asarray(w))
    wt = torch.from_numpy(w).requires_grad_(True)
    tl = TLy.moe_aux_loss({"w_router": wt}, torch.from_numpy(x), tcfg)
    (tg,) = torch.autograd.grad(tl, [wt])
    assert tl.dtype == torch.float32 and tl.dim() == 0
    assert abs(tl.item() - float(jl)) <= LOSS_RTOL * abs(float(jl))
    assert _rel_l2(tg.numpy(), np.asarray(jg)) <= GRAD_REL_L2


@pytest.mark.parametrize("arch", TB.ARCH_IDS)
def test_training_fields_and_shapes_follow_the_reference(arch):
    fields = ("remat", "microbatches", "adam_dtype", "grad_accum_dtype", "opt_master",
              "grad_compress")
    for tload, jload in ((TB.load_config, jload_config), (TB.load_smoke_config, jload_smoke)):
        t, j = tload(arch), jload(arch)
        assert {f: getattr(t, f) for f in fields} == {f: getattr(j, f) for f in fields}
    from repro.configs.base import ARCH_IDS, SHAPES

    assert TB.ARCH_IDS == ARCH_IDS
    assert {k: dataclasses.astuple(v) for k, v in TB.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in SHAPES.items()}


# -- optimizer and compression --------------------------------------------


def _rand_like(tree, rng, scale=1.0):
    return jax.tree.map(lambda a: (rng.standard_normal(a.shape) * scale).astype(np.float32),
                        tree)


@pytest.mark.parametrize("master,adam_dtype", [(True, "float32"), (False, "float32"),
                                               (False, "bfloat16")])
def test_apply_updates_matches_reference(master, adam_dtype):
    cfg = _tiny(True)
    tcfg = _tiny(False)
    oc = JO.OptConfig(lr=1e-2, warmup_steps=2, total_steps=10, adam_dtype=adam_dtype,
                      master_weights=master)
    toc = TO.OptConfig(lr=1e-2, warmup_steps=2, total_steps=10, adam_dtype=adam_dtype,
                       master_weights=master)
    rng = np.random.default_rng(3)
    jp = JM.init_params(cfg, jax.random.PRNGKey(4))
    js = JO.init_opt_state(jp, oc)
    # two reference steps first: a state with nonzero moments past the warmup
    for _ in range(2):
        jp, js, _ = JO.apply_updates(jp, jax.tree.map(jnp.asarray, _rand_like(jp, rng)), js, oc)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[adam_dtype]
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu", torch.float32)
    ts = opt_state_from_jax(jax.tree.map(np.asarray, js), tcfg, "cpu", adam_dtype=tdt)
    assert int(ts.step) == 2 and (ts.master is None) == (not master)
    grads = _rand_like(jp, rng, scale=3.0)  # clipped: norm > 1
    jp2, js2, jm = JO.apply_updates(jp, jax.tree.map(jnp.asarray, grads), js, oc)
    tg = params_from_jax(grads, tcfg, "cpu", torch.float32)
    tp2, ts2, tm = TO.apply_updates(tp, tg, ts, toc)
    assert int(ts2.step) == 3 and tm["lr"].dtype == torch.float32
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    for name, p in _flat(tp2).items():
        want = _flat(jax.tree.map(np.asarray, jp2))[name]
        assert np.abs(p.numpy() - want).max() <= OPT_TOL * np.abs(want).max(), name
    for field in ("m", "v") + (("master",) if master else ()):
        got = _flat(getattr(ts2, field))
        want = _flat(jax.tree.map(lambda a: np.asarray(a, np.float32), getattr(js2, field)))
        for name, t in got.items():
            assert t.dtype == (torch.float32 if field == "master" else tdt)
            w = want[name]
            tol = (OPT_TOL if tdt == torch.float32 or field == "master" else 2.0 ** -7)
            assert np.abs(t.float().numpy() - w).max() <= tol * max(np.abs(w).max(), 1e-30), \
                (field, name)


@pytest.mark.parametrize("step", [0, 1, 5, 100, 150, 9_999, 10_000, 20_000])
def test_schedule_matches_reference(step):
    oc, toc = JO.OptConfig(), TO.OptConfig()
    want = float(JO.schedule(oc, jnp.asarray(step, jnp.int32)))
    got = TO.schedule(toc, torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)


@pytest.mark.parametrize("shape", [(7,), (33, 17), (4, 8, 16)])
def test_quantize_int8_bits_match_reference(shape):
    rng = np.random.default_rng(len(shape))
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    jq, js = JGC.quantize_int8(jnp.asarray(x))
    tq, ts = TGC.quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.numpy().tobytes() == np.asarray(js, np.float32).tobytes()
    np.testing.assert_array_equal(TGC.dequantize(tq, ts).numpy(),
                                  np.asarray(JGC.dequantize(jq, js)))


def test_quantize_rounds_ties_to_even_as_the_reference():
    # max 127 gives scale 1 (+1e-12): x / scale lands on exact halves
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5], np.float32)
    jq, _ = JGC.quantize_int8(jnp.asarray(x))
    tq, _ = TGC.quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))


def test_maybe_compress_grads_matches_reference():
    rng = np.random.default_rng(9)
    tree = {"a": rng.standard_normal((5, 6)).astype(np.float32),
            "b": {"c": rng.standard_normal((9,)).astype(np.float32),
                  "d": rng.standard_normal((2, 3, 4)).astype(np.float32)}}
    want = _flat(jax.tree.map(np.asarray, JGC.maybe_compress_grads(
        jax.tree.map(jnp.asarray, tree))))
    got = _flat(TGC.maybe_compress_grads(jax.tree.map(torch.from_numpy, tree)))
    for name, t in got.items():
        np.testing.assert_array_equal(t.numpy(), want[name])


# -- train step ------------------------------------------------------------


@pytest.mark.parametrize("microbatches", [1, 2, 3, 4, 8, 16])
@pytest.mark.parametrize("global_batch,shards", [(1, 1), (6, 1), (8, 2), (12, 4), (7, 1),
                                                 (256, 16)])
def test_effective_microbatches_equal_reference(microbatches, global_batch, shards):
    j = dataclasses.replace(jload_config("smollm_360m"), microbatches=microbatches)
    t = dataclasses.replace(TB.load_config("smollm_360m"), microbatches=microbatches)
    assert TTS.effective_microbatches(t, global_batch, shards) == \
        JTS.effective_microbatches(j, global_batch, shards)


def _microbatched_steps_match(jcfg, tcfg):
    """Three microbatched steps (n_micro = 2) against the reference's jitted
    step; an enc-dec config's batches also carry ``frames``, which both
    steps split with the tokens."""
    oc = JO.OptConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    toc = TO.OptConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    n = JTS.effective_microbatches(jcfg, 8, 1)
    assert n == TTS.effective_microbatches(tcfg, 8, 1) == 2
    jstep = jax.jit(JTS.make_train_step(jcfg, oc, n))
    tstep = TTS.make_train_step(tcfg, toc, n)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu", torch.float32)
    js, ts = JO.init_opt_state(jp, oc), TO.init_opt_state(tp, toc)
    jd, td = JP.SyntheticLM(jcfg.vocab, 8, 64, seed=3), TP.SyntheticLM(tcfg.vocab, 8, 64,
                                                                       seed=3)
    rng = np.random.default_rng(5)
    for _ in range(3):
        stub = _stub_inputs(jcfg, 8, 64, rng)
        jp, js, jm = jstep(jp, js, {**next(jd), **stub})
        tp, ts, tm = tstep(tp, ts, TL.batch_to({**next(td), **stub}, CPU))
        assert tm["loss"].dim() == 0
        assert abs(tm["loss"].item() - float(jm["loss"])) <= LOSS_RTOL * float(jm["loss"])
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-4)


@pytest.mark.parametrize("grad_compress", [False, True])
def test_microbatched_steps_match_reference(grad_compress):
    _microbatched_steps_match(_tiny(True, microbatches=2, grad_compress=grad_compress),
                              _tiny(False, microbatches=2, grad_compress=grad_compress))


def test_microbatched_steps_split_frames_with_tokens():
    arch = "whisper_large_v3"
    _microbatched_steps_match(dataclasses.replace(_smoke_f32(arch, True), microbatches=2),
                              dataclasses.replace(_smoke_f32(arch, False), microbatches=2))


# -- data ------------------------------------------------------------------


@pytest.mark.parametrize("seed,host_index,host_count", [(0, 0, 1), (1, 0, 1), (2, 1, 2)])
def test_synthetic_lm_equals_reference(seed, host_index, host_count):
    kw = dict(seed=seed, host_index=host_index, host_count=host_count)
    j, t = JP.SyntheticLM(100, 8, 16, **kw), TP.SyntheticLM(100, 8, 16, **kw)
    for _ in range(3):
        a, b = next(j), next(t)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    st = t.state()
    assert st == j.state()
    x = next(t)
    t2 = TP.SyntheticLM(100, 8, 16, **kw)
    t2.restore(st)
    assert np.array_equal(next(t2)["tokens"], x["tokens"])


def test_memmap_corpus_equals_reference(tmp_path):
    jf = JP.write_corpus(str(tmp_path / "j"), vocab=500, n_tokens=3_000, shard_tokens=1_000)
    tf = TP.write_corpus(str(tmp_path / "t"), vocab=500, n_tokens=3_000, shard_tokens=1_000)
    for a, b in zip(jf, tf):
        assert np.array_equal(np.load(a), np.load(b))
    j = JP.MemmapCorpus(str(tmp_path / "j"), batch=4, seq_len=32)
    t = TP.MemmapCorpus(str(tmp_path / "t"), batch=4, seq_len=32)
    for _ in range(30):  # 90 windows, 22 steps an epoch: crosses an epoch
        a, b = next(j), next(t)
        assert np.array_equal(a["tokens"], b["tokens"])
        assert np.array_equal(a["labels"], b["labels"])
    assert t.state() == j.state() and t.state()["epoch"] == 1
    st = t.state()
    x = next(t)
    t2 = TP.MemmapCorpus(str(tmp_path / "t"), batch=4, seq_len=32)
    t2.restore(st)
    assert np.array_equal(next(t2)["tokens"], x["tokens"])


# -- checkpoints -----------------------------------------------------------


def _one_step_state(cfg, dtype=torch.float32):
    oc = TO.OptConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    params = TM.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    step = TTS.make_train_step(cfg, oc, 1)
    data = TP.SyntheticLM(cfg.vocab, 2, 16, seed=1)
    params, opt, _ = step(params, TO.init_opt_state(params, oc), TL.batch_to(next(data), CPU))
    return params, opt, data


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("async_write", [False, True])
def test_checkpoint_roundtrip_bitexact(tmp_path, dtype, async_write):
    cfg = _tiny(False, dtype=dtype, param_dtype=dtype)
    params, opt, data = _one_step_state(cfg)
    w = TC.save(str(tmp_path), 1, params, opt, data_state=data.state(),
                extra={"metrics": {"loss": 1.5}}, async_write=async_write)
    if w is not None:
        w.join()
    assert TC.latest_step(str(tmp_path)) == 1
    p2, o2, ds, extra = TC.restore(str(tmp_path), 1, params, opt)
    for a, b in zip(TO.tree_leaves((params, opt)), TO.tree_leaves((p2, o2))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert ds == data.state() and extra == {"metrics": {"loss": 1.5}}
    if dtype == "bfloat16":
        import json

        with open(tmp_path / "step_00000001" / "manifest.json") as f:
            assert json.load(f)["leaves"]["params/embed"]["dtype"] == "bfloat16"


def test_gc_old_keeps_the_newest(tmp_path):
    cfg = _tiny(False)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    for s in range(1, 6):
        TC.save(str(tmp_path), s, params)
    TC.gc_old(str(tmp_path), keep=3)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000003", "step_00000004", "step_00000005"]
    assert TC.latest_step(str(tmp_path)) == 5


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jcfg, tcfg = _tiny(True), _tiny(False)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(7))
    oc = JO.OptConfig()
    js = JO.init_opt_state(jp, oc)
    jp, js, _ = JO.apply_updates(jp, jax.tree.map(lambda a: jnp.ones_like(a) * 0.01, jp), js,
                                 oc)
    JC.save(str(tmp_path), 4, jp, js, data_state={"step": 4, "epoch": 0})
    np_p, np_s = jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js)
    want_p = params_from_jax(np_p, tcfg, "cpu", torch.float32)
    want_s = opt_state_from_jax(np_s, tcfg, "cpu")
    tp, ts, ds, _ = TC.restore(str(tmp_path), TC.latest_step(str(tmp_path)), want_p, want_s)
    assert ds == {"step": 4, "epoch": 0}
    for a, b in zip(TO.tree_leaves((want_p, want_s)), TO.tree_leaves((tp, ts))):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    cfg = _tiny(False)
    params, opt, data = _one_step_state(cfg)
    TC.save(str(tmp_path), 2, params, opt, data_state=data.state())
    jcfg = _tiny(True)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    js = JO.init_opt_state(jp, JO.OptConfig())
    rp, rs, ds, _ = JC.restore(str(tmp_path), JC.latest_step(str(tmp_path)), jp, js)
    assert ds == data.state()
    got = _flat(jax.tree.map(np.asarray, rp))
    for name, t in _flat(params).items():
        np.testing.assert_array_equal(got[name], t.numpy())
    assert int(rs.step) == int(opt.step) == 1
    for field in ("m", "v", "master"):
        got = _flat(jax.tree.map(np.asarray, getattr(rs, field)))
        for name, t in _flat(getattr(opt, field)).items():
            np.testing.assert_array_equal(got[name], t.numpy())


# -- the resilient loop ----------------------------------------------------


def _resilient_setup(steps):
    cfg = _tiny(False)
    oc = TO.OptConfig(lr=1e-2, warmup_steps=5, total_steps=steps)
    step = TTS.make_train_step(cfg, oc, TTS.effective_microbatches(cfg, 8, 1))
    last = {}

    def init_fn(seed=2):
        p = TM.init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")
        return p, TO.init_opt_state(p, oc)

    def step_fn(p, o, b):
        last["params"], o, m = step(p, o, TL.batch_to(b, CPU))
        return last["params"], o, m

    return cfg, init_fn, step_fn, last


def test_resilient_run_survives_injected_failures(tmp_path):
    cfg, init_fn, step_fn, _ = _resilient_setup(30)
    report = TFT.run_resilient(
        ckpt_dir=str(tmp_path), total_steps=30, init_fn=init_fn, step_fn=step_fn,
        data_iter=TP.SyntheticLM(cfg.vocab, 8, 32, seed=3), ckpt_every=10,
        injector=TFT.FailureInjector(fail_at=[7, 23]))
    assert report.steps_done == 30 and report.restarts == 2
    assert np.isfinite(report.final_metrics["loss"])
    assert TC.latest_step(str(tmp_path)) == 30


@pytest.mark.parametrize("fail_at", [[11], [3]])
def test_resume_reproduces_uninterrupted_run(tmp_path, fail_at):
    """Restart from the step-10 checkpoint ([11]) or from scratch with the
    data stream rewound ([3]): the trajectory is the same, bit for bit."""
    cfg, init_fn, step_fn, last = _resilient_setup(20)
    r1 = TFT.run_resilient(ckpt_dir=str(tmp_path / "a"), total_steps=20, init_fn=init_fn,
                           step_fn=step_fn, data_iter=TP.SyntheticLM(cfg.vocab, 8, 32, seed=9),
                           ckpt_every=100)
    p1 = last["params"]
    r2 = TFT.run_resilient(ckpt_dir=str(tmp_path / "b"), total_steps=20, init_fn=init_fn,
                           step_fn=step_fn, data_iter=TP.SyntheticLM(cfg.vocab, 8, 32, seed=9),
                           ckpt_every=10, injector=TFT.FailureInjector(fail_at=fail_at))
    assert r2.restarts == 1
    assert r1.final_metrics["loss"] == r2.final_metrics["loss"]
    for a, b in zip(TO.tree_leaves(p1), TO.tree_leaves(last["params"])):
        assert torch.equal(a, b)


def test_straggler_detector_flags_slow_steps():
    t = TFT.StepTimer(threshold=2.0)
    for i in range(10):
        t.record(i, 0.1)
    assert t.record(10, 0.5) is True
    assert 10 in t.stragglers
    assert t.record(11, 0.1) is False


# -- the launcher ----------------------------------------------------------


def test_launcher_trains_tiny_on_the_cpu(tmp_path, capsys):
    report = TL.main(["--device", "cpu", "--preset", "tiny", "--steps", "4",
                      "--log-every", "2", "--ckpt-dir", str(tmp_path)])
    assert report.steps_done == 4 and np.isfinite(report.final_metrics["loss"])
    assert "done: 4 steps" in capsys.readouterr().out


def test_launcher_mesh_none_keeps_the_loss_sequence(tmp_path, capsys):
    """``--mesh none`` trains as the launcher did before it took a mesh: the
    logged sequence of the tiny preset's first four steps."""
    TL.main(["--device", "cpu", "--preset", "tiny", "--steps", "4", "--log-every", "1",
             "--mesh", "none", "--ckpt-dir", str(tmp_path)])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("step")]
    assert lines == ["step     1 loss 7.6110 gnorm 7.609 lr 3.00e-04",
                     "step     2 loss 7.0481 gnorm 5.725 lr 2.33e-04",
                     "step     3 loss 6.7399 gnorm 3.798 lr 9.75e-05",
                     "step     4 loss 6.6310 gnorm 3.703 lr 3.00e-05"]


@pytest.mark.parametrize("arch,preset", [("phi35_moe", "tiny"), ("mamba2_370m", "tiny"),
                                         ("mamba2_370m", "smoke")])
def test_launcher_trains_the_moe_and_ssm_families_on_the_cpu(tmp_path, capsys, arch, preset):
    """The reference's tiny preset keeps the family's FFN (4 experts, top-2)
    and gives the ssm family attention blocks; the smoke preset runs
    mamba2's SSD blocks."""
    report = TL.main(["--device", "cpu", "--arch", arch, "--preset", preset, "--steps", "2",
                      "--batch", "4", "--seq", "64", "--log-every", "1",
                      "--ckpt-dir", str(tmp_path)])
    assert report.steps_done == 2 and np.isfinite(report.final_metrics["loss"])
    assert "done: 2 steps" in capsys.readouterr().out


@pytest.mark.parametrize("arch,key", [("whisper_large_v3", "frames"),
                                      ("internvl2_26b", "patches")])
def test_launcher_refuses_the_families_synthetic_lm_cannot_feed(tmp_path, arch, key):
    with pytest.raises(ValueError, match=key):
        TL.main(["--device", "cpu", "--arch", arch, "--ckpt-dir", str(tmp_path)])


def test_launcher_defaults_to_cuda_and_raises_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        TL.main(["--preset", "tiny", "--steps", "1", "--ckpt-dir", str(tmp_path)])


@pytest.mark.parametrize("mesh,world", [("single", 256), ("multi", 512)])
def test_launcher_refuses_a_mesh(tmp_path, mesh, world):
    """A world of one rank is smaller than the production mesh: the mesh's
    ``RuntimeError`` names the world it needs."""
    with pytest.raises(RuntimeError, match=f"needs a world of {world} ranks, have 1"):
        TL.main(["--device", "cpu", "--mesh", mesh, "--ckpt-dir", str(tmp_path)])
