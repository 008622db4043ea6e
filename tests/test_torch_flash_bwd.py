"""The backward of kernel 6 on the CPU: ``ref.flash_attention_backward_plain``
(the closed-form gradient in f32) against ``torch.autograd`` through
``ref.flash_attention_plain`` and against ``jax.vjp`` of the reference's
jnp ``repro.models.layers.flash_attention`` (``layers.py:100``, the function
XLA differentiates: the reference has no backward kernel), on a grid of
causal / window / non-causal x G in {1, 3} x hd in {64, 112, 128} at a
ragged S, each gradient elementwise within 1e-5 * max|ref| + 1e-6; the same
at Sq != Skv (cross-attention: non-causal, causal, windowed, both Sq < Skv
and Sq > Skv) and under a ``kv_len`` mask (``CROSS_CASES``);
``ops.flash_attention`` through ``FlashAttention`` on CPU tensors; the
forward's log-sum-exp; the ``kv_len`` range the backward refuses.

The ``cuda``-marked tests hold the backward kernel against its plain
version on a card and skip without one.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attn import BWD_HEAD_DIMS, check_backward_case  # noqa: E402

torch.set_num_threads(2)

RTOL_OF_MAX = 1e-5
ATOL = 1e-6

MASKS = [(True, 0), (True, 24), (False, 0)]  # (causal, window)


@pytest.fixture(autouse=True, scope="module")
def _settle_torch_exp():
    """One einsum and exp before the comparisons (``test_torch_flash.py``:
    the first ``torch.exp`` after a process's first ``einsum`` can be one
    thread's half off on this CPU torch)."""
    rng = np.random.default_rng(0)
    q, k = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((1, 128, 2, 2, 32), (1, 128, 2, 32)))
    torch.exp(torch.einsum("bqkgh,bckh->bkgqc", q, k))


def _inputs(seed, B, S, KVH, G, hd, Skv=None):
    """Seeded q, k, v and the output cotangent dout, f32 numpy; k / v of
    ``Skv`` positions (default S)."""
    Skv = S if Skv is None else Skv
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, KVH, G, hd)).astype(np.float32)
    k = (rng.standard_normal((B, Skv, KVH, hd)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((B, Skv, KVH, hd)) * 0.5).astype(np.float32)
    dout = rng.standard_normal((B, S, KVH, G, hd)).astype(np.float32)
    return q, k, v, dout


def _plain_grads(q, k, v, dout, causal, window, kv_len=None):
    """The closed form from the plain forward's own out and lse."""
    t = [torch.from_numpy(a) for a in (q, k, v, dout)]
    out, lse = ref.flash_attention_plain(*t[:3], causal=causal, window=window,
                                         kv_len=kv_len, return_lse=True)
    return ref.flash_attention_backward_plain(*t[:3], out, lse, t[3], causal=causal,
                                              window=window, kv_len=kv_len)


def _assert_within(got, want, label):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    tol = RTOL_OF_MAX * np.abs(want).max() + ATOL
    err = np.abs(got - want).max()
    assert err <= tol, (label, err, tol)


@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("G,hd", [(1, 64), (3, 64), (1, 112), (3, 128)])
def test_plain_backward_matches_autograd(causal, window, G, hd):
    q, k, v, dout = _inputs(1, 2, 77, 2, G, hd)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = ref.flash_attention_plain(qt, kt, vt, causal=causal, window=window)
    want = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(dout))
    got = _plain_grads(q, k, v, dout, causal, window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _assert_within(g.numpy(), w.numpy(), name)


@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("hd", [64, 112, 128])
def test_plain_backward_matches_jax_vjp(causal, window, G, hd):
    """Against the gradient XLA derives for the reference's chunked jnp
    attention (small chunks, so the ragged S = 100 spans several)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.models import layers as JL

    q, k, v, dout = _inputs(2, 2, 100, 2, G, hd)
    pos = jnp.arange(100, dtype=jnp.int32)

    def f(q_, k_, v_):
        return JL.flash_attention(q_, k_, v_, q_positions=pos, kv_positions=pos,
                                  causal=causal, window=window, q_chunk=32, kv_chunk=48)

    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    got = _plain_grads(q, k, v, dout, causal, window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _assert_within(g.numpy(), np.asarray(w), name)


@pytest.mark.parametrize("causal,window", MASKS)
def test_flash_attention_apply_on_cpu_matches_autograd_through_plain(causal, window):
    q, k, v, dout = _inputs(3, 1, 90, 2, 3, 64)
    launched = ops.LAUNCHES["flash_attention_bwd"]
    a = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    b = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = ops.flash_attention(*a, causal=causal, window=window)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    want_out = ref.flash_attention_plain(*b, causal=causal, window=window)
    assert torch.equal(out, want_out)
    g = torch.from_numpy(dout)
    got = torch.autograd.grad(out, a, g)
    want = torch.autograd.grad(want_out, b, g)
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        _assert_within(x.numpy(), y.numpy(), name)
    # the CPU path counts no kernel launch
    assert ops.LAUNCHES["flash_attention_bwd"] == launched


def test_no_grad_forward_has_the_same_bits_and_no_graph():
    q, k, v, _ = _inputs(4, 1, 70, 2, 3, 64)
    t = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    with_grad = ops.flash_attention(*t, causal=True, window=16)
    with torch.no_grad():
        without = ops.flash_attention(*t, causal=True, window=16)
    assert without.grad_fn is None
    assert torch.equal(with_grad, without)


def test_lse_is_the_rows_logsumexp_and_neg_inf_when_fully_masked():
    q, k, v, _ = _inputs(5, 2, 40, 2, 3, 64)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = ref.flash_attention_plain(qt, kt, vt, causal=True, window=8,
                                         return_lse=True)
    assert lse.shape == (2, 40, 2, 3) and lse.dtype == torch.float32
    s = torch.einsum("bqkgh,bckh->bqkgc", qt, kt) / np.sqrt(64)
    i = torch.arange(40)[:, None, None, None]
    j = torch.arange(40)[None, None, None, :]
    s = torch.where((j <= i) & (i - j < 8), s, -torch.inf)
    torch.testing.assert_close(lse, torch.logsumexp(s, dim=-1), rtol=1e-6, atol=1e-6)
    # kv_len = 0 masks every key: out 0, lse NEG_INF
    out0, lse0 = ref.flash_attention_plain(qt, kt, vt, causal=False, kv_len=0,
                                           return_lse=True)
    assert not out0.any() and bool((lse0 == ref.NEG_INF).all())


#: (label, Sq, Skv, causal, window, kv_len): cross-attention shapes and
#: ``kv_len`` masks, each row of which sees at least one key (the
#: reference's chunked attention averages a fully masked row where the port
#: gives 0, so no such row is compared with it)
CROSS_CASES = [
    ("cross", 40, 100, False, 0, None),  # whisper's decoder over its encoder
    ("cross_long_q", 100, 40, False, 0, None),
    ("cross_causal", 40, 100, True, 0, None),
    ("cross_causal_long_q", 100, 40, True, 0, None),
    ("cross_window", 60, 100, False, 24, None),
    ("kv_len", 64, 100, False, 0, 70),
]


def _cross(label):
    return next(c[1:] for c in CROSS_CASES if c[0] == label)


@pytest.mark.parametrize("label", [c[0] for c in CROSS_CASES])
@pytest.mark.parametrize("G", [1, 3])
def test_plain_backward_matches_autograd_at_sq_ne_skv(label, G):
    Sq, Skv, causal, window, kv_len = _cross(label)
    q, k, v, dout = _inputs(11, 2, Sq, 2, G, 64, Skv)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = ref.flash_attention_plain(qt, kt, vt, causal=causal, window=window, kv_len=kv_len)
    want = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(dout))
    got = _plain_grads(q, k, v, dout, causal, window, kv_len)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _assert_within(g.numpy(), w.numpy(), name)
    if kv_len is not None:  # keys at or past kv_len get no gradient
        assert not got[1][:, kv_len:].any() and not got[2][:, kv_len:].any()


@pytest.mark.parametrize("label", [c[0] for c in CROSS_CASES])
@pytest.mark.parametrize("G", [1, 3])
def test_plain_backward_matches_jax_vjp_at_sq_ne_skv(label, G):
    """Against ``jax.vjp`` of the reference's chunked jnp attention at Sq !=
    Skv; a ``kv_len`` mask is its ``kv_positions`` of -1 past kv_len."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.models import layers as JL

    Sq, Skv, causal, window, kv_len = _cross(label)
    q, k, v, dout = _inputs(12, 2, Sq, 2, G, 64, Skv)
    qpos = jnp.arange(Sq, dtype=jnp.int32)
    kpos = jnp.arange(Skv, dtype=jnp.int32)
    if kv_len is not None:
        kpos = jnp.where(kpos < kv_len, kpos, -1)

    def f(q_, k_, v_):
        return JL.flash_attention(q_, k_, v_, q_positions=qpos, kv_positions=kpos,
                                  causal=causal, window=window, q_chunk=32, kv_chunk=48)

    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    got = _plain_grads(q, k, v, dout, causal, window, kv_len)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _assert_within(g.numpy(), np.asarray(w), name)


@pytest.mark.parametrize("label", [c[0] for c in CROSS_CASES])
def test_flash_attention_apply_at_sq_ne_skv_matches_autograd_through_plain(label):
    """``ops.flash_attention`` with a gradient at Sq != Skv and under
    ``kv_len`` goes through ``FlashAttention`` (no refusal), equal to the
    plain forward and its autograd gradients."""
    Sq, Skv, causal, window, kv_len = _cross(label)
    q, k, v, dout = _inputs(13, 1, Sq, 2, 3, 64, Skv)
    a = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    b = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    kw = {"causal": causal, "window": window, "kv_len": kv_len}
    out = ops.flash_attention(*a, **kw)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    want_out = ref.flash_attention_plain(*b, **kw)
    assert torch.equal(out, want_out)
    g = torch.from_numpy(dout)
    for name, x, y in zip(("dq", "dk", "dv"), torch.autograd.grad(out, a, g),
                          torch.autograd.grad(want_out, b, g)):
        _assert_within(x.numpy(), y.numpy(), name)


@pytest.mark.parametrize("kv_len", [-1, 33])
def test_backward_refuses_a_kv_len_out_of_range(kv_len):
    with pytest.raises(ValueError, match=f"kv_len {kv_len} out of range"):
        check_backward_case((1, 20, 1, 2, 64), (1, 32, 1, 64), kv_len)
    check_backward_case((1, 20, 1, 2, 64), (1, 32, 1, 64), 32)
    check_backward_case((1, 20, 1, 2, 64), (1, 32, 1, 64), 0)


def test_backward_head_dims_bind_the_kernel_not_the_plain_version():
    for hd in BWD_HEAD_DIMS:
        check_backward_case((2, 50, 1, 3, hd), (2, 50, 1, hd), None)
        check_backward_case((2, 50, 1, 3, hd), (2, 50, 1, hd), 50)
    for hd in (32, 256):
        with pytest.raises(ValueError, match=f"hd {hd}"):
            check_backward_case((2, 50, 1, 3, hd), (2, 50, 1, hd), None)
        check_backward_case((2, 50, 1, 3, hd), (2, 50, 1, hd), None, kernel=False)
    # on CPU tensors the plain backward takes hd 32 (the smoke configs')
    q, k, v, dout = _inputs(8, 1, 20, 1, 2, 32)
    t = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    grads = torch.autograd.grad(ops.flash_attention(*t, causal=True), t, torch.from_numpy(dout))
    assert all(torch.isfinite(g).all() for g in grads)


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _bf16_operand_backward(q, k, v, out, lse, dout, *, causal, window):
    """The plain backward's closed form as the bf16 kernel computes it: p and
    ds in f32, each rounded once to bf16 as the operand of its products
    (a bf16 x bf16 product is exact in f32, the sums in f32), the gradients
    rounded to bf16."""
    B, S, KVH, G, hd = q.shape
    scale = ref.attn_scale(hd)
    i = torch.arange(S)[:, None]
    j = torch.arange(S)[None, :]
    mask = torch.ones(S, S, dtype=torch.bool)
    if causal:
        mask &= j <= i
    if window:
        mask &= i - j < window
    s = torch.einsum("bqkgh,bckh->bkgqc", q, k) * scale
    lse_t = lse.permute(0, 2, 3, 1)[..., None]
    p = torch.where(mask, torch.exp(torch.where(mask, s, 0.0) - lse_t), 0.0)
    dp = torch.einsum("bqkgh,bckh->bkgqc", dout, v)
    D = (dout * out).sum(-1).permute(0, 2, 3, 1)[..., None]
    ds = p * (dp - D)
    p, ds = _bf16(p), _bf16(ds)
    dq = torch.einsum("bkgqc,bckh->bqkgh", ds, k) * scale
    dk = torch.einsum("bkgqc,bqkgh->bckh", ds, q) * scale
    dv = torch.einsum("bkgqc,bqkgh->bckh", p, dout)
    return _bf16(dq), _bf16(dk), _bf16(dv)


@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("hd", [64, 112, 128])
def test_bf16_operands_of_p_and_ds_stay_within_a_quarter_of_the_gate(causal, window, G, hd):
    """The bf16 kernel feeds p and ds to the tensor cores as one bf16 each:
    on bf16 inputs with the forward's bf16 ``out``, that scheme stays within
    a quarter of the card's gate (2**-6 relative L2) of the f32 closed form,
    so no product needs p or ds in several parts."""
    q, k, v, dout = (_bf16(torch.from_numpy(a)) for a in _inputs(9, 1, 300, 2, G, hd))
    out, lse = ref.flash_attention_plain(q, k, v, causal=causal, window=window,
                                         return_lse=True)
    out = _bf16(out)
    want = ref.flash_attention_backward_plain(q, k, v, out, lse, dout, causal=causal,
                                              window=window)
    got = _bf16_operand_backward(q, k, v, out, lse, dout, causal=causal, window=window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        rel = (torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w)).item()
        assert rel <= 2.0 ** -6 / 4, (name, rel)


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,causal,window", [
    ((2, 256, 2, 3, 64), True, 0), ((1, 300, 4, 1, 112), True, 48),
    ((2, 130, 2, 2, 128), False, 0)])
def test_cuda_backward_matches_plain(cuda_device, dtype, shape, causal, window):
    from repro_torch.kernels.flash_attn import flash_attention_kernel

    dt = getattr(torch, dtype)
    q, k, v, dout = (torch.from_numpy(a).to(dt).to(cuda_device) for a in _inputs(7, *shape))
    out_off = flash_attention_kernel(q, k, v, causal=causal, window=window)
    out, lse = flash_attention_kernel(q, k, v, causal=causal, window=window,
                                      return_lse=True)
    assert torch.equal(out, out_off)
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    before = ops.LAUNCHES["flash_attention_bwd"]
    got = torch.autograd.grad(ops.flash_attention(qg, kg, vg, causal=causal, window=window),
                              (qg, kg, vg), dout)
    want = ref.flash_attention_backward_plain(q.float(), k.float(), v.float(), out.float(),
                                              lse, dout.float(), causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention_bwd"] == before + 1
    for g, w in zip(got, want):
        if dtype == "bfloat16":
            rel = torch.linalg.vector_norm(g.float() - w) / torch.linalg.vector_norm(w)
            assert rel.item() <= 2.0 ** -6
        else:
            assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item() + 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,Skv,causal,window,kv_len", [
    ((2, 130, 2, 1, 64), 300, False, 0, None), ((1, 200, 2, 3, 128), 90, True, 0, None),
    ((2, 100, 2, 2, 112), 150, True, 40, 120),
    # G = 6 (internvl2's group): a 64-row query tile holds 10 positions and 4 empty rows
    ((1, 150, 2, 6, 128), 220, True, 0, 200)])
def test_cuda_backward_matches_plain_at_sq_ne_skv(cuda_device, dtype, shape, Skv, causal,
                                                  window, kv_len):
    from repro_torch.kernels.flash_attn import flash_attention_kernel

    dt = getattr(torch, dtype)
    q, k, v, dout = (torch.from_numpy(a).to(dt).to(cuda_device)
                     for a in _inputs(14, *shape, Skv))
    kw = {"causal": causal, "window": window, "kv_len": kv_len}
    out, lse = flash_attention_kernel(q, k, v, return_lse=True, **kw)
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    got = torch.autograd.grad(ops.flash_attention(qg, kg, vg, **kw), (qg, kg, vg), dout)
    want = ref.flash_attention_backward_plain(q.float(), k.float(), v.float(), out.float(),
                                              lse, dout.float(), **kw)
    for g, w in zip(got, want):
        if dtype == "bfloat16":
            rel = torch.linalg.vector_norm(g.float() - w) / torch.linalg.vector_norm(w)
            assert rel.item() <= 2.0 ** -6
        else:
            assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item() + 1e-5
    if kv_len is not None:
        assert not got[1][:, kv_len:].any() and not got[2][:, kv_len:].any()
