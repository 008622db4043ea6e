"""Kernel 6, the port's prefill attention, on the CPU: ``ops.flash_attention``
(the plain version for CPU tensors) against the JAX reference's
``ops.flash_attention`` in Pallas interpret mode and its plain oracle
``ref.ref_flash_attention``, on the reference's grid
(``tests/test_kernels.py``): two shapes x {causal, causal with window 48,
non-causal} x {f32 within 2e-5, bf16 within 3e-2 (the reference's bf16
tolerance: the two sides round bf16 inputs and outputs at other places)},
plus a ragged S, the ``kv_len`` mask and fully masked rows; and against the
reference model's chunked layer ``layers.flash_attention``, with a window.
The decode kernels' shared-memory carves (kernel 5's one CTA per
sequence, kernels 3 and 4's one CTA per page, kv head and sequence),
mirrored here in Python, fit a block at both served configs' decode shapes.

The ``cuda``-marked test holds the CUDA kernel against the plain version on
a card and skips without one.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attn import flash_attention_kernel as jflash  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.configs import gemma3_27b, smollm_360m  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.paged_attn import split_ctas, split_scratch_floats  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

torch.set_num_threads(2)

F32_TOL = 2e-5
BF16_TOL = 3e-2


def _inputs(seed, B, Sq, KVH, G, hd, Skv=None):
    """Seeded q (B, Sq, KVH, G, hd) and k/v (B, Skv, KVH, hd), f32 numpy."""
    rng = np.random.default_rng(seed)
    Skv = Sq if Skv is None else Skv
    q = rng.standard_normal((B, Sq, KVH, G, hd)).astype(np.float32)
    k = (rng.standard_normal((B, Skv, KVH, hd)) * 0.3).astype(np.float32)
    v = (rng.standard_normal((B, Skv, KVH, hd)) * 0.3).astype(np.float32)
    return q, k, v


def _port(q, k, v, dtype, **kw):
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    out = ops.flash_attention(*(torch.from_numpy(a).to(dt) for a in (q, k, v)), **kw)
    assert out.dtype == dt and out.shape == q.shape
    return out.float().numpy()


def _jax(fn, q, k, v, dtype, **kw):
    return np.asarray(fn(*(jnp.asarray(a).astype(dtype) for a in (q, k, v)), **kw),
                      np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 48), (False, 0)])
@pytest.mark.parametrize("B,S,KVH,G,hd", [(1, 128, 2, 2, 32), (2, 160, 1, 3, 64)])
def test_flash_attention_matches_reference_kernel(B, S, KVH, G, hd, causal, window,
                                                  dtype):
    q, k, v = _inputs(1, B, S, KVH, G, hd)
    got = _port(q, k, v, dtype, causal=causal, window=window)
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    want = _jax(jops.flash_attention, q, k, v, dtype, causal=causal, window=window,
                block_q=64, block_k=64, interpret=True)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    oracle = _jax(jref.ref_flash_attention, q, k, v, dtype, causal=causal,
                  window=window)
    np.testing.assert_allclose(got, oracle, rtol=tol, atol=tol)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 48), (False, 16)])
def test_flash_attention_ragged_length_matches_reference_kernel(causal, window):
    """S = 100 is no tile multiple: the reference pads to 128 and masks with
    kv_len; the port takes any S."""
    q, k, v = _inputs(2, 2, 100, 2, 2, 32)
    got = _port(q, k, v, "float32", causal=causal, window=window)
    want = _jax(jops.flash_attention, q, k, v, jnp.float32, causal=causal,
                window=window, block_q=64, block_k=64, interpret=True)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("kv_len", [0, 1, 37, 64])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kv_len_mask_matches_reference_kernel(kv_len, causal):
    """Keys at or past ``kv_len`` are masked (``flash_attn.py``'s padded-key
    mask); a row with no key left gives 0, not NaN."""
    q, k, v = _inputs(3, 1, 64, 2, 2, 32)
    got = _port(q, k, v, "float32", causal=causal, window=0, kv_len=kv_len)
    want = _jax(jflash, q, k, v, jnp.float32, causal=causal, window=0,
                block_q=32, block_k=32, kv_len=kv_len, interpret=True)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    if kv_len == 0:
        assert not got.any()


def test_flash_attention_cross_lengths_match_reference_kernel():
    """Sq != Skv (queries and keys both indexed from 0), windowed."""
    q, k, v = _inputs(4, 1, 64, 1, 4, 32, Skv=128)
    for causal in (True, False):
        got = _port(q, k, v, "float32", causal=causal, window=24)
        want = _jax(jflash, q, k, v, jnp.float32, causal=causal, window=24,
                    block_q=32, block_k=32, interpret=True)
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 48), (False, 0),
                                           (False, 20)])
def test_layer_flash_attention_matches_reference_layer(causal, window):
    """The port's prefill attention, ``ops.flash_attention`` (the plain
    version on the CPU), against the reference model's chunked layer
    ``repro.models.layers.flash_attention``, with the keys from 90 on
    invalid (-1 there, ``kv_len=90`` here)."""
    q, k, v = _inputs(5, 2, 96, 2, 2, 32)
    pos = np.arange(96, dtype=np.int32)
    kv_pos = np.where(pos < 90, pos, -1).astype(np.int32)
    want = np.asarray(JL.flash_attention(
        *(jnp.asarray(a) for a in (q, k, v)), q_positions=jnp.asarray(pos),
        kv_positions=jnp.asarray(kv_pos), causal=causal, window=window,
        q_chunk=32, kv_chunk=32))
    got = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=causal, window=window, kv_len=90)
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


def test_layer_attention_equals_plain_kernel_path():
    """``layers.attention`` sends prefill attention through
    ``ops.flash_attention`` at positions ``arange(S)``: it equals kernel 6's
    plain version on the RoPE'd projections, causal with the window."""
    from repro_torch.models.layers import attention

    cfg = gemma3_27b.SMOKE_CONFIG
    rng = np.random.default_rng(6)
    d, qk, kv = cfg.d_model, cfg.qk_dim, cfg.kv_dim
    p = {n: torch.from_numpy((rng.standard_normal(s) * 0.05).astype(np.float32))
         for n, s in (("wq", (d, qk)), ("wk", (d, kv)), ("wv", (d, kv)),
                      ("wo", (qk, d)))}
    x = torch.from_numpy(rng.standard_normal((2, 40, d)).astype(np.float32))
    pos = torch.arange(40, dtype=torch.int32)
    before = dict(ops.LAUNCHES)
    out, (k, v) = attention(p, x, cfg, window=16)
    assert ops.LAUNCHES == before  # CPU tensors: the plain version, no launch
    assert out.shape == x.shape and k.shape == (2, 40, cfg.n_kv_heads, cfg.head_dim)
    q, _, v2 = TL._project_qkv(p, x, cfg)
    q = TL.rope(q.reshape(2, 40, cfg.n_heads, cfg.head_dim), pos[None].expand(2, 40),
                cfg.rope_theta).reshape(q.shape)
    plain = ref.flash_attention_plain(q, k, v2, causal=True, window=16)
    want = plain.reshape(2, 40, cfg.qk_dim) @ p["wo"]
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=F32_TOL, atol=F32_TOL)


def test_cpu_flash_attention_takes_plain_version_and_cuda_wrapper_refuses_cpu():
    from repro_torch.kernels.flash_attn import flash_attention_kernel

    q, k, v = (torch.from_numpy(a) for a in _inputs(7, 1, 16, 1, 2, 64))
    before = ops.LAUNCHES["flash_attention"]
    out = ops.flash_attention(q, k, v, causal=True, window=4)
    assert ops.LAUNCHES["flash_attention"] == before
    assert torch.equal(out, ref.flash_attention_plain(q, k, v, causal=True, window=4))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_kernel(q, k, v, causal=True, window=0)


MAX_SMEM = 232448  # kMaxSmem: 227 KB, a block's shared-memory limit on Hopper
STATIC_SMEM = 1024  # kStaticSmem: kept free for the kernels' static arrays
FOLD_TILE = 64  # kFoldTile
L2_BYTES = 50 * 2**20  # the H100's L2


def decode_smem(P, page, KVH, G, hd, esize, *, lanes):
    """``(chunk, bytes)`` of kernel 5's dynamic shared memory as
    ``kernels/csrc/paged_attn_common.cuh`` computes them (``chunk_rows``,
    ``smem_bytes`` with the planes), plus ``lanes`` * 5 ints of its
    directory; ``chunk`` is 0 when not even one row fits."""
    R = KVH * G
    row_words = (KVH * hd * esize // 4) | 1
    fixed = 4 * (3 * R * hd + 4 * R + R * page + 2 * P * R + P + 3 * P)
    reserve = fixed + 5 * 2 * P * 4 + STATIC_SMEM
    fit = max(MAX_SMEM - reserve, 0) // (2 * row_words * 4)
    chunk = page if fit >= page else (fit // 16 * 16 if fit >= 16 else fit)
    return chunk, fixed + 2 * chunk * row_words * 4 + 5 * lanes * 4


def split_smem(page, KVH, G, hd, esize):
    """``(partials, fold)`` dynamic shared memory of kernels 3 and 4's two
    launches (``split_smem_bytes``, ``fold_smem_bytes``): a partials CTA
    holds its kv head's K and V rows of a page, the query group and a page of
    scores (rows padded to 4 floats); a fold CTA two buffers of FOLD_TILE
    pages' 64-dim P.V slices, the tile's statistics and flags and the
    sequence's (m, l)."""
    partials = 2 * page * hd * esize + 4 * G * (hd + (page + 3) // 4 * 4)
    fold = 4 * (2 * FOLD_TILE * 64 + 5 * FOLD_TILE + 2 * KVH * G)
    return partials, fold


def _decode_shapes():
    """(name, P, page, KVH, G, hd) of both configs' decode pools: the served
    16-page pool and the config's own ``bounded_kv_pages``."""
    for cfg in (smollm_360m.CONFIG, gemma3_27b.CONFIG):
        for P in (16, cfg.bounded_kv_pages):
            yield (cfg.name, P, cfg.page_size, cfg.n_kv_heads,
                   cfg.n_heads // cfg.n_kv_heads, cfg.head_dim)


@pytest.mark.parametrize("esize", [2, 4])
@pytest.mark.parametrize("shape", list(_decode_shapes()), ids=lambda s: f"{s[0]}-P{s[1]}")
def test_decode_kernels_shared_memory_fits_a_block(shape, esize):
    """Kernel 5 stages a page in chunks of rows sized to the 227 KB block
    limit (``paged_attn_common.cuh`` ``chunk_rows``): every served decode
    shape launches, in bf16 and f32."""
    _, P, page, KVH, G, hd = shape
    chunk, nbytes = decode_smem(P, page, KVH, G, hd, esize, lanes=2 * P)
    assert 1 <= chunk <= page
    assert nbytes + STATIC_SMEM <= MAX_SMEM, (shape, esize, nbytes)
    if (P, page, KVH, G, hd, esize) == (16, 64, 16, 2, 128, 2):
        assert chunk == 16  # gemma3's served pool: pages take 4 chunks
    if KVH * hd * esize <= 640:
        assert chunk == page  # smollm: whole pages, K and V staged together


@pytest.mark.parametrize("esize", [2, 4])
@pytest.mark.parametrize("shape", list(_decode_shapes()), ids=lambda s: f"{s[0]}-P{s[1]}")
def test_split_decode_kernels_fit_and_their_scratch_stays_in_l2(shape, esize):
    """Kernels 3 and 4 (one CTA per page, kv head and sequence) take every
    served decode shape whole, in bf16 and f32: a kv head's slice of a row is
    whole 16-byte chunks, a partials CTA's shared memory leaves room for
    several per SM, a fold CTA's fits the default 48 KB, and the partials'
    scratch for a batch of 4 (``paged_attn.split_scratch_floats``)
    fits the 50 MB L2 and is at most a tenth of a full pool's K/V bytes."""
    _, P, page, KVH, G, hd = shape
    B = 4
    assert hd * esize % 16 == 0 and 1 <= G <= 8
    partials, fold = split_smem(page, KVH, G, hd, esize)
    assert fold + STATIC_SMEM <= 48 * 1024  # the fold launch needs no opt-in
    # several partials CTAs per SM: 8 at smollm's shapes in bf16, 3 at
    # gemma3's in f32
    per_sm = 228 * 1024 // (partials + STATIC_SMEM)
    assert per_sm >= (8 if KVH * hd * esize <= 640 else 3), (shape, esize, partials)
    R = KVH * G
    scratch = 4 * (B * P * R * hd + 2 * B * P * R + 2 * B * R)
    assert 4 * split_scratch_floats(B, P, KVH, G, hd) == scratch
    assert scratch < L2_BYTES
    # pv is G*hd*4 bytes per page and kv head against 2*page*hd*esize of
    # K/V: the partials add at most a tenth to a full pool's bytes (through L2)
    assert scratch <= 0.1 * B * P * page * KVH * hd * 2 * esize
    assert split_ctas(B, P, KVH, G, hd) == B * KVH * (P + G * -(-hd // 64)) > B


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,causal,window", [
    ((2, 256, 2, 2, 128), True, 0), ((2, 256, 2, 2, 128), True, 48),
    ((1, 100, 5, 3, 64), True, 48), ((1, 130, 2, 4, 64), False, 0)])
def test_cuda_flash_attention_matches_plain(cuda_device, dtype, shape, causal, window):
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(dt).to(cuda_device) for a in _inputs(8, *shape))
    before = ops.LAUNCHES["flash_attention"]
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    # one bf16 ulp of the value (f32: f32 summation order), plus a floor
    rtol, atol = (2.0 ** -7, 1e-6) if dtype == "bfloat16" else (1e-4, 1e-5)
    torch.testing.assert_close(out.float(), want.float(), rtol=rtol, atol=atol)
