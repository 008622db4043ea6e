"""Kernel 6, the port's prefill attention, on the CPU: ``ops.flash_attention``
(the plain version for CPU tensors) against the JAX reference's
``ops.flash_attention`` in Pallas interpret mode and its plain oracle
``ref.ref_flash_attention``, on the reference's grid
(``tests/test_kernels.py``): two shapes x {causal, causal with window 48,
non-causal} x {f32 within 2e-5, bf16 within 3e-2 (the reference's bf16
tolerance: the two sides round bf16 inputs and outputs at other places)},
plus a ragged S, the ``kv_len`` mask and fully masked rows, whisper's G = 1
at hd = 64 non-causal at Sq != Skv (cross-attention); and against the
reference model's chunked layer ``layers.flash_attention``, with a window.
The decode kernels' shared-memory carves (kernels 3, 4 and 5's one CTA per
page, kv head and sequence, kernel 5's with its ARC/CAR directory at a page
boundary), mirrored here in Python, fit a block at both served configs'
decode shapes.

The CUDA kernel's tests on a card are in ``tests/test_torch_flash_cuda.py``,
which imports no JAX (the card's machine has none).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attn import flash_attention_kernel as jflash  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.configs import gemma3_27b, qwen25_14b, smollm_360m, zamba2_7b  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.paged_attn import split_ctas, split_scratch_floats  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

torch.set_num_threads(2)

F32_TOL = 2e-5
BF16_TOL = 3e-2


@pytest.fixture(autouse=True, scope="module")
def _settle_torch_exp():
    """One einsum and exp before the comparisons.  On this torch (CPU, two
    intra-op threads) the first ``torch.exp`` after a process's first
    ``einsum`` sometimes returns one thread's half of the tensor about
    1e-4 (relative) off, in about one fresh process in eight; every later
    call is exact to an ulp.  The port's plain flash attention is an einsum
    then an exp, so without this its first case could compare torch's
    glitch, not the port, with the reference."""
    rng = np.random.default_rng(0)
    q, k = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((1, 128, 2, 2, 32), (1, 128, 2, 32)))
    torch.exp(torch.einsum("bqkgh,bckh->bkgqc", q, k))


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
@pytest.mark.parametrize("B,S,KVH,G,hd", [(1, 128, 2, 2, 32), (2, 160, 1, 3, 64),
                                          # qwen2.5's and yi's groups (60 and 63
                                          # of the CUDA tile's 64 rows), zamba2's
                                          # hd = 112, internvl2's G = 6
                                          (1, 128, 2, 5, 128), (1, 128, 2, 7, 128),
                                          (1, 128, 2, 1, 112), (1, 128, 2, 6, 128)])
def test_flash_attention_matches_reference_kernel(B, S, KVH, G, hd, causal, window,
                                                  dtype):
    q, k, v = _inputs(1, B, S, KVH, G, hd)
    got = _port(q, k, v, dtype, causal=causal, window=window)
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    want = _jax(jops.flash_attention, q, k, v, dtype, causal=causal, window=window,
                block_q=64, block_k=64, interpret=True)
    oracle = _jax(jref.ref_flash_attention, q, k, v, dtype, causal=causal,
                  window=window)
    # on a mismatch, say which of the three results moved
    moved = (f"max |port - kernel| {np.abs(got - want).max():.3g}, "
             f"|port - oracle| {np.abs(got - oracle).max():.3g}, "
             f"|kernel - oracle| {np.abs(want - oracle).max():.3g}")
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=moved)
    np.testing.assert_allclose(got, oracle, rtol=tol, atol=tol, err_msg=moved)


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


# whisper's shapes at test size: the encoder (non-causal self-attention,
# G = 1 at hd = 64, a ragged S), the decoder's cross-attention (Sq != Skv,
# non-causal, the keys' ragged length no tile multiple) both ways round, and
# causal self-attention at G = 1 / hd = 64
WHISPER_CASES = [(94, 94, False), (40, 150, False), (150, 40, False), (96, 96, True)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Skv,causal", WHISPER_CASES,
                         ids=[f"{a}x{b}-{'causal' if c else 'full'}"
                              for a, b, c in WHISPER_CASES])
def test_flash_attention_whisper_shapes_match_reference_kernel(Sq, Skv, causal, dtype):
    """G = 1, hd = 64 (whisper's 20 heads of 64, each its own KV head), at
    Sq != Skv without the causal mask: the reference pads both lengths to
    its tiles and masks the keys with kv_len = Skv; the port takes them as
    they are."""
    q, k, v = _inputs(8, 2, Sq, 3, 1, 64, Skv=Skv)
    got = _port(q, k, v, dtype, causal=causal, window=0)
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    want = _jax(jops.flash_attention, q, k, v, dtype, causal=causal, window=0,
                block_q=32, block_k=32, interpret=True)
    oracle = _jax(jref.ref_flash_attention, q, k, v, dtype, causal=causal, window=0)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, oracle, rtol=tol, atol=tol)


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


# one bf16 ulp of the plain value plus a floor: the card's gate on kernel 6
GATE_RTOL, GATE_ATOL = 2.0 ** -7, 1e-6


def _bf16_parts(p, parts: int):
    """``p`` (f32) as ``parts`` bf16 values (in f32), each the bf16 of what
    the earlier ones leave (every difference exact in f32)."""
    out, rest = [], p
    for _ in range(parts):
        out.append(rest.to(torch.bfloat16).float())
        rest = rest - out[-1]
    return out


def _causal_p(q, k):
    """Kernel 6's f32 scores and softmax numerators, causal: (p, l)."""
    S, hd = q.shape[1], q.shape[-1]
    s = torch.einsum("bqkgh,bckh->bkgqc", q.float(), k.float()) * ref.attn_scale(hd)
    pos = torch.arange(S)
    mask = pos[None, :] <= pos[:, None]
    s = torch.where(mask, s, ref.NEG_INF)
    p = torch.where(mask, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    return p, torch.clamp(p.sum(dim=-1), min=1e-30)


def _tensor_core_pv(q, k, v, *, parts: int):
    """Kernel 6's bf16 numerics emulated in torch, causal: f32 scores and
    softmax, l summed from the f32 p, then P.V as the tensor cores take it,
    p in ``parts`` bf16 pieces (bf16 x bf16 products are exact in f32, summed
    in f32): rounded once, hi + lo, or hi + mid + lo as the kernel runs it;
    out rounded to bf16."""
    p, l = _causal_p(q, k)
    pv = sum(torch.einsum("bkgqc,bckh->bqkgh", piece, v.float())
             for piece in _bf16_parts(p, parts))
    return (pv / l.permute(0, 3, 1, 2)[..., None]).to(torch.bfloat16)


def _draw_bf16(shape_q, shape_kv, seed):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal(shape_q).astype(np.float32))
    k, v = (torch.from_numpy((rng.standard_normal(shape_kv) * 0.5).astype(np.float32))
            for _ in range(2))
    return tuple(x.to(torch.bfloat16) for x in (q, k, v))


@pytest.mark.parametrize("B,S,KVH,G,hd", [(1, 128, 2, 2, 64), (1, 256, 2, 2, 128)])
def test_bf16_kernel_needs_p_split_into_hi_and_lo(B, S, KVH, G, hd):
    """Why kernel 6's bf16 path runs P.V as several tensor-core products:
    with p rounded once to bf16 the output misses the card's one-ulp gate
    against the plain version by two orders of magnitude (outputs near 0
    lose all their bits); with p split into hi + mid + lo, as the kernel
    splits it, it stays within the gate.  Inputs drawn as ``chip_smoke.py``
    draws them (q ~ N(0, 1), k, v ~ 0.5 N(0, 1))."""
    q, k, v = _draw_bf16((B, S, KVH, G, hd), (B, S, KVH, hd), 12)
    plain = ref.flash_attention_plain(q, k, v, causal=True).float()

    def over_gate(out):
        return ((out.float() - plain).abs() / (GATE_RTOL * plain.abs() + GATE_ATOL)).max().item()

    assert over_gate(_tensor_core_pv(q, k, v, parts=1)) > 10.0
    assert over_gate(_tensor_core_pv(q, k, v, parts=3)) <= 1.0


def test_two_bf16_parts_of_p_miss_the_gate_floor_and_three_do_not():
    """hi + lo keeps 16 of p's 24 bits: summed exactly (float64), P.V / l
    with p in two parts is off the same sum over the f32 p by more than the
    gate's floor (1e-6, the room an output near 0 has), where hi + mid + lo
    is p itself.  Causal (1, 1024, 1, 4, 128), drawn as ``chip_smoke.py``
    draws it: the early rows average few keys, so the parts' rounding
    errors do not cancel."""
    q, k, v = _draw_bf16((1, 1024, 1, 4, 128), (1, 1024, 1, 128), 1)
    p, l = _causal_p(q, k)

    def err(pieces):
        pv = torch.einsum("bkgqc,bckh->bkgqh", sum(x.double() for x in pieces), v.double())
        exact = torch.einsum("bkgqc,bckh->bkgqh", p.double(), v.double())
        return ((pv - exact) / l.double()[..., None]).abs().max().item()

    assert err(_bf16_parts(p, 2)) > GATE_ATOL
    assert err(_bf16_parts(p, 3)) == 0.0


MAX_SMEM = 232448  # kMaxSmem: 227 KB, a block's shared-memory limit on Hopper
STATIC_SMEM = 1024  # kStaticSmem: kept free for the kernels' static arrays
FOLD_TILE = 64  # kFoldTile
L2_BYTES = 50 * 2**20  # the H100's L2


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
    """(name, P, page, KVH, G, hd) of the served configs' decode pools: the
    served 16-page pool and the config's own ``bounded_kv_pages``."""
    for cfg in (smollm_360m.CONFIG, gemma3_27b.CONFIG, qwen25_14b.CONFIG,
                zamba2_7b.CONFIG):
        for P in (16, cfg.bounded_kv_pages):
            yield (cfg.name, P, cfg.page_size, cfg.n_kv_heads,
                   cfg.n_heads // cfg.n_kv_heads, cfg.head_dim)


def decode_smem(page, KVH, G, hd, esize, *, lanes):
    """Kernel 5's partials launch, dynamic shared memory (``adaptive_attn.cu``
    ``launch``): kernels 3 and 4's partials carve, plus, at a page boundary,
    its sequence's ARC/CAR directory, 5 planes of ``lanes`` ints (``lanes``
    0: a mid-page step, which carves none)."""
    return split_smem(page, KVH, G, hd, esize)[0] + 5 * lanes * 4


SPLIT_BLOCKS = 8  # kSplitBlocks: 64 registers a thread, 8 CTAs of 128 per SM


def ctas_per_sm(nbytes):
    """Partials CTAs of ``nbytes`` dynamic shared memory an SM holds: its
    228 KB of shared memory, and at most SPLIT_BLOCKS by registers."""
    return min(228 * 1024 // (nbytes + STATIC_SMEM), SPLIT_BLOCKS)


@pytest.mark.parametrize("esize", [2, 4])
@pytest.mark.parametrize("shape", list(_decode_shapes()), ids=lambda s: f"{s[0]}-P{s[1]}")
def test_decode_kernels_shared_memory_fits_a_block(shape, esize):
    """Kernel 5 runs on kernels 3 and 4's schedule: mid-page its partials
    CTA carves exactly kernel 4's shared memory; at a page boundary it adds
    the directory (L = 2P lanes), which at the served 16-page pools leaves
    the CTAs per SM unchanged (8 or more at smollm's in bf16), and which fits
    a block at every served shape and at P=256 with L=1024 lanes.  The
    fold's last CTA keeps the hit pages and the directory (P + 5L ints) in
    its two P.V buffers."""
    _, P, page, KVH, G, hd = shape
    mid = decode_smem(page, KVH, G, hd, esize, lanes=0)
    assert mid == split_smem(page, KVH, G, hd, esize)[0]
    boundary = decode_smem(page, KVH, G, hd, esize, lanes=2 * P)
    assert boundary + STATIC_SMEM <= MAX_SMEM, (shape, esize, boundary)
    if P == 16:  # the served pools
        assert ctas_per_sm(boundary) == ctas_per_sm(mid), (shape, esize)
    if KVH * hd * esize <= 640:  # smollm in bf16
        assert ctas_per_sm(mid) == SPLIT_BLOCKS
        if P == 16:
            assert ctas_per_sm(boundary) == SPLIT_BLOCKS
    assert decode_smem(page, KVH, G, hd, esize, lanes=1024) + STATIC_SMEM <= MAX_SMEM
    fold_buffers = 2 * FOLD_TILE * 64  # floats
    assert P + 5 * 2 * P <= fold_buffers and 256 + 5 * 1024 <= fold_buffers


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
