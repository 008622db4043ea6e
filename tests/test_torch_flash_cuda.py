"""Kernel 6's CUDA forward (``csrc/flash_attn.cu``), with no JAX import so
that it runs on the card's machine: ``python -m pytest -m cuda --noconftest
tests/test_torch_flash_cuda.py`` with ``PYTHONPATH=src``.

On a card (``cuda``-marked, skipped without one): the kernel against its
plain version, f32 and bf16, through ``ops.flash_attention`` (one launch);
the bf16 kernel at every head dim it takes (64, 112, 128, 256), at G = 1,
5, 6 and 7 (a warpgroup's idle rows), at Sq != Skv and under ``kv_len``,
each within one bf16 ulp, ``out`` equal with ``lse`` on and off, and a
repeated launch equal bit for bit.

On the CPU: the wrapper refuses q / k / v whose TMA strides are not
multiples of 16 bytes (the head dims it takes imply them), and the bf16
forward's source is built on TMA and ``wgmma`` (the ``mma.sync`` forward is
gone).
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attn import HEAD_DIMS, flash_attention_kernel  # noqa: E402

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"

# one bf16 ulp of the plain value plus a floor (chip_smoke's OUT_RTOL /
# OUT_ATOL); f32: the f32 summation order
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-6
F32_RTOL, F32_ATOL = 1e-4, 1e-5


def _inputs(seed, B, Sq, KVH, G, hd, Skv=None):
    """Seeded q (B, Sq, KVH, G, hd) and k/v (B, Skv, KVH, hd), f32 numpy."""
    rng = np.random.default_rng(seed)
    Skv = Sq if Skv is None else Skv
    q = rng.standard_normal((B, Sq, KVH, G, hd)).astype(np.float32)
    k = (rng.standard_normal((B, Skv, KVH, hd)) * 0.3).astype(np.float32)
    v = (rng.standard_normal((B, Skv, KVH, hd)) * 0.3).astype(np.float32)
    return q, k, v


def _bf16_forward_source() -> str:
    """``flash_attn.cu`` from the bf16 forward's section to the f32 one."""
    text = (CSRC / "flash_attn.cu").read_text()
    start = text.index("// ---- bf16:")
    return text[start:text.index("// ---- f32:", start)]


def test_bf16_forward_source_uses_tma_and_wgmma():
    src = _bf16_forward_source()
    assert "wgmma.mma_async" in src and "cp.async.bulk.tensor" in src
    assert "setmaxnreg" in src and "mbarrier.try_wait" in src
    text = (CSRC / "flash_attn.cu").read_text()
    for gone in ("mma_bf16(", "ldsm_x4", "cp_async16("):  # the mma.sync forward's
        assert gone not in text, gone


@pytest.mark.parametrize("KVH,G,hd", [(1, 1, 4), (3, 1, 4), (1, 3, 4)])
def test_wrapper_refuses_strides_tma_cannot_take(KVH, G, hd):
    """A head of 8 bytes: no TMA global stride may be anything but a
    multiple of 16 bytes; the wrapper refuses the head dim before it looks
    at the device."""
    q = torch.zeros((1, 8, KVH, G, hd), dtype=torch.bfloat16)
    k = torch.zeros((1, 8, KVH, hd), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported shapes"):
        flash_attention_kernel(q, k, k, causal=True, window=0)


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_served_shapes_have_tma_strides(hd):
    """Every head dim the kernel takes gives TMA's 16-byte global strides
    at any KVH and G: a head, a k/v row (KVH heads) and a q row (KVH * G
    heads) are whole heads of hd * 2 bytes, so the wrapper needs no stride
    check of its own."""
    assert hd * 2 % 16 == 0


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
    rtol, atol = (BF16_RTOL, BF16_ATOL) if dtype == "bfloat16" else (F32_RTOL, F32_ATOL)
    torch.testing.assert_close(out.float(), want.float(), rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,Skv,causal,window,kv_len", [
    ((2, 300, 4, 1, 112), None, True, 0, None),    # zamba2's head dim: a partial box
    ((1, 200, 2, 2, 256), None, True, 0, None),    # 32-key tiles
    ((2, 257, 2, 5, 128), None, True, 0, None),    # G = 5: 60 of 64 rows
    ((1, 190, 2, 6, 128), None, True, 40, None),   # G = 6, a window
    ((1, 150, 2, 7, 128), None, False, 0, 100),    # G = 7, kv_len
    ((2, 70, 3, 1, 64), 333, False, 0, None),      # cross-attention, Sq < Skv
    ((1, 333, 3, 2, 64), 70, True, 0, None),       # Sq > Skv
    ((1, 64, 1, 1, 64), None, False, 0, 0),        # every row masked
])
def test_cuda_bf16_forward_every_head_dim_and_group(cuda_device, shape, Skv, causal, window,
                                                    kv_len):
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16).to(cuda_device)
               for a in _inputs(9, *shape, Skv=Skv))
    kw = {"causal": causal, "window": window, "kv_len": kv_len}
    out = flash_attention_kernel(q, k, v, **kw)
    out_lse, lse = flash_attention_kernel(q, k, v, **kw, return_lse=True)
    want, want_lse = ref.flash_attention_plain(q, k, v, **kw, return_lse=True)
    again = flash_attention_kernel(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, out_lse) and torch.equal(out, again)
    torch.testing.assert_close(out.float(), want.float(), rtol=BF16_RTOL, atol=BF16_ATOL)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-6)
