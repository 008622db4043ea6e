"""Kernels 3-5 at the head groups and head dim of the QKV-bias, Mamba-2 and
VLM families, on the CPU: their plain PyTorch versions against the JAX
reference kernels (``repro.kernels.ops`` in Pallas interpret mode) at
zamba2's shared attention (G = 1, hd = 112: the fold's second 64-dim slice
is partial, 48 dims), qwen2.5's (G = 5, hd = 128), yi's (G = 7, hd = 128)
and internvl2's (G = 6, hd = 128), in float32 within RTOL/ATOL; planes bitwise except at a step whose
JAX mass lies within EPS_TAU of tau (counted).  Kernel 6 at these shapes
is one more input of ``tests/test_torch_flash.py``'s reference test.

The ``cuda``-marked tests hold the CUDA kernels against the same plain
versions at these groups on a card, and skip without one.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.cache import paged_kv as jpk  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.cache import paged_kv as tpk  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

torch.set_num_threads(2)

#: (G, hd) of zamba2's shared attention, qwen2.5, yi and internvl2
GROUPS = [(1, 112), (5, 128), (7, 128), (6, 128)]
B, P, PAGE, KVH = 2, 3, 4, 2
RTOL = ATOL = 2e-5
EPS_TAU = 1e-5


def t(a):
    return torch.from_numpy(np.array(a))


def ipos(p: int, device="cpu") -> torch.Tensor:
    return torch.tensor(p, dtype=torch.int32, device=device)


@pytest.fixture(autouse=True, scope="module")
def _settle_torch_exp():
    """One einsum and exp first (``tests/test_torch_flash.py``): torch's
    first CPU exp after a process's first einsum is sometimes off."""
    x = torch.ones((1, 64, 2, 2, 32))
    torch.exp(torch.einsum("bqkgh,bckh->bkgqc", x, x[:, :, :, 0]))


@pytest.mark.parametrize("G,hd", GROUPS)
def test_paged_attention_plain_matches_reference(G, hd):
    rng = np.random.default_rng(G)
    q = rng.standard_normal((B, KVH, G, hd)).astype(np.float32)
    k, v = ((rng.standard_normal((B, P, PAGE, KVH, hd)) * 0.5).astype(np.float32)
            for _ in range(2))
    ps = np.stack([rng.permutation(P) for _ in range(B)]).astype(np.int32) * PAGE
    ps[:, 0] = -1
    cur = np.array([P * PAGE - 1, P * PAGE - 3], np.int32)
    out, mass = ref.paged_attention_plain(t(q), t(k), t(v), t(ps), t(cur))
    out_j, mass_j = jops.paged_attention(*map(jnp.asarray, (q, k, v, ps, cur)),
                                         interpret=True)
    np.testing.assert_allclose(out.numpy(), out_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(mass.numpy(), mass_j, rtol=RTOL, atol=ATOL)


def _steps(G, hd, seed):
    rng = np.random.default_rng(seed)
    for pos in range((P + 2) * PAGE):
        yield (pos, rng.standard_normal((B, KVH, G, hd)).astype(np.float32),
               (rng.standard_normal((B, KVH, hd)) * 0.3).astype(np.float32),
               (rng.standard_normal((B, KVH, hd)) * 0.3).astype(np.float32))


def _near_tau(mass, page_start) -> bool:
    ps = np.asarray(page_start)
    tau = np.float32(1.0) / np.maximum((ps >= 0).sum(-1, keepdims=True), 1).astype(np.float32)
    return bool(np.any((np.abs(np.asarray(mass) - tau) < EPS_TAU) & (ps >= 0)))


@pytest.mark.parametrize("G,hd", GROUPS)
def test_policy_paged_attention_plain_matches_reference(G, hd):
    """AWRP from an empty pool to two pages past capacity (both later
    boundaries evict); every step restarts from the JAX planes."""
    kvd = KVH * hd
    jp = jpk.init_pool(B, P, PAGE, kvd, jnp.float32)
    near_tau = 0
    for pos, q, nk, nv in _steps(G, hd, 7):
        kp = np.asarray(jp.k).reshape(B, P, PAGE, KVH, hd)
        vp = np.asarray(jp.v).reshape(B, P, PAGE, KVH, hd)
        got = ref.policy_paged_attention_plain(
            t(q), t(kp), t(vp), t(nk), t(nv), ipos(pos), t(jp.f), t(jp.r),
            t(jp.page_start), t(jp.clock), t(jp.open_slot), policy="awrp")
        want = jops.policy_paged_attention(
            *map(jnp.asarray, (q, kp, vp, nk, nv)), jnp.int32(pos), jp.f, jp.r,
            jp.page_start, jp.clock, jp.open_slot, policy="awrp", interpret=True)
        np.testing.assert_allclose(got[0].numpy(), want[0], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got[1].numpy(), want[1], rtol=RTOL, atol=ATOL)
        if _near_tau(want[1], want[5]):
            near_tau += 1
        else:
            for name, a, b in zip(("slot", "f", "r", "page_start", "clock", "open"),
                                  got[2:], want[2:]):
                assert np.array_equal(a.numpy(), np.asarray(b)), (pos, name)
        jp = jpk._scatter_new_token(jp, jnp.asarray(nk.reshape(B, kvd)),
                                    jnp.asarray(nv.reshape(B, kvd)), jnp.int32(pos),
                                    PAGE, *want[2:])
    assert int(np.asarray(jp.clock).min()) == (P + 2) * PAGE
    assert near_tau <= 2, f"{near_tau} steps near tau"


@pytest.mark.parametrize("G,hd", GROUPS)
def test_adaptive_plain_matches_reference_kernel(G, hd):
    """Kernel 5 (arc) from an empty pool to two pages past capacity against
    JAX's fused adaptive step in interpret mode; every step restarts from
    the JAX pool."""
    kvd = KVH * hd
    jcore = jpk.adaptive_core("arc_adaptive", B, P)
    tcore = tpk.adaptive_core("arc_adaptive", B, P)
    step = jax.jit(lambda ap, q, k, v, pos: jpk.fused_adaptive_decode_step(
        ap, q, k, v, pos, PAGE, jcore, interpret=True))
    jap = jpk.init_adaptive_pool(B, P, PAGE, kvd, jnp.float32, "arc_adaptive")
    near_tau = 0
    for pos, q, nk, nv in _steps(G, hd, 13):
        tap = tpk.AdaptivePagedPool(
            tpk.PagedPool(*(t(np.asarray(a)) for a in jap.pool)),
            tpk.AdaptiveState(*(t(np.asarray(a)) for a in jap.policy)))
        out_t, mass_t, tap = tpk.fused_adaptive_decode_step(
            tap, t(q), t(nk.reshape(B, kvd)), t(nv.reshape(B, kvd)), ipos(pos), PAGE, tcore)
        out_j, mass_j, jap = step(jap, jnp.asarray(q), jnp.asarray(nk.reshape(B, kvd)),
                                  jnp.asarray(nv.reshape(B, kvd)), jnp.int32(pos))
        np.testing.assert_allclose(out_t.numpy(), out_j, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(mass_t.numpy(), mass_j, rtol=RTOL, atol=ATOL)
        if _near_tau(mass_j, jap.pool.page_start):
            near_tau += 1
            continue
        for part_t, part_j in ((tap.pool, jap.pool), (tap.policy, jap.policy)):
            for name, a, b in zip(part_j._fields, part_t, part_j):
                if name not in ("k", "v"):
                    assert np.array_equal(a.numpy(), np.asarray(b)), (pos, name)
    assert near_tau <= 2, f"{near_tau} steps near tau"


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,hd", GROUPS)
def test_cuda_kernels_3_to_6_match_plain_at_group(cuda_device, G, hd, dtype):
    """Kernels 3 and 4 (AWRP, a page boundary of a full pool) and kernel 6
    (causal, S = 200) against their plain versions on the card: one bf16
    ulp of the output (f32: summation order), the mass within f32
    summation order, kernel 4's planes bitwise."""
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(G * hd)

    def rnd(*shape, s=1.0):
        return (torch.randn(*shape, generator=g) * s).to(dt).to(cuda_device)

    rtol, atol = (2.0 ** -7, 1e-6) if dtype == "bfloat16" else (1e-4, 1e-5)
    Bc, Pc, page = 2, 4, 16
    q, k, v = rnd(Bc, KVH, G, hd), rnd(Bc, Pc, page, KVH, hd, s=0.5), \
        rnd(Bc, Pc, page, KVH, hd, s=0.5)
    ps = torch.stack([torch.randperm(Pc, generator=g) * page for _ in range(Bc)])
    ps = ps.to(torch.int32).to(cuda_device)
    cur = torch.full((Bc,), Pc * page - 1, dtype=torch.int32, device=cuda_device)
    got, want = ops.paged_attention(q, k, v, ps, cur), ref.paged_attention_plain(
        q, k, v, ps, cur)
    torch.testing.assert_close(got[0].float(), want[0].float(), rtol=rtol, atol=atol)
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-7)
    nk = rnd(Bc, KVH, hd, s=0.3)
    f = torch.randint(1, 9, (Bc, Pc), dtype=torch.int32).to(cuda_device)
    r = torch.randint(1, 60, (Bc, Pc), dtype=torch.int32).to(cuda_device)
    clock = torch.full((Bc,), 64, dtype=torch.int32, device=cuda_device)
    args = (q, k, v, nk, nk, ipos(Pc * page, cuda_device), f, r, ps, clock,
            ps.argmax(dim=-1).to(torch.int32))
    got = ops.policy_paged_attention(*args, policy="awrp")
    want = ref.policy_paged_attention_plain(*args, policy="awrp")
    torch.testing.assert_close(got[0].float(), want[0].float(), rtol=rtol, atol=atol)
    for a, b in zip(got[2:], want[2:]):
        assert torch.equal(a, b)
    qf = rnd(1, 200, KVH, G, hd)
    kf, vf = rnd(1, 200, KVH, hd, s=0.5), rnd(1, 200, KVH, hd, s=0.5)
    out = ops.flash_attention(qf, kf, vf, causal=True)
    torch.testing.assert_close(out.float(), ref.flash_attention_plain(
        qf, kf, vf, causal=True).float(), rtol=rtol, atol=atol)
