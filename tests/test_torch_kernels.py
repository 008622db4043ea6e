"""The decode kernels' plain PyTorch versions against the JAX reference
kernels (``repro.kernels.ops`` in Pallas interpret mode, and the plain
softmax ``repro.kernels.ref.ref_paged_attention``), on the CPU, at the
shapes of ``tests/test_policy_attn.py``.

Floats (out, mass) agree within RTOL/ATOL (2e-5, f32 summation order).
Planes agree bitwise, except at a step where some page's JAX mass lies
within EPS_TAU of tau = 1/residents; every step restarts from the JAX
planes, so such a step cannot carry over.

The ``cuda``-marked tests hold the CUDA kernels against the same plain
versions on a card and skip without one.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.cache import paged_kv as jpk  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.cache import paged_kv as tpk  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

torch.set_num_threads(2)

POLICIES = ("awrp", "lru", "fifo", "lfu", "arc", "car")
B, P, PAGE, KVH, G, HD = 2, 4, 4, 2, 2, 8
KVD = KVH * HD
RTOL = ATOL = 2e-5
EPS_TAU = 1e-5


def t(a):
    return torch.from_numpy(np.array(a))


def random_pool(rng, *, n_free=1, pos=None):
    """Pages of seeded K/V with shuffled starts (``n_free`` free per row)
    and the decode position after the last resident token."""
    k = rng.standard_normal((B, P, PAGE, KVH, HD)).astype(np.float32) * 0.5
    v = rng.standard_normal((B, P, PAGE, KVH, HD)).astype(np.float32) * 0.5
    ps = np.stack([rng.permutation(P) for _ in range(B)]).astype(np.int32) * PAGE
    ps[:, :n_free] = -1
    cur = np.full((B,), P * PAGE - 1 - (pos or 0), np.int32)
    q = rng.standard_normal((B, KVH, G, HD)).astype(np.float32)
    return q, k, v, ps, cur


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("n_free", [0, 1, 3])
def test_paged_attention_plain_matches_reference(seed, n_free):
    rng = np.random.default_rng(seed)
    q, k, v, ps, cur = random_pool(rng, n_free=n_free, pos=seed)
    out, mass = ref.paged_attention_plain(t(q), t(k), t(v), t(ps), t(cur))
    out_j, mass_j = jops.paged_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         jnp.asarray(ps), jnp.asarray(cur), interpret=True)
    out_r, mass_r = jref.ref_paged_attention(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v), jnp.asarray(ps),
                                             jnp.asarray(cur))
    np.testing.assert_allclose(out.numpy(), out_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(mass.numpy(), mass_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out.numpy(), out_r, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(mass.numpy(), mass_r, rtol=RTOL, atol=ATOL)
    # the port's own plain softmax agrees too
    out_p, mass_p = ref.ref_paged_attention(t(q), t(k), t(v), t(ps), t(cur))
    np.testing.assert_allclose(out_p.numpy(), out_r, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(mass_p.numpy(), mass_r, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_paged_attention_plain_matches_reference(policy):
    """The fused step's plain version against JAX's fused Pallas kernel,
    from an empty pool to 3 pages past capacity (every later boundary
    evicts)."""
    rng = np.random.default_rng(7)
    jp = jpk.init_pool(B, P, PAGE, KVD, jnp.float32)
    near_tau = 0
    for pos in range(P * PAGE + 3 * PAGE):
        q = rng.standard_normal((B, KVH, G, HD)).astype(np.float32)
        nk = (rng.standard_normal((B, KVH, HD)) * 0.3).astype(np.float32)
        nv = (rng.standard_normal((B, KVH, HD)) * 0.3).astype(np.float32)
        kp = np.asarray(jp.k).reshape(B, P, PAGE, KVH, HD)
        vp = np.asarray(jp.v).reshape(B, P, PAGE, KVH, HD)
        got = ref.policy_paged_attention_plain(
            t(q), t(kp), t(vp), t(nk), t(nv), pos, t(jp.f), t(jp.r),
            t(jp.page_start), t(jp.clock), t(jp.open_slot), policy=policy)
        want = jops.policy_paged_attention(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(nk),
            jnp.asarray(nv), jnp.int32(pos), jp.f, jp.r, jp.page_start, jp.clock,
            jp.open_slot, policy=policy, interpret=True)
        np.testing.assert_allclose(got[0].numpy(), want[0], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got[1].numpy(), want[1], rtol=RTOL, atol=ATOL)
        resident = np.maximum((np.asarray(want[5]) >= 0).sum(-1, keepdims=True), 1)
        tau = np.float32(1.0) / resident.astype(np.float32)
        if np.any(np.abs(np.asarray(want[1]) - tau) < EPS_TAU):
            near_tau += 1
        else:
            for name, a, b in zip(("slot", "f", "r", "page_start", "clock", "open"),
                                  got[2:], want[2:]):
                assert np.array_equal(a.numpy(), np.asarray(b)), (pos, name)
                assert a.dtype == torch.int32, name
        # advance the reference pool (the JAX planes drive both sides)
        jp = jpk._scatter_new_token(jp, jnp.asarray(nk.reshape(B, KVD)),
                                    jnp.asarray(nv.reshape(B, KVD)), jnp.int32(pos),
                                    PAGE, *want[2:])
    assert near_tau <= 2, f"{near_tau} steps near tau"


@pytest.mark.parametrize("policy", POLICIES)
def test_plain_fused_equals_unfused_chain_bitwise(policy):
    """On the CPU the fused plain step equals insert_token + plain
    paged_attention + score_update bit for bit, the contract the CUDA
    kernels hold on the card."""
    rng = np.random.default_rng(9)
    pool_f = tpk.init_pool(B, P, PAGE, KVD, torch.float32, device="cpu")
    pool_u = pool_f.clone()
    for pos in range(P * PAGE + 2 * PAGE):
        q = t(rng.standard_normal((B, KVH, G, HD)).astype(np.float32))
        nk = t((rng.standard_normal((B, KVD)) * 0.3).astype(np.float32))
        nv = t((rng.standard_normal((B, KVD)) * 0.3).astype(np.float32))
        out_f, mass_f, pool_f = tpk.fused_decode_step(pool_f, q, nk, nv, pos, PAGE,
                                                      policy)
        pool_u = tpk.insert_token(pool_u, nk, nv, pos, PAGE, policy)
        cur = torch.full((B,), pos, dtype=torch.int32)
        out_u, mass_u = ops.paged_attention(q, pool_u.k.view(B, P, PAGE, KVH, HD),
                                            pool_u.v.view(B, P, PAGE, KVH, HD),
                                            pool_u.page_start, cur)
        row_mass = torch.zeros((B, P, PAGE))
        row_mass[:, :, 0] = mass_u
        pool_u = tpk.score_update(pool_u, row_mass.reshape(B, -1), PAGE)
        assert torch.equal(out_f, out_u) and torch.equal(mass_f, mass_u)
        for name, a, b in zip(pool_f._fields, pool_f, pool_u):
            assert torch.equal(a, b), (pos, name)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    rng = np.random.default_rng(1)
    q, k, v, ps, cur = random_pool(rng)
    before = dict(ops.LAUNCHES)
    out, mass = ops.paged_attention(t(q), t(k), t(v), t(ps), t(cur))
    want = ref.paged_attention_plain(t(q), t(k), t(v), t(ps), t(cur))
    assert torch.equal(out, want[0]) and torch.equal(mass, want[1])
    assert ops.LAUNCHES == before


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_paged_attention_matches_plain(cuda_device, dtype):
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(2)
    q, k, v, ps, cur = (t(x).to(cuda_device) for x in random_pool(rng, n_free=1))
    q, k, v = q.to(dt), k.to(dt), v.to(dt)
    before = ops.LAUNCHES["paged_attention"]
    out, mass = ops.paged_attention(q, k, v, ps, cur)
    assert ops.LAUNCHES["paged_attention"] == before + 1
    out_p, mass_p = ref.paged_attention_plain(q, k, v, ps, cur)
    tol = 2e-5 if dtype == "float32" else 1e-2
    torch.testing.assert_close(out.float(), out_p.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(mass, mass_p, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", POLICIES)
def test_cuda_fused_equals_unfused_bitwise(cuda_device, policy):
    rng = np.random.default_rng(4)
    pool_f = tpk.init_pool(B, P, PAGE, KVD, torch.float32, device=cuda_device)
    pool_u = pool_f.clone()
    for pos in range(P * PAGE + 2 * PAGE):
        q = t(rng.standard_normal((B, KVH, G, HD)).astype(np.float32)).to(cuda_device)
        nk = t((rng.standard_normal((B, KVD)) * 0.3).astype(np.float32)).to(cuda_device)
        nv = t((rng.standard_normal((B, KVD)) * 0.3).astype(np.float32)).to(cuda_device)
        out_f, mass_f, pool_f = tpk.fused_decode_step(pool_f, q, nk, nv, pos, PAGE,
                                                      policy)
        pool_u = tpk.insert_token(pool_u, nk, nv, pos, PAGE, policy)
        cur = torch.full((B,), pos, dtype=torch.int32, device=cuda_device)
        out_u, mass_u = ops.paged_attention(q, pool_u.k.view(B, P, PAGE, KVH, HD),
                                            pool_u.v.view(B, P, PAGE, KVH, HD),
                                            pool_u.page_start, cur)
        row_mass = torch.zeros((B, P, PAGE), device=cuda_device)
        row_mass[:, :, 0] = mass_u
        pool_u = tpk.score_update(pool_u, row_mass.reshape(B, -1), PAGE)
        assert torch.equal(out_f, out_u) and torch.equal(mass_f, mass_u)
        for name, a, b in zip(pool_f._fields, pool_f, pool_u):
            assert torch.equal(a, b), (pos, name)
