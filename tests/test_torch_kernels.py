"""The kernels' plain PyTorch versions against the JAX reference kernels
(``repro.kernels.ops`` in Pallas interpret mode, and the plain oracles of
``repro.kernels.ref``), on the CPU: the decode kernels at the shapes of
``tests/test_policy_attn.py``, the AWRP victim selection (kernels 1 and 2)
exactly, tie-heavy and all-invalid rows and ragged lane counts included.

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
from repro_torch.core.kv_policy import PAGE_POLICIES, page_victim  # noqa: E402
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


# -- AWRP victim selection (kernels 1 and 2) ---------------------------------


def select_inputs(rng, B, P, *, ties=False, all_invalid_rows=(), pinned=True):
    """Seeded (f, r, clock, valid[, pinned]) int32 metadata.  ``ties`` draws
    F in 1..3 and R in 0..4 with the clock in 5..8, so many weights
    F/(N-R) are exactly equal; ``all_invalid_rows`` mask every lane."""
    if ties:
        f = rng.randint(1, 4, size=(B, P))
        r = rng.randint(0, 5, size=(B, P))
        clock = rng.randint(5, 9, size=(B,))
    else:
        f = rng.randint(1, 50, size=(B, P))
        r = rng.randint(0, 100, size=(B, P))
        clock = rng.randint(101, 200, size=(B,))
    valid = (rng.rand(B, P) < 0.85).astype(np.int32)
    valid[:, 0] = 1
    valid[list(all_invalid_rows)] = 0
    out = [f.astype(np.int32), r.astype(np.int32), clock.astype(np.int32), valid]
    if pinned:
        pin = (rng.rand(B, P) < 0.15).astype(np.int32) * valid
        pin[:, 0] = 0
        out.append(pin)
    return out


SELECT_SHAPES = [(1, 1), (1, 8), (4, 64), (3, 130), (13, 30), (9, 240), (32, 256)]


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("B,P", SELECT_SHAPES)
def test_awrp_select_plain_matches_reference(B, P, ties):
    """Kernel 1's plain version == the Pallas kernel in interpret mode and
    the float-argmin oracle, exactly; an all-invalid row gives lane 0."""
    rng = np.random.RandomState(B * 1000 + P + ties)
    dead = (B - 1,) if B > 1 else ()
    args = select_inputs(rng, B, P, ties=ties, all_invalid_rows=dead)
    got = ref.awrp_select_plain(*map(t, args))
    want = jops.awrp_select(*map(jnp.asarray, args), interpret=True)
    oracle = jref.ref_awrp_select(*map(jnp.asarray, args))
    assert got.dtype == torch.int32 and got.shape == (B,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.asarray(oracle))
    if dead:
        assert int(got[-1]) == 0
    # the dispatch sends CPU tensors to the plain version, launching nothing
    before = dict(ops.LAUNCHES)
    assert torch.equal(ops.awrp_select(*map(t, args)), got)
    assert ops.LAUNCHES == before


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("B,P", SELECT_SHAPES)
def test_awrp_select_rows_plain_matches_reference(B, P, ties):
    """Kernel 2's plain version == the Pallas rows kernel in interpret mode
    and its oracle, exactly (no lane padding on the port's side)."""
    rng = np.random.RandomState(B * 77 + P + ties)
    dead = (0,) if B > 2 else ()
    args = select_inputs(rng, B, P, ties=ties, all_invalid_rows=dead, pinned=False)
    got = ref.awrp_select_rows_plain(*map(t, args))
    want = jops.awrp_select_rows(*map(jnp.asarray, args), interpret=True)
    oracle = jref.ref_awrp_select_rows(*map(jnp.asarray, args))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.asarray(oracle))
    before = dict(ops.LAUNCHES)
    assert torch.equal(ops.awrp_select_rows(*map(t, args)), got)
    assert ops.LAUNCHES == before


def test_awrp_select_plain_matches_host_policy():
    """Plain kernel 1 == the numpy AWRP oracle's victim, bit-exact
    (``tests/test_kernels.py`` mirrored, on the port's own oracle)."""
    from repro_torch.core.policies import AWRP

    rng = np.random.RandomState(7)
    for _ in range(25):
        P = rng.randint(2, 40)
        clock = rng.randint(P + 1, 300)
        f = rng.randint(1, 30, size=P).astype(np.int32)
        r = rng.randint(0, clock, size=P).astype(np.int32)
        host = AWRP(P)
        host.blocks = np.arange(P, dtype=np.int64)
        host.F, host.R, host.clock = f.astype(np.int64), r.astype(np.int64), clock
        got = ref.awrp_select_plain(t(f)[None], t(r)[None], t([clock]).to(torch.int32),
                                    torch.ones((1, P), dtype=torch.int32),
                                    torch.zeros((1, P), dtype=torch.int32))
        assert int(got[0]) == host.victim_slot()


@pytest.mark.parametrize("seed", range(5))
def test_awrp_select_tiebreak_parity_with_page_victim(seed):
    """Plain kernel 1 on tie-heavy metadata == the port's
    ``page_victim("awrp")`` on both of its routes (``tests/test_kernels.py``
    mirrored): any first-index divergence shows up here."""
    rng = np.random.RandomState(seed)
    B, P = 8, 24
    f, r, clock, valid, pinned = select_inputs(rng, B, P, ties=True)
    got = ref.awrp_select_plain(t(f), t(r), t(clock), t(valid), t(pinned))
    page_start = t(np.where(valid != 0, np.arange(P, dtype=np.int32)[None], -1))
    for use_kernel in (False, True):
        want = page_victim("awrp", t(f), t(r), page_start, t(clock), t(pinned) != 0,
                           use_kernel=use_kernel)
        assert torch.equal(got, want), use_kernel


@pytest.mark.parametrize("policy", PAGE_POLICIES)
def test_page_victim_routes_agree(policy):
    """``page_victim``'s kernel route (the rows kernel's plain version on the
    CPU) and its inline route pick the same page for every page policy, and
    both equal the JAX ``page_victim``."""
    from repro.core.kv_policy import page_victim as jpage_victim

    rng = np.random.RandomState(3)
    B, P = 6, 20
    for ties in (False, True):
        f, r, clock, valid, pinned = select_inputs(rng, B, P, ties=ties)
        page_start = np.where(valid != 0, rng.permutation(P).astype(np.int32)[None] * 4,
                              -1).astype(np.int32)
        args = (t(f), t(r), t(page_start), t(clock), t(pinned) != 0)
        inline = page_victim(policy, *args)
        routed = page_victim(policy, *args, use_kernel=True)
        want = jpage_victim(policy, *map(jnp.asarray, (f, r, page_start, clock)),
                            jnp.asarray(pinned != 0), use_kernel=False)
        assert torch.equal(inline, routed)
        np.testing.assert_array_equal(inline.numpy(), np.asarray(want))


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


@pytest.mark.cuda
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("B,P", SELECT_SHAPES + [(2048, 240)])
def test_cuda_awrp_select_kernels_match_plain(cuda_device, B, P, ties):
    """Both CUDA kernels == their plain versions on the card, exactly."""
    rng = np.random.RandomState(B + P + ties)
    args = [t(a).to(cuda_device) for a in select_inputs(
        rng, B, P, ties=ties, all_invalid_rows=(0,) if B > 1 else ())]
    before = dict(ops.LAUNCHES)
    got1 = ops.awrp_select(*args)
    got2 = ops.awrp_select_rows(*args[:4])
    assert ops.LAUNCHES["awrp_select"] == before["awrp_select"] + 1
    assert ops.LAUNCHES["awrp_select_rows"] == before["awrp_select_rows"] + 1
    assert torch.equal(got1, ref.awrp_select_plain(*args))
    assert torch.equal(got2, ref.awrp_select_rows_plain(*args[:4]))
