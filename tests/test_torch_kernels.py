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

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.cache import paged_kv as jpk  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.cache import paged_kv as tpk  # noqa: E402
from repro_torch.core import policy_core  # noqa: E402
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


def ipos(p: int, device="cpu") -> torch.Tensor:
    """A decode position as the port takes it: a 0-d int32 tensor."""
    return torch.tensor(p, dtype=torch.int32, device=device)


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
            t(q), t(kp), t(vp), t(nk), t(nv), ipos(pos), t(jp.f), t(jp.r),
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
        out_f, mass_f, pool_f = tpk.fused_decode_step(pool_f, q, nk, nv, ipos(pos),
                                                      PAGE, policy)
        pool_u = tpk.insert_token(pool_u, nk, nv, ipos(pos), PAGE, policy)
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


# -- kernel 5: the fused true-adaptive (ARC/CAR) step ------------------------

AP = 3  # adaptive pool pages (the reference's twin tests use P = 3, page 4)


def _unfused_adaptive_step(apool, q, nk, nv, pos, core):
    """adaptive_insert_token + paged attention + adaptive_score_update; the
    page mass goes in row 0 of each page so the hit rule's per-page sum is
    exact."""
    Bn, Pn = apool.pool.f.shape
    apool = tpk.adaptive_insert_token(apool, nk, nv, pos, PAGE, core)
    cur = pos.expand(Bn)
    out, mass = ops.paged_attention(q, apool.pool.k.view(Bn, Pn, PAGE, KVH, HD),
                                    apool.pool.v.view(Bn, Pn, PAGE, KVH, HD),
                                    apool.pool.page_start, cur)
    row_mass = torch.zeros((Bn, Pn, PAGE), device=q.device)
    row_mass[:, :, 0] = mass
    return out, mass, tpk.adaptive_score_update(apool, row_mass.reshape(Bn, -1),
                                                PAGE, core)


def _ghost_seeded(kind, dev="cpu"):
    """A pool and policy state after the cross-request reseed of the churn
    stream (``p`` != 0, ghosts in the directory): the pool holds the reseed's
    target pages with seeded K/V.  Returns ``(apool, first decode pos)``."""
    kv_policy = f"{kind}_adaptive"
    core = tpk.adaptive_core(kv_policy, B, AP)
    churned, gh = tpk.replay_page_ids(core.init(device=dev), kv_policy, AP,
                                      [0, 1, 2, 0, 1, 3, 2, 4, 0, 5, 1])
    assert int(gh.min()) > 0
    n_have = 2 * AP
    state, _ = tpk.reseed_from_ghosts(churned, kv_policy, AP, n_have, AP)
    assert float(state.p.max()) > 0.0
    rng = np.random.default_rng(11)
    order = torch.arange(AP, dtype=torch.int32, device=dev)
    start = (n_have - AP) * PAGE
    pool = tpk.PagedPool(
        k=t((rng.standard_normal((B, AP, PAGE, KVD)) * 0.3).astype(np.float32)).to(dev),
        v=t((rng.standard_normal((B, AP, PAGE, KVD)) * 0.3).astype(np.float32)).to(dev),
        f=torch.ones((B, AP), dtype=torch.int32, device=dev),
        r=(order + 1).expand(B, AP).contiguous(),
        page_start=(start + order * PAGE).expand(B, AP).contiguous(),
        clock=torch.full((B,), AP, dtype=torch.int32, device=dev),
        open_slot=torch.full((B,), AP - 1, dtype=torch.int32, device=dev))
    return tpk.AdaptivePagedPool(pool, state), n_have * PAGE


def _adaptive_fused_vs_unfused(kind, dev, *, renorm_at="auto", seeded=False,
                               steps=(AP + 3) * PAGE, seed=9):
    """The fused step (kernel 5, or its plain version on the CPU) against the
    unfused chain from the same pool, bitwise on every output and plane."""
    core = tpk.adaptive_core(f"{kind}_adaptive", B, AP)
    if renorm_at != "auto":
        core = dataclasses.replace(core, renorm_at=renorm_at)
    if seeded:
        ap_f, start = _ghost_seeded(kind, dev)
    else:
        ap_f = tpk.init_adaptive_pool(B, AP, PAGE, KVD, torch.float32,
                                      f"{kind}_adaptive", device=dev)
        start = 0
    ap_u = ap_f.clone()
    rng = np.random.default_rng(seed)
    renorms0 = policy_core.HOST_SYNCS["renorm"]
    for pos in range(start, start + steps):
        q = t(rng.standard_normal((B, KVH, G, HD)).astype(np.float32)).to(dev)
        nk = t((rng.standard_normal((B, KVD)) * 0.3).astype(np.float32)).to(dev)
        nv = t((rng.standard_normal((B, KVD)) * 0.3).astype(np.float32)).to(dev)
        out_f, mass_f, ap_f = tpk.fused_adaptive_decode_step(ap_f, q, nk, nv,
                                                             ipos(pos, dev), PAGE, core)
        out_u, mass_u, ap_u = _unfused_adaptive_step(ap_u, q, nk, nv, ipos(pos, dev),
                                                     core)
        assert torch.equal(out_f, out_u) and torch.equal(mass_f, mass_u), pos
        for part_f, part_u in ((ap_f.pool, ap_u.pool), (ap_f.policy, ap_u.policy)):
            for name, a, b in zip(part_f._fields, part_f, part_u):
                assert a.dtype == b.dtype and torch.equal(a, b), (kind, pos, name)
    assert policy_core.HOST_SYNCS["renorm"] > renorms0
    return ap_f


@pytest.mark.parametrize("kind", ["arc", "car"])
def test_adaptive_plain_fused_equals_unfused_chain_bitwise(kind):
    """Kernel 5's plain version == adaptive_insert_token + plain paged
    attention + adaptive_score_update, bit for bit, through churn past
    capacity (the contract kernel 5 holds on the card)."""
    ap = _adaptive_fused_vs_unfused(kind, "cpu")
    assert int(ap.pool.page_start.max()) >= AP * PAGE  # evicted


@pytest.mark.parametrize("kind", ["arc", "car"])
def test_adaptive_plain_fused_equals_unfused_at_renorm_edge(kind):
    """The same with ``renorm_at=40``: the stamp renormalization fires inside
    the step (ctr is reset to L), and both sides agree."""
    ap = _adaptive_fused_vs_unfused(kind, "cpu", renorm_at=40)
    assert int(ap.policy.ctr.max()) < 40 + 2 * (AP + 2)


@pytest.mark.parametrize("kind", ["arc", "car"])
def test_adaptive_plain_fused_equals_unfused_from_ghost_seeded_state(kind):
    _adaptive_fused_vs_unfused(kind, "cpu", seeded=True, steps=2 * PAGE)


_JAX_STEPS = {}


def _jax_adaptive_step(core):
    """JAX's fused adaptive step (interpret mode), jitted once per core."""
    if core not in _JAX_STEPS:
        _JAX_STEPS[core] = jax.jit(lambda ap, q, k, v, pos: jpk.fused_adaptive_decode_step(
            ap, q, k, v, pos, PAGE, core, interpret=True))
    return _JAX_STEPS[core]


@pytest.mark.parametrize("kind,renorm_at,seeded", [
    ("arc", "auto", False), ("car", "auto", False), ("arc", 40, False),
    ("car", 36, False), ("arc", "auto", True), ("car", "auto", True)])
def test_adaptive_plain_matches_reference_kernel(kind, renorm_at, seeded):
    """Kernel 5's plain version against JAX's ``fused_adaptive_decode_step``
    (the Pallas kernel in interpret mode) at float32: out and mass within
    RTOL/ATOL; pool and policy planes bitwise, except at a step whose JAX
    mass lies within EPS_TAU of tau (counted).  Every step restarts from the
    JAX pool."""
    kv_policy = f"{kind}_adaptive"
    jcore = jpk.adaptive_core(kv_policy, B, AP)
    tcore = tpk.adaptive_core(kv_policy, B, AP)
    if renorm_at != "auto":
        jcore = dataclasses.replace(jcore, renorm_at=renorm_at)
        tcore = dataclasses.replace(tcore, renorm_at=renorm_at)
    if seeded:
        tap, start = _ghost_seeded(kind)
        steps = 2 * PAGE
    else:
        tap = tpk.init_adaptive_pool(B, AP, PAGE, KVD, torch.float32, kv_policy,
                                     device="cpu")
        start, steps = 0, (AP + 3) * PAGE
    jap = jpk.AdaptivePagedPool(
        pool=jpk.PagedPool(*(jnp.asarray(a.numpy()) for a in tap.pool)),
        policy=jpk.AdaptiveState(*(jnp.asarray(a.numpy()) for a in tap.policy)))
    step = _jax_adaptive_step(jcore)
    rng = np.random.default_rng(13)
    near_tau = 0
    for pos in range(start, start + steps):
        q = rng.standard_normal((B, KVH, G, HD)).astype(np.float32)
        nk = (rng.standard_normal((B, KVD)) * 0.3).astype(np.float32)
        nv = (rng.standard_normal((B, KVD)) * 0.3).astype(np.float32)
        tap = tpk.AdaptivePagedPool(
            tpk.PagedPool(*(t(np.asarray(a)) for a in jap.pool)),
            tpk.AdaptiveState(*(t(np.asarray(a)) for a in jap.policy)))
        out_t, mass_t, tap = tpk.fused_adaptive_decode_step(
            tap, t(q), t(nk), t(nv), ipos(pos), PAGE, tcore)
        out_j, mass_j, jap = step(jap, jnp.asarray(q), jnp.asarray(nk),
                                  jnp.asarray(nv), jnp.int32(pos))
        np.testing.assert_allclose(out_t.numpy(), out_j, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(mass_t.numpy(), mass_j, rtol=RTOL, atol=ATOL)
        ps = np.asarray(jap.pool.page_start)
        tau = np.float32(1.0) / np.maximum((ps >= 0).sum(-1, keepdims=True),
                                           1).astype(np.float32)
        if np.any((np.abs(np.asarray(mass_j) - tau) < EPS_TAU) & (ps >= 0)):
            near_tau += 1
            continue
        for part_t, part_j in ((tap.pool, jap.pool), (tap.policy, jap.policy)):
            for name, a, b in zip(part_j._fields, part_t, part_j):
                b = np.asarray(b)
                assert a.numpy().dtype == b.dtype, (pos, name)
                if name in ("k", "v"):
                    np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=0)
                else:
                    assert np.array_equal(a.numpy(), b), (kind, pos, name)
    assert near_tau <= 2, f"{near_tau} steps near tau"


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
    assert ops.LAUNCHES["paged_attention"] == before + ops.SPLIT_LAUNCHES
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
        tpos = ipos(pos, cuda_device)
        out_f, mass_f, pool_f = tpk.fused_decode_step(pool_f, q, nk, nv, tpos, PAGE,
                                                      policy)
        pool_u = tpk.insert_token(pool_u, nk, nv, tpos, PAGE, policy)
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
@pytest.mark.parametrize("within", [0, 2])
def test_cuda_fused_kernel_repeats_its_bits(cuda_device, within):
    """Kernel 4 launched again on the same inputs gives the same bits on
    every output, at a page boundary (every CTA allocates) and mid-page:
    which CTA of a sequence folds the pages does not change the result."""
    rng = np.random.default_rng(5)
    q, k, v, ps, _ = (t(x).to(cuda_device) for x in random_pool(rng, n_free=0))
    nk = t((rng.standard_normal((B, KVH, HD)) * 0.3).astype(np.float32)).to(cuda_device)
    f = t(rng.integers(1, 9, (B, P)).astype(np.int32)).to(cuda_device)
    r = t(rng.integers(1, 60, (B, P)).astype(np.int32)).to(cuda_device)
    clock = torch.full((B,), 64, dtype=torch.int32, device=cuda_device)
    open_slot = ps.argmax(dim=-1).to(torch.int32)
    if within:
        ps[torch.arange(B), open_slot.long()] = P * PAGE
    args = (q, k, v, nk, nk, ipos(P * PAGE + within, cuda_device), f, r, ps, clock,
            open_slot)
    first = ops.policy_paged_attention(*args, policy="awrp")
    for _ in range(3):
        for a, b in zip(first, ops.policy_paged_attention(*args, policy="awrp")):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["arc", "car"])
@pytest.mark.parametrize("renorm_at,seeded", [("auto", False), (40, False),
                                              ("auto", True)])
def test_cuda_adaptive_kernel_matches_unfused_and_plain(cuda_device, kind,
                                                        renorm_at, seeded):
    """Kernel 5 == the unfused chain on the card, bitwise, through churn, the
    renormalization edge and a ghost-seeded state; two launches per step
    (partials and fold, ``ops.SPLIT_LAUNCHES``); and the kernel == its plain
    version on the final pool."""
    before = ops.LAUNCHES["adaptive_policy_paged_attention"]
    steps = 2 * PAGE if seeded else (AP + 3) * PAGE
    ap = _adaptive_fused_vs_unfused(kind, cuda_device, renorm_at=renorm_at,
                                    seeded=seeded, steps=steps)
    assert ops.LAUNCHES["adaptive_policy_paged_attention"] == \
        before + ops.SPLIT_LAUNCHES * steps
    core = tpk.adaptive_core(f"{kind}_adaptive", B, AP)
    rng = np.random.default_rng(1)
    q = t(rng.standard_normal((B, KVH, G, HD)).astype(np.float32)).to(cuda_device)
    nk = t(rng.standard_normal((B, KVH, HD)).astype(np.float32)).to(cuda_device)
    pos = ipos(int(ap.pool.page_start.max()) + PAGE, cuda_device)  # the next boundary
    args = (q, ap.pool.k.view(B, AP, PAGE, KVH, HD), ap.pool.v.view(B, AP, PAGE, KVH, HD),
            nk, nk, pos, *ap.pool[2:], *(x[:, 0] for x in ap.policy))
    got = ops.adaptive_policy_paged_attention(*args, kind=kind, renorm_at=core.renorm_at)
    want = ref.adaptive_policy_paged_attention_plain(*args, kind=kind,
                                                     renorm_at=core.renorm_at)
    torch.testing.assert_close(got[0], want[0], rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(got[1], want[1], rtol=2e-5, atol=2e-5)
    for a, b in zip(got[2:], want[2:]):
        assert torch.equal(a, b)


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
