"""The port's true-adaptive (ARC/CAR) paged pool and its cross-request
ghost-hit feed against the JAX reference (``repro.cache.paged_kv``), on the
CPU.

Inputs are made with numpy from a seed and handed to both.  Every pool plane
(K/V included) and every policy plane is compared bitwise after every step.
The one float input to a decision, the attention mass, is the same numpy
array on both sides.  Each JAX function is ``jax.jit``-ed once, outside the
loop.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.cache import paged_kv as jpk  # noqa: E402
from repro_torch.cache import paged_kv as tpk  # noqa: E402
from repro_torch.core import policy_core as tpc  # noqa: E402

torch.set_num_threads(2)

KVD = 4
#: the re-reference stream of tests/test_policy_attn.py's ghost-churn case
CHURN = [0, 1, 2, 0, 1, 3, 2, 4, 0, 5, 1]


def t(a):
    return torch.from_numpy(np.array(a))


def assert_planes_equal(tag, got, want):
    for name, a, b in zip(want._fields, got, want):
        b = np.asarray(b)
        a = a.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (tag, name, a.dtype, b.dtype)
        assert np.array_equal(a, b), f"{tag}: plane {name} differs"


def assert_apools_equal(tag, got, want):
    assert_planes_equal(tag, got.pool, want.pool)
    assert_planes_equal(tag, got.policy, want.policy)


def to_torch_state(st):
    return tpc.AdaptiveState(*(t(np.asarray(a)) for a in st))


@pytest.mark.parametrize("kv_policy", ["arc_adaptive", "car_adaptive"])
def test_adaptive_pool_matches_reference_past_capacity(kv_policy):
    """adaptive_insert_token + adaptive_score_update, fed the same mass, keep
    all 7 pool planes and all 6 policy planes equal to JAX's after every
    step, from an empty pool to 3 pages past capacity."""
    B, P, page = 2, 3, 4
    jcore = jpk.adaptive_core(kv_policy, B, P)
    tcore = tpk.adaptive_core(kv_policy, B, P)
    jp = jpk.init_adaptive_pool(B, P, page, KVD, jnp.float32, kv_policy)
    tp = tpk.init_adaptive_pool(B, P, page, KVD, torch.float32, kv_policy,
                                device="cpu")
    insert = jax.jit(lambda ap, k, v, pos: jpk.adaptive_insert_token(
        ap, k, v, pos, page, jcore))
    score = jax.jit(lambda ap, m: jpk.adaptive_score_update(ap, m, page, jcore))
    rng = np.random.default_rng(3)
    hits = 0
    for pos in range((P + 3) * page):
        nk = rng.standard_normal((B, KVD)).astype(np.float32)
        nv = rng.standard_normal((B, KVD)).astype(np.float32)
        jp = insert(jp, jnp.asarray(nk), jnp.asarray(nv), jnp.int32(pos))
        tp = tpk.adaptive_insert_token(tp, t(nk), t(nv),
                                       torch.tensor(pos, dtype=torch.int32), page, tcore)
        assert_apools_equal(f"{kv_policy} insert pos={pos}", tp, jp)
        # scaled so that pages straddle tau = 1/residents
        mass = (rng.random((B, P * page)) * 2.0 / (P * page)).astype(np.float32)
        jp = score(jp, jnp.asarray(mass))
        tp = tpk.adaptive_score_update(tp, t(mass), page, tcore)
        assert_apools_equal(f"{kv_policy} score pos={pos}", tp, jp)
        hits += int(tpk.referenced_pages(tp.pool, t(mass), page).sum())
    assert hits > 0
    # the pool evicted: ids past P were allocated into a full pool
    assert int(tp.pool.page_start.max()) >= P * page


def test_seed_adaptive_state_matches_reference():
    for batch, pages, first, n_res in ((2, 3, 0, 2), (1, 4, 5, 4), (3, 2, 1, 0)):
        got = tpk.seed_adaptive_state(batch, pages, first, n_res, device="cpu")
        want = jpk.seed_adaptive_state(batch, pages, first, n_res)
        assert_planes_equal(f"seed {batch, pages, first, n_res}", got, want)


@pytest.mark.parametrize("kv_policy", ["arc_adaptive", "car_adaptive"])
def test_ghost_feed_matches_reference_on_churn(kv_policy):
    """replay_page_ids (ghost-hit counts included) and reseed_from_ghosts on
    the churn stream equal JAX's bitwise; ``p`` moves and the ghost directory
    is populated."""
    B, P = 2, 3
    init = tpk.adaptive_core(kv_policy, B, P).init(device="cpu")
    jinit = jpk.adaptive_core(kv_policy, B, P).init()
    got, gh = tpk.replay_page_ids(init, kv_policy, P, CHURN)
    want, jgh = jpk.replay_page_ids(jinit, kv_policy, P, CHURN)
    assert_planes_equal("replay", got, want)
    assert np.array_equal(gh.numpy(), np.asarray(jgh)) and gh.dtype == torch.int32
    assert int(gh.min()) > 0
    n_have, n_res = 2 * P, P
    st, gh2 = tpk.reseed_from_ghosts(got, kv_policy, P, n_have, n_res)
    jst, jgh2 = jpk.reseed_from_ghosts(want, kv_policy, P, n_have, n_res)
    assert_planes_equal("reseed", st, jst)
    assert np.array_equal(gh2, jgh2) and gh2.shape == (B,)
    assert float(st.p.max()) > 0.0  # p adapted
    assert int(st.tag.max()) >= tpc._TAG_B1  # ghost directory populated
    tel, jtel = tpk.pool_telemetry(st), jpk.pool_telemetry(jst)
    for k in jtel:
        assert float(tel[k]) == float(jtel[k]), k


@pytest.mark.parametrize("kv_policy", ["arc_adaptive", "car_adaptive"])
def test_ghost_feed_matches_reference_on_stacked_planes(kv_policy):
    """Layer-stacked (n_rep, B, 1, L) planes: replay and reseed flatten and
    restore the leading dims, ghost hits per row; every plane equal to JAX."""
    n_rep, B, P = 3, 2, 3
    jcore = jpk.adaptive_core(kv_policy, B, P)
    st = jax.tree.map(lambda a: jnp.stack([a] * n_rep), jcore.init())
    # give each layer its own history, so the rows differ
    rng = np.random.RandomState(4)
    ids = rng.randint(0, 7, size=(12, n_rep, B))
    step = jax.jit(jax.vmap(lambda s, x: jcore.on_access(s, x)[0]))
    for x in ids:
        st = step(st, jnp.asarray(x, jnp.int32))
    tst = to_torch_state(st)
    got, gh = tpk.replay_page_ids(tst, kv_policy, P, range(8))
    want, jgh = jpk.replay_page_ids(st, kv_policy, P, range(8))
    assert got.blocks.shape == (n_rep, B, 1, 2 * P) and gh.shape == (n_rep, B)
    assert_planes_equal("stacked replay", got, want)
    assert np.array_equal(gh.numpy(), np.asarray(jgh))
    new, gh2 = tpk.reseed_from_ghosts(tst, kv_policy, P, 4, 2)
    jnew, jgh2 = jpk.reseed_from_ghosts(st, kv_policy, P, 4, 2)
    assert new.blocks.shape == (n_rep, B, 1, 2 * P) and gh2.shape == (n_rep, B)
    assert_planes_equal("stacked reseed", new, jnew)
    assert np.array_equal(gh2, jgh2)


@pytest.mark.parametrize("kv_policy", ["arc_adaptive", "car_adaptive"])
def test_reseeded_pool_decodes_like_reference(kv_policy):
    """From a ghost-seeded state (``p`` != 0), the pool's decode steps keep
    every plane equal to JAX's, and pool and policy residency coherent."""
    B, P, page = 2, 3, 4
    jcore = jpk.adaptive_core(kv_policy, B, P)
    tcore = tpk.adaptive_core(kv_policy, B, P)
    churned, _ = jpk.replay_page_ids(jcore.init(), kv_policy, P, CHURN)
    n_have, n_res = 2 * P, P
    jst, _ = jpk.reseed_from_ghosts(churned, kv_policy, P, n_have, n_res)
    assert float(np.asarray(jst.p).max()) > 0.0
    start = (n_have - n_res) * page
    order = np.arange(P, dtype=np.int32)
    pool = jpk.init_pool(B, P, page, KVD, jnp.float32)._replace(
        f=jnp.ones((B, P), jnp.int32),
        r=jnp.broadcast_to(jnp.asarray(order + 1), (B, P)),
        page_start=jnp.broadcast_to(jnp.asarray(start + order * page), (B, P)),
        clock=jnp.full((B,), n_res, jnp.int32),
        open_slot=jnp.full((B,), n_res - 1, jnp.int32))
    jp = jpk.AdaptivePagedPool(pool=pool, policy=jst)
    tp = tpk.AdaptivePagedPool(tpk.PagedPool(*(t(np.asarray(a)) for a in pool)),
                               to_torch_state(jst))
    insert = jax.jit(lambda ap, k, pos: jpk.adaptive_insert_token(
        ap, k, k, pos, page, jcore))
    score = jax.jit(lambda ap, m: jpk.adaptive_score_update(ap, m, page, jcore))
    rng = np.random.default_rng(5)
    for pos in range(n_have * page, (n_have + 3) * page):
        nk = rng.standard_normal((B, KVD)).astype(np.float32)
        jp = insert(jp, jnp.asarray(nk), jnp.int32(pos))
        tp = tpk.adaptive_insert_token(tp, t(nk), t(nk),
                                       torch.tensor(pos, dtype=torch.int32), page, tcore)
        mass = (rng.random((B, P * page)) * 2.0 / (P * page)).astype(np.float32)
        jp = score(jp, jnp.asarray(mass))
        tp = tpk.adaptive_score_update(tp, t(mass), page, tcore)
        assert_apools_equal(f"{kv_policy} reseeded pos={pos}", tp, jp)
        res = tcore.resident_mask(tp.policy)[:, 0]
        for b in range(B):
            ps = tp.pool.page_start[b]
            assert set((ps[ps >= 0] // page).tolist()) == set(
                tp.policy.blocks[b, 0][res[b]].tolist()), (pos, b)


def test_adaptive_pool_clone_is_deep():
    ap = tpk.init_adaptive_pool(1, 2, 4, KVD, torch.float32, "car_adaptive",
                                device="cpu")
    copy = ap.clone()
    ap.pool.k.add_(1.0)
    ap.policy.blocks.fill_(7)
    assert float(copy.pool.k.abs().sum()) == 0.0
    assert int(copy.policy.blocks.max()) == -1
