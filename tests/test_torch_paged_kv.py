"""Parity of the port's decision core and classic paged pool with the JAX
reference (``repro.core.policy_core``, ``repro.core.kv_policy``,
``repro.cache.paged_kv``), on the CPU.

Inputs are made with numpy from a seed and handed to both.  Every decision
and plane is compared bitwise.  The one float input to a decision, the
attention mass, is taken from JAX where the two sides would compute it
separately (``score_update`` is fed the JAX mass); the fused step, which
computes its own mass, may differ from JAX only at a step where some page's
JAX mass lies within EPS_TAU of tau = 1/residents, and then the port is
re-synced to the JAX planes (such steps are counted and must stay rare).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.cache import paged_kv as jpk  # noqa: E402
from repro.core import kv_policy as jkv  # noqa: E402
from repro.core import policy_core as jpc  # noqa: E402
from repro_torch.cache import paged_kv as tpk  # noqa: E402
from repro_torch.core import kv_policy as tkv  # noqa: E402
from repro_torch.core import policy_core as tpc  # noqa: E402

torch.set_num_threads(2)

POLICIES = ("awrp", "lru", "fifo", "lfu", "arc", "car")
KVH, G, HD = 2, 2, 8
KVD = KVH * HD
EPS_TAU = 1e-5  # |mass - tau| below this may flip a reference decision
RTOL = ATOL = 2e-5  # f32 attention: summation order only


def t(a):
    return torch.from_numpy(np.array(a))


def equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def rand_planes(rng, B, P, *, clock_hi=50, free_p=0.2):
    f = rng.integers(0, 6, (B, P)).astype(np.int32)
    r = rng.integers(0, clock_hi, (B, P)).astype(np.int32)
    ps = (rng.integers(0, 40, (B, P)) * 4).astype(np.int32)
    ps[rng.random((B, P)) < free_p] = -1
    clock = np.full((B,), clock_hi, np.int32)
    return f, r, ps, clock


# -- decision core -----------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_first_min_matches_reference_with_ties(seed):
    rng = np.random.default_rng(seed)
    key = rng.integers(-3, 3, (7, 13)).astype(np.int32)  # many ties
    key[0] = 5  # an all-equal row
    key[1] = np.iinfo(np.int32).max
    got = tpc.first_min(t(key))
    assert got.dtype == torch.int32
    assert equal(got.numpy(), jpc.first_min(jnp.asarray(key)))


@pytest.mark.parametrize("case", ["ties", "all_invalid", "large_clock", "random"])
def test_awrp_victim_rows_matches_reference(case):
    rng = np.random.default_rng(11)
    B, P = 6, 16
    f, r, _, clock = rand_planes(rng, B, P)
    valid = rng.random((B, P)) < 0.7
    if case == "ties":
        f[:] = 2
        r[:] = 10  # equal weights everywhere: first valid lane wins
    elif case == "all_invalid":
        valid[:] = False
    elif case == "large_clock":
        clock[:] = 2**31 - 5
        r = (clock[:, None] - rng.integers(1, 2**20, (B, P))).astype(np.int32)
    got = tpc.awrp_victim_rows(t(f), t(r), t(clock), t(valid))
    want = jpc.awrp_victim_rows(jnp.asarray(f), jnp.asarray(r), jnp.asarray(clock),
                                jnp.asarray(valid))
    assert got.dtype == torch.int32 and equal(got.numpy(), want)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("seed", range(3))
def test_page_victim_matches_reference(policy, seed):
    rng = np.random.default_rng(100 + seed)
    B, P = 5, 12
    f, r, ps, clock = rand_planes(rng, B, P, free_p=0.1 * seed)
    f[:, ::3] = f[:, 1::3][:, : f[:, ::3].shape[1]]  # tie structure
    pinned = np.zeros((B, P), bool)
    pinned[np.arange(B), rng.integers(0, P, B)] = True
    ps[-1] = -1  # a row with no resident page
    got = tkv.page_victim(policy, t(f), t(r), t(ps), t(clock), t(pinned))
    want = jkv.page_victim(policy, jnp.asarray(f), jnp.asarray(r), jnp.asarray(ps),
                           jnp.asarray(clock), jnp.asarray(pinned))
    assert got.dtype == torch.int32 and equal(got.numpy(), want)


# -- classic pool --------------------------------------------------------------


def pools_equal(tp, jp) -> None:
    for name, a, b in zip(tp._fields, tp, jp):
        assert equal(a.numpy(), b), f"plane {name} differs"


def to_torch_pool(jp):
    return tpk.PagedPool(*(t(x).clone() for x in jp))


def step_inputs(rng, B):
    q = rng.standard_normal((B, KVH, G, HD)).astype(np.float32)
    nk = (rng.standard_normal((B, KVD)) * 0.3).astype(np.float32)
    nv = (rng.standard_normal((B, KVD)) * 0.3).astype(np.float32)
    return q, nk, nv


@pytest.mark.parametrize("policy", POLICIES)
def test_insert_and_score_update_match_reference_past_capacity(policy):
    """insert_token, kv_positions and score_update (fed the JAX mass) keep
    every plane and the K/V bitwise equal through evictions."""
    rng = np.random.default_rng(3)
    B, P, page = 2, 4, 4
    jp = jpk.init_pool(B, P, page, KVD, jnp.float32)
    tp = tpk.init_pool(B, P, page, KVD, torch.float32, device="cpu")
    for pos in range(P * page + 3 * page):
        _, nk, nv = step_inputs(rng, B)
        jp = jpk.insert_token(jp, jnp.asarray(nk), jnp.asarray(nv), jnp.int32(pos),
                              page, policy=policy)
        tpos = torch.tensor(pos, dtype=torch.int32)
        tp = tpk.insert_token(tp, t(nk), t(nv), tpos, page, policy=policy)
        pools_equal(tp, jp)
        assert equal(tpk.kv_positions(tp, tpos, page).numpy(),
                     jpk.kv_positions(jp, jnp.int32(pos), page))
        # a random softmax-like mass per row; scaled so pages straddle tau
        mass = (rng.random((B, P * page)) * 2.0 / (P * page)).astype(np.float32)
        jp = jpk.score_update(jp, jnp.asarray(mass), page)
        tp = tpk.score_update(tp, t(mass), page)
        pools_equal(tp, jp)


def test_score_update_at_tau_boundary():
    """A page whose mass is exactly tau counts as referenced on both sides."""
    B, P, page = 1, 4, 2
    jp = jpk.init_pool(B, P, page, KVD, jnp.float32)
    jp = jp._replace(page_start=jnp.asarray([[0, 2, 4, -1]], jnp.int32),
                     clock=jnp.asarray([5], jnp.int32))
    tp = to_torch_pool(jp)
    mass = np.zeros((B, P * page), np.float32)
    mass[0, 0] = np.float32(1.0) / np.float32(3.0)  # == tau for 3 residents
    mass[0, 2] = np.nextafter(mass[0, 0], np.float32(0))  # one ulp below
    pools_equal(tpk.score_update(tp, t(mass), page),
                jpk.score_update(jp, jnp.asarray(mass), page))


@pytest.mark.parametrize("policy", POLICIES)
def test_cpu_fused_decode_step_matches_reference(policy):
    """The port's fused step on the CPU (the plain version) against JAX's
    fused Pallas step in interpret mode, past capacity: planes bitwise
    (tau rule above), out and mass within RTOL/ATOL."""
    rng = np.random.default_rng(5)
    B, P, page = 2, 4, 4
    jp = jpk.init_pool(B, P, page, KVD, jnp.float32)
    near_tau = 0
    for pos in range(P * page + 2 * page):
        q, nk, nv = step_inputs(rng, B)
        tp = to_torch_pool(jp)
        out_t, mass_t, tp = tpk.fused_decode_step(tp, t(q), t(nk), t(nv),
                                                  torch.tensor(pos, dtype=torch.int32),
                                                  page, policy)
        out_j, mass_j, jp = jpk.fused_decode_step(
            jp, jnp.asarray(q), jnp.asarray(nk), jnp.asarray(nv), jnp.int32(pos),
            page, policy, interpret=True)
        np.testing.assert_allclose(out_t.numpy(), out_j, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(mass_t.numpy(), mass_j, rtol=RTOL, atol=ATOL)
        resident = np.maximum((np.asarray(jp.page_start) >= 0).sum(-1, keepdims=True), 1)
        tau = np.float32(1.0) / resident.astype(np.float32)
        if np.any(np.abs(np.asarray(mass_j) - tau) < EPS_TAU):
            near_tau += 1
            continue  # the next step restarts from the JAX planes
        pools_equal(tp, jp)
    assert near_tau <= 2, f"{near_tau} steps near tau"
