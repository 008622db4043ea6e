"""The split decode schedule of kernels 3, 4 and 5, on the CPU.

On the card kernels 3, 4 and 5 compute every page's partials (scores, local
max, exponentials and their sum, unscaled P.V) in parallel, in no order, and
fold them into the running (m, l, acc) in page order.  Their plain versions
(``kernels/ref.py``) keep the two halves apart: ``_Flash.partials`` and
``_Flash.fold``.  Here partials computed in a shuffled order and then folded
in page order equal the plain versions (partials of page p, then its fold,
then page p+1) bit for bit, on out and mass and on every plane of the fused
step, over pools drawn with hypothesis at small sizes: free pages, a partly
filled last page, ``cur`` inside a page, the new row injected at a page
boundary and mid-page, G = 1..4, f32 and bf16 pools; for kernel 5 the
ARC/CAR step from a prefill-seeded and a ghost-reseeded pool, arc and car,
across two page boundaries.  The shuffled split
also meets the JAX reference kernels (Pallas interpret mode) within the
parity tests' tolerance (2e-5, f32 summation order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from _propcheck import given, settings, st  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.cache import paged_kv  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

torch.set_num_threads(2)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
RTOL = ATOL = 2e-5


def _pool(seed, B, P, page, KVH, G, hd, dtype, n_free, back):
    """Seeded q, K/V pages with shuffled starts (``n_free`` free pages per
    sequence) and ``cur`` = ``back[b]`` rows before the pool's last row."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, KVH, G, hd)).astype(np.float32)
    k = (rng.standard_normal((B, P, page, KVH, hd)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((B, P, page, KVH, hd)) * 0.5).astype(np.float32)
    ps = np.stack([rng.permutation(P) for _ in range(B)]).astype(np.int32) * page
    ps[:, :n_free] = -1
    cur = np.array([P * page - 1 - back[b % len(back)] for b in range(B)], np.int32)
    dt = DTYPES[dtype]
    return (torch.from_numpy(q).to(dt), torch.from_numpy(k).to(dt),
            torch.from_numpy(v).to(dt), torch.from_numpy(ps), torch.from_numpy(cur))


def _split(seed, q, k_pages, v_pages, page_start, cur_pos, tile=None):
    """The card's schedule: every page's partials computed in a shuffled
    order (drawn from ``seed``), then folded in page order; ``tile(p)``
    gives page p's f32 (k, v) (default: the pool's)."""
    P, hd = k_pages.shape[1], q.shape[-1]
    qf = q.to(torch.float32)
    st_ = ref._Flash(qf, P)
    tile = tile or (lambda p: (ref._tile(k_pages, p), ref._tile(v_pages, p)))
    parts = {int(p): st_.partials(qf, *tile(p), page_start[:, p], cur_pos,
                                       ref.attn_scale(hd))
             for p in np.random.default_rng(seed + 1).permutation(P)}
    for p in range(P):
        st_.fold(p, *parts[p])
    return st_.finalize(q.dtype)


@settings(max_examples=12, deadline=None)
@given(seed=st.integers(0, 10_000), G=st.integers(1, 4), P=st.integers(1, 7),
       page=st.sampled_from([1, 4, 8]), n_free=st.integers(0, 3),
       back=st.lists(st.integers(0, 11), min_size=1, max_size=3),
       dtype=st.sampled_from(sorted(DTYPES)))
def test_shuffled_partials_fold_to_the_sequential_step_bitwise(seed, G, P, page, n_free,
                                                               back, dtype):
    """Kernel 3's plain version: any order of the partials, the same bits."""
    q, k, v, ps, cur = _pool(seed, 2, P, page, 2, G, 8, dtype, min(n_free, P - 1),
                             back)
    want = ref.paged_attention_plain(q, k, v, ps, cur)
    got = _split(seed, q, k, v, ps, cur)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@settings(max_examples=12, deadline=None)
@given(seed=st.integers(0, 10_000), G=st.integers(1, 4), P=st.integers(2, 6),
       n_free=st.integers(0, 2), within=st.integers(0, 3),
       policy=st.sampled_from(["awrp", "lru", "fifo", "lfu", "arc", "car"]),
       dtype=st.sampled_from(sorted(DTYPES)))
def test_fused_step_with_shuffled_partials_keeps_every_plane(seed, G, P, n_free, within,
                                                             policy, dtype):
    """Kernel 4's plain version: the new row injected at a page boundary
    (``within`` 0: an allocation) or mid-page; the allocation, the shuffled
    split over the injected tiles and the score update give every output
    and plane of the plain fused step, bitwise."""
    page, KVH, hd = 4, 2, 8
    q, k, v, ps, _ = _pool(seed, 2, P, page, KVH, G, hd, dtype, n_free, [0])
    rng = np.random.default_rng(seed + 2)
    dt = DTYPES[dtype]
    nk = torch.from_numpy(rng.standard_normal((2, KVH, hd)).astype(np.float32)).to(dt)
    nv = torch.from_numpy(rng.standard_normal((2, KVH, hd)).astype(np.float32)).to(dt)
    f = torch.from_numpy(rng.integers(1, 9, (2, P)).astype(np.int32))
    r = torch.from_numpy(rng.integers(1, 40, (2, P)).astype(np.int32))
    clock = torch.full((2,), 50, dtype=torch.int32)
    # the next token is ``within`` rows into the page starting at P*page: at
    # its boundary it is allocated, else it is the open page
    open_slot = ps.argmax(dim=-1).to(torch.int32)
    if within:
        ps[torch.arange(2), open_slot.long()] = P * page
    pos = P * page + within
    tpos = torch.tensor(pos, dtype=torch.int32)
    want = ref.policy_paged_attention_plain(q, k, v, nk, nv, tpos, f, r, ps, clock,
                                            open_slot, policy=policy)
    slot, fa, ra, psa = ref.allocate(f, r, ps, clock, open_slot, tpos, page, policy)
    row = torch.arange(page, dtype=torch.int32)

    def tile(p):
        inject = ((slot[:, None] == p) & (row[None] == pos % page))[..., None, None]
        return (torch.where(inject, nk.float()[:, None], ref._tile(k, p)),
                torch.where(inject, nv.float()[:, None], ref._tile(v, p)))

    cur = torch.full((2,), pos, dtype=torch.int32)
    out, mass = _split(seed, q, k, v, psa, cur, tile)
    f2, r2, clock2 = ref.score_planes(mass, fa, ra, psa, clock)
    got = (out, mass, slot, f2, r2, psa, clock2, slot if within == 0 else open_slot)
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)


def _adaptive_pool(seed, kind, B, P, page, KVH, hd, dtype, ghost):
    """A full true-adaptive pool as ``pool_from_prefill`` leaves it after a
    prompt, its last P pages in slots 0..P-1 with seeded K/V: the policy
    the prefill seeding of a P-page prompt, or with ``ghost`` the
    cross-request reseed of a 2P-page re-prefill through the state of a
    request that churned pages 0..7 with re-references (ghost hits move
    ``p``).  Returns (k, v, pool planes, directory planes (B, L) and (B,),
    the first decode position)."""
    rng = np.random.default_rng(seed)
    dt = DTYPES[dtype]
    k = torch.from_numpy((rng.standard_normal((B, P, page, KVH, hd)) * 0.5)
                         .astype(np.float32)).to(dt)
    v = torch.from_numpy((rng.standard_normal((B, P, page, KVH, hd)) * 0.5)
                         .astype(np.float32)).to(dt)
    first = P if ghost else 0  # the first resident page id
    order = torch.arange(P, dtype=torch.int32)
    planes = [torch.ones((B, P), dtype=torch.int32), (order + 1).expand(B, P).clone(),
              ((first + order) * page).expand(B, P).clone(),
              torch.full((B,), P, dtype=torch.int32), torch.full((B,), P - 1, dtype=torch.int32)]
    if ghost:
        core = paged_kv.adaptive_core(kind, B, P)
        prev, _ = paged_kv.replay_page_ids(core.init(device="cpu"), kind, P,
                                           [0, 1, 2, 3, 0, 1, 4, 2, 5, 0, 6, 1, 7, 3])
        state, hits = paged_kv.reseed_from_ghosts(prev, kind, P, 2 * P, P)
        assert int(hits.min()) > 0 and float(state.p.min()) > 0.0
    else:
        state = paged_kv.seed_adaptive_state(B, P, 0, P, device="cpu")
    return k, v, planes, [x[:, 0] for x in state], (first + P) * page


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("ghost", [False, True], ids=["prefill_seed", "ghost_reseed"])
@pytest.mark.parametrize("kind", ["arc", "car"])
def test_adaptive_step_with_shuffled_partials_keeps_every_plane(kind, ghost, dtype):
    """Kernel 5's plain version on the card's schedule: the ARC/CAR
    allocation miss, the partials of the injected tiles computed in a
    shuffled order and folded in page order, the score update and the hit
    accesses in slot order give every output of the plain fused step bit
    for bit (out and mass included), over page + 1 steps from a full pool:
    an evicting page boundary, the mid-page steps of the page it opened,
    and the next boundary."""
    B, P, page, KVH, G, hd = 2, 4, 4, 2, 2, 8
    k, v, planes, dirp, pos0 = _adaptive_pool(3, kind, B, P, page, KVH, hd, dtype, ghost)
    core = paged_kv.adaptive_core(kind, B, P)
    rng = np.random.default_rng(4)
    dt = DTYPES[dtype]
    row = torch.arange(page, dtype=torch.int32)
    for pos in range(pos0, pos0 + page + 1):
        q, nk, nv = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dt)
                     for shape in ((B, KVH, G, hd), (B, KVH, hd), (B, KVH, hd)))
        tpos = torch.tensor(pos, dtype=torch.int32)
        want = ref.adaptive_policy_paged_attention_plain(
            q, k, v, nk, nv, tpos, *planes, *dirp, kind=kind, renorm_at=core.renorm_at)
        f, r, ps, clock, open_slot = planes
        state = ref.AdaptiveState(*(x[:, None] for x in dirp))
        slot, fa, ra, psa, state = ref.adaptive_allocate(core, state, f, r, ps, clock,
                                                          open_slot, tpos, page)

        def tile(p):
            inject = ((slot[:, None] == p) & (row[None] == pos % page))[..., None, None]
            return (torch.where(inject, nk.float()[:, None], ref._tile(k, p)),
                    torch.where(inject, nv.float()[:, None], ref._tile(v, p)))

        cur = torch.full((B,), pos, dtype=torch.int32)
        out, mass = _split(pos, q, k, v, psa, cur, tile)
        f2, r2, clock2 = ref.score_planes(mass, fa, ra, psa, clock)
        state = ref.adaptive_hits(core, state, psa, ref._hit(mass, psa), page)
        got = (out, mass, slot, f2, r2, psa, clock2,
               slot if pos % page == 0 else open_slot, *(x[:, 0] for x in state))
        for a, b in zip(got, want, strict=True):
            assert torch.equal(a, b), pos
        # the caller's scatter of the new row, then the next step's inputs
        bi = torch.arange(B)
        k[bi, want[2].long(), pos % page] = nk
        v[bi, want[2].long(), pos % page] = nv
        planes, dirp = list(want[3:8]), list(want[8:])
    assert int(planes[2].max()) == pos0 + page  # the second boundary allocated


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("G", [1, 3])
def test_shuffled_partials_match_the_reference_kernel(seed, G):
    """The split plain version against JAX's Pallas kernel (interpret mode):
    ragged pool, f32."""
    q, k, v, ps, cur = _pool(seed, 2, 5, 4, 2, G, 8, "float32", 1, [2, 6])
    out, mass = _split(seed, q, k, v, ps, cur)
    out_j, mass_j = jops.paged_attention(*(jnp.asarray(t.numpy()) for t in
                                           (q, k, v, ps, cur)), interpret=True)
    np.testing.assert_allclose(out.numpy(), out_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(mass.numpy(), mass_j, rtol=RTOL, atol=ATOL)
