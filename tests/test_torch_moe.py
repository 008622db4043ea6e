"""The port's MoE layer (``repro_torch.models.layers.moe``) against the JAX
reference (``repro.models.layers.moe``) on the CPU.

* Routing (``layers.route``): top-k ids, dispatch order, sorted experts,
  ranks and the keep mask bitwise equal to the reference's routing lines
  (``repro/models/layers.py:437-446``, run in JAX below) on identical f32
  logits: random, with constructed exact ties, and with capacity small
  enough to drop pairs.  The gates agree within GATE_TOL (the two
  frameworks' ``exp`` may differ by an ulp).
* The layer: f32 outputs within RTOL/ATOL of the reference for phi3.5-moe's
  (SwiGLU) and grok-1's (GELU) SMOKE_CONFIG, at decode (S = 1) and prefill
  lengths, with exact router ties and with dropped pairs.  A token whose
  second and third router probabilities lie within MARGIN_TOL of each other
  could route differently under the two frameworks' router products; each
  case reports how many such tokens it has, and its routing must still
  agree.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import load_smoke_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import grok1_314b, phi35_moe  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

torch.set_num_threads(2)

# f32 products summed in another order over d_model / d_ff terms
RTOL, ATOL = 1e-5, 1e-6
GATE_TOL = 1e-6  # a few f32 ulps of a probability
MARGIN_TOL = 1e-5
F32 = dict(dtype="float32", param_dtype="float32")
ARCHS = {"phi35_moe": phi35_moe, "grok1_314b": grok1_314b}


def _jax_routing(logits, K, C):
    """The reference's routing, ``layers.py:437-446`` verbatim."""
    B, S, E = logits.shape
    probs = jax.nn.softmax(logits, axis=-1)
    gate, expert_idx = jax.lax.top_k(probs, K)
    gate = gate / jnp.maximum(gate.sum(-1, keepdims=True), 1e-9)
    pairs_e = expert_idx.reshape(B, S * K)
    order = jnp.argsort(pairs_e, axis=-1, stable=True)
    sorted_e = jnp.take_along_axis(pairs_e, order, axis=-1)
    counts = jax.vmap(lambda p: jnp.bincount(p, length=E))(pairs_e)
    starts = jnp.cumsum(counts, axis=-1) - counts
    rank = (jnp.arange(S * K, dtype=jnp.int32)[None]
            - jnp.take_along_axis(starts, sorted_e, axis=-1).astype(jnp.int32))
    return gate, expert_idx, order, sorted_e, rank, rank < C


_jax_routing_jit = jax.jit(_jax_routing, static_argnums=(1, 2))


def _assert_routing_equal(logits: np.ndarray, K: int, C: int) -> int:
    """Port routing == reference routing on ``logits``; returns the number
    of dropped pairs."""
    want = _jax_routing_jit(jnp.asarray(logits), K, C)
    got = TL.route(torch.from_numpy(logits), K, C)
    np.testing.assert_allclose(got.gate.numpy(), np.asarray(want[0]), rtol=GATE_TOL,
                               atol=GATE_TOL)
    for name, a, b in zip(("expert_idx", "order", "sorted_e", "rank", "keep"),
                          got[1:], want[1:]):
        assert np.array_equal(a.numpy(), np.asarray(b)), name
    return int((~got.keep).sum())


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("E,K", [(4, 2), (16, 2), (8, 1)])
def test_routing_bitwise_on_random_logits(seed, E, K):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((3, 37, E)).astype(np.float32)
    _assert_routing_equal(logits, K, C=max(8, int(37 * K / E)))


@pytest.mark.parametrize("E", [4, 16])
def test_routing_bitwise_with_exact_ties(E):
    """Logits on a coarse grid: many tokens tie their K-th and (K+1)-th
    experts exactly, and some rows are all equal (every expert tied)."""
    rng = np.random.default_rng(7)
    logits = rng.integers(0, 3, (2, 64, E)).astype(np.float32)
    logits[0, :5] = 1.0
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    top = np.sort(probs, -1)[..., ::-1]
    assert (top[..., 1] == top[..., 2]).mean() > 0.25  # ties at the top-2 edge
    _assert_routing_equal(logits, 2, C=max(8, int(64 * 2 / E)))


def test_routing_bitwise_when_capacity_drops_pairs():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 96, 4)).astype(np.float32)
    logits[..., 0] += 2.0  # a hot expert
    dropped = _assert_routing_equal(logits, 2, C=24)
    assert dropped > 0


@pytest.fixture(scope="module", params=sorted(ARCHS))
def moe_params(request):
    arch = request.param
    jcfg = dataclasses.replace(load_smoke_config(arch), **F32)
    tcfg = dataclasses.replace(ARCHS[arch].SMOKE_CONFIG, **F32)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(11))
    np_params = jax.tree.map(np.asarray, jparams)
    tparams = params_from_jax(np_params, tcfg, device="cpu", dtype=torch.float32)
    jlayer = {k: v[0] for k, v in jparams["u0"].items()}
    tlayer = {k: v[0] for k, v in tparams["u0"].items()}
    return jcfg, jlayer, tcfg, tlayer


def _near_ties(probs: np.ndarray, K: int) -> int:
    """Tokens whose K-th and (K+1)-th router probabilities lie within
    MARGIN_TOL."""
    top = np.sort(probs, -1)[..., ::-1]
    return int((top[..., K - 1] - top[..., K] < MARGIN_TOL).sum())


def _check_layer(jcfg, jlayer, tcfg, tlayer, x: np.ndarray) -> dict:
    want = np.asarray(JL.moe(jlayer, jnp.asarray(x), jcfg))
    xt = torch.from_numpy(x)
    got = TL.moe(tlayer, xt, tcfg).numpy()
    logits = torch.einsum("bsd,de->bse", xt, tlayer["w_router"])
    jlogits = np.asarray(jnp.einsum("bsd,de->bse", jnp.asarray(x), jlayer["w_router"]))
    K, C = tcfg.top_k, TL.moe_capacity(x.shape[1], tcfg)
    r = TL.route(logits, K, C)
    jr = _jax_routing_jit(jnp.asarray(jlogits), K, C)
    near = _near_ties(np.asarray(jax.nn.softmax(jlogits, -1)), K)
    assert np.array_equal(r.expert_idx.numpy(), np.asarray(jr[1])), \
        f"routing differs ({near} tokens with a top-{K} margin under {MARGIN_TOL})"
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    return {"near_ties": near, "dropped": int((~r.keep).sum())}


@pytest.mark.parametrize("S", [1, 7, 64])
def test_moe_layer_matches_reference(moe_params, S):
    jcfg, jlayer, tcfg, tlayer = moe_params
    rng = np.random.default_rng(S)
    x = rng.standard_normal((3, S, tcfg.d_model)).astype(np.float32)
    info = _check_layer(jcfg, jlayer, tcfg, tlayer, x)
    print(f"{tcfg.name} S={S}: {info}")


def test_moe_layer_matches_reference_with_tied_router_and_dropped_pairs(moe_params):
    """Experts 0 and 1 share one router column, so every token ties them
    exactly; capacity_factor 0.25 at S = 64 keeps 8 of each expert's ~32
    pairs."""
    jcfg, jlayer, tcfg, tlayer = moe_params
    jcfg = dataclasses.replace(jcfg, capacity_factor=0.25)
    tcfg = dataclasses.replace(tcfg, capacity_factor=0.25)
    w = np.asarray(jlayer["w_router"]).copy()
    w[:, 1] = w[:, 0]
    jlayer = dict(jlayer, w_router=jnp.asarray(w))
    tlayer = dict(tlayer, w_router=torch.from_numpy(w))
    x = np.random.default_rng(5).standard_normal((2, 64, tcfg.d_model)).astype(np.float32)
    info = _check_layer(jcfg, jlayer, tcfg, tlayer, x)
    assert info["dropped"] > 0
    logits = torch.einsum("bsd,de->bse", torch.from_numpy(x), tlayer["w_router"])
    idx = TL.route(logits, tcfg.top_k, 8).expert_idx
    both = (idx == 0).any(-1) & (idx == 1).any(-1)
    assert both.any()  # the tie is at the top: 0 then 1, as the reference
    assert bool((idx[both][:, 0] == 0).all())


def test_moe_refuses_top_k_above_two(moe_params):
    _, _, tcfg, tlayer = moe_params
    x = torch.zeros((1, 2, tcfg.d_model))
    with pytest.raises(NotImplementedError, match="top_k"):
        TL.moe(tlayer, x, dataclasses.replace(tcfg, top_k=3))
