"""The port's single-tenant ``ServeEngine`` against the JAX reference engine
on the CPU (smollm-360m SMOKE_CONFIG, float32, the reference's weights
carried across), plus its prefix cache and the ``launch/serve.py`` driver.

Greedy tokens must be equal: the two engines differ only in f32 summation
order, far below the logit gaps a random smoke model leaves between its
top tokens.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.cache.prefix_cache import PrefixCache as JPrefixCache  # noqa: E402
from repro.configs.base import load_smoke_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.cache.prefix_cache import PrefixCache, prompt_key  # noqa: E402
from repro_torch.configs import smollm_360m  # noqa: E402
from repro_torch.core.policies import POLICIES  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

torch.set_num_threads(2)

SMALL = dict(dtype="float32", param_dtype="float32", bounded_kv_pages=3, page_size=8)
NEW_TOKENS = 30  # 16-token prompt + 30 > 3 pages of 8: the pool evicts


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(load_smoke_config("smollm_360m"), **SMALL)
    tcfg = dataclasses.replace(smollm_360m.SMOKE_CONFIG, **SMALL)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(1))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu",
                              dtype=torch.float32)
    return jcfg, jparams, tcfg, tparams


def _prompts(seed, n, length=16, vocab=512):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, size=length).tolist() for _ in range(n)]


@pytest.mark.parametrize("fused", [True, False])
def test_greedy_tokens_equal_reference_engine(setup, fused):
    jcfg, jparams, tcfg, tparams = setup
    prompts = _prompts(0, 2)
    jeng = JServeEngine(jcfg, jparams, max_len=64, kv_mode="paged", fused=True)
    want = jeng.generate([JRequest(i, list(p), max_new_tokens=NEW_TOKENS)
                          for i, p in enumerate(prompts)])
    teng = ServeEngine(tcfg, tparams, max_len=64, kv_mode="paged", fused=fused,
                       device="cpu")
    got = teng.generate([Request(i, list(p), max_new_tokens=NEW_TOKENS)
                         for i, p in enumerate(prompts)])
    for i in range(len(prompts)):
        assert got[i].tokens == want[i].tokens, f"request {i}"
        assert len(got[i].tokens) == NEW_TOKENS
    assert teng.stats["kv_evictions"] > 0
    assert teng.stats["nonfinite_logits"] == 0
    assert teng.stats["decode_steps"] == NEW_TOKENS - 1


def test_full_kv_mode_tokens_equal_reference_engine(setup):
    jcfg, jparams, tcfg, tparams = setup
    prompt = _prompts(3, 1)[0]
    jeng = JServeEngine(jcfg, jparams, max_len=64, kv_mode="full")
    want = jeng.generate([JRequest(0, list(prompt), max_new_tokens=12)])
    teng = ServeEngine(tcfg, tparams, max_len=64, kv_mode="full", device="cpu")
    got = teng.generate([Request(0, list(prompt), max_new_tokens=12)])
    assert got[0].tokens == want[0].tokens


def test_prefix_cache_hit_skips_prefill_and_keeps_tokens(setup):
    """A repeated prompt hits the prefix cache; the stored caches were
    cloned, so the in-place decode of the first run did not corrupt them."""
    _, _, tcfg, tparams = setup
    prompt = _prompts(1, 1)[0]
    eng = ServeEngine(tcfg, tparams, max_len=64, kv_mode="paged", fused=True,
                      device="cpu")
    first = eng.generate([Request(0, list(prompt), max_new_tokens=NEW_TOKENS)])
    second = eng.generate([Request(1, list(prompt), max_new_tokens=NEW_TOKENS)])
    third = eng.generate([Request(2, list(prompt), max_new_tokens=NEW_TOKENS)])
    assert not first[0].prefill_cached and second[1].prefill_cached
    assert third[2].prefill_cached
    assert first[0].tokens == second[1].tokens == third[2].tokens
    assert eng.stats["prefills"] == 1
    assert eng.prefix_cache.hits == 2 and eng.prefix_cache.misses == 1


def test_prompt_alignment_matches_reference(setup):
    jcfg, jparams, tcfg, tparams = setup
    jeng = JServeEngine(jcfg, jparams, max_len=64)
    teng = ServeEngine(tcfg, tparams, max_len=64, device="cpu")
    for n in (3, 8, 13, 17):
        prompt = list(range(1, n + 1))
        assert teng._align(prompt) == jeng._align(prompt)


def test_awrp_prefix_eviction_matches_reference():
    """Same insert / lookup stream into both prefix caches (AWRP, capacity
    3): the stored keys and the hit/miss counts agree after every call."""
    rng = np.random.RandomState(7)
    prompts = [list(rng.randint(1, 100, size=4)) for _ in range(6)]
    jc, tc = JPrefixCache(3, "awrp"), PrefixCache(3, "awrp")
    for step in range(60):
        p = prompts[rng.randint(0, len(prompts))]
        if rng.rand() < 0.5:
            assert (jc.lookup(p) is None) == (tc.lookup(p) is None), step
        else:
            jc.insert(p, step)
            tc.insert(p, step)
        assert set(jc.store) == set(tc.store), step
        assert (jc.hits, jc.misses) == (tc.hits, tc.misses)
    assert tc.hits > 0 and len(tc.store) == 3
    assert prompt_key(prompts[0]) == prompt_key(list(prompts[0]))
    assert tc.telemetry()["hit_ratio"] == jc.hit_ratio


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_prefix_cache_policies_match_reference(policy):
    """Same insert / lookup stream into both prefix caches (capacity 3), for
    every host policy: the stored keys and the hit/miss counts agree after
    every call."""
    rng = np.random.RandomState(7)
    prompts = [list(rng.randint(1, 100, size=4)) for _ in range(6)]
    jc, tc = JPrefixCache(3, policy), PrefixCache(3, policy)
    for step in range(60):
        p = prompts[rng.randint(0, len(prompts))]
        if rng.rand() < 0.5:
            assert (jc.lookup(p) is None) == (tc.lookup(p) is None), step
        else:
            jc.insert(p, step)
            tc.insert(p, step)
        assert set(jc.store) == set(tc.store), step
        assert (jc.hits, jc.misses) == (tc.hits, tc.misses)
    assert tc.hits > 0 and len(tc.store) == 3
    assert prompt_key(prompts[0]) == prompt_key(list(prompts[0]))
    assert tc.telemetry()["hit_ratio"] == jc.hit_ratio
    assert tc.telemetry()["policy"] == policy


def test_launch_serve_runs_on_cpu(capsys):
    results = serve_cli.main(["--device", "cpu", "--smoke", "--dtype", "float32",
                              "--requests", "3", "--new-tokens", "6",
                              "--prompt-len", "64", "--kv-mode", "paged",
                              "--fused", "--kv-pages", "1", "--repeat-prompts"])
    out = capsys.readouterr().out
    assert len(results) == 3 and all(len(r.tokens) == 6 for r in results.values())
    assert results[2].prefill_cached
    assert "device=cpu" in out and "kv evictions=" in out
