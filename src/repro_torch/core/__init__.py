"""Core: the paper's contribution — AWRP and baseline replacement policies,
the trace simulator, the tensor policy core, the batched sweep engine and
the KV-page adaptation (``kv_policy``).  Mirrors ``repro.core``'s exports
for what the port provides."""

from .policies import (  # noqa: F401
    AAWRP,
    AWRP,
    ARC,
    CAR,
    FIFO,
    LFU,
    LRU,
    OPT,
    POLICIES,
    RANDOM,
    WRP,
    ReplacementPolicy,
    TwoQ,
    make_policy,
)
from .simulator import SimResult, hit_ratio_table, simulate, sweep  # noqa: F401
from .traces import TRACES  # noqa: F401

#: engine exports, resolved lazily (PEP 562) so host-only consumers of the
#: numpy oracles do not import the engine
_DEVICE_EXPORTS = (
    "JAX_POLICIES",
    "ADAPTIVE_POLICIES",
    "DEVICE_POLICIES",
    "POLICY_IDS",
    "SetCacheState",
    "AdaptiveState",
    "access_sets",
    "init_set_state",
    "init_adaptive_state",
    "simulate_trace_sets",
    "simulate_trace_batched",
)

#: the tensor policy core — same lazy-resolution rule
_CORE_EXPORTS = (
    "FlatCore",
    "AdaptiveCore",
    "PolicyCore",
    "FlatState",
    "PolicyState",
    "make_core",
    "make_cache_policy",
    "awrp_victim_rows",
    "first_min",
)


def __getattr__(name):
    if name in _DEVICE_EXPORTS:
        from . import torch_policies

        return getattr(torch_policies, name)
    if name in _CORE_EXPORTS:
        from . import policy_core

        return getattr(policy_core, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
