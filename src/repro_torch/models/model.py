"""Model assembly for the serving slice (``repro/models/model.py``):
parameter declarations and init, prefill, the decode step and the
prefill-to-pool handoff, for plain dense stacks of ``"attn"`` blocks.

Layout follows the reference so weights carry across
(``models/convert.py``): the repeating unit's position ``u0`` holds every
layer's parameters stacked on a leading ``(n_layers,)`` axis; decode caches
carry the same leading axis.  Where the reference scans the stack with
``lax.scan``, this module runs a Python loop over layers; the per-layer
views share storage with the stacked tensors.

Decode caches are ``{"pos": int, "blocks": {"u0": cache}}`` with ``cache`` a
stacked ``{"k", "v"}`` dict (``kv_mode="full"``), a stacked
``paged_kv.PagedPool`` (``kv_mode="paged"``) or, when ``cfg.kv_policy`` is in
``paged_kv.TRUE_ADAPTIVE_KV``, a stacked ``paged_kv.AdaptivePagedPool`` whose
ARC/CAR planes also carry the leading layer axis.  K/V tensors are updated in
place by ``decode_step`` (see ``cache/paged_kv.py``); callers that keep an
earlier cache clone it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.cache import paged_kv
from repro_torch.core.policy_core import AdaptiveState
from repro_torch.device import resolve_device
from repro_torch.models import layers as L

Params = Dict[str, Any]

#: parameters kept in float32 whatever ``param_dtype`` is (norm scales)
F32_PARAMS = ("ln1", "ln2", "final_norm")


def pad_vocab(cfg) -> int:
    return ((cfg.vocab + 127) // 128) * 128


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


@dataclasses.dataclass(frozen=True)
class Decl:
    shape: Tuple[int, ...]
    init: str = "normal"  # normal | zeros
    scale: float = 0.02


def _attn_decls(cfg) -> Dict[str, Decl]:
    d, qk, kv = cfg.d_model, cfg.qk_dim, cfg.kv_dim
    return {
        "wq": Decl((d, qk)),
        "wk": Decl((d, kv)),
        "wv": Decl((d, kv)),
        "wo": Decl((qk, d)),
        "ln1": Decl((d,), "zeros"),
        "ln2": Decl((d,), "zeros"),
    }


def _mlp_decls(cfg) -> Dict[str, Decl]:
    d, ff = cfg.d_model, cfg.d_ff
    return {"w_up": Decl((d, ff)), "w_down": Decl((ff, d)), "w_gate": Decl((d, ff))}


def _check_supported(cfg) -> None:
    if (cfg.family != "dense" or cfg.pattern is not None or cfg.n_experts
            or cfg.act != "swiglu" or cfg.qkv_bias):
        raise NotImplementedError(
            f"{cfg.name}: only plain dense SwiGLU 'attn' stacks without QKV "
            "bias are ported to repro_torch so far (MoE, sliding-window, SSM, "
            "enc-dec and VLM blocks come in later slices)")


def scan_plan(cfg) -> Tuple[List[Tuple[str, str]], int, List[Tuple[str, str]]]:
    """(unit, n_repeats, tail) of (position_name, kind) entries."""
    _check_supported(cfg)
    return [("u0", "attn")], cfg.n_layers, []


def param_decls(cfg) -> Dict[str, Any]:
    """Declaration tree with the stacked leading layer dim on ``u0``."""
    V, d = pad_vocab(cfg), cfg.d_model
    tree: Dict[str, Any] = {
        "embed": Decl((V, d), scale=1.0),
        "final_norm": Decl((d,), "zeros"),
    }
    if not cfg.tie_embeddings:
        tree["unembed"] = Decl((V, d))
    unit, n_rep, _ = scan_plan(cfg)
    for pos, _kind in unit:
        tree[pos] = {k: Decl((n_rep,) + v.shape, v.init, v.scale)
                     for k, v in {**_attn_decls(cfg), **_mlp_decls(cfg)}.items()}
    return tree


def init_params(cfg, generator: torch.Generator, device="cuda") -> Params:
    """Random parameters with the reference's declarations and scales
    (normal * min(scale, 1/sqrt(fan_in)); norm scales zero, in f32), drawn
    on the generator's device.  The streams differ from JAX's: weights that
    must match the reference come through ``convert.params_from_jax``."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.param_dtype)

    def walk(tree):
        out = {}
        for name, decl in tree.items():
            if not isinstance(decl, Decl):
                out[name] = walk(decl)
                continue
            dt = torch.float32 if name in F32_PARAMS else dtype
            if decl.init == "zeros":
                out[name] = torch.zeros(decl.shape, dtype=dt, device=dev)
                continue
            fan_in = decl.shape[-2] if len(decl.shape) >= 2 else decl.shape[-1]
            scale = min(decl.scale, 1.0 / math.sqrt(fan_in))
            w = torch.randn(decl.shape, generator=generator, dtype=torch.float32,
                            device=generator.device)
            out[name] = (w * scale).to(dt).to(dev)
        return out

    return walk(param_decls(cfg))


def logits_from_hidden(params: Params, cfg, x: torch.Tensor) -> torch.Tensor:
    """Final norm and the (tied) unembedding; logits (B, S, Vpad) in f32."""
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return (x @ table.T).to(torch.float32)


def _embed(params: Params, cfg, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.long()].to(torch_dtype(cfg.dtype))


def _layer(params: Params, pos_name: str, i: int) -> Params:
    return {k: v[i] for k, v in params[pos_name].items()}


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------


def prefill(params: Params, cfg, tokens: torch.Tensor, max_len: int,
            *, kv_mode: str = "full"):
    """Run the whole prompt (B, S); returns (logits (B, S, Vpad), decode
    caches positioned at S).  For ``kv_mode="paged"`` the prompt must be
    page-aligned (the engine aligns it)."""
    unit, n_rep, _ = scan_plan(cfg)
    B, S = tokens.shape
    x = _embed(params, cfg, tokens)
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    ks, vs = [], []
    for i in range(n_rep):
        p = _layer(params, "u0", i)
        h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
        attn_out, (k, v) = L.attention(p, h, cfg, positions=positions)
        x = x + attn_out
        x = x + L.mlp(p, L.rmsnorm(x, p["ln2"], cfg.norm_eps))
        ks.append(k.reshape(B, S, -1))
        vs.append(v.reshape(B, S, -1))
    logits = logits_from_hidden(params, cfg, x)
    k, v = torch.stack(ks), torch.stack(vs)  # (n_rep, B, S, kvd)
    if kv_mode == "paged":
        cache = pool_from_prefill(cfg, k, v, S)
    elif kv_mode == "full":
        kf = torch.zeros((n_rep, B, max_len, k.shape[-1]), dtype=k.dtype, device=k.device)
        vf = torch.zeros_like(kf)
        kf[:, :, :S], vf[:, :, :S] = k, v
        cache = {"k": kf, "v": vf}
    else:
        raise ValueError(f"unknown kv_mode {kv_mode!r}")
    return logits, {"pos": S, "blocks": {"u0": cache}}


def _stack_layers(t: torch.Tensor, n_rep: int) -> torch.Tensor:
    return t[None].expand(n_rep, *t.shape).contiguous()


def pool_from_prefill(cfg, k: torch.Tensor, v: torch.Tensor, S: int):
    """Seed a stacked pool from prefill KV (n_rep, B, S, kvd): the last
    ``bounded_kv_pages`` page-aligned pages are resident with F=1 and R =
    creation order; the clock is the number of resident pages.  A
    true-adaptive ``kv_policy`` also gets ARC/CAR planes seeded with those
    pages (``paged_kv.seed_adaptive_state``)."""
    page, P = cfg.page_size, cfg.bounded_kv_pages
    n_rep, B, _, kvd = k.shape
    n_have = S // page
    n_res = min(n_have, P)
    start_tok = (n_have - n_res) * page
    dev = k.device
    kp = torch.zeros((n_rep, B, P, page, kvd), dtype=k.dtype, device=dev)
    vp = torch.zeros_like(kp)
    span = slice(start_tok, start_tok + n_res * page)
    kp[:, :, :n_res] = k[:, :, span].reshape(n_rep, B, n_res, page, kvd)
    vp[:, :, :n_res] = v[:, :, span].reshape(n_rep, B, n_res, page, kvd)
    order = torch.arange(P, dtype=torch.int32, device=dev)
    res = order < n_res
    zero = torch.zeros((), dtype=torch.int32, device=dev)

    def plane(t):
        return t.to(torch.int32).expand(n_rep, B, P).contiguous()

    pool = paged_kv.PagedPool(
        k=kp, v=vp,
        f=plane(torch.where(res, 1, zero)),
        r=plane(torch.where(res, order + 1, zero)),
        page_start=plane(torch.where(res, start_tok + order * page, -1)),
        clock=torch.full((n_rep, B), n_res, dtype=torch.int32, device=dev),
        open_slot=torch.full((n_rep, B), max(n_res - 1, 0), dtype=torch.int32,
                             device=dev),
    )
    if cfg.kv_policy not in paged_kv.TRUE_ADAPTIVE_KV:
        return pool
    seed = paged_kv.seed_adaptive_state(B, P, start_tok // page, n_res, device=dev)
    return paged_kv.AdaptivePagedPool(
        pool, AdaptiveState(*(_stack_layers(t, n_rep) for t in seed)))


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def decode_caches(cfg, batch: int, max_len: int, *, kv_mode: str = "full",
                  device="cuda"):
    """Empty decode caches (stacked on the layer axis), positioned at 0."""
    dev = resolve_device(device)
    _, n_rep, _ = scan_plan(cfg)
    dtype = torch_dtype(cfg.dtype)
    if kv_mode == "paged" and cfg.kv_policy in paged_kv.TRUE_ADAPTIVE_KV:
        one = paged_kv.init_adaptive_pool(batch, cfg.bounded_kv_pages,
                                          cfg.page_size, cfg.kv_dim, dtype,
                                          cfg.kv_policy, device=dev)
        cache = paged_kv.AdaptivePagedPool(
            paged_kv.PagedPool(*(_stack_layers(t, n_rep) for t in one.pool)),
            AdaptiveState(*(_stack_layers(t, n_rep) for t in one.policy)))
    elif kv_mode == "paged":
        one = paged_kv.init_pool(batch, cfg.bounded_kv_pages, cfg.page_size,
                                 cfg.kv_dim, dtype, device=dev)
        cache = paged_kv.PagedPool(*(_stack_layers(t, n_rep) for t in one))
    elif kv_mode == "full":
        shape = (n_rep, batch, max_len, cfg.kv_dim)
        cache = {"k": torch.zeros(shape, dtype=dtype, device=dev),
                 "v": torch.zeros(shape, dtype=dtype, device=dev)}
    else:
        raise ValueError(f"unknown kv_mode {kv_mode!r}")
    return {"pos": 0, "blocks": {"u0": cache}}


def _decode_block(p: Params, x: torch.Tensor, cfg, cache, pos: int,
                  kv_mode: str, fused: bool):
    """One ``attn`` block at decode; returns (x, new cache of this layer)."""
    B = x.shape[0]
    h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    nk, nv = L.decode_kv_row(p, h, cfg, position=pos)
    if kv_mode == "paged":
        adaptive = isinstance(cache, paged_kv.AdaptivePagedPool)
        if adaptive:
            core = paged_kv.adaptive_core(cfg.kv_policy, B, cfg.bounded_kv_pages)
        if fused:
            # one CUDA launch: victim selection + attention over the pool +
            # policy-plane update (kernels/csrc/policy_attn.cu, adaptive_attn.cu)
            q = L.decode_q(p, h, cfg, position=pos)
            if adaptive:
                out, _, new_cache = paged_kv.fused_adaptive_decode_step(
                    cache, q, nk[:, 0], nv[:, 0], pos, cfg.page_size, core)
            else:
                out, _, new_cache = paged_kv.fused_decode_step(
                    cache, q, nk[:, 0], nv[:, 0], pos, cfg.page_size,
                    cfg.kv_policy)
            attn_out = L.decode_project_out(p, out.to(x.dtype), cfg)
        else:
            if adaptive:
                apool = paged_kv.adaptive_insert_token(
                    cache, nk[:, 0], nv[:, 0], pos, cfg.page_size, core)
                pool = apool.pool
            else:
                pool = paged_kv.insert_token(cache, nk[:, 0], nv[:, 0], pos,
                                             cfg.page_size, policy=cfg.kv_policy)
            P, page = pool.f.shape[1], cfg.page_size
            attn_out, mass = L.decode_attend(
                p, h, cfg, position=pos, k_cache=pool.k.reshape(B, P * page, -1),
                v_cache=pool.v.reshape(B, P * page, -1),
                kv_positions=paged_kv.kv_positions(pool, pos, page))
            new_cache = (paged_kv.adaptive_score_update(apool, mass, page, core)
                         if adaptive else paged_kv.score_update(pool, mass, page))
    elif kv_mode == "full":
        k, v = paged_kv.full_cache_insert(cache["k"], cache["v"], nk, nv, pos)
        T = k.shape[1]
        t = torch.arange(T, dtype=torch.int32, device=x.device)
        kv_pos = torch.where(t <= pos, t, -1)[None].expand(B, T)
        attn_out, _ = L.decode_attend(p, h, cfg, position=pos, k_cache=k,
                                      v_cache=v, kv_positions=kv_pos)
        new_cache = {"k": k, "v": v}
    else:
        raise ValueError(f"unknown kv_mode {kv_mode!r}")
    x = x + attn_out
    x = x + L.mlp(p, L.rmsnorm(x, p["ln2"], cfg.norm_eps))
    return x, new_cache


def decode_step(params: Params, cfg, token: torch.Tensor, caches,
                *, kv_mode: str = "full", fused: bool = False):
    """One serving step: token (B, 1) int -> (logits (B, 1, Vpad), caches).

    ``fused=True`` routes the paged blocks through the fused CUDA policy
    kernel (one launch per layer); decisions equal the unfused path's."""
    unit, n_rep, _ = scan_plan(cfg)
    pos = caches["pos"]
    x = _embed(params, cfg, token)
    cache = caches["blocks"]["u0"]
    planes = []
    for i in range(n_rep):
        x, new = _decode_block(_layer(params, "u0", i), x, cfg,
                               _layer_cache(cache, i), pos, kv_mode, fused)
        planes.append(new)
    logits = logits_from_hidden(params, cfg, x)
    return logits, {"pos": pos + 1, "blocks": {"u0": _restack(cache, planes)}}


def _layer_cache(cache, i: int):
    """Layer ``i``'s view of a stacked decode cache (K/V share storage)."""
    if isinstance(cache, paged_kv.AdaptivePagedPool):
        return paged_kv.AdaptivePagedPool(_layer_cache(cache.pool, i),
                                          AdaptiveState(*(t[i] for t in cache.policy)))
    if isinstance(cache, paged_kv.PagedPool):
        return paged_kv.PagedPool(*(t[i] for t in cache))
    return {"k": cache["k"][i], "v": cache["v"][i]}


def _restack(cache, layers):
    """The stacked cache after a step: K/V were written in place; the planes
    of every layer's new cache are stacked again."""
    if isinstance(cache, paged_kv.AdaptivePagedPool):
        return paged_kv.AdaptivePagedPool(
            _restack(cache.pool, [c.pool for c in layers]),
            AdaptiveState(*(torch.stack(ts) for ts in zip(*(c.policy for c in layers)))))
    if isinstance(cache, paged_kv.PagedPool):
        return paged_kv.PagedPool(
            k=cache.k, v=cache.v,
            **{name: torch.stack([getattr(c, name) for c in layers])
               for name in ("f", "r", "page_start", "clock", "open_slot")})
    return cache


def clone_caches(caches):
    """Deep copy of a decode-cache tree (for a caller that keeps it while
    decoding continues in place)."""
    cache = caches["blocks"]["u0"]
    copy = (cache.clone() if isinstance(cache, (paged_kv.PagedPool,
                                                paged_kv.AdaptivePagedPool))
            else {k: v.clone() for k, v in cache.items()})
    return {"pos": caches["pos"], "blocks": {"u0": copy}}
