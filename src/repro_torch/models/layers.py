"""Layers in plain PyTorch (``repro/models/layers.py``): dense attention
(with the optional q/k/v biases, added before RoPE; self- or
cross-attention, causal or not) and MLP blocks, the top-k MoE FFN and the
Mamba-2 (SSD) block.

Conventions, as in the reference:
  * activations (B, S, D) in the config's dtype; softmax and norms in f32;
  * parameters keep FLATTENED feature dims (``n_heads*head_dim``) and the
    reference's (in, out) layout, so ``x @ w`` is the reference's einsum;
  * prefill attention (``attention``) runs kernel 6, the flash-attention
    CUDA kernel (``kernels/ops.py`` ``flash_attention``; its plain version
    on the CPU): causal with the block's sliding window, or non-causal
    without RoPE (whisper's encoder), or cross-attention over K/V of another
    length (``kv_override``, whisper's decoder); the reference computes the
    same function as a chunked jnp loop.
    The decode-time paged attention is the CUDA kernel
    (``cache/paged_kv.py`` ``fused_decode_step``); ``decode_attend`` is the
    unfused plain path, the local layers' ring-cache attention and whisper's
    decode attention (self and cross, as plain jnp in the reference);
  * whisper's positions are the fixed ``sinusoidal_positions`` (no RoPE);
  * ``moe`` is the reference's sort-based dispatch with per-sequence
    capacity, its products ``torch.einsum`` as the reference leaves them to
    XLA (no Pallas kernel there): every expert runs over its capacity
    buffer, at decode too; differentiable to x, the gates and the router
    (the dispatch's index writes carry their gradients);
    ``moe_aux_loss`` is the reference's load-balancing loss;
  * the Mamba-2 block (``ssd_chunked``, ``mamba2_block``,
    ``mamba2_decode_step``) is the reference's chunked SSD scan and its
    O(1) recurrent step in torch ops, as the reference leaves them to XLA
    (no Pallas kernel there): the chunk recurrence and the decode state in
    f32, the causal depthwise conv tap by tap in the activation dtype;
  * every hot intermediate is constrained with ``logical_shard`` where the
    reference constrains it (an identity off a mesh).  On a mesh (the
    placed train step, ``train/train_step.py``) the layers run on DTensors:
    kernel 6 on each shard's local heads under ``local_map`` (``_flash``),
    heads replicated where the kv heads do not divide "model"
    (``_head_feat``), the MoE routing, dispatch and combine on each batch
    shard's whole sequences (``_per_sequence``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.sharding.specs import logical_shard, shards_of

Params = Dict[str, Any]

NEG_INF = -1e30


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm with a ``(1 + scale)`` gain (scales initialise to zero)."""
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.to(torch.float32))).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding on halves (not interleaved pairs).  x (B, S, H, hd);
    positions (B, S) int."""
    hd = x.shape[-1]
    half = hd // 2
    exponent = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    # theta filled on the device, not copied from the host: a decode step
    # makes no host-to-device copy (a CUDA graph captures it)
    freq = torch.pow(torch.full((), theta, dtype=torch.float32, device=x.device), exponent)
    ang = positions[..., None].to(torch.float32) * freq  # (B, S, half)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(positions: torch.Tensor, d: int) -> torch.Tensor:
    """(B, S) int -> (B, S, d) f32 fixed sinusoidal embedding (whisper's):
    ``[sin(p * f), cos(p * f)]`` with ``f_i = exp(-ln(1e4) * i / max(half - 1,
    1))``, as the reference computes it in f32.  The caller casts it to the
    activation dtype before adding it."""
    half = d // 2
    i = torch.arange(half, dtype=torch.float32, device=positions.device)
    freq = torch.exp(-math.log(10_000.0) * i / max(half - 1, 1))
    ang = positions[..., None].to(torch.float32) * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def mlp(params: Params, x: torch.Tensor, act: str) -> torch.Tensor:
    """Feed-forward: SwiGLU, or GELU in its tanh form (``jax.nn.gelu``'s
    default; torch's default is the exact erf form)."""
    feat = ("act_batch", "act_seq", "act_feat")
    if act == "swiglu":
        h = F.silu(logical_shard(x @ params["w_gate"], *feat)) * logical_shard(
            x @ params["w_up"], *feat)
    elif act == "gelu":
        h = F.gelu(logical_shard(x @ params["w_up"], *feat), approximate="tanh")
    else:
        raise ValueError(f"unknown act {act!r}")
    return logical_shard(h @ params["w_down"], "act_batch", "act_res_seq", "act_embed")


def _head_feat(cfg) -> Optional[str]:
    """The logical name of a flattened per-head feature dim: ``"act_feat"``
    where the kv heads divide its shards, so each shard holds whole kv heads
    and their query groups; otherwise None (replicated).  GSPMD pads an
    uneven split; DTensor cannot view a flattened ``heads * hd`` dim split
    off a head boundary, so those heads are computed whole on every shard
    (smollm: 5 kv heads at full width, 1 at its smoke config)."""
    return "act_feat" if cfg.n_kv_heads % shards_of("act_feat") == 0 else None


def _project_qkv(params: Params, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, ...]:
    B, S, _ = x.shape
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = x @ params["wq"], x @ params["wk"], x @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    names = ("act_batch", "act_seq", _head_feat(cfg))
    q, k, v = (logical_shard(t, *names) for t in (q, k, v))
    return (q.reshape(B, S, KVH, H // KVH, hd), k.reshape(B, S, KVH, hd),
            v.reshape(B, S, KVH, hd))


def attention(params: Params, x: torch.Tensor, cfg, *, causal: bool = True,
              window: int = 0, use_rope: bool = True,
              kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
              ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence attention (prefill) of the queries at positions
    ``arange(S)`` over keys at ``arange(Skv)``, through kernel 6
    (``ops.flash_attention``): causal or not, with the block's sliding
    ``window`` (0 = none).  RoPE on q and k unless ``use_rope=False``.
    ``kv_override=(k, v)`` (B, Skv, KVH, hd) is cross-attention: those K/V
    replace the block's own, q gets no RoPE and Skv may differ from S (the
    reference's ``kv_override``).  Every caller of the reference passes
    ``positions=arange(S)``, which kernel 6 masks by index, so the port takes
    no ``positions``.  ``cfg.attention_schedule`` "balanced" runs kernel 6
    as "rect" does: the reference's ``flash_attention_balanced`` pairs query
    chunks to skip the masked half of a causal product, and kernel 6 skips
    every tile above the diagonal whatever the schedule.  Returns (out, (k,
    v)) so prefill can keep the KV cache; k is RoPE'd when q is."""
    B, S, _ = x.shape
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if kv_override is None:
        q, k, v = _project_qkv(params, x, cfg)
    else:
        q = x @ params["wq"]
        if cfg.qkv_bias:
            q = q + params["bq"]
        q = logical_shard(q, "act_batch", "act_seq", _head_feat(cfg))
        q = q.reshape(B, S, KVH, H // KVH, hd)
        k, v = kv_override
    if use_rope and kv_override is None:
        pos2 = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
        q = rope(q.reshape(B, S, H, hd), pos2, cfg.rope_theta).reshape(B, S, KVH, H // KVH, hd)
        k = rope(k, pos2, cfg.rope_theta)
    out = _flash(q.contiguous(), k.contiguous(), v.contiguous(), causal, window)
    out = logical_shard(out.reshape(B, S, H * hd), "act_batch", "act_seq", "act_feat")
    proj = logical_shard(out @ params["wo"], "act_batch", "act_res_seq", "act_embed")
    return proj, (k, v)


def _flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           window: int) -> torch.Tensor:
    """Kernel 6 (``ops.flash_attention``).  On DTensors it runs under
    ``local_map``: each shard's local heads (q's kv-head dim 2, or its batch
    dim 0) go to the kernel as plain contiguous tensors, k and v placed as
    q; the output keeps q's placements.  Any other placement raises."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    if not isinstance(q, DTensor):
        return ops.flash_attention(q, k, v, causal=causal, window=window)
    mesh = q.device_mesh
    # a mesh dim of size 1 holds the whole tensor whatever its placement
    pl = tuple(Replicate() if mesh.size(i) == 1 else p for i, p in enumerate(q.placements))
    if any(not (isinstance(p, Replicate) or p in (Shard(0), Shard(2))) for p in pl):
        raise ValueError(f"flash attention: q placed {pl}; heads (dim 2) or batch "
                         "(dim 0) shards only")
    q, k, v = (t.redistribute(mesh, pl) for t in (q, k, v))
    fn = local_map(lambda a, b, c: ops.flash_attention(a.contiguous(), b.contiguous(),
                                                       c.contiguous(), causal=causal,
                                                       window=window),
                   out_placements=list(pl), in_placements=(list(pl),) * 3,
                   device_mesh=mesh)
    return fn(q, k, v)


def _positions(position: torch.Tensor, B: int) -> torch.Tensor:
    """The decode token's (B, 1) positions from the shared 0-d int32
    ``position`` (a broadcast on the device)."""
    return position.reshape(1, 1).expand(B, 1)


def decode_kv_row(params: Params, x: torch.Tensor, cfg, *, position: torch.Tensor,
                  use_rope: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """New token's (k, v) rows, k RoPE'd at ``position`` (0-d int32) unless
    ``use_rope=False``: (B, 1, D) -> (B, 1, kvd) each."""
    B = x.shape[0]
    KVH, hd = cfg.n_kv_heads, cfg.head_dim
    k_new, v_new = x @ params["wk"], x @ params["wv"]
    if cfg.qkv_bias:
        k_new, v_new = k_new + params["bk"], v_new + params["bv"]
    names = ("act_batch", "act_seq", _head_feat(cfg))
    k_new, v_new = logical_shard(k_new, *names), logical_shard(v_new, *names)
    if use_rope:
        k_new = rope(k_new.reshape(B, 1, KVH, hd), _positions(position, B),
                     cfg.rope_theta).reshape(B, 1, KVH * hd)
    return k_new, v_new


def decode_q(params: Params, x: torch.Tensor, cfg, *, position: torch.Tensor,
             use_rope: bool = True) -> torch.Tensor:
    """The query half of ``decode_attend``: (B, 1, D) -> (B, KVH, G, hd)
    grouped queries, RoPE'd at ``position`` (0-d int32) unless
    ``use_rope=False``."""
    B = x.shape[0]
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ params["wq"]
    if cfg.qkv_bias:
        q = q + params["bq"]
    q = logical_shard(q, "act_batch", "act_seq", _head_feat(cfg)).reshape(B, 1, H, hd)
    if use_rope:
        q = rope(q, _positions(position, B), cfg.rope_theta)
    return q.reshape(B, KVH, H // KVH, hd)


def decode_project_out(params: Params, out: torch.Tensor, cfg) -> torch.Tensor:
    """The output half of ``decode_attend``: (B, KVH, G, hd) -> (B, 1, D)."""
    return _project_row(params, out, cfg)


def _project_row(params: Params, out: torch.Tensor, cfg) -> torch.Tensor:
    """(B, ..., H, hd) attention rows -> (B, 1, D) through ``wo``, as one
    (B, H*hd) x (H*hd, D) product: the one ``matmul`` makes of a plain (B,
    1, H*hd) row, which a DTensor's size-1 stride would turn into a batched
    product of other rounding."""
    B = out.shape[0]
    out = logical_shard(out.reshape(B, cfg.n_heads * cfg.head_dim), "act_batch", "act_feat")
    return logical_shard((out @ params["wo"])[:, None], "act_batch", "act_res_seq",
                         "act_embed")


def decode_attend(params: Params, x: torch.Tensor, cfg, *, position: torch.Tensor,
                  k_cache: torch.Tensor, v_cache: torch.Tensor,
                  kv_positions: torch.Tensor, use_rope: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token attention over a (B, T, kvd) cache that already holds the
    new row (q RoPE'd at ``position`` unless ``use_rope=False``; rows whose
    ``kv_positions`` are negative masked).  Returns (out (B, 1, D),
    attn_mass (B, T)), the per-row softmax mass the AWRP hit rule reads."""
    B = x.shape[0]
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = decode_q(params, x, cfg, position=position,
                 use_rope=use_rope)[:, None]  # (B, 1, KVH, G, hd)
    # whole kv heads per shard, or the heads replicated (``_head_feat``)
    feat = _head_feat(cfg)
    kv_ax = "act_kv_heads" if feat else None
    kc = logical_shard(logical_shard(k_cache, "act_batch", "act_pages", feat)
                       .reshape(B, -1, KVH, hd), "act_batch", "act_pages", kv_ax, None)
    vc = logical_shard(logical_shard(v_cache, "act_batch", "act_pages", feat)
                       .reshape(B, -1, KVH, hd), "act_batch", "act_pages", kv_ax, None)
    scale = 1.0 / math.sqrt(hd)
    if _is_dtensor(q) and not _splits(kc, 1):
        out, mass = _placed_attend(q, kc, vc, kv_positions, scale)
    else:
        # plain tensors, or keys split over shards (a batch-1 pool's pages):
        # DTensor gathers the scores and sums the partial P.V products
        out, mass = _attend_rows(q, kc, vc, kv_positions, scale)
    return _project_row(params, out, cfg), mass


def _attend_rows(q, kc, vc, kv_positions, scale: float):
    """``decode_attend``'s core: q (B, 1, KVH, G, hd) over kc / vc (B, T,
    KVH, hd), rows whose ``kv_positions`` are negative masked; returns (out
    (B, 1, KVH, G, hd), the rows' softmax mass (B, T))."""
    s = torch.einsum("bqkgh,btkh->bkgqt", q, kc).to(torch.float32)
    s = s * scale
    valid = (kv_positions >= 0)[:, None, None, None, :]
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqt,btkh->bqkgh", p.to(vc.dtype), vc)
    return out, p.sum(dim=(1, 2, 3))


def _splits(t, dim: int) -> bool:
    """Whether a DTensor ``t`` is split along ``dim`` on some mesh dim of
    more than one piece."""
    from torch.distributed.tensor import Shard

    return any(p == Shard(dim) and t.device_mesh.size(i) > 1
               for i, p in enumerate(t.placements))


def _placed_attend(q, kc, vc, kv_positions, scale: float):
    """``_attend_rows`` on DTensors whose keys are whole on every shard:
    under ``local_map``, each shard its sequences (dim 0) and kv heads (dim
    2), as q holds them (any other split of q made whole first); the mass,
    summed over heads, is a partial sum where the heads are split."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    keep = [p if p in (Shard(0), Shard(2)) else Replicate() for p in q.placements]
    rows = [Shard(0) if p == Shard(0) else Replicate() for p in keep]
    mass = [Shard(0) if p == Shard(0) else Partial() if p == Shard(2) else Replicate()
            for p in keep]
    if not isinstance(kv_positions, DTensor):
        kv_positions = DTensor.from_local(kv_positions, mesh, [Replicate()] * mesh.ndim,
                                          run_check=False)
    args = (q.redistribute(mesh, keep), kc.redistribute(mesh, keep),
            vc.redistribute(mesh, keep), kv_positions.redistribute(mesh, rows))
    return local_map(lambda *ts: _attend_rows(*ts, scale), out_placements=(keep, mass),
                     in_placements=(keep, keep, keep, rows), device_mesh=mesh)(*args)


# ---------------------------------------------------------------------------
# MoE (sort-based dispatch, per-sequence capacity)
# ---------------------------------------------------------------------------


def moe_capacity(S: int, cfg) -> int:
    """Slots per expert per sequence, in Python floats as the reference
    computes them: ``max(8, int(S * K / E * capacity_factor))``."""
    return max(8, int(S * cfg.top_k / cfg.n_experts * cfg.capacity_factor))


class Routing(NamedTuple):
    """One batch's routing, every tensor (B, S*K) in the reference's
    expert-sorted pair order unless noted."""

    gate: torch.Tensor  # (B, S, K) f32, normalised over the K choices
    expert_idx: torch.Tensor  # (B, S, K) int64, best first
    order: torch.Tensor  # pair index (s * K + k) at each sorted position
    sorted_e: torch.Tensor  # expert of each sorted pair
    rank: torch.Tensor  # its rank among its expert's pairs
    keep: torch.Tensor  # bool: rank < capacity


def route(logits: torch.Tensor, top_k: int, capacity: int) -> Routing:
    """Top-k routing and dispatch order from f32 router logits (B, S, E).

    Both sorts are stable, so ties resolve as ``jax.lax.top_k`` and
    ``jnp.argsort(..., stable=True)`` resolve them: the lower index first
    (``torch.topk`` promises no tie order).  The softmax is written out as
    the reference's, ``exp(l - max) / sum``."""
    B, S, E = logits.shape
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = e / e.sum(dim=-1, keepdim=True)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert_idx = top[..., :top_k], idx[..., :top_k]
    gate = gate / torch.clamp(gate.sum(dim=-1, keepdim=True), min=1e-9)
    pairs_e = expert_idx.reshape(B, S * top_k)
    sorted_e, order = torch.sort(pairs_e, dim=-1, stable=True)
    counts = torch.zeros((B, E), dtype=torch.int64, device=logits.device)
    counts.scatter_add_(1, pairs_e, torch.ones_like(pairs_e))
    starts = torch.cumsum(counts, dim=-1) - counts
    rank = (torch.arange(S * top_k, device=logits.device)[None]
            - torch.gather(starts, 1, sorted_e))
    return Routing(gate, expert_idx, order, sorted_e, rank, rank < capacity)


def moe(params: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    """Top-k MoE FFN over (B, S, D), as ``repro.models.layers.moe``: each
    sequence dispatches its S*K token-expert pairs sorted by expert, the
    first ``moe_capacity`` of each expert kept (GShard-style dropping); a
    (B, E, C, D) buffer through every expert's FFN; each token's output the
    sum of its kept pairs' rows times their gates (cast to ``x.dtype``).

    Only kept pairs are written into the buffer (the reference scatter-adds
    zero rows for the dropped ones onto rank C - 1: the same values).  The
    combine adds each token's contributions onto zero, which rounds once
    whatever the order for K <= 2, so it equals the reference's scatter-add;
    a larger K is refused.

    On a mesh the expert products run on DTensors (experts or their d_ff
    over "model", ``moe_sharding``); the routing, the dispatch and the
    combine read across a sequence's tokens and experts, so they run on
    whole sequences: per batch shard, each sequence whole over every other
    mesh dim (``_per_sequence``), from the same router logits."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    if not 1 <= K <= 2:
        raise NotImplementedError(f"moe: the combine is exact for top_k <= 2, got {K}")
    C = moe_capacity(S, cfg)
    logits = torch.einsum("bsd,de->bse", x, params["w_router"]).to(torch.float32)
    r = Routing(*_per_sequence(lambda lg: route(lg, K, C), logits,
                               n_out=len(Routing._fields)))
    pairs = (r.order, r.sorted_e, r.rank, r.keep)
    buf = _per_sequence(_dispatch, x, *pairs, top_k=K, n_experts=E, capacity=C)
    buf = logical_shard(buf, "act_batch", "act_experts", None, "act_embed")

    ff = ("act_batch", "act_experts", None, "act_expert_ff")
    if cfg.act == "swiglu":
        h = F.silu(logical_shard(torch.einsum("becd,edf->becf", buf, params["w_gate"]), *ff))
        h = h * logical_shard(torch.einsum("becd,edf->becf", buf, params["w_up"]), *ff)
    elif cfg.act == "gelu":
        h = F.gelu(logical_shard(torch.einsum("becd,edf->becf", buf, params["w_up"]), *ff),
                   approximate="tanh")
    else:
        raise ValueError(f"unknown act {cfg.act!r}")
    if _is_dtensor(h):
        # DTensor's einsum views its local piece, which the products above
        # leave permuted where the batch is split
        h = h.contiguous()
    eout = torch.einsum("becf,efd->becd", h, params["w_down"])
    eout = logical_shard(eout, "act_batch", "act_experts", None, "act_embed")
    out = _per_sequence(_combine, eout, r.gate, *pairs, top_k=K, dtype=x.dtype)
    return logical_shard(out, "act_batch", "act_res_seq", "act_embed")


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _per_sequence(fn, *tensors: torch.Tensor, n_out: int = 1, **kw):
    """``fn(*tensors, **kw)`` for a ``fn`` that reads each row of dim 0 (a
    sequence) alone and returns rows in the same order: on DTensors each
    input keeps dim 0 split as the first input places it (the batch axes)
    and is made whole over every other mesh dim, and ``fn`` runs on the
    local rows under ``local_map``, its outputs placed alike.  So a batch
    shard holds its own sequences only, not the global batch.  A dim 0 the
    split does not divide evenly is refused: the rows would not be a batch
    shard's own sequences."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(tensors[0], DTensor):
        return fn(*tensors, **kw)
    from torch.distributed.tensor.experimental import local_map

    mesh = tensors[0].device_mesh
    pls = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
           for p in tensors[0].placements]
    n = 1
    for d, p in enumerate(pls):
        n *= mesh.size(d) if isinstance(p, Shard) else 1
    if tensors[0].shape[0] % n:
        raise ValueError(f"_per_sequence: {tensors[0].shape[0]} sequences do not split "
                         f"evenly over {n} batch shards")
    rows = [t.redistribute(mesh, pls) for t in tensors]
    return local_map(lambda *ts: fn(*ts, **kw),
                     out_placements=pls if n_out == 1 else (pls,) * n_out,
                     in_placements=(pls,) * len(rows), device_mesh=mesh)(*rows)


def _slots(order, sorted_e, rank, keep, n_experts: int, capacity: int) -> torch.Tensor:
    """Each sorted pair's row of the flat (B*E*C + 1, D) buffer: kept pairs
    at their (expert, rank) slot, dropped ones at the spare last row, so no
    pair needs a host-side mask."""
    B, E, C = order.shape[0], n_experts, capacity
    b = torch.arange(B, device=order.device)[:, None]
    return torch.where(keep, (b * E + sorted_e) * C + rank, B * E * C)


def _dispatch(x: torch.Tensor, order, sorted_e, rank, keep, *, top_k: int,
              n_experts: int, capacity: int) -> torch.Tensor:
    """The (B, E, C, D) expert buffer of x's kept token-expert pairs (the
    ``Routing`` fields in its sorted pair order)."""
    B, S, D = x.shape
    E, C = n_experts, capacity
    b = torch.arange(B, device=x.device)[:, None]
    buf = torch.zeros((B * E * C + 1, D), dtype=x.dtype, device=x.device)
    buf[_slots(order, sorted_e, rank, keep, E, C).reshape(-1)] = \
        x[b, order // top_k].reshape(-1, D)
    return buf[:-1].view(B, E, C, D)


def _combine(eout: torch.Tensor, gate, order, sorted_e, rank, keep, *, top_k: int,
             dtype: torch.dtype) -> torch.Tensor:
    """Each token's output from the experts' (B, E, C, D) rows: the sum of
    its kept pairs' rows times their gates, the gates cast to ``dtype``
    (the activations')."""
    B, E, C, D = eout.shape
    S, K = gate.shape[1], top_k
    slot = _slots(order, sorted_e, rank, keep, E, C)
    b = torch.arange(B, device=eout.device)[:, None]
    w = torch.gather(gate.reshape(B, S * K), 1, order)
    rows = eout.reshape(-1, D)[torch.where(keep, slot, 0).reshape(-1)] * w.reshape(-1, 1).to(dtype)
    rows = torch.where(keep.reshape(-1, 1), rows, 0)
    # back to pair order (s * K + k), then each token's K contributions
    contrib = torch.empty_like(rows).index_copy_(0, (b * S * K + order).reshape(-1), rows)
    contrib = contrib.view(B, S, K, D)
    return contrib[:, :, 0] if K == 1 else contrib[:, :, 0] + contrib[:, :, 1]


def moe_aux_loss(params: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    """Switch-style load-balancing loss E * sum_e f_e * P_e over x (B, S,
    D) (``repro.models.layers.moe_aux_loss``): f the share of tokens whose
    top-1 expert is e (the first on a tie), P the mean router probability
    of e, both over the B * S tokens, in f32.  As in the reference, nothing
    adds it to the training loss."""
    E = cfg.n_experts
    logits = torch.einsum("bsd,de->bse", x, params["w_router"]).to(torch.float32)
    probs = torch.softmax(logits, dim=-1).reshape(-1, E)
    f = F.one_hot(probs.argmax(dim=-1), E).to(torch.float32).mean(dim=0)
    return E * (f * probs.mean(dim=0)).sum()


# ---------------------------------------------------------------------------
# Mamba-2 (SSD: state-space duality, chunked)
# ---------------------------------------------------------------------------


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x (..., T) -> (..., T, T) with out[i, j] = sum_{j<k<=i} x[k], -inf
    above the diagonal (the difference of two cumulative sums, as the
    reference computes it)."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    return out.masked_fill(~mask, -math.inf)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                Cm: torch.Tensor, chunk: int,
                initial_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba-2 SSD forward, chunked: x (B, S, H, P), dt (B, S, H) after the
    softplus, A (H,) negative, Bm / Cm (B, S, N), ``initial_state`` (B, H,
    P, N) or None.  Returns (y (B, S, H, P) in x's dtype, the final state
    (B, H, P, N) f32).  S is zero-padded to a multiple of ``chunk``; the
    intra-chunk products, the per-chunk states, the inter-chunk recurrence
    and the inter-chunk output run in f32, as in the reference (its bf16
    C.B product is cast to f32 after the product)."""
    if _is_dtensor(x):
        return _placed_ssd(x, dt, A, Bm, Cm, chunk, initial_state)
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    S = x.shape[1]
    nc = S // chunk
    f32 = torch.float32
    xc = x.reshape(b, nc, chunk, h, p).to(f32)
    dtc = dt.reshape(b, nc, chunk, h).to(f32)
    Bc = Bm.reshape(b, nc, chunk, n)
    Cc = Cm.reshape(b, nc, chunk, n)

    dA = dtc * A.to(f32)  # (b, nc, q, h)
    dA_cs = torch.cumsum(dA, dim=2)

    # 1) intra-chunk (diagonal blocks)
    Lmat = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))  # (b, nc, h, q, q)
    scores = torch.einsum("bcqn,bckn->bcqk", Cc, Bc).to(f32)
    M = scores[:, :, None] * Lmat  # (b, nc, h, q, k)
    xdt = xc * dtc[..., None]  # (b, nc, q, h, p)
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", M, xdt)

    # 2) per-chunk input states
    decay_states = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)  # (b, nc, q, h)
    states = torch.einsum("bcqn,bcqh,bcqhp->bchpn", Bc.to(f32), decay_states * dtc, xc)

    # 3) inter-chunk recurrence: the state at each chunk's start
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])  # (b, nc, h)
    carry = (torch.zeros((b, h, p, n), dtype=f32, device=x.device)
             if initial_state is None else initial_state.to(f32))
    starts = []
    for c in range(nc):
        starts.append(carry)
        carry = states[:, c] + carry * chunk_decay[:, c, :, None, None]
    start_states = torch.stack(starts, dim=1)  # (b, nc, h, p, n)

    # 4) inter-chunk output
    state_decay_out = torch.exp(dA_cs)  # (b, nc, q, h)
    y_off = torch.einsum("bcqn,bchpn,bcqh->bcqhp", Cc.to(f32), start_states,
                         state_decay_out)
    y = (y_diag + y_off).reshape(b, S, h, p)[:, :s]
    return y.to(x.dtype), carry


def _placed_ssd(x, dt, A, Bm, Cm, chunk: int, initial_state):
    """``ssd_chunked`` on DTensors under ``local_map``: each shard its
    sequences (dim 0) and heads (x's dim 2), as x holds them (any other
    split of x made whole first); B and C, shared by the heads, whole over
    the heads' split.  The scan is per sequence and head, so each shard
    runs it on its own."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    keep = [p if p in (Shard(0), Shard(2)) else Replicate() for p in x.placements]
    rows = [Shard(0) if p == Shard(0) else Replicate() for p in keep]
    heads = [Shard(0) if p == Shard(2) else Replicate() for p in keep]
    state = [Shard(1) if p == Shard(2) else p for p in keep]
    args = [x.redistribute(mesh, keep), dt.redistribute(mesh, keep),
            A.redistribute(mesh, heads), Bm.redistribute(mesh, rows),
            Cm.redistribute(mesh, rows)]
    pls = [keep, keep, heads, rows, rows]
    if initial_state is not None:
        args.append(initial_state.redistribute(mesh, state))
        pls.append(state)

    def scan(*ts):
        return ssd_chunked(*ts[:5], chunk, initial_state=ts[5] if len(ts) > 5 else None)

    return local_map(scan, out_placements=(keep, state), in_placements=tuple(pls),
                     device_mesh=mesh)(*args)


def _split_zxbcdt(cfg, zxbcdt: torch.Tensor):
    d_in, N = cfg.d_inner, cfg.ssm_state
    conv_ch = d_in + 2 * N
    return torch.split(zxbcdt, [d_in, conv_ch, zxbcdt.shape[-1] - d_in - conv_ch], dim=-1)


def mamba2_block(params: Params, x: torch.Tensor, cfg, *,
                 initial_state: Optional[torch.Tensor] = None,
                 initial_conv: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The Mamba-2 block over the whole prompt (B, S, D): in-projection,
    the causal depthwise conv over xBC (the taps summed one by one in the
    activation dtype, in the reference's order, then the bias and SiLU),
    the SSD scan, the D skip, the gated RMS norm and the out-projection.
    Returns (y (B, S, D), the final SSM state (B, H, P, N) f32, the conv
    tail (B, d_conv - 1, d_inner + 2N)): a decode cache's ``MambaCache``."""
    B, S, _ = x.shape
    d_in, H, P, N = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    conv_ch = d_in + 2 * N
    z, xBC, dt = _split_zxbcdt(cfg, logical_shard(x @ params["w_in"], "act_batch",
                                                   "act_seq", "act_feat"))

    if initial_conv is None:
        initial_conv = torch.zeros((B, cfg.d_conv - 1, conv_ch), dtype=x.dtype,
                                   device=x.device)
    xpad = torch.cat([initial_conv, xBC], dim=1)
    conv_tail = xpad[:, xpad.shape[1] - (cfg.d_conv - 1):].contiguous()
    wconv = params["w_conv"]  # (d_conv, conv_ch)
    xconv = 0
    for i in range(cfg.d_conv):
        xconv = xconv + xpad[:, i:i + S] * wconv[i]
    xBC = F.silu(xconv + params["b_conv"])

    xs, Bm, Cm = torch.split(xBC, [d_in, N, N], dim=-1)
    dt = F.softplus(dt.to(torch.float32) + params["dt_bias"])
    A = -torch.exp(params["a_log"].to(torch.float32))  # (H,)
    y, final_state = ssd_chunked(xs.reshape(B, S, H, P), dt, A, Bm, Cm, cfg.ssm_chunk,
                                 initial_state=initial_state)
    y = y + xs.reshape(B, S, H, P) * params["d_skip"].to(x.dtype)[:, None]
    y = y.reshape(B, S, d_in)
    y = rmsnorm(y * F.silu(z), params["norm_scale"], cfg.norm_eps)
    out = logical_shard(y @ params["w_out"], "act_batch", "act_res_seq", "act_embed")
    return out, final_state, conv_tail


def mamba2_decode_step(params: Params, x: torch.Tensor, cfg, *, state: torch.Tensor,
                       conv_state: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The O(1) recurrent step: x (B, 1, D), ``state`` (B, H, P, N) f32,
    ``conv_state`` (B, d_conv - 1, d_inner + 2N).  Returns (y (B, 1, D), the
    new state, the new conv window): new tensors, the caches are replaced,
    not written in place."""
    B = x.shape[0]
    d_in, H, P, N = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    f32 = torch.float32
    z, xBC, dt = _split_zxbcdt(cfg, (x @ params["w_in"])[:, 0])

    xfull = torch.cat([conv_state, xBC[:, None, :]], dim=1)  # (B, d_conv, ch)
    xconv = torch.einsum("bkc,kc->bc", xfull, params["w_conv"]) + params["b_conv"]
    xBC = F.silu(xconv)
    new_conv = xfull[:, 1:]

    xs, Bm, Cm = torch.split(xBC, [d_in, N, N], dim=-1)
    dt = F.softplus(dt.to(f32) + params["dt_bias"])  # (B, H)
    A = -torch.exp(params["a_log"].to(f32))
    dA = torch.exp(dt * A)  # (B, H)
    xh = xs.reshape(B, H, P).to(f32)
    upd = torch.einsum("bn,bh,bhp->bhpn", Bm.to(f32), dt, xh)
    new_state = state * dA[..., None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", Cm.to(f32), new_state)
    y = y + xh * params["d_skip"].to(f32)[None, :, None]
    y = y.reshape(B, d_in).to(x.dtype)
    y = rmsnorm(y * F.silu(z), params["norm_scale"], cfg.norm_eps)
    return (y @ params["w_out"])[:, None, :], new_state, new_conv
