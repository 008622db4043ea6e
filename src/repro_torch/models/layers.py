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
    f32, the causal depthwise conv tap by tap in the activation dtype.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

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
    if act == "swiglu":
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    elif act == "gelu":
        h = F.gelu(x @ params["w_up"], approximate="tanh")
    else:
        raise ValueError(f"unknown act {act!r}")
    return h @ params["w_down"]


def _project_qkv(params: Params, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, ...]:
    B, S, _ = x.shape
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = x @ params["wq"], x @ params["wk"], x @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
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
    no ``positions``.  Returns (out, (k, v)) so prefill can keep the KV
    cache; k is RoPE'd when q is."""
    B, S, _ = x.shape
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if kv_override is None:
        q, k, v = _project_qkv(params, x, cfg)
    else:
        q = x @ params["wq"]
        if cfg.qkv_bias:
            q = q + params["bq"]
        q = q.reshape(B, S, KVH, H // KVH, hd)
        k, v = kv_override
    if use_rope and kv_override is None:
        pos2 = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
        q = rope(q.reshape(B, S, H, hd), pos2, cfg.rope_theta).reshape(B, S, KVH, H // KVH, hd)
        k = rope(k, pos2, cfg.rope_theta)
    out = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal=causal, window=window)
    return out.reshape(B, S, H * hd) @ params["wo"], (k, v)


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
    q = q.reshape(B, 1, H, hd)
    if use_rope:
        q = rope(q, _positions(position, B), cfg.rope_theta)
    return q.reshape(B, KVH, H // KVH, hd)


def decode_project_out(params: Params, out: torch.Tensor, cfg) -> torch.Tensor:
    """The output half of ``decode_attend``: (B, KVH, G, hd) -> (B, 1, D)."""
    B = out.shape[0]
    return out.reshape(B, 1, cfg.n_heads * cfg.head_dim) @ params["wo"]


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
    kc = k_cache.reshape(B, -1, KVH, hd)
    vc = v_cache.reshape(B, -1, KVH, hd)
    s = torch.einsum("bqkgh,btkh->bkgqt", q, kc).to(torch.float32)
    s = s * (1.0 / math.sqrt(hd))
    valid = (kv_positions >= 0)[:, None, None, None, :]
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqt,btkh->bqkgh", p.to(vc.dtype), vc)
    proj = out.reshape(B, 1, H * hd) @ params["wo"]
    return proj, p.sum(dim=(1, 2, 3))


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
    a larger K is refused."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    if not 1 <= K <= 2:
        raise NotImplementedError(f"moe: the combine is exact for top_k <= 2, got {K}")
    C = moe_capacity(S, cfg)
    logits = torch.einsum("bsd,de->bse", x, params["w_router"]).to(torch.float32)
    r = route(logits, K, C)

    b = torch.arange(B, device=x.device)[:, None]
    src_token = r.order // K  # (B, S*K) indices into S
    # kept pairs to their (expert, rank) slot; dropped ones to one spare row
    # past the buffer, so no pair needs a host-side mask
    slot = torch.where(r.keep, (b * E + r.sorted_e) * C + r.rank, B * E * C)
    buf = torch.zeros((B * E * C + 1, D), dtype=x.dtype, device=x.device)
    buf[slot.reshape(-1)] = x[b, src_token].reshape(-1, D)
    buf = buf[:-1].view(B, E, C, D)

    if cfg.act == "swiglu":
        h = F.silu(torch.einsum("becd,edf->becf", buf, params["w_gate"]))
        h = h * torch.einsum("becd,edf->becf", buf, params["w_up"])
    elif cfg.act == "gelu":
        h = F.gelu(torch.einsum("becd,edf->becf", buf, params["w_up"]),
                   approximate="tanh")
    else:
        raise ValueError(f"unknown act {cfg.act!r}")
    eout = torch.einsum("becf,efd->becd", h, params["w_down"]).reshape(-1, D)

    w = torch.gather(r.gate.reshape(B, S * K), 1, r.order)
    rows = eout[torch.where(r.keep, slot, 0).reshape(-1)] * w.reshape(-1, 1).to(x.dtype)
    rows = torch.where(r.keep.reshape(-1, 1), rows, 0)
    # back to pair order (s * K + k), then each token's K contributions
    contrib = torch.empty_like(rows).index_copy_(0, (b * S * K + r.order).reshape(-1), rows)
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
    z, xBC, dt = _split_zxbcdt(cfg, x @ params["w_in"])

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
    return y @ params["w_out"], final_state, conv_tail


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
