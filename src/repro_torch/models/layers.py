"""Dense decoder layers in plain PyTorch (``repro/models/layers.py``).

Conventions, as in the reference:
  * activations (B, S, D) in the config's dtype; softmax and norms in f32;
  * parameters keep FLATTENED feature dims (``n_heads*head_dim``) and the
    reference's (in, out) layout, so ``x @ w`` is the reference's einsum;
  * prefill attention (``attention``) runs kernel 6, the flash-attention
    CUDA kernel (``kernels/ops.py`` ``flash_attention``; its plain version
    on the CPU), causal with the block's sliding window; the reference
    computes the same function as a chunked jnp loop.
    The decode-time paged attention is the CUDA kernel
    (``cache/paged_kv.py`` ``fused_decode_step``); ``decode_attend`` is the
    unfused plain path and the local layers' ring-cache attention.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

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
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device), exponent)
    ang = positions[..., None].to(torch.float32) * freq  # (B, S, half)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


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
    return (q.reshape(B, S, KVH, H // KVH, hd), k.reshape(B, S, KVH, hd),
            v.reshape(B, S, KVH, hd))


def attention(params: Params, x: torch.Tensor, cfg, *, window: int = 0
              ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence causal self-attention (prefill) over positions
    ``arange(S)``, through kernel 6 (``ops.flash_attention``) with the
    block's sliding ``window`` (0 = none).  Returns (out, (k, v)) so prefill
    can keep the KV cache; k is RoPE'd."""
    B, S, _ = x.shape
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _project_qkv(params, x, cfg)
    pos2 = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    q = rope(q.reshape(B, S, H, hd), pos2, cfg.rope_theta).reshape(B, S, KVH, H // KVH, hd)
    k = rope(k, pos2, cfg.rope_theta)
    out = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal=True, window=window)
    return out.reshape(B, S, H * hd) @ params["wo"], (k, v)


def decode_kv_row(params: Params, x: torch.Tensor, cfg, *, position: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """New token's (k, v) rows, RoPE'd at ``position``: (B, 1, D) ->
    (B, 1, kvd) each."""
    B = x.shape[0]
    KVH, hd = cfg.n_kv_heads, cfg.head_dim
    k_new, v_new = x @ params["wk"], x @ params["wv"]
    pos = torch.full((B, 1), position, dtype=torch.int32, device=x.device)
    k_new = rope(k_new.reshape(B, 1, KVH, hd), pos, cfg.rope_theta).reshape(B, 1, KVH * hd)
    return k_new, v_new


def decode_q(params: Params, x: torch.Tensor, cfg, *, position: int) -> torch.Tensor:
    """The query half of ``decode_attend``: (B, 1, D) -> (B, KVH, G, hd)
    grouped queries, RoPE'd at ``position``."""
    B = x.shape[0]
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ params["wq"]
    pos = torch.full((B, 1), position, dtype=torch.int32, device=x.device)
    q = rope(q.reshape(B, 1, H, hd), pos, cfg.rope_theta)
    return q.reshape(B, KVH, H // KVH, hd)


def decode_project_out(params: Params, out: torch.Tensor, cfg) -> torch.Tensor:
    """The output half of ``decode_attend``: (B, KVH, G, hd) -> (B, 1, D)."""
    B = out.shape[0]
    return out.reshape(B, 1, cfg.n_heads * cfg.head_dim) @ params["wo"]


def decode_attend(params: Params, x: torch.Tensor, cfg, *, position: int,
                  k_cache: torch.Tensor, v_cache: torch.Tensor,
                  kv_positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token attention over a (B, T, kvd) cache that already holds the
    new row.  Returns (out (B, 1, D), attn_mass (B, T)), the per-row softmax
    mass the AWRP hit rule reads."""
    B = x.shape[0]
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = decode_q(params, x, cfg, position=position)[:, None]  # (B, 1, KVH, G, hd)
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
