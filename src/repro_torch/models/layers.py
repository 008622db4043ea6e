"""Dense decoder layers in plain PyTorch (``repro/models/layers.py``).

Conventions, as in the reference:
  * activations (B, S, D) in the config's dtype; softmax and norms in f32;
  * parameters keep FLATTENED feature dims (``n_heads*head_dim``) and the
    reference's (in, out) layout, so ``x @ w`` is the reference's einsum;
  * attention for prefill is a chunked flash-style loop (running max and
    denominator) in plain torch, the way the reference's is plain jnp.  The
    decode-time paged attention is the CUDA kernel (``cache/paged_kv.py``
    ``fused_decode_step``); ``decode_attend`` is the unfused plain path.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

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


def mlp(params: Params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU feed-forward."""
    return (F.silu(x @ params["w_gate"]) * (x @ params["w_up"])) @ params["w_down"]


def flash_attention(
    q: torch.Tensor,  # (B, Sq, KVH, G, hd)
    k: torch.Tensor,  # (B, Skv, KVH, hd)
    v: torch.Tensor,  # (B, Skv, KVH, hd)
    *,
    q_positions: torch.Tensor,  # (Sq,) int
    kv_positions: torch.Tensor,  # (Skv,) int, -1 = invalid
    q_chunk: int = 512,
    kv_chunk: int = 1024,
) -> torch.Tensor:
    """Causal chunked softmax attention with running (m, l, acc): the
    rectangular schedule of the reference, with block masking."""
    B, Sq, KVH, G, hd = q.shape
    Skv = k.shape[1]
    q_chunk, kv_chunk = min(q_chunk, Sq), min(kv_chunk, Skv)
    scale = 1.0 / math.sqrt(hd)
    outs = []
    for q0 in range(0, Sq, q_chunk):
        qc = q[:, q0:q0 + q_chunk]
        qpos = q_positions[q0:q0 + q_chunk]
        cq = qc.shape[1]
        m = torch.full((B, KVH, G, cq), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, KVH, G, cq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, KVH, G, cq, hd), dtype=torch.float32, device=q.device)
        for k0 in range(0, Skv, kv_chunk):
            kc, vc = k[:, k0:k0 + kv_chunk], v[:, k0:k0 + kv_chunk]
            kpos = kv_positions[k0:k0 + kv_chunk]
            s = torch.einsum("bqkgh,bckh->bkgqc", qc, kc).to(torch.float32) * scale
            mask = (kpos[None, :] >= 0) & (kpos[None, :] <= qpos[:, None])
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgqc,bckh->bkgqh", p.to(vc.dtype), vc)
            acc = acc * corr[..., None] + pv.to(torch.float32)
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))  # (B, cq, KVH, G, hd)
    return torch.cat(outs, dim=1).to(q.dtype)


def _project_qkv(params: Params, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, ...]:
    B, S, _ = x.shape
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = x @ params["wq"], x @ params["wk"], x @ params["wv"]
    return (q.reshape(B, S, KVH, H // KVH, hd), k.reshape(B, S, KVH, hd),
            v.reshape(B, S, KVH, hd))


def attention(params: Params, x: torch.Tensor, cfg, *, positions: torch.Tensor
              ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence causal self-attention (prefill).  Returns (out, (k, v)) so
    prefill can keep the KV cache; k is RoPE'd."""
    B, S, _ = x.shape
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _project_qkv(params, x, cfg)
    pos2 = positions[None].expand(B, S)
    q = rope(q.reshape(B, S, H, hd), pos2, cfg.rope_theta).reshape(B, S, KVH, H // KVH, hd)
    k = rope(k, pos2, cfg.rope_theta)
    out = flash_attention(q, k, v, q_positions=positions, kv_positions=positions)
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
