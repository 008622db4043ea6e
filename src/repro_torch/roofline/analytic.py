"""Analytic per-cell cost model (FLOPs / HBM bytes / collective bytes)
(``repro/roofline/analytic.py``, the same arithmetic and the same keys).

Closed-form costs from the architecture and the sharding design, per (arch x
shape x mesh) cell.  The port keeps the reference's formulas exactly, so
``cell_costs`` returns the reference's dict key for key
(``tests/test_torch_roofline.py``); a difference is a fault of the port.

Two FLOP numbers per cell, under the reference's names:
  * model_flops  — useful work: 6·N_active·D (train), 2·N·D (prefill/decode)
                   plus exact causal attention;
  * hlo_flops    — what the reference's compiled schedule executes: the
                   rectangular-flash 2x waste (``schedule_factor``; 1.08 under
                   ``attention_schedule="balanced"``), remat recompute, MoE
                   capacity padding and uneven-head padding.  The port's
                   kernel 6 skips the tiles above the diagonal whatever the
                   schedule, so on the card this over-counts causal attention;
                   the roofline's compute term reads it as the reference does.

All outputs are PER DEVICE per step unless suffixed ``_global``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

from repro_torch.configs.base import ModelConfig, ShapeSpec


def _ceil_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class MeshInfo:
    batch_shards: int  # data (x pod)
    model_shards: int  # tensor axis

    @property
    def chips(self) -> int:
        return self.batch_shards * self.model_shards


def mesh_info(multi_pod: bool) -> MeshInfo:
    return MeshInfo(batch_shards=32 if multi_pod else 16, model_shards=16)


# ---------------------------------------------------------------------------
# per-layer FLOPs (per token, global)
# ---------------------------------------------------------------------------


def _attn_proj_flops(cfg) -> float:
    return 2 * cfg.d_model * (2 * cfg.qk_dim + 2 * cfg.kv_dim)


def _attn_score_flops(cfg, kv_len: float, *, padded: bool,
                      model_shards: int = 16) -> float:
    """scores + pv per query token attending to kv_len keys."""
    kvh = cfg.n_kv_heads
    if padded and model_shards > 1:
        # uneven KVH sharding pads up to the model axis width (GSPMD)
        kvh = _ceil_to(kvh, model_shards)
    heads = kvh * (cfg.n_heads // cfg.n_kv_heads)
    return 2 * 2 * heads * cfg.head_dim * kv_len


def _mlp_flops(cfg) -> float:
    m = 3 if cfg.act == "swiglu" else 2
    return 2 * m * cfg.d_model * cfg.d_ff


def _moe_flops(cfg, *, padded: bool) -> float:
    m = 3 if cfg.act == "swiglu" else 2
    router = 2 * cfg.d_model * cfg.n_experts
    factor = cfg.top_k * (cfg.capacity_factor if padded else 1.0)
    return router + factor * 2 * m * cfg.d_model * cfg.d_ff


def _mamba_flops(cfg) -> float:
    d, din, n, h, p = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                       cfg.ssm_heads, cfg.ssm_head_dim)
    q = cfg.ssm_chunk
    proj = 2 * d * (2 * din + 2 * n + h) + 2 * din * d
    conv = 2 * cfg.d_conv * (din + 2 * n)
    # SSD: intra-chunk scores (Q·N) + apply (Q·H·P per token row) + states
    ssd = 2 * q * n + 2 * q * h * p + 3 * 2 * h * p * n
    return proj + conv + ssd


def _mamba_decode_flops(cfg) -> float:
    d, din, n, h, p = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                       cfg.ssm_heads, cfg.ssm_head_dim)
    proj = 2 * d * (2 * din + 2 * n + h) + 2 * din * d
    return proj + 2 * cfg.d_conv * (din + 2 * n) + 3 * 2 * h * p * n


# ---------------------------------------------------------------------------
# cell-level costs
# ---------------------------------------------------------------------------


def _layer_flops_per_token(cfg, shape, *, padded: bool, kind_kv_len,
                           model_shards: int = 16) -> float:
    """Sum over the whole stack for one (query) token."""
    total = 0.0
    pattern = (cfg.layer_pattern if cfg.family != "encdec" else
               ("enc",) * cfg.enc_layers + ("dec",) * cfg.dec_layers)
    for blk in pattern:
        if blk == "mamba":
            total += _mamba_flops(cfg) if shape.kind != "decode" else _mamba_decode_flops(cfg)
            continue
        total += _attn_proj_flops(cfg)
        total += _attn_score_flops(cfg, kind_kv_len(blk), padded=padded,
                                   model_shards=model_shards)
        if blk == "dec":  # whisper cross-attention
            total += _attn_proj_flops(cfg)
            total += _attn_score_flops(cfg, cfg.cross_kv_len, padded=padded,
                                       model_shards=model_shards)
        total += _moe_flops(cfg, padded=padded) if blk == "moe" else _mlp_flops(cfg)
    return total


def cell_costs(cfg: ModelConfig, shape: ShapeSpec, *, multi_pod: bool = False,
               schedule_factor: float = 2.0,
               mesh: "MeshInfo | None" = None) -> Dict[str, float]:
    """The three roofline inputs + bookkeeping.  ``schedule_factor`` is the
    causal-attention waste of the rectangular flash baseline (2.0); the
    triangular §Perf variant sets it to ~1.0.  ``mesh`` overrides the
    protocol mesh (used by the cost-model cross-validation test)."""
    mi = mesh if mesh is not None else mesh_info(multi_pod)
    if getattr(cfg, "attention_schedule", "rect") == "balanced":
        schedule_factor = 1.08  # n(n+1)/2 pair steps + pad-to-2c overhead
    tp_on = getattr(cfg, "tp_feat", True)
    sp_on = getattr(cfg, "seq_parallel", False)
    B, S = shape.global_batch, shape.seq_len
    V = _ceil_to(cfg.vocab, 128)
    d = cfg.d_model
    dtype_b = 2  # bf16

    if shape.kind == "decode":
        tokens = B  # one new token per sequence
        if cfg.family != "ssm" and (
                shape.name == "long_500k" or getattr(cfg, "force_paged_decode", False)):
            full_kv = cfg.bounded_kv_pages * cfg.page_size  # AWRP pool
        else:
            full_kv = S
        kv_len_of = lambda blk: (min(cfg.sliding_window, S) if blk == "local"
                                 else full_kv)
        fwd_factor, sched = 1.0, 1.0
    elif shape.kind == "prefill":
        tokens = B * S
        kv_len_of = lambda blk: (min(cfg.sliding_window, S) if blk == "local"
                                 else S / 2)  # causal average
        fwd_factor, sched = 1.0, schedule_factor
    else:  # train
        tokens = B * S
        kv_len_of = lambda blk: (min(cfg.sliding_window, S) if blk == "local"
                                 else S / 2)
        fwd_factor = 4.0 if cfg.remat == "full" else 3.0  # fwd+bwd(2x)+remat
        sched = schedule_factor

    # ---- FLOPs -------------------------------------------------------------
    def stack_flops(padded: bool, schedule: float) -> float:
        def kv(blk):
            base = kv_len_of(blk)
            return base * (schedule if blk != "local" else 1.0)
        return _layer_flops_per_token(
            cfg, shape, padded=padded, kind_kv_len=kv,
            model_shards=mi.model_shards if tp_on else 1)

    logits_flops = 2 * d * V
    useful = tokens * (stack_flops(False, 1.0) + logits_flops)
    executed = tokens * (stack_flops(True, sched) + logits_flops)
    model_flops_global = useful * (3.0 if shape.kind == "train" else 1.0)
    hlo_flops_global = executed * fwd_factor
    hlo_flops = hlo_flops_global / mi.chips

    # ---- HBM bytes per device ----------------------------------------------
    tp_div = mi.model_shards if tp_on else 1
    p_local = cfg.n_params() * dtype_b / tp_div  # TP shard per device
    n_micro = max(1, min(cfg.microbatches, B // mi.batch_shards)) if shape.kind == "train" else 1
    act_tokens_dev = tokens / mi.chips if B >= mi.batch_shards else tokens / mi.model_shards
    act_bytes = act_tokens_dev * d * dtype_b * len(cfg.layer_pattern or [1]) * 4
    if shape.kind == "train":
        opt_bytes = cfg.n_params() / mi.chips * (
            (4 * 3 + 2 * 2) if cfg.opt_master else (2 * 2 + 2 * 2))
        hbm = 3 * n_micro * p_local + act_bytes + opt_bytes
    elif shape.kind == "prefill":
        hbm = p_local + act_bytes + tokens / mi.chips * cfg.kv_dim * 2 * dtype_b * \
            sum(1 for b in (cfg.layer_pattern or []) if b != "mamba")
    else:
        kv_rows = sum(kv_len_of(b) for b in (cfg.layer_pattern or ["attn"])
                      if b != "mamba")
        kv_bytes_dev = B * kv_rows * cfg.kv_dim * 2 * dtype_b / mi.chips * mi.batch_shards / max(B, 1)
        kv_bytes_dev = min(kv_bytes_dev, B * kv_rows * cfg.kv_dim * 2 * dtype_b / mi.model_shards)
        hbm = p_local + kv_bytes_dev

    # ---- collective bytes per device ---------------------------------------
    L = len(cfg.layer_pattern) if cfg.family != "encdec" else (
        cfg.enc_layers + cfg.dec_layers)
    act_row = d * dtype_b  # one token's residual
    if shape.kind == "train":
        # FSDP all-gather (fwd + bwd re-gather) per microbatch + grad RS
        fsdp_ag = 2 * n_micro * p_local
        grad_rs = cfg.n_params() * 4 / mi.model_shards
        # TP all-reduce: 2 ops/layer x 2 (fwd+bwd) on microbatch activations
        tp_ar = 2 * 2 * 2 * L * (tokens / max(n_micro, 1) / mi.batch_shards) * act_row
        if not tp_on:
            tp_ar = 0.0
        if sp_on:
            tp_ar *= 0.5  # AR -> RS+AG (Megatron SP)
        grad_rs = cfg.n_params() * 4 / tp_div
        coll = fsdp_ag + grad_rs + tp_ar
    elif shape.kind == "prefill":
        tp_ar = 2 * 2 * L * (tokens / mi.batch_shards) * act_row
        if not tp_on:
            tp_ar = 0.0
        if sp_on:
            tp_ar *= 0.5
        coll = p_local + tp_ar
    else:
        coll = 2 * 2 * L * (tokens / max(min(B, mi.batch_shards), 1)) * act_row
        if shape.name == "long_500k":
            # split-KV partial-attention combine across the batch axes
            coll += 2 * L * cfg.qk_dim * dtype_b * mi.batch_shards

    return {
        "model_flops_global": model_flops_global,
        "hlo_flops_global": hlo_flops_global,
        "hlo_flops": hlo_flops,
        "hbm_bytes": hbm,
        "coll_bytes": coll,
        "tokens": tokens,
        "n_micro": n_micro,
        "chips": mi.chips,
    }
