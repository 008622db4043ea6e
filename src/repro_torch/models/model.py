"""Model assembly for the serving slice (``repro/models/model.py``):
parameter declarations and init, prefill, the decode step and the
prefill-to-cache handoff, for stacks of ``"attn"``, ``"global"`` (full
attention), ``"local"`` (sliding-window), ``"moe"`` (full attention and the
top-k expert FFN, ``layers.moe``), ``"mamba"`` (the Mamba-2 SSD block,
``layers.mamba2_block``, no MLP) and ``"shared_attn"`` (a full-attention +
MLP block whose one parameter set every occurrence shares, zamba2's)
blocks; attention blocks carry q/k/v biases when ``cfg.qkv_bias``.  Two
more families: the VLM (internvl2: such a stack whose first
``n_patch_tokens`` positions take the patch embeddings ``prefill`` is given,
the reference's stub frontend) and the encoder-decoder (whisper:
``enc_layers`` non-causal encoder blocks over stub frame embeddings plus
fixed sinusoidal positions, then ``dec_layers`` decoder blocks of causal
self-attention, cross-attention over the encoder's output and an MLP, three
norms each; no RoPE).

Layout follows the reference so weights carry across
(``models/convert.py``): ``scan_plan`` names the repeating unit's positions
``u0``..``u{n-1}`` (one ``u0`` for a homogeneous stack, gemma3's 5 local + 1
global as ``u0``..``u5``) and the tail's ``t0``..; each unit position holds
its layers' parameters stacked on a leading ``(n_repeats,)`` axis, each
tail position one unstacked set, and ``params["shared_attn"]`` the one
unstacked set of every ``"shared_attn"`` position.  Decode caches carry the
same structure (a ``"shared_attn"`` position has a cache per occurrence).
Where the reference scans the unit with ``lax.scan``, this module runs a
Python loop over repeats and positions; the per-layer views share storage
with the stacked tensors.

The encoder-decoder's parameters are ``enc`` and ``dec`` (stacked on
``(enc_layers,)`` / ``(dec_layers,)``; a decoder block's ``self_*`` and
``cross_*`` attention sets, its MLP and ``ln1``-``ln3``) and
``enc_final_norm``; its caches are ``{"pos", "blocks": {"dec": {"k", "v",
"ck", "cv"}}}``, stacked on ``(dec_layers,)``: the self K/V of ``max_len``
rows and the cross K/V projected once from the encoder's output at
prefill, which a decode step reads and never writes.  Every ``kv_mode``
gives that tree, as in the reference.

Training (``forward``, ``loss_fn``; the reference's ``forward`` and
``loss_fn``) takes every family: the prefill's blocks without their caches
(the MoE FFN, Mamba-2 blocks, the one shared-attention set, the VLM's
patches), or for the encoder-decoder its encoder and decoder blocks; each
repeat of the unit, and each encoder and decoder layer, under
``torch.utils.checkpoint`` when ``cfg.remat == "full"`` (the reference's
``jax.checkpoint`` of its scan bodies), the stacked parameters unbound once
per call so that their gradients are stacked once (the placed train step
hands ``sharding.fsdp.StackedOnUse`` leaves instead, which gather each
repeat's slice on use; its loss keeps the logits split over the
vocabulary, ``_vocab_parallel_loss``).  Each declaration
carries the reference's logical axes (``param_logical_axes``: the placed
train step's layout, ``launch/inputs.py``); ``abstract_params`` gives the
tree on the ``meta`` device.  The embedding, the residual stream and the
logits are constrained with ``logical_shard`` where the reference
constrains them.

Decode caches are ``{"pos": pos, "blocks": {position: cache}}``, ``pos``
the next token's index as a 0-d int32 tensor on the caches' device (the
reference's traced scalar): ``decode_step`` advances it there and reads
nothing back to the host, so a CUDA graph can capture the step.  A
``"local"`` position's cache is a sliding-window ring ``{"k", "v"}`` of
``sliding_window`` rows (slot ``pos % W``); a full-attention position's
(``"attn"``, ``"global"``, ``"moe"``, ``"shared_attn"``) is a ``{"k", "v"}``
dict of ``max_len`` rows (``kv_mode="full"``), a ``paged_kv.PagedPool``
(``kv_mode="paged"``) or, when ``cfg.kv_policy`` is in
``paged_kv.TRUE_ADAPTIVE_KV``, a ``paged_kv.AdaptivePagedPool`` whose ARC/CAR
planes also carry the leading layer axis.  K/V tensors are updated in place
by ``decode_step`` (see ``cache/paged_kv.py``); callers that keep an earlier
cache clone it.  A ``"mamba"`` position's cache is a ``MambaCache``: the
SSM state (B, H, P, N) in f32 and the conv window (B, d_conv - 1,
d_inner + 2N) in the activation dtype, in every kv_mode; a step REPLACES it
(``layers.mamba2_decode_step`` returns new tensors), so the stacked cache is
rebuilt from the layers' new ones (``_restack``).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.cache import paged_kv
from repro_torch.core.policy_core import AdaptiveState
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.sharding.shards import cut, from_piece, local_box
from repro_torch.sharding.specs import logical_shard

Params = Dict[str, Any]


class MambaCache(NamedTuple):
    """A ``mamba`` position's decode cache (leading dims may add a
    ``(n_layers,)`` stack in front of ``B``).  A step replaces both."""

    state: torch.Tensor  # (B, H, P, N) float32
    conv: torch.Tensor  # (B, d_conv - 1, d_inner + 2N), the activation dtype

    def clone(self) -> "MambaCache":
        return MambaCache(*(t.clone() for t in self))

#: parameters kept in float32 whatever ``param_dtype`` is (norm scales and
#: the Mamba-2 block's A, dt bias, D skip and gated-norm scale), the
#: reference's dtype rule
F32_PARAMS = ("ln1", "ln2", "ln3", "final_norm", "enc_final_norm", "a_log", "dt_bias",
              "d_skip", "norm_scale")


def pad_vocab(cfg) -> int:
    return ((cfg.vocab + 127) // 128) * 128


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


@dataclasses.dataclass(frozen=True)
class Decl:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]  # logical axis names (sharding/specs.py)
    init: str = "normal"  # normal | zeros | ones | a_log | dt_bias
    scale: float = 0.02


def _attn_decls(cfg) -> Dict[str, Decl]:
    d, qk, kv = cfg.d_model, cfg.qk_dim, cfg.kv_dim
    out = {
        "wq": Decl((d, qk), ("p_embed", "p_feat")),
        "wk": Decl((d, kv), ("p_embed", "p_feat")),
        "wv": Decl((d, kv), ("p_embed", "p_feat")),
        "wo": Decl((qk, d), ("p_feat", "p_embed")),
        "ln1": Decl((d,), ("p_noshard",), "zeros"),
        "ln2": Decl((d,), ("p_noshard",), "zeros"),
    }
    if cfg.qkv_bias:  # in the param dtype, zeros at init, as the reference
        out["bq"] = Decl((qk,), ("p_feat",), "zeros")
        out["bk"] = Decl((kv,), ("p_feat",), "zeros")
        out["bv"] = Decl((kv,), ("p_feat",), "zeros")
    return out


def _mlp_decls(cfg) -> Dict[str, Decl]:
    d, ff = cfg.d_model, cfg.d_ff
    out = {"w_up": Decl((d, ff), ("p_embed", "p_feat")),
           "w_down": Decl((ff, d), ("p_feat", "p_embed"))}
    if cfg.act == "swiglu":
        out["w_gate"] = Decl((d, ff), ("p_embed", "p_feat"))
    return out


def _moe_decls(cfg) -> Dict[str, Decl]:
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    out = {"w_router": Decl((d, e), ("p_embed", "p_noshard")),
           "w_up": Decl((e, d, ff), ("p_experts", "p_embed", "p_expert_ff")),
           "w_down": Decl((e, ff, d), ("p_experts", "p_expert_ff", "p_embed"))}
    if cfg.act == "swiglu":
        out["w_gate"] = Decl((e, d, ff), ("p_experts", "p_embed", "p_expert_ff"))
    return out


def _mamba_decls(cfg) -> Dict[str, Decl]:
    d, din, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_ch = din + 2 * n
    return {
        "w_in": Decl((d, 2 * din + 2 * n + h), ("p_embed", "p_feat")),
        "w_conv": Decl((cfg.d_conv, conv_ch), ("p_noshard", "p_feat")),
        "b_conv": Decl((conv_ch,), ("p_feat",), "zeros"),
        "dt_bias": Decl((h,), ("p_noshard",), "dt_bias"),
        "a_log": Decl((h,), ("p_noshard",), "a_log"),
        "d_skip": Decl((h,), ("p_noshard",), "ones"),
        "norm_scale": Decl((din,), ("p_feat",), "zeros"),
        "w_out": Decl((din, d), ("p_feat", "p_embed")),
        "ln1": Decl((d,), ("p_noshard",), "zeros"),
    }


def _cross_decls(cfg) -> Dict[str, Decl]:
    """A whisper decoder block: self-attention (``self_*``), cross-attention
    (``cross_*``), the MLP and three norms."""
    out = {pre + k: v for pre in ("self_", "cross_")
           for k, v in _attn_decls(cfg).items() if not k.startswith("ln")}
    out.update(_mlp_decls(cfg))
    for name in ("ln1", "ln2", "ln3"):
        out[name] = Decl((cfg.d_model,), ("p_noshard",), "zeros")
    return out


#: block kinds the port serves: full attention, sliding-window attention,
#: full attention with the MoE FFN, the Mamba-2 block and the shared
#: attention block
KINDS = ("attn", "global", "local", "moe", "mamba", "shared_attn")


def _check_supported(cfg) -> None:
    kinds = set(cfg.layer_pattern)
    if cfg.family == "encdec":
        # the reference's encoder and decoder blocks are dense attention +
        # MLP whatever the pattern: a pattern or experts would be ignored
        ok = (cfg.enc_layers >= 1 and cfg.dec_layers >= 1 and cfg.enc_seq_divisor >= 1
              and cfg.pattern is None and not cfg.n_experts
              and cfg.act in ("swiglu", "gelu"))
    else:
        moe_ok = (("moe" in kinds) == (cfg.family == "moe")
                  and ("moe" not in kinds or 1 <= cfg.top_k <= min(2, cfg.n_experts)))
        mamba_ok = "mamba" not in kinds or (
            cfg.ssm_state >= 1 and cfg.d_conv >= 1 and cfg.ssm_chunk >= 1
            and cfg.d_inner % cfg.ssm_head_dim == 0)
        ok = (cfg.family in ("dense", "moe", "ssm", "hybrid", "vlm") and moe_ok
              and mamba_ok and cfg.act in ("swiglu", "gelu") and kinds <= set(KINDS)
              and ("local" not in kinds or cfg.sliding_window >= 1)
              and (cfg.family != "vlm" or cfg.n_patch_tokens >= 1))
    if not ok:
        raise NotImplementedError(
            f"{cfg.name}: stacks of {'/'.join(KINDS)} blocks with SwiGLU or GELU "
            "are ported to repro_torch (moe blocks in the moe family alone, top-1 "
            "or top-2; mamba blocks with ssm_state >= 1), as is the VLM family "
            "with n_patch_tokens >= 1 and the enc-dec family with enc_layers and "
            f"dec_layers >= 1, no pattern and no experts; got family={cfg.family!r} "
            f"kinds={sorted(kinds)} act={cfg.act!r} top_k={cfg.top_k} "
            f"ssm_state={cfg.ssm_state} n_patch_tokens={cfg.n_patch_tokens} "
            f"enc_layers={cfg.enc_layers} dec_layers={cfg.dec_layers}")


def scan_plan(cfg) -> Tuple[List[Tuple[str, str]], int, List[Tuple[str, str]]]:
    """(unit, n_repeats, tail) of (position_name, kind) entries; none for
    the encoder-decoder, whose stacks ``prefill`` and ``decode_step`` run
    apart."""
    _check_supported(cfg)
    if cfg.family == "encdec":
        return [], 0, []
    if cfg.pattern is None:
        return [("u0", cfg.layer_pattern[0])], cfg.n_layers, []
    unit = [(f"u{i}", k) for i, k in enumerate(cfg.pattern)]
    tail = [(f"t{i}", k) for i, k in enumerate(cfg.tail)]
    return unit, cfg.n_repeats, tail


def param_decls(cfg) -> Dict[str, Any]:
    """Declaration tree: unit positions stacked on a leading
    ``(n_repeats,)`` dim, tail positions unstacked."""
    V, d = pad_vocab(cfg), cfg.d_model
    tree: Dict[str, Any] = {
        "embed": Decl((V, d), ("p_vocab", "p_embed"), scale=1.0),
        "final_norm": Decl((d,), ("p_noshard",), "zeros"),
    }
    if not cfg.tie_embeddings:
        tree["unembed"] = Decl((V, d), ("p_vocab", "p_embed"))
    unit, n_rep, tail = scan_plan(cfg)

    def block(kind):
        if kind == "mamba":
            return _mamba_decls(cfg)
        ffn = _moe_decls(cfg) if kind == "moe" else _mlp_decls(cfg)
        return {**_attn_decls(cfg), **ffn}

    def stack(decls, n):
        return {k: Decl((n,) + v.shape, ("layers",) + v.axes, v.init, v.scale)
                for k, v in decls.items()}

    if cfg.family == "encdec":
        tree["enc"] = stack(block("attn"), cfg.enc_layers)
        tree["dec"] = stack(_cross_decls(cfg), cfg.dec_layers)
        tree["enc_final_norm"] = Decl((d,), ("p_noshard",), "zeros")
        return tree
    for pos, kind in unit:
        if kind == "shared_attn":
            # one unstacked set, shared by every occurrence in the unit
            tree["shared_attn"] = block(kind)
        else:
            tree[pos] = stack(block(kind), n_rep)
    for pos, kind in tail:
        tree[pos] = block(kind)
    return tree


def param_bytes(cfg) -> int:
    """Bytes of the parameters ``init_params`` allocates."""
    esize = torch_dtype(cfg.param_dtype).itemsize

    def walk(tree):
        return sum(walk(d) if not isinstance(d, Decl)
                   else math.prod(d.shape) * (4 if name in F32_PARAMS else esize)
                   for name, d in tree.items())

    return walk(param_decls(cfg))


def init_params(cfg, generator: torch.Generator, device="cuda", *, mesh=None,
                shardings=None) -> Params:
    """Random parameters with the reference's declarations and scales
    (normal * min(scale, 1/sqrt(fan_in)); norm scales zero, in f32; the
    Mamba-2 leaves as the reference draws them: D skip ones, A's log
    ``log(linspace(1, 16, H))``, the dt bias the inverse softplus of a dt
    log-uniform in [1e-3, 1e-1]), drawn on the generator's device.  Each
    leaf is allocated once in its dtype and drawn matrix by matrix along its
    leading (layer, expert) axes, so no f32 copy of a whole stacked leaf
    exists (phi3.5-moe's stacked expert leaves are 20 GB each in bf16).  The
    streams differ from JAX's: weights that must match the reference come
    through ``convert.params_from_jax``.

    With ``mesh`` and ``shardings`` (``launch.inputs.params_shardings``)
    every leaf is a DTensor of those placements, equal to ``place`` of the
    unplaced tree: each rank draws the same stream, matrix by matrix, and
    keeps only its piece of each matrix, so no rank holds a leaf whole."""
    if (mesh is None) != (shardings is None):
        raise ValueError("init_params: pass mesh and shardings together")
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.param_dtype)

    def full(decl, dt):
        if decl.init in ("zeros", "ones"):
            fill = torch.zeros if decl.init == "zeros" else torch.ones
            return fill(decl.shape, dtype=dt, device=dev)
        if decl.init == "a_log":
            vals = torch.log(torch.linspace(1.0, 16.0, decl.shape[-1], device=dev))
            return vals.expand(decl.shape).to(dt).contiguous()
        u = torch.rand(decl.shape, generator=generator, dtype=torch.float32,
                       device=generator.device)
        lo, hi = math.log(1e-3), math.log(0.1)
        step = torch.exp(u * (hi - lo) + lo)
        return (step + torch.log(-torch.expm1(-step))).to(dt).to(dev)

    def drawn(decl, dt, box):
        """The normal leaf's ``box`` (all of it when None)."""
        fan_in = decl.shape[-2] if len(decl.shape) >= 2 else decl.shape[-1]
        scale = min(decl.scale, 1.0 / math.sqrt(fan_in))
        box = box or [(0, n) for n in decl.shape]
        leaf = torch.empty([n for _, n in box], dtype=dt, device=dev)
        lead = decl.shape[:-2]
        tail = tuple(slice(a, a + n) for a, n in box[len(lead):])
        for idx in itertools.product(*map(range, lead)):
            w = torch.randn(decl.shape[len(lead):], generator=generator,
                            dtype=torch.float32, device=generator.device)
            if all(a <= i < a + n for i, (a, n) in zip(idx, box)):
                at = tuple(i - a for i, (a, _) in zip(idx, box))
                leaf[at].copy_((w * scale)[tail])
        return leaf

    def walk(tree, pls):
        out = {}
        for name, decl in tree.items():
            if not isinstance(decl, Decl):
                out[name] = walk(decl, None if pls is None else pls[name])
                continue
            dt = torch.float32 if name in F32_PARAMS else dtype
            box = None if pls is None else local_box(decl.shape, mesh, pls[name])
            if decl.init == "normal":
                leaf = drawn(decl, dt, box)
            else:
                leaf = full(decl, dt)
                leaf = leaf if box is None else cut(leaf, box).contiguous()
            out[name] = leaf if pls is None else from_piece(leaf, mesh, pls[name], decl.shape)
        return out

    return walk(param_decls(cfg), shardings)


def abstract_params(cfg) -> Params:
    """The parameter tree as tensors on the ``meta`` device (shapes and the
    dtypes ``init_params`` gives, no storage; the reference's
    ``ShapeDtypeStruct`` tree), so that a dry run of grok-1's 314 B
    parameters allocates nothing."""
    dtype = torch_dtype(cfg.param_dtype)

    def walk(tree):
        return {name: (walk(d) if not isinstance(d, Decl) else torch.empty(
            d.shape, dtype=torch.float32 if name in F32_PARAMS else dtype, device="meta"))
            for name, d in tree.items()}

    return walk(param_decls(cfg))


def param_logical_axes(cfg) -> Dict[str, Any]:
    """The parameter tree's logical axis names (a tuple per leaf), the
    input of ``sharding.specs.placements_for``."""
    def walk(tree):
        return {k: (v.axes if isinstance(v, Decl) else walk(v)) for k, v in tree.items()}

    return walk(param_decls(cfg))


def logits_from_hidden(params: Params, cfg, x: torch.Tensor) -> torch.Tensor:
    """Final norm and the (tied) unembedding; logits (B, S, Vpad) in f32."""
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return logical_shard((x @ table.T).to(torch.float32), "act_batch", "act_seq", "act_vocab")


def _embed(params: Params, cfg, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.long()].to(torch_dtype(cfg.dtype))


def _train_embed(params: Params, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """The training forward's embedding: ``F.embedding``, whose gradient is
    one sorted reduction (the same bits as the prefill's lookup).  On a mesh
    the table is gathered over its vocabulary shards first: DTensor's
    vocab-parallel lookup leaves a masked partial whose backward it cannot
    redistribute."""
    table = logical_shard(params["embed"], None, "act_embed")
    return F.embedding(tokens.long(), table).to(torch_dtype(cfg.dtype))


def _layer(params: Params, pos_name: str, kind: str, i: int) -> Params:
    """Layer ``i``'s parameters at a unit position: views of the stacked
    tensors, or the one shared set of a ``shared_attn`` position."""
    if kind == "shared_attn":
        return params["shared_attn"]
    return {k: v[i] for k, v in params[pos_name].items()}


# ---------------------------------------------------------------------------
# training forward and loss
# ---------------------------------------------------------------------------


def stacked_positions(cfg) -> Tuple[str, ...]:
    """The parameter tree's keys whose leaves are stacked on a leading
    repeat (layer) dim: the unit's positions but ``shared_attn``, or the
    encoder-decoder's ``enc`` and ``dec``."""
    if cfg.family == "encdec":
        return ("enc", "dec")
    unit, _, _ = scan_plan(cfg)
    return tuple(pos for pos, kind in unit if kind != "shared_attn")


def _unbind(stacked: Params) -> Dict[str, Tuple[torch.Tensor, ...]]:
    """One view per layer of each stacked tensor; their gradients are
    stacked once (unbind's backward).  A leaf that is no tensor is already
    indexed by layer: the placed train step's ``sharding.fsdp.StackedOnUse``,
    whose ``[i]`` gathers layer i's slice on use."""
    return {k: t.unbind(0) if isinstance(t, torch.Tensor) else t for k, t in stacked.items()}


def _remat(cfg, fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` when ``cfg.remat ==
    "full"`` (its interior recomputed in the backward, as the reference's
    ``jax.checkpoint``)."""
    if cfg.remat == "full":
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def forward(params: Params, cfg, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Training forward -> logits (B, S, Vpad) in f32 (the reference's
    ``forward``): the embedding (``F.embedding``, whose gradient is one
    sorted reduction; the same bits as the prefill's lookup), for the VLM
    with ``batch["patches"]`` (B, n_patch_tokens, D) in place of the first
    positions; the unit's repeats and the tail through the prefill's blocks
    (attention through kernel 6 and its backward; a ``shared_attn`` position
    runs the one shared set, whose gradient sums over its occurrences), the
    final norm and the unembedding.  The encoder-decoder takes
    ``batch["frames"]`` (B, Se, D) (``_encdec_forward``)."""
    if cfg.family == "encdec":
        x = _encdec_forward(params, cfg, batch["frames"], batch["tokens"])
        return logits_from_hidden(params, cfg, x)
    unit, n_rep, tail = scan_plan(cfg)
    x = _train_embed(params, cfg, batch["tokens"])
    if cfg.family == "vlm":
        x = torch.cat([batch["patches"].to(x.dtype), x[:, cfg.n_patch_tokens:]], dim=1)
    x = logical_shard(x, "act_batch", "act_res_seq", "act_embed")
    layers = {pos: _unbind(params[pos]) for pos, kind in unit if kind != "shared_attn"}

    def unit_body(h, i):
        for pos, kind in unit:
            p = (params["shared_attn"] if kind == "shared_attn"
                 else {k: t[i] for k, t in layers[pos].items()})
            h = _prefill_block(kind, p, h, cfg)[0]
        return h

    for i in range(n_rep):
        x = _remat(cfg, unit_body, x, i)
    for pos, kind in tail:
        x = _prefill_block(kind, params[pos], x, cfg)[0]
    return logits_from_hidden(params, cfg, x)


def loss_fn(params: Params, cfg, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Mean next-token NLL over the labels >= 0 (the reference's
    ``loss_fn``): the vocabulary's padding rows masked to -1e30 before the
    log-sum-exp, the mean over max(count, 1).  On a mesh the logits stay
    split over the vocabulary (``_vocab_parallel_loss``)."""
    logits = forward(params, cfg, batch)
    if L._is_dtensor(logits):
        return _vocab_parallel_loss(logits, batch["labels"], cfg)
    return _nll(logits, batch["labels"].long(), cfg, 0, None)


class _SumOverPieces(torch.autograd.Function):
    """The sum of a tensor over the vocabulary's pieces (a functional
    all-reduce); its gradient is the caller's, which every piece holds
    whole: the loss is the same on every piece."""

    @staticmethod
    def forward(ctx, t, group):
        import torch.distributed._functional_collectives as fc

        out = fc.all_reduce(t, "sum", group)
        return out.wait() if isinstance(out, fc.AsyncCollectiveTensor) else out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _nll(x: torch.Tensor, labels: torch.Tensor, cfg, start: int, group) -> torch.Tensor:
    """The mean NLL from logits ``x`` (B, S, n) that hold the vocabulary's
    columns ``start`` .. ``start + n`` (all of them when ``group`` is None,
    else this piece of those the pieces over ``group`` hold).  Each piece
    masks the padding columns it holds and takes its log-sum-exp lse_r; the
    pieces combine as m + log(sum_r exp(lse_r - m)), m their max (no
    gradient).  The gold logit is gathered on the piece that holds the
    label's column, 0 elsewhere, and summed over the pieces (one term is
    not 0: exact).  The gradient stays a piece: softmax minus one-hot on its
    own columns."""
    n = x.shape[-1]
    if cfg.vocab < start + n:  # this piece holds padding columns
        x = torch.where(torch.arange(start, start + n, device=x.device) < cfg.vocab, x, -1e30)
    logz = torch.logsumexp(x, dim=-1)
    if group is None:
        gold = x.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    else:
        import torch.distributed._functional_collectives as fc

        m = fc.all_reduce(logz.detach(), "max", group)
        m = m.wait() if isinstance(m, fc.AsyncCollectiveTensor) else m
        logz = m + torch.log(_SumOverPieces.apply(torch.exp(logz - m), group))
        local = labels - start
        here = (local >= 0) & (local < n)
        gold = x.gather(-1, local.clamp(0, max(n - 1, 0))[..., None])[..., 0]
        gold = _SumOverPieces.apply(torch.where(here, gold, 0.0), group)
    mask = (labels >= 0).to(torch.float32)
    return ((logz - gold) * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _vocab_parallel_loss(logits: torch.Tensor, labels: torch.Tensor, cfg) -> torch.Tensor:
    """``loss_fn``'s loss from logits (B, S, Vpad) placed on a mesh, each
    piece its own columns (``logits_from_hidden`` splits them over
    "model"; ``_nll`` on the local piece), as a replicated 0-d DTensor.
    With one piece this is the unplaced loss, op for op."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = logits.device_mesh
    last = logits.dim() - 1
    vocab_dims = [i for i, p in enumerate(logits.placements)
                  if isinstance(p, Shard) and p.dim == last and mesh.size(i) > 1]
    if len(vocab_dims) > 1:
        raise ValueError(f"logits split over the vocabulary by mesh dims {vocab_dims}")
    want = [Shard(last) if i in vocab_dims else Replicate() for i in range(mesh.ndim)]
    if list(logits.placements) != want:
        logits = logits.redistribute(mesh, want)
    start, _ = local_box(logits.shape, mesh, want)[last]
    lab = labels.to_local() if isinstance(labels, DTensor) else labels
    loss = _nll(logits.to_local(), lab.long(), cfg, start,
                (mesh, vocab_dims[0]) if vocab_dims else None)
    return DTensor.from_local(loss, mesh, [Replicate()] * mesh.ndim, run_check=False)


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------


def _prefill_block(kind: str, p: Params, x: torch.Tensor, cfg):
    """One block over the whole prompt; returns (x, k, v), k/v (B, S, kvd),
    or for a ``mamba`` block (x, state, conv): its decode cache's tensors."""
    B, S, _ = x.shape
    if kind == "mamba":
        y, state, conv = L.mamba2_block(p, L.rmsnorm(x, p["ln1"], cfg.norm_eps), cfg)
        return x + y, state, conv
    window = cfg.sliding_window if kind == "local" else 0
    h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    attn_out, (k, v) = L.attention(p, h, cfg, window=window)
    x = x + attn_out
    x = x + _ffn(kind, p, L.rmsnorm(x, p["ln2"], cfg.norm_eps), cfg)
    return x, k.reshape(B, S, -1), v.reshape(B, S, -1)


def _ffn(kind: str, p: Params, h: torch.Tensor, cfg) -> torch.Tensor:
    return L.moe(p, h, cfg) if kind == "moe" else L.mlp(p, h, cfg.act)


def _cache_from_prefill(cfg, kind: str, k: torch.Tensor, v: torch.Tensor, S: int,
                        max_len: int, kv_mode: str):
    """Decode cache of one position from its layers' prefill K/V (n, B, S,
    kvd): a ``local`` ring keeps the last W rows at ring slots
    ``arange(start, S) % W``; a full-attention position gets a pool
    (``paged``) or ``max_len`` zero-padded rows (``full``).  A ``mamba``
    position's (state, conv) are already its decode cache."""
    if kind == "mamba":
        return MambaCache(k, v)
    if kind == "local":
        # token t at ring slot t % W: the last W rows, zero-padded to W and
        # rotated by start % W
        W = cfg.sliding_window
        start = max(S - W, 0)
        cut = W - start % W

        def ring(t):
            seg = _pad_rows(t[:, :, start:S], W)
            return torch.cat([seg[:, :, cut:], seg[:, :, :cut]], dim=2)

        return {"k": ring(k), "v": ring(v)}
    if kv_mode == "paged":
        return pool_from_prefill(cfg, k, v, S)
    return {"k": _pad_rows(k, max_len), "v": _pad_rows(v, max_len)}


def _pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    """``t`` (..., n, B, S, kvd) with zero rows after its S up to ``rows``:
    built out of place from ops a DTensor takes (``cat``, ``new_zeros``),
    so a placed prefill builds its caches as the unplaced one does."""
    pad = rows - t.shape[-2]
    if pad == 0:
        return t
    return torch.cat([t, t.new_zeros(t.shape[:-2] + (pad, t.shape[-1]))], dim=-2)


def prefill(params: Params, cfg, tokens: torch.Tensor, max_len: int,
            *, kv_mode: str = "full", frames: torch.Tensor | None = None,
            patches: torch.Tensor | None = None):
    """Run the whole prompt (B, S); returns (logits (B, S, Vpad), decode
    caches positioned at S).  For ``kv_mode="paged"`` the prompt must be
    page-aligned (the engine aligns it).  The VLM family takes ``patches``
    (B, n_patch_tokens, D), which replace the first ``n_patch_tokens``
    embedded tokens; the encoder-decoder takes ``frames`` (B, Se, D), the
    encoder's input, and keeps full caches whatever ``kv_mode`` (as the
    reference)."""
    if kv_mode not in ("full", "paged"):
        raise ValueError(f"unknown kv_mode {kv_mode!r}")
    unit, n_rep, tail = scan_plan(cfg)
    if cfg.family == "encdec":
        if frames is None:
            raise ValueError(f"{cfg.name}: the enc-dec prefill needs frames")
        return _encdec_prefill(params, cfg, frames, tokens, max_len)
    B, S = tokens.shape
    x = _embed(params, cfg, tokens)
    if cfg.family == "vlm":
        if patches is None:
            raise ValueError(f"{cfg.name}: the VLM prefill needs patches")
        x = torch.cat([patches.to(x.dtype), x[:, cfg.n_patch_tokens:]], dim=1)
    x = logical_shard(x, "act_batch", "act_res_seq", "act_embed")
    kv = {pos: ([], []) for pos, _ in unit}
    for i in range(n_rep):
        for pos, kind in unit:
            x, k, v = _prefill_block(kind, _layer(params, pos, kind, i), x, cfg)
            kv[pos][0].append(k)
            kv[pos][1].append(v)
    tail_blocks = {}
    for pos, kind in tail:
        x, k, v = _prefill_block(kind, params[pos], x, cfg)
        tail_blocks[pos] = _layer_cache(
            _cache_from_prefill(cfg, kind, k[None], v[None], S, max_len, kv_mode), 0)
    logits = logits_from_hidden(params, cfg, x)
    blocks = {}
    for pos, kind in unit:
        ks, vs = kv.pop(pos)
        k, v = torch.stack(ks), torch.stack(vs)  # (n_rep, B, S, kvd)
        del ks, vs
        blocks[pos] = _cache_from_prefill(cfg, kind, k, v, S, max_len, kv_mode)
    # the unit's positions, then the tail's: the order of decode_caches and
    # decode_step
    blocks.update(tail_blocks)
    return logits, {"pos": _position(S, x.device), "blocks": blocks}


def _dec_split(p: Params) -> Tuple[Params, Params, Params]:
    """A decoder layer's parameters: the whole block, its self-attention set
    and its cross-attention set, each under the attention layer's names."""
    return (p, {k[5:]: v for k, v in p.items() if k.startswith("self_")},
            {k[6:]: v for k, v in p.items() if k.startswith("cross_")})


def _enc_block(p: Params, h: torch.Tensor, cfg) -> torch.Tensor:
    """One encoder block: non-causal self-attention (kernel 6, no RoPE) and
    the MLP, pre-norm."""
    attn_out, _ = L.attention(p, L.rmsnorm(h, p["ln1"], cfg.norm_eps), cfg, causal=False,
                              use_rope=False)
    h = h + attn_out
    return h + L.mlp(p, L.rmsnorm(h, p["ln2"], cfg.norm_eps), cfg.act)


def _dec_block(p: Params, x: torch.Tensor, enc_out: torch.Tensor, cfg):
    """One decoder block: causal self-attention (kernel 6), cross-attention
    over K/V projected from the encoder's output (kernel 6, non-causal, Sq
    != Skv) and the MLP, three norms.  Returns (x, self k, self v, cross k,
    cross v), the K/V (B, S, KVH, hd)."""
    p, sp, cp = _dec_split(p)
    B, Se, _ = enc_out.shape
    eps = cfg.norm_eps
    self_out, (sk, sv) = L.attention(sp, L.rmsnorm(x, p["ln1"], eps), cfg, causal=True,
                                     use_rope=False)
    x = x + self_out
    heads = ("act_batch", "act_seq", L._head_feat(cfg))
    ek = logical_shard(enc_out @ cp["wk"], *heads).reshape(B, Se, cfg.n_kv_heads, cfg.head_dim)
    ev = logical_shard(enc_out @ cp["wv"], *heads).reshape(B, Se, cfg.n_kv_heads, cfg.head_dim)
    cross_out, _ = L.attention(cp, L.rmsnorm(x, p["ln2"], eps), cfg, causal=False,
                               use_rope=False, kv_override=(ek, ev))
    x = x + cross_out
    x = x + L.mlp(p, L.rmsnorm(x, p["ln3"], eps), cfg.act)
    return x, sk, sv, ek, ev


def _add_sinusoid(x: torch.Tensor, cfg) -> torch.Tensor:
    """x (B, S, D) plus the sinusoid at positions ``arange(S)``, computed in
    f32 and cast to x's dtype before the add (the reference's order): the
    encoder's input from its frames, the decoder's from its embeddings."""
    pos = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)[None]
    return x + L.sinusoidal_positions(pos, cfg.d_model).to(x.dtype)


def _encdec_forward(params: Params, cfg, frames: torch.Tensor,
                    tokens: torch.Tensor) -> torch.Tensor:
    """The reference's ``_encdec_forward`` without caches, for training:
    the encoder over ``frames`` plus the sinusoid, its final norm, then the
    decoder over the embedded tokens plus the sinusoid; each encoder and
    each decoder layer under ``torch.utils.checkpoint`` when ``cfg.remat ==
    "full"`` (the reference checkpoints ``enc_body`` and ``dec_body``).
    Returns the decoder's last hidden state (B, Sd, D)."""
    enc, dec = _unbind(params["enc"]), _unbind(params["dec"])

    def enc_body(h, i):
        return _enc_block({k: t[i] for k, t in enc.items()}, h, cfg)

    def dec_body(x, enc_out, i):
        return _dec_block({k: t[i] for k, t in dec.items()}, x, enc_out, cfg)[0]

    h = _add_sinusoid(frames, cfg)
    for i in range(cfg.enc_layers):
        h = _remat(cfg, enc_body, h, i)
    enc_out = L.rmsnorm(h, params["enc_final_norm"], cfg.norm_eps)
    x = _train_embed(params, cfg, tokens)
    x = logical_shard(_add_sinusoid(x, cfg), "act_batch", "act_res_seq", "act_embed")
    for i in range(cfg.dec_layers):
        x = _remat(cfg, dec_body, x, enc_out, i)
    return x


def _encdec_prefill(params: Params, cfg, frames: torch.Tensor, tokens: torch.Tensor,
                    max_len: int):
    """The reference's ``_encdec_forward`` with its caches: the encoder
    (``_enc_block``: non-causal, no RoPE, kernel 6) over ``frames`` plus the
    sinusoid, its final norm; the decoder (``_dec_block``: causal
    self-attention, cross-attention at Sq != Skv, both kernel 6, the MLP)
    over the embedded tokens plus the sinusoid.  Returns the logits and the
    decode caches: the self K/V zero-padded to ``max_len`` rows and the
    cross K/V, stacked over the decoder layers."""
    B, Se, _ = frames.shape
    Sd = tokens.shape[1]
    dev = tokens.device
    h = _add_sinusoid(frames, cfg)
    for i in range(cfg.enc_layers):
        h = _enc_block(_layer(params, "enc", "enc", i), h, cfg)
    enc_out = L.rmsnorm(h, params["enc_final_norm"], cfg.norm_eps)
    del h

    x = _add_sinusoid(_embed(params, cfg, tokens), cfg)
    rows = {"k": [], "v": [], "ck": [], "cv": []}
    for i in range(cfg.dec_layers):
        x, sk, sv, ek, ev = _dec_block(_layer(params, "dec", "dec", i), x, enc_out, cfg)
        for name, t in zip(rows, (sk, sv, ek, ev)):
            rows[name].append(t.reshape(B, t.shape[1], -1))
    logits = logits_from_hidden(params, cfg, x)
    # stacked, the self rows zero-padded to max_len: out of place, so it runs
    # on DTensors too
    cache = {name: torch.stack(ts) for name, ts in rows.items()}
    for name in ("k", "v"):
        cache[name] = _pad_rows(cache[name], max_len)
    return logits, {"pos": _position(Sd, dev), "blocks": {"dec": cache}}


def _position(value: int, device) -> torch.Tensor:
    """A 0-d int32 position on ``device``, filled there (no host copy)."""
    return torch.full((), value, dtype=torch.int32, device=device)


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
    """Empty decode caches, positioned at 0: unit positions stacked on the
    ``(n_repeats,)`` axis, tail positions unstacked; the encoder-decoder's
    ``dec`` caches (``cross_kv_len`` cross rows) stacked on
    ``(dec_layers,)``."""
    dev = resolve_device(device)
    unit, n_rep, tail = scan_plan(cfg)
    dtype = torch_dtype(cfg.dtype)
    if cfg.family == "encdec":  # full caches in every kv_mode, as the reference
        rows = {"k": max_len, "v": max_len, "ck": cfg.cross_kv_len, "cv": cfg.cross_kv_len}
        dec = {name: torch.zeros((cfg.dec_layers, batch, n, cfg.kv_dim), dtype=dtype,
                                 device=dev) for name, n in rows.items()}
        return {"pos": _position(0, dev), "blocks": {"dec": dec}}

    def one(kind, n):
        if kind == "mamba":
            return MambaCache(
                torch.zeros((n, batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                            dtype=torch.float32, device=dev),
                torch.zeros((n, batch, cfg.d_conv - 1, cfg.d_inner + 2 * cfg.ssm_state),
                            dtype=dtype, device=dev))
        if kind == "local":
            shape = (n, batch, cfg.sliding_window, cfg.kv_dim)
            return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                    "v": torch.zeros(shape, dtype=dtype, device=dev)}
        if kv_mode == "paged" and cfg.kv_policy in paged_kv.TRUE_ADAPTIVE_KV:
            a = paged_kv.init_adaptive_pool(batch, cfg.bounded_kv_pages,
                                            cfg.page_size, cfg.kv_dim, dtype,
                                            cfg.kv_policy, device=dev)
            return paged_kv.AdaptivePagedPool(
                paged_kv.PagedPool(*(_stack_layers(t, n) for t in a.pool)),
                AdaptiveState(*(_stack_layers(t, n) for t in a.policy)))
        if kv_mode == "paged":
            a = paged_kv.init_pool(batch, cfg.bounded_kv_pages, cfg.page_size,
                                   cfg.kv_dim, dtype, device=dev)
            return paged_kv.PagedPool(*(_stack_layers(t, n) for t in a))
        if kv_mode == "full":
            shape = (n, batch, max_len, cfg.kv_dim)
            return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                    "v": torch.zeros(shape, dtype=dtype, device=dev)}
        raise ValueError(f"unknown kv_mode {kv_mode!r}")

    blocks = {pos: one(kind, n_rep) for pos, kind in unit}
    blocks.update({pos: _layer_cache(one(kind, 1), 0) for pos, kind in tail})
    return {"pos": _position(0, dev), "blocks": blocks}


def _decode_block(kind: str, p: Params, x: torch.Tensor, cfg, cache, pos,
                  win_positions, kv_mode: str, fused: bool, mesh=None):
    """One block at decode; returns (x, new cache of this layer).  A
    ``local`` block writes its ring and attends over ``win_positions``; a
    ``mamba`` block steps its recurrence and returns its new state and conv
    window."""
    B = x.shape[0]
    h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    if kind == "mamba":
        y, state, conv = L.mamba2_decode_step(p, h, cfg, state=cache.state,
                                              conv_state=cache.conv)
        return x + y, MambaCache(state, conv)
    nk, nv = L.decode_kv_row(p, h, cfg, position=pos)
    if kind == "local":
        k, v = paged_kv.ring_insert(cache["k"], cache["v"], nk, nv, pos)
        kv_pos = win_positions[None].expand(B, win_positions.shape[0])
        attn_out, _ = L.decode_attend(p, h, cfg, position=pos, k_cache=k,
                                      v_cache=v, kv_positions=kv_pos)
        new_cache = {"k": k, "v": v}
    elif kv_mode == "paged":
        adaptive = isinstance(cache, paged_kv.AdaptivePagedPool)
        if adaptive:
            core = paged_kv.adaptive_core(cfg.kv_policy, B, cfg.bounded_kv_pages,
                                          masked_renorm=True)
        if fused:
            # one CUDA launch: victim selection + attention over the pool +
            # policy-plane update (kernels/csrc/policy_attn.cu, adaptive_attn.cu)
            q = L.decode_q(p, h, cfg, position=pos)
            if adaptive:
                out, _, new_cache = paged_kv.fused_adaptive_decode_step(
                    cache, q, nk[:, 0], nv[:, 0], pos, cfg.page_size, core, mesh=mesh)
            else:
                out, _, new_cache = paged_kv.fused_decode_step(
                    cache, q, nk[:, 0], nv[:, 0], pos, cfg.page_size,
                    cfg.kv_policy, mesh=mesh)
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
    x = x + _ffn(kind, p, L.rmsnorm(x, p["ln2"], cfg.norm_eps), cfg)
    return x, new_cache


def decode_step(params: Params, cfg, token: torch.Tensor, caches,
                *, kv_mode: str = "full", fused: bool = False, mesh=None):
    """One serving step: token (B, 1) int -> (logits (B, 1, Vpad), caches),
    ``pos`` advanced on the device.  No host read and no host copy, so a
    CUDA graph captures it whole (``serve/engine.py``).  An unfused
    true-adaptive pool is the exception: its eager core copies its
    capacities to the device at every access, and CAR's clock-hand sweep
    reads the host once per trip (``policy_core._car_step``).

    ``fused=True`` routes the paged blocks through the fused CUDA policy
    kernel (one call per layer, ``ops.SPLIT_LAUNCHES`` launches); decisions
    equal the unfused path's.  ``mesh`` (a ``core.sharding`` rows mesh)
    launches each fused kernel shard-locally, each shard's sequences on its
    device and stream (``paged_kv.fused_decode_step``), with decisions
    bit-identical; it is a no-op without ``fused`` or when the batch does not
    divide the mesh.  The encoder-decoder ignores ``kv_mode``, ``fused`` and
    ``mesh``, as the reference (``_encdec_decode``)."""
    unit, n_rep, tail = scan_plan(cfg)
    if cfg.family == "encdec":
        return _encdec_decode(params, cfg, token, caches)
    pos = caches["pos"]
    x = logical_shard(_embed(params, cfg, token), "act_batch", "act_res_seq", "act_embed")
    win_positions = (paged_kv.ring_positions(pos, cfg.sliding_window)
                     if cfg.sliding_window else None)
    blocks = caches["blocks"]
    layers = {name: [] for name, _ in unit}
    for i in range(n_rep):
        for name, kind in unit:
            x, new = _decode_block(kind, _layer(params, name, kind, i), x, cfg,
                                   _layer_cache(blocks[name], i), pos,
                                   win_positions, kv_mode, fused, mesh)
            layers[name].append(new)
    new_blocks = {name: _restack(blocks[name], layers[name]) for name, _ in unit}
    for name, kind in tail:
        x, new_blocks[name] = _decode_block(kind, params[name], x, cfg, blocks[name],
                                            pos, win_positions, kv_mode, fused, mesh)
    logits = logits_from_hidden(params, cfg, x)
    return logits, {"pos": pos + 1, "blocks": new_blocks}


def _encdec_decode(params: Params, cfg, token: torch.Tensor, caches):
    """One whisper decoder step: the token's embedding plus the sinusoid at
    the device ``pos``; per layer the new K/V row written at ``pos`` of the
    self cache (in place) and attended over rows ``<= pos``, then
    cross-attention over every row of ``ck`` / ``cv`` (read only), then the
    MLP; all plain torch (``decode_attend``), as the reference's jnp."""
    pos = caches["pos"]
    B, eps = token.shape[0], cfg.norm_eps
    x = _embed(params, cfg, token)
    x = x + L.sinusoidal_positions(pos.reshape(1, 1).expand(B, 1), cfg.d_model).to(x.dtype)
    dc = caches["blocks"]["dec"]
    T, Se = dc["k"].shape[2], dc["ck"].shape[2]
    t = torch.arange(T, dtype=torch.int32, device=x.device)
    self_pos = torch.where(t <= pos, t, -1)[None].expand(B, T)
    cross_pos = torch.arange(Se, dtype=torch.int32, device=x.device)[None].expand(B, Se)
    for i in range(cfg.dec_layers):
        p, sp, cp = _dec_split(_layer(params, "dec", "dec", i))
        c = _layer_cache(dc, i)
        a = L.rmsnorm(x, p["ln1"], eps)
        nk, nv = L.decode_kv_row(sp, a, cfg, position=pos, use_rope=False)
        k, v = paged_kv.full_cache_insert(c["k"], c["v"], nk, nv, pos)
        self_out, _ = L.decode_attend(sp, a, cfg, position=pos, k_cache=k, v_cache=v,
                                      kv_positions=self_pos, use_rope=False)
        x = x + self_out
        cross_out, _ = L.decode_attend(cp, L.rmsnorm(x, p["ln2"], eps), cfg, position=pos,
                                       k_cache=c["ck"], v_cache=c["cv"],
                                       kv_positions=cross_pos, use_rope=False)
        x = x + cross_out
        x = x + L.mlp(p, L.rmsnorm(x, p["ln3"], eps), cfg.act)
    logits = logits_from_hidden(params, cfg, x)
    return logits, {"pos": pos + 1, "blocks": {"dec": dc}}


def _layer_cache(cache, i: int):
    """Layer ``i``'s view of a stacked decode cache (its tensors share
    storage)."""
    if isinstance(cache, paged_kv.AdaptivePagedPool):
        return paged_kv.AdaptivePagedPool(_layer_cache(cache.pool, i),
                                          AdaptiveState(*(t[i] for t in cache.policy)))
    if isinstance(cache, (paged_kv.PagedPool, MambaCache)):
        return type(cache)(*(t[i] for t in cache))
    return {name: t[i] for name, t in cache.items()}


def _restack(cache, layers):
    """The stacked cache after a step: K/V were written in place; the planes
    of every layer's new cache, and a ``mamba`` position's replaced state
    and conv window, are stacked again."""
    if isinstance(cache, paged_kv.AdaptivePagedPool):
        return paged_kv.AdaptivePagedPool(
            _restack(cache.pool, [c.pool for c in layers]),
            AdaptiveState(*(torch.stack(ts) for ts in zip(*(c.policy for c in layers)))))
    if isinstance(cache, paged_kv.PagedPool):
        return paged_kv.PagedPool(
            k=cache.k, v=cache.v,
            **{name: torch.stack([getattr(c, name) for c in layers])
               for name in ("f", "r", "page_start", "clock", "open_slot")})
    if isinstance(cache, MambaCache):
        return MambaCache(*(torch.stack(ts) for ts in zip(*layers)))
    return cache


def clone_caches(caches):
    """Deep copy of a decode-cache tree (for a caller that keeps it while
    decoding continues in place)."""
    def copy(cache):
        if isinstance(cache, (paged_kv.PagedPool, paged_kv.AdaptivePagedPool, MambaCache)):
            return cache.clone()
        return {k: v.clone() for k, v in cache.items()}

    return {"pos": caches["pos"].clone(),
            "blocks": {name: copy(c) for name, c in caches["blocks"].items()}}
