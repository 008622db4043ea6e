"""Input layouts for every (arch x shape) cell (``repro/launch/inputs.py``).

``batch_specs`` / ``decode_specs`` give ``Spec`` records (shape, dtype and
one DTensor placement per mesh dim) for a dry run, the counterpart of the
reference's ``ShapeDtypeStruct`` with a ``NamedSharding``; ``concrete_batch``
draws real batches of the same layout for tests and runs, and ``place``
puts a tree of full tensors on a mesh.  The same code builds both, so what
is planned is what runs.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.sharding.shards import local_part
from repro_torch.sharding.specs import AxisRules, placements_for

__all__ = ["Spec", "kv_mode_for", "params_shardings", "batch_specs",
           "decode_cache_shardings", "decode_specs", "concrete_batch", "gather_batch_axes",
           "gather_on_use", "place"]


class Spec(NamedTuple):
    """A tensor's plan: its global shape and dtype and its placements."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    placements: tuple

    def meta(self) -> torch.Tensor:
        """The tensor on the ``meta`` device (no storage)."""
        return torch.empty(self.shape, dtype=self.dtype, device="meta")


def kv_mode_for(cfg: ModelConfig, shape: ShapeSpec) -> str:
    """long_500k decodes from the paper's AWRP-bounded pool on
    full-attention blocks, and so does every decode shape under
    ``cfg.force_paged_decode``; everything else from the exact (full)
    cache."""
    has_attn = cfg.family != "ssm"
    if cfg.force_paged_decode and shape.kind == "decode" and has_attn:
        return "paged"
    return "paged" if (shape.name == "long_500k" and has_attn) else "full"


def _is_leaf(x) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields")


def params_shardings(cfg: ModelConfig, mesh, rules: AxisRules):
    """The parameter tree's placements, from ``M.param_logical_axes``."""
    def walk(tree):
        return {k: placements_for(mesh, rules, v) if _is_leaf(v) else walk(v)
                for k, v in tree.items()}

    return walk(M.param_logical_axes(cfg))


def _batch_layout(cfg: ModelConfig, B: int, S: int, labels: bool
                  ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype, tuple]]:
    """{key: (shape, dtype, logical names)} of a training / prefill batch:
    tokens (+ labels) and the family's stub frontend input."""
    dt = M.torch_dtype(cfg.dtype)
    seq = ("act_batch", "act_seq")
    out = {"tokens": ((B, S), torch.int32, seq)}
    if labels:
        out["labels"] = ((B, S), torch.int32, seq)
    if cfg.family == "encdec":
        out["frames"] = ((B, S // cfg.enc_seq_divisor, cfg.d_model), dt,
                         seq + ("act_embed",))
    if cfg.family == "vlm":
        out["patches"] = ((B, cfg.n_patch_tokens, cfg.d_model), dt, seq + ("act_embed",))
    return out


def batch_specs(cfg: ModelConfig, shape: ShapeSpec, mesh, rules: AxisRules
                ) -> Dict[str, Spec]:
    """Training / prefill batch (tokens + labels + modality stubs)."""
    layout = _batch_layout(cfg, shape.global_batch, shape.seq_len, shape.kind == "train")
    return {k: Spec(s, dt, placements_for(mesh, rules, names))
            for k, (s, dt, names) in layout.items()}


def _cache_names(name: str, nd: int, b_ax: Optional[str]) -> Tuple[Optional[str], ...]:
    """A decode-cache leaf's logical names, by its field name and rank (the
    reference's ``assign``)."""
    p_ax = "act_pages"  # the batch axes iff the rules were built with shard_pages
    if name == "pos":
        return ()
    if name in ("k", "v") and nd == 5:  # paged pool (R, B, P, page, kvd)
        return (None, b_ax, p_ax, None, "act_feat")
    if name in ("k", "v", "ck", "cv") and nd == 4:  # (R, B, T, kvd)
        return (None, b_ax, None, "act_feat")
    if name in ("k", "v") and nd == 3:  # unstacked tail (B, T, kvd)
        return (b_ax, None, "act_feat")
    if name == "state":  # (R, B, H, P, N)
        return (b_ax, "act_heads", None, None) if nd == 4 else (
            (None, b_ax, "act_heads", None, None)[:nd])
    if name == "conv":  # (R, B, dc - 1, ch)
        return (None, b_ax, None, "act_feat")[-nd:] if nd == 4 else (b_ax, None, "act_feat")
    if name in ("f", "r", "page_start"):  # (R, B, P)
        return (None, b_ax, p_ax)[-nd:]
    if name in ("clock", "open_slot"):  # (R, B)
        return (None, b_ax)[-nd:]
    return (None,) * nd


def _map_named(fn, tree, name=None):
    """``fn(field name, leaf)`` over dicts and NamedTuples, their structure
    kept."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, k) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_map_named(fn, getattr(tree, k), k) for k in tree._fields))
    return fn(name, tree)


def decode_cache_shardings(cfg: ModelConfig, shape: ShapeSpec, mesh, rules: AxisRules,
                           caches):
    """Placements matching ``caches`` (a ``M.decode_caches`` tree, on
    ``meta`` for a dry run).  Batch 1 (long_500k) cannot shard the batch
    dim; there the resident KV pages shard over the batch axes instead."""
    b_ax = None if shape.global_batch == 1 else "act_batch"
    return _map_named(lambda name, leaf: placements_for(
        mesh, rules, _cache_names(name, leaf.dim(), b_ax)), caches)


def decode_specs(cfg: ModelConfig, shape: ShapeSpec, mesh, rules: AxisRules):
    """(token, caches, kv_mode) specs for one decode step."""
    B, S = shape.global_batch, shape.seq_len
    mode = kv_mode_for(cfg, shape)
    caches = M.decode_caches(cfg, B, S, kv_mode=mode, device="meta")
    shardings = decode_cache_shardings(cfg, shape, mesh, rules, caches)
    specs = _zip_specs(caches, shardings)
    token = Spec((B, 1), torch.int32,
                 placements_for(mesh, rules, (None if B == 1 else "act_batch", None)))
    return token, specs, mode


def _zip_specs(tensors, placements):
    if isinstance(tensors, dict):
        return {k: _zip_specs(v, placements[k]) for k, v in tensors.items()}
    if hasattr(tensors, "_fields"):
        return type(tensors)(*(_zip_specs(a, b) for a, b in zip(tensors, placements)))
    return Spec(tuple(tensors.shape), tensors.dtype, placements)


def concrete_batch(cfg: ModelConfig, B: int, S: int, generator: torch.Generator, *,
                   labels: bool = True, device="cuda") -> Dict[str, torch.Tensor]:
    """A batch of ``_batch_layout``'s layout: uniform token ids (and
    labels) in the vocabulary, stub inputs N(0, 1) * 0.02 in the activation
    dtype, drawn from ``generator`` on its device and put on ``device``."""
    dev = resolve_device(device)
    out = {}
    for k, (s, dt, _) in _batch_layout(cfg, B, S, labels).items():
        if dt == torch.int32:
            t = torch.randint(0, cfg.vocab, s, generator=generator, device=generator.device)
        else:
            t = torch.randn(s, generator=generator, device=generator.device) * 0.02
        out[k] = t.to(dtype=dt, device=dev)
    return out


def gather_batch_axes(params, mesh):
    """Each placed parameter made whole over the mesh's batch axes, its
    "model" split kept: the FSDP gather, once a call, for a placed prefill
    or decode step under ``param_mode="fsdp"`` rules (``gather_on_use``
    and the train step gather each repeat's slice on use instead:
    ``sharding/fsdp.py``).  Without it DTensor may split a contraction
    over a batch axis instead (partial sums, then an all-reduce).  A leaf
    the batch axes do not split is returned as it is."""
    from torch.distributed.tensor import Replicate

    from repro_torch.launch.mesh import batch_axes

    bdims = [mesh.mesh_dim_names.index(a) for a in batch_axes(mesh)]

    def one(p):
        want = [Replicate() if i in bdims else pl for i, pl in enumerate(p.placements)]
        return p if list(p.placements) == want else p.redistribute(mesh, want)

    return {k: gather_batch_axes(v, mesh) if isinstance(v, dict) else one(v)
            for k, v in params.items()}


def gather_on_use(params, cfg: ModelConfig, mesh):
    """The parameters of a placed prefill or decode step under
    ``param_mode="fsdp"`` rules, made whole over the batch axes as the step
    uses them: each stacked leaf (``M.stacked_positions``) as a
    ``sharding.fsdp.StackedOnUse`` with no accumulator, whose ``[i]``
    gathers repeat i's slice when the model indexes it, so one repeat's
    weights are whole at a time;
    every other leaf gathered now (``gather_batch_axes``).  Call under
    ``torch.no_grad``: the slices carry no gradient back to the leaf."""
    from repro_torch.sharding import fsdp

    axes = fsdp.BatchAxes(mesh)
    stacked = set(M.stacked_positions(cfg))
    rest = gather_batch_axes({k: v for k, v in params.items() if k not in stacked}, mesh)
    def on_use(t):
        return fsdp.StackedOnUse(t, fsdp.leaf_layout(axes, t.shape, t.placements), axes,
                                 t.device_mesh, range(t.device_mesh.ndim))

    return {k: ({n: on_use(t) for n, t in v.items()} if k in stacked else rest[k])
            for k, v in params.items()}


def place(tree, mesh, shardings, *, device=None):
    """Each full tensor of ``tree`` as a DTensor on ``mesh`` with the
    placements of the matching leaf of ``shardings``.  Every rank passes the
    same full tree (the same seed, checkpoint or ``convert.params_from_jax``
    output, on any device) and keeps a copy of its own slice on ``device``
    (the mesh's device when None; ``"meta"`` for a dry run, whose tree is on
    ``meta`` too): no communication (``sharding.shards.local_part``).
    Dicts and NamedTuples (a decode cache's pools) keep their structure."""
    if isinstance(tree, dict):
        return {k: place(v, mesh, shardings[k], device=device) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(place(v, mesh, s, device=device)
                            for v, s in zip(tree, shardings)))
    return local_part(tree, mesh, shardings, device=device)
