"""Dry run: every (arch × shape × mesh) cell on ``meta`` tensors over a fake
world of 256 or 512 ranks (``repro/launch/dryrun.py``).

For each cell this shows, without a card:
  * the layout is coherent: the cell's step runs on DTensors placed by the
    logical-axis rules (``sharding/specs.py``) over the production mesh,
    every op and every redistribution planned by DTensor;
  * each rank's memory: the bytes of its local pieces of the arguments and
    outputs, and the peak over the step (``MemTracker``);
  * the roofline's inputs: each rank's FLOPs and the collectives it issues
    with their bytes (``roofline.analysis.CellTrace``), beside the analytic
    model (``roofline.analytic.cell_costs``).

Where it runs: one process joins a fake process group
(``torch.testing._internal.distributed.fake_pg``) of 256 ranks (``single``)
or 512 (``multi``) as rank 0, and builds ``make_production_mesh`` typed
"cuda", so DTensor picks NCCL's collectives (an all-to-all stays one; a
"cpu" mesh would lower it to an all-gather).  Every leaf is a ``meta``
piece: nothing is allocated, nothing launched, no card touched.  It is no
CPU fallback either: ``meta`` carries no numbers.  Kernel 6 and its
backward take a shape-only route on ``meta`` (``kernels/ops.py``): no
launch is counted, their FLOPs are the pairs their masks leave
(``ops.META_FLOPS``: 4·hd a pair forward, 10·hd backward), and their
memory is their outputs', as on the card (the plain versions' (Sq, Skv)
scores would be the larger part of a cell's peak).  The decode step is the
unfused one (the reference's default), which reaches no kernel.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen25_14b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh both] [--out artifacts/dryrun]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
import warnings
from typing import Optional, Sequence

import torch

from repro_torch.configs.base import ARCH_IDS, SHAPES, ModelConfig, ShapeSpec, load_config
from repro_torch.kernels import ops
from repro_torch.launch import inputs as I
from repro_torch.launch.mesh import PRODUCTION_SHAPES, batch_shards, make_mesh
from repro_torch.models import model as M
from repro_torch.optim import optimizer as O
from repro_torch.roofline import analysis as R
from repro_torch.roofline.analytic import MeshInfo, cell_costs
from repro_torch.sharding import fsdp
from repro_torch.sharding.shards import local_part
from repro_torch.sharding.specs import activate, make_rules
from repro_torch.train.train_step import effective_microbatches, make_train_step

#: the reference's config fields the port does not carry, and why
REFUSED_FIELDS = {
    "attention_impl": "the port always runs kernel 6 (no XLA / Pallas choice)",
}

#: record fields with no honest counterpart on ``meta``, and why
NULL_FIELDS = {
    "bytes_accessed": "only XLA's cost analysis gives it; the analytic model's "
                      "is analytic.hbm_bytes",
    "transcendentals": "only XLA's cost analysis gives it",
    "generated_code_size_in_bytes": "no compiled program",
}


def start_fake_world(world_size: int) -> None:
    """Join a fake process group of ``world_size`` ranks as rank 0 (once a
    process; a started world of another size raises)."""
    import torch.distributed as dist

    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(f"a world of {dist.get_world_size()} ranks is started; "
                               f"the cell needs {world_size}")
        return
    # private to torch's tests: imported here, never at the package's import
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", rank=0, world_size=world_size, store=FakeStore())


def fake_mesh(shape: Sequence[int]):
    """A "cuda"-typed ``DeviceMesh`` of ``shape`` over a fake world of
    exactly its size."""
    start_fake_world(math.prod(shape))
    return make_mesh(shape, device_type="cuda")


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return []


def local_bytes(tree) -> int:
    """Bytes of this rank's pieces of every tensor of ``tree``."""
    from torch.distributed.tensor import DTensor

    total = 0
    for t in _leaves(tree):
        t = t.to_local() if isinstance(t, DTensor) else t
        total += t.numel() * t.element_size()
    return total


def cell_rules(cfg: ModelConfig, shape: ShapeSpec, multi: bool):
    """The rules of a cell, as the reference's dry run builds them."""
    return make_rules(
        multi_pod=multi, moe_sharding=cfg.moe_sharding,
        shard_pages=shape.global_batch == 1,
        param_mode=cfg.decode_param_mode if shape.kind == "decode" else "fsdp",
        tp_feat=cfg.tp_feat, seq_parallel=cfg.seq_parallel)


def build_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, rules):
    """Returns ``(fn, args, extra)`` for one cell: ``fn(*args)`` runs its step
    on placed ``meta`` tensors; ``extra`` holds what the record reports of
    the build (``n_micro`` for a train cell, ``kv_mode`` for a decode)."""
    params = I.place(M.abstract_params(cfg), mesh, I.params_shardings(cfg, mesh, rules),
                     device="meta")

    def batch():
        return {k: local_part(s.meta(), mesh, s.placements, device="meta")
                for k, s in I.batch_specs(cfg, shape, mesh, rules).items()}

    if shape.kind == "train":
        oc = O.OptConfig(adam_dtype=cfg.adam_dtype, master_weights=cfg.opt_master)
        n_micro = effective_microbatches(cfg, shape.global_batch, batch_shards(mesh))
        step = make_train_step(cfg, oc, n_micro, mesh=mesh, rules=rules)
        return step, (params, O.init_opt_state(params, oc), batch()), {"n_micro": n_micro}

    from torch.distributed.tensor.experimental import implicit_replication

    # FSDP weights are gathered over the batch axes as they are used, each
    # repeat's slice when its layer runs (the train step likewise); "tp2d"
    # weights stay split
    gather = shape.kind != "decode" or cfg.decode_param_mode == "fsdp"

    def use(p):
        return I.gather_on_use(p, cfg, mesh) if gather else p

    if shape.kind == "prefill":
        def prefill_fn(p, b):
            with activate(mesh, rules), implicit_replication(), torch.no_grad():
                return M.prefill(use(p), cfg, b["tokens"], shape.seq_len,
                                 frames=b.get("frames"), patches=b.get("patches"))

        return prefill_fn, (params, batch()), {}

    token, caches, mode = I.decode_specs(cfg, shape, mesh, rules)
    token = local_part(token.meta(), mesh, token.placements, device="meta")
    caches = _place_specs(caches, mesh)

    def serve_step(p, t, c):
        with activate(mesh, rules), implicit_replication(), torch.no_grad():
            return M.decode_step(use(p), cfg, t, c, kv_mode=mode)

    return serve_step, (params, token, caches), {"kv_mode": mode}


def _whole_over_batch(axes, p) -> int:
    """Elements of this rank's piece of the placed ``p`` made whole over the
    batch axes (``axes``: a ``sharding.fsdp.BatchAxes``)."""
    from repro_torch.sharding import fsdp

    local = p.to_local()
    lay = fsdp.leaf_layout(axes, p.shape, p.placements)
    if lay.dim is None or local.shape[lay.dim] == 0:
        return local.numel() if lay.dim is None else 0
    return local.numel() // local.shape[lay.dim] * p.shape[lay.dim]


def peak_terms(cfg: ModelConfig, shape: ShapeSpec, mesh, params) -> dict:
    """The placed train step's predicted peak bytes a rank, term by term,
    from the config, the shape and the placed ``params`` (their local
    pieces' shapes):

    * ``accumulator``: the gradient accumulator's pieces in
      ``grad_accum_dtype``;
    * ``repeat_slices``: one repeat's slices of the stacked leaves, whole
      over the batch axes, four times (the slice, its gradient, the
      all-to-all's send copy and its receive buffer);
    * ``boundaries``: the unit's saved inputs, one (rows, S, D) a repeat
      (whisper: one a layer, the encoder's at its frame length);
    * ``unit_recompute``: one unit's activations, forward and backward,
      at a chunk's tokens: 8·D + 4·(q, k, v widths) + 4·ff a token for an
      attention + MLP position (widths a rank: split over "model" where
      the heads divide), top_k · capacity_factor · (2·D + 4·ff) and the
      router's f32 logits for an MoE FFN, 8·D + 6·(Mamba-2 in-projection
      width) for a Mamba-2 block;
    * ``logits``: the chunk's f32 logits piece over "model" and its
      gradient;
    * ``embedding``: the table gathered whole (``_train_embed``) and its
      gradient, and every other leaf that is not stacked, gathered over the
      batch axes, with its gradient;
    * ``update_f32_grads``: ``_finish``'s f32 copy of the accumulator
      where it is not f32;
    * ``norm_slice``: ``optim.global_norm``'s largest whole piece (a
      stacked leaf's slice, else a whole leaf) in f32, four times (the
      gather's buffer, the joined piece, its square, a spare).

    ``predicted`` = the arguments (``arguments``, set by the caller) + the
    accumulator + the larger of the step's terms (``repeat_slices`` to
    ``embedding``) and the update's (the last two): they do not live at
    once."""
    from repro_torch.sharding import fsdp

    axes = fsdp.BatchAxes(mesh)
    names = mesh.mesh_dim_names
    ms = mesh.size(names.index("model"))
    n_micro = effective_microbatches(cfg, shape.global_batch, axes.n)
    rows = max(shape.global_batch // (axes.n * n_micro), 1)
    act_b = M.torch_dtype(cfg.dtype).itemsize
    acc_b = M.torch_dtype(cfg.grad_accum_dtype).itemsize
    stacked = set(M.stacked_positions(cfg))

    def split(width: int, heads: int) -> float:
        return width / ms if heads and heads % ms == 0 else width

    def whole_piece(p) -> int:
        """Elements of ``global_norm``'s piece: a slice of a leaf of 3 or
        more dims, else the leaf."""
        return math.prod(p.shape[1:]) if p.dim() >= 3 else math.prod(p.shape)

    acc = slices = others = 0
    norm = 0
    for key, sub in params.items():
        for p in _leaves(sub):
            b = p.element_size()
            acc += p.to_local().numel() * acc_b
            norm = max(norm, whole_piece(p) * 4)
            if key in stacked:
                slices += _whole_over_batch(axes, p) // p.shape[0] * b
            else:
                others += _whole_over_batch(axes, p) * b
    D, S = cfg.d_model, shape.seq_len
    tokens = rows * S
    qkv = split(cfg.qk_dim, cfg.n_heads) + 2 * split(cfg.kv_dim, cfg.n_kv_heads) \
        if cfg.n_heads else 0
    ff = cfg.d_ff / ms if cfg.d_ff else 0

    def width(kind: str) -> float:
        if kind == "mamba":
            proj = 2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_heads
            return 8 * D + 6 * proj / ms
        attn = 8 * D + 4 * qkv
        if kind == "moe":
            return attn + cfg.top_k * cfg.capacity_factor * (2 * D + 4 * ff) \
                + 2 * cfg.n_experts * 4 / act_b
        return attn + 4 * ff

    if cfg.family == "encdec":
        enc_tokens = rows * (S // cfg.enc_seq_divisor)
        boundaries = (cfg.enc_layers * enc_tokens + cfg.dec_layers * tokens) * D * act_b
        unit = max(enc_tokens, tokens) * (width("attn") + 4 * qkv) * act_b
    else:
        unit_plan, n_rep, tail = M.scan_plan(cfg)
        boundaries = n_rep * tokens * D * act_b
        unit = tokens * sum(width(kind) for _, kind in unit_plan) * act_b
    vpad = M.pad_vocab(cfg)
    emb_b = M.torch_dtype(cfg.param_dtype).itemsize
    terms = {
        "accumulator": acc,
        "repeat_slices": 4 * slices,
        "boundaries": boundaries,
        "unit_recompute": int(unit),
        "logits": 2 * tokens * -(-vpad // ms) * 4,
        "embedding": 2 * vpad * D * emb_b + 2 * others,
        "update_f32_grads": 0 if acc_b == 4 else acc // acc_b * 4,
        "norm_slice": 4 * norm,
    }
    step = sum(terms[k] for k in ("repeat_slices", "boundaries", "unit_recompute", "logits",
                                  "embedding"))
    update = terms["update_f32_grads"] + terms["norm_slice"]
    terms["predicted_over_arguments"] = terms["accumulator"] + max(step, update)
    return terms


def prefill_peak_terms(cfg: ModelConfig, shape: ShapeSpec, mesh, params) -> dict:
    """The placed prefill's predicted peak bytes a rank over its arguments,
    term by term (a decoder-only family; the weights gathered on use,
    ``inputs.gather_on_use``, the MoE's routing per batch shard), at a
    batch shard's ``tokens`` = (global batch / batch shards) x S:

    * ``unstacked``: every leaf that is not stacked, gathered whole over
      the batch axes (the embedding and unembedding, norms);
    * ``repeat_slices``: the largest unit position's slices of one repeat,
      whole over the batch axes, twice (the all-gather's buffer and the
      joined slice);
    * ``kv``: each attention layer's K and V, a rank's kv heads (all of
      them where they do not divide "model"), kept for the caches, twice
      (the per-layer list and the stacked cache);
    * ``residual``: the stream and a block's output, (tokens, D) each;
    * ``block``: the largest block's activations: q, k, v and the
      attention output, then the MLP's three (tokens, d_ff / "model")
      tensors, or the MoE's router logits and their softmax in f32 (three
      (tokens, E)) and its dispatch, expert and combine tensors, top_k x
      capacity_factor rows a token: the buffer and the experts' output
      whole over "model" (2 D) and three d_ff / "model" wide;
    * ``logits``: the (tokens, Vpad / "model") logits in f32 and the final
      hidden state.

    ``predicted_over_arguments`` is their sum (``block`` and ``logits`` do
    not live at once: the larger of the two)."""
    from repro_torch.sharding import fsdp

    axes = fsdp.BatchAxes(mesh)
    ms = mesh.size(mesh.mesh_dim_names.index("model"))
    act_b = M.torch_dtype(cfg.dtype).itemsize
    tokens = max(shape.global_batch // axes.n, 1) * shape.seq_len
    stacked = set(M.stacked_positions(cfg))

    def whole_bytes(p) -> int:
        return _whole_over_batch(axes, p) * p.element_size()

    unstacked, slices = 0, 0
    for key, sub in params.items():
        if key in stacked:
            slices = max(slices, sum(whole_bytes(p) // p.shape[0] for p in _leaves(sub)))
        else:
            unstacked += sum(whole_bytes(p) for p in _leaves(sub))

    def split(width: int, heads: int) -> float:
        return width / ms if heads and heads % ms == 0 else width

    D = cfg.d_model
    q, kv = split(cfg.qk_dim, cfg.n_heads), split(cfg.kv_dim, cfg.n_kv_heads)
    ff = cfg.d_ff / ms if cfg.d_ff else 0
    unit, n_rep, tail = M.scan_plan(cfg)
    attn_layers = n_rep * sum(k != "mamba" for _, k in unit) + sum(k != "mamba" for _, k in tail)

    def width(kind: str) -> float:
        if kind == "mamba":
            return 6 * (2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_heads) / ms
        attn = 2 * q + 2 * kv
        if kind == "moe":
            routed = cfg.top_k * cfg.capacity_factor
            return attn + max(3 * cfg.n_experts * 4 / act_b, routed * (2 * D + 3 * ff))
        return attn + 3 * ff

    vpad = M.pad_vocab(cfg)
    terms = {
        "unstacked": unstacked,
        "repeat_slices": 2 * slices,
        "kv": int(2 * attn_layers * 2 * tokens * kv * act_b),
        "residual": 2 * tokens * D * act_b,
        "block": int(tokens * max(width(k) for _, k in (*unit, *tail)) * act_b),
        "logits": tokens * (-(-vpad // ms) * 4 + D * act_b),
    }
    terms["predicted_over_arguments"] = (sum(terms[k] for k in ("unstacked", "repeat_slices",
                                                                "kv", "residual"))
                                         + max(terms["block"], terms["logits"]))
    return terms


def _place_specs(tree, mesh):
    """A tree of ``inputs.Spec`` as placed ``meta`` DTensors (a 0-d leaf,
    the decode position, stays a plain ``meta`` tensor, as the unplaced
    caches keep it)."""
    if isinstance(tree, dict):
        return {k: _place_specs(v, mesh) for k, v in tree.items()}
    if isinstance(tree, I.Spec):
        if not tree.shape:
            return tree.meta()
        return local_part(tree.meta(), mesh, tree.placements, device="meta")
    return type(tree)(*(_place_specs(v, mesh) for v in tree))


def _peak_tracker():
    """``MemTracker`` (private to torch) if this torch has it, else None."""
    try:
        from torch.distributed._tools.mem_tracker import MemTracker
    except ImportError:  # its absence is recorded
        return None
    return MemTracker()


def run_cell(arch: str, shape_name: str, mesh_name: str, out_dir: Optional[str],
             overrides: dict | None = None, tag: str = "", *,
             cfg: Optional[ModelConfig] = None, shape: Optional[ShapeSpec] = None,
             mesh_shape: Optional[Sequence[int]] = None) -> dict:
    """Run one cell and write its record to ``out_dir`` (None: no file).
    ``cfg`` / ``shape`` / ``mesh_shape`` replace the arch's config, the
    named shape and the production mesh (smaller cells for tests)."""
    cfg = cfg if cfg is not None else load_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = shape if shape is not None else SHAPES[shape_name]
    mesh_shape = tuple(mesh_shape or PRODUCTION_SHAPES[mesh_name == "multi"])
    multi = len(mesh_shape) == 3
    t0 = time.time()
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "mesh_shape": list(mesh_shape), "chips": math.prod(mesh_shape),
        "status": "ok", "overrides": overrides or {},
    }
    try:
        mesh = fake_mesh(mesh_shape)
        rec["mesh_device_type"] = mesh.device_type
        mi = MeshInfo(batch_shards=batch_shards(mesh), model_shards=mesh_shape[-1])
        rules = cell_rules(cfg, shape, multi)
        fn, args, extra = build_cell(cfg, shape, mesh, rules)
        t_lower = time.time() - t0
        arg_bytes = local_bytes(args)  # before the step: the train step updates in place
        if shape.kind == "train":
            terms = {"arguments": arg_bytes, **peak_terms(cfg, shape, mesh, args[0])}
            extra["peak_terms"] = terms
        elif shape.kind == "prefill" and cfg.family != "encdec":
            terms = {"arguments": arg_bytes, **prefill_peak_terms(cfg, shape, mesh, args[0])}
            extra["peak_terms"] = terms
        launches, kflops = dict(ops.LAUNCHES), dict(ops.META_FLOPS)
        fsdp_bytes = dict(fsdp.BYTES)
        trace, peak = R.CellTrace(), _peak_tracker()
        with contextlib.ExitStack() as stack:
            # DTensor warns of the 0-d decode position it replicates, once a layer
            stack.enter_context(warnings.catch_warnings())
            warnings.filterwarnings("ignore", message="Found a non-scalar tensor")
            if peak is not None:
                stack.enter_context(peak)
                peak.track_external(*_leaves(args))
            stack.enter_context(trace)
            out = fn(*args)
        peak_bytes = None if peak is None else _peak_on(peak, "meta")
        t_run = time.time() - t0 - t_lower
        kernel_flops = sum(ops.META_FLOPS[k] - kflops[k] for k in kflops)
        launched = sum(ops.LAUNCHES[k] - launches[k] for k in launches)
        if shape.kind == "train":
            extra["fsdp_bytes"] = {k: fsdp.BYTES[k] - fsdp_bytes[k] for k in fsdp_bytes}
        memory = {"argument_size_in_bytes": arg_bytes,
                  "output_size_in_bytes": local_bytes(out),
                  "peak_bytes": peak_bytes,
                  "predicted_peak_bytes": extra["peak_terms"]["arguments"]
                  + extra["peak_terms"]["predicted_over_arguments"]
                  if "peak_terms" in extra else None,
                  "temp_size_in_bytes": None if peak_bytes is None else
                  max(peak_bytes - arg_bytes, 0),
                  "generated_code_size_in_bytes": None}
        rec.update(
            flops=float(trace.flops + kernel_flops),
            flops_parts={"torch_ops": float(trace.flops), "kernels": float(kernel_flops)},
            launches=launched,
            bytes_accessed=None,
            transcendentals=None,
            collectives=R.collective_bytes(trace.collectives),
            collective_ops=trace.counts(),
            analytic=cell_costs(cfg, shape, multi_pod=multi, mesh=mi),
            model_flops=R.model_flops_for(cfg, shape),
            memory=memory,
            n_params=cfg.n_params(),
            n_active_params=cfg.n_active_params(),
            lower_s=round(t_lower, 1),
            compile_s=round(t_run, 1),
            **extra,
        )
        rec["null_fields"] = dict(NULL_FIELDS)
        if peak is None:
            rec["null_fields"]["peak_bytes"] = "torch.distributed._tools.mem_tracker is missing"
        rec["notes"] = {
            "peak_terms": "a train cell's predicted peak, term by term (peak_terms): "
                          "predicted_peak_bytes = arguments + accumulator + the larger of "
                          "the step's terms and the update's",
            "fsdp_bytes": "bytes this rank receives from the train step's FSDP collectives "
                          "(sharding.fsdp): the weights' gathers on use and the gradients' "
                          "reductions",
            "flops": "per rank: torch.utils.flop_counter's formulas over the local "
                     "ops on meta, plus kernel 6 and its backward from their meta "
                     "route (4·hd / 10·hd a (query head, key) pair the masks leave; "
                     "the masked half of a causal product not counted)",
            "memory": "per rank, from the local pieces' shapes; peak_bytes and "
                      "temp_size_in_bytes from MemTracker over the step (meta): every "
                      "local tensor alive at once, collectives' outputs included",
            "lower_s": "placing the arguments and building the step",
            "compile_s": "running the step once on meta (nothing is compiled)",
        }
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec["status"] = "FAIL"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        suffix = f"__{tag}" if tag else ""
        path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_name}{suffix}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def _peak_on(tracker, device: str) -> Optional[int]:
    """The tracker's peak bytes on ``device`` (every category), or None."""
    snap = tracker.get_tracker_snapshot("peak")
    for dev, stats in snap.items():
        if torch.device(dev).type == device:
            return int(stats.get("Total", sum(stats.values())))
    return None


def parse_overrides(pairs: Sequence[str]) -> dict:
    """``key=value`` pairs as config overrides (bools, ints, floats, else
    strings, as the reference parses them).  A field the port does not
    carry, or one no config has, raises a ``ValueError`` naming it."""
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    out = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        if k in REFUSED_FIELDS:
            raise ValueError(f"--set {k}: not a field of the port ({REFUSED_FIELDS[k]})")
        if k not in fields:
            raise ValueError(f"--set {k}: no such config field")
        if v in ("true", "True", "false", "False"):
            v = v in ("true", "True")
        else:
            try:
                v = int(v)
            except ValueError:
                try:
                    v = float(v)
                except ValueError:
                    pass
        out[k] = v
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=sorted(SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi", "both"), default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--set", action="append", default=[],
                    help="cfg override key=value (repeatable), e.g. "
                         "--set attention_schedule=balanced")
    ap.add_argument("--tag", default="", help="artifact filename suffix")
    args = ap.parse_args(argv)
    try:
        overrides = parse_overrides(args.set)
    except ValueError as e:
        ap.error(str(e))

    archs = ARCH_IDS if args.all or not args.arch else (args.arch,)
    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)
    if len(meshes) > 1:
        # one fake world a process: each mesh in a process of its own
        import subprocess
        import sys

        rcs = []
        for mesh_name in meshes:
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh", mesh_name,
                   "--out", args.out] + [f"--set={kv}" for kv in args.set]
            cmd += ["--all"] if args.all else []
            cmd += ["--arch", args.arch] if args.arch else []
            cmd += ["--shape", args.shape] if args.shape else []
            cmd += ["--skip-existing"] if args.skip_existing else []
            cmd += ["--tag", args.tag] if args.tag else []
            rcs.append(subprocess.run(cmd).returncode)
        raise SystemExit(max(rcs))
    n_ok = n_fail = n_skip = 0
    for arch in archs:
        cfg = load_config(arch)
        shapes = cfg.run_shapes if args.all or not args.shape else (args.shape,)
        for shape_name in shapes:
            if shape_name not in cfg.run_shapes:
                print(f"SKIP {arch} {shape_name}: {cfg.skip_reasons.get(shape_name)}")
                n_skip += 1
                continue
            for mesh_name in meshes:
                path = os.path.join(args.out, f"{arch}__{shape_name}__{mesh_name}.json")
                if args.skip_existing and os.path.exists(path):
                    with open(path) as f:
                        if json.load(f).get("status") == "ok":
                            n_ok += 1
                            continue
                rec = run_cell(arch, shape_name, mesh_name, args.out,
                               overrides=overrides, tag=args.tag)
                ok = rec["status"] == "ok"
                n_ok += ok
                n_fail += not ok
                if ok:
                    peak = rec["memory"]["peak_bytes"]
                    print(
                        f"OK   {arch:18s} {shape_name:12s} {mesh_name:6s} "
                        f"flops/dev={rec['flops']:.3e} "
                        f"coll={rec['collectives']['total']:.3e}B "
                        f"args={rec['memory']['argument_size_in_bytes'] / 2**30:.2f}GiB "
                        f"peak={'n/a' if peak is None else f'{peak / 2**30:.2f}GiB'} "
                        f"run={rec['compile_s']}s",
                        flush=True,
                    )
                else:
                    print(f"FAIL {arch} {shape_name} {mesh_name}: {rec['error']}",
                          flush=True)
    print(f"\ndry-run: {n_ok} ok, {n_fail} failed, {n_skip} skipped")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
