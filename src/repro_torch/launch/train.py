"""Training launcher (``repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --preset tiny \
      --steps 20

Presets: ``tiny`` (a CPU-runnable few-M-parameter config), ``smoke`` (the
arch's reduced config), ``full`` (the published config).  The loop is the
fault-tolerant harness: checkpoint/restart, straggler logging, preemption
checkpointing (SIGTERM).  Parameters are random, from seed 0; data is
``SyntheticLM``.  Runs on the CUDA card by default (``--device cuda``; it
raises when CUDA is not available); ``--device cpu`` runs the kernels'
plain versions on the CPU.

One deviation from the reference: under ``--preset full``, ``--batch`` and
``--seq`` override ``train_4k``'s shape when they are given.  ``train_4k``'s
global batch of 256 x 4096 does not fit one card (smollm's f32 logits alone
would be ~100 GB a microbatch).  The dense, moe, ssm and
hybrid families train on ``SyntheticLM``, as in the reference.  The
enc-dec and VLM families need ``frames`` / ``patches``, which
``SyntheticLM`` does not yield (the reference's launcher fails on them for
want of those keys): the launcher raises a ``ValueError`` for them, and
``models.model.loss_fn`` trains them on batches that carry the key.

``--mesh single`` / ``--mesh multi`` train on the reference's production
mesh, (16, 16) over ("data", "model") or (2, 16, 16) with "pod"
(``launch/mesh.py``), one rank per device: start one process per rank with
``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` set (and
``LOCAL_RANK`` for the card), e.g. under ``torchrun``.  Each rank draws
the same parameters from seed 0 and keeps only its slice of each matrix
(``models.model.init_params`` with ``params_shardings``), and the train
step runs placed (``train_step.make_train_step(mesh=...)``) under
``activate``.  With fewer
ranks than the mesh needs it raises the mesh's ``RuntimeError``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch.configs.base import ARCH_IDS, SHAPES, load_config, load_smoke_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch.inputs import params_shardings
from repro_torch.launch.mesh import batch_shards, make_production_mesh
from repro_torch.models import model as M
from repro_torch.optim import optimizer as O
from repro_torch.sharding.specs import activate, make_rules
from repro_torch.train import fault_tolerance as FT
from repro_torch.train.train_step import effective_microbatches, make_train_step


#: the families whose batches carry a stub frontend's input besides the tokens
STUB_INPUTS = {"encdec": "frames", "vlm": "patches"}


def tiny_config(cfg):
    return dataclasses.replace(
        cfg, n_layers=4, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
        d_ff=1024, vocab=2048, pattern=None, n_repeats=0, tail=(),
        n_experts=min(cfg.n_experts, 4), microbatches=1,
        dtype="float32", param_dtype="float32",
    )


def default_opt_config(cfg, steps: int, lr: float = 3e-4) -> O.OptConfig:
    """The launcher's ``OptConfig`` for a run of ``steps``: warmup over a
    quarter of them (at most 50), the config's Adam dtype and master rule."""
    return O.OptConfig(lr=lr, warmup_steps=min(50, steps // 4), total_steps=steps,
                       adam_dtype=cfg.adam_dtype, master_weights=cfg.opt_master)


def batch_to(batch, device):
    """A pipeline batch (numpy int32) as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_360m", choices=ARCH_IDS)
    ap.add_argument("--preset", default="tiny", choices=("tiny", "smoke", "full"))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=None,
                    help="global batch (default 8; under --preset full, train_4k's)")
    ap.add_argument("--seq", type=int, default=None,
                    help="sequence length (default 256; under --preset full, train_4k's)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default="none", choices=("none", "single", "multi"))
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    key = STUB_INPUTS.get(load_config(args.arch).family)
    if key is not None:
        raise ValueError(f"--arch {args.arch}: its batches need {key!r}, and SyntheticLM "
                         "yields tokens and labels only; call models.model.loss_fn with "
                         f"a batch that carries {key!r}")
    device = resolve_device(args.device)
    if args.preset == "full":
        cfg = load_config(args.arch)
        shape = SHAPES["train_4k"]
        batch = shape.global_batch if args.batch is None else args.batch
        seq = shape.seq_len if args.seq is None else args.seq
    else:
        cfg = (load_smoke_config(args.arch) if args.preset == "smoke"
               else tiny_config(load_config(args.arch)))
        batch = 8 if args.batch is None else args.batch
        seq = 256 if args.seq is None else args.seq

    oc = default_opt_config(cfg, args.steps, args.lr)
    mesh = rules = None
    shards = 1
    if args.mesh != "none":
        device = _start_world(device)
        mesh = make_production_mesh(multi_pod=args.mesh == "multi",
                                    device_type=device.type)
        rules = make_rules(multi_pod=args.mesh == "multi", moe_sharding=cfg.moe_sharding)
        shards = batch_shards(mesh)
    n_micro = effective_microbatches(cfg, batch, shards)
    train_step = make_train_step(cfg, oc, n_micro, mesh=mesh, rules=rules)
    data = SyntheticLM(cfg.vocab, batch, seq)

    def init_fn():
        placed = {} if mesh is None else {
            "mesh": mesh, "shardings": params_shardings(cfg, mesh, rules)}
        params = M.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                               device=device, **placed)
        return params, O.init_opt_state(params, oc)

    def step_fn(params, opt_state, np_batch):
        return train_step(params, opt_state, batch_to(np_batch, device))

    def log(step, metrics):
        if step % args.log_every == 0:
            print(f"step {step:5d} loss {metrics['loss']:.4f} "
                  f"gnorm {metrics['grad_norm']:.3f} lr {metrics['lr']:.2e}",
                  flush=True)

    with activate(mesh, rules) if mesh is not None else contextlib.nullcontext():
        report = FT.run_resilient(
            ckpt_dir=args.ckpt_dir, total_steps=args.steps, init_fn=init_fn,
            step_fn=step_fn, data_iter=data, ckpt_every=args.ckpt_every,
            on_metrics=log,
        )
    print(f"done: {report.steps_done} steps, {report.restarts} restarts, "
          f"{len(report.stragglers)} straggler steps, "
          f"final loss {report.final_metrics.get('loss'):.4f}")
    return report


def _start_world(device: torch.device) -> torch.device:
    """Start the process group from the environment (``WORLD_SIZE`` and the
    rest, as ``torchrun`` sets them) unless one is started or the
    environment names none; returns this rank's device (``LOCAL_RANK``'s
    card under CUDA)."""
    if device.type == "cuda" and "LOCAL_RANK" in os.environ:
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method="env://")
    return device


if __name__ == "__main__":
    main()
