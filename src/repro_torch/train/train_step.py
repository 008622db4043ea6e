"""Training step factory (``repro/train/train_step.py``): microbatched
gradient accumulation and the AdamW update.

The global batch (B_g, S) is split into ``n_micro`` chunks; each chunk's
loss is differentiated by one backward (the attention's through the
backward kernel), and its gradients are added into ``cfg.grad_accum_dtype``
buffers, which bounds activation memory by the microbatch.  Then the sum is
divided by ``n_micro``, optionally int8-compressed (``cfg.grad_compress``)
and applied.  The step reads nothing back to the host: its metrics are 0-d
tensors on the device.

On a mesh (``mesh=``, a ``launch.mesh`` DeviceMesh over ("data", "model")
or ("pod", "data", "model")) the parameters, the accumulators and the
optimizer state are DTensors placed by the logical-axis rules
(``launch.inputs.place``): FSDP over the batch axes, features over
"model".  Each batch shard takes its own rows of the batch and splits them
into ``n_micro`` chunks.  Per step, each parameter is gathered over the
batch axes once; each chunk then runs the model under ``activate`` on
DTensors over the shard's "model" sub-mesh (the batch wrapped with
``DTensor.from_local``), kernel 6 on each shard's local heads under
``local_map``.  Each chunk's gradients are reduced over the batch axes in a
fixed order: an all-to-all hands every shard its slice of each shard's
gradient (an all-gather for a parameter the batch axes do not split), and
the slices are added into the accumulator in shard order.  So the placed
step at "model" size 1 is bit for bit the unsharded step over the same
chunks, the chunk of micro step m and shard s being chunk m * shards + s of
that step (``n_micro * shards`` chunks); "model" > 1 splits contractions and
agrees within rounding.  The loss is the mean of the chunks' losses, as the
unsharded step's: the reference's mean over the global batch when every
chunk counts as many labels (every label >= 0).
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models import model as M
from repro_torch.optim import optimizer as O
from repro_torch.optim.grad_compress import maybe_compress_grads


def effective_microbatches(cfg, global_batch: int, batch_shards: int) -> int:
    """Largest n_micro <= cfg.microbatches with a whole per-shard batch."""
    n = min(cfg.microbatches, max(global_batch // batch_shards, 1))
    while global_batch % (n * batch_shards) and n > 1:
        n -= 1
    return max(n, 1)


def make_train_step(cfg, oc: O.OptConfig, n_micro: int, *, mesh=None, rules=None):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, which updates the given parameters and optimizer state in
    place (``O.apply_updates``); ``batch`` values are tensors on the
    parameters' device whose leading dim B_g divides by ``n_micro``.  With
    ``mesh`` (and the rules, ``make_rules``' defaults when None) the state
    is placed on it and ``batch`` is either the global batch, the same on
    every rank, or its rows placed ``Shard(0)`` over the batch axes; B_g
    divides by ``n_micro * batch_shards(mesh)``."""
    if mesh is not None:
        return _placed_train_step(cfg, oc, n_micro, mesh, rules)
    acc_dt = M.torch_dtype(cfg.grad_accum_dtype)

    def train_step(params, opt_state, batch: Dict[str, torch.Tensor]):
        leaves = O.tree_leaves(params)
        live = [p.detach().requires_grad_(True) for p in leaves]
        it = iter(live)
        live_params = O.tree_map(lambda _: next(it), params)
        acc = [torch.zeros(p.shape, dtype=acc_dt, device=p.device) for p in leaves]
        loss_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        chunks = {k: v.chunk(n_micro) for k, v in batch.items()}
        for i in range(n_micro):
            mb = {k: c[i] for k, c in chunks.items()}
            loss = M.loss_fn(live_params, cfg, mb)
            grads = torch.autograd.grad(loss, live)
            with torch.no_grad():
                for a, g in zip(acc, grads):
                    a.add_(g.to(acc_dt))
                loss_sum += loss.detach()
            del loss, grads
        return _finish(cfg, oc, params, opt_state, acc, loss_sum, n_micro)

    return train_step


@torch.no_grad()
def _finish(cfg, oc, params, opt_state, acc, loss_sum, n_chunks: int):
    """Divide the summed gradients and loss by the chunk count, compress,
    apply AdamW."""
    # in place where the accumulator is f32: the same bits as a / n
    flat = [a.to(torch.float32).div_(n_chunks) for a in acc]
    del acc
    it = iter(flat)
    grads = O.tree_map(lambda _: next(it), params)
    if cfg.grad_compress:
        grads = maybe_compress_grads(grads)
    params, opt_state, metrics = O.apply_updates(params, grads, opt_state, oc)
    metrics["loss"] = loss_sum / n_chunks
    return params, opt_state, metrics


def _placed_train_step(cfg, oc: O.OptConfig, n_micro: int, mesh, rules):
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.mesh import batch_axes, batch_shards
    from repro_torch.sharding.specs import activate, make_rules

    if rules is None:
        rules = make_rules(multi_pod="pod" in mesh.mesh_dim_names,
                           moe_sharding=cfg.moe_sharding)
    names = mesh.mesh_dim_names
    bdims = [names.index(a) for a in batch_axes(mesh)]
    mdim = names.index("model")
    model_mesh = mesh["model"]
    n_shards = batch_shards(mesh)
    coord = mesh.get_coordinate()
    shard = 0
    for d in bdims:  # pod-major, the order of Shard(0) over the batch axes
        shard = shard * mesh.size(d) + coord[d]
    acc_dt = M.torch_dtype(cfg.grad_accum_dtype)
    rep = Replicate()

    def shifted(pl):
        return Shard(pl.dim + 1) if isinstance(pl, Shard) else pl

    def reduce_into(acc_local, g_local, p):
        """Add shard 0's, shard 1's, ... slice of this chunk's gradient into
        this shard's accumulator, in that order.  ``g_local`` is this
        shard's gradient, whole over the batch axes; stacked on a new
        leading dim placed ``Shard(0)`` over them, one redistribute moves
        every shard's slice to its owner (all-to-all) or everywhere (a
        parameter the batch axes do not split: all-gather)."""
        if n_shards == 1:
            acc_local.add_(g_local.to(acc_dt))
            return
        src = [Shard(0) if i in bdims else shifted(pl) for i, pl in enumerate(p.placements)]
        dst = [shifted(pl) for pl in p.placements]
        shape = (n_shards,) + tuple(p.shape)
        stacked = DTensor.from_local(g_local[None], mesh, src, run_check=False, shape=shape,
                                     stride=torch.empty(shape, device="meta").stride())
        parts = stacked.redistribute(mesh, dst).to_local()
        for s in range(n_shards):
            acc_local.add_(parts[s].to(acc_dt))

    def local_rows(v):
        if isinstance(v, DTensor):
            return v.to_local()
        rows = v.shape[0] // n_shards
        return v[shard * rows:(shard + 1) * rows]

    def train_step(params, opt_state, batch: Dict[str, torch.Tensor]):
        leaves = O.tree_leaves(params)
        model_pl = [p.placements[mdim] for p in leaves]
        with torch.no_grad():
            gathered = [p.redistribute(mesh, [rep if i in bdims else pl
                                              for i, pl in enumerate(p.placements)])
                        .to_local() for p in leaves]
        live = [DTensor.from_local(g, model_mesh, [pl], run_check=False, shape=p.shape,
                                   stride=p.stride()).requires_grad_(True)
                for g, pl, p in zip(gathered, model_pl, leaves)]
        del gathered
        it = iter(live)
        live_params = O.tree_map(lambda _: next(it), params)
        acc = [torch.zeros_like(p, dtype=acc_dt) for p in leaves]
        acc_local = [a.to_local() for a in acc]
        chunks = {k: local_rows(v).chunk(n_micro) for k, v in batch.items()}
        losses = []
        for i in range(n_micro):
            mb = {k: DTensor.from_local(c[i], model_mesh, [rep], run_check=False)
                  for k, c in chunks.items()}
            with activate(mesh, rules), implicit_replication():
                loss = M.loss_fn(live_params, cfg, mb)
                grads = torch.autograd.grad(loss, live)
            with torch.no_grad():
                for a, g, pl, p in zip(acc_local, grads, model_pl, leaves):
                    reduce_into(a, g.redistribute(model_mesh, [pl]).to_local(), p)
                losses.append(loss.detach().redistribute(model_mesh, [rep]).to_local())
            del loss, grads
        del live, live_params  # the gathered parameters, before the update
        with torch.no_grad():
            mine = torch.stack(losses)[None]  # (1, n_micro)
            every = DTensor.from_local(mine, mesh, [Shard(0) if i in bdims else rep
                                                    for i in range(mesh.ndim)],
                                       run_check=False)
            every = every.redistribute(mesh, [rep] * mesh.ndim).to_local()
            loss_sum = torch.zeros((), dtype=torch.float32, device=mine.device)
            for i in range(n_micro):  # the unsharded step's chunk order
                for s in range(n_shards):
                    loss_sum += every[s, i]
        return _finish(cfg, oc, params, opt_state, acc, loss_sum, n_micro * n_shards)

    return train_step
