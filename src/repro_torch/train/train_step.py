"""Training step factory (``repro/train/train_step.py``): microbatched
gradient accumulation and the AdamW update.

The global batch (B_g, S) is split into ``n_micro`` chunks; each chunk's
loss is differentiated by one backward (the attention's through the
backward kernel), and its gradients are added into ``cfg.grad_accum_dtype``
buffers, which bounds activation memory by the microbatch.  Then the sum is
divided by ``n_micro``, optionally int8-compressed (``cfg.grad_compress``)
and applied.  The step reads nothing back to the host: its metrics are 0-d
tensors on the device.
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


def make_train_step(cfg, oc: O.OptConfig, n_micro: int):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, which updates the given parameters and optimizer state in
    place (``O.apply_updates``); ``batch`` values are tensors on the
    parameters' device whose leading dim B_g divides by ``n_micro``."""
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
        with torch.no_grad():
            # in place where the accumulator is f32: the same bits as a / n
            flat = [a.to(torch.float32).div_(n_micro) for a in acc]
            del acc
            it = iter(flat)
            grads = O.tree_map(lambda _: next(it), params)
            if cfg.grad_compress:
                grads = maybe_compress_grads(grads)
            params, opt_state, metrics = O.apply_updates(params, grads, opt_state, oc)
            metrics["loss"] = loss_sum / n_micro
        return params, opt_state, metrics

    return train_step
