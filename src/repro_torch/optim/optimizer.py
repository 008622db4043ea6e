"""AdamW on tensor dicts (``repro/optim/optimizer.py``): f32 master weights
(optional), configurable m/v dtype, global-norm clipping, decoupled weight
decay and a cosine schedule with warmup.

Plain functions under ``torch.no_grad()`` on nested dicts of tensors (the
parameter tree): ``apply_updates`` writes the new parameters, moments and
master weights into the given tensors (the reference's launcher donates
them to its jitted step) and never reads the device from the host.  The
step, the schedule and the bias corrections are f32 tensors on the
parameters' device, as the reference computes them, not Python doubles.
Weight decay follows the reference's rule ``p.ndim >= 2`` exactly: in the
stacked layout it also decays the ``(n_layers, d)`` norm scales.
``abstract_opt_state`` (shapes for a dry run) is not ported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.models.model import torch_dtype


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    adam_dtype: str = "float32"
    master_weights: bool = True


class OptState(NamedTuple):
    step: torch.Tensor  # 0-d int32
    m: Any
    v: Any
    master: Any  # f32 parameters, or None


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of nested dicts and tuples (an ``OptState``), in order;
    None has none."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, tuple):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


@torch.no_grad()
def init_opt_state(params, oc: OptConfig) -> OptState:
    adt = torch_dtype(oc.adam_dtype)
    m = tree_map(lambda p: torch.zeros(p.shape, dtype=adt, device=p.device), params)
    v = tree_map(lambda p: torch.zeros(p.shape, dtype=adt, device=p.device), params)
    master = (tree_map(lambda p: p.detach().to(torch.float32, copy=True), params)
              if oc.master_weights else None)
    device = tree_leaves(params)[0].device
    return OptState(torch.zeros((), dtype=torch.int32, device=device), m, v, master)


@torch.no_grad()
def schedule(oc: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step`` (0-d int tensor) as an f32 tensor: linear
    warmup, then cosine to ``min_lr_frac``."""
    step = step.to(torch.float32)
    warm = step / max(oc.warmup_steps, 1)
    prog = torch.clamp((step - oc.warmup_steps) / max(oc.total_steps - oc.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = oc.min_lr_frac + (1 - oc.min_lr_frac) * cos
    return oc.lr * torch.where(step < oc.warmup_steps, warm, frac)


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    total = None
    for g in tree_leaves(tree):
        part = torch.sum(torch.square(g.to(torch.float32)))
        total = part if total is None else total + part
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(params, grads, state: OptState, oc: OptConfig
                  ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """grads: f32 tree.  Updates ``params`` and ``state``'s tensors in place
    (one copy of the parameters and Adam states, not the old and the new)
    and returns (params, new_state, metrics), the metrics 0-d f32 tensors
    on the device."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(oc.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = schedule(oc, step)
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(torch.tensor(oc.b1, dtype=torch.float32, device=stepf.device), stepf)
    b2c = 1 - torch.pow(torch.tensor(oc.b2, dtype=torch.float32, device=stepf.device), stepf)
    adt = torch_dtype(oc.adam_dtype)

    def upd(p, g, m, v, mw: Optional[torch.Tensor]):
        g = g.to(torch.float32) * scale
        m32 = m.to(torch.float32) * oc.b1 + g * (1 - oc.b1)
        v32 = v.to(torch.float32) * oc.b2 + g * g * (1 - oc.b2)
        mhat = m32 / b1c
        vhat = v32 / b2c
        base = (mw if mw is not None else p).to(torch.float32)
        # decay only matrices (>= 2 dims), the reference's rule
        wd = oc.weight_decay if p.dim() >= 2 else 0.0
        new = base - lr * (mhat / (torch.sqrt(vhat) + oc.eps) + wd * base)
        return new, m32.to(adt), v32.to(adt)

    def walk(p, g, m, v, mw):
        if isinstance(p, dict):
            for k in p:
                walk(p[k], g[k], m[k], v[k], None if mw is None else mw[k])
            return
        n, m2, v2 = upd(p, g, m, v, mw)
        p.copy_(n)
        m.copy_(m2)
        v.copy_(v2)
        if mw is not None:
            mw.copy_(n)

    walk(params, grads, state.m, state.v, state.master)
    return params, OptState(step, state.m, state.v, state.master), {"grad_norm": gnorm,
                                                                     "lr": lr}
