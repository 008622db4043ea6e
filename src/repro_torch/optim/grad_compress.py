"""Int8 gradient compression (``repro/optim/grad_compress.py``).  Two
pieces:

* ``maybe_compress_grads``: the quant -> dequant of the matrix gradients
  that ``cfg.grad_compress`` puts in the train step, the numerics of an int8
  wire format.  A placed (DTensor) gradient is scaled by its global max|g|
  (an exact max over the shards), so it quantizes as the unsharded one.
* ``compressed_allreduce_int8``: the wire format itself over a process
  group: each rank quantizes to int8, ``all_gather`` moves the int8
  payloads and the f32 scales, and every rank sums ``s_r * q_r`` locally in
  f32 as the reference's ``tensordot`` over the gathered axis does on XLA's
  CPU: a chain of fused multiply-adds in rank order (``sum_scaled``).
  As in the reference, the train step does not call it.

``torch.round`` rounds half to even, as ``jnp.round`` does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.core.policy_core import _f32_of_sum
from repro_torch.optim.optimizer import tree_map


def quantize_int8(x: torch.Tensor, amax: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: scale max|x| / 127 (+1e-12), or ``amax`` /
    127 where the caller gives the max of a tensor ``x`` is a shard of."""
    if amax is None:
        amax = torch.max(torch.abs(x))
    scale = amax / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


@torch.no_grad()
def maybe_compress_grads(grads):
    """Per-tensor symmetric int8 quant -> dequant of the matrix gradients;
    vectors stay as they are."""

    def qd(g):
        if g.dim() < 2:
            return g
        if isinstance(g, DTensor):
            amax = torch.max(torch.abs(g)).full_tensor()
            q, s = quantize_int8(g.to_local(), amax)
            return DTensor.from_local(dequantize(q, s).to(g.dtype), g.device_mesh,
                                      g.placements, run_check=False, shape=g.shape,
                                      stride=g.stride())
        q, s = quantize_int8(g)
        return dequantize(q, s).to(g.dtype)

    return tree_map(qd, grads)


@torch.no_grad()
def compressed_allreduce_int8(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` (the default group when
    None) with int8 on the wire: every rank gathers each rank's int8
    payload and f32 scale and returns ``sum_r s_r * q_r`` in f32."""
    import torch.distributed as dist

    q, s = quantize_int8(x)
    n = dist.get_world_size(group)
    qs = [torch.empty_like(q) for _ in range(n)]
    ss = [torch.empty_like(s) for _ in range(n)]
    dist.all_gather(qs, q, group=group)  # the int8 payload
    dist.all_gather(ss, s, group=group)
    return sum_scaled(ss, qs)


def sum_scaled(ss, qs) -> torch.Tensor:
    """``sum_r ss[r] * qs[r]`` in f32 (``ss`` f32 scalars, ``qs`` int8
    tensors of one shape) with the reference's bits:
    ``jnp.tensordot(ss, qs.astype(f32), ((0,), (0,)))`` is a chain of fused
    multiply-adds in rank order, ``acc = f32(s_0 q_0)``, then ``acc =
    fma(s_r, q_r, acc)``, each rounded once.  ``torch.tensordot`` is not: its
    BLAS path may or may not fuse, by host and thread count.  Written out:
    ``s_r q_r`` (24 + 8 significant bits) is exact in float64, and
    ``_f32_of_sum`` rounds ``acc + s_r q_r`` to float32 once, exactly (a
    float64 sum rounded to odd), so the result is an fma's by construction,
    on the CPU and on CUDA, at any ``torch.get_num_threads()``."""
    acc = ss[0] * qs[0].to(torch.float32)
    for s, q in zip(ss[1:], qs[1:]):
        acc = _f32_of_sum(acc.double(), s.double() * q.double())
    return acc
