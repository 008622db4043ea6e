"""Int8 gradient compression (``repro/optim/grad_compress.py``): the
quant -> dequant of the matrix gradients that ``cfg.grad_compress`` puts in
the train step, the numerics of an int8 wire format.  ``torch.round``
rounds half to even, as ``jnp.round`` does.  ``compressed_allreduce_int8``
needs a collective and waits for the multi-device slice.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.optim.optimizer import tree_map


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
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
        q, s = quantize_int8(g)
        return dequantize(q, s).to(g.dtype)

    return tree_map(qd, grads)
