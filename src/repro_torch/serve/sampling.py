"""Token sampling for the serving engine (``repro/serve/sampling.py``)."""

from __future__ import annotations

from typing import Optional

import torch


def sample(logits: torch.Tensor, generator: Optional[torch.Generator] = None, *,
           temperature: float = 0.0, vocab: Optional[int] = None) -> torch.Tensor:
    """logits (B, 1, Vpad) -> (B, 1) int32 tokens.  Padded vocab rows are
    masked to -inf.  Greedy (``temperature <= 0``) is the parity path; above
    zero the draw uses ``generator``, whose streams differ from JAX's."""
    x = logits[:, 0].to(torch.float32)
    if vocab is not None:
        cols = torch.arange(x.shape[-1], device=x.device)
        x = torch.where(cols < vocab, x, -torch.inf)
    if temperature <= 0.0:
        return x.argmax(dim=-1).to(torch.int32)[:, None]
    probs = torch.softmax(x / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator).to(torch.int32)
