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


def sample_traced(logits: torch.Tensor, generator: Optional[torch.Generator],
                  temperature: torch.Tensor, *, vocab: Optional[int] = None
                  ) -> torch.Tensor:
    """``sample`` with ``temperature`` a 0-d float32 device tensor
    (``repro/serve/sampling.py`` ``sample_traced``): one captured decode
    graph serves every temperature.  ``generator=None`` is the greedy graph:
    the argmax alone, the parity path.  Otherwise ``t <= 0`` selects the
    same argmax and ``t > 0`` the draw ``sample`` makes from ``generator``
    (the division by ``max(t, 1e-6)`` is ``sample``'s division for every
    ``t`` the draw is kept for)."""
    x = logits[:, 0].to(torch.float32)
    if vocab is not None:
        cols = torch.arange(x.shape[-1], device=x.device)
        x = torch.where(cols < vocab, x, -torch.inf)
    greedy = x.argmax(dim=-1).to(torch.int32)[:, None]
    if generator is None:
        return greedy
    probs = torch.softmax(x / torch.clamp(temperature, min=1e-6), dim=-1)
    drawn = torch.multinomial(probs, 1, generator=generator).to(torch.int32)
    return torch.where(temperature <= 0.0, greedy, drawn)
