"""PyTorch / CUDA port of the AWRP serving stack (``repro``'s second package).

The JAX package ``repro`` stays the reference.  This package mirrors its
layout module for module (``configs``, ``core``, ``cache``, ``kernels``,
``models``, ``serve``, ``launch``) and imports neither JAX nor ``repro``:
everything it needs is copied here.  The decode hot path runs through
hand-written CUDA kernels for Hopper (``kernels/csrc``); a tensor on the CPU
goes to each kernel's plain PyTorch version instead.

Entry points take ``device="cuda"`` by default and raise when CUDA is not
available; only an explicit ``device="cpu"`` runs on the CPU.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
