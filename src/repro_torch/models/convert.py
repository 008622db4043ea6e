"""Carry the reference's parameters across to the port.

``params_from_jax`` takes ``repro.models.model.init_params`` output after
``np.asarray`` on every leaf (this module never imports JAX) and returns the
port's parameter tree: the same nesting and layout (the unit positions
``u0``.. stacked on a leading ``(n_repeats,)`` axis, the tail positions
``t0``.. unstacked, zamba2's one ``shared_attn`` set unstacked, whisper's
``enc`` / ``dec`` stacks and ``enc_final_norm``, (in, out) matrices), the
leaves of ``model.F32_PARAMS`` (norm scales, the Mamba-2 block's ``a_log``,
``dt_bias``, ``d_skip`` and ``norm_scale``) in float32.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.model import F32_PARAMS, Decl, param_decls


def _to_numpy_f32(a) -> np.ndarray:
    a = np.asarray(a)
    # bfloat16 leaves arrive as an extension dtype torch cannot read directly
    return a.astype(np.float32)


def params_from_jax(np_params: Dict[str, Any], cfg, device="cuda",
                    dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    """Reference parameters (nested dicts of numpy arrays) -> the port's
    (nested dicts of tensors on ``device``).  Matrices and biases become
    ``dtype``; the ``F32_PARAMS`` leaves stay float32.  Raises on a missing, extra or misshapen
    leaf."""
    dev = resolve_device(device)

    def walk(decls, tree, path):
        if set(decls) != set(tree):
            raise ValueError(f"{path or 'params'}: keys {sorted(tree)} != "
                             f"declared {sorted(decls)}")
        out = {}
        for name, decl in decls.items():
            here = f"{path}/{name}" if path else name
            if not isinstance(decl, Decl):
                out[name] = walk(decl, tree[name], here)
                continue
            arr = _to_numpy_f32(tree[name])
            if arr.shape != decl.shape:
                raise ValueError(f"{here}: shape {arr.shape} != declared {decl.shape}")
            dt = torch.float32 if name in F32_PARAMS else dtype
            out[name] = torch.from_numpy(arr).to(dtype=dt, device=dev)
        return out

    return walk(param_decls(cfg), np_params, "")
