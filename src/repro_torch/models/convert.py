"""Carry the reference's parameters across to the port.

``params_from_jax`` takes ``repro.models.model.init_params`` output after
``np.asarray`` on every leaf (this module never imports JAX) and returns the
port's parameter tree: the same nesting and layout (the unit positions
``u0``.. stacked on a leading ``(n_repeats,)`` axis, the tail positions
``t0``.. unstacked, zamba2's one ``shared_attn`` set unstacked, whisper's
``enc`` / ``dec`` stacks and ``enc_final_norm``, (in, out) matrices), the
leaves of ``model.F32_PARAMS`` (norm scales, the Mamba-2 block's ``a_log``,
``dt_bias``, ``d_skip`` and ``norm_scale``) in float32.

``opt_state_from_jax`` does the same for the reference's optimizer state
(``repro.optim.optimizer.OptState`` with numpy leaves), so that both sides
can take one identical update step.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.model import F32_PARAMS, Decl, param_decls
from repro_torch.optim.optimizer import OptState


def _to_numpy_f32(a) -> np.ndarray:
    a = np.asarray(a)
    # bfloat16 leaves arrive as an extension dtype torch cannot read directly
    return a.astype(np.float32)


def _tree_from_jax(np_tree, cfg, dev, dtype_of) -> Dict[str, Any]:
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
            out[name] = torch.from_numpy(arr).to(dtype=dtype_of(name), device=dev)
        return out

    return walk(param_decls(cfg), np_tree, "")


def params_from_jax(np_params: Dict[str, Any], cfg, device="cuda",
                    dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    """Reference parameters (nested dicts of numpy arrays) -> the port's
    (nested dicts of tensors on ``device``).  Matrices and biases become
    ``dtype``; the ``F32_PARAMS`` leaves stay float32.  Raises on a missing, extra or misshapen
    leaf."""
    return _tree_from_jax(np_params, cfg, resolve_device(device),
                          lambda name: torch.float32 if name in F32_PARAMS else dtype)


def opt_state_from_jax(np_opt_state, cfg, device="cuda",
                       adam_dtype: torch.dtype = torch.float32) -> OptState:
    """The reference's ``OptState`` (its leaves as numpy) -> the port's
    ``OptState`` on ``device``: the step as a 0-d int32 tensor, m and v in
    ``adam_dtype`` on every leaf, the master weights (or None) in float32."""
    dev = resolve_device(device)
    step = torch.tensor(int(np.asarray(np_opt_state.step)), dtype=torch.int32, device=dev)
    m = _tree_from_jax(np_opt_state.m, cfg, dev, lambda _: adam_dtype)
    v = _tree_from_jax(np_opt_state.v, cfg, dev, lambda _: adam_dtype)
    master = (None if np_opt_state.master is None else
              _tree_from_jax(np_opt_state.master, cfg, dev, lambda _: torch.float32))
    return OptState(step, m, v, master)
