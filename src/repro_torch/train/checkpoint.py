"""Checkpoints (``repro/train/checkpoint.py``), in the reference's layout:

    <dir>/step_<N>/
       manifest.json      — step, flat param/opt tree spec (path, shape,
                            dtype), data-pipeline state, extra
       arrays.npz          — flat leaf name -> full array
       .complete           — commit marker written LAST (atomic visibility)

Leaves are named by their paths (``params/u0/wq``, ``opt/m/u0/wq``,
``opt/step``), as the reference names them, so a checkpoint of either
package restores in the other.  numpy has no bfloat16 without
``ml_dtypes``: a bf16 leaf is stored as its ``uint16`` bits and the
manifest's ``dtype`` says ``bfloat16``.  Saving copies each leaf to the
host; async mode hands those host arrays to a writer thread, so the loop
resumes at once.  ``restore`` puts each leaf on its template leaf's device.

Placed state (DTensor leaves, a train step on a mesh): ``save`` writes each
leaf's full tensor, gathered to the host one dim-0 slice of a stacked leaf
at a time (every rank takes part in the gathers, rank 0 alone keeps the
host copy and writes), so the files are the unsharded format; ``restore``
cuts each rank's piece of a leaf out of the host array and moves only that
piece to the device, on its template's mesh and placements.  So a sharded
checkpoint restores unsharded and the other way round.  ``sync`` is the barrier a multi-rank loop passes before
it reads a checkpoint that rank 0 may still be writing.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.sharding.shards import local_part, whole_slices

_SEP = "/"


def _flatten(tree) -> Dict[str, Any]:
    flat = {}

    def walk(t, prefix):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, prefix + (str(k),))
        elif isinstance(t, (list, tuple)) and not hasattr(t, "_fields"):
            for i, v in enumerate(t):
                walk(v, prefix + (str(i),))
        elif hasattr(t, "_fields"):  # NamedTuple
            for k in t._fields:
                walk(getattr(t, k), prefix + (k,))
        elif t is None:
            return
        else:
            flat[_SEP.join(prefix)] = t

    walk(tree, ())
    return flat


def _to_host(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(numpy array, manifest dtype) of a leaf; bf16 as its uint16 bits.  A
    copy also on the CPU: the train step updates its tensors in place while
    an asynchronous write is still reading them."""
    if isinstance(t, DTensor):  # gathered one dim-0 slice at a time
        host = torch.empty(t.shape, dtype=t.dtype)
        for part, piece in zip(host.unbind(0) if t.dim() >= 3 else (host,), whole_slices(t)):
            part.copy_(piece)
        t = host
    else:
        t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def _writes() -> bool:
    """Whether this process writes checkpoints: rank 0 of a started world,
    or the one process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def sync() -> None:
    """A barrier over the started world (nothing in a world of one)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def save(directory: str, step: int, params, opt_state=None,
         data_state: Optional[dict] = None, extra: Optional[dict] = None,
         *, async_write: bool = False) -> threading.Thread | None:
    """Copy to the host and write ``step_<N>``; async mode returns the writer
    thread (join before exit).  In a world of several ranks every rank calls
    it (placed leaves are gathered) and rank 0 alone writes."""
    tree = {"params": params}
    if opt_state is not None:
        tree["opt"] = opt_state
    if not _writes():  # take part in the placed leaves' gathers only
        for v in _flatten(tree).values():
            if isinstance(v, DTensor):
                for _ in whole_slices(v):
                    pass
        return None
    host, dtypes = {}, {}
    for k, v in _flatten(tree).items():
        host[k], dtypes[k] = _to_host(v)
    manifest = {
        "step": step,
        "leaves": {k: {"shape": list(v.shape), "dtype": dtypes[k]}
                   for k, v in host.items()},
        "data_state": data_state or {},
        "extra": extra or {},
    }

    def write():
        final = os.path.join(directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **host)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        open(os.path.join(tmp, ".complete"), "w").close()
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)

    if async_write:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    write()
    return None


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for d in os.listdir(directory):
        full = os.path.join(directory, d)
        if d.startswith("step_") and os.path.exists(
                os.path.join(full, ".complete")):
            steps.append(int(d[5:]))
    return max(steps) if steps else None


def restore(directory: str, step: int, params_template, opt_template=None
            ) -> Tuple[Any, Any, dict, dict]:
    """Rebuild (params, opt_state, data_state, extra); the templates supply
    the tree's structure and each leaf's device."""
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = manifest["leaves"]

    with np.load(os.path.join(d, "arrays.npz")) as arrays:
        def rebuild(template, prefix):
            if isinstance(template, dict):
                return {k: rebuild(v, prefix + (str(k),)) for k, v in template.items()}
            if hasattr(template, "_fields"):
                return type(template)(**{k: rebuild(getattr(template, k), prefix + (k,))
                                         for k in template._fields})
            if isinstance(template, (list, tuple)):
                return type(template)(rebuild(v, prefix + (str(i),))
                                      for i, v in enumerate(template))
            if template is None:
                return None
            key = _SEP.join(prefix)
            if isinstance(template, DTensor):  # only this rank's piece goes to the device
                full = _from_host(arrays[key], leaves[key]["dtype"], "cpu")
                return local_part(full, template.device_mesh, template.placements,
                                  template.to_local().device)
            return _from_host(arrays[key], leaves[key]["dtype"], template.device)

        params = rebuild(params_template, ("params",))
        opt = rebuild(opt_template, ("opt",)) if opt_template is not None else None
    return params, opt, manifest.get("data_state", {}), manifest.get("extra", {})


def gc_old(directory: str, keep: int = 3) -> None:
    if not _writes() or not os.path.isdir(directory):
        return
    steps = sorted(
        int(d[5:]) for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"), ignore_errors=True)
