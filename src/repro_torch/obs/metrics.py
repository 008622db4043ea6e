"""The metrics registry and the decode loop's device planes
(``repro/obs/metrics.py``).

The registry is the one snapshot surface of the serving stack: every cache,
engine and tenancy telemetry source mounts a *provider* (a callable returning
a possibly nested dict) under a namespace, and ``Registry.snapshot()``
flattens the mounted tree into one flat ``{"ns/sub/key": value}`` dict.
Providers return tensors un-pulled (0-d counters, ``(rows,)`` planes,
histograms), and the snapshot reads every device tensor back with one
synchronization (``_pull``): the leaves of each device are packed into one
byte buffer on the device (``reshape(-1).view(torch.uint8)``, one
``torch.cat``), copied to the host by one ``.cpu()`` and split there.  Never
one synchronization per key.

The decode-loop planes (``loop_planes`` / ``loop_update``) follow the
reference's ``RowCounters`` idiom: a small int32 carry advanced by integer
ops only, inside the captured decode step (``loop_update_``, in place, since
a graph replay writes to fixed addresses) or once per step on the host loop,
so the two loops' planes are equal bit for bit: integer adds have no
rounding to reorder.  The token histogram is a scatter-add into the fixed
``(HIST_BINS,)`` plane (``index_add_``), not ``torch.bincount``, which sizes
its output from the data and so cannot be captured.

``safe_ratio`` is the one guarded hit-ratio division every surface uses.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = [
    "safe_ratio",
    "safe_ratio_plane",
    "Derived",
    "Registry",
    "HIST_BINS",
    "loop_planes",
    "loop_update",
    "loop_update_",
    "loop_merge_",
]

#: token-histogram buckets of the decode-loop planes (``loop_planes``)
HIST_BINS = 16

#: numpy dtype of each tensor dtype a snapshot leaf may have (bfloat16 is
#: widened to float32 on the device before the pull: numpy has no bfloat16)
_NP_DTYPES = {
    torch.bool: np.bool_, torch.uint8: np.uint8, torch.int8: np.int8,
    torch.int16: np.int16, torch.int32: np.int32, torch.int64: np.int64,
    torch.float16: np.float16, torch.float32: np.float32, torch.float64: np.float64,
}


def safe_ratio(num, den) -> float:
    """``num / den`` with the zero-denominator guard every telemetry surface
    shares: 0.0 when ``den`` is falsy (no accesses yet).  Host numbers in,
    a host float out: exact float64 division of ints, so accounting parity
    checks can compare ratios with ``==``."""
    return num / den if den else 0.0


def safe_ratio_plane(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """``safe_ratio`` over whole planes on the device: float32 ``num / den``
    where ``den > 0``, else 0.0.  The guard selects the operand, not the
    result, so an empty row makes no NaN."""
    den_f = torch.clamp(den.to(torch.float32), min=1.0)
    out = num.to(torch.float32) / den_f
    return torch.where(den > 0, out, torch.zeros((), dtype=torch.float32, device=out.device))


class Derived(NamedTuple):
    """A snapshot value computed on the host after the pull, from its own
    namespace group's pulled siblings: e.g. the exact float64 ``hits /
    accesses`` of pulled int counters.  ``fn`` receives a dict of the group's
    sibling values keyed by their relative names (``{"hits": 3,
    "accesses": 4, ...}``)."""

    fn: Callable[[Dict[str, Any]], Any]


def _flatten(prefix: str, tree: Any, flat: Dict[str, Any]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(f"{prefix}/{k}" if prefix else str(k), v, flat)
    else:
        flat[prefix] = tree


def _scalarize(v: Any) -> Any:
    if isinstance(v, np.ndarray) and v.ndim == 0:
        return v.item()
    if isinstance(v, (np.integer, np.floating, np.bool_)):
        return v.item()
    return v


def _pack(tensors: List[torch.Tensor]) -> torch.Tensor:
    """The bytes of ``tensors`` (one device, no bfloat16), one after the
    other, as one uint8 tensor on that device: one ``torch.cat``."""
    return torch.cat([t.contiguous().reshape(-1).view(torch.uint8) for t in tensors])


def _split(raw: np.ndarray, tensors: List[torch.Tensor]) -> List[np.ndarray]:
    """``_pack``'s bytes read back to the host, cut into one numpy array per
    tensor, of its dtype and shape."""
    out, at = [], 0
    for t in tensors:
        n = t.numel() * t.element_size()
        out.append(raw[at:at + n].view(_NP_DTYPES[t.dtype]).reshape(tuple(t.shape)).copy())
        at += n
    return out


def _pull(leaves: List[torch.Tensor]) -> List[np.ndarray]:
    """Every tensor of ``leaves`` as a numpy array of its own dtype and
    shape, with one device-to-host copy (and so one synchronization) per
    device: the leaves of a device are packed into one byte buffer there
    (``_pack``), read back by one ``.cpu()`` and split on the host
    (``_split``).  The one read-back of a snapshot; CPU tensors are read in
    place."""
    out: List[Any] = [None] * len(leaves)
    by_device: Dict[torch.device, list] = {}
    for i, t in enumerate(leaves):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        if t.device.type == "cpu":
            out[i] = t.numpy().copy()
        else:
            by_device.setdefault(t.device, []).append((i, t))
    for items in by_device.values():
        tensors = [t for _, t in items]
        arrays = _split(_pack(tensors).cpu().numpy(), tensors)
        for (i, _), arr in zip(items, arrays):
            out[i] = arr
    return out


class Registry:
    """Namespace-mounted metrics registry with a one-pull snapshot.

    ``mount(ns, provider)`` registers a callable returning a (possibly
    nested) dict for namespace ``ns``; ``set_gauge(path, value)`` sets a
    sticky host-side gauge that every later snapshot reports until it is
    overwritten.  ``snapshot()`` evaluates every provider, flattens to
    ``"ns/sub/key"`` paths, pulls all tensor leaves with one ``_pull``,
    resolves ``Derived`` entries from their pulled siblings, and returns
    plain scalars and numpy arrays."""

    def __init__(self):
        self._providers: Dict[str, Callable[[], Dict[str, Any]]] = {}
        self._gauges: Dict[str, Any] = {}

    def mount(self, namespace: str, provider: Callable[[], Dict[str, Any]]) -> None:
        """Register ``provider`` under ``namespace`` (replacing any earlier
        mount there).  Providers run at snapshot time and must not read the
        device: they return tensors as they are."""
        self._providers[str(namespace)] = provider

    def unmount(self, namespace: str) -> None:
        """Remove a mounted provider (no-op if absent)."""
        self._providers.pop(str(namespace), None)

    def set_gauge(self, path: str, value: Any) -> None:
        """Set a sticky host-side gauge at flat ``path``, reported by every
        later ``snapshot()`` until overwritten.  Gauges shadow provider
        values at the same path and outlive an unmount."""
        self._gauges[str(path)] = value

    def snapshot(self) -> Dict[str, Any]:
        """The flat namespaced snapshot of every mounted provider plus the
        sticky gauges, with one ``_pull`` for all tensor leaves.  0-d
        tensors come back as Python scalars, planes as numpy arrays of the
        tensor's dtype."""
        flat: Dict[str, Any] = {}
        for ns, provider in self._providers.items():
            _flatten(ns, provider() or {}, flat)
        flat.update(self._gauges)
        keys = [k for k, v in flat.items() if isinstance(v, torch.Tensor)]
        pulled = dict(zip(keys, _pull([flat[k] for k in keys]))) if keys else {}
        out: Dict[str, Any] = {}
        derived = []
        for k, v in flat.items():
            if isinstance(v, Derived):
                derived.append((k, v))
            elif k in pulled:
                out[k] = _scalarize(pulled[k])
            else:
                out[k] = _scalarize(v)
        for path, d in derived:
            prefix = path.rsplit("/", 1)[0] + "/" if "/" in path else ""
            group = {
                k[len(prefix):]: v
                for k, v in out.items()
                if k.startswith(prefix) and "/" not in k[len(prefix):]
            }
            out[path] = d.fn(group)
        return out


# -- the decode loop's planes -------------------------------------------------


def loop_planes(device="cuda", bins: int = HIST_BINS) -> Dict[str, torch.Tensor]:
    """Fresh all-zero decode-loop planes on ``device`` (the CUDA card unless
    the caller asks for the CPU): the sampling-event and token counters (0-d
    int32) and a ``(bins,)`` int32 token-id histogram."""
    z = dict(dtype=torch.int32, device=resolve_device(device))
    return {"steps": torch.zeros((), **z), "tokens": torch.zeros((), **z),
            "token_hist": torch.zeros((bins,), **z)}


def loop_update_(planes: Dict[str, torch.Tensor], toks: torch.Tensor, *,
                 vocab: int) -> Dict[str, torch.Tensor]:
    """One sampling event's fold into ``planes``, in place: ``steps += 1``,
    ``tokens += toks.numel()`` and a scatter-add into the token histogram
    (bucket ``clip(tok * bins // vocab, 0, bins - 1)``, int32).  Integer ops
    on the device only, nothing read back: it is captured in the decode
    graph."""
    t = toks.reshape(-1).to(torch.int32)
    hist = planes["token_hist"]
    bins = hist.shape[0]
    b = torch.clamp(t * bins // vocab, 0, bins - 1)
    hist.index_add_(0, b, torch.ones_like(b))
    planes["steps"].add_(1)
    planes["tokens"].add_(t.numel())
    return planes


def loop_update(planes: Dict[str, torch.Tensor], toks: torch.Tensor, *,
                vocab: int) -> Dict[str, torch.Tensor]:
    """``loop_update_`` on copies: the reference's pure form."""
    return loop_update_({k: v.clone() for k, v in planes.items()}, toks, vocab=vocab)


def loop_merge_(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor]) -> None:
    """Add the planes ``src`` into ``dst`` on the device (integer adds, so
    folding a bucket into planes of its own and adding those equals folding
    every step into ``dst``, bit for bit)."""
    for k, v in dst.items():
        v.add_(src[k])
