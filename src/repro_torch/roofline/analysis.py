"""Roofline terms from dry-run records (``repro/roofline/analysis.py``),
with the H100's constants.

Per (arch × shape × mesh) cell:

    compute term    = FLOPs_per_device / PEAK_FLOPS                [s]
    memory term     = bytes_per_device / HBM_BW                    [s]
    collective term = collective_bytes_per_device / LINK_BW        [s]

The constants are an H100 SXM5's, from NVIDIA's H100 data sheet:
``PEAK_FLOPS`` the bf16 dense tensor-core rate (989 TFLOP/s, without
sparsity), ``HBM_BW`` the HBM3 rate (3.35 TB/s), and ``LINK_BW`` NVLink 4's
rate in one direction (450 GB/s: the sheet's 900 GB/s counts both).  A world
of 256 or 512 ranks spans 32 or 64 eight-GPU nodes, whose links between
nodes are slower than NVLink, so the collective term is a lower bound.

The reference reads its FLOPs and collectives out of XLA's compiled module;
the port has none.  Its dry run (``launch/dryrun.py``) runs a cell's step on
``meta`` tensors under ``CellTrace``, a ``TorchDispatchMode`` that sees each
rank's local ops after DTensor has lowered them: each collective's output
tensor and group size (``collective_bytes`` applies the reference's ring
rules to them) and each op's FLOPs by ``torch.utils.flop_counter``'s
formulas (the ones ``FlopCounterMode`` applies).  The ring rules, per
device:

    all-gather:          result_bytes               (each device receives ~N-1/N)
    reduce-scatter:      result_bytes * group_size  (sends ~N-1/N of its input)
    all-reduce:          2 * result_bytes           (RS + AG phases)
    all-to-all:          result_bytes
    collective-permute:  result_bytes
    broadcast:           result_bytes               (no XLA counterpart)
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# H100 SXM5 (NVIDIA H100 Tensor Core GPU data sheet)
PEAK_FLOPS = 989e12  # bf16 dense tensor cores, FLOP/s
HBM_BW = 3.35e12  # HBM3, bytes/s
LINK_BW = 450e9  # NVLink 4, bytes/s in one direction (900 GB/s both ways)

#: collective kind of each functional-collective op the dispatch mode sees
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_reduce": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "broadcast",
}
_NAMESPACES = ("_c10d_functional", "_dtensor")
#: the reference's kinds (its HLO census), and broadcast
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute", "broadcast")


class Collective(NamedTuple):
    """One collective as a rank issues it: its kind, the bytes of its
    result on this rank and its group's size."""

    kind: str
    result_bytes: int
    group_size: int


def _bytes(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    return sum(_bytes(t) for t in out) if isinstance(out, (list, tuple)) else 0


def _group_size(func, args, kwargs) -> int:
    """The ``group_size`` argument where the op's schema has one, else 0."""
    for i, a in enumerate(func._schema.arguments):
        if a.name == "group_size":
            return int(kwargs[a.name] if a.name in kwargs else args[i])
    return 0


class CellTrace(TorchDispatchMode):
    """Records each rank-local collective (``collectives``) and sums the
    rank-local ops' FLOPs (``flops``, ``torch.utils.flop_counter``'s
    formulas).  An op on DTensors is handed back to DTensor
    (``NotImplemented``), which lowers it to local ops and collectives that
    come here again, as ``CommDebugMode`` does: so every count is one
    rank's, and a redistribution inside an op is seen."""

    def __init__(self):
        super().__init__()
        self.collectives: List[Collective] = []
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if func.namespace in _NAMESPACES and packet.__name__ in _KINDS:
            self.collectives.append(Collective(_KINDS[packet.__name__], _bytes(out),
                                               _group_size(func, args, kwargs)))
        elif packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        return out

    def counts(self) -> Dict[str, int]:
        """Collectives issued, per kind (every kind of ``KINDS``)."""
        out = {k: 0 for k in KINDS}
        for c in self.collectives:
            out[c.kind] += 1
        return out


def collective_bytes(collectives) -> Dict[str, float]:
    """Sum estimated per-device wire bytes per collective kind, from
    ``Collective`` records (``CellTrace.collectives``), by the ring rules of
    the module docstring; ``"total"`` sums the kinds."""
    out: Dict[str, float] = {}
    for c in collectives:
        if c.kind == "all-reduce":
            traffic = 2.0 * c.result_bytes
        elif c.kind == "reduce-scatter":
            traffic = float(c.result_bytes * c.group_size)
        else:
            traffic = float(c.result_bytes)
        out[c.kind] = out.get(c.kind, 0.0) + traffic
    out["total"] = sum(v for k, v in out.items() if k != "total")
    return out


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float  # per device
    hlo_bytes: float  # per device
    coll_bytes: float  # per device
    model_flops: float  # 6*N*D (global, per step)
    bytes_per_device: Optional[float] = None  # the arguments' bytes on a device

    @property
    def compute_s(self) -> float:
        return self.hlo_flops / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline lower bound (no overlap assumed away): max of the three."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_frac(self) -> float:
        """MODEL_FLOPS / (FLOPs x chips): remat/padding/dispatch waste."""
        total_hlo = self.hlo_flops * self.chips
        return self.model_flops / total_hlo if total_hlo else 0.0

    @property
    def mfu(self) -> float:
        """Model FLOPs utilization at the roofline step time."""
        denom = self.step_time_s * self.chips * PEAK_FLOPS
        return self.model_flops / denom if denom else 0.0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        for k in ("compute_s", "memory_s", "collective_s", "bottleneck",
                  "useful_flops_frac", "mfu", "step_time_s"):
            d[k] = getattr(self, k)
        return d


def model_flops_for(cfg, shape) -> float:
    """6·N·D (dense) / 6·N_active·D (MoE) per step; decode: D = global_batch
    new tokens; train adds nothing (the 6x already covers fwd+bwd); prefill
    uses the 2·N·D forward-only factor."""
    n = cfg.n_active_params()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def from_dryrun_json(path: str) -> Roofline:
    """A dry-run record's roofline.  The port's records carry no
    ``bytes_accessed`` (only XLA's cost analysis gives it): the memory term
    then reads the analytic ``hbm_bytes``."""
    with open(path) as f:
        d = json.load(f)
    hbm = d.get("bytes_accessed")
    return Roofline(
        arch=d["arch"], shape=d["shape"], mesh=d["mesh"], chips=d["chips"],
        hlo_flops=d["flops"],
        hlo_bytes=hbm if hbm is not None else d["analytic"]["hbm_bytes"],
        coll_bytes=d["collectives"]["total"], model_flops=d["model_flops"],
        bytes_per_device=d.get("memory", {}).get("argument_size_in_bytes"),
    )
