"""The port's roofline (``repro_torch/roofline``) against the reference's
(``repro/roofline``), on the CPU:

* ``ModelConfig.n_params`` / ``n_active_params`` equal the reference's for
  every arch's CONFIG and SMOKE_CONFIG;
* ``cell_costs`` equals the reference's dict key for key (``==``) over every
  arch x its ``run_shapes``, on the single and multi-pod protocol meshes,
  under each config override the reference's dry run takes
  (``attention_schedule="balanced"``, ``tp_feat=False``,
  ``seq_parallel=True``, ``force_paged_decode=True``) and at
  ``MeshInfo(1, 1)`` and ``MeshInfo(4, 2)``: one parametrised test;
* ``model_flops_for`` equals the reference's;
* the constants are the H100's (no TPU figure), and ``Roofline``'s terms
  divide by them;
* ``collective_bytes`` gives exact byte counts on known redistributions
  over a fake 16-rank (2, 8) "cuda"-typed mesh, in a subprocess (no pytest
  worker keeps a default process group): an all-gather, a Partial ->
  Replicate all-reduce, a reduce-scatter and an all-to-all, as
  ``tests/test_roofline.py::test_collective_bytes_parser`` holds the
  reference's HLO parser.
"""

import dataclasses
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import ARCH_IDS, SHAPES  # noqa: E402
from repro.configs.base import load_config as jload  # noqa: E402
from repro.configs.base import load_smoke_config as jload_smoke  # noqa: E402
from repro.roofline import analysis as JR  # noqa: E402
from repro.roofline import analytic as JA  # noqa: E402
from repro_torch.configs.base import load_config, load_smoke_config  # noqa: E402
from repro_torch.roofline import analysis as R  # noqa: E402
from repro_torch.roofline import analytic as A  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (name, config overrides, cell_costs keywords)
VARIANTS = (
    ("single", {}, {"multi_pod": False}),
    ("multi", {}, {"multi_pod": True}),
    ("balanced", {"attention_schedule": "balanced"}, {"multi_pod": False}),
    ("no_tp_feat", {"tp_feat": False}, {"multi_pod": True}),
    ("seq_parallel", {"seq_parallel": True}, {"multi_pod": False}),
    ("force_paged", {"force_paged_decode": True}, {"multi_pod": False}),
    ("mesh_1x1", {}, {"mesh": (1, 1)}),
    ("mesh_4x2", {}, {"mesh": (4, 2)}),
)
CELLS = [(arch, shape) for arch in ARCH_IDS for shape in jload(arch).run_shapes]


def _kw(kw, mesh_info):
    kw = dict(kw)
    if "mesh" in kw:
        kw["mesh"] = mesh_info(*kw["mesh"])
    return kw


@pytest.mark.parametrize("smoke", [False, True], ids=["config", "smoke"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_equal_reference(arch, smoke):
    mine = (load_smoke_config if smoke else load_config)(arch)
    want = (jload_smoke if smoke else jload)(arch)
    assert mine.n_params() == want.n_params()
    assert mine.n_active_params() == want.n_active_params()


@pytest.mark.parametrize("variant", VARIANTS, ids=lambda v: v[0])
@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_cell_costs_equal_reference(arch, shape_name, variant):
    _, overrides, kw = variant
    cfg = dataclasses.replace(load_config(arch), **overrides)
    jcfg = dataclasses.replace(jload(arch), **overrides)
    shape = SHAPES[shape_name]
    mine = A.cell_costs(cfg, shape, **_kw(kw, A.MeshInfo))
    want = JA.cell_costs(jcfg, shape, **_kw(kw, JA.MeshInfo))
    assert mine.keys() == want.keys()
    for k, v in want.items():
        assert mine[k] == v, (k, mine[k], v)
        assert type(mine[k]) is type(v), k


def test_mesh_info_equals_reference():
    for multi in (False, True):
        mine, want = A.mesh_info(multi), JA.mesh_info(multi)
        assert (mine.batch_shards, mine.model_shards, mine.chips) == \
            (want.batch_shards, want.model_shards, want.chips)


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_model_flops_equal_reference(arch, shape_name):
    shape = SHAPES[shape_name]
    assert R.model_flops_for(load_config(arch), shape) == \
        JR.model_flops_for(jload(arch), shape)


def test_constants_are_the_h100s():
    assert (R.PEAK_FLOPS, R.HBM_BW, R.LINK_BW) == (989e12, 3.35e12, 450e9)
    assert (JR.PEAK_FLOPS, JR.HBM_BW, JR.LINK_BW) != (R.PEAK_FLOPS, R.HBM_BW, R.LINK_BW)
    r = R.Roofline("a", "s", "single", 256, hlo_flops=2 * 989e12, hlo_bytes=3.35e12,
                   coll_bytes=3 * 450e9, model_flops=256 * 989e12)
    assert (r.compute_s, r.memory_s, r.collective_s) == (2.0, 1.0, 3.0)
    assert r.bottleneck == "collective" and r.step_time_s == 3.0
    assert r.mfu == pytest.approx(1 / 3)
    assert r.useful_flops_frac == pytest.approx(0.5)
    assert set(r.to_dict()) >= {"compute_s", "memory_s", "collective_s", "mfu"}


def test_from_dryrun_json_reads_a_port_record(tmp_path):
    """A record without ``bytes_accessed`` (the port's) takes the memory
    term from the analytic ``hbm_bytes``."""
    rec = {"arch": "smollm_360m", "shape": "train_4k", "mesh": "single", "chips": 256,
           "flops": 1e12, "bytes_accessed": None, "collectives": {"total": 9e9},
           "model_flops": 2e14, "analytic": {"hbm_bytes": 6.7e9},
           "memory": {"argument_size_in_bytes": 123}}
    path = tmp_path / "r.json"
    path.write_text(json.dumps(rec))
    r = R.from_dryrun_json(str(path))
    assert (r.hlo_flops, r.hlo_bytes, r.coll_bytes, r.bytes_per_device) == \
        (1e12, 6.7e9, 9e9, 123)


_SCRIPT = r"""
import json
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.roofline.analysis import CellTrace, collective_bytes

dist.init_process_group("fake", rank=0, world_size=16, store=FakeStore())
mesh = init_device_mesh("cuda", (2, 8), mesh_dim_names=("data", "model"))


def piece(shape, pls, dtype, glob):
    t = torch.empty(shape, dtype=dtype, device="meta")
    return DTensor.from_local(t, mesh, pls, run_check=False, shape=glob,
                              stride=torch.empty(glob, device="meta").stride())


out = {}
cases = {
    # (1, 256) bf16 pieces over "data" -> (2, 256) whole
    "all-gather": (piece((1, 256), [Shard(0), Replicate()], torch.bfloat16, (2, 256)),
                   [Replicate(), Replicate()]),
    # a (1024,) f32 partial sum over "model" -> whole
    "all-reduce": (piece((1024,), [Replicate(), Partial()], torch.float32, (1024,)),
                   [Replicate(), Replicate()]),
    # a (1024,) f32 partial sum over "model" -> (128,) pieces
    "reduce-scatter": (piece((1024,), [Replicate(), Partial()], torch.float32, (1024,)),
                       [Replicate(), Shard(0)]),
    # (16, 64) f32 pieces of dim 0 over "model" -> (128, 8) pieces of dim 1
    "all-to-all": (piece((16, 64), [Replicate(), Shard(0)], torch.float32, (128, 64)),
                   [Replicate(), Shard(1)]),
}
for name, (t, dst) in cases.items():
    with CellTrace() as tr:
        t.redistribute(mesh, dst)
    out[name] = {"bytes": collective_bytes(tr.collectives), "counts": tr.counts(),
                 "records": [list(c) for c in tr.collectives]}
dist.destroy_process_group()
print(json.dumps(out))
"""


def test_collective_bytes_of_known_redistributions():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", _SCRIPT], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    want = {
        "all-gather": 2 * 256 * 2,  # the result's bytes
        "all-reduce": 2 * 1024 * 4,  # twice the result's
        "reduce-scatter": 128 * 4 * 8,  # the result's times the group (8)
        "all-to-all": 128 * 8 * 4,  # the result's
    }
    for kind, nbytes in want.items():
        rec = got[kind]
        assert rec["bytes"] == {kind: nbytes, "total": nbytes}, (kind, rec)
        assert rec["counts"][kind] == 1 and sum(rec["counts"].values()) == 1, (kind, rec)
    assert got["reduce-scatter"]["records"] == [["reduce-scatter", 512, 8]]


def test_collective_bytes_sums_records_by_the_ring_rules():
    recs = [R.Collective("all-gather", 100, 4), R.Collective("all-reduce", 10, 0),
            R.Collective("reduce-scatter", 8, 16), R.Collective("all-to-all", 7, 0),
            R.Collective("all-gather", 1, 4)]
    assert R.collective_bytes(recs) == {"all-gather": 101.0, "all-reduce": 20.0,
                                        "reduce-scatter": 128.0, "all-to-all": 7.0,
                                        "total": 256.0}
    assert R.collective_bytes([]) == {"total": 0}
