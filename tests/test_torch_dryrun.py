"""The port's dry run (``repro_torch/launch/dryrun.py``) on the CPU: every
family's cells on ``meta`` tensors over a fake world, held to the reference
where the reference has a number for them.

* ``run_cell`` is ``ok`` at a fake (4, 2) world for the SMOKE config of
  each family (dense qwen2.5, moe phi3.5, ssm mamba2, hybrid zamba2, encdec
  whisper, vlm internvl2), for train, prefill and decode shapes sized for
  the test and a batch-1 ``long_500k`` decode (the paged pool, its pages
  over "data"); each record's ``analytic`` equals the reference's
  ``cell_costs`` at ``MeshInfo(4, 2)``, its ``argument_size_in_bytes`` the
  bytes of the rank-0 pieces the reference's ``NamedSharding`` specs give
  (reckoned from shapes, as ``tests/test_torch_specs.py`` does: no JAX
  compile), its ``n_micro`` the reference's ``effective_microbatches``; no
  launch is counted and every collective is one a "cuda" mesh issues;
* one full-width cell through the CLI, smollm-360m ``train_4k`` on the
  single-pod mesh (256 fake ranks): ``ok``, its JSON written, its
  ``n_micro`` the reference's, its gradient reduction counted as
  all-to-alls and its gathers on use as all-gathers, its peak a rank under
  80 GB;
* ``--set attention_impl=...`` and an unknown field are refused by name;
* the ``meta`` route of kernel 6 and its backward (``kernels/ops.py``):
  the plain versions' shapes and dtypes, no launch, the FLOPs of the pairs
  the masks leave (``ref.flash_pairs`` against ``_flash_mask``);
* the port's attention under ``attention_schedule="balanced"`` (kernel 6,
  as "rect") against the reference's balanced schedule at S = 1024, within
  the f32 flash tolerance.

The fake worlds run in subprocesses with timeouts (no pytest worker keeps a
default process group), started together.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ShapeSpec as JShapeSpec  # noqa: E402
from repro.configs.base import load_config as jload  # noqa: E402
from repro.configs.base import load_smoke_config as jload_smoke  # noqa: E402
from repro.launch import inputs as JI  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import optimizer as JO  # noqa: E402
from repro.roofline.analytic import MeshInfo as JMeshInfo  # noqa: E402
from repro.roofline.analytic import cell_costs as jcell_costs  # noqa: E402
from repro.sharding import specs as JS  # noqa: E402
from repro.train.train_step import effective_microbatches as jeffective  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ("qwen25_14b", "phi35_moe", "mamba2_370m", "zamba2_7b", "whisper_large_v3",
            "internvl2_26b")
#: the test's shapes: (seq_len, global_batch, kind), under the grid's names
SHAPES = {"train_4k": (64, 8, "train"), "prefill_32k": (64, 8, "prefill"),
          "decode_32k": (64, 8, "decode"), "long_500k": (512, 1, "decode")}
MESH = (4, 2)
CELLS = [(a, s) for a in FAMILIES for s in SHAPES]
F32_FLASH_TOL = 1e-4

_GRID = r"""
import sys
from repro_torch.configs.base import ShapeSpec, load_smoke_config
from repro_torch.launch.dryrun import run_cell

out, shapes, cells = sys.argv[1], eval(sys.argv[2]), eval(sys.argv[3])
for arch, name in cells:
    run_cell(arch, name, "single", out, cfg=load_smoke_config(arch),
             shape=ShapeSpec(name, *shapes[name]), mesh_shape=%r)
""" % (MESH,)


def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """The smoke grid (two processes) and the full-width CLI cell, run
    together; {(arch, shape): record}, and the CLI's (returncode, record)."""
    out = tmp_path_factory.mktemp("dryrun")
    halves = (CELLS[: len(CELLS) // 2], CELLS[len(CELLS) // 2:])
    procs = [subprocess.Popen([sys.executable, "-c", _GRID, str(out / "grid"), repr(SHAPES),
                               repr(cells)], env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for cells in halves]
    cli = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                            "smollm_360m", "--shape", "train_4k", "--mesh", "single",
                            "--out", str(out / "cli")], env=_env(), cwd=ROOT,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        for p in procs:
            _, err = p.communicate(timeout=150)
            assert p.returncode == 0, err[-3000:]
        cli_out, cli_err = cli.communicate(timeout=150)
    finally:
        for p in procs + [cli]:
            p.kill()
    grid = {}
    for arch, name in CELLS:
        with open(out / "grid" / f"{arch}__{name}__single.json") as f:
            grid[(arch, name)] = json.load(f)
    path = out / "cli" / "smollm_360m__train_4k__single.json"
    cli_rec = json.loads(path.read_text()) if path.exists() else None
    return grid, (cli.returncode, cli_out, cli_err, cli_rec)


# -- the reference's per-rank argument bytes, from its specs ----------------


def _piece_bytes(shape, dtype, spec, axes):
    """Bytes of rank 0's piece of a ``shape`` tensor placed by ``spec`` (a
    PartitionSpec) over mesh ``axes`` ((name, size), mesh order): each
    sharded dim cut into ``ceil(L / n)`` pieces per mesh axis, in order."""
    dims = list(shape)
    for name, n in axes:
        for i, entry in enumerate(tuple(spec) + (None,) * (len(dims) - len(spec))):
            names = (entry,) if isinstance(entry, str) else (entry or ())
            if name in names:
                dims[i] = -(-dims[i] // n)
    return math.prod(dims) * np.dtype(dtype).itemsize


def _tree_bytes(tree, axes):
    total = 0
    for leaf in jax.tree_util.tree_leaves(tree):
        total += _piece_bytes(leaf.shape, leaf.dtype, leaf.sharding.spec, axes)
    return total


def reference_argument_bytes(arch, shape_name):
    """The reference's dry-run arguments for the cell (its ``build_cell``'s
    ShapeDtypeStructs with their NamedShardings, on a 1 x 1 mesh for the
    specs), as rank 0's bytes on the test's (4, 2) mesh."""
    jcfg = jload_smoke(arch)
    shape = JShapeSpec(shape_name, *SHAPES[shape_name])
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    axes = tuple(zip(("data", "model"), MESH))
    rules = JS.make_rules(
        moe_sharding=jcfg.moe_sharding, shard_pages=shape.global_batch == 1,
        param_mode=jcfg.decode_param_mode if shape.kind == "decode" else "fsdp",
        tp_feat=jcfg.tp_feat, seq_parallel=jcfg.seq_parallel)
    psh = JI.params_shardings(jcfg, jmesh, rules)
    params = jax.tree.map(lambda s, sh: jax.ShapeDtypeStruct(s.shape, s.dtype, sharding=sh),
                          JM.abstract_params(jcfg), psh)
    total = _tree_bytes(params, axes)
    if shape.kind == "train":
        oc = JO.OptConfig(adam_dtype=jcfg.adam_dtype, master_weights=jcfg.opt_master)
        opt = JO.abstract_opt_state(JM.abstract_params(jcfg), oc)
        for field in opt[1:]:  # m, v, master
            if field:
                total += _tree_bytes(jax.tree.map(
                    lambda s, sh: jax.ShapeDtypeStruct(s.shape, s.dtype, sharding=sh),
                    field, psh), axes)
        total += 4  # the replicated int32 step counter
    if shape.kind in ("train", "prefill"):
        total += _tree_bytes(JI.batch_specs(jcfg, shape, jmesh, rules), axes)
        return total
    token, caches, _ = JI.decode_specs(jcfg, shape, jmesh, rules)
    return total + _tree_bytes((token, caches), axes)


# -- the smoke grid --------------------------------------------------------


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_smoke_cell_is_ok_and_equals_the_reference(records, arch, shape_name):
    grid, _ = records
    rec = grid[(arch, shape_name)]
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["chips"] == 8 and rec["mesh_shape"] == list(MESH)
    assert rec["mesh_device_type"] == "cuda"
    shape = JShapeSpec(shape_name, *SHAPES[shape_name])
    jcfg = jload_smoke(arch)
    assert rec["analytic"] == jcell_costs(jcfg, shape, mesh=JMeshInfo(*MESH))
    assert rec["memory"]["argument_size_in_bytes"] == reference_argument_bytes(arch, shape_name)
    assert rec["n_params"] == jcfg.n_params()
    assert rec["n_active_params"] == jcfg.n_active_params()
    assert rec["launches"] == 0
    assert rec["flops"] > 0 and rec["collectives"]["total"] > 0
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_size_in_bytes"]
    assert rec["bytes_accessed"] is None and "bytes_accessed" in rec["null_fields"]
    counted = sum(rec["collective_ops"].values())
    assert counted > 0 and rec["collective_ops"]["broadcast"] == 0
    if shape.kind == "train":
        assert rec["n_micro"] == jeffective(jcfg, shape.global_batch, MESH[0])
    if shape.kind != "decode" and jcfg.family != "ssm":
        assert rec["flops_parts"]["kernels"] > 0  # kernel 6 through its meta route
    if shape.kind == "decode":
        assert rec["kv_mode"] == JI.kv_mode_for(jcfg, shape)


def test_the_grid_covers_a_paged_decode(records):
    grid, _ = records
    assert {rec["kv_mode"] for (a, s), rec in grid.items() if s == "long_500k"} >= {"paged"}


# -- the full-width cell through the CLI -----------------------------------


def test_full_width_cell_through_the_cli(records):
    _, (rc, out, err, rec) = records
    assert rc == 0, err[-3000:]
    assert "dry-run: 1 ok, 0 failed" in out
    assert rec["status"] == "ok" and rec["chips"] == 256 and rec["mesh"] == "single"
    jcfg = jload("smollm_360m")
    assert rec["n_micro"] == jeffective(jcfg, 256, 16)
    assert rec["analytic"] == jcell_costs(jcfg, JShapeSpec("train_4k", 4096, 256, "train"))
    # the gradients' fixed-order reduction: all-to-alls on a "cuda" mesh
    assert rec["collective_ops"]["all-to-all"] > 0
    assert rec["collectives"]["all-to-all"] > 0
    # the weights gathered on use: all-gathers
    assert rec["collective_ops"]["all-gather"] > 0
    assert rec["collectives"]["all-gather"] > 0
    assert rec["launches"] == 0 and rec["flops_parts"]["kernels"] > 0
    # a rank's peak fits an 80 GB card
    assert rec["memory"]["peak_bytes"] < 80e9


def test_set_refuses_a_field_the_port_lacks_and_an_unknown_one(capsys):
    from repro_torch.launch import dryrun as D

    with pytest.raises(ValueError, match="attention_impl"):
        D.parse_overrides(["attention_impl=pallas_flash"])
    with pytest.raises(ValueError, match="no_such_field"):
        D.parse_overrides(["no_such_field=1"])
    assert D.parse_overrides(["attention_schedule=balanced", "tp_feat=false",
                              "microbatches=4"]) == {
        "attention_schedule": "balanced", "tp_feat": False, "microbatches": 4}
    for bad in ("attention_impl=xla", "no_such_field=1"):
        with pytest.raises(SystemExit) as e:
            D.main(["--arch", "smollm_360m", "--set", bad])
        assert e.value.code == 2
        assert bad.split("=")[0] in capsys.readouterr().err


# -- kernel 6's meta route ---------------------------------------------------


@pytest.mark.parametrize("Sq,Skv,causal,window,kv_len", [
    (64, 64, True, 0, None), (64, 64, True, 16, None), (40, 64, False, 0, 50),
    (64, 40, True, 0, None), (33, 33, False, 7, None), (64, 64, True, 0, 20)])
def test_flash_pairs_count_the_mask(Sq, Skv, causal, window, kv_len):
    from repro_torch.kernels import ref

    mask = ref._flash_mask(Sq, Skv, causal, window, Skv if kv_len is None else kv_len, "cpu")
    assert ref.flash_pairs(Sq, Skv, causal, window, kv_len) == \
        int(mask.expand(Sq, Skv).sum())  # a non-causal mask broadcasts its rows


@pytest.mark.parametrize("causal,window,kv_len", [(True, 0, None), (True, 8, None),
                                                  (False, 0, 20)])
def test_meta_route_of_kernel_6_gives_the_plain_shapes_and_no_launch(causal, window, kv_len):
    from repro_torch.kernels import ops, ref

    B, Sq, Skv, KVH, G, hd = 2, 32, 24 if not causal else 32, 2, 3, 32
    shapes = ((B, Sq, KVH, G, hd), (B, Skv, KVH, hd), (B, Skv, KVH, hd))
    pairs = ref.flash_pairs(Sq, Skv, causal, window, kv_len)
    for dtype in (torch.float32, torch.bfloat16):
        cpu = [torch.randn(s).to(dtype).requires_grad_(True) for s in shapes]
        meta = [torch.empty(s, dtype=dtype, device="meta").requires_grad_(True)
                for s in shapes]
        kw = dict(causal=causal, window=window, kv_len=kv_len)
        launches, flops = dict(ops.LAUNCHES), dict(ops.META_FLOPS)
        want = ops.flash_attention(*cpu, **kw)
        got = ops.flash_attention(*meta, **kw)
        assert (got.shape, got.dtype, got.device.type) == (want.shape, want.dtype, "meta")
        assert ops.META_FLOPS["flash_attention"] - flops["flash_attention"] == \
            4 * hd * B * KVH * G * pairs
        gw = torch.autograd.grad(want.float().sum(), cpu)
        gg = torch.autograd.grad(got.float().sum(), meta)
        for a, b in zip(gg, gw):
            assert (a.shape, a.dtype, a.device.type) == (b.shape, b.dtype, "meta")
        assert ops.META_FLOPS["flash_attention_bwd"] - flops["flash_attention_bwd"] == \
            10 * hd * B * KVH * G * pairs
        assert ops.LAUNCHES == launches  # CPU: plain; meta: shapes only
        # the forward alone, with and without the log-sum-exp
        out, lse = ref.flash_attention_meta(*meta, return_lse=True, **kw)[0]
        pout, plse = ref.flash_attention_plain(*(t.detach() for t in cpu), return_lse=True,
                                               **kw)
        assert (out.shape, out.dtype, lse.shape, lse.dtype) == \
            (pout.shape, pout.dtype, plse.shape, plse.dtype)


# -- attention_schedule="balanced" -------------------------------------------


def test_balanced_schedule_matches_the_reference_balanced_path():
    """The reference's ``flash_attention_balanced`` pairs query chunks to
    skip the masked half; the port's kernel 6 skips every tile above the
    diagonal already, so "balanced" runs it as "rect" does.  Held to the
    reference's balanced path (S = 1024 >= 2 x its 512 chunk) within the
    f32 flash tolerance."""
    from repro_torch.configs.base import load_smoke_config
    from repro_torch.models import layers as TL

    S, B = 1024, 1
    cfg = dataclasses.replace(load_smoke_config("qwen25_14b"), dtype="float32",
                              param_dtype="float32", attention_schedule="balanced")
    jcfg = dataclasses.replace(jload_smoke("qwen25_14b"), dtype="float32",
                               param_dtype="float32", attention_schedule="balanced")
    rng = np.random.default_rng(11)
    d, qk, kv = cfg.d_model, cfg.qk_dim, cfg.kv_dim
    p = {n: (rng.standard_normal(s) * 0.05).astype(np.float32)
         for n, s in (("wq", (d, qk)), ("wk", (d, kv)), ("wv", (d, kv)), ("wo", (qk, d)),
                      ("bq", (qk,)), ("bk", (kv,)), ("bv", (kv,)))}
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    want, (wk, _) = JL.attention({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                                 jcfg, positions=jnp.arange(S, dtype=jnp.int32))
    got, (gk, _) = TL.attention({k: torch.from_numpy(v) for k, v in p.items()},
                                torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_FLASH_TOL,
                               atol=F32_FLASH_TOL)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), rtol=F32_FLASH_TOL,
                               atol=F32_FLASH_TOL)
