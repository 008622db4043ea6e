"""The port's logical-axis layout against the reference, on the CPU in one
process (a world of one gloo rank for the 1 x 1 device meshes):

* ``sharding/specs.py``: ``make_rules`` equals the reference's table for
  every combination of its seven keywords; ``spec_for`` equals the entries
  of the reference's ``PartitionSpec`` for every logical name (and raises on
  an unknown one); ``placements_for`` refuses two dims on one mesh axis;
  ``logical_shard`` is an identity outside ``activate`` and a rank mismatch
  raises inside it;
* ``models/model.py``: ``param_logical_axes`` and ``abstract_params``
  (shapes, dtypes, on ``meta``), and ``optim`` ``abstract_opt_state``, for
  every arch;
* ``launch/inputs.py``: ``params_shardings``, ``batch_specs`` and the
  decode caches' placements equal the reference's ``NamedSharding`` specs
  for every arch x shape of its ``run_shapes`` (the reference on a 1 x 1
  ``jax.make_mesh``, with the rules its dry run builds), on the
  ("data", "model") and the ("pod", "data", "model") mesh; ``kv_mode_for``
  equals the reference's.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro.configs.base import ARCH_IDS, SHAPES  # noqa: E402
from repro.configs.base import load_config as jload_config  # noqa: E402
from repro.launch import inputs as JI  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import optimizer as JO  # noqa: E402
from repro.sharding import specs as JS  # noqa: E402
from repro_torch.configs.base import load_config  # noqa: E402
from repro_torch.launch import inputs as TI  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import optimizer as TO  # noqa: E402
from repro_torch.sharding import specs as TS  # noqa: E402

KEYWORDS = {
    "multi_pod": (False, True),
    "moe_sharding": ("tp", "ep"),
    "shard_pages": (False, True),
    "fsdp": (True, False),
    "param_mode": ("fsdp", "tp2d"),
    "tp_feat": (True, False),
    "seq_parallel": (False, True),
}
COMBOS = [dict(zip(KEYWORDS, vals)) for vals in itertools.product(*KEYWORDS.values())]
CELLS = [(arch, shape) for arch in ARCH_IDS for shape in jload_config(arch).run_shapes]


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """1 x 1 and 1 x 1 x 1 device meshes over a world of one gloo rank, and
    the reference's meshes of the same axes on one CPU device."""
    store = tmp_path_factory.mktemp("store") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0, world_size=1)
    try:
        port = {2: make_mesh((1, 1), device_type="cpu"),
                3: make_mesh((1, 1, 1), device_type="cpu")}
        ref = {2: jax.make_mesh((1, 1), ("data", "model")),
               3: jax.make_mesh((1, 1, 1), ("pod", "data", "model"))}
        yield port, ref
    finally:
        dist.destroy_process_group()


def _placements_of(axis_names, pspec):
    """The placements a reference ``PartitionSpec`` gives on a mesh of
    ``axis_names``: ``Shard(i)`` on a mesh axis that dim i's entry holds."""
    out = []
    for axis in axis_names:
        dims = [i for i, e in enumerate(pspec)
                if e is not None and axis in ((e,) if isinstance(e, str) else e)]
        assert len(dims) <= 1
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items() if isinstance(tree, dict) else tree._asdict().items():
        p = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict) or (hasattr(v, "_fields") and not isinstance(v, TI.Spec)):
            out.update(_flat(v, p))
        else:
            out[p] = v
    return out


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


# -- sharding/specs.py -----------------------------------------------------


@pytest.mark.parametrize("kw", COMBOS, ids=lambda kw: "-".join(str(v) for v in kw.values()))
def test_make_rules_equals_reference(kw):
    assert TS.make_rules(**kw) == JS.make_rules(**kw)


@pytest.mark.parametrize("name", sorted(JS.make_rules()))
@pytest.mark.parametrize("multi_pod", [False, True])
def test_spec_for_equals_reference(name, multi_pod):
    jr, tr = JS.make_rules(multi_pod=multi_pod), TS.make_rules(multi_pod=multi_pod)
    names = (name, None, "act_batch")
    # a PartitionSpec writes a one-axis entry as the bare name
    want = tuple((e,) if isinstance(e, str) else e for e in JS.spec_for(jr, names))
    assert TS.spec_for(tr, names) == want


def test_spec_for_raises_on_an_unknown_name():
    with pytest.raises(KeyError, match="unknown logical axis"):
        TS.spec_for(TS.make_rules(), ("act_batch", "no_such_axis"))


def test_placements_refuse_two_dims_on_one_mesh_axis(meshes):
    port, _ = meshes
    rules = TS.make_rules()
    assert TS.placements_for(port[2], rules, ("act_batch", "act_feat")) == (Shard(0), Shard(1))
    with pytest.raises(ValueError, match="claimed by tensor dims"):
        TS.placements_for(port[2], rules, ("act_feat", "act_heads"))


def test_logical_shard_is_an_identity_outside_activate(meshes):
    port, _ = meshes
    x = torch.arange(6.0).reshape(2, 3)
    assert TS.logical_shard(x, "act_batch") is x  # no rank check outside activate
    assert TS.active_mesh_rules() is None
    with TS.activate(port[2], TS.make_rules()):
        assert TS.active_mesh_rules()[0] is port[2]
        assert TS.logical_shard(x, "act_batch", "act_feat") is x  # a plain tensor
        with pytest.raises(ValueError, match="2 names for rank-3"):
            TS.logical_shard(x[None], "act_batch", "act_feat")
    assert TS.active_mesh_rules() is None


# -- parameters and optimizer state ----------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_logical_axes_equal_reference(arch):
    assert TM.param_logical_axes(load_config(arch)) == JM.param_logical_axes(jload_config(arch))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_equal_reference(arch):
    mine = _flat(TM.abstract_params(load_config(arch)))
    want = _flat(JM.abstract_params(jload_config(arch)))
    assert sorted(mine) == sorted(want)
    for k, t in mine.items():
        assert t.device.type == "meta", k
        assert (tuple(t.shape), _dtype_name(t.dtype)) == (want[k].shape, str(want[k].dtype)), k


@pytest.mark.parametrize("arch", ["smollm_360m", "phi35_moe", "zamba2_7b"])
@pytest.mark.parametrize("master", [True, False])
def test_abstract_opt_state_equals_reference(arch, master):
    cfg, jcfg = load_config(arch), jload_config(arch)
    oc = TO.OptConfig(adam_dtype="bfloat16", master_weights=master)
    joc = JO.OptConfig(adam_dtype="bfloat16", master_weights=master)
    mine = TO.abstract_opt_state(TM.abstract_params(cfg), oc)
    want = JO.abstract_opt_state(JM.abstract_params(jcfg), joc)
    assert mine.step.device.type == "meta" and _dtype_name(mine.step.dtype) == "int32"
    for field in ("m", "v", "master"):
        a, b = getattr(mine, field), getattr(want, field)
        if b is None:
            assert a is None
            continue
        a, b = _flat(a), _flat(b)
        assert {k: (tuple(t.shape), _dtype_name(t.dtype)) for k, t in a.items()} == \
            {k: (t.shape, str(t.dtype)) for k, t in b.items()}


# -- launch/inputs.py ------------------------------------------------------


def _rules(cfg, shape, multi):
    """The rules the reference's dry run builds for a cell."""
    return dict(multi_pod=multi, moe_sharding=cfg.moe_sharding,
                shard_pages=shape.global_batch == 1,
                param_mode=cfg.decode_param_mode if shape.kind == "decode" else "fsdp",
                tp_feat=cfg.tp_feat, seq_parallel=cfg.seq_parallel)


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_input_placements_equal_reference(meshes, arch, shape_name, multi):
    port, ref = meshes
    nd = 3 if multi else 2
    tmesh, jmesh = port[nd], ref[nd]
    jcfg, cfg = jload_config(arch), load_config(arch)
    shape = SHAPES[shape_name]
    kw = _rules(jcfg, shape, multi)
    jr, tr = JS.make_rules(**kw), TS.make_rules(**kw)
    names = jmesh.axis_names
    assert TI.kv_mode_for(cfg, shape) == JI.kv_mode_for(jcfg, shape)

    want = _flat(JI.params_shardings(jcfg, jmesh, jr))
    got = _flat(TI.params_shardings(cfg, tmesh, tr))
    assert got == {k: _placements_of(names, s.spec) for k, s in want.items()}

    if shape.kind in ("train", "prefill"):
        want = JI.batch_specs(jcfg, shape, jmesh, jr)
        got = TI.batch_specs(cfg, shape, tmesh, tr)
        assert sorted(got) == sorted(want)
        for k, spec in got.items():
            assert spec.shape == want[k].shape, k
            assert _dtype_name(spec.dtype) == str(want[k].dtype), k
            assert spec.placements == _placements_of(names, want[k].sharding.spec), k
        return
    jtok, jcaches, jmode = JI.decode_specs(jcfg, shape, jmesh, jr)
    ttok, tcaches, tmode = TI.decode_specs(cfg, shape, tmesh, tr)
    assert tmode == jmode
    assert (ttok.shape, _dtype_name(ttok.dtype)) == (jtok.shape, str(jtok.dtype))
    assert ttok.placements == _placements_of(names, jtok.sharding.spec)
    jflat = {k.replace("blocks/", ""): v for k, v in _jax_flat(jcaches).items()}
    tflat = {k.replace("blocks/", ""): v for k, v in _flat(tcaches).items()}
    assert sorted(tflat) == sorted(jflat)
    for k, spec in tflat.items():
        assert spec.shape == jflat[k].shape, k
        assert _dtype_name(spec.dtype) == str(jflat[k].dtype), k
        assert spec.placements == _placements_of(names, jflat[k].sharding.spec), k
        assert spec.meta().device.type == "meta"


def _jax_flat(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [str(getattr(p, "name", getattr(p, "key", getattr(p, "idx", p)))) for p in path]
        out["/".join(keys)] = leaf
    return out


def test_concrete_batch_follows_batch_specs(meshes):
    port, _ = meshes
    for arch in ("smollm_360m", "whisper_large_v3", "internvl2_26b"):
        cfg = load_config(arch)
        shape = SHAPES["train_4k"]
        specs = TI.batch_specs(cfg, shape, port[2], TS.make_rules())
        small = TI.concrete_batch(cfg, 2, 64, torch.Generator().manual_seed(0), device="cpu")
        assert sorted(small) == sorted(specs)
        for k, t in small.items():
            assert t.dtype == specs[k].dtype and t.shape[2:] == specs[k].shape[2:], k
        assert int(small["tokens"].max()) < cfg.vocab and int(small["tokens"].min()) >= 0
    assert np.isfinite(small["patches"].float().numpy()).all()


def test_place_keeps_each_leaf_and_its_placements(meshes):
    port, _ = meshes
    cfg = load_config("smollm_360m")
    rules = TS.make_rules()
    params = {"embed": torch.randn(8, 4), "u0": {"ln1": torch.randn(2, 4)}}
    shardings = {"embed": TS.placements_for(port[2], rules, ("p_vocab", "p_embed")),
                 "u0": {"ln1": TS.placements_for(port[2], rules, ("layers", "p_noshard"))}}
    placed = TI.place(params, port[2], shardings)
    assert tuple(placed["embed"].placements) == (Shard(1), Shard(0))
    assert torch.equal(placed["embed"].full_tensor(), params["embed"])
    assert torch.equal(placed["u0"]["ln1"].to_local(), params["u0"]["ln1"])
    assert cfg.moe_sharding == "tp"
