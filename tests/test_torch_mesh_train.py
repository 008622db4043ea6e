"""The placed train step on ``torch.distributed`` worlds of 2 gloo ranks on
the CPU: meshes (2, 1) and (1, 2) over ("data", "model").

One world runs every case (``_world_cases``, rendezvous through a file
store) and writes what it measured; the tests compare it:

* **against the port's unsharded step** (run in the world's rank 0, the
  same thread count): at (2, 1) two placed steps are bit for bit the
  unsharded step over ``n_micro * 2`` chunks, chunk ``m * 2 + s`` holding
  shard s's rows of micro step m (parameters, master, m, v and losses);
  at (1, 2) "model" splits contractions: the losses within 1e-6 relative,
  the gradient norms within 1e-5, the parameters and master weights within
  1e-5 relative L2 on every leaf that starts nonzero, at the launcher's
  learning rate.  Looser, each for its reason (CHANGES.md): m and v within
  ``MV_REL`` (they carry the raw gradients, whose smallest leaves, a Mamba
  block's 8 per-head scalars, sum with cancellation); the leaves that start
  at zero (norm scales, biases) within ``ZERO_INIT_REL``, since they are
  Adam's normalised updates alone, where a gradient element near Adam's eps
  takes the split's rounding at full scale;
* **against the reference**: the losses within 1e-5 relative and the
  gradient norms within 1e-4 of ``repro.train.train_step.make_train_step``
  (unsharded, jitted: the function GSPMD partitions) from the same
  parameters (``convert.params_from_jax`` feeds both sides) and batches, as
  ``tests/test_torch_train.py`` holds the unsharded step; and every leaf of
  the final parameters, m, v and master within ``JAX_*_TOL`` of max |want|;
* **placed init**: ``init_params`` drawn placed equals ``place`` of the
  unplaced draw;
* **memory**: each rank's local shard of every parameter and optimizer
  leaf has the shape its placements give;
* **resume**: a placed resilient run with a failure injected resumes bit
  for bit, its checkpoints restore unsharded, and an unsharded checkpoint
  restores placed;
* ``cfg.grad_compress`` at (2, 1): bit for bit the unsharded step's;
* ``compressed_allreduce_int8`` at 2 ranks: int8 on the wire, the payloads
  and scales bit for bit the reference's ``quantize_int8`` per rank, the
  sum bit for bit the reference's formula.

Configs: qwen2.5-14b, zamba2-7b and phi3.5-moe (the reference's own
distribution cells) and smollm-360m (uneven heads: 1 kv head at its smoke
config) at their SMOKE configs in f32; whisper-large-v3 (frames, the
cross-attention) and internvl2-26b (patches) against both steps too.  The ``cuda`` case runs the placed
step in a world of one NCCL rank on the card against the plain step, bit
for bit, with equal kernel launches; it imports no JAX.
"""

import dataclasses
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

ARCHS = ("qwen25_14b", "zamba2_7b", "phi35_moe", "smollm_360m")
#: the families whose batches carry a stub frontend's input, in this world only
STUB_ARCHS = ("whisper_large_v3", "internvl2_26b")
MESHES = ((2, 1), (1, 2))
B, S, N_MICRO, STEPS = 8, 32, 2, 2
LR = 3e-4  # the launcher's default learning rate
ZERO_INIT_REL = 2e-3
TP_REL = 1e-5
MV_REL = 1e-4
#: the final state against the reference's, per leaf: max |got - want| over
#: max |want| (``tests/test_torch_train.py``'s OPT_TOL form).  OPT_TOL itself
#: (1e-6) holds one update from the same gradients; here two whole steps of
#: two frameworks differ in the gradients' rounding, which Adam's first
#: updates g / (|g| + eps) turn into a share of the step where |g| is near
#: eps.  Measured worst over both meshes and all six configs (CPU, f32):
#: parameters and master 3.27e-4 (zamba2 u0/w_in), zero-initialised leaves
#: 3.70e-3 (internvl2 u0/ln1), m 7.39e-5 (zamba2 embed), v 6.68e-5
#: (internvl2 u0/wo).  A wrong gradient on any leaf, however small, moves
#: its m by the whole of it.
JAX_PARAM_TOL = 1e-3
JAX_ZERO_INIT_TOL = 1e-2
JAX_MV_TOL = 2e-4


def _cfg(arch, **kw):
    from repro_torch.configs.base import load_smoke_config

    return dataclasses.replace(load_smoke_config(arch), dtype="float32",
                               param_dtype="float32", microbatches=N_MICRO, **kw)


def _opt():
    from repro_torch.optim import optimizer as O

    return O.OptConfig(lr=LR, warmup_steps=1, total_steps=10)


def _batches(arch, seed=3):
    """Two global batches (numpy): tokens and labels in the vocabulary, and
    the family's stub input (whisper's frames, internvl2's patches) N(0, 1)
    * 0.02 in f32."""
    cfg = _cfg(arch)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        b = {k: rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
             for k in ("tokens", "labels")}
        stub = {"encdec": ("frames", S // cfg.enc_seq_divisor),
                "vlm": ("patches", cfg.n_patch_tokens)}.get(cfg.family)
        if stub:
            b[stub[0]] = (rng.standard_normal((B, stub[1], cfg.d_model))
                          * 0.02).astype(np.float32)
        out.append(b)
    return out


def chunk_order(n_shards: int, n_micro: int, rows: int) -> np.ndarray:
    """Row order of the global batch that makes the unsharded step's chunk
    ``m * n_shards + s`` shard s's rows of micro step m."""
    per_shard, per_chunk = rows // n_shards, rows // (n_shards * n_micro)
    return np.concatenate([np.arange(s * per_shard + m * per_chunk,
                                     s * per_shard + (m + 1) * per_chunk)
                           for m in range(n_micro) for s in range(n_shards)])


def _full(t):
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def _flat(tree, prefix=""):
    out = {}
    items = tree.items() if isinstance(tree, dict) else tree._asdict().items()
    for k, v in items:
        p = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict) or hasattr(v, "_fields"):
            out.update(_flat(v, p))
        elif v is not None:
            out[p] = v
    return out


def _state(params, opt_state):
    """{path: full tensor} of the parameters and the optimizer state."""
    flat = {f"params/{k}": _full(v) for k, v in _flat(params).items()}
    flat.update({f"opt/{k}": _full(v) for k, v in _flat(opt_state).items()})
    return {k: v.detach().clone() for k, v in flat.items()}


def _local_shapes(params, opt_state):
    from torch.distributed.tensor import DTensor

    tree = {**{f"params/{k}": v for k, v in _flat(params).items()},
            **{f"opt/{k}": v for k, v in _flat(opt_state).items()}}
    return {k: (tuple(v.shape), tuple(v.to_local().shape), tuple(map(str, v.placements)))
            for k, v in tree.items() if isinstance(v, DTensor)}


def _device(mesh):
    return torch.device("cpu") if mesh.device_type == "cpu" else torch.device(
        "cuda", torch.cuda.current_device())


def run_placed(arch, mesh, np_params, batches, **cfg_kw):
    """Two placed steps on ``mesh`` from ``params_from_jax`` of the
    reference's parameters; returns their record."""
    from repro_torch.launch.inputs import params_shardings, place
    from repro_torch.models.convert import params_from_jax
    from repro_torch.optim import optimizer as O
    from repro_torch.sharding.specs import make_rules
    from repro_torch.train.train_step import make_train_step

    cfg, oc, dev = _cfg(arch, **cfg_kw), _opt(), _device(mesh)
    rules = make_rules(multi_pod="pod" in mesh.mesh_dim_names, moe_sharding=cfg.moe_sharding)
    full = params_from_jax(np_params, cfg, dev, torch.float32)
    params = place(full, mesh, params_shardings(cfg, mesh, rules))
    opt_state = O.init_opt_state(params, oc)
    step = make_train_step(cfg, oc, N_MICRO, mesh=mesh, rules=rules)
    rec = {"loss": [], "grad_norm": []}
    for b in batches:
        params, opt_state, m = step(params, opt_state,
                                    {k: torch.from_numpy(v).to(dev) for k, v in b.items()})
        rec["loss"].append(m["loss"].item())
        rec["grad_norm"].append(m["grad_norm"].item())
    rec["state"] = _state(params, opt_state)
    rec["local"] = _local_shapes(params, opt_state)
    rec["coord"] = tuple(mesh.get_coordinate())
    return rec


def run_plain(arch, np_params, batches, shards, dev, **cfg_kw):
    """Two unsharded steps over ``N_MICRO * shards`` chunks, chunk ``m *
    shards + s`` holding shard s's rows of micro step m."""
    from repro_torch.models.convert import params_from_jax
    from repro_torch.optim import optimizer as O
    from repro_torch.train.train_step import make_train_step

    cfg, oc = _cfg(arch, **cfg_kw), _opt()
    order = torch.from_numpy(chunk_order(shards, N_MICRO, B))
    p = params_from_jax(np_params, cfg, dev, torch.float32)
    o = O.init_opt_state(p, oc)
    step = make_train_step(cfg, oc, N_MICRO * shards)
    rec = {"loss": [], "grad_norm": []}
    for b in batches:
        p, o, m = step(p, o, {k: torch.from_numpy(v).to(dev)[order] for k, v in b.items()})
        rec["loss"].append(m["loss"].item())
        rec["grad_norm"].append(m["grad_norm"].item())
    rec["state"] = _state(p, o)
    return rec


def init_case(arch, mesh):
    """Keys of the leaves where ``init_params`` drawn placed (each rank
    keeping its pieces) differs from ``place`` of the unplaced draw, and the
    placed leaves' count."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.inputs import params_shardings, place
    from repro_torch.models import model as M
    from repro_torch.sharding.specs import make_rules

    cfg = _cfg(arch)
    sh = params_shardings(cfg, mesh, make_rules(multi_pod="pod" in mesh.mesh_dim_names,
                                                moe_sharding=cfg.moe_sharding))
    want = place(M.init_params(cfg, torch.Generator().manual_seed(4), device="cpu"), mesh, sh)
    got = M.init_params(cfg, torch.Generator().manual_seed(4), device="cpu", mesh=mesh,
                        shardings=sh)
    want, got = _flat(want), _flat(got)
    assert want.keys() == got.keys()
    differ = [k for k, v in got.items()
              if not (isinstance(v, DTensor) and v.placements == want[k].placements
                      and torch.equal(v.to_local(), want[k].to_local()))]
    return {"differ": differ, "leaves": len(got)}


def _tiny():
    from repro_torch.configs.base import load_config
    from repro_torch.launch import train as TL
    from repro_torch.optim import optimizer as O

    cfg = dataclasses.replace(TL.tiny_config(load_config("smollm_360m")), n_layers=2,
                              d_model=128, d_ff=512, vocab=256, microbatches=2)
    return cfg, O.OptConfig(lr=1e-2, warmup_steps=2, total_steps=6)


def write_plain_checkpoint(directory):
    """An unsharded checkpoint (seed 5) for the world to restore placed."""
    from repro_torch.models import model as M
    from repro_torch.optim import optimizer as O
    from repro_torch.train import checkpoint as C

    cfg, oc = _tiny()
    p = M.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    C.save(directory, 0, p, O.init_opt_state(p, oc))
    return p


def _resume_case(mesh, out_dir):
    """An uninterrupted placed resilient run and one with a failure at step
    3 (restored from the step-2 checkpoint), and the unsharded checkpoint
    ``write_plain_checkpoint`` wrote, restored placed."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train as TL
    from repro_torch.launch.inputs import params_shardings, place
    from repro_torch.models import model as M
    from repro_torch.optim import optimizer as O
    from repro_torch.sharding.specs import make_rules
    from repro_torch.train import checkpoint as C
    from repro_torch.train import fault_tolerance as FT
    from repro_torch.train.train_step import make_train_step

    cfg, oc = _tiny()
    rules = make_rules()
    shardings = params_shardings(cfg, mesh, rules)
    step = make_train_step(cfg, oc, 2, mesh=mesh, rules=rules)
    last = {}

    def init_fn():
        p = place(M.init_params(cfg, torch.Generator().manual_seed(2), device="cpu"), mesh,
                  shardings)
        return p, O.init_opt_state(p, oc)

    def step_fn(p, o, b):
        last["params"], o, m = step(p, o, TL.batch_to(b, "cpu"))
        return last["params"], o, m

    tag = "x".join(map(str, mesh.shape))
    runs = {}
    for name, fail in (("straight", None), ("resumed", [3])):
        d = os.path.join(out_dir, f"ckpt_{tag}_{name}")
        r = FT.run_resilient(ckpt_dir=d, total_steps=6, init_fn=init_fn, step_fn=step_fn,
                             data_iter=SyntheticLM(cfg.vocab, 8, 32, seed=9), ckpt_every=2,
                             injector=FT.FailureInjector(fail_at=fail))
        runs[name] = {"restarts": r.restarts, "loss": r.final_metrics["loss"],
                      "params": {k: _full(v).clone() for k, v in _flat(last["params"]).items()},
                      "dir": d}
    tp, to = init_fn()
    rp, _, _, _ = C.restore(os.path.join(out_dir, "plain_ckpt"), 0, tp, to)
    runs["plain_restored"] = {k: (type(v).__name__, _full(v).clone())
                              for k, v in _flat(rp).items()}
    return runs


def _int8_case(rank, world):
    """``compressed_allreduce_int8`` on a seeded (64, 33) tensor per rank,
    recording the dtypes that went over the wire."""
    from repro_torch.optim import grad_compress as GC

    x = torch.from_numpy(np.random.default_rng(40 + rank).standard_normal((64, 33))
                         .astype(np.float32) * (rank + 1))
    wire = []
    real = dist.all_gather

    def spy(tensors, t, group=None):
        wire.append(t.dtype)
        return real(tensors, t, group=group)

    dist.all_gather = spy
    try:
        out = GC.compressed_allreduce_int8(x)
    finally:
        dist.all_gather = real
    q, s = GC.quantize_int8(x)
    return {"x": x, "q": q, "s": s, "out": out, "wire": wire}


def _world_cases(rank, world, store, out_dir, jobs):
    """Every case of one world; each rank writes ``rank<r>.pt``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    from repro_torch.launch.mesh import batch_shards, make_mesh

    results = {}
    try:
        for shape in jobs["meshes"]:
            mesh = make_mesh(shape, device_type="cpu")
            for arch in jobs["archs"]:
                rec = run_placed(arch, mesh, jobs["params"][arch], jobs["batches"][arch])
                rec["init"] = init_case(arch, mesh)
                if rank == 0:  # the same thread count as the shards
                    rec["plain"] = run_plain(arch, jobs["params"][arch],
                                             jobs["batches"][arch], batch_shards(mesh),
                                             torch.device("cpu"))
                results[(arch, shape)] = rec
            if shape in jobs["resume"]:
                results[("resume", shape)] = _resume_case(mesh, out_dir)
            if shape == (2, 1) and "qwen25_14b" in jobs["archs"]:
                # cfg.grad_compress: each placed gradient quantized by its global max
                rec = run_placed("qwen25_14b", mesh, jobs["params"]["qwen25_14b"],
                                 jobs["batches"]["qwen25_14b"], grad_compress=True)
                if rank == 0:
                    rec["plain"] = run_plain("qwen25_14b", jobs["params"]["qwen25_14b"],
                                             jobs["batches"]["qwen25_14b"], 2,
                                             torch.device("cpu"), grad_compress=True)
                results[("grad_compress", shape)] = rec
        results["int8"] = _int8_case(rank, world)
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_world(world, out_dir, jobs):
    """Start the world (without waiting); join with ``ctx.join()``."""
    store = os.path.join(out_dir, "store")
    return mp.spawn(_world_cases, args=(world, store, str(out_dir), jobs), nprocs=world,
                    join=False)


def reference_params(arch, seed=0):
    """Parameters in the reference's layout (numpy, f32), drawn from the
    reference's declarations as its ``init_params`` draws them (normal *
    min(scale, 1/sqrt(fan_in)), norm scales and biases zero, the Mamba-2
    leaves' own rules), from a numpy generator; ``params_from_jax`` carries
    them to the port, ``jax.numpy`` to the reference."""
    from repro.configs.base import load_smoke_config as jload
    from repro.models import model as JM

    rng = np.random.default_rng(seed)

    def draw(decl):
        shape = decl.shape
        if decl.init in ("zeros", "ones"):
            return (np.zeros if decl.init == "zeros" else np.ones)(shape, np.float32)
        if decl.init == "a_log":
            return np.broadcast_to(np.log(np.linspace(1.0, 16.0, shape[-1])),
                                   shape).astype(np.float32)
        if decl.init == "dt_bias":
            dt = np.exp(rng.uniform(size=shape) * (math.log(0.1) - math.log(1e-3))
                        + math.log(1e-3))
            return (dt + np.log(-np.expm1(-dt))).astype(np.float32)
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        scale = min(decl.scale, 1.0 / math.sqrt(fan_in))
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else draw(v) for k, v in tree.items()}

    return walk(JM.param_decls(jload(arch)))


def jax_reference(arch, np_params, batches):
    """Losses, gradient norms and the final state (parameters, m, v,
    master, carried to the port's layout by ``convert``) of the reference's
    jitted unsharded step (n_micro chunks of the global batch)."""
    import jax
    import jax.numpy as jnp

    from repro.configs.base import load_smoke_config as jload
    from repro.optim import optimizer as JO
    from repro.train import train_step as JTS
    from repro_torch.models.convert import opt_state_from_jax, params_from_jax

    jcfg = dataclasses.replace(jload(arch), dtype="float32", param_dtype="float32",
                               microbatches=N_MICRO)
    oc = JO.OptConfig(lr=LR, warmup_steps=1, total_steps=10)
    step = jax.jit(JTS.make_train_step(jcfg, oc, N_MICRO))
    p = jax.tree.map(jnp.asarray, np_params)
    o = JO.init_opt_state(p, oc)
    out = {"loss": [], "grad_norm": []}
    for b in batches:
        p, o, m = step(p, o, {k: jnp.asarray(v) for k, v in b.items()})
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    cfg = _cfg(arch)
    out["state"] = _state(params_from_jax(jax.tree.map(np.asarray, p), cfg, "cpu",
                                          torch.float32),
                          opt_state_from_jax(jax.tree.map(np.asarray, o), cfg, "cpu"))
    return out


def expected_local_shape(shape, placements, mesh_shape, coord):
    """torch.chunk's piece of each sharded dim, mesh dims in order."""
    shape = list(shape)
    for pl, n, c in zip(placements, mesh_shape, coord):
        if pl.startswith("S("):
            d = int(pl[2:-1])
            size = math.ceil(shape[d] / n)
            shape[d] = max(0, min(size, shape[d] - c * size))
    return tuple(shape)


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("world2")
    archs = ARCHS + STUB_ARCHS
    params = {arch: reference_params(arch) for arch in archs}
    batches = {arch: _batches(arch) for arch in archs}
    plain_ckpt = write_plain_checkpoint(str(out / "plain_ckpt"))
    jobs = {"meshes": MESHES, "archs": archs, "params": params, "batches": batches,
            "resume": MESHES}
    ctx = spawn_world(2, str(out), jobs)
    ref = {arch: jax_reference(arch, params[arch], batches[arch]) for arch in archs}
    while not ctx.join():
        pass
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return ranks, ref, plain_ckpt


def starts_at_zero(cfg, key: str) -> bool:
    """Whether the parameter behind a ``_state`` key (``params/<path>`` or
    ``opt/<field>/<path>``) is initialised to zeros."""
    from repro_torch.models.model import param_decls

    parts = key.split("/")
    node = param_decls(cfg)
    for part in parts[1 if parts[0] == "params" else 2:]:
        node = node[part]
    return node.init == "zeros"


def check_against_plain(rec, plain, arch, shape):
    """Bitwise at "model" size 1; otherwise the tolerances of the module
    docstring."""
    if shape[-1] == 1:
        assert rec["loss"] == plain["loss"]
        assert rec["grad_norm"] == plain["grad_norm"]
        for k, v in rec["state"].items():
            assert torch.equal(v, plain["state"][k]), k
        return
    cfg = _cfg(arch)
    for got, want in zip(rec["loss"], plain["loss"]):
        assert abs(got - want) <= 1e-6 * abs(want)
    np.testing.assert_allclose(rec["grad_norm"], plain["grad_norm"], rtol=1e-5)
    for k, v in rec["state"].items():
        want = plain["state"][k]
        if k == "opt/step":
            assert torch.equal(v, want)
        elif k.split("/")[1] in ("m", "v"):
            assert rel_l2(v, want) <= MV_REL, (k, rel_l2(v, want))
        else:
            tol = ZERO_INIT_REL if starts_at_zero(cfg, k) else TP_REL
            assert rel_l2(v, want) <= tol, (k, rel_l2(v, want))


def check_state_against_reference(state, want_state, arch):
    """Every leaf of the parameters, m, v and master after two placed steps
    against the reference's unsharded jitted step, the ``JAX_*_TOL``s."""
    cfg = _cfg(arch)
    assert state.keys() == want_state.keys()
    for k, v in state.items():
        want = want_state[k]
        if k == "opt/step":
            assert torch.equal(v, want)
            continue
        field = k.split("/")[1] if k.startswith("opt/") else "params"
        tol = (JAX_MV_TOL if field in ("m", "v") else
               JAX_ZERO_INIT_TOL if starts_at_zero(cfg, k) else JAX_PARAM_TOL)
        err = float((v.double() - want.double()).abs().max())
        assert err <= tol * max(float(want.abs().max()), 1e-30), (k, err)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", ARCHS + STUB_ARCHS)
def test_placed_step_against_the_unsharded_step(world, arch, shape):
    ranks, _, _ = world
    rec = ranks[0][(arch, shape)]
    check_against_plain(rec, rec["plain"], arch, shape)


def test_placed_step_compresses_its_gradients_as_the_unsharded_step(world):
    """``cfg.grad_compress`` on placed gradients: each quantized by the max
    over all its shards, so the step stays the unsharded one bit for bit."""
    ranks, _, _ = world
    rec = ranks[0][("grad_compress", (2, 1))]
    check_against_plain(rec, rec["plain"], "qwen25_14b", (2, 1))
    assert rec["loss"] != ranks[0][("qwen25_14b", (2, 1))]["loss"] or any(
        not torch.equal(v, ranks[0][("qwen25_14b", (2, 1))]["state"][k])
        for k, v in rec["state"].items())


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", ARCHS + STUB_ARCHS)
def test_placed_step_against_the_reference(world, arch, shape):
    ranks, ref, _ = world
    rec = ranks[0][(arch, shape)]
    for got, want in zip(rec["loss"], ref[arch]["loss"]):
        assert abs(got - want) <= 1e-5 * want
    np.testing.assert_allclose(rec["grad_norm"], ref[arch]["grad_norm"], rtol=1e-4)
    # every rank ends with the same metrics and the same full state
    other = ranks[1][(arch, shape)]
    assert other["loss"] == rec["loss"]
    for k, v in rec["state"].items():
        assert torch.equal(v, other["state"][k]), k


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", ARCHS + STUB_ARCHS)
def test_placed_state_against_the_reference(world, arch, shape):
    ranks, ref, _ = world
    check_state_against_reference(ranks[0][(arch, shape)]["state"], ref[arch]["state"], arch)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", ARCHS + STUB_ARCHS)
def test_placed_init_params_equal_the_placed_draw(world, arch, shape):
    """``init_params(mesh=, shardings=)``, each rank drawing the stream and
    keeping its pieces, equals ``place`` of the unplaced draw on every rank."""
    ranks, _, _ = world
    for r in ranks:
        rec = r[(arch, shape)]["init"]
        assert rec["leaves"] > 0 and rec["differ"] == [], rec


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", ARCHS)
def test_local_shards_have_their_placed_shapes(world, arch, shape):
    ranks, _, _ = world
    seen = set()
    for r in ranks:
        rec = r[(arch, shape)]
        assert rec["local"], "no placed leaf"
        for k, (glob, local, pls) in rec["local"].items():
            assert local == expected_local_shape(glob, pls, shape, rec["coord"]), k
            seen.add(pls)
    # the layout is really split: some leaf is sharded on each mesh dim of size 2
    for dim, n in enumerate(shape):
        if n > 1:
            assert any(p[dim].startswith("S(") for p in seen), shape


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_placed_resilient_run_resumes_bit_for_bit(world, shape):
    from repro_torch.models import model as M
    from repro_torch.optim import optimizer as O
    from repro_torch.train import checkpoint as C

    ranks, _, plain_ckpt = world
    runs = ranks[0][("resume", shape)]
    a, b = runs["straight"], runs["resumed"]
    assert a["restarts"] == 0 and b["restarts"] == 1
    assert a["loss"] == b["loss"] == ranks[1][("resume", shape)]["resumed"]["loss"]
    for k, v in a["params"].items():
        assert torch.equal(v, b["params"][k]), k
    # the unsharded checkpoint restored placed, on every rank
    for r in ranks:
        for k, (kind, v) in r[("resume", shape)]["plain_restored"].items():
            assert kind == "DTensor" and torch.equal(v, _flat(plain_ckpt)[k]), k
    # the placed run's last checkpoint restores unsharded, equal to its state
    cfg, oc = _tiny()
    tmpl = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert C.latest_step(b["dir"]) == 6
    params, _, _, _ = C.restore(b["dir"], 6, tmpl, O.init_opt_state(tmpl, oc))
    for k, v in _flat(params).items():
        assert torch.equal(v, b["params"][k]), k


def test_compressed_allreduce_int8_at_two_ranks(world):
    import jax.numpy as jnp

    from repro.optim import grad_compress as JGC

    ranks, _, _ = world
    recs = [r["int8"] for r in ranks]
    qs, ss = [], []
    for rec in recs:
        assert rec["wire"][0] == torch.int8  # the payload
        jq, js = JGC.quantize_int8(jnp.asarray(rec["x"].numpy()))
        assert rec["q"].dtype == torch.int8
        assert np.array_equal(rec["q"].numpy(), np.asarray(jq))
        assert rec["s"].item() == float(js)
        qs.append(jq)
        ss.append(js)
    want = np.asarray(jnp.tensordot(jnp.stack(ss), jnp.stack(qs).astype(jnp.float32),
                                    axes=((0,), (0,))))
    for rec in recs:
        assert rec["out"].dtype == torch.float32
        assert np.array_equal(rec["out"].numpy(), want)


@pytest.mark.parametrize("shape", ((64, 64), (64, 33), (3, 5, 129)),
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("ranks", (2, 3, 5))
@pytest.mark.parametrize("threads", (1, 4, 8))
def test_compressed_allreduce_int8_sum_at_thread_counts(threads, ranks, shape):
    """The all-reduce's local sum (``sum_scaled``) over gathered payloads is
    bit for bit the reference's ``jnp.tensordot`` at any intra-op thread
    count, over payloads whose scales span six decades."""
    import jax.numpy as jnp

    from repro.optim import grad_compress as JGC
    from repro_torch.optim import grad_compress as GC

    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        for seed in range(4):
            rng = np.random.default_rng(1000 * seed + 10 * ranks + threads)
            xs = [rng.standard_normal(shape).astype(np.float32) * 10 ** rng.uniform(-3, 3)
                  for _ in range(ranks)]
            jq = [JGC.quantize_int8(jnp.asarray(x)) for x in xs]
            want = np.asarray(jnp.tensordot(jnp.stack([s for _, s in jq]),
                                            jnp.stack([q for q, _ in jq]).astype(jnp.float32),
                                            axes=((0,), (0,))))
            tq = [GC.quantize_int8(torch.from_numpy(x)) for x in xs]
            got = GC.sum_scaled([s for _, s in tq], [q for q, _ in tq])
            assert got.dtype == torch.float32
            assert np.array_equal(got.numpy(), want), seed
    finally:
        torch.set_num_threads(before)


# -- on the card -----------------------------------------------------------


@pytest.fixture
def nccl_world(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


@pytest.mark.cuda
def test_cuda_placed_step_is_the_plain_step_on_one_rank(nccl_world):
    """A world of one NCCL rank, mesh (1, 1): two placed steps of smollm's
    smoke config in f32 at hd 64 (the backward kernel's smallest) equal two
    plain steps bit for bit, with as many launches of kernel 6 and of its
    backward (under ``local_map``)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M

    cfg = _cfg("smollm_360m", head_dim=64)
    p = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    np_params = {k: ({kk: vv.numpy() for kk, vv in v.items()} if isinstance(v, dict)
                     else v.numpy()) for k, v in p.items()}
    batches = _batches("smollm_360m")
    mesh = make_mesh((1, 1), device_type="cuda")
    counts = []
    for run in (lambda: run_placed("smollm_360m", mesh, np_params, batches, head_dim=64),
                lambda: run_plain("smollm_360m", np_params, batches, 1, _device(mesh),
                                  head_dim=64)):
        before = dict(ops.LAUNCHES)
        rec = run()
        counts.append({k: ops.LAUNCHES[k] - before.get(k, 0) for k in ops.LAUNCHES})
        counts[-1]["rec"] = rec
    placed, plain = counts[0].pop("rec"), counts[1].pop("rec")
    assert counts[0]["flash_attention"] > 0 and counts[0]["flash_attention_bwd"] > 0
    assert counts[0] == counts[1]
    assert placed["loss"] == plain["loss"]
    for k, v in placed["state"].items():
        assert torch.equal(v, plain["state"][k]), k
