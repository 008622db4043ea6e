"""Placed serving on ``torch.distributed`` worlds of 2 gloo ranks on the CPU:
``prefill`` and ``decode_step`` on DTensors over meshes (2, 1) and (1, 2)
of ("data", "model"), held to the unplaced port.

One world runs every case (rendezvous through a file store; one thread a
rank, and the unplaced comparator in rank 0 with the same thread count)
and writes what it measured; the tests compare it.  Each case places the
parameters by the rules the dry run builds for the cell
(``launch.dryrun.cell_rules``: FSDP for prefill, ``decode_param_mode``
for decode) and runs under ``activate`` and ``implicit_replication``, as
``launch/dryrun.py`` does on ``meta``; here the tensors hold numbers:

* **prefill**: the logits and every decode cache leaf (the full caches'
  zero padding, gemma3's local ring, whisper's self and cross rows);
* **decode**: one ``decode_step`` from the unplaced prefill's caches, placed
  by ``inputs.decode_cache_shardings``: its logits and its new caches;
* **paged decode** (batch 1, the long-context rules: the pool's pages over
  "data"): one step at a page boundary, so the allocation and the row
  written on the shard that holds the new page
  (``paged_kv._placed_insert_token``): logits, K/V pool and planes.

The unplaced comparator runs each data shard's rows on their own (the
CPU's vectorised elementwise kernels round a row by the size of the tensor
it lies in, as ``softplus`` does).  At (2, 1) every output is bit for bit
the unplaced one.  At (1, 2) "model" splits contractions: outputs within
``TP_TOL`` of max |want|.  The paged step splits its keys over "data": its
floats within ``TP_TOL`` on both meshes, its planes (integer decisions)
equal.

Configs: the SMOKE configs in f32 of smollm-360m (uneven heads: 1 kv head),
qwen2.5-14b (QKV bias), gemma3-27b (local + global), phi3.5-moe,
zamba2-7b (Mamba-2 + shared attention), whisper-large-v3 (frames) and
internvl2-26b (patches).
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

ARCHS = ("smollm_360m", "qwen25_14b", "gemma3_27b", "phi35_moe", "zamba2_7b",
         "whisper_large_v3", "internvl2_26b")
PAGED_ARCHS = ("smollm_360m", "qwen25_14b")
MESHES = ((2, 1), (1, 2))
B, S, MAX_LEN = 4, 32, 40
#: (1, 2), and the paged step on both meshes, against the unplaced run: max
#: |got - want| over max |want|.  Measured worst over the cases (CPU, f32):
#: 1.19e-6 (zamba2's decode SSM state), logits 9.8e-7.
TP_TOL = 1e-5


def _cfg(arch, **kw):
    from repro_torch.configs.base import load_smoke_config

    return dataclasses.replace(load_smoke_config(arch), dtype="float32",
                               param_dtype="float32", **kw)


def _paged_cfg(arch):
    return _cfg(arch, page_size=8, bounded_kv_pages=4)


def _inputs(cfg, batch, seq, seed=1):
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32)),
           "next": torch.from_numpy(rng.integers(0, cfg.vocab, (batch, 1)).astype(np.int32))}
    stub = {"encdec": ("frames", seq // cfg.enc_seq_divisor),
            "vlm": ("patches", cfg.n_patch_tokens)}.get(cfg.family)
    if stub:
        out[stub[0]] = torch.from_numpy(
            (rng.standard_normal((batch, stub[1], cfg.d_model)) * 0.02).astype(np.float32))
    return out


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


def _full(t):
    from torch.distributed.tensor import DTensor

    return (t.full_tensor() if isinstance(t, DTensor) else t).detach().clone()


def _record(logits, caches):
    return {"logits": _full(logits),
            "caches": {k: _full(v) for k, v in _flat(caches).items()}}


def _rows(tree, block):
    """The decode-cache tree's rows ``block`` (a slice of the batch), each
    leaf cut on its batch dim (``inputs._cache_names``'s "act_batch")."""
    from repro_torch.launch import inputs as I

    def one(name, t):
        if t.dim() == 0:
            return t.clone()
        d = I._cache_names(name, t.dim(), "act_batch").index("act_batch")
        return t.narrow(d, block.start, block.stop - block.start).clone()

    return I._map_named(one, tree)


def _cat(trees):
    """Decode-cache trees of consecutive row blocks, joined on each leaf's
    batch dim (the 0-d position taken from the first)."""
    from repro_torch.launch import inputs as I

    flat = [_flat(t) for t in trees]
    out = {}
    for k, t in flat[0].items():
        if t.dim() == 0:
            out[k] = t
            continue
        d = I._cache_names(k.rsplit("/", 1)[-1], t.dim(), "act_batch").index("act_batch")
        out[k] = torch.cat([f[k] for f in flat], dim=d)
    return out


def _unflat(flat, like):
    """``flat`` (``_flat``'s keys) in the structure of ``like``."""
    from repro_torch.launch import inputs as I

    keys = iter(_flat(like))
    return I._map_named(lambda name, t: flat[next(keys)], like)


def run_case(arch, mesh, *, paged=False, shards=1):
    """Prefill then one decode step, placed on ``mesh``; with no mesh, the
    unplaced port over each of ``shards`` row blocks (each data shard's
    rows: the CPU's elementwise kernels round a row by the tensor's size),
    joined."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import inputs as I
    from repro_torch.launch.dryrun import cell_rules
    from repro_torch.models import model as M
    from repro_torch.sharding.shards import local_part
    from repro_torch.sharding.specs import activate, placements_for

    cfg = _paged_cfg(arch) if paged else _cfg(arch)
    batch, seq, max_len = (1, 2 * cfg.page_size, 0) if paged else (B, S, MAX_LEN)
    kv_mode = "paged" if paged else "full"
    x = _inputs(cfg, batch, seq)
    stubs = {k: x[k] for k in ("frames", "patches") if k in x}
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    n = batch // shards
    blocks = [slice(i * n, (i + 1) * n) for i in range(shards)]

    def prefill(rows, **kw):
        return M.prefill(params, cfg, x["tokens"][rows], max_len,
                         **{k: v[rows] for k, v in stubs.items()}, **kw)

    # the decode steps start from the unplaced prefill's caches, row block
    # by row block
    _, proto = prefill(blocks[0], kv_mode=kv_mode)
    caches0 = _unflat(_cat([prefill(r, kv_mode=kv_mode)[1] for r in blocks]), proto)
    caches0 = {"pos": proto["pos"], "blocks": caches0["blocks"]}
    rec = {}
    if mesh is None:
        with torch.no_grad():
            if not paged:
                outs = [prefill(r) for r in blocks]
                rec["prefill"] = {"logits": torch.cat([o[0] for o in outs]),
                                  "caches": _cat([o[1] for o in outs])}
            outs = [M.decode_step(params, cfg, x["next"][r], _rows(caches0, r),
                                  kv_mode=kv_mode) for r in blocks]
            rec["decode"] = {"logits": torch.cat([o[0] for o in outs]),
                             "caches": _cat([o[1] for o in outs])}
        return rec
    name = "long_500k" if paged else "decode_32k"
    for kind in (("decode",) if paged else ("prefill", "decode")):
        shape = ShapeSpec(name if kind == "decode" else "prefill_32k", seq, batch, kind)
        rules = cell_rules(cfg, shape, multi=False)
        placed = I.place(params, mesh, I.params_shardings(cfg, mesh, rules))
        if kind == "prefill" or cfg.decode_param_mode == "fsdp":
            placed = I.gather_on_use(placed, cfg, mesh)  # as the dry run's step

        def put(t, names):
            return local_part(t, mesh, placements_for(mesh, rules, names))

        with activate(mesh, rules), implicit_replication(), torch.no_grad():
            if kind == "prefill":
                seq_names = ("act_batch", "act_seq", "act_embed")
                out = M.prefill(placed, cfg, put(x["tokens"], seq_names[:2]), max_len,
                                **{k: put(v, seq_names) for k, v in stubs.items()})
            else:
                sh = I.decode_cache_shardings(cfg, shape, mesh, rules, caches0)
                caches = I.place(M.clone_caches(caches0), mesh, sh)
                caches["pos"] = caches0["pos"].clone()  # a plain 0-d tensor, as unplaced
                tok = put(x["next"], ((None if batch == 1 else "act_batch"), None))
                out = M.decode_step(placed, cfg, tok, caches, kv_mode=kv_mode)
        rec[kind] = _record(*out)
    return rec


def _serve_world(rank, world, store, out_dir, jobs):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    from repro_torch.launch.mesh import make_mesh

    results = {}
    try:
        for shape in jobs["meshes"]:
            mesh = make_mesh(shape, device_type="cpu")
            for arch, paged in jobs["cases"]:
                results[(arch, paged, shape)] = run_case(arch, mesh, paged=paged,
                                                         shards=_shards(shape, paged))
        if rank == 0:  # the same thread count as the shards
            for arch, paged in jobs["cases"]:
                for shards in (1, 2):
                    results[(arch, paged, "plain", shards)] = run_case(
                        arch, None, paged=paged, shards=1 if paged else shards)
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("serve2")
    cases = [(a, False) for a in ARCHS] + [(a, True) for a in PAGED_ARCHS]
    jobs = {"meshes": MESHES, "cases": cases}
    ctx = mp.spawn(_serve_world, args=(2, os.path.join(out, "store"), str(out), jobs),
                   nprocs=2, join=False)
    while not ctx.join():
        pass
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(2)]


def _shards(shape, paged):
    """Row blocks of the unplaced comparator: the data shards' (batch 1 when
    paged: the pages split, not the rows)."""
    return 1 if paged else shape[0]


def _want(world, arch, paged, shape):
    return world[0][(arch, paged, "plain", _shards(shape, paged))]


def _check(got, want, exact):
    assert got.keys() == want.keys()
    for k, v in got.items():
        w = want[k]
        assert v.shape == w.shape and v.dtype == w.dtype, k
        if exact or not v.is_floating_point():
            assert torch.equal(v, w), k
        else:
            err = float((v.double() - w.double()).abs().max())
            assert err <= TP_TOL * max(float(w.abs().max()), 1e-30), (k, err)


def _check_record(got, want, shape, *, exact_floats=True):
    exact = shape[1] == 1 and exact_floats
    _check({"logits": got["logits"]}, {"logits": want["logits"]}, exact)
    _check(got["caches"], want["caches"], exact)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", ARCHS)
def test_placed_prefill_against_the_unplaced_prefill(world, arch, shape):
    for r in world:
        _check_record(r[(arch, False, shape)]["prefill"],
                      _want(world, arch, False, shape)["prefill"], shape)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", ARCHS)
def test_placed_decode_step_against_the_unplaced_step(world, arch, shape):
    for r in world:
        _check_record(r[(arch, False, shape)]["decode"],
                      _want(world, arch, False, shape)["decode"], shape)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", PAGED_ARCHS)
def test_placed_paged_decode_step_against_the_unplaced_step(world, arch, shape):
    """The pool's pages split over "data": the new page's row lands on the
    shard that holds it and the decisions (the integer planes) are the
    unplaced step's.  The attention sums over keys split between the
    shards, so its logits, and the rows later layers write, hold within
    ``TP_TOL`` on both meshes."""
    want = _want(world, arch, True, shape)["decode"]
    for r in world:
        got = r[(arch, True, shape)]["decode"]
        _check_record(got, want, shape, exact_floats=False)
        # the step allocated a page: a third page is resident
        starts = got["caches"]["blocks/u0/page_start"]
        assert int((starts >= 0).sum()) == 3 * starts.shape[0], starts
