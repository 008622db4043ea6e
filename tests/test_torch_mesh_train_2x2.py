"""The placed train step on a world of 4 gloo ranks on the CPU: mesh (2, 2)
over ("data", "model"), FSDP and the feature split at once.

The same cases and gates as ``test_torch_mesh_train.py`` at "model" > 1
(against the port's unsharded step over the shards' chunks, against the
reference's unsharded step and its final state, local shard shapes, the
placed ``init_params``), for qwen2.5-14b,
zamba2-7b, phi3.5-moe and smollm-360m at their SMOKE configs in f32; the
multi-pod mesh (2, 2, 1) over ("pod", "data", "model") bit for bit against
the unsharded step over the four shards' chunks; and
``compressed_allreduce_int8`` at 4 ranks: int8 on the wire, the payloads
and scales bit for bit the reference's ``quantize_int8`` per rank, the sum
within 1e-6 relative of the reference's formula (four terms: the order of
a dot product's sum is the library's).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_mesh_train import (  # noqa: E402
    ARCHS, _batches, check_against_plain, check_state_against_reference,
    expected_local_shape, jax_reference, reference_params, spawn_world,
    write_plain_checkpoint)

MESH = (2, 2)
#: the multi-pod layout at its smallest: ("pod", "data", "model") = (2, 2, 1),
#: the batch axes four shards pod-major
POD_MESH = (2, 2, 1)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("world4")
    params = {arch: reference_params(arch) for arch in ARCHS}
    batches = {arch: _batches(arch) for arch in ARCHS}
    write_plain_checkpoint(str(out / "plain_ckpt"))
    jobs = {"meshes": (MESH, POD_MESH), "archs": ARCHS, "params": params,
            "batches": batches, "resume": ()}
    ctx = spawn_world(4, str(out), jobs)
    ref = {arch: jax_reference(arch, params[arch], batches[arch]) for arch in ARCHS}
    while not ctx.join():
        pass
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(4)], ref


@pytest.mark.parametrize("arch", ARCHS)
def test_placed_step_against_the_unsharded_step(world, arch):
    ranks, _ = world
    rec = ranks[0][(arch, MESH)]
    check_against_plain(rec, rec["plain"], arch, MESH)


@pytest.mark.parametrize("arch", ARCHS)
def test_multi_pod_placed_step_is_the_unsharded_step(world, arch):
    """(2, 2, 1): the gradients reduced over ("pod", "data") as one group in
    pod-major order, so two placed steps are the unsharded step over
    ``n_micro * 4`` chunks bit for bit, on every rank."""
    ranks, _ = world
    rec = ranks[0][(arch, POD_MESH)]
    check_against_plain(rec, rec["plain"], arch, POD_MESH)
    for other in ranks[1:]:
        assert other[(arch, POD_MESH)]["loss"] == rec["loss"]
        assert other[(arch, POD_MESH)]["init"]["differ"] == []


@pytest.mark.parametrize("arch", ARCHS)
def test_placed_step_against_the_reference(world, arch):
    ranks, ref = world
    rec = ranks[0][(arch, MESH)]
    for got, want in zip(rec["loss"], ref[arch]["loss"]):
        assert abs(got - want) <= 1e-5 * want
    np.testing.assert_allclose(rec["grad_norm"], ref[arch]["grad_norm"], rtol=1e-4)
    for other in ranks[1:]:
        assert other[(arch, MESH)]["loss"] == rec["loss"]


@pytest.mark.parametrize("arch", ARCHS)
def test_placed_state_against_the_reference(world, arch):
    ranks, ref = world
    check_state_against_reference(ranks[0][(arch, MESH)]["state"], ref[arch]["state"], arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_placed_init_params_equal_the_placed_draw(world, arch):
    ranks, _ = world
    for r in ranks:
        rec = r[(arch, MESH)]["init"]
        assert rec["leaves"] > 0 and rec["differ"] == [], rec


@pytest.mark.parametrize("arch", ARCHS)
def test_local_shards_have_their_placed_shapes(world, arch):
    ranks, _ = world
    coords = set()
    for r in ranks:
        rec = r[(arch, MESH)]
        coords.add(rec["coord"])
        for k, (glob, local, pls) in rec["local"].items():
            assert local == expected_local_shape(glob, pls, MESH, rec["coord"]), k
    assert coords == {(0, 0), (0, 1), (1, 0), (1, 1)}


def test_compressed_allreduce_int8_at_four_ranks(world):
    import jax.numpy as jnp

    from repro.optim import grad_compress as JGC

    ranks, _ = world
    recs = [r["int8"] for r in ranks]
    qs, ss = [], []
    for rec in recs:
        assert rec["wire"][0] == torch.int8
        jq, js = JGC.quantize_int8(jnp.asarray(rec["x"].numpy()))
        assert np.array_equal(rec["q"].numpy(), np.asarray(jq))
        assert rec["s"].item() == float(js)
        qs.append(jq)
        ss.append(js)
    want = np.asarray(jnp.tensordot(jnp.stack(ss), jnp.stack(qs).astype(jnp.float32),
                                    axes=((0,), (0,))))
    for rec in recs:
        np.testing.assert_allclose(rec["out"].numpy(), want, rtol=1e-6, atol=1e-6)
        assert np.array_equal(rec["out"].numpy(), recs[0]["out"].numpy())
