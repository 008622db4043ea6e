"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the reference package, and the port's entry
points run on the CUDA card unless the caller asks for the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
PORT_MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(".__init__")
    for p in PORT.rglob("*.py"))


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "repro")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax_and_no_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = (
        "import importlib, sys\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
    )
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= len(PORT_MODULES)


def test_chip_smoke_alone_fails_without_the_repo(tmp_path):
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env={"PATH": "/usr/bin:/bin"}, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _smoke_cfg():
    from repro_torch.configs import smollm_360m

    return smollm_360m.SMOKE_CONFIG


def test_init_params_defaults_to_cuda(no_cuda):
    from repro_torch.models import model as M

    with pytest.raises(RuntimeError, match="cuda"):
        M.init_params(_smoke_cfg(), torch.Generator().manual_seed(0))


def test_engine_defaults_to_cuda(no_cuda):
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeEngine

    params = M.init_params(_smoke_cfg(), torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        ServeEngine(_smoke_cfg(), params)


def test_pool_and_caches_default_to_cuda(no_cuda):
    from repro_torch.cache import paged_kv
    from repro_torch.models import model as M

    with pytest.raises(RuntimeError, match="cuda"):
        paged_kv.init_pool(1, 2, 4, 8, torch.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        M.decode_caches(_smoke_cfg(), 1, 64, kv_mode="paged")


def test_params_from_jax_defaults_to_cuda(no_cuda):
    from repro_torch.models.convert import params_from_jax

    with pytest.raises(RuntimeError, match="cuda"):
        params_from_jax({}, _smoke_cfg())


def test_launch_serve_defaults_to_cuda(no_cuda):
    from repro_torch.launch import serve

    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--smoke"])


def test_gemma3_entry_points_default_to_cuda(no_cuda):
    from repro_torch.configs import gemma3_27b
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "gemma3_27b", "--smoke"])
    with pytest.raises(RuntimeError, match="cuda"):
        M.decode_caches(gemma3_27b.SMOKE_CONFIG, 1, 64, kv_mode="paged")


def test_port_files_cover_the_sweep_slice():
    """The import checks above walk every module of the package, the sweep,
    tenancy and training-layout slices' included."""
    names = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    for mod in ("core/traces.py", "core/policies.py", "core/simulator.py",
                "core/policy_core.py", "core/torch_policies.py",
                "kernels/awrp_select.py", "kernels/flash_attn.py",
                "configs/gemma3_27b.py", "serve/tenancy.py", "kernels/sweep.py",
                "core/sharding.py", "sharding/specs.py", "launch/mesh.py",
                "launch/inputs.py", "roofline/analytic.py", "roofline/analysis.py",
                "launch/dryrun.py"):
        assert mod in names, mod
        assert "repro_torch." + mod[:-3].replace("/", ".") in PORT_MODULES


def test_every_reference_module_has_a_counterpart_in_the_port():
    """The port mirrors the reference module for module: every file of
    ``src/repro`` has one of the same path in ``src/repro_torch``, the JAX
    policy engine's being ``core/torch_policies.py``."""
    ref = ROOT / "src" / "repro"
    renamed = {"core/jax_policies.py": "core/torch_policies.py"}
    names = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    missing = [m for m in (p.relative_to(ref).as_posix() for p in ref.rglob("*.py"))
               if renamed.get(m, m) not in names]
    assert not missing, missing


def test_simulate_trace_batched_defaults_to_cuda(no_cuda):
    from repro_torch.core.torch_policies import simulate_trace_batched

    with pytest.raises(RuntimeError, match="cuda"):
        simulate_trace_batched([1, 2, 1], ["awrp"], [2])


def test_rows_mesh_defaults_to_cuda(no_cuda):
    from repro_torch.core import sharding

    with pytest.raises(RuntimeError, match="cuda"):
        sharding.rows_mesh()
    with pytest.raises(RuntimeError, match="cuda"):
        sharding.rows_mesh(devices=("cuda:0",) * 2)


def test_loop_planes_defaults_to_cuda(no_cuda):
    from repro_torch.obs.metrics import loop_planes

    with pytest.raises(RuntimeError, match="cuda"):
        loop_planes()


def test_sweep_engine_defaults_to_cuda(no_cuda):
    from repro_torch.core import sweep

    with pytest.raises(RuntimeError, match="cuda"):
        sweep(["awrp", "2q"], [1, 2, 1], [2])
    with pytest.raises(RuntimeError, match="cuda"):
        sweep(["arc"], [], [2])  # resolved whenever a policy goes to the engine
    # the host path alone needs no device
    assert sweep(["awrp"], [1, 2, 1], [2], device=False) == {"awrp": {2: 1 / 3}}


@pytest.mark.parametrize("policy", ["awrp", "car"])
def test_core_init_defaults_to_cuda(no_cuda, policy):
    from repro_torch.core import policy_core

    with pytest.raises(RuntimeError, match="cuda"):
        policy_core.make_core(policy, rows=2, ways=4).init()
    with pytest.raises(RuntimeError, match="cuda"):
        policy_core.init(policy, rows=2, ways=4)


def test_tenancy_defaults_to_cuda(no_cuda):
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.tenancy import TenantCacheManager, TenantPrefixCache

    with pytest.raises(RuntimeError, match="cuda"):
        TenantCacheManager({"a": 2, "b": 1})
    with pytest.raises(RuntimeError, match="cuda"):
        TenantPrefixCache({"a": 2}, "arc")
    params = M.init_params(_smoke_cfg(), torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        ServeEngine(_smoke_cfg(), params, tenants={"a": 2})


def test_set_state_defaults_to_cuda(no_cuda):
    from repro_torch.core.policy_core import init_adaptive_state
    from repro_torch.core.torch_policies import init_set_state

    with pytest.raises(RuntimeError, match="cuda"):
        init_set_state(8, 2)
    with pytest.raises(RuntimeError, match="cuda"):
        init_adaptive_state(1, 1, 8)


def test_mesh_entry_points_default_to_cuda(no_cuda):
    import inspect

    from repro_torch.configs.base import load_smoke_config
    from repro_torch.launch import inputs, mesh

    for fn in (mesh.make_mesh, mesh.make_production_mesh):
        assert inspect.signature(fn).parameters["device_type"].default == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        inputs.concrete_batch(load_smoke_config("smollm_360m"), 2, 8,
                              torch.Generator().manual_seed(0))
