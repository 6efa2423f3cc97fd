"""Package rules of the port: it imports neither JAX nor the JAX package,
builds nothing at import, and runs on the card unless asked for the CPU."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.utils.device import resolve_device

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
SMOKE = REPO / "chip_smoke.py"
ENV = dict(os.environ, PYTHONPATH=str(REPO / "src"))


# the secure masking and the workload generator (numpy-only copies)
SLICE_MODULES = ["repro_torch.core.secure",
                 *(f"repro_torch.workload.{m}" for m in (
                     "arrivals", "sizes", "churn", "regime", "trace",
                     "replay")),
                 "repro_torch.workload"]
# the serving layer, the Edge server and the serve CLI
SERVING_MODULES = [*(f"repro_torch.serving.{m}" for m in (
                       "protocol", "admission", "ingest", "frontend",
                       "client")),
                   "repro_torch.serving", "repro_torch.fl",
                   "repro_torch.fl.server", "repro_torch.launch.serve"]
# the training substrate: optimizers, data, the client and the train CLI
TRAINING_MODULES = ["repro_torch.optim", "repro_torch.optim.optimizers",
                    "repro_torch.optim.schedule", "repro_torch.data",
                    *(f"repro_torch.data.{m}" for m in (
                        "synthetic", "partition", "loader")),
                    "repro_torch.fl.client", "repro_torch.launch.train"]
# the distributed engine and its mesh tooling
MESH_MODULES = ["repro_torch.core.distributed", "repro_torch.launch.mesh"]


def _modules():
    out = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        out.append(".".join(parts))
    return out


def _run(args, cwd=REPO, env=ENV, timeout=120):
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_importing_the_port_loads_no_jax_and_builds_nothing():
    mods = _modules()
    assert {"repro_torch.kernels.fused_fusion.kernel",
            "repro_torch.kernels.flash_attention.kernel",
            "repro_torch.kernels.flash_decode.kernel",
            "repro_torch.kernels.ssd_chunk.kernel",
            "repro_torch.models.decoder",
            "repro_torch.models.layers.mamba2",
            "repro_torch.models.zamba",
            "repro_torch.launch.generate",
            "repro_torch.core.adaptive",
            "repro_torch.checkpoint",
            "repro_torch.checkpoint.ckpt",
            *SLICE_MODULES, *SERVING_MODULES, *TRAINING_MODULES,
            *MESH_MODULES} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro') or\n"
        "             m.startswith(('jax.', 'repro.')))\n"
        "from repro_torch.kernels import _build\n"
        "print('BAD', bad, 'LOADED', sorted(_build._LOADED))\n"
    )
    res = _run(["-c", code])
    assert res.returncode == 0, res.stderr
    assert "BAD [] LOADED []" in res.stdout, res.stdout


@pytest.mark.parametrize("module", ["repro_torch.core.adaptive",
                                    "repro_torch.checkpoint"])
def test_adaptive_and_checkpoint_load_no_jax(module):
    """The adaptive controller and the controller checkpoint are numpy
    and JSON copies of the JAX package's modules: importing either alone
    loads neither JAX nor the JAX package (the reference's checkpoint
    module imports JAX)."""
    code = (
        f"import {module}, sys\n"
        "print('BAD', sorted(m for m in sys.modules if m.split('.')[0]\n"
        "                    in ('jax', 'jaxlib', 'repro')))\n"
    )
    res = _run(["-c", code])
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout


@pytest.mark.parametrize("module", SLICE_MODULES)
def test_secure_and_workload_load_no_jax_and_no_kernel(module):
    """Each module of the secure masking and the workload generator,
    imported alone, loads neither JAX, nor the JAX package, nor a kernel
    library."""
    code = (
        f"import {module}, sys\n"
        "from repro_torch.kernels import _build\n"
        "print('BAD', sorted(m for m in sys.modules if m.split('.')[0]\n"
        "                    in ('jax', 'jaxlib', 'repro')),\n"
        "      'LOADED', sorted(_build._LOADED))\n"
    )
    res = _run(["-c", code])
    assert res.returncode == 0, res.stderr
    assert "BAD [] LOADED []" in res.stdout, res.stdout


@pytest.mark.parametrize("module", SERVING_MODULES)
def test_serving_layer_loads_no_jax_no_ml_dtypes_and_no_kernel(module):
    """Each module of the serving layer, imported alone, loads neither
    JAX, nor ``ml_dtypes`` (the port names bf16 frames itself), nor the
    JAX package, nor a kernel library."""
    code = (
        f"import {module}, sys\n"
        "from repro_torch.kernels import _build\n"
        "print('BAD', sorted(m for m in sys.modules if m.split('.')[0]\n"
        "                    in ('jax', 'jaxlib', 'ml_dtypes', 'repro')),\n"
        "      'LOADED', sorted(_build._LOADED))\n"
    )
    res = _run(["-c", code])
    assert res.returncode == 0, res.stderr
    assert "BAD [] LOADED []" in res.stdout, res.stdout


@pytest.mark.parametrize("module", TRAINING_MODULES)
def test_training_substrate_loads_no_jax_and_no_kernel(module):
    """Each module of the training substrate, imported alone, loads
    neither JAX nor the JAX package nor a kernel library."""
    code = (
        f"import {module}, sys\n"
        "from repro_torch.kernels import _build\n"
        "print('BAD', sorted(m for m in sys.modules if m.split('.')[0]\n"
        "                    in ('jax', 'jaxlib', 'repro')),\n"
        "      'LOADED', sorted(_build._LOADED))\n"
    )
    res = _run(["-c", code])
    assert res.returncode == 0, res.stderr
    assert "BAD [] LOADED []" in res.stdout, res.stdout


@pytest.mark.parametrize("module", MESH_MODULES)
def test_distributed_engine_loads_no_jax_and_no_kernel(module):
    """The distributed engine and the mesh tooling, each imported alone,
    load neither JAX nor the JAX package nor a kernel library."""
    code = (
        f"import {module}, sys\n"
        "from repro_torch.kernels import _build\n"
        "print('BAD', sorted(m for m in sys.modules if m.split('.')[0]\n"
        "                    in ('jax', 'jaxlib', 'repro')),\n"
        "      'LOADED', sorted(_build._LOADED))\n"
    )
    res = _run(["-c", code])
    assert res.returncode == 0, res.stderr
    assert "BAD [] LOADED []" in res.stdout, res.stdout


def test_train_cli_defaults_to_the_card():
    from repro_torch.launch import train

    assert train.parse_args([]).device == "cuda"
    assert train.parse_args([]).local_strategy == "kernel"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--rounds", "1", "--clients", "1"])


def _imported_names(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [SMOKE],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_repro_imports_in_source(path):
    bad = [name for name in _imported_names(path)
           if name.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes")]
    assert not bad, f"{path}: imports {bad}"


def test_entry_points_default_to_the_card():
    from repro_torch.core.local import LocalEngine
    from repro_torch.core.service import AggregationService

    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        assert AggregationService().device.type == "cuda"
        assert LocalEngine().device.type == "cuda"
        return
    for make in (lambda: resolve_device(None), lambda: resolve_device("cuda"),
                 AggregationService, LocalEngine,
                 lambda: AggregationService(device="cuda")):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    res = _run(["-m", "repro_torch.launch.aggregate", "--model", "CNN4.6",
                "--clients", "2"])
    assert res.returncode != 0 and "CUDA" in res.stderr


def test_serving_entry_points_default_to_the_card():
    from repro_torch.configs import get_config
    from repro_torch.launch import generate
    from repro_torch.models import build_model

    cfg = get_config("qwen2-0.5b-smoke")
    assert build_model(cfg, device="cpu").device == torch.device("cpu")
    if torch.cuda.is_available():
        assert build_model(cfg).device.type == "cuda"
        return
    for make in (lambda: build_model(cfg),
                 lambda: build_model(cfg, device="cuda"),
                 lambda: generate.main(["--arch", "qwen2-0.5b-smoke"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    res = _run(["-m", "repro_torch.launch.generate", "--arch",
                "qwen2-0.5b-smoke"])
    assert res.returncode != 0 and "CUDA" in res.stderr


def _assert_no_result(res):
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout and '"kernels"' not in res.stdout


def test_chip_smoke_fails_without_a_card_or_a_repo(tmp_path):
    if not torch.cuda.is_available():
        _assert_no_result(_run([str(SMOKE)], env=dict(os.environ)))
    lone = tmp_path / "lone"
    lone.mkdir()
    shutil.copy(SMOKE, lone / "chip_smoke.py")
    _assert_no_result(_run(["chip_smoke.py"], cwd=lone, env=dict(os.environ)))
