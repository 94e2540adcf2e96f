"""The port stands alone: it imports neither jax nor the reference package,
and its entry points run on the card unless the CPU is asked for."""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

import repro_torch
from repro_torch.device import resolve_device
from repro_torch.federated import experiment, simulation
from repro_torch.kernels.quantize import ops

PKG = pathlib.Path(repro_torch.__file__).resolve().parent
MODULES = sorted(
    ".".join(("repro_torch",) + p.relative_to(PKG).with_suffix("").parts)
    .removesuffix(".__init__")
    for p in PKG.rglob("*.py"))


def test_importing_every_module_leaves_jax_and_repro_out():
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in MODULES)
            + "bad = sorted(m for m in sys.modules if m == 'jax' or "
              "m.startswith('jax.') or m == 'repro' or "
              "m.startswith('repro.'))\n"
              "print(len(bad), bad)\n"
              "sys.exit(1 if bad else 0)\n")
    env = {"PYTHONPATH": str(PKG.parent), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert len(MODULES) > 15


def test_no_source_imports_jax_or_repro():
    chip_smoke = PKG.parent.parent / "chip_smoke.py"
    assert chip_smoke.exists()
    for path in [*PKG.rglob("*.py"), chip_smoke]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (path, n)


def test_entry_points_default_to_cuda_and_never_fall_back():
    spec = experiment.get("mnist_smoke")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        assert spec.build().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        spec.build()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulation.Simulator(None, {}, lambda s: [], [], spec.fed, None, None)
    assert resolve_device("cpu").type == "cpu"


def test_quantize_refuses_other_devices():
    x = torch.zeros(4, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.quantize(x, x)
