"""The port stands alone: it imports neither jax nor the reference package,
and its entry points run on the card unless the CPU is asked for."""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import convert
from repro_torch.configs.registry import get_config
from repro_torch.device import resolve_device
from repro_torch.federated import experiment, simulation
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.quantize import ops
from repro_torch.kernels.selective_scan import ops as ss_ops
from repro_torch.launch import serve
from repro_torch.models import transformer as tfm

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
    cfg = get_config("qwen2-0.5b", smoke=True)
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        assert spec.build().device.type == "cuda"
        params = tfm.init_params(cfg, torch.Generator())
        assert params["embed"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        spec.build()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulation.Simulator(None, {}, lambda s: [], [], spec.fed, None, None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfm.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--smoke", "--prompt-len", "8", "--gen", "2"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "falcon-mamba-7b", "--smoke", "--prompt-len",
                    "8", "--gen", "2"])
    params = tfm.init_params(cfg, torch.Generator(), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.generate(cfg, params, torch.zeros(1, 8, dtype=torch.int64), 2)
    assert resolve_device("cpu").type == "cpu"


def test_to_torch_defaults_to_cuda_and_never_falls_back():
    params = {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}
    if torch.cuda.is_available():
        assert convert.to_torch(params)["w"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            convert.to_torch(params)
    out = convert.to_torch(params, device="cpu")
    assert out["w"].device.type == "cpu"
    assert torch.equal(out["w"], torch.arange(6.0).reshape(2, 3))


def test_quantize_refuses_other_devices():
    x = torch.zeros(4, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.quantize(x, x)


def test_flash_attention_refuses_other_devices():
    x = torch.zeros(1, 8, 2, 32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa_ops.flash_attention(x, x, x)


def test_selective_scan_refuses_other_devices():
    x = torch.zeros(1, 8, 16, device="meta")
    A = torch.zeros(16, 8, device="meta")
    bc = torch.zeros(1, 8, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ss_ops.selective_scan(x, x, A, bc, bc, torch.zeros(16, device="meta"))
