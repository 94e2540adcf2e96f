"""The port stands alone: it imports neither jax nor the reference package
(nor the reference's benchmarks), and its entry points run on the card
unless the CPU is asked for."""
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
from repro_torch.federated import experiment, simulation, study
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.fold_matmul import ops as fm_ops
from repro_torch.kernels.quantize import ops
from repro_torch.kernels.selective_scan import ops as ss_ops
from repro_torch.launch import serve, train
from repro_torch.models import transformer as tfm

PKG = pathlib.Path(repro_torch.__file__).resolve().parent
ROOT = PKG.parent.parent
# The port's scripts outside the package: they import nothing of JAX or of
# the reference either.
SCRIPTS = [ROOT / "chip_smoke.py", ROOT / "examples" / "quickstart_torch.py",
           ROOT / "examples" / "defl_vs_fedavg_torch.py",
           ROOT / "examples" / "async_vs_sync_torch.py",
           ROOT / "examples" / "planner_service_demo_torch.py",
           ROOT / "examples" / "serve_decode_torch.py",
           ROOT / "examples" / "multipod_dryrun_demo_torch.py"]
MODULES = sorted(
    ".".join(("repro_torch",) + p.relative_to(PKG).with_suffix("").parts)
    .removesuffix(".__init__")
    for p in PKG.rglob("*.py"))


def test_importing_every_module_leaves_jax_and_repro_out():
    code = ("import runpy, sys\n"
            + "".join(f"import {m}\n" for m in MODULES)
            + "".join(f"runpy.run_path({str(p)!r}, run_name='script')\n"
                      for p in SCRIPTS)
            + "bad = sorted(m for m in sys.modules if m == 'jax' or "
              "m.startswith('jax.') or m == 'repro' or "
              "m.startswith('repro.') or m == 'benchmarks' or "
              "m.startswith('benchmarks.'))\n"
              "print(len(bad), bad)\n"
              "sys.exit(1 if bad else 0)\n")
    env = {"PYTHONPATH": str(PKG.parent), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert len(MODULES) > 15
    # The numpy copies of the reference's modules are walked too.
    assert {"repro_torch.federated.faults",
            "repro_torch.federated.scenarios",
            "repro_torch.federated.server"} <= set(MODULES)
    # The sampled path's modules (ClientDataPool, partition_virtual, the
    # cohort stacks, the cohort chunk, the sampled Simulator and spec).
    assert {"repro_torch.data.pipeline", "repro_torch.federated.partition",
            "repro_torch.federated.client",
            "repro_torch.federated.mesh_rounds",
            "repro_torch.federated.simulation",
            "repro_torch.federated.experiment",
            "repro_torch.federated.study"} <= set(MODULES)
    # The asynchronous backend's own module (AsyncSpec, the twin, the
    # oracle), a numpy copy of the reference's.
    assert "repro_torch.federated.events" in MODULES
    # The trace-driven fleets and the online planner, numpy copies of the
    # reference's.
    assert {"repro_torch.federated.traces",
            "repro_torch.federated.planner"} <= set(MODULES)
    # musicgen-large and the training path: the config, AdamW, the
    # checkpoint files (with the port's own msgpack codec: the msgpack
    # package is no dependency) and the driver.
    assert {"repro_torch.configs.musicgen_large", "repro_torch.optim.adam",
            "repro_torch.checkpoint", "repro_torch.checkpoint.io",
            "repro_torch.launch.train"} <= set(MODULES)
    # The dry run and its roofline tools.
    assert {"repro_torch.launch.dryrun", "repro_torch.launch.mesh",
            "repro_torch.launch.specs_inputs", "repro_torch.launch.postprocess",
            "repro_torch.sharding", "repro_torch.sharding.specs",
            "repro_torch.utils.analytic", "repro_torch.utils.flops",
            "repro_torch.utils.hlo"} <= set(MODULES)
    # The client axis across ranks: torch.distributed, nothing of JAX.
    assert "repro_torch.sharding.collectives" in MODULES


def test_checkpoint_io_needs_no_msgpack_package():
    code = ("import sys\nsys.modules['msgpack'] = None\n"
            "from repro_torch.checkpoint import io\n"
            "assert io.unpackb(io.packb({'a': [1, b'x']})) == "
            "{'a': [1, b'x']}\n")
    env = {"PYTHONPATH": str(PKG.parent), "PATH": "/usr/bin:/bin"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_no_source_imports_jax_or_repro():
    assert all(p.exists() for p in SCRIPTS)
    for path in [*PKG.rglob("*.py"), *SCRIPTS]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro", "benchmarks"), (
                    path, n)


def test_entry_points_default_to_cuda_and_never_fall_back():
    spec = experiment.get("mnist_smoke")
    sampled = experiment.get("mnist_sampled")
    asyn = experiment.get("mnist_async")
    cfg = get_config("qwen2-0.5b", smoke=True)
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        assert spec.build().device.type == "cuda"
        sim = asyn.build()
        assert sim.device.type == "cuda"
        assert sim.init().async_c["t_finish"].device.type == "cuda"
        for backend in ("scan", "batched"):
            assert sampled.replace(backend=backend).build(
            ).device.type == "cuda"
        for backend in ("batched", "loop"):
            assert spec.replace(backend=backend).build().device.type == "cuda"
        sims = study.Study(arms=[("A", spec)]).build_sims()
        assert sims["A"].device.type == "cuda"
        params = tfm.init_params(cfg, torch.Generator())
        assert params["embed"].device.type == "cuda"
        params = train.main(["--smoke", "--rounds", "1", "--clients", "1",
                             "--batch", "2", "--seq", "16", "--V", "1"])
        assert params["embed"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        spec.build()
    for backend in ("scan", "batched"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            sampled.replace(backend=backend).build()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        asyn.build()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulation.Simulator(None, {}, lambda s: [], [], spec.fed, None,
                             None, backend="async",
                             async_spec=asyn.async_spec)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        study.Study(arms=[("A", spec)], max_rounds=1).run()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulation.Simulator(None, {}, lambda s: [], [], spec.fed, None, None)
    for backend in ("batched", "loop"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            spec.replace(backend=backend).build()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            simulation.Simulator(None, {}, lambda s: [], [], spec.fed, None,
                                 None, backend=backend)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfm.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--smoke", "--prompt-len", "8", "--gen", "2"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "falcon-mamba-7b", "--smoke", "--prompt-len",
                    "8", "--gen", "2"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "musicgen-large", "--smoke", "--prompt-len",
                    "8", "--gen", "2"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--smoke", "--rounds", "1", "--clients", "1"])
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


def test_fold_matmul_refuses_other_devices():
    x = torch.zeros(2, 4, 4, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fm_ops.fold_matmul(x, x)
