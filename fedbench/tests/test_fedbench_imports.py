"""The import rule: nothing fedbench runs loads JAX or the JAX package
`repro`, compared by whole top-level module names (the port `repro_torch`
begins with `repro` and is allowed); the reference loads no code of the
program either. And without a card the harness prints no result."""
import ast
import os
import subprocess
import sys

from fedbench.harness import imports, manifest


def _imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_imports_jax_or_the_jax_package():
    for path in manifest.BENCH.rglob("*.py"):
        assert imports.forbidden(_imported(path)) == [], path


def test_the_reference_imports_nothing_of_the_program():
    for path in (manifest.BENCH / "reference").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imported(path)}
        assert not tops & {"repro", "repro_torch", "fedbench"}, path


def test_names_compare_whole():
    assert imports.forbidden(["repro_torch", "repro_torch.models.cnn",
                              "jaxtyping", "reproducible", "numpy"]) == []
    assert imports.forbidden(["jax", "jax.numpy", "jaxlib.xla_client",
                              "flax.linen", "repro", "repro.core.defl",
                              "torch"]) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client", "repro",
        "repro.core.defl"]


def test_no_card_no_result():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run(
        [sys.executable, str(manifest.BENCH / "run.py"), "--workload",
         "mnist_paper.fleet16_int8", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, env=env,
        cwd=manifest.ROOT, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
