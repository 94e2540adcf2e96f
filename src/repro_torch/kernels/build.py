"""Build a kernel's CUDA source into a shared library at first use.

Each kernel is one `.cu` file with a plain `extern "C"` launcher,
compiled by `nvcc` for Hopper (sm_90a) into a library loaded with ctypes.
The library lands in a `build/` directory beside the kernel's `csrc/`
(listed in .gitignore), named by a hash of the source and the flags, so
an edited source never reuses a stale build.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Tuple

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """nvcc from PATH, else from CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found on PATH or at {path}")
    return str(path)


def library_path(source: Path) -> Path:
    """Where `source` is built: build/ beside its csrc/, named by a hash of
    the source and the flags."""
    source = Path(source).resolve()
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return source.parent.parent / "build" / f"lib{source.stem}-{digest}.so"


def load(source: Path) -> Tuple[ctypes.CDLL, str]:
    """(library, compiler log) for `source`, compiling it unless this
    source was built before (the log is then the one kept beside the
    library). Raises RuntimeError with nvcc's output when the build
    fails."""
    source = Path(source).resolve()
    lib_path = library_path(source)
    log_path = lib_path.with_suffix(".log")
    out_dir = lib_path.parent
    out_dir.mkdir(exist_ok=True)
    if lib_path.exists():
        log = (log_path.read_text() if log_path.exists()
               else "cached build")
    else:
        # Build under a temporary name, then rename: a concurrent or
        # interrupted build never leaves a half-written library behind.
        fd, tmp = tempfile.mkstemp(dir=out_dir, suffix=".so")
        os.close(fd)
        try:
            res = subprocess.run(
                [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(source)],
                capture_output=True, text=True, check=False)
            log = res.stdout + res.stderr
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed on {source}:\n{log}")
            log_path.write_text(log)
            os.replace(tmp, lib_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return ctypes.CDLL(str(lib_path)), log
