"""Build and load the package's CUDA kernels.

`csrc/*.cu` is compiled with nvcc for Hopper (sm_90a) into one shared
library with a plain C interface, on first use, into
`admm_library_torch/_build/` (git-ignored). The file name carries a
hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads at once. There is no fallback: a missing nvcc or a
failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
# No --use_fast_math: the approximate sqrt and division change the SOC
# projection's branches.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((home and os.path.join(home, "bin", "nvcc")),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of admm_library_torch are built from source on first use")


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libadmm_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> tuple[Path, str]:
    """Compile the kernels unless the library for these sources exists.

    Returns (library path, compiler output). verbose adds
    `-Xptxas -v` (registers, shared memory and spills per kernel), and
    rebuilds even when the library exists so that output is produced.
    """
    out = library_path()
    if out.exists() and not verbose:
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
           "-o", tmp, *map(str, sources())]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)          # atomic against a concurrent build
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, proc.stdout + proc.stderr


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    path = str(build()[0])
    if path not in _loaded:
        _loaded[path] = ctypes.CDLL(path)
    return _loaded[path]
