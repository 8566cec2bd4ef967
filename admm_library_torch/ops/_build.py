"""Build and load the package's CUDA kernels.

Each `csrc/*.cu` is compiled with nvcc for Hopper (sm_90a) into its own
shared library with a plain C interface, on first use, into
`admm_library_torch/_build/` (git-ignored). All sources are compiled
together, one nvcc process each. A library's file name carries a hash of
its source and the flags, so an edited source rebuilds and an unchanged
one loads at once. There is no fallback: a missing nvcc or a failed
build raises.
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


def library_path(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(src.name.encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> dict[str, tuple[Path, str]]:
    """Compile every source whose library does not exist yet, all nvcc
    processes at once.

    Returns {source stem: (library path, compiler output)}. verbose adds
    `-Xptxas -v` (registers, shared memory and spills per kernel), and
    rebuilds even when a library exists so that output is produced.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    done: dict[str, tuple[Path, str]] = {}
    jobs = []
    try:
        for src in sources():
            out = library_path(src)
            if out.exists() and not verbose:
                done[src.stem] = (out, "")
                continue
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS,
                   *(("-Xptxas", "-v") if verbose else ()),
                   "-o", tmp, str(src)]
            jobs.append((src.stem, out, tmp, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for stem, out, tmp, cmd, proc in jobs:
            log = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n"
                              f"{' '.join(cmd)}\n{log}")
                continue
            os.replace(tmp, out)      # atomic against a concurrent build
            done[stem] = (out, log)
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for _, _, tmp, _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return done


def load_library(name: str) -> ctypes.CDLL:
    """The shared library of `csrc/<name>.cu`, built on first use."""
    path = str(build()[name][0])
    if path not in _loaded:
        _loaded[path] = ctypes.CDLL(path)
    return _loaded[path]
