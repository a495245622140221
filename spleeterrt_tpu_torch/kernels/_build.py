"""Build the CUDA kernels of csrc/ with nvcc at first use and load them.

One shared library with a plain C interface, compiled for Hopper
(`sm_90a`) and loaded with ctypes. Each `csrc/*.cu` compiles in its own
nvcc process, all started together, and one more nvcc links the objects.
The library name carries a hash of the sources and flags, so an edited
source builds anew and a stale library is never loaded. The build happens
in a temporary directory and the library is renamed into place, so
concurrent first uses do not race. Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [shutil.which("nvcc")]
    for root in (cuda_home, "/usr/local/cuda"):
        if root:
            candidates.append(os.path.join(root, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built from csrc/ with the CUDA "
        "toolkit (put nvcc on PATH or set CUDA_HOME)"
    )


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libspleeterrt_kernels_{h.hexdigest()[:16]}.so"


def _run(cmd: list[str]) -> str:
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(
            f"nvcc failed with code {res.returncode}:\n{' '.join(cmd)}\n"
            f"{res.stdout}{res.stderr}"
        )
    return res.stdout + res.stderr


def build() -> Path:
    """Compile csrc/*.cu into the library unless it exists; returns its
    path. nvcc's report (registers, shared memory, spills) is kept beside
    it as `<name>.log`."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        sources = sorted(CSRC.glob("*.cu"))
        objects = [os.path.join(tmp, f"{src.stem}.o") for src in sources]
        with ThreadPoolExecutor(max_workers=len(sources)) as pool:
            logs = list(pool.map(
                _run,
                [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                 for src, obj in zip(sources, objects)],
            ))
        lib = os.path.join(tmp, out.name)
        logs.append(_run([nvcc, *ARCH_FLAGS, "-shared", "-o", lib, *objects]))
        out.with_suffix(".log").write_text("".join(logs))
        os.replace(lib, out)
    return out


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed and load the library (once per process)."""
    return ctypes.CDLL(str(build()))
