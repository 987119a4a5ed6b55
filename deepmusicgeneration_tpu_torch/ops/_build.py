"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. On first use it is compiled
with ``nvcc`` for ``sm_90a`` into a shared library under ``ops/_build/``
(listed in ``.gitignore``), named by a hash of the source and of the shared
headers ``csrc/*.cuh``, and loaded with ``ctypes``. Nothing is built or
loaded when a module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).with_name("csrc")
# every csrc/<name>.cu the port builds
SOURCES = ("slab_decode", "multirow_decode", "flash_prefill", "s2s_slab", "flash_train",
           "flash_mt", "flash_encoder", "s2s_fused")
BUILD_DIR = Path(__file__).with_name("_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME: the CUDA "
                       "toolkit is needed to build the port's kernels")


def library_path(name: str) -> Path:
    """Where the shared library for ``csrc/<name>.cu`` goes."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library exists; returns the path.

    The compiler's output (``-Xptxas -v``: registers, shared memory, spills
    per kernel) is kept beside the library as ``.log``."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``'s library once per process."""
    return ctypes.CDLL(str(build(name)))
