"""Build the port's CUDA kernels (``hashx/csrc/*.cu``) on first use.

The role of ``p1_tpu/hashx/native_build.py`` for the card: ``nvcc`` compiles
each source into a shared library with a plain C interface for Hopper
(``sm_90a``), and ``ctypes`` loads it — no PyTorch headers, so a build
takes seconds.  The library lands in ``build/p1_tpu_torch/`` beside the
package (``.gitignore`` lists ``build/``), named by a hash of the source
and the flags, so an edited source rebuilds and an unchanged one loads.
Concurrent builds race benignly through an atomic rename.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "p1_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)  # fmt: skip


class KernelBuildError(RuntimeError):
    """A kernel source could not be compiled (no nvcc, or nvcc refused it)."""


@dataclasses.dataclass(frozen=True)
class BuiltKernel:
    """A compiled library and what its build reported."""

    path: pathlib.Path
    lib: ctypes.CDLL
    build_s: float  # 0.0 when the library was already built
    ptxas_log: str  # nvcc's -Xptxas -v report, "" when already built


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise KernelBuildError("nvcc not found on PATH or at /usr/local/cuda/bin")
    return nvcc


def library_path(source: str) -> pathlib.Path:
    src = CSRC / source
    tag = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}_{tag}.so"


def build(source: str) -> BuiltKernel:
    """Compile ``csrc/<source>`` (if needed) and load it."""
    out = library_path(source)
    build_s, log = 0.0, ""
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".tmp.{os.getpid()}")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        build_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise KernelBuildError(
                f"nvcc failed ({' '.join(cmd)}):\n{proc.stderr[-4000:]}"
            )
        log = proc.stdout + proc.stderr
        os.replace(tmp, out)
    return BuiltKernel(out, ctypes.CDLL(str(out)), build_s, log)
