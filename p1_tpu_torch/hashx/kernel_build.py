"""Build the port's CUDA kernels (``csrc/*.cu`` of a package) on first use.

The card's counterpart of ``hashx/native_build.py`` (the host core):
``nvcc`` compiles each source into a shared library with a plain C
interface for Hopper (``sm_90a``), and ``ctypes`` loads it — no PyTorch
headers, so a build takes seconds.  A source is a file name in
``hashx/csrc`` (the default ``csrc``) or in another package's ``csrc``
directory, passed as ``csrc``.
Every library lands in ``build/p1_tpu_torch/`` beside the package
(``.gitignore`` lists ``build/``), named by a hash of the source, the
headers (``*.cuh``) of its ``csrc`` and the flags, so an edited source or
header rebuilds and an unchanged one loads; the ``-Xptxas -v`` report is
kept beside it (``.ptxas``).  Threads of one process that build one
source at once run one ``nvcc`` (a lock per library): the node's miner
thread and its validate lane may reach an unbuilt kernel together.
Builds from several processes race benignly: each writes a temporary file
of its own (named by process and thread) and renames it into place
atomically.  ``build_all`` starts one ``nvcc`` per source at once.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "p1_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)  # fmt: skip
_NVCC_TIMEOUT_S = 600

#: One lock per library path: ``build`` holds it from the existence check
#: to the rename.
_LOCKS: dict[pathlib.Path, threading.Lock] = {}
_LOCKS_GUARD = threading.Lock()


class KernelBuildError(RuntimeError):
    """A kernel source could not be compiled (no nvcc, or nvcc refused it)."""


@dataclasses.dataclass(frozen=True)
class BuiltKernel:
    """A compiled library and what its build reported."""

    path: pathlib.Path
    lib: ctypes.CDLL
    build_s: float  # 0.0 when the library was already built
    ptxas_log: str  # nvcc's -Xptxas -v report of the build that made it


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise KernelBuildError("nvcc not found on PATH or at /usr/local/cuda/bin")
    return nvcc


def library_path(source: str, csrc: pathlib.Path = CSRC) -> pathlib.Path:
    src = csrc / source
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(csrc.glob("*.cuh")):  # what the sources include
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}_{digest.hexdigest()[:16]}.so"


def _start(source: str, csrc: pathlib.Path):
    """Start ``nvcc`` for ``source`` unless its library exists: (library
    path, process or None, temporary output, command, start time)."""
    out = library_path(source, csrc)
    if out.exists():
        return out, None, None, None, 0.0
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp.{os.getpid()}.{threading.get_ident()}")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(csrc / source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return out, proc, tmp, cmd, time.perf_counter()


def _finish(out, proc, tmp, cmd, t0) -> BuiltKernel:
    build_s = 0.0
    report = out.with_suffix(".ptxas")
    if proc is not None:
        try:
            stdout, stderr = proc.communicate(timeout=_NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise KernelBuildError(f"nvcc timed out ({' '.join(cmd)})") from None
        build_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise KernelBuildError(f"nvcc failed ({' '.join(cmd)}):\n{stderr[-4000:]}")
        report.write_text(stdout + stderr)
        os.replace(tmp, out)
    log = report.read_text() if report.exists() else ""
    return BuiltKernel(out, ctypes.CDLL(str(out)), build_s, log)


def _lock(out: pathlib.Path) -> threading.Lock:
    with _LOCKS_GUARD:
        return _LOCKS.setdefault(out, threading.Lock())


def build(source: str, csrc: pathlib.Path = CSRC) -> BuiltKernel:
    """Compile ``csrc/<source>`` (if needed) and load it.  A thread that
    finds another building the same library waits for it and loads what
    it built."""
    with _lock(library_path(source, csrc)):
        return _finish(*_start(source, csrc))


def build_all(sources: list[tuple[str, pathlib.Path]]) -> list[BuiltKernel]:
    """Compile every ``(source, csrc)`` pair with all ``nvcc`` processes
    started together, then load each library; in the order given."""
    started = [_start(source, csrc) for source, csrc in sources]
    try:
        return [_finish(*s) for s in started]
    finally:
        for s in started:  # a failed build stops the rest with it
            if s[1] is not None and s[1].poll() is None:
                s[1].kill()
                s[1].communicate()
