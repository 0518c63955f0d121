"""Build the port's native host core (``p1_tpu_torch/native/*.cpp``) on demand.

The port's copy of ``p1_tpu/hashx/native_build.py``.  One shared object
carries both host engines: the SHA-256d miner/verifier core (``sha256d.cpp``,
runtime SHA-NI dispatch) and the Ed25519 verifier (``ed25519.cpp``,
``__int128`` radix-2⁵¹ field arithmetic).  The first consumer
(``get_backend("native")``, ``chain.replay_native`` or the first signature
rung resolution in ``core/keys.py``) pays one ``g++`` run; everything after
that loads the built object.  The C ABI and ``ctypes`` are the whole
binding layer.

The object lands in the port's build directory, ``build/p1_tpu_torch/``
(``kernel_build.BUILD_DIR``, which ``.gitignore`` lists), named by a hash
of both sources and the flags, so an edited source rebuilds.  It never
reads the JAX package's cache (``~/.cache/p1_tpu``, ``P1_NATIVE_CACHE``):
the port loads only what it built from its own sources.  Threads of one
process that build at once run one ``g++`` (``kernel_build``'s lock per
library path: a node's miner thread and its validate lane may both reach
it first); builds from several processes race benignly, each writing a
temporary file of its own (named by process and thread) and renaming it
into place atomically.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import subprocess
import threading

from p1_tpu_torch.hashx import kernel_build

NATIVE_DIR = pathlib.Path(__file__).resolve().parent.parent / "native"
SOURCES = (
    NATIVE_DIR / "sha256d.cpp",
    NATIVE_DIR / "ed25519.cpp",
)
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-fno-exceptions")
_CXX_TIMEOUT_S = 120


class NativeBuildError(RuntimeError):
    """The native core could not be compiled (missing toolchain, bad env)."""


def library_path() -> pathlib.Path:
    """Where the library of the current sources lives (built or not)."""
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return kernel_build.BUILD_DIR / f"p1native_{h.hexdigest()[:16]}.so"


def build_lib(force: bool = False) -> pathlib.Path:
    """Compile (if needed) and return the shared library's path."""
    out = library_path()
    with kernel_build._lock(out):
        if out.exists() and not force:
            return out
        out.parent.mkdir(parents=True, exist_ok=True)
        cxx = os.environ.get("CXX", "g++")
        tmp = out.with_suffix(f".tmp.{os.getpid()}.{threading.get_ident()}")
        cmd = [cxx, *CXX_FLAGS, *[str(src) for src in SOURCES], "-o", str(tmp)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=_CXX_TIMEOUT_S)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise NativeBuildError(f"cannot run {cxx}: {e}") from e
        if proc.returncode != 0:
            raise NativeBuildError(f"native build failed ({' '.join(cmd)}):\n{proc.stderr[-2000:]}")
        os.replace(tmp, out)
        return out
