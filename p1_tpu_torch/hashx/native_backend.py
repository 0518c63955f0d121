"""Native hash backend: the C++ SHA-256d core via ctypes.

The port's copy of ``p1_tpu/hashx/native_backend.py``, registered (lazily)
as ``native`` in the port's own registry.  One C call scans a whole nonce
range with the midstate trick, on the SHA-NI extension when the host CPU
has it (runtime-dispatched inside the library) and on the portable scalar
compression otherwise.  Deterministic earliest hit: the same contract as
every other backend, so it slots into the miner, chain and node unchanged.
The library is ``native/sha256d.cpp`` + ``native/ed25519.cpp``, built by
``native_build``.  It runs on the host only: ``device`` exists so callers
that pass one get a clear refusal instead of a silent host run.
"""

from __future__ import annotations

import ctypes
import threading

from p1_tpu_torch.hashx.backend import HashBackend, SearchResult, register
from p1_tpu_torch.hashx.native_build import build_lib


def _load():
    lib = ctypes.CDLL(str(build_lib()))
    lib.p1_sha256d.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p]
    lib.p1_sha256d.restype = None
    lib.p1_search.argtypes = [ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint64, ctypes.c_uint32]
    lib.p1_search.restype = ctypes.c_longlong
    lib.p1_has_shani.argtypes = []
    lib.p1_has_shani.restype = ctypes.c_int
    lib.p1_force_scalar.argtypes = [ctypes.c_int]
    lib.p1_force_scalar.restype = None
    lib.p1_verify_chain.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint32, ctypes.c_int]
    lib.p1_verify_chain.restype = ctypes.c_longlong
    lib.p1_verify_chain_retarget.argtypes = [ctypes.c_char_p, ctypes.c_uint64] + [ctypes.c_uint32] * 4
    lib.p1_verify_chain_retarget.restype = ctypes.c_longlong
    return lib


def verify_header_chain(raw: bytes, n: int, difficulty: int, genesis_exempt: bool = True) -> int | None:
    """Native engine for chain replay (config 3): verify ``n`` contiguous
    80-byte headers in one C call — PoW, difficulty field, prev-hash
    linkage, exactly ``chain.replay.replay_host``'s rules.  Returns the
    first invalid index, or None when the whole chain is valid."""
    if len(raw) != 80 * n:
        raise ValueError(f"expected {80 * n} header bytes, got {len(raw)}")
    idx = _lib().p1_verify_chain(raw, n, difficulty, int(genesis_exempt))
    return None if idx < 0 else int(idx)


def verify_header_chain_retarget(raw: bytes, n: int, retarget) -> int | None:
    """Retargeting form of ``verify_header_chain``: the C engine
    recomputes the contextual difficulty schedule and enforces the
    timestamp rules (strict increase + forward cap, height-1 anchor
    exempt) — rule-for-rule ``replay_host(retarget=...)``.  The caller
    validates header 0 against the chain's genesis identity, exactly as
    the host path's callers do."""
    if len(raw) != 80 * n:
        raise ValueError(f"expected {80 * n} header bytes, got {len(raw)}")
    idx = _lib().p1_verify_chain_retarget(
        raw, n, retarget.window, retarget.spacing, retarget.max_adjust, retarget.max_step
    )
    return None if idx < 0 else int(idx)


_LIB = None
_LIB_LOCK = threading.Lock()


def _lib():
    """The loaded library (built on first use); raises ``NativeBuildError``
    without a toolchain, ``OSError`` if the object will not load."""
    global _LIB
    if _LIB is None:
        with _LIB_LOCK:
            if _LIB is None:
                _LIB = _load()
    return _LIB


@register("native")
class NativeBackend(HashBackend):
    """C++ SHA-256d search (SHA-NI when the host CPU has it)."""

    def __init__(self, device: str = "cpu"):
        if device != "cpu":
            raise ValueError(f"the native backend runs on the host only, not on {device!r}")
        self._lib = _lib()
        self.has_shani = bool(self._lib.p1_has_shani())

    def force_scalar(self, enable: bool) -> None:
        """Test hook: pin the portable scalar compression on/off."""
        self._lib.p1_force_scalar(int(enable))
        self.has_shani = bool(self._lib.p1_has_shani())

    def sha256d(self, data: bytes) -> bytes:
        out = ctypes.create_string_buffer(32)
        self._lib.p1_sha256d(data, len(data), out)
        return out.raw

    def search(self, header_prefix: bytes, nonce_start: int, count: int, difficulty: int) -> SearchResult:
        self._check_search_args(header_prefix, nonce_start, count, difficulty)
        hit = self._lib.p1_search(header_prefix, nonce_start, count, difficulty)
        if hit < 0:
            return SearchResult(None, count)
        return SearchResult(int(hit), int(hit) - nonce_start + 1)
