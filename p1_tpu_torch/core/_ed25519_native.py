"""Native Ed25519 — the ctypes seam over ``native/ed25519.cpp``.

The port's copy of ``p1_tpu/core/_ed25519_native.py``: the ``native`` rung
of the signature ladder (``core/keys.py``).  When a C++ toolchain exists
(or the library is already built), this module loads the shared object
``hashx/native_build.py`` compiles from ``p1_tpu_torch/native/`` and
exposes the SAME call surface as the pure-Python rung (``verify`` /
``verify_batch``), with the same semantics:

- ``verify`` is the serial cofactorless RFC 8032 check, bit-identical
  to ``core/_ed25519.py::verify`` on every input — length checks,
  s < q range check, non-canonical-y rejection, and k reduced mod q
  happen HERE (CPython's hashlib/long arithmetic is already C-speed);
  only the curve arithmetic crosses the ctypes boundary.
- ``verify_batch`` is the subgroup-gated random-linear-combination
  batch: every A (deduplicated per call) and every R is exactly gated
  ([q]·P == identity) in C, then one Pippenger MSM settles the
  combination — batch acceptance implies serial acceptance (2⁻¹²⁸),
  batch False is NOT a serial verdict, exactly the
  ``core/_ed25519.py::verify_batch`` contract.  The per-batch random
  coefficients come from ``secrets`` on the Python side, so the C
  engine is deterministic and RNG-free.

Degradation is memoized: if the toolchain is missing, the build fails, or
the library will not load or fails its self-check, ``available()`` turns
False for the life of the process (one log line, no retry storm) and
``keys.py`` keeps the pure-Python rung for serial work.  Nothing in this
module raises at import.
"""

from __future__ import annotations

import ctypes
import logging
import secrets
import threading

from p1_tpu_torch.core._ed25519 import _Q, _sha512

log = logging.getLogger(__name__)

_LIB = None
_LOAD_FAILED = False
_LOAD_LOCK = threading.Lock()


def _bind(lib) -> None:
    lib.p1_ed25519_impl.argtypes = []
    lib.p1_ed25519_impl.restype = ctypes.c_char_p
    lib.p1_ed25519_verify.argtypes = [ctypes.c_char_p] * 4
    lib.p1_ed25519_verify.restype = ctypes.c_int
    lib.p1_ed25519_in_subgroup.argtypes = [ctypes.c_char_p]
    lib.p1_ed25519_in_subgroup.restype = ctypes.c_int
    lib.p1_ed25519_batch.argtypes = [
        ctypes.c_char_p,
        ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_uint64,
    ]
    lib.p1_ed25519_batch.restype = ctypes.c_int


def load():
    """The loaded shared library, or None (memoized either way).

    A first call on a cold build directory pays one ``g++`` run
    (``hashx/native_build.py``); every failure mode — no compiler, build
    error, unloadable object — is caught, logged once, and remembered, so
    a compiler-less image costs one attempt.  Threads that call at once
    wait for one load.
    """
    global _LIB, _LOAD_FAILED
    if _LIB is not None or _LOAD_FAILED:
        return _LIB
    with _LOAD_LOCK:
        if _LIB is not None or _LOAD_FAILED:
            return _LIB
        try:
            from p1_tpu_torch.hashx.native_build import build_lib

            lib = ctypes.CDLL(str(build_lib()))
            _bind(lib)
            # One end-to-end probe before trusting the object: a known-good
            # RFC 8032-shaped check must pass, or the build is treated as
            # absent (a half-linked or ABI-drifted library must never
            # become the consensus backend).
            if not _selfcheck(lib):
                raise OSError("native ed25519 self-check failed")
            _LIB = lib
        except Exception as exc:  # NativeBuildError, OSError, AttributeError
            _LOAD_FAILED = True
            log.info("native Ed25519 engine unavailable (%s); using fallback", exc)
            return None
    return _LIB


def _selfcheck(lib) -> bool:
    from p1_tpu_torch.core import _ed25519 as _py

    seed = b"\x00" * 32
    pub = _py.public_key(seed)
    sig = _py.sign(seed, b"p1-native-selfcheck")
    k = int.from_bytes(_sha512(sig[:32] + pub + b"p1-native-selfcheck"), "little") % _Q
    good = lib.p1_ed25519_verify(pub, sig[:32], sig[32:], k.to_bytes(32, "little"))
    bad = lib.p1_ed25519_verify(pub, sig[:32], (_Q - 1).to_bytes(32, "little"), k.to_bytes(32, "little"))
    return good == 1 and bad == 0


def available() -> bool:
    return load() is not None


def impl() -> str | None:
    """The C engine's arithmetic tag (telemetry), or None if absent."""
    lib = load()
    return lib.p1_ed25519_impl().decode() if lib is not None else None


def _loaded():
    lib = load()
    if lib is None:
        raise RuntimeError("native ed25519 engine not loaded")
    return lib


def in_subgroup(enc: bytes) -> bool | None:
    """Exact prime-subgroup gate on one compressed point — the C
    engine's answer (test hook; None = undecodable)."""
    r = _loaded().p1_ed25519_in_subgroup(bytes(enc))
    return None if r < 0 else bool(r)


def verify(pubkey: bytes, sig: bytes, message: bytes) -> bool:
    """Serial cofactorless verification — ``_ed25519.verify`` semantics,
    native curve arithmetic.  Raises if the engine did not load."""
    lib = _loaded()
    if len(pubkey) != 32 or len(sig) != 64:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= _Q:
        return False
    k = int.from_bytes(_sha512(sig[:32] + pubkey + message), "little") % _Q
    return bool(lib.p1_ed25519_verify(bytes(pubkey), sig[:32], sig[32:], k.to_bytes(32, "little")))


def verify_batch(triples) -> bool:
    """Subgroup-gated batch verification — ``_ed25519.verify_batch``
    semantics, native gates + Pippenger MSM.

    The Python side does what CPython is already fast at: length and
    s-range checks, SHA-512 challenges, mod-q scalar products, the 128-bit
    random coefficients, and pubkey deduplication (the C engine gates each
    UNIQUE pubkey once — block windows repeat senders).
    """
    lib = _loaded()
    triples = list(triples)
    n = len(triples)
    if n == 0:
        return True
    uniq: dict[bytes, int] = {}
    idx = []
    r_encs = []
    zr = []
    za = []
    s_total = 0
    for pubkey, sig, message in triples:
        if len(pubkey) != 32 or len(sig) != 64:
            return False
        s = int.from_bytes(sig[32:], "little")
        if s >= _Q:
            return False
        pubkey = bytes(pubkey)
        slot = uniq.setdefault(pubkey, len(uniq))
        idx.append(slot)
        k = int.from_bytes(_sha512(sig[:32] + pubkey + message), "little") % _Q
        # Unpredictable per-batch coefficients: an adversary must not
        # be able to craft signatures whose errors cancel in the sum.
        z = secrets.randbits(128) | 1
        s_total = (s_total + z * s) % _Q
        r_encs.append(sig[:32])
        zr.append(z.to_bytes(32, "little"))
        # z·k mod q is exact only because the C engine PROVES A has
        # order q before the term enters the sum (gate-first contract).
        za.append((z * k % _Q).to_bytes(32, "little"))
    sb = ((_Q - s_total) % _Q).to_bytes(32, "little")
    pub_idx = (ctypes.c_uint32 * n)(*idx)
    return bool(
        lib.p1_ed25519_batch(
            b"".join(uniq), len(uniq), pub_idx, b"".join(r_encs), b"".join(zr), b"".join(za), sb, n
        )
    )
