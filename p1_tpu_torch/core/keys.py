"""Ed25519 account keys: ownership for the account model.

The port's copy of ``p1_tpu/core/keys.py``: the same account ids, key
files, signatures (RFC 8032 signing is deterministic, so a key signs the
same 64 bytes in both packages), backend ladder names, ``VerifyStats`` key
set, negative memo and ``verify_batch`` / ``first_invalid`` contract.
What differs is which rungs exist and where ``auto`` goes:

- **``device``** (what ``auto`` resolves to) routes every batch of at
  least ``BATCH_MIN`` signatures to ``hashx/ed25519_msm.verify_batch_device``:
  the subgroup gate and the multi-scalar multiplication in the CUDA kernel
  ``hashx/csrc/ed25519_msm.cu`` on the card.  Unlike ``p1_tpu``, which
  drops back to the host ladder when its device program fails to load,
  the port does not degrade: with no card the batch raises.  The plain
  PyTorch version runs only when the caller asks for it with
  ``set_sig_backend("device", device="cpu")``.  Serial verifies (and
  batches under ``BATCH_MIN``) take the rung beneath: ``native`` where
  it loads, else ``pure-python``.
- **``native``** (``core/_ed25519_native.py`` + ``native/ed25519.cpp``,
  the JAX package's C++ host engine, built with ``g++`` on first use):
  the serial rung wherever it builds — mempool admission, ``first_invalid``'s
  serial settling, small batches.  Pinned (``set_sig_backend("native")``),
  it also runs every batch on the host (its subgroup-gated Pippenger
  MSM); without a toolchain a pin warns once and resolves ``auto``.
- **``pure-python``** (``core/_ed25519.py``): the serial rung on a host
  where the native engine does not build, and the batch rung only when
  forced (``set_sig_backend("fallback")`` or ``P1_SIG_BACKEND=pure-python``).
- **``cryptography``**: the port imports ``torch``, numpy and the standard
  library only, so the wheel's rung is unavailable here, as it is in
  ``p1_tpu`` on a host without the wheel.  Asking for it warns once and
  resolves ``auto``.
- The JAX package's worker pool is carried for the native rung only:
  ctypes releases the GIL around a native batch call, so a pinned
  ``native`` batch's chunks go to a thread pool when ``verify_workers()``
  is above 1 (the node sets it from ``--verify-workers`` /
  ``--pipeline-workers``; unpinned it is 1).  The pure-Python batch holds
  the GIL for its whole MSM and the device rung orders its launches on
  the card's stream, so neither runs a pool.

Semantics, shared by every rung:

- An **account id is a key fingerprint**: ``p1`` + first 16 hex chars of
  SHA-256(public key).  Any string can *receive* coins, but only a
  transaction carrying the matching public key and a valid Ed25519
  signature can *spend* from a fingerprint account (chain/validate.py).
- ``verify_batch(triples)`` — True only if every triple is serially
  valid.  The device, native and pure-Python batches compute one
  subgroup-gated random-linear-combination equation per chunk of
  ``BATCH_CHUNK``; batch FALSE is not yet a verdict (the gate also
  rejects torsion-crafted inputs the serial equation tolerates).
- ``first_invalid(triples)`` — serial-confirming locator used when a
  batch fails: sub-batches that pass are skipped (acceptance implies
  serial validity), everything else is settled by ``verify`` itself, so
  the REJECTED signature (and the error text consensus reports) — or
  the conclusion that there is none — is byte-identical to the serial
  path's.
- Positive results are memoized one level up (core/sigcache.py, keyed by
  txid); ``verify`` keeps only a small bounded NEGATIVE memo, and
  ``STATS`` counts how work reached a backend (serial vs batched, and by
  rung).
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import hashlib
import json
import logging
import os
import threading

from p1_tpu_torch.core import _ed25519 as _py_ed25519
from p1_tpu_torch.core import _ed25519_native as _native_ed25519

#: The ``cryptography`` wheel's rung: never available in the port (it
#: imports torch, numpy and the standard library only).
HAVE_CRYPTOGRAPHY = False

#: Account-id prefix: distinguishes spendable (key-backed) accounts from
#: free-form receive-only ids at a glance.
ACCOUNT_PREFIX = "p1"
_FINGERPRINT_HEX = 16

PUBKEY_SIZE = 32
SIG_SIZE = 64
SEED_SIZE = 32


@functools.lru_cache(maxsize=65_536)
def account_id(pubkey: bytes) -> str:
    """The spendable account id owned by ``pubkey``.  Memoized: every
    ``verify_signature`` call derives the sender's fingerprint — pure
    function, bounded cache."""
    if len(pubkey) != PUBKEY_SIZE:
        raise ValueError(f"public key must be {PUBKEY_SIZE} bytes")
    return ACCOUNT_PREFIX + hashlib.sha256(pubkey).hexdigest()[:_FINGERPRINT_HEX]


def account_id_or_none(pubkey: bytes) -> str | None:
    """``account_id`` that maps a malformed key to None (never a valid
    sender id) instead of raising — for use in validation predicates."""
    return account_id(pubkey) if len(pubkey) == PUBKEY_SIZE else None


class Keypair:
    """One Ed25519 identity: seed -> (private, public, account id)."""

    def __init__(self, seed: bytes):
        if len(seed) != SEED_SIZE:
            raise ValueError(f"seed must be {SEED_SIZE} bytes")
        self._seed = seed
        self.pubkey: bytes = _py_ed25519.public_key(seed)
        self.account: str = account_id(self.pubkey)

    @classmethod
    def generate(cls) -> "Keypair":
        return cls(os.urandom(SEED_SIZE))

    @classmethod
    def from_seed_text(cls, text: str) -> "Keypair":
        """Deterministic keypair from any text label (tests/tools only —
        the seed is the SHA-256 of the label, so the 'secret' is public)."""
        return cls(hashlib.sha256(text.encode("utf-8")).digest())

    def sign(self, message: bytes) -> bytes:
        # Ed25519 signing is deterministic (RFC 8032): the same bytes as
        # any other implementation's.
        return _py_ed25519.sign(self._seed, message)

    # -- persistence -------------------------------------------------------

    def save(self, path: str, overwrite: bool = False) -> None:
        """Write the key as JSON {seed_hex, pubkey_hex, account} with
        owner-only permissions (it contains the private seed).

        Refuses to clobber an existing file unless ``overwrite`` — a seed
        exists nowhere else, so silently truncating one would make every
        coin its fingerprint holds permanently unspendable.
        """
        payload = json.dumps(
            {
                "seed_hex": self._seed.hex(),
                "pubkey_hex": self.pubkey.hex(),
                "account": self.account,
            },
            indent=2,
        )
        flags = os.O_WRONLY | os.O_CREAT | (os.O_TRUNC if overwrite else os.O_EXCL)
        fd = os.open(path, flags, 0o600)
        # os.open's mode only applies at creation — an overwrite of a
        # pre-existing world-readable file must still end up owner-only.
        os.fchmod(fd, 0o600)
        with os.fdopen(fd, "w") as f:
            f.write(payload + "\n")

    @classmethod
    def load(cls, path: str) -> "Keypair":
        with open(path) as f:
            data = json.load(f)
        kp = cls(bytes.fromhex(data["seed_hex"]))
        if data.get("account") not in (None, kp.account):
            raise ValueError(
                f"key file {path} claims account {data['account']} but its "
                f"seed derives {kp.account}"
            )
        return kp


log = logging.getLogger(__name__)

#: Every signature backend the ladder names, in ladder order (the JAX
#: package's key set, so ``STATS.backends`` has the same keys).
#: ``device`` is batch-only: serial work under it takes ``native`` (or
#: ``pure-python`` where the native engine does not build).
SIG_BACKENDS = ("cryptography", "native", "pure-python", "device")

#: Explicit backend override (``set_sig_backend``); None = auto (the
#: ``device`` rung).
_sig_backend: str | None = None
#: Where the ``device`` rung runs: "cuda" (the kernel) or "cpu" (the
#: plain PyTorch version, only when asked for).
_sig_device: str = "cuda"
#: Memoized auto/override resolution.
_resolved: str | None = None


def set_sig_backend(name: str | None, *, device: str | None = None) -> None:
    """Pin the signature backend: ``auto``/None and ``device`` route
    BATCHES through ``hashx/ed25519_msm.verify_batch_device`` (serial
    verifies take the native rung, or pure Python without a toolchain),
    ``native`` runs batches and serial verifies on the C++ host engine
    (one warning, then ``auto``, where it does not build),
    ``fallback``/``pure-python`` force the pure-Python tier,
    ``cryptography`` asks for a rung the port does not have (one warning,
    then ``auto``).  ``device`` is
    where the ``device`` rung runs: "cuda" (the default: the kernel, which
    raises without a card) or "cpu" (the plain PyTorch version); it is
    refused for any other rung.  Unknown names raise (a typo must not
    silently change the validation cost model)."""
    global _sig_backend, _sig_device, _resolved
    if name in (None, "", "auto"):
        want = None
    elif name == "fallback":
        want = "pure-python"
    elif name in SIG_BACKENDS:
        want = name
    else:
        raise ValueError(
            f"unknown signature backend {name!r} "
            f"(choose from auto/fallback/{'/'.join(SIG_BACKENDS)})"
        )
    if device is not None and want not in (None, "device"):
        raise ValueError("device= applies to the 'device' signature backend only")
    if device not in (None, "cuda", "cpu"):
        raise ValueError(f"the device rung runs on 'cuda' or 'cpu', not {device!r}")
    _sig_backend = want
    _sig_device = device or "cuda"
    _resolved = None


def backend() -> str:
    """The ACTIVE batch backend name, resolved lazily and memoized:
    ``device`` unless ``native`` or ``pure-python`` is pinned.  Serial
    dispatch under ``device`` takes the rung beneath (``_serial_backend``).
    Resolving a ``native`` pin may build the library once (``g++``); a
    failed build is remembered by ``_ed25519_native``."""
    global _resolved
    if _resolved is not None:
        return _resolved
    want = _sig_backend
    if want is None:
        want = os.environ.get("P1_SIG_BACKEND") or "auto"
        if want == "fallback":
            want = "pure-python"
        if want not in SIG_BACKENDS and want != "auto":
            log.warning("P1_SIG_BACKEND=%r unknown; using auto", want)
            want = "auto"
    if want == "cryptography" and not HAVE_CRYPTOGRAPHY:
        log.warning(
            "signature backend 'cryptography' requested but the port does not "
            "carry the wheel; resolving auto (the device rung) instead"
        )
        want = "auto"
    if want == "native" and not _native_ed25519.available():
        log.warning(
            "signature backend 'native' requested but the engine did not "
            "load (no compiler / build failure); resolving auto (the device "
            "rung) instead"
        )
        want = "auto"
    if want == "auto":
        want = "device"
    _resolved = want
    return want


def backend_label() -> str:
    """The backend name WITHOUT resolving: the memoized rung if any
    verification already ran, else the pin/env request verbatim.

    Status planes read this instead of ``backend()`` because resolution
    may probe the native rung — a ctypes load that can run ``g++`` once —
    and a GETSTATUS served from the node's event loop must never be the
    call that pays it."""
    if _resolved is not None:
        return _resolved
    if _sig_backend is not None:
        return _sig_backend
    want = os.environ.get("P1_SIG_BACKEND") or "auto"
    return want if want in SIG_BACKENDS else "auto"


def _serial_backend() -> str:
    """Where one-at-a-time verifies go: the active backend, except that
    ``device`` is batch-only and serial work takes the ladder beneath
    (native where it loads, else pure Python)."""
    b = backend()
    if b != "device":
        return b
    return "native" if _native_ed25519.available() else "pure-python"


@dataclasses.dataclass
class VerifyStats:
    """Process-wide backend-call accounting.  ``serial`` counts
    signatures that reached a backend one at a time, ``batched`` the ones
    that went through ``verify_batch``; ``backends`` splits the same
    signature counts by the rung that did the work — the key set is
    FIXED (the JAX package's).  ``pool_dispatches`` counts native batches
    whose chunks went to the worker pool."""

    serial: int = 0
    batched: int = 0
    batches: int = 0
    pool_dispatches: int = 0
    backends: dict = dataclasses.field(
        default_factory=lambda: {name: 0 for name in SIG_BACKENDS}
    )

    def reset(self) -> None:
        self.serial = self.batched = self.batches = self.pool_dispatches = 0
        for name in self.backends:
            self.backends[name] = 0


STATS = VerifyStats()


def _backend_verify(pubkey: bytes, sig: bytes, message: bytes) -> bool:
    """THE single-signature backend dispatch — every serial verify in
    the process funnels through here (tests spy on it)."""
    STATS.serial += 1
    which = _serial_backend()
    STATS.backends[which] += 1
    if which == "native":
        return _native_ed25519.verify(pubkey, sig, message)
    return _py_ed25519.verify(pubkey, sig, message)


#: Bounded negative-verify memo.  Failures only: ``verify`` is a
#: deterministic function of the three byte strings, so memoizing a FALSE
#: can never change an outcome, and the key is a salted digest of the
#: exact bytes so an entry can't shadow any other (pubkey, sig, message).
#: Consulted on the serial paths only.
_NEG_CACHE_MAX = 4096
_neg_salt = os.urandom(16)
_neg_cache: collections.OrderedDict = collections.OrderedDict()


def _neg_key(pubkey: bytes, sig: bytes, message: bytes) -> bytes:
    h = hashlib.sha256(_neg_salt)
    h.update(pubkey)
    h.update(sig)
    h.update(message)
    return h.digest()[:16]


def verify(pubkey: bytes, sig: bytes, message: bytes) -> bool:
    """True iff ``sig`` is ``pubkey``'s valid Ed25519 signature over
    ``message``.  Known-bad triples are absorbed by the bounded negative
    memo — a memo hit touches no STATS counter because no backend work
    happened."""
    if len(pubkey) != PUBKEY_SIZE or len(sig) != SIG_SIZE:
        return False
    key = _neg_key(pubkey, sig, message)
    if key in _neg_cache:
        _neg_cache.move_to_end(key)
        return False
    ok = _backend_verify(pubkey, sig, message)
    if not ok:
        _neg_cache[key] = None
        while len(_neg_cache) > _NEG_CACHE_MAX:
            _neg_cache.popitem(last=False)
    return ok


# -- batch verification ----------------------------------------------------

#: Below this many cache-missing signatures a batch call just runs
#: serially: the batch setup costs more than it saves on a handful of
#: signatures.  A constant, NOT configuration — validation behavior must
#: not vary with local tuning.
BATCH_MIN = 8

#: Signatures per chunk: one multi-scalar multiplication (one kernel
#: launch under the ``device`` rung) each.  Bounds the per-chunk memory.
BATCH_CHUNK = 1024

_fallback_warned = False

_workers_lock = threading.Lock()
#: Explicit ``set_verify_workers`` pin (None = unpinned).
_workers: int | None = None
_executor = None
_executor_size = 0


def set_verify_workers(n: int | None) -> None:
    """Pin the verification worker count (None/0 = unpinned).  Only the
    native rung's batches use it (module docstring); an existing pool of
    a different size is replaced on the next batch."""
    global _workers
    _workers = int(n) if n else None


def verify_workers() -> int:
    """The pinned worker count, else 1: unpinned, every rung verifies on
    one thread (serially, or one stream of the card)."""
    return max(1, _workers) if _workers is not None else 1


def shutdown_verify_pool(cancel: bool = False) -> None:
    """Tear down the lazy worker pool (tests, interpreter exit).  Safe
    to call any time: in-flight batches finish their chunks in the
    calling thread when their futures are cancelled."""
    global _executor, _executor_size
    with _workers_lock:
        ex, _executor, _executor_size = _executor, None, 0
    if ex is not None:
        ex.shutdown(wait=not cancel, cancel_futures=cancel)


def _pool(size: int):
    """The shared verification executor, (re)built at ``size``."""
    global _executor, _executor_size
    with _workers_lock:
        old = None
        if _executor is None or _executor_size != size:
            from concurrent.futures import ThreadPoolExecutor

            old = _executor
            _executor = ThreadPoolExecutor(max_workers=size, thread_name_prefix="sigverify")
            _executor_size = size
        pool = _executor
    if old is not None:
        old.shutdown(wait=False, cancel_futures=True)
    return pool


def _use_pool(n_chunks: int) -> bool:
    """Whether a batch's chunks go to the thread pool: native batches of
    more than one chunk when more than one worker is set (ctypes releases
    the GIL around each chunk's call).  Tests monkeypatch this."""
    return backend() == "native" and n_chunks > 1 and verify_workers() > 1


def _batch_worker():
    """``(backend_name, callable)`` one batch CHUNK runs through —
    resolved per batch so ``set_sig_backend`` takes effect immediately.
    The ``device`` worker is not guarded: a missing card or a kernel that
    fails to build or launch raises out of the batch."""
    b = backend()
    if b == "device":
        from p1_tpu_torch.hashx import ed25519_msm

        return "device", functools.partial(
            ed25519_msm.verify_batch_device, device=_sig_device
        )
    if b == "native":
        return "native", _native_ed25519.verify_batch
    return "pure-python", _py_ed25519.verify_batch


def _warn_fallback_once() -> None:
    """One-time cost-model warning when batches run on the pure-Python
    rung (only ever forced in the port), naming its measured cost and the
    rungs that would be faster, so numbers taken on it are never read as
    regressions."""
    global _fallback_warned
    if _fallback_warned:
        return
    _fallback_warned = True
    from p1_tpu_torch.hashx.perf_record import RECORDED_SIG_NATIVE_MS

    log.warning(
        "pure-Python Ed25519 fallback was FORCED via set_sig_backend/"
        "P1_SIG_BACKEND for batch verification: ~%.1f ms/signature serial, "
        "~%.2f ms batched (recorded on the card's host), against ~%.3f "
        "ms/signature for a 1,024 batch on the 'native' rung, the C++ host "
        "engine (recorded).  The 'device' rung (the default) runs batches "
        "on the card; the 'cryptography' rung is not in the port.  Numbers "
        "measured on this rung are NOT comparable to the records in PERF.md.",
        _py_ed25519.RECORDED_SERIAL_MS,
        _py_ed25519.RECORDED_BATCH_MS,
        RECORDED_SIG_NATIVE_MS,
    )


def verify_batch(triples) -> bool:
    """True only if EVERY (pubkey, sig, message) triple is serially
    valid (batch acceptance implies serial acceptance).

    False means "not proven": usually a bad signature, but the gated
    batches also reject torsion-crafted inputs the serial equation
    tolerates (_ed25519.py's docstring) — use ``first_invalid`` to
    settle a failed batch with serial-identical semantics.  Dispatch
    (``_batch_worker``): device → ``verify_batch_device`` per chunk, one
    kernel launch each; native → the C++ gated batch per chunk, on the
    worker pool when ``_use_pool``; pure-Python → the host MSM per chunk,
    in the calling thread.
    """
    triples = list(triples)
    if not triples:
        return True
    STATS.batches += 1
    STATS.batched += len(triples)
    which, worker = _batch_worker()
    if which == "pure-python":
        _warn_fallback_once()
    if len(triples) < BATCH_MIN:
        STATS.batched -= len(triples)  # accounted as serial below
        return _verify_serial_counted(triples)
    STATS.backends[which] += len(triples)
    chunks = [triples[i : i + BATCH_CHUNK] for i in range(0, len(triples), BATCH_CHUNK)]
    if not _use_pool(len(chunks)):
        return all(worker(chunk) for chunk in chunks)
    from concurrent.futures import CancelledError

    STATS.pool_dispatches += 1
    pool = _pool(verify_workers())
    futures = []
    for chunk in chunks:
        try:
            futures.append(pool.submit(worker, chunk))
        except RuntimeError:  # pool shut down mid-submission
            futures.append(None)
    ok = True
    for fut, chunk in zip(futures, chunks):
        if fut is None:
            ok &= worker(chunk)
            continue
        try:
            ok &= fut.result()
        except (CancelledError, RuntimeError):
            # Pool torn down mid-batch: finish in this thread — the answer
            # must not depend on the executor's lifecycle.
            ok &= worker(chunk)
    return ok


def _verify_serial_counted(triples) -> bool:
    for pubkey, sig, message in triples:
        if not verify(pubkey, sig, message):
            return False
    return True


def first_invalid(triples) -> int | None:
    """Index of the FIRST triple serial verification rejects, or None.

    None after a failed ``verify_batch`` is a legitimate answer — batch
    False does not imply a serial reject (the subgroup gate also turns
    away torsion-crafted inputs the serial equation tolerates), so
    callers must treat None as "all serially valid".  Left-first scan: a
    sub-batch that PASSES proves all its members serially valid and is
    skipped wholesale; a sub-batch that fails is split, and windows of ≤
    BATCH_MIN are settled one by one with ``verify`` itself.
    """
    triples = list(triples)

    def scan(lo: int, hi: int, known_failed: bool) -> int | None:
        if hi - lo <= BATCH_MIN:
            for i in range(lo, hi):
                if not verify(*triples[i]):
                    return i
            return None
        if not known_failed and verify_batch(triples[lo:hi]):
            return None
        mid = (lo + hi) // 2
        found = scan(lo, mid, False)
        return found if found is not None else scan(mid, hi, False)

    # Callers reach here right after a failed full batch: don't re-run it.
    return scan(0, len(triples), True)
