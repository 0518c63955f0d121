"""Chain replay: generate and verify long header chains (benchmark config 3).

The port of ``p1_tpu/chain/replay.py``: "chain replay: verify 10k-block
header chain (hash-only, no mining)".  ``generate_headers`` mines the
chain through the port's ``Miner`` (on the card by default);
``replay_host`` is the hashlib oracle, retarget rules included;
``replay_native`` runs the same rules in one call of the C++ host engine
(``native/sha256d.cpp``, SHA-NI where the CPU has it); ``replay_device``
verifies PoW, declared difficulty and prev-hash linkage of the whole
chain in one launch of ``hashx/csrc/verify_chain.cu``, or with its plain
PyTorch version when the caller asks for the CPU.

``replay_fast`` and ``replay_packed`` are the entries the light client
and the store tools call (``chain/headerplane.py``, ``chain/tooling.py``):
the native engine where it builds, ``replay_host`` where it does not.
"""

from __future__ import annotations

import dataclasses
import operator
import time

import numpy as np

from p1_tpu_torch.core.genesis import genesis_header
from p1_tpu_torch.core.hashutil import sha256d
from p1_tpu_torch.core.header import (
    HEADER_SIZE,
    BlockHeader,
    meets_target,
    target_from_difficulty,
    target_to_words,
)


def _expected_difficulty_at(headers: list[BlockHeader], i: int, retarget) -> int:
    """Required difficulty of ``headers[i]`` given its predecessors — the
    linear-chain form of ``Chain._expected_difficulty`` (same boundary,
    same window-1-interval span, same rule)."""
    if retarget is None or i == 0:
        return headers[0].difficulty if headers else 0
    if i % retarget.window != 0:
        return headers[i - 1].difficulty
    span = headers[i - 1].timestamp - headers[i - retarget.window].timestamp
    return retarget.adjusted(headers[i - 1].difficulty, span)


def generate_headers(
    n: int, difficulty: int, backend=None, progress=None, retarget=None
) -> list[BlockHeader]:
    """Mine an ``n``-header chain (genesis first) at ``difficulty``.

    Header-only mining: empty merkle root, timestamps stepping one second.
    ``backend`` is any of the port's ``HashBackend``s (default: ``cuda`` on
    the card).  With a ``RetargetRule`` the chain follows the rule's
    difficulty schedule (and its genesis commits to the rule).
    """
    from p1_tpu_torch.miner import Miner

    miner = Miner(backend=backend if backend is not None else "cuda")
    headers = [genesis_header(difficulty, retarget)]
    for height in range(1, n):
        draft = BlockHeader(
            version=1,
            prev_hash=headers[-1].block_hash(),
            merkle_root=bytes(32),
            timestamp=headers[-1].timestamp + 1,
            difficulty=_expected_difficulty_at(headers, height, retarget),
            nonce=0,
        )
        sealed = miner.search_nonce(draft)
        if sealed is None:
            raise RuntimeError(f"no seal found for height {height}")
        headers.append(sealed)
        if progress is not None:
            progress(height)
    return headers


def pack_headers(headers: list[BlockHeader]) -> bytes:
    """The contiguous (N*80)-byte buffer of the headers' canonical
    encodings.  ``BlockHeader.serialize`` memoizes, so for headers already
    encoded this is a join of cached buffers."""
    try:
        return b"".join(map(operator.attrgetter("_raw"), headers))
    except AttributeError:
        # Some header not yet encoded: pay its one-time pack.
        return b"".join([h.serialize() for h in headers])


def parse_headers(raw: bytes) -> list[BlockHeader]:
    """Batch-parse a packed header buffer (the inverse of
    ``pack_headers``); each header's encoding cache is seeded with its
    exact 80-byte slice."""
    if len(raw) % HEADER_SIZE:
        raise ValueError(f"packed header buffer must be a multiple of {HEADER_SIZE} bytes")
    return [
        BlockHeader.deserialize(raw[off : off + HEADER_SIZE])
        for off in range(0, len(raw), HEADER_SIZE)
    ]


def headers_to_words(headers: list[BlockHeader]) -> np.ndarray:
    """(N, 20) big-endian uint32 view of serialized headers."""
    raw = pack_headers(headers)
    return np.frombuffer(raw, dtype=">u4").astype(np.uint32).reshape(-1, 20)


def pad_to_segments(words: np.ndarray, segment: int) -> np.ndarray:
    """(S, segment, 20): ``words`` padded to a multiple of ``segment`` with
    byte-copies of its last header, the reference's device layout."""
    n_segments = -(-len(words) // segment)
    pad = n_segments * segment - len(words)
    if pad:
        words = np.concatenate([words, np.repeat(words[-1:], pad, axis=0)])
    return words.reshape(n_segments, segment, 20)


@dataclasses.dataclass(frozen=True)
class ReplayReport:
    n_headers: int
    valid: bool
    first_invalid: int | None  # header index, None when valid
    elapsed_s: float
    method: str

    @property
    def headers_per_sec(self) -> float:
        return self.n_headers / self.elapsed_s if self.elapsed_s > 0 else 0.0


def replay_host(headers: list[BlockHeader], retarget=None) -> ReplayReport:
    """Sequential hashlib verification: PoW + prev-hash linkage.

    With a ``RetargetRule`` this is the full light-client header check for
    retargeting chains: the required difficulty is recomputed per header
    from the sequence itself, and timestamps obey the rule's timestamp
    check — the rules a node enforces at connect time.

    Trust note: ``headers[0]`` self-attests the base difficulty — the
    CALLER must pin it to the chain it cares about
    (``headers[0].block_hash() == genesis_hash(difficulty, rule)``), or a
    forged file claiming a trivial base difficulty "verifies" cheaply.
    ``replay --verify`` performs exactly that check.
    """
    t0 = time.perf_counter()
    prev_digest = bytes(32)
    first_invalid = None
    expected = headers[0].difficulty if headers else 0
    for i, header in enumerate(headers):
        digest = sha256d(header.serialize())
        if retarget is not None and i >= 1:
            expected = _expected_difficulty_at(headers, i, retarget)
        pow_ok = i == 0 or meets_target(digest, expected)
        diff_ok = header.difficulty == expected
        ts_ok = retarget is None or i == 0 or (
            retarget.timestamp_violation(i - 1, headers[i - 1].timestamp, header.timestamp)
            is None
        )
        if not (pow_ok and diff_ok and ts_ok and header.prev_hash == prev_digest):
            first_invalid = i
            break
        prev_digest = digest
    return ReplayReport(
        len(headers), first_invalid is None, first_invalid, time.perf_counter() - t0, "host"
    )


def replay_native(headers: list[BlockHeader], retarget=None) -> ReplayReport:
    """C++ verification engine: one ctypes call over the packed headers
    (SHA-NI compressions, no per-header Python), the same rules as
    ``replay_host`` (its oracle), including the contextual difficulty
    schedule and timestamp rules of retargeting chains
    (``p1_verify_chain_retarget``).  Packing is inside the timer, as
    ``replay_host`` pays per-header serialization in its own."""
    from p1_tpu_torch.hashx.native_backend import (
        verify_header_chain,
        verify_header_chain_retarget,
    )

    difficulty = headers[0].difficulty if headers else 0
    t0 = time.perf_counter()
    raw = pack_headers(headers)
    if retarget is None:
        first_invalid = verify_header_chain(raw, len(headers), difficulty)
    else:
        first_invalid = verify_header_chain_retarget(raw, len(headers), retarget)
    return ReplayReport(
        len(headers), first_invalid is None, first_invalid, time.perf_counter() - t0, "native"
    )


def _probe_native() -> None:
    """Force the C library load NOW: ``native_backend._lib()`` builds (or
    finds) the library and binds every symbol the wrapper uses, so every
    environment failure — no toolchain (``NativeBuildError``), unloadable
    object (``OSError``), stale symbol table (``AttributeError`` from
    ctypes, surfacing deliberately) — fires here, in a scope where the
    caller knows exactly what it is excusing."""
    from p1_tpu_torch.hashx import native_backend

    native_backend._lib()


def replay_fast(headers: list[BlockHeader], retarget=None) -> ReplayReport:
    """The light-client entry point: the C++ engine, falling back to the
    hashlib oracle when the native library cannot build (no toolchain).

    The fallback excuses ENVIRONMENT failures only, and only from the
    probe: ``replay_native`` itself runs outside any except scope, so a
    genuine wrapper bug (bad argtypes, a broken ``ReplayReport``
    construction, an AttributeError past the load) crashes loudly instead
    of silently degrading every light-client verification to the host
    path."""
    from p1_tpu_torch.hashx.native_build import NativeBuildError

    try:
        _probe_native()
    except (NativeBuildError, OSError):
        return replay_host(headers, retarget=retarget)
    return replay_native(headers, retarget=retarget)


def replay_packed(raw: bytes, retarget=None) -> ReplayReport:
    """Verify a header chain straight from its packed wire/disk buffer
    (header files, store exports, a segment's ``.hdrx`` blob): the buffer
    goes to the native verifier in one ctypes call with no object parse;
    only the no-toolchain fallback pays a batch parse before
    ``replay_host``."""
    n = len(raw) // HEADER_SIZE
    if len(raw) != n * HEADER_SIZE or n == 0:
        raise ValueError(
            f"packed header buffer must be a non-empty multiple of "
            f"{HEADER_SIZE} bytes"
        )
    from p1_tpu_torch.hashx.native_build import NativeBuildError

    try:
        from p1_tpu_torch.hashx.native_backend import (
            verify_header_chain,
            verify_header_chain_retarget,
        )

        t0 = time.perf_counter()
        if retarget is None:
            first_invalid = verify_header_chain(raw, n, int.from_bytes(raw[72:76], "big"))
        else:
            first_invalid = verify_header_chain_retarget(raw, n, retarget)
        return ReplayReport(n, first_invalid is None, first_invalid, time.perf_counter() - t0, "native")
    except (NativeBuildError, OSError, AttributeError):
        return replay_host(parse_headers(raw), retarget=retarget)


def replay_device(
    headers: list[BlockHeader], segment: int = 8192, device: str = "cuda"
) -> ReplayReport:
    """Whole-chain verification on ``device`` in ONE kernel launch.

    On the card the kernel verifies the n headers as one flat chain in one
    launch.  On the CPU the chain is padded to a multiple of ``segment``
    with byte-copies of its last header and reshaped to (S, segment, 20),
    the reference's layout, and the plain version scans the segments,
    carrying the digest.  Both give the index of the first invalid header,
    the reference's for every ``segment``: the segments change no index.

    Padding semantics: every pad lane FAILS linkage (a copied header's
    prev_hash never equals the preceding copy's digest), intentionally —
    padding sits strictly after every real header, so a reported first
    failure ``>= n`` means the real chain is clean; the ``< n`` clamp is
    what discards pad-lane failures.  Do not "fix" the clamp away.

    The timer spans what the reference's does: from after packing, through
    the copy to the device, the verification and the readback.
    """
    if not headers:
        raise ValueError("empty chain")
    import torch  # here, not at import: the store tools load the chain package

    from p1_tpu_torch.hashx.cuda_verify import first_invalid as verify_first_invalid

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "replay_device needs a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch version"
        )
    difficulty = headers[0].difficulty
    target = target_to_words(target_from_difficulty(difficulty))
    n = len(headers)
    words = headers_to_words(headers)
    # The kernel reads the words' bits as uint32 from an int32 tensor, with
    # no pad lanes; the plain version computes in int64 lanes.
    words = torch.from_numpy(
        words.view(np.int32)
        if device.type == "cuda"
        else pad_to_segments(words, segment).astype(np.int64)
    )

    t0 = time.perf_counter()
    bad = verify_first_invalid(words.to(device), target, difficulty)
    first_invalid = bad if bad < n else None  # pad-lane failure: real chain is clean
    return ReplayReport(n, first_invalid is None, first_invalid, time.perf_counter() - t0, "device")
