"""Block header: canonical 80-byte serialization and difficulty/target math.

The port's own copy of ``p1_tpu/core/header.py`` (same names, same bytes):
``BlockHeader.deserialize`` reads the JAX package's 80-byte encoding and
``serialize`` writes it, byte for byte.  Fields are fixed-width
**big-endian** (network order) throughout, which keeps the device-side word
view trivial — the header is exactly twenty uint32 words, and the nonce is
word 19 (the last word of the second SHA-256 chunk), so the CUDA search
kernel varies the nonce without any byte shuffling.

Layout (80 bytes, the classic Bitcoin-style shape):

    offset  size  field
    0       4     version      (uint32 be)
    4       32    prev_hash    (raw SHA-256d digest bytes)
    36      32    merkle_root  (raw digest bytes)
    68      4     timestamp    (uint32 be, unix seconds)
    72      4     difficulty   (uint32 be — required leading zero bits, 0..255)
    76      4     nonce        (uint32 be)

Difficulty convention: an integer ``d`` meaning the block hash, read as a
big-endian 256-bit integer, must be strictly less than ``2**(256-d)`` —
i.e. it has at least ``d`` leading zero bits.  ``BASELINE.json:6-12`` sweeps
``d`` in 16..28.

Canonical-encoding cache: the header is frozen, so its 80-byte wire form
and SHA-256d digest are constants of the instance — ``serialize()`` and
``block_hash()`` compute each once and memoize via ``object.__setattr__``
(cache slots are NOT dataclass fields: equality/hash ignore them, and
``dataclasses.replace`` — hence ``with_nonce``/``with_timestamp`` — builds
instances through ``__init__``, so derived headers start with *fresh,
empty* caches and can never inherit a stale encoding).  ``deserialize``
seeds the cache with the exact wire bytes; the encoding is canonical, so
the seeded bytes are byte-identical to a recomputation.
"""

from __future__ import annotations

import dataclasses
import struct

HEADER_SIZE = 80
NONCE_OFFSET = 76
_PACK = struct.Struct(">I32s32sIII")
assert _PACK.size == HEADER_SIZE


class _HeaderCache:
    """Slot home for the memoized encoding (``_raw``) and digest
    (``_hash``).  A separate base because ``dataclass(slots=True)``
    generates ``__slots__`` from the FIELDS only — the caches are not
    fields (equality/replace must ignore them) but still need slots, or
    the instance grows a dict and the whole point is lost."""

    __slots__ = ("_raw", "_hash")


@dataclasses.dataclass(frozen=True, slots=True)
class BlockHeader(_HeaderCache):
    version: int
    prev_hash: bytes  # 32 raw bytes
    merkle_root: bytes  # 32 raw bytes
    timestamp: int
    difficulty: int  # required leading zero bits of the block hash
    nonce: int

    def __post_init__(self) -> None:
        if len(self.prev_hash) != 32:
            raise ValueError(f"prev_hash must be 32 bytes, got {len(self.prev_hash)}")
        if len(self.merkle_root) != 32:
            raise ValueError(
                f"merkle_root must be 32 bytes, got {len(self.merkle_root)}"
            )
        for name in ("version", "timestamp", "difficulty", "nonce"):
            v = getattr(self, name)
            if not 0 <= v <= 0xFFFFFFFF:
                raise ValueError(f"{name}={v} out of uint32 range")
        if self.difficulty > 255:
            raise ValueError(f"difficulty={self.difficulty} out of range (0..255)")

    def serialize(self) -> bytes:
        raw = getattr(self, "_raw", None)
        if raw is None:
            raw = _PACK.pack(
                self.version,
                self.prev_hash,
                self.merkle_root,
                self.timestamp,
                self.difficulty,
                self.nonce,
            )
            object.__setattr__(self, "_raw", raw)
        return raw

    @classmethod
    def deserialize(cls, data: bytes) -> "BlockHeader":
        if len(data) != HEADER_SIZE:
            raise ValueError(f"header must be {HEADER_SIZE} bytes, got {len(data)}")
        version, prev_hash, merkle_root, timestamp, difficulty, nonce = _PACK.unpack(
            data
        )
        # The fixed-width unpack structurally guarantees every
        # ``__post_init__`` range rule (``>I`` yields uint32, ``32s``
        # yields 32 bytes) except the difficulty ceiling — check that one
        # and build the instance directly: this is the gossip/resume hot
        # path, and re-validating what the wire format already proves is
        # pure overhead.
        if difficulty > 255:
            raise ValueError(f"difficulty={difficulty} out of range (0..255)")
        header = object.__new__(cls)
        set_ = object.__setattr__
        set_(header, "version", version)
        set_(header, "prev_hash", prev_hash)
        set_(header, "merkle_root", merkle_root)
        set_(header, "timestamp", timestamp)
        set_(header, "difficulty", difficulty)
        set_(header, "nonce", nonce)
        # Seed the encoding cache with the exact wire bytes: fixed-width
        # fields make re-packing byte-identical, so these ARE the
        # canonical encoding and the header never repacks.
        set_(header, "_raw", bytes(data))
        return header

    def with_nonce(self, nonce: int) -> "BlockHeader":
        return dataclasses.replace(self, nonce=nonce)

    def with_timestamp(self, timestamp: int) -> "BlockHeader":
        return dataclasses.replace(self, timestamp=timestamp)

    def mining_prefix(self) -> bytes:
        """The first 76 bytes — everything the nonce search holds constant."""
        return self.serialize()[:NONCE_OFFSET]

    def block_hash(self) -> bytes:
        """SHA-256d of the serialized header (the block id) — computed
        once; gossip ingest, fork choice, and store resume all re-ask."""
        digest = getattr(self, "_hash", None)
        if digest is None:
            from p1_tpu_torch.core.hashutil import sha256d

            digest = sha256d(self.serialize())
            object.__setattr__(self, "_hash", digest)
        return digest


def target_from_difficulty(difficulty: int) -> int:
    """Target threshold: hash (as a big-endian 256-bit int) must be < this."""
    if not 0 <= difficulty <= 255:
        raise ValueError(f"difficulty={difficulty} out of range (0..255)")
    return 1 << (256 - difficulty)


def target_to_words(target: int) -> tuple[int, ...]:
    """The 256-bit target as 8 big-endian uint32 words (device compare form)."""
    if not 0 < target <= 1 << 256:
        raise ValueError("target out of range")
    # A target of exactly 2**256 (difficulty 0) clamps to all-ones: every hash
    # is strictly below 2**256 anyway, and 8 words cannot represent 2**256.
    t = min(target, (1 << 256) - 1)
    return tuple((t >> (32 * (7 - i))) & 0xFFFFFFFF for i in range(8))


def meets_target(block_hash: bytes, difficulty: int) -> bool:
    """Host-side PoW check: does the hash have >= difficulty leading zero bits?"""
    if len(block_hash) != 32:
        raise ValueError("block hash must be 32 bytes")
    if difficulty == 0:
        return True
    return int.from_bytes(block_hash, "big") < target_from_difficulty(difficulty)
