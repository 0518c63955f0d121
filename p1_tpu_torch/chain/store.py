"""Chain persistence: append-only block log + resume from tip.

The blockchain analog of checkpoint/resume (SURVEY.md §5): every block the
node accepts is appended to a length-prefixed record log; on restart the
log replays through ``Chain.add_block`` — full validation, fork choice,
and orphan handling included — so a corrupt or truncated tail degrades to
"resume from the last good block" rather than a poisoned index.  Records
keep insertion order, which preserves first-seen tie-breaks and means
side branches survive restarts too.

The port's copy of ``p1_tpu/chain/store.py``: the same record framing,
so a store written by either package loads in the other.  An untrusted
``load_chain`` streams its signature windows through
``chain/validate.preverify_signatures``, on the card under the default
``device`` rung (``hashx/csrc/ed25519_msm.cu``).

Round 7 — the durability layer.  v3 framing carries a CRC32 trailer per
record (over the length prefix AND the payload), which splits on-disk
damage into two cases the recovery paths treat differently:

- **torn tail** — the file ends inside a record (crash mid-append).  The
  expected crash artifact: the partial record is silently truncated
  under the writer lock, exactly as before.
- **mid-log corruption** — a record whose bytes are all present but fail
  their checksum (bit-rot, a flipped length prefix, a bad sector).
  Pre-v3 framing could not tell this from a torn tail, so one flipped
  bit in a mid-log length prefix silently truncated every good record
  behind it.  v3 *resyncs*: scan forward for the next checksum-valid
  record boundary, quarantine the bad span to a ``.quarantine`` sidecar,
  keep everything else, and surface counts (``ChainStore.healed``).

v2 stores (``P1TPUCH2``) stay readable — every read path accepts both
framings — but a writer refuses them with an upgrade hint (``p1 fsck``
or ``p1 compact`` rewrite the log as v3).
"""

from __future__ import annotations

import dataclasses
import fcntl
import io
import os
import struct
import threading
import zlib
from pathlib import Path
from typing import Iterator

from p1_tpu_torch.chain.chain import AddStatus, Chain
from p1_tpu_torch.core.block import Block
from p1_tpu_torch.core.header import HEADER_SIZE, BlockHeader

_LEN = struct.Struct(">I")
_CRC = struct.Struct(">I")
#: Quarantine sidecar entry header: original byte offset (u64) + span
#: length (u32), followed by the raw quarantined bytes.  Append-only, so
#: repeated heals accumulate evidence instead of overwriting it.
_QREC = struct.Struct(">QI")
#: Format tag, versioned with the RECORD layout, not just the framing:
#: "3" adds the per-record CRC32 trailer (corruption containment); "2"
#: extended the transaction wire format (Ed25519 fields) over round 3's
#: original layout.  Older tags are refused with a clean message instead
#: of crashing mid-parse with a raw "truncated transaction".
MAGIC = b"P1TPUCH3"
V2_MAGIC = b"P1TPUCH2"
_OLD_MAGICS = (b"P1TPUCHN",)
#: Largest length prefix a record may carry — same bound as the wire's
#: ``protocol.MAX_FRAME`` (every stored block arrived in, or must fit
#: into, one gossip frame).  Scanning rejects bigger length fields
#: before checksumming, which bounds the resync walk's per-candidate
#: cost: a random 32-bit length passes this gate ~0.8% of the time, so
#: recovering framing past a corrupt span stays near-linear instead of
#: O(file_size x record_size).
_MAX_RECORD = 32 << 20

#: Body spans are packed ``(offset << _SPAN_SHIFT) | length`` into ONE
#: int per block: the span index is an O(chain) RAM structure, and a
#: small int (~36 B) beats a tuple of two (~116 B) by ~8 MB at 100k
#: blocks.  26 bits holds any length ≤ _MAX_RECORD (= 2**25) inclusive.
_SPAN_SHIFT = 26
assert _MAX_RECORD < (1 << _SPAN_SHIFT)


def fsync_dir(path: str | os.PathLike) -> None:
    """fsync a DIRECTORY, making a just-created or just-renamed entry
    durable: on journaling filesystems the rename/create lives in the
    directory's metadata, and a crash after the data fsync but before
    the metadata journal commits can lose the entry — the file's bytes
    were safe, the *name* wasn't."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


@dataclasses.dataclass
class StoreScan:
    """One framing walk's verdict over a store's raw bytes."""

    #: Record-layout version the magic declared (2 = pre-checksum).
    version: int
    #: (payload offset, payload length) of every checksum-valid record
    #: (v2: every whole record — no checksums to check), in file order.
    spans: list[tuple[int, int]]
    #: [start, end) byte ranges that fail their checksum but are fully
    #: present — mid-log corruption, quarantinable.  Always empty for v2
    #: (undetectable without checksums: pre-v3 behavior was truncation).
    bad_spans: list[tuple[int, int]]
    #: Offset where an INCOMPLETE trailing record starts (crash
    #: mid-append), or None.  Truncated by the writer, never quarantined.
    torn_tail: int | None
    #: Total file size scanned.
    size: int

    @property
    def clean(self) -> bool:
        return not self.bad_spans and self.torn_tail is None

    @property
    def quarantined_bytes(self) -> int:
        return sum(e - s for s, e in self.bad_spans)


class ChainStore:
    """Append-only block log backing one node's chain.

    Durability contract: with ``fsync=True`` (the default) every
    ``append`` returns only after ``os.fsync`` — an acknowledged block
    survives OS crash / power loss, not just process death.  At benchmark
    block rates the cost is noise next to the PoW.  ``fsync=False`` keeps only the
    process-crash guarantee (the flush + torn-tail truncation story) for
    workloads that prefer raw append throughput, e.g. bulk ``save_chain``
    snapshots, which are re-derivable.

    The file layer is routed through four overridable seams
    (``_open_fh``/``_fsync_file``/``_fsync_dir``/``_read_bytes``) so the
    fault-injection harness (``chain/testing.py`` ``FaultStore``) can
    script disk pathologies without monkeypatching."""

    def __init__(self, path: str | os.PathLike, fsync: bool = True):
        self.path = Path(path)
        self.fsync = fsync
        self._fh: io.BufferedWriter | None = None
        #: The pre-heal scan ``acquire`` ran (None until then) and what
        #: the heal did about it — surfaced by ``Node.status()["storage"]``
        #: and ``p1 fsck``.
        self.last_scan: StoreScan | None = None
        self.healed = {
            "quarantined_records": 0,
            "quarantined_bytes": 0,
            "truncated_bytes": 0,
        }
        #: block hash -> (payload offset, length), populated by the read
        #: paths and by ``append`` — the offset index behind on-demand
        #: body refetch (``read_body``), which is what lets the chain
        #: evict block bodies from RAM (memory-bounded operation).
        self._body_spans: dict[bytes, int] = {}
        #: File offset the NEXT append lands at, maintained so appends can
        #: register their span without a stat per record.  None = unknown
        #: (not yet acquired, or a failed write left the tail unknowable —
        #: spans stop being registered until re-acquire, which only costs
        #: evictability of post-incident blocks, never correctness).
        self._append_off: int | None = None
        self._read_fd: int | None = None
        #: Read-fd lifecycle guard for the staged node (node/pipeline.py):
        #: ``read_body`` preads can run on the event-loop thread while the
        #: store-writer lane rewrites/compacts/prunes on its worker — the
        #: pread itself is seek-free and page-cache-safe, but open/close of
        #: the shared read fd must not race a read in flight (a close
        #: between the ``is None`` check and the pread would pread a dead —
        #: or worse, recycled — descriptor).
        self._fd_lock = threading.Lock()

    # -- file-layer seams (FaultStore overrides these) --------------------
    #
    # The no-arg seams are the historical single-file surface; each
    # routes through a ``*_path`` seam taking an explicit path so the
    # segmented store (chain/segstore.py), whose appends land in
    # per-segment files, injects through the SAME fault plane — one
    # FaultStore shim covers both layouts.

    def _open_fh(self):
        return self._open_fh_path(self.path)

    def _open_fh_path(self, path):
        return open(path, "a+b")  # "a": every write appends

    def _fsync_file(self, fh) -> None:
        os.fsync(fh.fileno())

    def _fsync_dir(self) -> None:
        self._fsync_dir_path(self.path.parent)

    def _fsync_dir_path(self, path) -> None:
        fsync_dir(path)

    def _read_bytes(self) -> bytes:
        return self._read_bytes_path(self.path)

    def _read_bytes_path(self, path) -> bytes:
        return Path(path).read_bytes()

    def _pread(self, fd: int, n: int, off: int) -> bytes:
        """The body-refetch read seam (``read_body``/``iter_blocks``):
        per-call so the fault harness can model a sector going EIO
        under a live serve — the segmented store's per-segment
        degradation case."""
        return os.pread(fd, n, off)

    # -- writer lifecycle -------------------------------------------------

    def acquire(self, allow_v2: bool = False, heal: bool = True) -> None:
        """Open + exclusively lock the store for this writer's lifetime
        (idempotent; released by ``close``).  Raises RuntimeError when
        another process holds the lock — two nodes appending to one store,
        or a compaction racing a live node, would corrupt or silently
        orphan records.

        Lock ordering matters: the torn-tail truncation and the
        corruption heal run strictly UNDER the lock, so a refused second
        writer can never mutate a live writer's in-flight record on its
        way to the refusal.

        ``allow_v2`` admits a pre-checksum v2 store (read/maintenance
        tooling: ``p1 compact`` / ``p1 fsck`` lock before rewriting);
        plain writers refuse v2 with an upgrade hint — appending
        unchecksummed records forever would defeat the containment.
        ``heal=False`` locks and scans without mutating (``p1 fsck``'s
        report pass owns its own salvage decisions)."""
        if self._fh is not None:
            return
        self.path.parent.mkdir(parents=True, exist_ok=True)
        # At most one rebuild round: the first pass may replace the file
        # (quarantine heal), after which the fresh inode is re-locked and
        # re-verified; a clean store locks on the first pass.
        for attempt in (0, 1):
            fh = self._open_fh()
            try:
                fcntl.flock(fh, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError as e:
                fh.close()
                raise RuntimeError(
                    f"{self.path} is locked by another process (a running node?)"
                ) from e
            try:
                if self.path.stat().st_size == 0:
                    fh.write(MAGIC)
                    fh.flush()
                    break
                data = self._read_bytes()
                scan = self.scan(data)
                self.last_scan = scan
                if scan.version == 2 and not allow_v2:
                    raise ValueError(
                        f"{self.path}: v2 chain store (records carry no "
                        "checksums) — run `p1 fsck` or `p1 compact` to "
                        "upgrade before writing"
                    )
                if not heal or scan.clean:
                    break
                if scan.bad_spans:
                    if attempt == 0:
                        # Mid-log corruption: quarantine + rebuild
                        # replaces the inode, so loop to re-lock and
                        # re-verify it.
                        self._heal_rebuild(data, scan)
                        fh.close()
                        continue
                    # The rebuild wrote only checksum-valid records, so
                    # corruption surviving the re-verify means the medium
                    # itself is lying (persistent read fault, bytes
                    # re-corrupting under us).  Refuse the writer rather
                    # than silently append behind unhealed damage.
                    raise ValueError(
                        f"{self.path}: {len(scan.bad_spans)} corrupt "
                        "span(s) persist after heal — refusing writer; "
                        "run `p1 fsck`"
                    )
                if scan.torn_tail is not None:
                    # Drop the truncated tail record (crash mid-append)
                    # before writing behind it, or its stale length
                    # prefix would point into the new records and corrupt
                    # the whole log.
                    self.healed["truncated_bytes"] += len(data) - scan.torn_tail
                    os.truncate(self.path, scan.torn_tail)
                break
            except ValueError as e:
                # e.g. "not a chain store": release the lock + handle
                # instead of leaking an exclusively-flocked fd, and
                # surface the same clean error type as the lock conflict.
                fh.close()
                raise RuntimeError(str(e)) from e
        self._fh = fh
        try:
            self._append_off = self.path.stat().st_size
        except OSError:
            self._append_off = None

    def _heal_rebuild(self, data: bytes, scan: StoreScan) -> None:
        """Quarantine ``scan.bad_spans`` to the sidecar, then atomically
        rewrite the store as magic + every valid record (and NO torn
        tail).  Sidecar first, fsynced: the evidence must be durable
        before the original bytes stop existing.  The rebuild goes
        through tmp + rename + directory fsync, so a crash at any point
        leaves either the old corrupt file (re-healed next start) or the
        complete new one — never a half-rebuilt log."""
        qpath = self.quarantine_path()
        with open(qpath, "ab") as qf:
            for s, e in scan.bad_spans:
                qf.write(_QREC.pack(s, e - s))
                qf.write(data[s:e])
            qf.flush()
            os.fsync(qf.fileno())
        tmp = self.path.with_name(f"{self.path.name}.heal.{os.getpid()}")
        with open(tmp, "wb") as out:
            out.write(MAGIC)
            for off, n in scan.spans:
                out.write(data[off - _LEN.size : off + n + _CRC.size])
            out.flush()
            os.fsync(out.fileno())
        os.replace(tmp, self.path)
        self._fsync_dir()
        self.healed["quarantined_records"] += len(scan.bad_spans)
        self.healed["quarantined_bytes"] += scan.quarantined_bytes
        if scan.torn_tail is not None:
            self.healed["truncated_bytes"] += scan.size - scan.torn_tail

    def quarantine_path(self) -> Path:
        return self.path.with_name(self.path.name + ".quarantine")

    def append(self, block: Block, height: int | None = None) -> None:
        """Append one record.  ``height`` is an optional hint for
        layouts that track height spans (the segmented store's
        manifest); the single-file log ignores it."""
        self.acquire()
        if self.last_scan is not None and self.last_scan.version == 2:
            # allow_v2 admits readers and rewriters, never appenders: a
            # v3 CRC-trailed record in a v2-magic file reads back with
            # the trailer as the NEXT record's length prefix, silently
            # desyncing the whole log's framing.
            raise ValueError(
                f"{self.path}: cannot append to a v2 chain store — "
                "rewrite it as v3 first (`p1 fsck` or `p1 compact`)"
            )
        # ``serialize`` is memoized on the block: for a block that arrived
        # off the wire these are the exact gossip bytes — ingest appends
        # with zero re-packing.
        raw = block.serialize()
        if len(raw) > _MAX_RECORD:
            # The scan rejects bigger length fields as corruption, so a
            # record this size would be unreadable the moment it landed.
            raise ValueError(
                f"block serializes to {len(raw)} bytes, over the "
                f"{_MAX_RECORD}-byte record limit"
            )
        prefix = _LEN.pack(len(raw))
        crc = zlib.crc32(raw, zlib.crc32(prefix))
        # One write per record: a torn append (crash, ENOSPC mid-write)
        # can tear at most THIS record, never desync an earlier one.
        try:
            self._fh.write(prefix + raw + _CRC.pack(crc))
            self._fh.flush()
        except OSError:
            # The tail may now hold a partial record, so the next append's
            # offset is unknowable without a rescan: stop registering
            # spans (post-incident blocks just stay unevictable until the
            # next acquire re-derives clean framing).
            self._append_off = None
            raise
        if self._append_off is not None:
            self._body_spans[block.block_hash()] = (
                (self._append_off + _LEN.size) << _SPAN_SHIFT
            ) | len(raw)
            self._append_off += _LEN.size + len(raw) + _CRC.size
        if self.fsync:
            self._fsync_file(self._fh)

    def sync(self) -> None:
        """Flush + fsync now — the batch closer for callers that toggle
        ``fsync`` off around a bulk append run (e.g. a node persisting a
        whole BLOCKS resync batch pays one fsync per frame, not per
        block; every batched block is re-fetchable from peers if the OS
        eats the window)."""
        if self._fh is not None:
            self._fh.flush()
            self._fsync_file(self._fh)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        self._append_off = None
        with self._fd_lock:
            if self._read_fd is not None:
                os.close(self._read_fd)
                self._read_fd = None

    # -- the framing walk -------------------------------------------------

    @staticmethod
    def _check_magic(data: bytes, label: str = "") -> None:
        prefix = f"{label} " if label else ""
        if not data.startswith(MAGIC) and not data.startswith(V2_MAGIC):
            if any(data.startswith(m) for m in _OLD_MAGICS):
                raise ValueError(
                    f"{prefix}written by an older p1-tpu version "
                    "(incompatible transaction format); re-mine or discard it"
                )
            raise ValueError(f"{prefix}not a chain store")

    @staticmethod
    def _v3_record_at(data: bytes, off: int) -> int | None:
        """End offset of a checksum-valid v3 record starting at ``off``,
        or None (incomplete frame / checksum mismatch)."""
        if off + _LEN.size + _CRC.size > len(data):
            return None
        (n,) = _LEN.unpack_from(data, off)
        if n > _MAX_RECORD:
            return None
        end = off + _LEN.size + n + _CRC.size
        if end > len(data):
            return None
        body_end = end - _CRC.size
        if zlib.crc32(data[off:body_end]) != _CRC.unpack_from(data, body_end)[0]:
            return None
        return end

    @classmethod
    def _resync(cls, data: bytes, start: int) -> int | None:
        """First offset >= ``start`` where a checksum-valid record begins
        — how the scan recovers framing past a corrupt span.  A false
        positive needs a 32-bit CRC collision at a byte offset whose
        length field also happens to land exactly inside the file
        (~2^-32 per candidate): negligible against whole-log loss.
        Candidates whose length field exceeds ``_MAX_RECORD`` (or whose
        frame overruns the file) are rejected before any checksumming,
        so the walk's cost is dominated by the cheap 4-byte reads, not
        by CRCs over garbage."""
        for cand in range(start, len(data) - (_LEN.size + _CRC.size) + 1):
            if cls._v3_record_at(data, cand) is not None:
                return cand
        return None

    @classmethod
    def scan(cls, data: bytes) -> StoreScan:
        """The ONE walk of the framing, shared by the writer's heal, the
        batch parse, the packed-header extraction, and ``p1 fsck`` — so
        none of them can drift."""
        cls._check_magic(data)
        if data.startswith(V2_MAGIC):
            # Pre-checksum framing: whole records up to the first one the
            # file ends inside.  Corruption is UNDETECTABLE here (that is
            # what v3 fixes); a bad length prefix reads as a torn tail.
            spans: list[tuple[int, int]] = []
            off = len(V2_MAGIC)
            while off + _LEN.size <= len(data):
                (n,) = _LEN.unpack_from(data, off)
                if off + _LEN.size + n > len(data):
                    break
                spans.append((off + _LEN.size, n))
                off += _LEN.size + n
            return StoreScan(
                version=2,
                spans=spans,
                bad_spans=[],
                torn_tail=off if off < len(data) else None,
                size=len(data),
            )
        spans = []
        bad: list[tuple[int, int]] = []
        torn: int | None = None
        off = len(MAGIC)
        while off < len(data):
            end = cls._v3_record_at(data, off)
            if end is not None:
                spans.append((off + _LEN.size, end - off - _LEN.size - _CRC.size))
                off = end
                continue
            nxt = cls._resync(data, off + 1)
            if nxt is not None:
                bad.append((off, nxt))
                off = nxt
                continue
            # Nothing checksum-valid ahead.  A fully-present frame that
            # failed its CRC is trailing corruption (quarantinable);
            # anything the file ends inside is a torn tail.
            if off + _LEN.size <= len(data):
                (n,) = _LEN.unpack_from(data, off)
                end = off + _LEN.size + n + _CRC.size
                if end <= len(data):
                    bad.append((off, end))
                    if end < len(data):
                        torn = end
                    break
            torn = off
            break
        return StoreScan(
            version=3, spans=spans, bad_spans=bad, torn_tail=torn, size=len(data)
        )

    @classmethod
    def _record_spans(cls, data: bytes) -> Iterator[tuple[int, int]]:
        """(offset, length) of every checksum-valid record's block bytes.
        Skips quarantinable spans and stops cleanly at a torn tail."""
        yield from cls.scan(data).spans

    # -- readers ----------------------------------------------------------

    def _read_checked(self) -> bytes:
        data = self._read_bytes()
        self._check_magic(data, str(self.path))
        return data

    def load_blocks(self) -> list[Block]:
        """All decodable records: checksum-valid (v3), stopping cleanly at
        a truncated tail, SKIPPING — not trusting — corrupt spans.

        Batch parse on the packed-bytes plane: each ``Block.deserialize``
        seeds the block's (and its header's and transactions') encoding
        caches with the record's exact bytes, so resume never re-packs —
        ``add_block``'s hashing, the ledger's txids, and any later relay
        all reuse the disk bytes."""
        return list(self.iter_blocks())

    def iter_blocks(self):
        """Streaming form of ``load_blocks``: one block at a time, never
        the whole object list at once — what memory-bounded resume
        iterates (``load_chain(..., body_cache=N)`` evicts as it goes, so
        peak RSS is bounded by the keep window, not the chain length).
        Registers each record's span in the body index as a side effect.

        The whole-file buffer is needed for the checksum walk but is
        RELEASED before the object build: records are re-read per span
        (pread against the page cache the scan just warmed), so the
        build phase — where the per-block index objects accumulate —
        never also carries an O(chain) byte buffer."""
        if not self.path.exists():
            return
        data = self._read_checked()
        spans = list(self._record_spans(data))
        del data
        with self._fd_lock:
            if self._read_fd is None:
                self._read_fd = os.open(self.path, os.O_RDONLY)
        for off, n in spans:
            raw = self._pread(self._read_fd, n, off)
            if len(raw) != n:
                raise OSError(f"{self.path}: short record read at {off}")
            block = Block.deserialize(raw)
            self._body_spans[block.block_hash()] = (off << _SPAN_SHIFT) | n
            yield block

    def first_difficulty(self) -> int | None:
        """The difficulty the first stored record declares (every block
        carries the chain difficulty), or None for an empty store —
        the streaming-resume path's pre-check, which must not
        materialize the block list just to read one header field."""
        header = self.first_header()
        return None if header is None else header.difficulty

    def first_header(self) -> BlockHeader | None:
        """The first stored record's header (None for an empty store).
        The snapshot-resume path's linkage probe: a store whose first
        record is (or extends) genesis resumes normally, one whose
        records hang off a snapshot anchor needs the sidecar
        (node/node.py ``_try_snapshot_resume``)."""
        if not self.path.exists():
            return None
        data = self._read_checked()
        for off, _ in self._record_spans(data):
            return BlockHeader.deserialize(data[off : off + HEADER_SIZE])
        return None

    def reindex_spans(self) -> int:
        """Rebuild the body-span index from the CURRENT file contents —
        required after an in-place rewrite replaced the inode under the
        held writer lock (the snapshot plane's flip transition): the old
        spans point into a dead inode, and serving a refetch from them
        would be an offset lottery.  Block hashes come straight from the
        80-byte header slices (block id = header SHA-256d), so the
        rebuild costs no full-record parses."""
        from p1_tpu_torch.core.hashutil import sha256d

        self._body_spans.clear()
        with self._fd_lock:
            if self._read_fd is not None:
                os.close(self._read_fd)  # points at the replaced inode
                self._read_fd = None
        if not self.path.exists():
            return 0
        data = self._read_checked()
        for off, n in self._record_spans(data):
            bhash = sha256d(data[off : off + HEADER_SIZE])
            self._body_spans[bhash] = (off << _SPAN_SHIFT) | n
        return len(self._body_spans)

    # -- body refetch (memory-bounded operation) ---------------------------

    def has_body(self, block_hash: bytes) -> bool:
        """True when ``read_body`` can re-serve this block — the chain's
        eviction gate: only durably refetchable bodies leave RAM."""
        return block_hash in self._body_spans

    def read_body(self, block_hash: bytes) -> Block:
        """Re-read one block straight from its record span (pread — no
        shared seek state with the appender; the writer flushes every
        record, so the bytes are page-cache-visible the moment the span
        exists).  The deserialize seeds the block's encoding caches with
        the disk bytes, so a refetched body re-serves/re-hashes at the
        zero-repack rate; the hash check pins the span map itself —
        a mismatch is a store-layer bug, not peer input, so it raises."""
        span = self._body_spans[block_hash]
        off, n = span >> _SPAN_SHIFT, span & ((1 << _SPAN_SHIFT) - 1)
        with self._fd_lock:
            if self._read_fd is None:
                self._read_fd = os.open(self.path, os.O_RDONLY)
            raw = self._pread(self._read_fd, n, off)
        if len(raw) != n:
            raise OSError(f"{self.path}: short body read at {off}")
        block = Block.deserialize(raw)
        if block.block_hash() != block_hash:
            raise ValueError(
                f"{self.path}: body span for {block_hash.hex()[:16]} "
                "re-read as a different block"
            )
        return block

    def packed_headers(self) -> tuple[bytes, int]:
        """(buffer, count): every record's 80-byte header, contiguous, cut
        straight from the record framing with NO object parse — the exact
        shape ``replay_packed`` takes in one call.  For a linear store (a ``save_chain`` snapshot or compacted
        log — main branch only, append order = height order) this is the
        whole-chain PoW + linkage check at the raw-bytes rate; stores
        carrying side branches fail linkage at the first out-of-line
        record, by construction."""
        if not self.path.exists():
            return b"", 0
        data = self._read_checked()
        parts = [
            data[off : off + HEADER_SIZE] for off, _ in self._record_spans(data)
        ]
        return b"".join(parts), len(parts)

    def load_chain(
        self,
        difficulty: int,
        blocks: list[Block] | None = None,
        retarget=None,
        trusted: bool = False,
        body_cache: int = 0,
        sig_cache=None,
        orphans_ok: bool = False,
    ) -> Chain:
        """Rebuild a validated chain from the log (skipping the genesis
        record, which the Chain constructor provides).  Pass ``blocks``
        when the caller already ran ``load_blocks`` (avoids a second full
        read+parse of the log), and the store's ``RetargetRule`` if the
        chain was mined with one (the rule is part of chain identity).

        ``trusted=True`` is the fast-resume path for a node reloading its
        OWN store: every record was fully validated by this node before
        it was appended (and the store is exclusively flocked, so nothing
        else wrote it), so the stateless checks — Ed25519 signatures
        above all — are skipped while the contextual rules and the
        connect-time ledger still rebuild identical state (equivalence is
        tested).  The v3 record checksum bounds what
        trust costs: bit-rot inside a record body now fails the CRC and
        the record is quarantined at ``acquire`` rather than trusted
        through — ``p1 node --revalidate-store`` remains the remedy for
        corruption *with* a fixed-up checksum (i.e. a hostile editor,
        not a disk).

        Raises ValueError when records exist but NONE connect — that is a
        store from a chain with different parameters (wrong difficulty /
        retarget flags), and proceeding would be catastrophic for some
        callers (``p1 compact`` would rewrite the store as a genesis-only
        snapshot of the wrong chain).  The guard lives here, once, so no
        call site can forget it; a partially-connecting store (corrupt
        tail) still loads what it can.

        ``orphans_ok`` relaxes that guard for callers that can BACKFILL:
        when this acquire's heal quarantined the head of the log, the
        surviving records legitimately hang off a missing ancestor —
        they park in the chain's orphan pool and reconnect the moment a
        peer re-serves the gap.  The chaos sweeps found the hard guard
        bricking exactly that recovery (a node refusing to boot off its
        own healed store over one rotted head record, with the whole
        suffix intact and the mesh holding every missing block); a NODE
        passes ``orphans_ok`` when its store healed, while tooling
        (``p1 compact``) keeps the refusal — compacting an unanchored
        store would discard records a sync could still save.

        Resume operates on the packed-bytes plane end to end: the batch
        parse (``load_blocks``) seeds every block's encoding caches from
        the record bytes, so the per-block hashing that ``add_block`` and
        the ledger need digests the disk bytes directly — no
        re-serialization anywhere in the resume loop.

        ``body_cache=N`` (memory-bounded resume) wires the chain's body
        refetch to THIS store and streams the log through periodic body
        eviction, so peak RSS is bounded by the keep window instead of
        the whole chain's object graph — the governor's memory-bounded
        operation starts at boot, not after it.

        Untrusted loads (``trusted=False`` — `--revalidate-store`,
        foreign stores) run through the validation fast lane: blocks
        stream through a signature pre-verification window
        (chain/validate.py ``preverify_signatures``) that proves whole
        batches of Ed25519 signatures into the chain's verify-once
        cache before ``add_block``'s per-block ``check_block`` consults
        it — one batch call per ~4k signatures instead of one backend
        call per transfer, with bit-identical accept/reject outcomes
        (the warmer only ever caches proofs that hold).  Under the
        port's default ``device`` rung a full window of
        ``PREVERIFY_WINDOW`` signatures is four ``ed25519_msm.cu``
        launches (``keys.BATCH_CHUNK`` each); without a card it raises,
        it never falls back to a host rung."""
        chain = Chain(difficulty, retarget=retarget)
        if body_cache > 0:
            chain.body_source = self
        if sig_cache is not None:
            chain.sig_cache = sig_cache
        ghash = chain.genesis.block_hash()
        saw_record = False
        if blocks is None:
            blocks = self.iter_blocks() if body_cache > 0 else self.load_blocks()
        if not trusted:
            blocks = _preverify_stream(
                blocks, chain.genesis.block_hash(), chain.sig_cache
            )
        seen = 0
        for block in blocks:
            if block.block_hash() == ghash:
                continue
            saw_record = True
            chain.add_block(block, trusted=trusted)
            seen += 1
            if body_cache > 0 and seen % 1024 == 0:
                chain.evict_bodies(body_cache)
        if body_cache > 0:
            chain.evict_bodies(body_cache)
        if saw_record and not chain.height and not orphans_ok:
            raise ValueError(
                f"{self.path}: records do not connect to this chain's "
                "genesis — wrong --difficulty or "
                "--retarget-window/--target-spacing for this store?"
            )
        return chain


def _preverify_stream(blocks, chain_tag: bytes, sig_cache):
    """Stream ``blocks`` through windowed signature pre-verification.

    Buffers blocks until ~PREVERIFY_WINDOW transfer signatures are
    pending, proves them into ``sig_cache`` with one batch call, then
    yields the buffered blocks onward — so the untrusted resume loop
    stays a stream (memory O(window), compatible with ``body_cache``
    eviction) while its Ed25519 cost drops to the batch rate.  Purely an
    accelerator: outcomes are identical whether or not a block ever
    passed through here (preverify_signatures's contract).
    """
    from p1_tpu_torch.chain.validate import PREVERIFY_WINDOW, preverify_signatures

    window: list[Block] = []
    pending_sigs = 0
    for block in blocks:
        window.append(block)
        pending_sigs += sum(1 for tx in block.txs if not tx.is_coinbase)
        # The block-count bound keeps a sparse-transfer store's window
        # from buffering unboundedly many blocks ahead of a streaming
        # (body_cache) resume; the sig bound is the batching target.
        if pending_sigs >= PREVERIFY_WINDOW or len(window) >= PREVERIFY_WINDOW:
            preverify_signatures(
                (tx for blk in window for tx in blk.txs), chain_tag, sig_cache
            )
            yield from window
            window.clear()
            pending_sigs = 0
    if window:
        preverify_signatures(
            (tx for blk in window for tx in blk.txs), chain_tag, sig_cache
        )
        yield from window


def save_chain(
    chain: Chain, path: str | os.PathLike, store_cls: type[ChainStore] = ChainStore
) -> None:
    """Snapshot a chain's main branch to a fresh store (tooling aid; nodes
    normally append incrementally as blocks arrive).  The snapshot is
    LINEAR by construction — genesis-first main branch — so its
    ``packed_headers`` buffer verifies in one ``replay_packed`` call,
    which is how ``p1 compact`` proves a snapshot
    before replacing the original log.

    Durability: one data fsync at the end (bulk snapshot; the source
    chain still exists in memory if the write is lost), then a PARENT
    DIRECTORY fsync — a freshly created file whose directory entry only
    lives in an uncommitted metadata journal vanishes wholesale on power
    loss, data fsync or not.  ``store_cls`` is the fault-injection seam
    (tests pass ``FaultStore``)."""
    p = Path(path)
    if p.exists():
        p.unlink()
    store = store_cls(p, fsync=False)
    try:
        for block in chain.main_chain():
            store.append(block)
        store.sync()
        store._fsync_dir()
    finally:
        store.close()
