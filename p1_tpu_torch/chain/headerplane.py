"""The spillable header plane: per-segment packed-header indexes and
the archive-scale serve-only boot (round 18).

The port's copy of ``p1_tpu/chain/headerplane.py``: the same ``.hdrx``
bytes.

The in-RAM header index is the last O(chain) structure that matters at
archive scale: ~143 MB at 100k blocks is ~14 GB at 10M.  This module
makes chain length a *disk* problem for the serving path:

- ``write_segment_index`` distills one sealed segment into a ``.hdrx``
  sidecar: every record's 80-byte header (the packed-headers shape —
  contiguous, parse-free, the exact buffer ``replay_packed`` verifies),
  the record's (offset, length) span, a sorted block-hash index, and a
  sorted txid index.  Everything is derivable from the segment, so the
  sidecar is a cache that can always be rebuilt — and it survives
  pruning, which is what keeps a pruned store's header chain whole.
- ``SegmentIndex`` probes one sidecar via ``pread`` (O(log n) reads
  per lookup; a blocked bloom filter makes txid negatives one 64-byte
  read) — untouched history stays in the page cache, not this
  process's RSS, so memory is bounded by the query working set, not
  the chain length.
- ``ArchiveChain`` is the serve-only composition: ledger state from a
  snapshot (``Chain.from_snapshot`` — the bounded hot window of
  real ``_Entry`` headers), cold headers/proof lookups from the
  on-disk plane below the base.  The JAX package's
  benchmarks/archive_scale.py boots a synthetic archive-scale store
  this way and reads its peak RSS; the port has not measured it.

Ordinal == height: the plane assumes a LINEAR store (compacted /
synthetic / pruned-serve archives — main branch only, append order =
height order), checked at attach by linking each segment's first
header to its predecessor's last.  A node's live log with side
branches is not a plane candidate; its resume path is unchanged.
"""

from __future__ import annotations

import os
import struct
import zlib
from pathlib import Path

from p1_tpu_torch.chain.store import ChainStore, fsync_dir
from p1_tpu_torch.core.hashutil import sha256d
from p1_tpu_torch.core.header import HEADER_SIZE

HDRX_MAGIC = b"P1TPUHX1"
_U32 = struct.Struct(">I")
_SPAN = struct.Struct(">QI")  # record payload (offset, length)
_IDX = struct.Struct(">32sI")  # (hash, ordinal), sorted by hash

#: Blocked bloom filter over the txid set, ~10 bits/key in 64-byte
#: blocks with all k probe bits INSIDE one block: a negative costs ONE
#: page touch.  Without it, a cold-proof lookup binary-searched every
#: segment's txid index — ~17 scattered page touches per segment per
#: query, which at archive scale keeps the index pages of every segment
#: resident.  Txids are sha256d outputs, so the txid's own bytes are the
#: hash material.
_BLOOM_BLOCK = 64
_BLOOM_BITS_PER_KEY = 10
_BLOOM_K = 6


def _bloom_probe(txid: bytes, n_blocks: int):
    """(block index, bit offsets within the 512-bit block)."""
    block = int.from_bytes(txid[:8], "big") % n_blocks
    word = int.from_bytes(txid[8:16], "big")
    return block, [(word >> (9 * i)) & 511 for i in range(_BLOOM_K)]


def _bloom_build(txids, count: int) -> bytes:
    n_blocks = max(1, (count * _BLOOM_BITS_PER_KEY + 511) // 512)
    buf = bytearray(n_blocks * _BLOOM_BLOCK)
    for txid in txids:
        block, bits = _bloom_probe(txid, n_blocks)
        base = block * _BLOOM_BLOCK
        for b in bits:
            buf[base + (b >> 3)] |= 1 << (b & 7)
    return bytes(buf)


def write_segment_index(segment_data: bytes, out_path) -> int:
    """Distill ``segment_data`` (one v3 segment file's bytes) into the
    ``.hdrx`` sidecar at ``out_path`` (tmp + rename + dir-fsync — the
    sidecar appears atomically or not at all).  Returns record count.

    Layout after the magic: u32 count | u32 ntx | count×80 B headers
    (record order) | count×(u64 off, u32 len) spans | count×(32s, u32)
    sorted hash index | ntx×(32s, u32) sorted txid index | u32 CRC32
    over everything after the magic."""
    out_path = Path(out_path)
    spans = ChainStore.scan(segment_data).spans
    headers: list[bytes] = []
    span_rows: list[bytes] = []
    hash_rows: list[tuple[bytes, int]] = []
    tx_rows: list[tuple[bytes, int]] = []
    for ordinal, (off, n) in enumerate(spans):
        hdr = segment_data[off : off + HEADER_SIZE]
        headers.append(hdr)
        span_rows.append(_SPAN.pack(off, n))
        hash_rows.append((sha256d(hdr), ordinal))
        # Raw txid walk (no object parse), the queryplane technique.
        end = off + n
        pos = off + HEADER_SIZE
        if pos + 4 > end:
            continue
        (ntx,) = _U32.unpack_from(segment_data, pos)
        pos += 4
        for _ in range(ntx):
            if pos + 4 > end:
                break
            (tlen,) = _U32.unpack_from(segment_data, pos)
            pos += 4
            if pos + tlen > end:
                break
            tx_rows.append((sha256d(segment_data[pos : pos + tlen]), ordinal))
            pos += tlen
    hash_rows.sort()
    tx_rows.sort()
    bloom = _bloom_build((t for t, _ in tx_rows), max(len(tx_rows), 1))
    body = b"".join(
        (
            _U32.pack(len(headers)),
            _U32.pack(len(tx_rows)),
            *headers,
            *span_rows,
            *(_IDX.pack(h, o) for h, o in hash_rows),
            *(_IDX.pack(t, o) for t, o in tx_rows),
            _U32.pack(len(bloom) // _BLOOM_BLOCK),
            bloom,
        )
    )
    tmp = out_path.with_name(f"{out_path.name}.tmp.{os.getpid()}")
    with open(tmp, "wb") as f:
        f.write(HDRX_MAGIC)
        f.write(body)
        f.write(_U32.pack(zlib.crc32(body)))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, out_path)
    fsync_dir(out_path.parent)
    return len(headers)


class SegmentIndex:
    """One ``.hdrx`` sidecar, probed via ``pread`` — deliberately NOT
    memory-mapped: random faults on a file mapping drag fault-around
    clusters (~16 pages per touch, regardless of MADV_RANDOM) into
    process RSS, which at 10M blocks residented most of a GB of
    never-used neighbor pages and broke the boot bar.  ``pread`` copies
    the handful of bytes a probe needs and leaves residency to the
    page cache, where the kernel — not this process's VmHWM — owns it.
    All lookups are O(log n) reads; nothing is materialized into
    Python objects until asked."""

    def __init__(self, path, verify: bool = True):
        self.path = Path(path)
        self._fd = os.open(self.path, os.O_RDONLY)
        try:
            size = os.fstat(self._fd).st_size
            head = os.pread(self._fd, 16, 0)
        except OSError:
            os.close(self._fd)
            self._fd = None
            raise
        if head[: len(HDRX_MAGIC)] != HDRX_MAGIC:
            self.close()
            raise ValueError(f"{self.path}: not a header-plane index")
        if verify:
            # Whole-file CRC: O(file) — right for fsck and one-shot
            # readers; the archive attach passes verify=False and
            # relies on the structural checks below plus the optional
            # whole-plane PoW replay (``ArchiveChain.verify_headers``).
            data = os.pread(self._fd, size, 0)
            body = data[len(HDRX_MAGIC) : size - _U32.size]
            if zlib.crc32(body) != _U32.unpack_from(data, size - _U32.size)[0]:
                self.close()
                raise ValueError(
                    f"{self.path}: header-plane index CRC mismatch"
                )
        off = len(HDRX_MAGIC)
        if len(head) < off + 8:
            self.close()
            raise ValueError(f"{self.path}: header-plane index truncated")
        (self.count,) = _U32.unpack_from(head, off)
        (self.tx_count,) = _U32.unpack_from(head, off + 4)
        self._hdr0 = off + 8
        self._span0 = self._hdr0 + self.count * HEADER_SIZE
        self._hash0 = self._span0 + self.count * _SPAN.size
        self._tx0 = self._hash0 + self.count * _IDX.size
        bloom_len = self._tx0 + self.tx_count * _IDX.size
        bl = os.pread(self._fd, _U32.size, bloom_len)
        if len(bl) < _U32.size:
            self.close()
            raise ValueError(f"{self.path}: header-plane index truncated")
        (self._bloom_blocks,) = _U32.unpack(bl)
        self._bloom0 = bloom_len + _U32.size
        expect = (
            self._bloom0 + self._bloom_blocks * _BLOOM_BLOCK + _U32.size
        )
        if expect != size:
            self.close()
            raise ValueError(f"{self.path}: header-plane index truncated")

    def close(self) -> None:
        if getattr(self, "_fd", None) is not None:
            os.close(self._fd)
            self._fd = None

    def _read(self, off: int, n: int) -> bytes:
        return os.pread(self._fd, n, off)

    def header_at(self, ordinal: int) -> bytes:
        return self._read(self._hdr0 + ordinal * HEADER_SIZE, HEADER_SIZE)

    def headers_blob(self) -> bytes:
        return self._read(self._hdr0, self._span0 - self._hdr0)

    def record_span(self, ordinal: int) -> tuple[int, int]:
        """(payload offset, length) of the ordinal-th record in the
        segment FILE (valid while the body segment still exists)."""
        return _SPAN.unpack(
            self._read(self._span0 + ordinal * _SPAN.size, _SPAN.size)
        )

    def _bisect(self, base: int, n: int, key: bytes) -> int | None:
        lo, hi = 0, n
        while lo < hi:
            mid = (lo + hi) // 2
            row = self._read(base + mid * _IDX.size, _IDX.size)
            cand = row[:32]
            if cand < key:
                lo = mid + 1
            elif cand > key:
                hi = mid
            else:
                return _U32.unpack_from(row, 32)[0]
        return None

    def maybe_txid(self, txid: bytes) -> bool:
        """Bloom probe: False means DEFINITELY absent (one 64-byte
        read); True means fall through to the binary search (~1% of
        misses)."""
        if self._bloom_blocks == 0:
            return True
        block, bits = _bloom_probe(txid, self._bloom_blocks)
        blob = self._read(self._bloom0 + block * _BLOOM_BLOCK, _BLOOM_BLOCK)
        for b in bits:
            if not blob[b >> 3] & (1 << (b & 7)):
                return False
        return True

    def find_hash(self, block_hash: bytes) -> int | None:
        """Ordinal of the record whose header hashes to ``block_hash``,
        or None."""
        return self._bisect(self._hash0, self.count, block_hash)

    def find_txid(self, txid: bytes) -> int | None:
        """Ordinal of the (first) record containing ``txid``, or None."""
        if not self.maybe_txid(txid):
            return None
        return self._bisect(self._tx0, self.tx_count, txid)


class HeaderPlane:
    """Ordered segment indexes with cumulative ordinal bases — the
    whole cold region's header surface.  For a linear store ordinal IS
    height, so ``header_at_height`` is two integer compares and one
    80-byte pread."""

    def __init__(self, indexes: list[SegmentIndex]):
        self.indexes = indexes
        self.bases: list[int] = []
        total = 0
        for idx in indexes:
            self.bases.append(total)
            total += idx.count
        self.count = total

    def close(self) -> None:
        for idx in self.indexes:
            idx.close()

    def _locate(self, ordinal: int) -> tuple[SegmentIndex, int] | None:
        if not 0 <= ordinal < self.count:
            return None
        lo, hi = 0, len(self.indexes) - 1
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if self.bases[mid] <= ordinal:
                lo = mid
            else:
                hi = mid - 1
        return self.indexes[lo], ordinal - self.bases[lo]

    def header_at(self, ordinal: int) -> bytes | None:
        loc = self._locate(ordinal)
        return None if loc is None else loc[0].header_at(loc[1])

    def hash_at(self, ordinal: int) -> bytes | None:
        hdr = self.header_at(ordinal)
        return None if hdr is None else sha256d(hdr)

    def find_txid(self, txid: bytes) -> tuple[int, SegmentIndex, int] | None:
        """(global ordinal, owning index, local ordinal) for ``txid``,
        searching newest segments first (recent history is the common
        query)."""
        for i in range(len(self.indexes) - 1, -1, -1):
            local = self.indexes[i].find_txid(txid)
            if local is not None:
                return self.bases[i] + local, self.indexes[i], local
        return None


class ArchiveChain:
    """Serve-only archive boot: a bounded hot ``Chain`` window anchored
    on a snapshot, backed by the header plane for everything below the
    base.  RAM is O(hot window + accounts + touched pages).

    Trust model: the snapshot passed chain/snapshot.py's integrity
    gates and the store is this host's own (or a verified copy); the
    plane's headers can additionally be PoW-replay-verified
    (``verify_headers``) — O(chain) time, O(1) RAM."""

    def __init__(self, store, snapshot_path, difficulty: int, retarget=None):
        from p1_tpu_torch.chain.chain import Chain
        from p1_tpu_torch.chain.segstore import SegmentedStore
        from p1_tpu_torch.chain.snapshot import load_snapshot

        if not isinstance(store, SegmentedStore):
            store = SegmentedStore(store)
        self.store = store
        snap = load_snapshot(snapshot_path)
        self.base_height = snap.height
        self.chain = Chain.from_snapshot(difficulty, snap, retarget=retarget)
        self.plane = HeaderPlane(self._open_indexes())
        anchor = self.plane.hash_at(snap.height)
        if anchor is not None and anchor != snap.manifest.block.block_hash():
            raise ValueError(
                f"snapshot anchor at height {snap.height} does not match "
                "the store's header plane — wrong snapshot for this archive"
            )
        self._replay_tail()

    def _open_indexes(self) -> list:
        """A ``SegmentIndex`` per segment, building any missing sidecar
        from the segment bytes (sealed segments only get written once;
        the active tail is indexed in the hot chain, not the plane)."""
        out = []
        prev_last: bytes | None = None
        for seg in self.store._segments_for_read():
            hx = self.store.hdrx_path(seg)
            # The unsealed tail's sidecar goes stale with every append,
            # so it is rebuilt at attach; sealed segments build once.
            if not hx.exists() or not seg.sealed:
                if seg.pruned:
                    raise ValueError(
                        f"{hx}: pruned segment lost its header-plane "
                        "sidecar — the header chain has a hole"
                    )
                write_segment_index(
                    self.store._read_bytes_path(self.store._seg_path(seg)), hx
                )
            idx = SegmentIndex(hx, verify=False)
            if idx.count:
                first = idx.header_at(0)
                if prev_last is not None and first[4:36] != sha256d(prev_last):
                    raise ValueError(
                        f"{hx}: segment does not extend its predecessor — "
                        "archive serving needs a linear (compacted) store"
                    )
                prev_last = idx.header_at(idx.count - 1)
            out.append(idx)
        return out

    def _replay_tail(self) -> None:
        """Connect every record above the snapshot base into the hot
        chain (trusted resume — this host validated them before they
        were persisted).  Ordinal == height on a linear store, so the
        records to replay are exactly ordinals base+1..count-1 plus
        anything in the active (un-indexed) segment."""
        from p1_tpu_torch.core.block import Block

        ordinal = -1  # genesis is record 0 in a linear store
        for i, seg in enumerate(self.store._segments_for_read()):
            count = self.plane.indexes[i].count
            if seg.pruned or ordinal + count <= self.base_height:
                # Wholly below the base (or bodiless): the plane's
                # count stands in for a scan — boot cost is O(tail +
                # segments), never O(chain) bytes.
                ordinal += count
                continue
            data = self.store._read_bytes_path(self.store._seg_path(seg))
            spans = ChainStore.scan(data).spans
            for off, n in spans:
                ordinal += 1
                if ordinal <= self.base_height:
                    continue
                self.chain.add_block(
                    Block.deserialize(data[off : off + n]), trusted=True
                )
            del data

    # -- the query surface -------------------------------------------------

    @property
    def height(self) -> int:
        return self.chain.height

    def header_bytes_at(self, height: int) -> bytes | None:
        """The 80-byte header at ``height`` — plane below the base, hot
        window above."""
        if height > self.base_height:
            bhash = self.chain.main_hash_at(height)
            if bhash is None:
                return None
            return self.chain.header_of(bhash).serialize()
        return self.plane.header_at(height)

    def hash_at(self, height: int) -> bytes | None:
        if height > self.base_height:
            return self.chain.main_hash_at(height)
        return self.plane.hash_at(height)

    def balance(self, account: str) -> int:
        return self.chain.balance(account)

    def nonce(self, account: str) -> int:
        return self.chain.nonce(account)

    def tx_proof(self, txid: bytes):
        """An SPV inclusion proof for ``txid`` — hot window first, then
        the plane's txid index (cold proofs read ONE record back from
        its segment; pruned ranges are not servable, same refusal the
        pruned node mode makes on the wire)."""
        import dataclasses as _dc

        from p1_tpu_torch.chain.proof import build_block_proofs
        from p1_tpu_torch.core.block import Block

        proof = self.chain.tx_proof(txid)
        if proof is not None:
            return proof
        hit = self.plane.find_txid(txid)
        if hit is None:
            return None
        height, idx, local = hit
        seg_name = Path(idx.path).name.replace(".hdrx", ".p1s")
        seg_path = Path(idx.path).with_name(seg_name)
        if not seg_path.exists():
            return None  # pruned body: headers survive, proofs don't
        off, n = idx.record_span(local)
        with open(seg_path, "rb") as f:
            f.seek(off)
            raw = f.read(n)
        block = Block.deserialize(raw)
        template = build_block_proofs(block, height).get(txid)
        if template is None:
            return None
        return _dc.replace(template, tip_height=self.chain.height)

    def verify_headers(self, retarget=None):
        """Whole-archive PoW + linkage proof over the packed plane —
        one ``replay_packed`` call per segment blob, O(1) RAM."""
        from p1_tpu_torch.chain.replay import replay_packed

        raw, count = self.store.packed_headers()
        return replay_packed(raw, retarget=retarget), count

    def close(self) -> None:
        self.plane.close()
        self.store.close()
