"""Read-only replica workers: the query serving plane (`p1 serve`).

The scaling problem: every headers/filters/proof
query a node answers runs on its single consensus asyncio thread — the
same thread that validates blocks, settles reorgs, and feeds the miner.
Query fan-out therefore could not scale past one core, and a heavy read
load was indistinguishable from an attack.  This module moves the READ
side of the protocol into separate processes that share nothing with
the consensus loop but the append-only store file itself:

- **No writer flock, ever.**  A replica opens the store read-only and
  never calls ``ChainStore.acquire`` — the live node (or ``p1 fsck`` /
  ``p1 compact``) keeps exclusive writership, and any number of
  replicas attach concurrently.  The append-only discipline is what
  makes this safe: a record, once checksum-valid at offset X, never
  changes (heals/compactions REPLACE the inode, which the replica
  detects by ``st_ino`` and handles by a clean rescan).

- **mmap + incremental tail scan.**  The file is memory-mapped; the v3
  checksum framing (chain/store.py) is walked once at attach and then
  only over the newly appended tail on each ``refresh()`` — headers
  are served as raw 80-byte mmap slices (no object parse:
  ``protocol.encode_headers_raw``), block bodies as raw record slices,
  and the per-record work is three SHA-256d digests per transaction at
  attach time (txid index) plus fork choice over header fields.  A
  torn tail (the writer's in-flight record) simply fails its CRC and
  is retried on the next refresh.

- **The same serving caches as the node.**  Proofs go through a
  ``ProofCache`` (chain/proof.py — whole-block merkle amortization +
  serialized-payload memoization + 4-byte tip patches) and filters
  through a ``FilterIndex`` (chain/filters.py), so a replica's steady-
  state QPS is dict lookups and byte splices, measured in
  benchmarks/query_plane.py.

- **Governor admission.**  Every session gets a per-peer query budget
  (node/governor.py ``ResourceGovernor``) charged at the dispatch
  door, same classes and same economics as the full node — a replica
  is cheap, not free.

``p1 serve --workers N`` runs N such processes against one store on one
port via ``SO_REUSEPORT``, so host query throughput scales with cores
while the consensus node only mines and validates.

The port's copy of ``p1_tpu/node/queryplane.py``: host code, as in the
reference; no kernel lies on its path.
"""

from __future__ import annotations

import asyncio
import collections
import logging
import mmap
import os
import secrets
import struct
import time
from pathlib import Path

from p1_tpu_torch.chain.filters import FilterHeaderChain, FilterIndex
from p1_tpu_torch.chain.proof import ProofCache, build_block_proofs
from p1_tpu_torch.chain.store import MAGIC, V2_MAGIC, ChainStore
from p1_tpu_torch.core.block import Block
from p1_tpu_torch.core.genesis import make_genesis
from p1_tpu_torch.core.hashutil import sha256d
from p1_tpu_torch.core.header import HEADER_SIZE
from p1_tpu_torch.node import protocol
from p1_tpu_torch.node.governor import (
    CLASS_QUERIES,
    WRITE_QUEUE_MAX,
    ResourceGovernor,
)
from p1_tpu_torch.node.protocol import Hello, MsgType
from p1_tpu_torch.node.subscriptions import SubscriptionManager, block_items_index

log = logging.getLogger("p1_tpu_torch.queryplane")

_LEN = struct.Struct(">I")
_CRC_SIZE = 4

#: Serving caps, mirroring the node's (one query must not pin the loop).
HEADERS_BATCH = 2000
FILTER_BATCH = 1000
SYNC_BATCH = 500
SYNC_BYTES = 8 << 20

#: A replica holds no per-peer consensus state, so it can afford far
#: more concurrent sessions than a node's MAX_PEERS — this is the knob
#: that lets thousands of light clients fan out across a few workers.
MAX_SESSIONS = 2048

#: How long a session may sit silent before the replica closes it.
#: No PING probing here — reconnecting to a replica is cheap, and the
#: simple read deadline keeps dead sockets from pinning session slots.
IDLE_TIMEOUT_S = 120.0


class _Entry:
    """One indexed record: everything fork choice and serving need,
    without retaining a single parsed object."""

    __slots__ = ("height", "work", "prev", "off", "length")

    def __init__(self, height: int, work: int, prev: bytes, off: int, length: int):
        self.height = height
        self.work = work
        self.prev = prev
        #: Packed payload location: ``(source index << _SRC_SHIFT) |
        #: byte offset`` into that source's mmap — source 0 is the
        #: whole file for a single-file store, one source per segment
        #: for a segmented one.  0 = genesis (no record anywhere).
        self.off = off
        self.length = length


#: Packed-offset split for ``_Entry.off``: low bits are the byte offset
#: inside one mapped source (44 bits ≫ any segment bound), high bits the
#: source index.
_SRC_SHIFT = 44
_SRC_MASK = (1 << _SRC_SHIFT) - 1


class _SegSrc:
    """One memory-mapped record source (the single file, or one
    segment): its scan cursor plus the inode pin that detects
    heal/compaction rewrites underneath us."""

    __slots__ = ("name", "fd", "mm", "mapped", "ino", "off")

    def __init__(self, name: str, fd: int):
        self.name = name
        self.fd = fd
        self.mm: mmap.mmap | None = None
        self.mapped = 0
        self.ino = os.fstat(fd).st_ino
        self.off = 0  # next unscanned byte

    def close(self) -> None:
        if self.mm is not None:
            self.mm.close()
            self.mm = None
        if self.fd is not None:
            os.close(self.fd)
            self.fd = None


class ReplicaView:
    """A flock-free, incrementally refreshed read view of a chain store.

    Correctness model: the store is the node's own append-only log of
    blocks it fully validated before persisting, protected per record by
    the v3 CRC (chain/store.py) — the replica therefore TRUSTS record
    contents the same way the node's own ``trusted=True`` resume does,
    and spends its cycles on indexing, not revalidation.  Clients
    verify what they receive anyway (headers by PoW replay, proofs by
    merkle recombination — the protocol is evidence-based end to end).
    """

    def __init__(self, path: str | os.PathLike, difficulty: int, retarget=None):
        self.path = Path(path)
        self.difficulty = difficulty
        self.retarget = retarget
        self.genesis = make_genesis(difficulty, retarget)
        self.proof_cache = ProofCache()
        self.filter_index = FilterIndex()
        #: The replica's own filter-header commitment chain, rebuilt
        #: from record bytes at attach and advanced per refresh.  It is
        #: DERIVED, not copied: filters are pure functions of block
        #: bytes, so this replica's chain matches the writer's — and a
        #: wallet cross-checking two replicas compares commitments
        #: neither could forge independently.
        self.filter_headers = FilterHeaderChain()
        #: Mapped record sources, in record order: [whole file] for the
        #: single-file layout, one per segment (manifest order) for a
        #: segmented store — ``_Entry.off`` packs the source index.
        self._srcs: list[_SegSrc] = []
        self._by_name: dict[str, _SegSrc] = {}
        self._segmented = False
        self._manifest_key: tuple | None = None
        self._manifest_rows: list = []
        self.records = 0
        self.rescans = 0  # full rescans (inode change / truncation)
        self.refreshes = 0
        self._entries: dict[bytes, _Entry] = {}
        self._pending: dict[bytes, list[tuple[bytes, bytes, int, int]]] = {}
        self._tx_index: dict[bytes, bytes | list[bytes]] = {}
        self._main: list[bytes] = []
        self._tip: bytes = b""
        #: Snapshot-bootstrap base (node/provision.py): when a
        #: ``.bootbase`` sidecar sits next to the store, heights
        #: ``1..assumed_base`` are ADOPTED — PoW-verified headers and
        #: peer-served filter headers without bodies on disk (the
        #: snapshot carries the state, not the history).  Queries below
        #: the base refuse bodies/filters honestly, exactly like a
        #: pruned archive; 0 = ordinary full store.
        self.assumed_base = 0
        self._boot_headers: list[bytes] = []  # heights 1..base
        self._boot_fheaders: list[bytes] = []  # heights 0..base
        self._load_bootbase()
        self._reset_index()
        self.refresh()

    # -- attach / rescan ---------------------------------------------------

    def _load_bootbase(self) -> None:
        """Read the ``.bootbase`` sidecar (if any) a snapshot bootstrap
        left next to the store, and verify its adopted header prefix
        actually links from OUR genesis — a sidecar written against a
        different chain (or torn mid-write, which read_bootbase already
        rejects) must fail the attach, not serve a phantom history."""
        from p1_tpu_torch.node.provision import read_bootbase

        bb = read_bootbase(self.path)
        if bb is None:
            return
        base, headers, fheaders = bb
        prev = self.genesis.block_hash()
        for hdr in headers:
            if hdr[4:36] != prev:
                raise ValueError(
                    f"{self.path}: bootbase sidecar does not link from"
                    " this chain's genesis"
                )
            prev = sha256d(hdr)
        self.assumed_base = base
        self._boot_headers = headers
        self._boot_fheaders = fheaders

    def _reset_index(self) -> None:
        ghash = self.genesis.block_hash()
        self._entries = {
            ghash: _Entry(0, 1 << self.difficulty, b"", 0, 0)
        }
        self._pending = {}
        self._tx_index = {
            tx.txid(): ghash for tx in self.genesis.txs
        }
        self._main = [ghash]
        self._tip = ghash
        self.records = 0
        if self.assumed_base:
            self._seed_bootbase()

    def _seed_bootbase(self) -> None:
        """Seed the adopted prefix (heights ``1..assumed_base``) into a
        fresh index — called from every ``_reset_index`` so full rescans
        (inode replaced, layout change) re-adopt the base before the
        store's body records (all above the base) re-connect to it.
        Adopted entries carry ``off=0`` with height > 0: the existing
        raw_record contract already reads that as "no bytes anywhere",
        which IS the honest body refusal below the base."""
        work = self._entries[self._tip].work
        prev_hash = self._tip
        for h, hdr in enumerate(self._boot_headers, start=1):
            bhash = sha256d(hdr)
            work += 1 << _header_difficulty(hdr)
            self._entries[bhash] = _Entry(h, work, hdr[4:36], 0, 0)
            self._main.append(bhash)
            prev_hash = bhash
        self._tip = prev_hash
        # Adopt the peer-served commitment prefix wholesale: filters
        # below the base cannot be recomputed (no bodies), and sync()
        # extends above it from real record bytes.  Only when shorter —
        # a live rescan must not wipe commitments already derived.
        if len(self.filter_headers) <= self.assumed_base:
            self.filter_headers.seed(
                list(
                    zip(
                        self._main[: self.assumed_base + 1],
                        self._boot_fheaders,
                    )
                )
            )

    def close(self) -> None:
        for src in self._srcs:
            src.close()
        self._srcs = []
        self._by_name = {}
        self._manifest_key = None
        self._manifest_rows = []

    def _full_reset(self) -> None:
        """Void every cached offset and start over (inode replaced,
        file truncated, layout changed).  Caches keyed by block hash
        (proofs, filters) stay valid: a hash names the same bytes in
        any inode."""
        self.close()
        self._reset_index()
        self.rescans += 1

    def _slice(self, packed_off: int, length: int) -> bytes:
        src = self._srcs[packed_off >> _SRC_SHIFT]
        off = packed_off & _SRC_MASK
        return bytes(src.mm[off : off + length])

    def refresh(self) -> int:
        """Bring the view up to date with the store; returns how many
        new records were indexed.  NEVER takes any lock — reading races
        the writer only at the torn tail, which the per-record CRC
        resolves (an incomplete record fails its checksum and is
        retried on the next refresh, after the writer's flush
        completes).  Segmented stores re-read the manifest when its
        inode moves (every roll rewrites it) and keep per-segment scan
        cursors: sealed history is scanned once, only the ACTIVE
        segment is re-walked — and a single-file store upgrading to
        segments under a live attach is detected as a layout change
        and triggers one clean rescan."""
        try:
            head = b""
            with open(self.path, "rb") as f:
                head = f.read(len(MAGIC))
        except FileNotFoundError:
            # Store not created yet (node about to boot): empty view.
            self.close()
            self._reset_index()
            return 0
        from p1_tpu_torch.chain.segstore import SEG_MAGIC

        segmented = head == SEG_MAGIC
        if self._srcs and segmented != self._segmented:
            self._full_reset()  # live upgrade: single file became a manifest
        self._segmented = segmented
        old_tip = self._tip
        new = (
            self._refresh_segmented()
            if segmented
            else self._refresh_single(head)
        )
        if new is None:  # a source was replaced underneath us: rescan
            self._full_reset()
            new = (
                self._refresh_segmented()
                if segmented
                else self._refresh_single(head)
            )
            new = new or 0
        if new:
            self.records += new
            if (
                self._tip != old_tip
                or len(self._main) - 1 != self._entries[self._tip].height
            ):
                self._rebuild_main()
            self.filter_headers.sync(
                self.tip_height, self.hash_at, self.filter_at
            )
        self.refreshes += 1
        return new

    def _open_src(self, name: str, path) -> _SegSrc | None:
        try:
            fd = os.open(path, os.O_RDONLY)
        except FileNotFoundError:
            return None
        src = _SegSrc(name, fd)
        self._srcs.append(src)
        self._by_name[name] = src
        return src

    def _scan_src(self, src: _SegSrc, path) -> int | None:
        """Advance one source's scan cursor; returns records indexed,
        or None when the file was replaced/truncated underneath us
        (caller does a full rescan)."""
        try:
            st = os.stat(path)
        except FileNotFoundError:
            return None
        if st.st_ino != src.ino or st.st_size < src.mapped:
            return None
        size = os.fstat(src.fd).st_size
        if size < len(MAGIC):
            return 0
        if size > src.mapped:
            if src.mm is not None:
                src.mm.close()
            src.mm = mmap.mmap(src.fd, size, prot=mmap.PROT_READ)
            src.mapped = size
        mm = src.mm
        if src.off == 0:
            head = bytes(mm[: len(MAGIC)])
            if head == V2_MAGIC:
                raise ValueError(
                    f"{self.path}: v2 chain store — upgrade with `p1 fsck`"
                    " or `p1 compact` before serving replicas"
                )
            if head != MAGIC:
                return 0  # torn first write mid-roll: retry next refresh
            src.off = len(MAGIC)
        src_idx = self._srcs.index(src)
        new = 0
        while src.off < src.mapped:
            end = ChainStore._v3_record_at(mm, src.off)
            if end is None:
                # Torn tail (writer mid-append) or trailing damage the
                # writer will heal: stop here, retry next refresh.
                break
            p_off = src.off + _LEN.size
            p_len = end - p_off - _CRC_SIZE
            self._index_record(
                src_idx, mm, (src_idx << _SRC_SHIFT) | p_off, p_off, p_len
            )
            src.off = end
            new += 1
        return new

    def _refresh_single(self, head: bytes) -> int | None:
        if not self._srcs:
            if head and head != MAGIC and head != V2_MAGIC and len(head) >= len(MAGIC):
                raise ValueError(f"{self.path}: not a chain store")
            if self._open_src("", self.path) is None:
                return 0
        return self._scan_src(self._srcs[0], self.path)

    def _refresh_segmented(self) -> int | None:
        from p1_tpu_torch.chain.segstore import SegmentInfo, read_manifest

        try:
            mst = os.stat(self.path)
        except FileNotFoundError:
            return None
        key = (mst.st_ino, mst.st_size, mst.st_mtime_ns)
        if key != self._manifest_key:
            manifest = read_manifest(self.path)
            if manifest is None:
                return 0  # mid-replace race: retry next refresh
            self._manifest_rows = [
                SegmentInfo.from_json(r) for r in manifest.get("segments", [])
            ]
            self._manifest_key = key
        seg_dir = self.path.with_name(self.path.name + ".d")
        total = 0
        for row in self._manifest_rows:
            if row.pruned:
                raise ValueError(
                    f"{self.path}: pruned store cannot back a replica — "
                    "deep bodies are gone; serve from an archive copy"
                )
            src = self._by_name.get(row.name)
            path = seg_dir / row.name
            if src is None:
                src = self._open_src(row.name, path)
                if src is None:
                    break  # manifest ahead of the directory: retry later
            n = self._scan_src(src, path)
            if n is None:
                return None  # heal/compaction replaced this segment
            total += n
        return total

    def _index_record(
        self, src_idx: int, mm, packed_off: int, off: int, length: int
    ) -> None:
        """Index one checksum-valid record at payload ``off`` in
        ``mm``: header digest, fork choice, txid index — no object
        construction.  ``packed_off`` is what the entry retains."""
        hdr = bytes(mm[off : off + HEADER_SIZE])
        if len(hdr) < HEADER_SIZE:
            return
        bhash = sha256d(hdr)
        if bhash in self._entries:
            return  # duplicate record (e.g. a snapshot's genesis row)
        prev = hdr[4:36]  # BlockHeader layout: u32 version + 32s prev_hash
        parent = self._entries.get(prev)
        if parent is None:
            # Out-of-line record (shouldn't happen in a node's log, which
            # appends in connect order — but a foreign/hand-built store
            # may interleave): park until the parent shows up.
            self._pending.setdefault(prev, []).append(
                (bhash, hdr, packed_off, length)
            )
            return
        self._connect(bhash, hdr, packed_off, length, parent)
        # Drain anything that was waiting on this block, recursively.
        queue = [bhash]
        while queue:
            for child, chdr, coff, clen in self._pending.pop(queue.pop(), []):
                self._connect(
                    child, chdr, coff, clen, self._entries[chdr[4:36]]
                )
                queue.append(child)

    def _connect(self, bhash, hdr, off, length, parent) -> None:
        diff = _header_difficulty(hdr)
        entry = _Entry(
            parent.height + 1, parent.work + (1 << diff), hdr[4:36], off, length
        )
        self._entries[bhash] = entry
        tip = self._entries[self._tip]
        if entry.work > tip.work or (
            entry.work == tip.work and bhash < self._tip
        ):
            self._tip = bhash
        self._index_txids(bhash, off, length)

    def _index_txids(self, bhash: bytes, packed_off: int, length: int) -> None:
        """txid -> block hash entries for one record, hashing raw tx
        slices straight off the map (no Transaction objects)."""
        mm = self._srcs[packed_off >> _SRC_SHIFT].mm
        off = packed_off & _SRC_MASK
        end = off + length
        pos = off + HEADER_SIZE
        if pos + 4 > end:
            return
        (ntx,) = _LEN.unpack_from(mm, pos)
        pos += 4
        for _ in range(ntx):
            if pos + 4 > end:
                return  # malformed (CRC-valid but not a block): serve raw only
            (tlen,) = _LEN.unpack_from(mm, pos)
            pos += 4
            if pos + tlen > end:
                return
            txid = sha256d(bytes(mm[pos : pos + tlen]))
            pos += tlen
            have = self._tx_index.get(txid)
            if have is None:
                self._tx_index[txid] = bhash
            elif isinstance(have, bytes):
                if have != bhash:
                    self._tx_index[txid] = [have, bhash]
            elif bhash not in have:
                have.append(bhash)

    def _rebuild_main(self) -> None:
        """Re-derive the height -> hash list for the current tip.  Walks
        back only until it meets the old main chain (O(new blocks + fork
        depth)), the incremental trick Chain's reorg paths use."""
        suffix: list[bytes] = []
        h = self._tip
        while True:
            entry = self._entries[h]
            if (
                entry.height < len(self._main)
                and self._main[entry.height] == h
            ):
                break
            suffix.append(h)
            if entry.height == 0:
                break
            h = entry.prev
        keep = self._entries[suffix[-1]].height if suffix else len(self._main)
        del self._main[keep:]
        self._main.extend(reversed(suffix))

    # -- queries -----------------------------------------------------------

    @property
    def tip_height(self) -> int:
        return len(self._main) - 1

    def _is_main(self, bhash: bytes) -> bool:
        entry = self._entries.get(bhash)
        return (
            entry is not None
            and entry.height < len(self._main)
            and self._main[entry.height] == bhash
        )

    def raw_record(self, bhash: bytes) -> bytes | None:
        entry = self._entries.get(bhash)
        if entry is None or entry.off == 0:
            if entry is not None and entry.height == 0:
                return self.genesis.serialize()
            return None
        return self._slice(entry.off, entry.length)

    def read_block(self, bhash: bytes) -> Block | None:
        raw = self.raw_record(bhash)
        if raw is None:
            return None
        return Block.deserialize(raw)

    def raw_header(self, height: int) -> bytes | None:
        if not 0 <= height < len(self._main):
            return None
        entry = self._entries[self._main[height]]
        if entry.off == 0:
            if height == 0:
                return self.genesis.header.serialize()
            if height <= self.assumed_base:
                # Adopted bootbase header: on main at height > 0 with no
                # record bytes, the only entries with off 0 are the
                # seeded prefix — serve the header the bootstrap
                # PoW-verified (a bootstrapped replica can feed another
                # replica's header sync).
                return self._boot_headers[height - 1]
            return None
        return self._slice(entry.off, HEADER_SIZE)

    def _start_after(self, locator: list[bytes]) -> int:
        for h in locator:
            entry = self._entries.get(h)
            if entry is not None and self._is_main(h):
                return entry.height + 1
        return 0

    def headers_after(self, locator: list[bytes], limit: int = HEADERS_BATCH):
        start = self._start_after(locator)
        end = min(start + limit, len(self._main))
        return [self.raw_header(h) for h in range(start, end)]

    def blocks_after(
        self,
        locator: list[bytes],
        limit: int = SYNC_BATCH,
        max_bytes: int = SYNC_BYTES,
    ):
        start = self._start_after(locator)
        end = min(start + limit, len(self._main))
        out, total = [], 0
        for h in range(start, end):
            raw = self.raw_record(self._main[h])
            if raw is None:
                # Adopted bootbase height: the body was never on this
                # disk.  Stop — a short (or empty) reply is the same
                # honest refusal a pruned archive gives.
                break
            total += len(raw) + 4
            if out and total > max_bytes:
                break
            out.append(raw)
        return out

    def filters_range(self, start: int, count: int):
        """(block hash, filter) pairs for main heights [start, start+count)."""
        out = []
        for h in range(start, min(start + count, len(self._main))):
            if 0 < h <= self.assumed_base:
                break  # bodyless adopted height: refuse, never guess
            bhash = self._main[h]
            fbytes = self.filter_index.get_or_build(
                bhash, lambda bh: self.read_block(bh)
            )
            out.append((bhash, fbytes))
        return out

    # -- subscription source (node/subscriptions.py duck type) -------------

    def hash_at(self, height: int) -> bytes | None:
        if 0 <= height < len(self._main):
            return self._main[height]
        return None

    def raw_header_at(self, height: int) -> bytes | None:
        return self.raw_header(height)

    def filter_at(self, height: int) -> bytes | None:
        if 0 < height <= self.assumed_base:
            return None  # bodyless adopted height (bootbase)
        bhash = self.hash_at(height)
        if bhash is None:
            return None
        return self.filter_index.get_or_build(
            bhash, lambda bh: self.read_block(bh)
        )

    def fheader_at(self, height: int) -> bytes | None:
        return self.filter_headers.header_at(height)

    def block_items_at(self, height: int):
        bhash = self.hash_at(height)
        if bhash is None:
            return None
        block = self.read_block(bhash)
        if block is None:
            return None
        return block_items_index(block)

    def proof_payload(self, txid: bytes) -> bytes:
        """The wire PROOF reply for ``txid`` at this view's tip — same
        cache economics as the node's ``_proof_payload``."""
        have = self._tx_index.get(txid)
        if have is None:
            return protocol.encode_proof(None)
        candidates = [have] if isinstance(have, bytes) else have
        bhash = next((b for b in candidates if self._is_main(b)), None)
        if bhash is None:
            return protocol.encode_proof(None)
        entry = self.proof_cache.get(bhash, txid)
        if entry is None:
            block = self.read_block(bhash)
            if block is None:
                return protocol.encode_proof(None)
            height = self._entries[bhash].height
            txids = [tx.txid() for tx in block.txs]
            for tid, proof in build_block_proofs(block, height, txids).items():
                e = self.proof_cache.add(bhash, tid, proof)
                if tid == txid:
                    entry = e
        if entry.payload is None:
            self.proof_cache.note_payload(
                entry, protocol.encode_proof(entry.proof)
            )
        return protocol.patch_proof_tip(entry.payload, self.tip_height)


def _header_difficulty(hdr: bytes) -> int:
    """The u32 difficulty field straight out of an 80-byte header record
    (core/header.py ``>I32s32sIII``: bytes 72..76) — the one header
    field fork choice needs per record, read without an object parse."""
    return struct.unpack_from(">I", hdr, 72)[0]


class QueryPlaneServer:
    """One replica worker: an asyncio server speaking the READ subset of
    the wire protocol over a ``ReplicaView``, behind governor admission.

    Served: HELLO, GETHEADERS, GETFILTERS, GETPROOF, GETBLOCKS,
    GETSTATUS, PING.  Everything write-shaped (BLOCK/TX pushes) or
    ledger-shaped (GETACCOUNT, GETFEES, GETMEMPOOL — they need tip
    state only the consensus node holds) is ignored; a client that
    needs those talks to the node.
    """

    def __init__(
        self,
        view: ReplicaView,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        refresh_interval_s: float = 0.25,
        max_sessions: int = MAX_SESSIONS,
        idle_timeout_s: float = IDLE_TIMEOUT_S,
        reuse_port: bool = False,
        governor: ResourceGovernor | None = None,
    ):
        self.view = view
        self.host = host
        self._want_port = port
        self.port: int | None = None
        self.refresh_interval_s = refresh_interval_s
        self.max_sessions = max_sessions
        self.idle_timeout_s = idle_timeout_s
        self.reuse_port = reuse_port
        self.governor = governor or ResourceGovernor()
        # Telemetry registry (node/telemetry.py): replica-side query
        # latency + the counters below, served over GETMETRICS exactly
        # like the consensus node's.  Host clock by design — the
        # replica is a real-socket separate-process tier the simulator
        # never runs.
        from p1_tpu_torch.node.telemetry import MetricsRegistry

        self.telemetry = MetricsRegistry()
        #: The wallet push plane (node/subscriptions.py): watch-filter
        #: subscriptions notified from the refresh loop at each new
        #: record batch, degrading slow consumers down the
        #: coalesce → drop-to-cursor → disconnect ladder.
        self.subscriptions = SubscriptionManager(
            view, registry=self.telemetry
        )
        self.instance_nonce = secrets.randbits(64) | 1
        self._server: asyncio.Server | None = None
        self._sessions: set[asyncio.Task] = set()
        self._refresh_task: asyncio.Task | None = None
        self._running = False
        self.started_at = time.monotonic()
        self.queries_served = collections.Counter()
        self.admission_dropped = 0
        self.sessions_refused = 0
        self.sessions_total = 0
        #: Sessions disconnected at the hard write-queue cap — the same
        #: squat guard node sessions have: a subscriber (or a client
        #: that keeps asking without reading) cannot pin replica memory.
        self.sessions_dropped_squat = 0
        #: Rolling per-second query counts for the QPS figure (last 60 s).
        self._qps_window: collections.deque[tuple[int, int]] = (
            collections.deque(maxlen=60)
        )

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        self._running = True
        self.started_at = time.monotonic()
        self._server = await asyncio.start_server(
            self._on_client,
            self.host,
            self._want_port,
            reuse_port=self.reuse_port or None,
        )
        self.port = self._server.sockets[0].getsockname()[1]
        self._refresh_task = asyncio.create_task(self._refresh_loop())
        self._refresh_task.add_done_callback(self._refresh_done)
        log.info(
            "replica serving %s on %s:%d (tip height %d)",
            self.view.path,
            self.host,
            self.port,
            self.view.tip_height,
        )

    async def drain(self) -> int:
        """Graceful replica drain (`p1 serve` on SIGTERM): stop
        accepting new sessions FIRST, push a final EVENTGAP resume
        cursor to every live subscriber so wallets fail over instantly
        instead of waiting out a dead socket, then stop.  Returns how
        many subscribers were drained.

        The listener is closed here but awaited in ``stop``: from Python
        3.12.1 on, ``Server.wait_closed`` waits for every accepted
        connection to close, and a live subscriber's session closes
        only after its final cursor, so awaiting it before the drain
        would never return."""
        if self._server is not None:
            self._server.close()
        drained = await self.subscriptions.drain()
        await self.stop()
        return drained

    async def stop(self) -> None:
        self._running = False
        self.subscriptions.close_all()
        if self._refresh_task is not None:
            self._refresh_task.cancel()
            await asyncio.gather(self._refresh_task, return_exceptions=True)
            self._refresh_task = None
        for task in list(self._sessions):
            task.cancel()
        await asyncio.gather(*self._sessions, return_exceptions=True)
        self._sessions.clear()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        self.view.close()

    def _refresh_done(self, task: asyncio.Task) -> None:
        """A refresh loop that dies of an unexpected exception (the
        per-iteration handler only expects OSError/ValueError) would
        strand the replica serving an ever-staler tip with no sign of
        trouble — same lost-task shape as the node's dead
        store-recovery loop, same cure: observe the wreck, log it, and
        respawn while still running (the loop's leading sleep keeps a
        persistent crash from spinning)."""
        if task.cancelled():
            return
        exc = task.exception()
        if exc is None:
            return
        log.error("replica refresh loop died: %r — respawning", exc)
        if self._running:
            self._refresh_task = asyncio.create_task(self._refresh_loop())
            self._refresh_task.add_done_callback(self._refresh_done)

    async def _refresh_loop(self) -> None:
        while self._running:
            await asyncio.sleep(self.refresh_interval_s)
            try:
                if self.view.refresh():
                    await self.subscriptions.notify()
            except (OSError, ValueError) as e:
                # A transient read fault or a mid-run store replacement
                # with something unreadable: keep serving the view we
                # hold and keep retrying — a replica that dies of one
                # bad stat() defeats its purpose.
                log.warning("replica refresh failed: %s", e)

    # -- sessions ----------------------------------------------------------

    def _count_query(self, mtype) -> None:
        self.queries_served[mtype.name] += 1
        now = int(time.monotonic())
        if self._qps_window and self._qps_window[-1][0] == now:
            sec, n = self._qps_window[-1]
            self._qps_window[-1] = (sec, n + 1)
        else:
            self._qps_window.append((now, 1))

    def qps(self) -> float:
        """Queries/s over the rolling window (excludes the current
        second only if it is the lone sample)."""
        if not self._qps_window:
            return 0.0
        span = max(1, self._qps_window[-1][0] - self._qps_window[0][0] + 1)
        return sum(n for _, n in self._qps_window) / span

    def status(self) -> dict:
        v = self.view
        return {
            "role": "replica",
            "store": str(v.path),
            "height": v.tip_height,
            "tip": v._main[-1].hex() if v._main else "",
            "records": v.records,
            "refreshes": v.refreshes,
            "rescans": v.rescans,
            "assumed_base": v.assumed_base,
            "sessions": len(self._sessions),
            "sessions_total": self.sessions_total,
            "sessions_refused": self.sessions_refused,
            "sessions_dropped_squat": self.sessions_dropped_squat,
            "filter_headers": len(self.view.filter_headers),
            "subscriptions": self.subscriptions.snapshot(),
            "queries": {
                "served": dict(self.queries_served),
                "total": sum(self.queries_served.values()),
                "qps": round(self.qps(), 1),
                "admission_dropped": self.admission_dropped,
                "proof_cache": v.proof_cache.snapshot(),
                "filter_cache": v.filter_index.snapshot(),
            },
        }

    def _hello(self) -> bytes:
        return protocol.encode_hello(
            Hello(
                self.view.genesis.block_hash(),
                self.view.tip_height,
                self.port or 0,
                self.instance_nonce,
            )
        )

    async def _on_client(self, reader, writer) -> None:
        if len(self._sessions) >= self.max_sessions:
            self.sessions_refused += 1
            writer.close()
            return
        task = asyncio.current_task()
        self._sessions.add(task)
        self.sessions_total += 1
        sid = self.sessions_total
        subscribed = False
        budget = self.governor.budget()

        async def push(payload: bytes) -> None:
            # Pushes never drain: the transport buffer is the bounded
            # subscription queue, read back by the ladder below.
            protocol.write_frame_nowait(writer, payload)

        def buffer_size() -> int:
            transport = writer.transport
            return (
                transport.get_write_buffer_size()
                if transport is not None
                else 0
            )

        try:
            await protocol.write_frame(writer, self._hello())
            payload = await asyncio.wait_for(
                protocol.read_frame(reader), timeout=10.0
            )
            mtype, hello = protocol.decode(payload)
            if mtype is not MsgType.HELLO:
                raise protocol.ProtocolError("expected HELLO")
            if hello.genesis_hash != self.view.genesis.block_hash():
                raise protocol.ChainMismatch("genesis mismatch")
            while self._running:
                # A subscribed session is legitimately silent for as
                # long as blocks are quiet — the idle deadline applies
                # only to the request/reply shape.
                payload = await asyncio.wait_for(
                    protocol.read_frame(reader),
                    timeout=None if subscribed else self.idle_timeout_s,
                )
                mtype, body = protocol.decode(payload)
                if mtype in _QUERY_TYPES and not self.governor.admit(
                    budget, CLASS_QUERIES
                ):
                    self.admission_dropped += 1
                    continue
                if mtype is MsgType.SUBSCRIBE:
                    cursor, items = body
                    self._count_query(mtype)
                    ok = await self.subscriptions.subscribe(
                        sid,
                        items,
                        cursor,
                        send=push,
                        buffer_size=buffer_size,
                        close=writer.close,
                    )
                    if not ok:
                        # Unverifiable resume cursor (pruned window or a
                        # wallet that last spoke to a liar): refusing by
                        # disconnect is the failover signal.
                        raise protocol.ProtocolError(
                            "resume cursor not on the committed chain"
                        )
                    subscribed = True
                    continue
                if mtype is MsgType.UNSUBSCRIBE:
                    self._count_query(mtype)
                    self.subscriptions.unsubscribe(sid)
                    subscribed = False
                    continue
                with self.telemetry.span("query.request_s"):
                    reply = self._answer(mtype, body)
                    if reply is not None:
                        self._count_query(mtype)
                        if buffer_size() > WRITE_QUEUE_MAX:
                            # Asking while never reading: same hard-cap
                            # disconnect as a squatting node peer.
                            self.sessions_dropped_squat += 1
                            break
                        await protocol.write_frame(writer, reply)
        except (
            asyncio.IncompleteReadError,
            asyncio.TimeoutError,
            TimeoutError,
            ConnectionError,
            ValueError,
            OSError,
        ):
            pass  # replica sessions end quietly; clients just reconnect
        finally:
            self.subscriptions.drop(sid)
            self._sessions.discard(task)
            writer.close()

    def _answer(self, mtype, body) -> bytes | None:
        v = self.view
        if mtype is MsgType.GETHEADERS:
            return protocol.encode_headers_raw(
                v.headers_after(body, HEADERS_BATCH)
            )
        if mtype is MsgType.GETFILTERS:
            start, count = body
            entries = v.filters_range(start, min(count, FILTER_BATCH))
            return protocol.encode_filters(start, entries)
        if mtype is MsgType.GETPROOF:
            return v.proof_payload(body)
        if mtype is MsgType.GETBLOCKS:
            return protocol.encode_blocks_raw(
                v.blocks_after(body, SYNC_BATCH, SYNC_BYTES)
            )
        if mtype is MsgType.GETFILTERHEADERS:
            start, count = body
            return protocol.encode_filterheaders(
                start,
                v.filter_headers.range(start, min(count, FILTER_BATCH)),
            )
        if mtype is MsgType.GETSTATUS:
            return protocol.encode_status(self.status())
        if mtype is MsgType.GETMETRICS:
            # The replica serves its own registry — a fleet scrape sees
            # every worker's latency surface, not just the writer's.
            return protocol.encode_metrics(
                {
                    "role": "replica",
                    "height": v.tip_height,
                    "queries_total": sum(self.queries_served.values()),
                    **self.telemetry.snapshot(),
                }
            )
        if mtype is MsgType.PING:
            return protocol.encode_pong(body)
        return None  # pushes / ledger queries: not this plane's job


_QUERY_TYPES = frozenset(
    {
        MsgType.GETHEADERS,
        MsgType.GETFILTERS,
        MsgType.GETFILTERHEADERS,
        MsgType.GETPROOF,
        MsgType.GETBLOCKS,
        MsgType.GETSTATUS,
        MsgType.GETMETRICS,
        MsgType.SUBSCRIBE,
        MsgType.UNSUBSCRIBE,
    }
)


async def serve_replica(
    store_path,
    difficulty: int,
    *,
    retarget=None,
    host: str = "127.0.0.1",
    port: int = 0,
    refresh_interval_s: float = 0.25,
    reuse_port: bool = False,
) -> QueryPlaneServer:
    """Attach a ``ReplicaView`` and start one worker (the `p1 serve`
    core, also what tests drive directly)."""
    view = ReplicaView(store_path, difficulty, retarget)
    server = QueryPlaneServer(
        view,
        host=host,
        port=port,
        refresh_interval_s=refresh_interval_s,
        reuse_port=reuse_port,
    )
    await server.start()
    return server
