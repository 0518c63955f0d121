"""Segmented chain persistence: bounded segment files behind the
``ChainStore`` API (round 18 — archive-scale durability).

The port's copy of ``p1_tpu/chain/segstore.py``: the same manifest,
segment and sidecar bytes.

The single append-only log made chain length a *whole-file* problem:
one mid-log corruption heal or compaction rewrites the world, and the
blast radius of any disk fault is the entire archive.  This module
shards the log the Bitcoin-Core way (``blk*.dat`` lineage): records —
v3 CRC framing byte-identical to ``chain/store.py`` — land in bounded
``segNNNNN.p1s`` files under ``<store>.d/``, and the store path itself
becomes a small CRC-framed **manifest** mapping segments to their
height spans.  What that buys, per segment:

- **containment** — ``p1 fsck`` scans/salvages/quarantines ONE segment;
  mid-log corruption loses at most one segment's bad span, never the
  archive, and every other segment's bytes are untouched;
- **bounded compaction** — only segments holding reorged-away records
  are rewritten (tmp + rename + dir-fsync per segment), so compacting
  a 10M-block archive costs O(dirty), not O(chain);
- **pruning** — body segments wholly below a snapshot base can be
  discarded (``prune_below``) while their packed-header sidecar
  (chain/headerplane.py ``.hdrx``) keeps header/PoW service alive —
  the serve-only degradation the pruned node mode builds on.

Durability discipline, unchanged from round 7 but now per boundary:
segment rolls fsync the sealed file, then the new segment's first
bytes, then the directory, and only then rewrite the manifest via
tmp + rename + dir-fsync — a crash at ANY boundary leaves a layout the
next ``acquire`` recovers (stray segment files are adopted, a corrupt
or missing manifest is rebuilt from the directory listing; the
manifest is a cache of the segment set, never the only copy of it).

**Lossless upgrade**: a writer acquiring an old single-file v3 store
hard-links it into place as ``seg00000.p1s`` (same inode — the record
bytes are never copied, so the upgrade is byte-lossless by
construction) and replaces the path with a manifest.  Read-only
attaches of single-file stores keep working everywhere — readers sniff
the magic.

The writer lock moves to a stable ``<store>.lock`` sidecar (the
manifest inode is replaced on every roll, so a flock on it would
protect nothing); during the upgrade the old single file is ALSO
flocked so a legacy writer can never race the conversion.
"""

from __future__ import annotations

import dataclasses
import fcntl
import json
import os
import struct
import threading
import zlib
from pathlib import Path

from p1_tpu_torch.chain.store import (
    _CRC,
    _LEN,
    _MAX_RECORD,
    MAGIC,
    V2_MAGIC,
    ChainStore,
    StoreScan,
)

#: Manifest format tag (the store path's new magic).  Sniffable by every
#: reader: single-file stores start ``P1TPUCH*``, segmented ones this.
SEG_MAGIC = b"P1TPUSG1"

#: Default segment bound.  Small enough that a heal/compaction rewrite
#: is a sub-second local event, large enough that a 100k-block store is
#: a handful of files, not thousands.
DEFAULT_SEGMENT_BYTES = 64 << 20

#: Span packing: ``(seg_id << _SEG_SHIFT) | (offset << _SPAN_SHIFT) |
#: length``.  Offset gets 30 bits, so a segment file may not exceed
#: 1 GiB — enforced against ``segment_bytes`` at construction (the
#: record that OVERFLOWS the bound still lands in the old segment, so
#: the true file cap is ``segment_bytes + _MAX_RECORD`` and the bound
#: check leaves headroom).
_SPAN_SHIFT = 26
_SEG_SHIFT = 56
_MAX_SEGMENT_BYTES = (1 << (_SEG_SHIFT - _SPAN_SHIFT)) - _MAX_RECORD - 64

#: Bound on cached per-segment read fds (pread plane).  Evicts oldest;
#: a 10M-block archive at default bounds is ~40 segments, well under.
_MAX_READ_FDS = 64


@dataclasses.dataclass
class SegmentInfo:
    """One segment's manifest row."""

    seg_id: int
    sealed: bool = False
    pruned: bool = False
    records: int = 0
    bytes: int = 0
    #: Height span of the records inside (maintained by ``append``'s
    #: ``height`` hint).  None = unknown (adopted/rebuilt/foreign
    #: segments) — unknown spans are never prunable, by design.
    min_height: int | None = None
    max_height: int | None = None

    @property
    def name(self) -> str:
        return f"seg{self.seg_id:05d}.p1s"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "SegmentInfo":
        return cls(**{f.name: d.get(f.name) for f in dataclasses.fields(cls)})


def _torn_magic(data: bytes) -> bool:
    """True for a file holding a strict PREFIX of the v3 magic — the
    on-disk shape of a crash that tore the new segment's very first
    write mid-roll.  Recovers as an empty segment (no record ever
    landed there)."""
    return len(data) < len(MAGIC) and MAGIC.startswith(data)


def read_manifest(path) -> dict | None:
    """Parse the manifest at ``path`` (None when missing/corrupt) —
    shared by the store and lock-free readers (the query plane's
    ReplicaView re-reads it on every roll)."""
    try:
        data = Path(path).read_bytes()
    except OSError:
        return None
    if not data.startswith(SEG_MAGIC):
        return None
    off = len(SEG_MAGIC)
    if off + _LEN.size + _CRC.size > len(data):
        return None
    (n,) = _LEN.unpack_from(data, off)
    end = off + _LEN.size + n
    if end + _CRC.size > len(data):
        return None
    body = data[off:end]
    if zlib.crc32(body) != _CRC.unpack_from(data, end)[0]:
        return None
    try:
        return json.loads(data[off + _LEN.size : end].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError):
        return None


def is_segmented(path) -> bool:
    """True when ``path`` holds a segment manifest (vs a single-file
    log, a v2 store, or nothing)."""
    try:
        with open(path, "rb") as f:
            return f.read(len(SEG_MAGIC)) == SEG_MAGIC
    except OSError:
        return False


def open_store(path, fsync: bool = True, segment_bytes: int = 0):
    """The layout-sniffing store factory: an existing segmented store
    (or an explicit ``segment_bytes`` request) opens as a
    ``SegmentedStore``; everything else keeps the single-file
    ``ChainStore``.  This is what lets a node config say nothing and
    still reopen whatever layout it shut down with."""
    if segment_bytes > 0 or is_segmented(path):
        return SegmentedStore(
            path,
            fsync=fsync,
            segment_bytes=segment_bytes or DEFAULT_SEGMENT_BYTES,
        )
    return ChainStore(path, fsync=fsync)


class SegmentedStore(ChainStore):
    """A ``ChainStore`` whose log is sharded into bounded segment
    files.  Same API, same per-record framing, same durability
    contract; ``append`` additionally takes a ``height`` hint so the
    manifest can map height spans to segments (what pruning and the
    archive boot consult)."""

    def __init__(
        self,
        path,
        fsync: bool = True,
        segment_bytes: int = DEFAULT_SEGMENT_BYTES,
    ):
        super().__init__(path, fsync=fsync)
        if segment_bytes > _MAX_SEGMENT_BYTES:
            raise ValueError(
                f"segment_bytes {segment_bytes} over the "
                f"{_MAX_SEGMENT_BYTES}-byte span-packing bound"
            )
        self.segment_bytes = max(segment_bytes, 1)
        self.seg_dir = self.path.with_name(self.path.name + ".d")
        self.lock_path = self.path.with_name(self.path.name + ".lock")
        self._segments: list[SegmentInfo] = []
        self._lock_fh = None
        self._active: SegmentInfo | None = None
        #: Current byte size of the active segment (None after a failed
        #: write — same unknown-tail discipline as the base class).
        self._active_size: int | None = None
        self._read_fds: dict[int, int] = {}
        #: Height floor below which body segments were discarded
        #: (``prune_below``); 0 = archive (nothing pruned).
        self.pruned_below = 0
        #: seg_id -> the acquire-time ``StoreScan`` (fsck surface).
        self.segment_scans: dict[int, StoreScan] = {}
        #: Segments whose pread plane returned an I/O error — the node's
        #: serve-only degradation reads this (bodies there are
        #: unavailable until the disk recovers and spans reindex).
        self.read_failed_segments: set[int] = set()
        self.healed.setdefault("lost_segments", 0)
        self.healed.setdefault("hdrx_failures", 0)
        self.healed.setdefault("sdx_failures", 0)
        #: One-shot failure seam (chaos plane, ``seal_sidecar_crash``):
        #: the next seal-time state-delta sidecar write raises OSError.
        #: Exercises the derivable-cache tolerance — the roll must
        #: survive, the counter must tick, the plane must rebuild.
        self.fail_next_sidecar = False
        #: One-shot failure seam (chaos plane, ``online_compact_crash``):
        #: the next ``plan_compaction`` fails mid-tmp-write.  The live
        #: segment files must be untouched afterwards.
        self.fail_next_compact = False

    # -- layout helpers ---------------------------------------------------

    def _seg_path(self, seg: SegmentInfo) -> Path:
        return self.seg_dir / seg.name

    def _seg_by_id(self, seg_id: int) -> SegmentInfo | None:
        for seg in self._segments:
            if seg.seg_id == seg_id:
                return seg
        return None

    def hdrx_path(self, seg: SegmentInfo) -> Path:
        return self.seg_dir / f"seg{seg.seg_id:05d}.hdrx"

    def sdx_path(self, seg: SegmentInfo) -> Path:
        return self.seg_dir / f"seg{seg.seg_id:05d}.sdx"

    @property
    def segments(self) -> tuple[SegmentInfo, ...]:
        return tuple(self._segments)

    # -- manifest ---------------------------------------------------------

    def _parse_manifest(self) -> dict | None:
        """The manifest's payload, or None when missing/corrupt — a
        corrupt manifest is NOT fatal: the segment set rebuilds from
        the directory listing (the manifest is a cache, the segments
        are the data)."""
        return read_manifest(self.path)

    def _write_manifest(self) -> None:
        """Atomically rewrite the manifest: tmp + rename + dir-fsync —
        a crash leaves either the old manifest or the new one, and
        either recovers (stray segments adopt, missing ones rebuild)."""
        payload = json.dumps(
            {
                "version": 1,
                "segment_bytes": self.segment_bytes,
                "pruned_below": self.pruned_below,
                "segments": [s.to_json() for s in self._segments],
            },
            sort_keys=True,
        ).encode("utf-8")
        body = _LEN.pack(len(payload)) + payload
        blob = SEG_MAGIC + body + _CRC.pack(zlib.crc32(body))
        # The temporary name is the writer's process AND thread: two
        # threads of one process (a node's loop and a sidecar spill)
        # rewriting the manifest at once must not share one tmp file,
        # or one rename moves the other's half-written bytes.
        tmp = self.path.with_name(
            f"{self.path.name}.mf.{os.getpid()}.{threading.get_ident()}"
        )
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        self._fsync_dir_path(self.path.parent)

    # -- writer lifecycle -------------------------------------------------

    def acquire(self, allow_v2: bool = False, heal: bool = True) -> None:
        """Lock + open the segmented store (idempotent; see the base
        class for the contract).  Ordering: the stable lock sidecar
        first, then layout recovery (upgrade / manifest rebuild / stray
        adoption), then the per-segment scan+heal — all strictly under
        the lock, exactly as the single-file acquire runs its heal."""
        if self._fh is not None:
            return
        self.path.parent.mkdir(parents=True, exist_ok=True)
        lf = open(self.lock_path, "a+b")
        try:
            fcntl.flock(lf, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError as e:
            lf.close()
            raise RuntimeError(
                f"{self.path} is locked by another process (a running node?)"
            ) from e
        try:
            self._setup_layout(allow_v2=allow_v2)
            if heal:
                self._heal_segments()
            active = [s for s in self._segments if not s.pruned][-1]
            path = self._seg_path(active)
            fh = self._open_fh_path(path)
            try:
                size = path.stat().st_size
            except OSError:
                size = 0
            if size == 0:
                fh.write(MAGIC)
                fh.flush()
                size = len(MAGIC)
            self._fh = fh
            self._active = active
            self._active_size = size
            active.bytes = size
        except ValueError as e:
            lf.close()
            raise RuntimeError(str(e)) from e
        except Exception:
            lf.close()
            raise
        self._lock_fh = lf

    def _setup_layout(self, allow_v2: bool) -> None:
        head = b""
        if self.path.exists() and self.path.stat().st_size > 0:
            with open(self.path, "rb") as f:
                head = f.read(len(SEG_MAGIC))
        if head == V2_MAGIC:
            raise ValueError(
                f"{self.path}: v2 chain store (records carry no "
                "checksums) — run `p1 fsck` or `p1 compact` to "
                "upgrade before segmenting"
            )
        if head and head != SEG_MAGIC:
            if not head.startswith(MAGIC):
                # Unknown/old magic: same message family as the base.
                ChainStore._check_magic(head, str(self.path))
            self._upgrade_single_file()
        manifest = self._parse_manifest()
        self._segments = []
        self.pruned_below = 0
        dirty = manifest is None
        if manifest is not None:
            self.pruned_below = int(manifest.get("pruned_below", 0))
            for row in manifest.get("segments", []):
                try:
                    self._segments.append(SegmentInfo.from_json(row))
                except TypeError:
                    dirty = True
        # Reconcile against the directory — the segments are the data.
        on_disk: set[int] = set()
        self.seg_dir.mkdir(parents=True, exist_ok=True)
        for stale in self.seg_dir.glob("seg*.p1s.cmp.*"):
            # A crashed online compaction leaves tmp replacements; the
            # originals were never touched, so the tmps are pure waste
            # (and can never adopt — the glob below requires ``.p1s``).
            stale.unlink(missing_ok=True)
        for f in sorted(self.seg_dir.glob("seg*.p1s")):
            try:
                on_disk.add(int(f.name[3:8]))
            except ValueError:
                continue
        known = {s.seg_id for s in self._segments}
        for seg_id in sorted(on_disk - known):
            # Stray file: a roll or upgrade crashed between creating the
            # segment and rewriting the manifest.  Adopt it; its height
            # span is unknown (never prunable) until records say more.
            self._segments.append(SegmentInfo(seg_id=seg_id))
            dirty = True
        for seg in list(self._segments):
            if seg.seg_id not in on_disk and not seg.pruned:
                # Manifest names a segment the disk no longer holds —
                # a lying medium or a crashed compaction.  Drop the row
                # (the records are gone; peers re-serve) and count it.
                self._segments.remove(seg)
                self.healed["lost_segments"] += 1
                dirty = True
        self._segments.sort(key=lambda s: s.seg_id)
        # Everything but the last live segment is sealed by definition.
        live = [s for s in self._segments if not s.pruned]
        for seg in live[:-1]:
            if not seg.sealed:
                seg.sealed = True
                dirty = True
        if not live:
            next_id = (
                self._segments[-1].seg_id + 1 if self._segments else 0
            )
            seg = SegmentInfo(seg_id=next_id)
            fh = self._open_fh_path(self._seg_path(seg))
            fh.write(MAGIC)
            fh.flush()
            self._fsync_file(fh)
            fh.close()
            self._fsync_dir_path(self.seg_dir)
            self._segments.append(seg)
            dirty = True
        if dirty:
            self._write_manifest()

    def _upgrade_single_file(self) -> None:
        """Lossless single-file v3 → segmented conversion, under BOTH
        locks (the sidecar is already held; the old file's own flock
        excludes a legacy writer).  The record bytes are hard-linked
        into place — same inode, zero copies — so the upgrade cannot
        lose or alter a byte; the round-trip digest test pins it."""
        old = open(self.path, "r+b")
        try:
            try:
                fcntl.flock(old, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError as e:
                raise RuntimeError(
                    f"{self.path} is locked by another process "
                    "(a running node?)"
                ) from e
            self.seg_dir.mkdir(parents=True, exist_ok=True)
            for stale in self.seg_dir.iterdir():
                # A crashed validation-flip rewrite (node/_rewrite_store
                # replaces the manifest with a fresh single-file store)
                # leaves the previous layout's segments behind: clear
                # them BEFORE linking, or they would adopt as live data.
                stale.unlink()
            seg0 = self.seg_dir / "seg00000.p1s"
            os.link(self.path, seg0)
            self._fsync_dir_path(self.seg_dir)
            self._segments = [SegmentInfo(seg_id=0)]
            self.pruned_below = 0
            self._write_manifest()
        finally:
            old.close()

    def _heal_segments(self) -> None:
        """The round-7 scan+heal, per segment: torn tails truncate,
        mid-segment corruption quarantines to the SEGMENT's sidecar and
        rebuilds only that file — every other segment's bytes are
        untouched (containment is the whole point)."""
        self.segment_scans = {}
        for seg in self._segments:
            if seg.pruned:
                continue
            path = self._seg_path(seg)
            for attempt in (0, 1):
                data = self._read_bytes_path(path)
                if not data or _torn_magic(data):
                    if data:  # torn first write: reset to empty
                        os.truncate(path, 0)
                    scan = StoreScan(3, [], [], None, 0)
                    break
                if not data.startswith(MAGIC):
                    raise ValueError(
                        f"{path}: segment is not a v3 chain store"
                    )
                scan = ChainStore.scan(data)
                if not scan.bad_spans:
                    break
                if attempt == 1:
                    raise ValueError(
                        f"{path}: {len(scan.bad_spans)} corrupt span(s) "
                        "persist after heal — refusing writer; run `p1 fsck`"
                    )
                self._heal_segment(path, data, scan)
            if scan.torn_tail is not None:
                self.healed["truncated_bytes"] += len(data) - scan.torn_tail
                os.truncate(path, scan.torn_tail)
                scan = dataclasses.replace(
                    scan, torn_tail=None, size=scan.torn_tail
                )
            self.segment_scans[seg.seg_id] = scan
            seg.records = len(scan.spans)
            seg.bytes = scan.size
            self.last_scan = scan

    def _heal_segment(self, path: Path, data: bytes, scan: StoreScan) -> None:
        """Quarantine + rebuild ONE segment (sidecar first, durably;
        then tmp + rename + dir-fsync — the base class's discipline,
        scoped to this file)."""
        qpath = path.with_name(path.name + ".quarantine")
        with open(qpath, "ab") as qf:
            for s, e in scan.bad_spans:
                qf.write(struct.pack(">QI", s, e - s))
                qf.write(data[s:e])
            qf.flush()
            os.fsync(qf.fileno())
        tmp = path.with_name(f"{path.name}.heal.{os.getpid()}")
        with open(tmp, "wb") as out:
            out.write(MAGIC)
            for off, n in scan.spans:
                out.write(data[off - _LEN.size : off + n + _CRC.size])
            out.flush()
            os.fsync(out.fileno())
        os.replace(tmp, path)
        self._fsync_dir_path(self.seg_dir)
        self.healed["quarantined_records"] += len(scan.bad_spans)
        self.healed["quarantined_bytes"] += scan.quarantined_bytes

    def quarantine_path(self) -> Path:
        """The ACTIVE segment's quarantine sidecar (single-file callers
        use this for evidence paths; per-segment sidecars sit next to
        their segment)."""
        if self._active is not None:
            p = self._seg_path(self._active)
            return p.with_name(p.name + ".quarantine")
        return super().quarantine_path()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        self._active = None
        self._active_size = None
        self._append_off = None
        with self._fd_lock:
            for fd in self._read_fds.values():
                os.close(fd)
            self._read_fds.clear()
            if self._read_fd is not None:
                os.close(self._read_fd)
                self._read_fd = None
        if self._lock_fh is not None:
            self._lock_fh.close()
            self._lock_fh = None

    # -- appends + rolls --------------------------------------------------

    def append(self, block, height: int | None = None) -> None:
        self.append_raw(
            block.serialize(), height=height, block_hash=block.block_hash()
        )

    def append_raw(
        self,
        raw: bytes,
        height: int | None = None,
        block_hash: bytes | None = None,
    ) -> None:
        """Append one pre-serialized record (the bulk-ingest /
        synthetic-archive path: benchmarks craft record bytes directly
        and skip the object layer entirely).  ``block_hash`` registers
        the body span when given; without it the record is simply not
        refetchable until the next reindex."""
        self.acquire()
        if len(raw) > _MAX_RECORD:
            raise ValueError(
                f"block serializes to {len(raw)} bytes, over the "
                f"{_MAX_RECORD}-byte record limit"
            )
        rec_len = _LEN.size + len(raw) + _CRC.size
        if (
            self._active.records > 0
            and self._active_size is not None
            and self._active_size + rec_len > self.segment_bytes
        ):
            self._roll()
        prefix = _LEN.pack(len(raw))
        crc = zlib.crc32(raw, zlib.crc32(prefix))
        try:
            self._fh.write(prefix + raw + _CRC.pack(crc))
            self._fh.flush()
        except OSError:
            # Unknown tail: stop registering spans until re-acquire —
            # the base class's post-incident discipline, per segment.
            self._active_size = None
            raise
        if self._active_size is not None:
            if block_hash is not None:
                self._body_spans[block_hash] = (
                    (self._active.seg_id << _SEG_SHIFT)
                    | ((self._active_size + _LEN.size) << _SPAN_SHIFT)
                    | len(raw)
                )
            self._active_size += rec_len
            self._active.bytes = self._active_size
        self._active.records += 1
        if height is not None:
            if self._active.min_height is None or height < self._active.min_height:
                self._active.min_height = height
            if self._active.max_height is None or height > self._active.max_height:
                self._active.max_height = height
        if self.fsync:
            self._fsync_file(self._fh)

    def _roll(self) -> None:
        """Seal the active segment and open the next one.  Ordering per
        the module docstring: sealed bytes durable → header-plane
        sidecar → new segment's magic durable → directory → manifest.
        A crash between ANY two steps recovers at the next acquire
        (stray adoption / manifest rebuild); an OSError mid-roll leaves
        the OLD segment active so the caller's degradation path
        (node ``_store_fail``) sees one coherent store."""
        self._fh.flush()
        self._fsync_file(self._fh)
        active = self._active
        seg_bytes = None
        try:
            seg_bytes = self._read_bytes_path(self._seg_path(active))
        except OSError:
            # Neither sidecar can derive without the bytes; both planes
            # rebuild later (prune_below / ensure_sidecars re-derive).
            self.healed["hdrx_failures"] += 1
            self.healed["sdx_failures"] += 1
        if seg_bytes is not None:
            try:
                from p1_tpu_torch.chain import headerplane

                headerplane.write_segment_index(
                    seg_bytes, self.hdrx_path(active)
                )
            except OSError:
                # The plane is derivable from the segment: losing the
                # sidecar costs a rebuild, never data.
                self.healed["hdrx_failures"] += 1
            try:
                from p1_tpu_torch.chain import statedelta

                if self.fail_next_sidecar:
                    self.fail_next_sidecar = False
                    raise OSError("injected sidecar failure (chaos seam)")
                statedelta.write_segment_delta(
                    seg_bytes, self.sdx_path(active)
                )
            except OSError:
                # Same derivable-cache tolerance as the header plane:
                # the delta recomputes from the segment on demand.
                self.healed["sdx_failures"] += 1
        new = SegmentInfo(seg_id=active.seg_id + 1)
        path = self._seg_path(new)
        fh = self._open_fh_path(path)
        try:
            if path.stat().st_size == 0:
                fh.write(MAGIC)
                fh.flush()
            self._fsync_file(fh)
            self._fsync_dir_path(self.seg_dir)
            active.sealed = True
            self._segments.append(new)
            self._write_manifest()
        except OSError:
            fh.close()
            if self._segments and self._segments[-1] is new:
                self._segments.remove(new)
            active.sealed = False
            raise
        old = self._fh
        self._fh = fh
        old.close()
        self._active = new
        self._active_size = len(MAGIC)
        new.bytes = len(MAGIC)

    def roll_segment(self) -> None:
        """Force a segment roll (chaos events and tests; production
        rolls happen at the size bound)."""
        self.acquire()
        if self._active.records > 0:
            self._roll()

    # -- readers ----------------------------------------------------------

    def _live_segments(self) -> list[SegmentInfo]:
        return [s for s in self._segments_for_read() if not s.pruned]

    def _segments_for_read(self) -> list[SegmentInfo]:
        """Reader-side segment set: the acquired writer's in-memory
        list, or a fresh manifest parse for lock-free readers (tooling
        attach before acquire)."""
        if self._segments:
            return self._segments
        manifest = self._parse_manifest()
        if manifest is None:
            return []
        return [
            SegmentInfo.from_json(row)
            for row in manifest.get("segments", [])
        ]

    def iter_blocks(self):
        from p1_tpu_torch.core.block import Block

        for seg in self._live_segments():
            path = self._seg_path(seg)
            try:
                data = self._read_bytes_path(path)
            except FileNotFoundError:
                continue
            if not data or _torn_magic(data):
                continue
            if not data.startswith(MAGIC):
                raise ValueError(f"{path}: segment is not a v3 chain store")
            spans = ChainStore.scan(data).spans
            del data
            fd = self._seg_fd(seg.seg_id)
            for off, n in spans:
                raw = self._pread(fd, n, off)
                if len(raw) != n:
                    raise OSError(f"{path}: short record read at {off}")
                block = Block.deserialize(raw)
                self._body_spans[block.block_hash()] = (
                    (seg.seg_id << _SEG_SHIFT) | (off << _SPAN_SHIFT) | n
                )
                yield block

    def load_blocks(self):
        return list(self.iter_blocks())

    def first_header(self):
        from p1_tpu_torch.core.header import HEADER_SIZE, BlockHeader

        for seg in self._segments_for_read():
            if seg.pruned:
                # Pruned bodies keep their packed-header sidecar: the
                # chain's first header is still knowable.
                from p1_tpu_torch.chain import headerplane

                try:
                    idx = headerplane.SegmentIndex(self.hdrx_path(seg))
                except (OSError, ValueError):
                    continue
                if idx.count:
                    return BlockHeader.deserialize(idx.header_at(0))
                continue
            try:
                data = self._read_bytes_path(self._seg_path(seg))
            except FileNotFoundError:
                continue
            if not data.startswith(MAGIC):
                continue
            for off, _ in ChainStore.scan(data).spans:
                return BlockHeader.deserialize(data[off : off + HEADER_SIZE])
        return None

    def packed_headers(self) -> tuple[bytes, int]:
        from p1_tpu_torch.core.header import HEADER_SIZE

        parts: list[bytes] = []
        count = 0
        for seg in self._segments_for_read():
            if seg.pruned:
                from p1_tpu_torch.chain import headerplane

                idx = headerplane.SegmentIndex(self.hdrx_path(seg))
                parts.append(idx.headers_blob())
                count += idx.count
                continue
            try:
                data = self._read_bytes_path(self._seg_path(seg))
            except FileNotFoundError:
                continue
            if not data.startswith(MAGIC):
                continue
            for off, _ in ChainStore.scan(data).spans:
                parts.append(data[off : off + HEADER_SIZE])
                count += 1
        return b"".join(parts), count

    def reindex_spans(self) -> int:
        from p1_tpu_torch.core.hashutil import sha256d
        from p1_tpu_torch.core.header import HEADER_SIZE

        self._body_spans.clear()
        self.read_failed_segments.clear()
        with self._fd_lock:
            for fd in self._read_fds.values():
                os.close(fd)
            self._read_fds.clear()
        for seg in self._live_segments():
            try:
                data = self._read_bytes_path(self._seg_path(seg))
            except FileNotFoundError:
                continue
            if not data.startswith(MAGIC):
                continue
            for off, n in ChainStore.scan(data).spans:
                bhash = sha256d(data[off : off + HEADER_SIZE])
                self._body_spans[bhash] = (
                    (seg.seg_id << _SEG_SHIFT) | (off << _SPAN_SHIFT) | n
                )
        return len(self._body_spans)

    # -- body refetch ------------------------------------------------------

    def _seg_fd(self, seg_id: int) -> int:
        # Callers hold ``self._fd_lock`` (read-fd lifecycle guard for the
        # staged node — the eviction close below must not land under a
        # concurrent pread on the victim's fd).
        fd = self._read_fds.get(seg_id)
        if fd is None:
            seg = self._seg_by_id(seg_id)
            name = seg.name if seg else f"seg{seg_id:05d}.p1s"
            fd = os.open(self.seg_dir / name, os.O_RDONLY)
            if len(self._read_fds) >= _MAX_READ_FDS:
                victim = next(iter(self._read_fds))
                os.close(self._read_fds.pop(victim))
            self._read_fds[seg_id] = fd
        return fd

    def read_body(self, block_hash: bytes):
        from p1_tpu_torch.core.block import Block

        span = self._body_spans[block_hash]
        seg_id = span >> _SEG_SHIFT
        off = (span >> _SPAN_SHIFT) & ((1 << (_SEG_SHIFT - _SPAN_SHIFT)) - 1)
        n = span & ((1 << _SPAN_SHIFT) - 1)
        try:
            with self._fd_lock:
                raw = self._pread(self._seg_fd(seg_id), n, off)
            if len(raw) != n:
                raise OSError(
                    f"{self.seg_dir}/seg{seg_id:05d}: short body read at {off}"
                )
        except OSError:
            # The segment's medium failed under us: drop its read fd
            # and remember — the node degrades to serve-only and the
            # recovery loop re-probes (bodies in OTHER segments keep
            # serving throughout).
            self.read_failed_segments.add(seg_id)
            with self._fd_lock:
                fd = self._read_fds.pop(seg_id, None)
                if fd is not None:
                    os.close(fd)
            raise
        block = Block.deserialize(raw)
        if block.block_hash() != block_hash:
            raise ValueError(
                f"{self.seg_dir}: body span for {block_hash.hex()[:16]} "
                "re-read as a different block"
            )
        return block

    # -- pruning -----------------------------------------------------------

    def prunable_segments(self, floor: int) -> list[SegmentInfo]:
        """Sealed, un-pruned segments whose every record sits strictly
        below ``floor`` — the discardable set.  Unknown height spans
        never qualify."""
        return [
            s
            for s in self._segments
            if s.sealed
            and not s.pruned
            and s.max_height is not None
            and s.max_height < floor
        ]

    def prune_below(self, floor: int) -> int:
        """Discard body segments wholly below height ``floor`` (the
        caller aligns ``floor`` to its snapshot base — bodies below it
        are re-derivable from any archive peer, and headers survive in
        the ``.hdrx`` plane, which is (re)written before the unlink so
        the header chain never has a hole).  Returns segments removed.
        Manifest updated last: a crash mid-prune leaves missing files
        the next acquire reconciles (``lost_segments`` stays 0 for
        rows already marked pruned)."""
        self.acquire()
        victims = self.prunable_segments(floor)
        if not victims:
            return 0
        from p1_tpu_torch.chain import headerplane

        for seg in victims:
            hx = self.hdrx_path(seg)
            if not hx.exists():
                headerplane.write_segment_index(
                    self._read_bytes_path(self._seg_path(seg)), hx
                )
            sx = self.sdx_path(seg)
            if not sx.exists():
                # The state-delta sidecar is the only record of what
                # the discarded bodies did to the ledger — write it
                # before the unlink, tolerating failure (the prunebase
                # snapshot carries the state either way).
                try:
                    from p1_tpu_torch.chain import statedelta

                    statedelta.write_segment_delta(
                        self._read_bytes_path(self._seg_path(seg)), sx
                    )
                except OSError:
                    self.healed["sdx_failures"] += 1
            os.unlink(self._seg_path(seg))
            seg.pruned = True
            with self._fd_lock:
                fd = self._read_fds.pop(seg.seg_id, None)
                if fd is not None:
                    os.close(fd)
            self.pruned_below = max(self.pruned_below, seg.max_height + 1)
        self._fsync_dir_path(self.seg_dir)
        self._write_manifest()
        pruned_ids = {s.seg_id for s in self._segments if s.pruned}
        self._body_spans = {
            h: sp
            for h, sp in self._body_spans.items()
            if (sp >> _SEG_SHIFT) not in pruned_ids
        }
        return len(victims)

    # -- always-on maintenance (round 20) ---------------------------------

    def ensure_sidecars(self) -> int:
        """Write any missing ``.hdrx``/``.sdx`` sidecars for sealed,
        un-pruned segments — the live re-base's spill step: before the
        chain drops its in-RAM header index below the new base, every
        sealed segment must carry its packed-header plane so the
        history stays servable/bootable from disk.  Returns sidecars
        written.  A header-plane failure RAISES (the caller's re-base
        depends on the plane existing and must abort cleanly); a
        state-delta failure is tolerated (``sdx_failures``) like
        everywhere else — it is an optimization cache, not the spill.
        """
        self.acquire()
        written = 0
        from p1_tpu_torch.chain import headerplane, statedelta

        for seg in self._segments:
            if not seg.sealed or seg.pruned:
                continue
            data = None
            hx = self.hdrx_path(seg)
            if not hx.exists():
                data = self._read_bytes_path(self._seg_path(seg))
                headerplane.write_segment_index(data, hx)
                written += 1
            sx = self.sdx_path(seg)
            if not sx.exists():
                try:
                    if data is None:
                        data = self._read_bytes_path(self._seg_path(seg))
                    statedelta.write_segment_delta(data, sx)
                    written += 1
                except OSError:
                    self.healed["sdx_failures"] += 1
        return written

    def plan_compaction(self, drop: set[bytes]) -> list[dict]:
        """Off-loop half of ONLINE compaction (the node runs this on
        its store lane): for every sealed, un-pruned segment holding at
        least one record whose block hash is in ``drop``, build a
        compacted replacement under a tmp name — MAGIC + surviving
        frames, fsync'd, then self-checked with a fresh scan (a
        replacement that cannot prove itself byte-perfect is discarded
        and the original left untouched: OSError).  Returns one plan
        row per dirty segment for ``commit_compacted_segment``; the
        LIVE segment files are never touched here, so a crash or
        failure at any point inside this method costs only stray tmp
        files (reaped at the next acquire).

        ``drop`` must only ever name records the caller POSITIVELY
        knows are off the main chain — unknown hashes are kept, so
        compaction can never widen a prune's loss (chain/tooling.py's
        rule, enforced the same way: keep is the default)."""
        from p1_tpu_torch.core.hashutil import sha256d
        from p1_tpu_torch.core.header import HEADER_SIZE

        plans: list[dict] = []
        tmp: Path | None = None
        try:
            for seg in self._segments:
                if not seg.sealed or seg.pruned:
                    continue
                tmp = None
                path = self._seg_path(seg)
                data = self._read_bytes_path(path)
                if not data.startswith(MAGIC):
                    continue
                scan = ChainStore.scan(data)
                frames: list[bytes] = []
                spans: list[tuple[bytes, int, int]] = []
                pos = len(MAGIC)
                for off, n in scan.spans:
                    bhash = sha256d(data[off : off + HEADER_SIZE])
                    if bhash in drop:
                        continue
                    frames.append(
                        data[off - _LEN.size : off + n + _CRC.size]
                    )
                    spans.append((bhash, pos + _LEN.size, n))
                    pos += _LEN.size + n + _CRC.size
                if len(frames) == len(scan.spans):
                    continue  # clean segment: nothing to drop
                tmp = path.with_name(f"{path.name}.cmp.{os.getpid()}")
                if self.fail_next_compact:
                    self.fail_next_compact = False
                    # Fail AFTER a partial tmp lands — the worst-case
                    # interruption point the chaos plane exercises.
                    tmp.write_bytes(MAGIC + (frames[0] if frames else b""))
                    raise OSError("injected compaction failure (chaos seam)")
                with open(tmp, "wb") as out:
                    out.write(MAGIC)
                    for frame in frames:
                        out.write(frame)
                    out.flush()
                    os.fsync(out.fileno())
                vscan = ChainStore.scan(self._read_bytes_path(tmp))
                if not vscan.clean or len(vscan.spans) != len(frames):
                    raise OSError(
                        f"{tmp}: compacted segment fails self-check"
                    )
                plans.append(
                    {
                        "seg_id": seg.seg_id,
                        "tmp": str(tmp),
                        "records": len(frames),
                        "bytes": len(MAGIC)
                        + sum(len(f) for f in frames),
                        "spans": spans,
                        "dropped": len(scan.spans) - len(frames),
                        # Staleness pin for the commit half: the exact
                        # size this plan was derived from.
                        "orig_bytes": len(data),
                    }
                )
        except OSError:
            # Live failure: drop every replacement built so far,
            # including the one mid-write.  (A kill-9 leaves them
            # instead — the next acquire reaps stray ``.cmp.`` tmps.)
            if tmp is not None:
                tmp.unlink(missing_ok=True)
            self.discard_compaction(plans)
            raise
        return plans

    def commit_compacted_segment(self, plan: dict) -> int:
        """On-loop half: atomically swap ONE compacted segment into
        place and fix every in-RAM structure that referenced the old
        inode — the span map entries for this segment and its cached
        read fd — in one synchronous step.  The caller (node) runs
        this between awaits, so no reader can interleave between the
        replace and the span fixup; until then, readers holding the
        old cached fd kept reading the old (still-live) inode at the
        old offsets, which is consistent by construction.  Returns
        records dropped."""
        seg = self._seg_by_id(plan["seg_id"])
        if seg is None or seg.pruned:
            Path(plan["tmp"]).unlink(missing_ok=True)
            return 0
        path = self._seg_path(seg)
        try:
            current = path.stat().st_size
        except OSError:
            current = -1
        if not seg.sealed or current != plan["orig_bytes"]:
            # The segment changed since the plan was derived (a roll
            # raced the off-loop planner, or a failed roll re-activated
            # it).  Replacing now would lose records — skip; the next
            # compaction re-plans from current bytes.
            Path(plan["tmp"]).unlink(missing_ok=True)
            return 0
        os.replace(plan["tmp"], path)
        self._fsync_dir_path(self.seg_dir)
        with self._fd_lock:
            fd = self._read_fds.pop(seg.seg_id, None)
            if fd is not None:
                os.close(fd)
        sid = seg.seg_id
        self._body_spans = {
            h: sp
            for h, sp in self._body_spans.items()
            if (sp >> _SEG_SHIFT) != sid
        }
        for bhash, off, n in plan["spans"]:
            self._body_spans[bhash] = (
                (sid << _SEG_SHIFT) | (off << _SPAN_SHIFT) | n
            )
        seg.records = plan["records"]
        seg.bytes = plan["bytes"]
        return plan["dropped"]

    def flush_manifest(self) -> None:
        """Persist the in-RAM segment rows.  Appends and prunes write
        the manifest themselves; a compaction COMMIT changes a sealed
        segment's records/bytes without either, so the node calls this
        (off-loop, with the sidecar refresh) once a commit batch lands.
        Crash before it: the manifest's stale row sizes are healed by
        the next acquire's scan, costing an fsck repair, never data."""
        self._write_manifest()

    def discard_compaction(self, plans: list[dict]) -> None:
        """Abort path: drop any tmp replacements already built.  The
        live segments were never touched."""
        for plan in plans:
            Path(plan["tmp"]).unlink(missing_ok=True)

    def refresh_sidecars(self, seg_ids: list[int]) -> None:
        """Rewrite the ``.hdrx``/``.sdx`` sidecars for segments whose
        bytes just changed (post-compaction, on the store lane).
        Failures are tolerated and counted — both planes are derivable
        caches."""
        from p1_tpu_torch.chain import headerplane, statedelta

        for seg_id in seg_ids:
            seg = self._seg_by_id(seg_id)
            if seg is None or seg.pruned:
                continue
            try:
                data = self._read_bytes_path(self._seg_path(seg))
            except OSError:
                self.healed["hdrx_failures"] += 1
                self.healed["sdx_failures"] += 1
                continue
            try:
                headerplane.write_segment_index(data, self.hdrx_path(seg))
            except OSError:
                self.healed["hdrx_failures"] += 1
            try:
                statedelta.write_segment_delta(data, self.sdx_path(seg))
            except OSError:
                self.healed["sdx_failures"] += 1

    # -- fsck surface ------------------------------------------------------

    def scan_segments(self) -> list[tuple[SegmentInfo, StoreScan | None]]:
        """Read-only per-segment framing verdicts (``p1 fsck``'s report
        pass): (info, scan) per segment, scan None for pruned bodies.
        Raises nothing — an unreadable or mis-tagged segment reports as
        a scan whose spans are empty and whose whole extent is one bad
        span (unrecoverable-at-segment-level, contained there)."""
        out: list[tuple[SegmentInfo, StoreScan | None]] = []
        for seg in self._segments_for_read():
            if seg.pruned:
                out.append((seg, None))
                continue
            path = self._seg_path(seg)
            try:
                data = self._read_bytes_path(path)
            except OSError:
                out.append((seg, StoreScan(3, [], [(0, 0)], None, 0)))
                continue
            if not data.startswith(MAGIC):
                out.append(
                    (seg, StoreScan(3, [], [(0, len(data))], None, len(data)))
                )
                continue
            out.append((seg, ChainStore.scan(data)))
        return out
