"""Disk-fault injection harness: scripted bad storage behavior.

The storage analog of ``node/testing.py``'s ``HostilePeer``: where that
module scripts delivery pathologies against a real node's sockets, this
one scripts DISK pathologies against a real ``ChainStore`` — a
``FaultStore`` is a ChainStore whose file layer is shimmed per a
declarative ``StoreFaultPlan``:

The port's copy of ``p1_tpu/chain/testing.py``.  Its kill-9 child runs
as ``python -m p1_tpu_torch.chain.testing``.

- **fail the Nth write** with ENOSPC/EIO (one-shot, or every write from
  the Nth until ``clear_faults()`` — the full-disk that later drains);
- **torn writes**: the failing write lands only its first K bytes, the
  on-disk shape of a crash/power-cut mid-append;
- **fsync failure** (file or directory), the journaling-loss profile;
- **bit-flips on read**, transient bad-sector reads that corrupt what
  the process sees while the platter bytes stay intact.

Write counting is at the file layer and one append = one write (the
store frames each record as a single write exactly so a tear is bounded
to one record); on a fresh store the magic is write #1.

Test infrastructure, not product: nothing in the node imports this.  It
lives in the package (rather than tests/) so external soak rigs can
script disk faults against real nodes without vendoring test helpers —
``append_soak`` is the subprocess the kill-9 crash soak runs and kills.
"""

from __future__ import annotations

import dataclasses
import errno
import os

from p1_tpu_torch.chain.store import ChainStore
from p1_tpu_torch.chain.segstore import SegmentedStore

__all__ = ["StoreFaultPlan", "FaultStore", "SegFaultStore", "append_soak"]


@dataclasses.dataclass(frozen=True)
class StoreFaultPlan:
    """One scripted disk pathology.  Default = a perfectly healthy disk."""

    #: One-shot: the Nth write call raises ``write_errno`` (1-based).
    fail_write_at: int | None = None
    #: Persistent: every write from the Nth on raises ``write_errno``
    #: until ``FaultStore.clear_faults()`` — ENOSPC that later drains.
    fail_writes_from: int | None = None
    write_errno: int = errno.ENOSPC
    #: The failing write lands this many bytes before raising — a torn
    #: record, exactly what a power cut mid-append leaves behind.
    torn_bytes: int | None = None
    #: The Nth data fsync raises ``fsync_errno`` (the EIO-on-fsync case
    #: that famously eats acknowledged writes).
    fail_fsync_at: int | None = None
    #: The Nth DIRECTORY fsync raises ``fsync_errno``.
    fail_dir_fsync_at: int | None = None
    fsync_errno: int = errno.EIO
    #: Flip ``flip_mask`` into the byte at this absolute file offset on
    #: every read — the disk holds good bytes, the process sees bad ones.
    flip_read_at: int | None = None
    flip_mask: int = 0x01
    #: Persistent: every body-refetch pread from the Nth on raises
    #: ``pread_errno`` until ``clear_faults()`` — a sector (or a whole
    #: segment file) going EIO under a live serve.
    fail_preads_from: int | None = None
    pread_errno: int = errno.EIO


class _FaultFile:
    """Write-path shim around the store's buffered writer: counts write
    calls and injects the plan's write faults; everything else passes
    through (flock needs ``fileno``, close needs ``close``...)."""

    def __init__(self, fh, owner: "FaultStore"):
        self._fh = fh
        self._owner = owner

    def write(self, data: bytes) -> int:
        owner = self._owner
        owner.writes += 1
        owner.events.append("write")
        plan = owner.plan
        n = owner.writes
        failing = plan.fail_write_at == n or (
            plan.fail_writes_from is not None and n >= plan.fail_writes_from
        )
        if failing:
            if plan.torn_bytes:
                # The tear must actually reach the file, not sit in the
                # buffer: flush so a reopening reader sees the torn tail.
                self._fh.write(data[: plan.torn_bytes])
                self._fh.flush()
            raise OSError(plan.write_errno, os.strerror(plan.write_errno))
        return self._fh.write(data)

    def flush(self) -> None:
        self._fh.flush()

    def fileno(self) -> int:
        return self._fh.fileno()

    def close(self) -> None:
        self._fh.close()

    @property
    def closed(self) -> bool:
        return self._fh.closed


class _FaultSeams:
    """The shimmed file layer, shared by the single-file ``FaultStore``
    and the segmented ``SegFaultStore``: both stores route every file
    open / fsync / dir-fsync / whole-file read through the ``*_path``
    seams (chain/store.py), so ONE shim covers both layouts — a plan's
    write counter ticks across segment boundaries exactly as it ticks
    across records in one file."""

    def _init_faults(self, plan: StoreFaultPlan | None) -> None:
        self.plan = plan if plan is not None else StoreFaultPlan()
        self.writes = 0
        self.fsyncs = 0
        self.dir_fsyncs = 0
        self.reads = 0
        self.events: list[str] = []

    def clear_faults(self) -> None:
        """Lift every injected fault (the disk 'recovered')."""
        self.plan = StoreFaultPlan()

    # -- shimmed file-layer seams -----------------------------------------

    def _open_fh_path(self, path):
        return _FaultFile(super()._open_fh_path(path), self)

    def _fsync_file(self, fh) -> None:
        self.fsyncs += 1
        self.events.append("fsync")
        if self.plan.fail_fsync_at == self.fsyncs:
            raise OSError(
                self.plan.fsync_errno, os.strerror(self.plan.fsync_errno)
            )
        os.fsync(fh.fileno())

    def _fsync_dir_path(self, path) -> None:
        self.dir_fsyncs += 1
        self.events.append("dir_fsync")
        if self.plan.fail_dir_fsync_at == self.dir_fsyncs:
            raise OSError(
                self.plan.fsync_errno, os.strerror(self.plan.fsync_errno)
            )
        super()._fsync_dir_path(path)

    def _read_bytes_path(self, path) -> bytes:
        self.reads += 1
        data = super()._read_bytes_path(path)
        plan = self.plan
        if plan.flip_read_at is not None and plan.flip_read_at < len(data):
            buf = bytearray(data)
            buf[plan.flip_read_at] ^= plan.flip_mask
            data = bytes(buf)
        return data

    def _pread(self, fd: int, n: int, off: int) -> bytes:
        self.preads = getattr(self, "preads", 0) + 1
        plan = self.plan
        if (
            plan.fail_preads_from is not None
            and self.preads >= plan.fail_preads_from
        ):
            raise OSError(plan.pread_errno, os.strerror(plan.pread_errno))
        return super()._pread(fd, n, off)


class FaultStore(_FaultSeams, ChainStore):
    """A ``ChainStore`` with an unreliable disk, per a ``StoreFaultPlan``.

    Usage::

        store = FaultStore(path, plan=StoreFaultPlan(fail_writes_from=3))
        node = Node(config, store=store)   # injectable: Node's store seam
        ...
        store.clear_faults()               # "space was freed"

    Counters (``writes``/``fsyncs``/``dir_fsyncs``/``reads``) and the
    ordered ``events`` trace let tests assert what the store actually
    did — e.g. that ``save_chain`` fsyncs the data BEFORE the directory.
    The heal/rebuild path writes through plain ``open`` (it replaces the
    inode wholesale), so faults apply to the append plane only.
    """

    def __init__(
        self,
        path,
        plan: StoreFaultPlan | None = None,
        fsync: bool = True,
    ):
        super().__init__(path, fsync=fsync)
        self._init_faults(plan)


class SegFaultStore(_FaultSeams, SegmentedStore):
    """A ``SegmentedStore`` with the same unreliable disk: faults land
    on whichever SEGMENT the store touches (appends, rolls, per-segment
    scans), which is how the round-7 fault families port to segment
    boundaries — e.g. ``fail_write_at`` aimed one past the roll point
    tears the FIRST record of a fresh segment.  Manifest writes ride
    the plain heal plane (atomic tmp+rename), like the base heal."""

    def __init__(
        self,
        path,
        plan: StoreFaultPlan | None = None,
        fsync: bool = True,
        segment_bytes: int = 1 << 16,
    ):
        super().__init__(path, fsync=fsync, segment_bytes=segment_bytes)
        self._init_faults(plan)


def append_soak(
    path,
    n_blocks: int = 24,
    difficulty: int = 12,
    delay_s: float = 0.0,
    segment_bytes: int = 0,
) -> None:
    """Subprocess body of the kill-9 crash soak: (re)open the store at
    ``path`` and append the DETERMINISTIC ``make_blocks`` chain from
    wherever the store left off, fsync per append.  The parent SIGKILLs
    this at a random moment, reopens the store, and asserts the
    surviving records are exactly a prefix of the same chain — then
    relaunches to keep appending.  Determinism is what makes the
    invariant checkable: same difficulty + miner id → byte-identical
    blocks in every process.  ``delay_s`` paces the appends so a
    random-time kill reliably lands INSIDE the append window instead of
    after a sub-second sprint."""
    import time

    from p1_tpu_torch.node.testing import make_blocks

    blocks = make_blocks(n_blocks, difficulty=difficulty)
    if segment_bytes > 0:
        # The segmented variant of the same soak: tiny segments put the
        # random kill INSIDE roll boundaries, not just appends.
        store = SegmentedStore(path, segment_bytes=segment_bytes)
    else:
        store = ChainStore(path)
    store.acquire()
    try:
        done = len(store.load_blocks())
        for block in blocks[done:]:
            store.append(block)
            if delay_s:
                time.sleep(delay_s)
    finally:
        store.close()


if __name__ == "__main__":  # the crash-soak child: append until killed
    import sys

    append_soak(
        sys.argv[1],
        int(sys.argv[2]),
        int(sys.argv[3]),
        float(sys.argv[4]) if len(sys.argv) > 4 else 0.0,
        int(sys.argv[5]) if len(sys.argv) > 5 else 0,
    )
