"""The port's chain stores (``p1_tpu_torch.chain``) against the JAX package's.

Mirrors tests/test_storefault.py (``TestV3Framing``, ``TestV2Compat``,
``TestFaultStore``, ``TestCrashSoak``, ``TestCompactWriteFailure``),
tests/test_segstore.py (``TestSegmentedCore``, ``TestUpgrade``,
``TestSegmentHeal``, ``TestPrune``, ``TestRollCrashBoundaries``,
``TestSegmentInfoRow``, ``TestSegmentedCompaction``) and
tests/test_headerplane.py (``TestSegmentIndex``, ``TestHeaderPlane``,
``TestArchiveChain``): the reference's cases, run against the port's
``ChainStore``, ``SegmentedStore``, header plane and fault stores.  The
kill-9 soaks stay ``slow``, as in the reference; their child runs as
``python -m p1_tpu_torch.chain.testing``.  ``TestCrossPackage`` then holds
the two packages to each other: the same blocks give byte-identical
stores, segment files, ``.hdrx`` and ``.sdx`` sidecars, and a store written
by either loads in the other to the same state.

test_storefault.py's ``TestNodeDegradation`` runs on the port's ``Node``
(its ENOSPC case is ``slow``, as in the reference), and test_segstore.py's
``TestSegmentEIO`` on the port's ``SimNet`` with ``device="cpu"``.
``TestManifestRace`` holds the port's segmented-store manifest against
threads of one process rewriting it at once.  test_headerplane.py's 1M-block acceptance
(``test_archive_scale_acceptance_1m``, slow) is a benchmark-scale run and
is not mirrored.
"""

import errno
import hashlib
import os
import pathlib
import signal
import struct
import subprocess
import sys
import threading
import time

import pytest

from p1_tpu.chain import ChainStore as RefStore
from p1_tpu.chain import SegmentedStore as RefSegmentedStore
from p1_tpu.chain import save_chain as ref_save_chain
from p1_tpu.chain.chain import Chain as RefChain
from p1_tpu.node.testing import make_blocks as ref_make_blocks
from p1_tpu_torch.chain import ChainStore, SegmentedStore, is_segmented, open_store, save_chain
from p1_tpu_torch.chain import snapshot as snapmod
from p1_tpu_torch.chain.chain import Chain
from p1_tpu_torch.chain.headerplane import (
    ArchiveChain,
    HeaderPlane,
    SegmentIndex,
    write_segment_index,
)
from p1_tpu_torch.chain.proof import verify_tx_proof
from p1_tpu_torch.chain.segstore import DEFAULT_SEGMENT_BYTES, SegmentInfo, read_manifest
from p1_tpu_torch.chain.store import MAGIC, V2_MAGIC
from p1_tpu_torch.chain.testing import FaultStore, SegFaultStore, StoreFaultPlan
from p1_tpu_torch.core.hashutil import sha256d
from p1_tpu_torch.node import Node
from p1_tpu_torch.node.testing import FaultPlan, HostilePeer, make_blocks
from test_torch_node import _config, run, wait_until

DIFF = 12  # tests/test_node.py's
REPO = pathlib.Path(__file__).resolve().parent.parent

_LEN = struct.Struct(">I")
_CRC = struct.Struct(">I")

#: Small enough that 8 mined blocks span several segments.
SEG_BYTES = 600


@pytest.fixture(scope="module")
def blocks():
    """Genesis + 8 mined blocks at DIFF (shared: mining is the only
    expensive part of these tests)."""
    return make_blocks(8, difficulty=DIFF)


class _TenBlocks:
    """The header-plane cases' chain: genesis + 10 blocks."""

    @pytest.fixture(scope="class")
    def blocks(self):
        return make_blocks(10, difficulty=DIFF)


def _fill_store(path, blocks) -> bytes:
    """Append every post-genesis block; return the on-disk bytes."""
    store = ChainStore(path)
    try:
        for block in blocks[1:]:
            store.append(block)
    finally:
        store.close()
    return path.read_bytes()


def _record_frames(data: bytes) -> list[tuple[int, int]]:
    """[(frame start, frame end)] of every record, from the scan spans."""
    return [
        (off - _LEN.size, off + n + _CRC.size)
        for off, n in ChainStore.scan(data).spans
    ]


def _write_v2_store(path, blocks) -> None:
    """Hand-craft a pre-checksum v2 store (the old framing)."""
    parts = [V2_MAGIC]
    for block in blocks[1:]:
        raw = block.serialize()
        parts.append(_LEN.pack(len(raw)))
        parts.append(raw)
    path.write_bytes(b"".join(parts))


def _digest(blocks) -> bytes:
    h = hashlib.sha256()
    for b in blocks:
        h.update(b.serialize())
    return h.digest()


def _fill(path, blocks, segment_bytes=SEG_BYTES, heights=True):
    store = SegmentedStore(path, segment_bytes=segment_bytes)
    try:
        for i, block in enumerate(blocks[1:], start=1):
            store.append(block, height=i if heights else None)
    finally:
        store.close()
    return store


def _linear_store(path, blocks, segment_bytes=SEG_BYTES):
    """A LINEAR segmented store: genesis at record 0, ordinal == height
    (the archive-serving shape)."""
    store = SegmentedStore(path, segment_bytes=segment_bytes)
    for h, block in enumerate(blocks):
        store.append(block, height=h)
    store.close()
    return store


def _snapshot_at(blocks, height, path):
    """A snapshot file for the chain at ``height``."""
    chain = Chain(DIFF)
    chain.checkpoint_interval = height
    for b in blocks[1:]:
        chain.add_block(b)
    h, block, balances, nonces, root = chain.snapshot_state()
    assert h == height
    manifest, chunks = snapmod.build_records(h, block, balances, nonces)
    snapmod.write_snapshot(path, manifest, chunks)
    return chain


# -- tests/test_storefault.py's cases ---------------------------------------


class TestV3Framing:
    def test_v3_magic_and_roundtrip(self, blocks, tmp_path):
        path = tmp_path / "chain.dat"
        _fill_store(path, blocks)
        assert path.read_bytes().startswith(MAGIC)
        loaded = ChainStore(path).load_blocks()
        assert [b.block_hash() for b in loaded] == [
            b.block_hash() for b in blocks[1:]
        ]
        chain = ChainStore(path).load_chain(DIFF)
        assert chain.tip_hash == blocks[-1].block_hash()

    def test_flipped_length_prefix_loses_zero_good_records(
        self, blocks, tmp_path
    ):
        """THE headline guarantee: pre-v3 framing read a corrupt mid-log
        length prefix as a truncated tail and permanently truncated the
        entire good remainder at the next startup.  v3 resyncs past the
        one damaged record and keeps every other one."""
        path = tmp_path / "chain.dat"
        data = bytearray(_fill_store(path, blocks))
        frames = _record_frames(bytes(data))
        # Flip one bit in record 3's length prefix (8 records total).
        bad_start, bad_end = frames[2]
        data[bad_start] ^= 0x10
        path.write_bytes(bytes(data))

        # Restart sequence: acquire (heal under the lock) + load.
        store = ChainStore(path)
        store.acquire()
        try:
            loaded = store.load_blocks()
        finally:
            store.close()
        survivors = [b.block_hash() for b in loaded]
        want = [b.block_hash() for b in blocks[1:]]
        assert survivors == want[:2] + want[3:]  # ONLY the hit record gone
        assert len(survivors) == 7
        # The bad span is quarantined, not destroyed: sidecar holds the
        # original bytes (offset u64 + len u32 header per entry).
        q = store.quarantine_path().read_bytes()
        qoff, qlen = struct.unpack_from(">QI", q, 0)
        assert (qoff, qlen) == (bad_start, bad_end - bad_start)
        assert q[12 : 12 + qlen] == bytes(data[bad_start:bad_end])
        assert store.healed["quarantined_records"] == 1
        assert store.healed["quarantined_bytes"] == bad_end - bad_start
        # The healed file re-scans clean and still holds the 7 records.
        rescan = ChainStore.scan(path.read_bytes())
        assert rescan.clean and len(rescan.spans) == 7

    def test_flipped_body_byte_detected_at_resume(self, blocks, tmp_path):
        """Bit-rot inside a record body fails the record CRC: the record
        is quarantined at resume instead of riding through the trusted
        fast-resume path undetected (the pre-v3 docstring's admitted
        hole)."""
        path = tmp_path / "chain.dat"
        data = bytearray(_fill_store(path, blocks))
        frames = _record_frames(bytes(data))
        s, e = frames[4]
        data[(s + e) // 2] ^= 0x01  # mid-payload flip
        path.write_bytes(bytes(data))
        corrupt_hash = blocks[5].block_hash()

        store = ChainStore(path)
        store.acquire()
        try:
            loaded = store.load_blocks()
            chain = store.load_chain(DIFF, loaded, trusted=True)
        finally:
            store.close()
        # Detected: the damaged record never reaches the chain, trusted
        # resume or not.
        assert corrupt_hash not in {b.block_hash() for b in loaded}
        assert corrupt_hash not in chain
        assert store.healed["quarantined_records"] == 1
        # The chain resumes to the last block BEFORE the gap (the later
        # records survive on disk as orphans until a peer fills the gap).
        assert chain.tip_hash == blocks[4].block_hash()

    def test_torn_tail_still_truncates_silently(self, blocks, tmp_path):
        path = tmp_path / "chain.dat"
        data = _fill_store(path, blocks)
        path.write_bytes(data[:-7])  # crash mid-append of the last record
        store = ChainStore(path)
        store.acquire()
        try:
            loaded = store.load_blocks()
            # A crash artifact, not corruption: nothing quarantined.
            assert store.healed["quarantined_records"] == 0
            assert store.healed["truncated_bytes"] > 0
            assert not store.quarantine_path().exists()
            assert len(loaded) == 7
            # And the writer can append cleanly behind the trim.
            store.append(blocks[-1])
        finally:
            store.close()
        assert ChainStore(path).load_chain(DIFF).tip_hash == blocks[
            -1
        ].block_hash()

    def test_trailing_complete_corrupt_record_quarantined(
        self, blocks, tmp_path
    ):
        # The LAST record's bytes are all present but its CRC fails:
        # that is corruption (quarantine), not a torn tail (truncate).
        path = tmp_path / "chain.dat"
        data = bytearray(_fill_store(path, blocks))
        data[-1] ^= 0x01  # flip inside the final CRC trailer
        path.write_bytes(bytes(data))
        store = ChainStore(path)
        store.acquire()
        try:
            assert store.healed["quarantined_records"] == 1
            assert store.quarantine_path().exists()
            assert len(store.load_blocks()) == 7
        finally:
            store.close()

    def test_multiple_corrupt_spans_all_quarantined(self, blocks, tmp_path):
        path = tmp_path / "chain.dat"
        data = bytearray(_fill_store(path, blocks))
        frames = _record_frames(bytes(data))
        for idx in (1, 5):
            s, e = frames[idx]
            data[(s + e) // 2] ^= 0x40
        path.write_bytes(bytes(data))
        store = ChainStore(path)
        store.acquire()
        try:
            assert store.healed["quarantined_records"] == 2
            assert len(store.load_blocks()) == 6
        finally:
            store.close()


class TestV2Compat:
    def test_v2_store_loads_read_only(self, blocks, tmp_path):
        path = tmp_path / "v2.dat"
        _write_v2_store(path, blocks)
        loaded = ChainStore(path).load_blocks()
        assert [b.block_hash() for b in loaded] == [
            b.block_hash() for b in blocks[1:]
        ]
        chain = ChainStore(path).load_chain(DIFF)
        assert chain.tip_hash == blocks[-1].block_hash()
        raw, n = ChainStore(path).packed_headers()
        assert n == len(blocks) - 1

    def test_v2_writer_refused_with_upgrade_hint(self, blocks, tmp_path):
        path = tmp_path / "v2.dat"
        _write_v2_store(path, blocks)
        with pytest.raises(RuntimeError, match="fsck"):
            ChainStore(path).acquire()
        # Maintenance tooling (compact/fsck) may still lock it.
        store = ChainStore(path)
        store.acquire(allow_v2=True)
        store.close()
        assert path.read_bytes().startswith(V2_MAGIC)  # untouched

    def test_v2_append_refused_even_under_allow_v2(self, blocks, tmp_path):
        # allow_v2 admits readers/rewriters; an appended v3 record's CRC
        # trailer would read back as the next record's length prefix and
        # desync the v2 framing, so append must refuse.
        path = tmp_path / "v2.dat"
        _write_v2_store(path, blocks)
        before = path.read_bytes()
        store = ChainStore(path)
        store.acquire(allow_v2=True)
        try:
            with pytest.raises(ValueError, match="v2"):
                store.append(blocks[1])
        finally:
            store.close()
        assert path.read_bytes() == before  # untouched

    def test_v2_torn_tail_truncated_under_allow_v2(self, blocks, tmp_path):
        path = tmp_path / "v2.dat"
        _write_v2_store(path, blocks)
        raw = path.read_bytes()
        path.write_bytes(raw[:-5])
        store = ChainStore(path)
        store.acquire(allow_v2=True)
        store.close()
        assert len(ChainStore(path).load_blocks()) == 7


class TestFaultStore:
    def test_persistent_read_fault_refuses_writer(self, blocks, tmp_path):
        # A bit that re-flips on EVERY read (bad sector / lying medium)
        # survives the quarantine rebuild's re-verify; the writer must be
        # refused, not admitted behind unhealed corruption.
        path = tmp_path / "f.dat"
        data = _fill_store(path, blocks)
        s, e = _record_frames(data)[0]
        store = FaultStore(
            path,
            plan=StoreFaultPlan(flip_read_at=(s + e) // 2, flip_mask=0x10),
        )
        with pytest.raises(RuntimeError, match="persist"):
            store.acquire()

    def test_enospc_on_nth_write(self, blocks, tmp_path):
        # Write #1 is the magic, each append is one write.
        store = FaultStore(
            tmp_path / "f.dat", plan=StoreFaultPlan(fail_write_at=3)
        )
        try:
            store.append(blocks[1])
            with pytest.raises(OSError) as exc:
                store.append(blocks[2])
            assert exc.value.errno == errno.ENOSPC
        finally:
            store.close()
        assert len(ChainStore(tmp_path / "f.dat").load_blocks()) == 1

    def test_torn_write_leaves_recoverable_prefix(self, blocks, tmp_path):
        path = tmp_path / "f.dat"
        store = FaultStore(
            path, plan=StoreFaultPlan(fail_write_at=3, torn_bytes=10)
        )
        try:
            store.append(blocks[1])
            with pytest.raises(OSError):
                store.append(blocks[2])
        finally:
            store.close()
        # 10 bytes of record 2 landed: a torn tail the next writer trims.
        fresh = ChainStore(path)
        fresh.acquire()
        try:
            assert fresh.healed["truncated_bytes"] == 10
            fresh.append(blocks[2])
        finally:
            fresh.close()
        assert len(ChainStore(path).load_blocks()) == 2

    def test_fsync_failure_surfaces_as_oserror(self, blocks, tmp_path):
        store = FaultStore(
            tmp_path / "f.dat", plan=StoreFaultPlan(fail_fsync_at=1)
        )
        try:
            with pytest.raises(OSError) as exc:
                store.append(blocks[1])
            assert exc.value.errno == errno.EIO
        finally:
            store.close()

    def test_bitflip_on_read_detected_without_touching_disk(
        self, blocks, tmp_path
    ):
        path = tmp_path / "f.dat"
        pristine = _fill_store(path, blocks)
        frames = _record_frames(pristine)
        s, e = frames[3]
        flipped = FaultStore(
            path, plan=StoreFaultPlan(flip_read_at=(s + e) // 2)
        )
        assert len(flipped.load_blocks()) == 7  # bad read: record dropped
        assert path.read_bytes() == pristine  # platter bytes intact
        assert len(ChainStore(path).load_blocks()) == 8  # clean reader

    def test_save_chain_fsyncs_data_then_directory(self, blocks, tmp_path):
        chain = Chain(DIFF, genesis=blocks[0])
        for block in blocks[1:]:
            chain.add_block(block)
        created = []

        def factory(p, fsync=True):
            s = FaultStore(p, fsync=fsync)
            created.append(s)
            return s

        save_chain(chain, tmp_path / "snap.dat", store_cls=factory)
        (store,) = created
        # The snapshot's one data fsync lands BEFORE the directory fsync
        # (dir-entry durability is meaningless for still-dirty data).
        assert store.events[-2:] == ["fsync", "dir_fsync"]
        assert store.fsyncs == 1 and store.dir_fsyncs == 1
        # A failing directory fsync is a real error, not best-effort.
        with pytest.raises(OSError):
            save_chain(
                chain,
                tmp_path / "snap2.dat",
                store_cls=lambda p, fsync=True: FaultStore(
                    p, plan=StoreFaultPlan(fail_dir_fsync_at=1), fsync=fsync
                ),
            )


class TestCrashSoak:
    def test_truncation_at_every_offset_recovers_prefix(
        self, blocks, tmp_path
    ):
        """Deterministic tier-1 crash soak: a store cut at ANY byte
        offset (kill-9 / power-cut shapes) must reopen to an exact
        prefix of the appended chain — never an exception, never a
        record past the cut, never a misparse."""
        path = tmp_path / "soak.dat"
        data = _fill_store(path, blocks)
        frames = _record_frames(data)
        want = [b.block_hash() for b in blocks[1:]]
        for cut in range(len(MAGIC), len(data), 3):
            path.write_bytes(data[:cut])
            store = ChainStore(path)
            store.acquire()
            try:
                got = [b.block_hash() for b in store.load_blocks()]
            finally:
                store.close()
            whole = sum(1 for _, end in frames if end <= cut)
            assert got == want[:whole], f"cut at {cut}"

    def test_bitflip_at_sampled_offsets_never_loses_other_records(
        self, blocks, tmp_path
    ):
        """Every single-bit flip past the magic costs AT MOST the one
        record it hits — the containment bound the checksums buy."""
        path = tmp_path / "flip.dat"
        data = _fill_store(path, blocks)
        frames = _record_frames(data)
        want = [b.block_hash() for b in blocks[1:]]
        for off in range(len(MAGIC), len(data), 17):
            buf = bytearray(data)
            buf[off] ^= 0x08
            path.write_bytes(bytes(buf))
            store = ChainStore(path)
            store.acquire()
            try:
                got = [b.block_hash() for b in store.load_blocks()]
            finally:
                store.close()
            hit = [
                i for i, (s, e) in enumerate(frames) if s <= off < e
            ]
            expect = [h for i, h in enumerate(want) if i not in hit]
            assert got == expect, f"flip at {off}"

    @pytest.mark.slow
    def test_kill9_at_random_offset_soak(self, tmp_path):
        """The real thing: SIGKILL a subprocess mid-append at random
        moments, reopen, assert the surviving store is an exact prefix
        of the deterministic chain, then relaunch on the SAME store to
        keep appending — every round exercises heal + resume + append
        continuation."""
        import random
        import time

        path = tmp_path / "kill.dat"
        n_blocks, diff, delay = 24, 10, 0.08
        from p1_tpu_torch.node.testing import make_blocks as mk

        want = [b.block_hash() for b in mk(n_blocks, difficulty=diff)]
        env = dict(os.environ)
        rng = random.Random(7)
        rounds = intermediates = 0
        complete = False
        while rounds < 20 and not complete:
            proc = subprocess.Popen(
                [
                    sys.executable,
                    "-m",
                    "p1_tpu_torch.chain.testing",
                    str(path),
                    str(n_blocks),
                    str(diff),
                    str(delay),
                ],
                env=env,
                cwd=REPO,
                stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL,
            )
            try:
                time.sleep(rng.uniform(0.5, 2.2))
                proc.send_signal(signal.SIGKILL)
                proc.wait(timeout=30)
            finally:
                if proc.poll() is None:
                    proc.kill()
            rounds += 1
            if not path.exists():
                continue  # killed before the store was even created
            store = ChainStore(path)
            store.acquire()  # the restart heal path
            try:
                got = [b.block_hash() for b in store.load_blocks()]
            finally:
                store.close()
            assert got == want[: len(got)], f"round {rounds}"
            complete = len(got) >= n_blocks + 1
            if got and not complete:
                intermediates += 1
        assert complete, f"never finished in {rounds} rounds"
        # The soak must have actually observed kill-mid-append states —
        # a run whose every kill landed after completion proves nothing.
        assert intermediates >= 1, "no mid-append kill ever observed"


class TestCompactWriteFailure:
    """Satellite (round 18): compaction ENOSPC mid-rewrite must leave
    the original store byte-identical AND release the writer flock —
    the whole-file os.replace path was untested under tmp-write
    failure."""

    def test_enospc_mid_rewrite_original_untouched_lock_released(
        self, tmp_path, blocks
    ):
        import functools

        from p1_tpu_torch.chain.tooling import run_compact

        path = tmp_path / "chain.dat"
        _fill_store(path, blocks)
        before = path.read_bytes()
        store_cls = functools.partial(
            FaultStore,
            plan=StoreFaultPlan(fail_write_at=3, write_errno=errno.ENOSPC),
        )
        rc = run_compact(str(path), None, store_cls=store_cls)
        assert rc == 2
        # The original store was never touched...
        assert path.read_bytes() == before
        # ...the partial tmp was removed...
        assert not list(tmp_path.glob("*.compact.*"))
        # ...and the writer flock was released: a fresh writer works.
        st = ChainStore(path)
        st.acquire()  # would raise "locked by another process" on a leak
        st.close()

    def test_enospc_with_out_flag_leaves_both_paths(self, tmp_path, blocks):
        import functools

        from p1_tpu_torch.chain.tooling import run_compact

        path = tmp_path / "chain.dat"
        _fill_store(path, blocks)
        before = path.read_bytes()
        out = tmp_path / "out.dat"
        store_cls = functools.partial(
            FaultStore,
            plan=StoreFaultPlan(fail_write_at=2, write_errno=errno.ENOSPC),
        )
        rc = run_compact(str(path), str(out), store_cls=store_cls)
        assert rc == 2
        assert path.read_bytes() == before
        # The destination acquired its magic but no record ever landed.
        assert ChainStore(out).load_blocks() == []



# -- tests/test_segstore.py's cases -----------------------------------------


class TestSegmentedCore:
    def test_roll_and_roundtrip(self, tmp_path, blocks):
        path = tmp_path / "chain.dat"
        store = _fill(path, blocks)
        assert len(store.segments) > 1, "no roll happened — shrink SEG_BYTES"
        assert all(s.sealed for s in store.segments[:-1])
        # Height spans landed in the manifest.
        assert store.segments[0].min_height == 1
        assert store.segments[-1].max_height == len(blocks) - 1
        # The manifest is what the path now holds.
        assert is_segmented(path)
        # Round trip: records come back byte-identical, in order.
        rd = SegmentedStore(path)
        assert _digest(rd.load_blocks()) == _digest(blocks[1:])
        rd.close()

    def test_resume_load_chain(self, tmp_path, blocks):
        path = tmp_path / "chain.dat"
        _fill(path, blocks)
        store = SegmentedStore(path)
        store.acquire()
        chain = store.load_chain(DIFF, trusted=True)
        assert chain.height == len(blocks) - 1
        assert chain.tip_hash == blocks[-1].block_hash()
        store.close()

    def test_read_body_across_segments(self, tmp_path, blocks):
        path = tmp_path / "chain.dat"
        _fill(path, blocks)
        store = SegmentedStore(path)
        list(store.iter_blocks())  # registers spans
        for b in blocks[1:]:
            bh = b.block_hash()
            assert store.has_body(bh)
            assert store.read_body(bh).serialize() == b.serialize()
        store.close()

    def test_append_rejects_duplicate_writer(self, tmp_path, blocks):
        path = tmp_path / "chain.dat"
        a = SegmentedStore(path, segment_bytes=SEG_BYTES)
        a.acquire()
        b = SegmentedStore(path, segment_bytes=SEG_BYTES)
        with pytest.raises(RuntimeError, match="locked by another process"):
            b.acquire()
        a.close()

    def test_open_store_factory(self, tmp_path, blocks):
        seg = tmp_path / "seg.dat"
        _fill(seg, blocks)
        assert isinstance(open_store(seg), SegmentedStore)
        single = tmp_path / "single.dat"
        st = ChainStore(single)
        st.append(blocks[1])
        st.close()
        assert type(open_store(single)) is ChainStore
        assert isinstance(
            open_store(tmp_path / "fresh.dat", segment_bytes=1 << 20),
            SegmentedStore,
        )

    def test_manifest_rebuild_from_directory(self, tmp_path, blocks):
        path = tmp_path / "chain.dat"
        _fill(path, blocks)
        os.unlink(path)  # the manifest dies; the segments are the data
        store = SegmentedStore(path)
        store.acquire()
        assert _digest(store.load_blocks()) == _digest(blocks[1:])
        # Heights were lost with the manifest: adopted segments are
        # never prunable.
        assert all(s.max_height is None for s in store.segments[:-1])
        store.close()

    def test_stray_segment_adopted(self, tmp_path, blocks):
        path = tmp_path / "chain.dat"
        store = _fill(path, blocks)
        last = store.segments[-1].seg_id
        # A roll that crashed after creating the file but before the
        # manifest write: bare magic, not in the manifest.
        stray = path.with_name(path.name + ".d") / f"seg{last + 1:05d}.p1s"
        stray.write_bytes(MAGIC)
        rd = SegmentedStore(path)
        rd.acquire()
        assert rd.segments[-1].seg_id == last + 1
        assert _digest(rd.load_blocks()) == _digest(blocks[1:])
        rd.close()


class TestUpgrade:
    def test_single_file_upgrade_lossless(self, tmp_path, blocks):
        path = tmp_path / "chain.dat"
        st = ChainStore(path)
        for b in blocks[1:]:
            st.append(b)
        st.close()
        before = _digest(ChainStore(path).load_blocks())
        store = SegmentedStore(path, segment_bytes=SEG_BYTES)
        store.acquire()
        # Upgrade happened, and the round-trip digest is identical.
        assert is_segmented(path)
        assert store.segments[0].seg_id == 0
        assert _digest(store.load_blocks()) == before
        # The original records were hard-linked, not copied: seg00000
        # holds the old file's exact bytes.
        store.close()

    def test_upgrade_refuses_v2(self, tmp_path, blocks):
        path = tmp_path / "chain.dat"
        st = ChainStore(path)
        st.append(blocks[1])
        st.close()
        data = path.read_bytes()
        path.write_bytes(V2_MAGIC + data[len(MAGIC) :])
        store = SegmentedStore(path)
        with pytest.raises(RuntimeError, match="v2 chain store"):
            store.acquire()

    def test_upgrade_excluded_by_legacy_writer(self, tmp_path, blocks):
        path = tmp_path / "chain.dat"
        legacy = ChainStore(path)
        legacy.append(blocks[1])  # acquires the single-file flock
        store = SegmentedStore(path)
        with pytest.raises(RuntimeError, match="locked by another process"):
            store.acquire()
        legacy.close()

    def test_legacy_writer_refuses_manifest(self, tmp_path, blocks):
        path = tmp_path / "chain.dat"
        _fill(path, blocks)
        legacy = ChainStore(path)
        with pytest.raises(RuntimeError, match="not a chain store"):
            legacy.acquire()

    def test_single_file_readonly_attach_unchanged(self, tmp_path, blocks):
        """Read paths never upgrade: a single-file store attached
        read-only (no writer acquire) stays a single file."""
        path = tmp_path / "chain.dat"
        st = ChainStore(path)
        for b in blocks[1:]:
            st.append(b)
        st.close()
        rd = ChainStore(path)
        assert len(rd.load_blocks()) == len(blocks) - 1
        assert path.read_bytes().startswith(MAGIC)
        rd.close()


class TestSegmentHeal:
    def _flip_mid_segment(self, path, store):
        """Flip one byte inside a middle SEALED segment's first record
        body; returns (segment path, untouched sibling paths)."""
        segs = store.segments
        victim = segs[len(segs) // 2]
        seg_dir = path.with_name(path.name + ".d")
        vpath = seg_dir / victim.name
        data = bytearray(vpath.read_bytes())
        data[len(MAGIC) + 10] ^= 0x40
        vpath.write_bytes(bytes(data))
        others = [
            seg_dir / s.name for s in segs if s.seg_id != victim.seg_id
        ]
        return vpath, others

    def test_midlog_corruption_contained_to_one_segment(
        self, tmp_path, blocks
    ):
        path = tmp_path / "chain.dat"
        store = _fill(path, blocks)
        n_records = sum(s.records for s in store.segments)
        vpath, others = self._flip_mid_segment(path, store)
        before = {p: p.read_bytes() for p in others}
        healed = SegmentedStore(path)
        healed.acquire()
        # The bad span was quarantined NEXT TO its segment...
        assert vpath.with_name(vpath.name + ".quarantine").exists()
        assert healed.healed["quarantined_records"] == 1
        # ...at most that one record was lost...
        survivors = healed.load_blocks()
        assert len(survivors) >= n_records - 1
        # ...and every OTHER segment's bytes were never rewritten.
        for p, data in before.items():
            assert p.read_bytes() == data, f"{p} was touched by the heal"
        healed.close()

    def test_torn_tail_truncated(self, tmp_path, blocks):
        path = tmp_path / "chain.dat"
        store = _fill(path, blocks)
        seg_dir = path.with_name(path.name + ".d")
        active = seg_dir / store.segments[-1].name
        data = active.read_bytes()
        os.truncate(active, len(data) - 3)  # crash mid-append shape
        healed = SegmentedStore(path)
        healed.acquire()
        assert healed.healed["truncated_bytes"] > 0
        got = healed.load_blocks()
        assert _digest(got) == _digest(blocks[1 : 1 + len(got)])  # a prefix
        healed.close()


class TestPrune:
    def test_prune_below_keeps_headers(self, tmp_path, blocks):
        path = tmp_path / "chain.dat"
        store = _fill(path, blocks)
        prunable = store.segments[0]
        floor = prunable.max_height + 1
        store2 = SegmentedStore(path)
        store2.acquire()
        n = store2.prune_below(floor)
        assert n >= 1
        seg_dir = path.with_name(path.name + ".d")
        assert not (seg_dir / prunable.name).exists()
        # The packed-header sidecar survives the body...
        assert (seg_dir / f"seg{prunable.seg_id:05d}.hdrx").exists()
        # ...so the whole-chain header plane is still complete.
        raw, count = store2.packed_headers()
        assert count == len(blocks) - 1
        assert len(raw) == count * 80
        assert store2.first_header() == blocks[1].header
        # Pruned bodies are not refetchable...
        list(store2.iter_blocks())
        assert not store2.has_body(blocks[1].block_hash())
        store2.close()
        # ...and the floor survives a reopen.
        rd = SegmentedStore(path)
        rd.acquire()
        assert rd.pruned_below == floor
        survivors = rd.load_blocks()
        assert survivors[-1].serialize() == blocks[-1].serialize()
        rd.close()

    def test_unknown_heights_never_prune(self, tmp_path, blocks):
        path = tmp_path / "chain.dat"
        _fill(path, blocks, heights=False)
        store = SegmentedStore(path)
        store.acquire()
        assert store.prune_below(10_000) == 0
        store.close()


class TestRollCrashBoundaries:
    """A fault injected at EVERY write/fsync/dir-fsync ordinal through a
    roll-heavy append run, then recovery: fsck verdict <= 1 and the
    survivors are a prefix — the crash-at-every-boundary proof, with
    the kill-9 soak (slow) as the kernel-reality version."""

    def _run_with_fault(self, tmp_path, blocks, plan, tag):
        path = tmp_path / f"crash-{tag}.dat"
        store = SegFaultStore(path, plan=plan, segment_bytes=SEG_BYTES)
        appended = 0
        try:
            for i, b in enumerate(blocks[1:], start=1):
                store.append(b, height=i)
                appended += 1
        except OSError:
            pass
        finally:
            # Abrupt death: no clean close bookkeeping beyond fd close.
            store.close()
        return path, appended

    def _assert_recovers(self, path, blocks):
        rd = SegmentedStore(path)
        rd.acquire()  # must not raise: verdict <= 1 by definition
        for seg, scan in rd.scan_segments():
            assert scan is None or not scan.bad_spans
        got = rd.load_blocks()
        assert _digest(got) == _digest(blocks[1 : 1 + len(got)])
        rd.close()
        return len(got)

    def test_write_fault_at_every_ordinal(self, tmp_path, blocks):
        total_writes = 40  # covers every append + roll magic write
        for n in range(2, total_writes):
            path, _ = self._run_with_fault(
                tmp_path, blocks, StoreFaultPlan(fail_write_at=n), f"w{n}"
            )
            self._assert_recovers(path, blocks)

    def test_torn_write_at_every_ordinal(self, tmp_path, blocks):
        for n in range(2, 30):
            path, _ = self._run_with_fault(
                tmp_path,
                blocks,
                StoreFaultPlan(fail_write_at=n, torn_bytes=3),
                f"t{n}",
            )
            self._assert_recovers(path, blocks)

    def test_fsync_fault_at_every_ordinal(self, tmp_path, blocks):
        for n in range(1, 20):
            path, _ = self._run_with_fault(
                tmp_path, blocks, StoreFaultPlan(fail_fsync_at=n), f"f{n}"
            )
            self._assert_recovers(path, blocks)

    def test_dir_fsync_fault_at_every_ordinal(self, tmp_path, blocks):
        for n in range(1, 12):
            path, _ = self._run_with_fault(
                tmp_path, blocks, StoreFaultPlan(fail_dir_fsync_at=n), f"d{n}"
            )
            self._assert_recovers(path, blocks)

    @pytest.mark.slow
    def test_kill9_segment_roll_soak(self, tmp_path):
        """SIGKILL a real appending process at random moments across a
        segment-rolling run; every recovery must boot with verdict <= 1
        and hold a prefix of the deterministic chain.  Asserts that at
        least one kill landed mid-run (not after completion)."""
        path = tmp_path / "soak.dat"
        n_blocks, mid_kills = 24, 0
        deterministic = make_blocks(n_blocks, difficulty=12)
        for round_i in range(8):
            proc = subprocess.Popen(
                [
                    sys.executable,
                    "-m",
                    "p1_tpu_torch.chain.testing",
                    str(path),
                    str(n_blocks),
                    "12",
                    "0.01",
                    "400",  # tiny segments: kills land around rolls
                ],
                stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL,
            )
            time.sleep(0.15 + 0.05 * round_i)
            if proc.poll() is None:
                os.kill(proc.pid, signal.SIGKILL)
                mid_kills += 1
            proc.wait()
            rd = SegmentedStore(path, segment_bytes=400)
            rd.acquire()
            got = rd.load_blocks()
            # The soak child appends from genesis: records are a prefix
            # of the deterministic chain including block 0.
            assert _digest(got) == _digest(deterministic[: len(got)])
            rd.close()
            if len(got) > n_blocks:
                break
        assert mid_kills >= 1, "every run finished before the kill"


class TestSegmentInfoRow:
    def test_manifest_row_round_trip(self):
        row = SegmentInfo(
            seg_id=3, sealed=True, records=7, bytes=1234, max_height=9
        )
        assert SegmentInfo.from_json(row.to_json()) == row
        assert row.name == "seg00003.p1s"

    def test_default_bound_fits_span_packing(self):
        # The packing invariant the module asserts at construction.
        SegmentedStore.__init__  # noqa: B018 (existence)
        assert DEFAULT_SEGMENT_BYTES < (1 << 30)


class TestSegmentedCompaction:
    def _forked_store(self, path):
        """A segmented store holding a reorged-away side branch: the
        short fork's records are exactly the dirty set."""
        from p1_tpu_torch.chain.tooling import run_compact  # noqa: F401 (used by callers)

        short = make_blocks(3, difficulty=DIFF, miner_id="loser")
        long = make_blocks(5, difficulty=DIFF, miner_id="winner")
        store = SegmentedStore(path, segment_bytes=500)
        for h, b in enumerate(short[1:], start=1):
            store.append(b, height=h)
        for h, b in enumerate(long[1:], start=1):
            store.append(b, height=h)
        store.close()
        return short, long, store

    def test_only_dirty_segments_rewritten(self, tmp_path):
        import json as jsonlib

        from p1_tpu_torch.chain.tooling import run_compact

        path = tmp_path / "chain.dat"
        short, long, store = self._forked_store(path)
        seg_dir = path.with_name(path.name + ".d")
        main_hashes = {b.block_hash() for b in long}
        # Identify which segments are already clean (all-main records).
        clean_before = {}
        rd = SegmentedStore(path)
        for seg, scan in rd.scan_segments():
            data = (seg_dir / seg.name).read_bytes()
            from p1_tpu_torch.core.hashutil import sha256d

            hashes = {sha256d(data[o : o + 80]) for o, _ in scan.spans}
            if hashes and hashes <= main_hashes:
                clean_before[seg.name] = data
        rd.close()
        import contextlib
        import io as iolib

        buf = iolib.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = run_compact(str(path), None)
        assert rc == 0, buf.getvalue()
        report = jsonlib.loads(buf.getvalue().strip())
        assert report["layout"] == "segmented"
        assert report["records_after"] == len(long) - 1
        assert report["segments_rewritten"] >= 1
        # Clean segments were NEVER rewritten — byte-identical.
        for name, data in clean_before.items():
            assert (seg_dir / name).read_bytes() == data, name
        # The compacted store reloads to the winning chain only.
        rd = SegmentedStore(path)
        rd.acquire()
        got = rd.load_blocks()
        assert _digest(got) == _digest(long[1:])
        chain = rd.load_chain(DIFF, got, trusted=True)
        assert chain.height == len(long) - 1
        rd.close()



# -- tests/test_headerplane.py's cases --------------------------------------


class TestSegmentIndex(_TenBlocks):
    def test_round_trip(self, tmp_path, blocks):
        path = tmp_path / "chain.dat"
        _linear_store(path, blocks)
        seg_dir = path.with_name(path.name + ".d")
        seg0 = seg_dir / "seg00000.p1s"
        data = seg0.read_bytes()
        hx = tmp_path / "seg0.hdrx"
        n = write_segment_index(data, hx)
        idx = SegmentIndex(hx)
        assert idx.count == n > 0
        spans = ChainStore.scan(data).spans
        for ordinal, (off, length) in enumerate(spans):
            hdr = data[off : off + 80]
            assert idx.header_at(ordinal) == hdr
            assert idx.find_hash(sha256d(hdr)) == ordinal
            assert idx.record_span(ordinal) == (off, length)
        # Coinbase txids resolve to their record (genesis carries no
        # transactions — nothing of it lands in the txid index).
        for ordinal in range(n):
            block = blocks[ordinal]
            if block.txs:
                assert idx.find_txid(block.txs[0].txid()) == ordinal
        assert idx.find_hash(b"\x00" * 32) is None
        assert idx.find_txid(b"\xff" * 32) is None
        idx.close()

    def test_corrupt_index_refused(self, tmp_path, blocks):
        path = tmp_path / "chain.dat"
        _linear_store(path, blocks)
        seg0 = path.with_name(path.name + ".d") / "seg00000.p1s"
        hx = tmp_path / "bad.hdrx"
        write_segment_index(seg0.read_bytes(), hx)
        data = bytearray(hx.read_bytes())
        data[20] ^= 0x01
        hx.write_bytes(bytes(data))
        with pytest.raises(ValueError, match="CRC mismatch"):
            SegmentIndex(hx)


class TestHeaderPlane(_TenBlocks):
    def test_cumulative_ordinals(self, tmp_path, blocks):
        path = tmp_path / "chain.dat"
        store = _linear_store(path, blocks)
        seg_dir = path.with_name(path.name + ".d")
        indexes = []
        for seg in store.segments:
            hx = seg_dir / f"seg{seg.seg_id:05d}.hdrx"
            write_segment_index((seg_dir / seg.name).read_bytes(), hx)
            indexes.append(SegmentIndex(hx))
        plane = HeaderPlane(indexes)
        assert plane.count == len(blocks)
        for h, block in enumerate(blocks):
            assert plane.header_at(h) == block.header.serialize()
            assert plane.hash_at(h) == block.block_hash()
        assert plane.header_at(len(blocks)) is None
        hit = plane.find_txid(blocks[3].txs[0].txid())
        assert hit is not None and hit[0] == 3
        plane.close()


class TestArchiveChain(_TenBlocks):
    def test_boot_and_serve(self, tmp_path, blocks):
        path = tmp_path / "chain.dat"
        _linear_store(path, blocks)
        snap_path = tmp_path / "snap.p1s"
        full = _snapshot_at(blocks, 8, snap_path)
        arch = ArchiveChain(path, snap_path, DIFF)
        try:
            assert arch.base_height == 8
            assert arch.height == len(blocks) - 1
            # Headers: hot window above the base, plane below it.
            for h, block in enumerate(blocks):
                assert arch.header_bytes_at(h) == block.header.serialize()
                assert arch.hash_at(h) == block.block_hash()
            # Balances match the fully-replayed chain's ledger.
            for acct in full.balances_snapshot():
                assert arch.balance(acct) == full.balance(acct)
            # A COLD proof (below the base) is served from the plane +
            # one record read, and verifies end to end.
            cold_txid = blocks[2].txs[0].txid()
            proof = arch.tx_proof(cold_txid)
            assert proof is not None and proof.height == 2
            verify_tx_proof(
                proof, DIFF, blocks[0].block_hash(), txid=cold_txid
            )
            # A hot proof comes from the chain window.
            hot_txid = blocks[-1].txs[0].txid()
            hot = arch.tx_proof(hot_txid)
            assert hot is not None and hot.height == len(blocks) - 1
            assert arch.tx_proof(b"\x00" * 32) is None
            # The whole-archive PoW replay holds.
            report, count = arch.verify_headers()
            assert count == len(blocks) and report.valid
        finally:
            arch.close()

    def test_wrong_snapshot_refused(self, tmp_path, blocks):
        path = tmp_path / "chain.dat"
        _linear_store(path, blocks)
        other = make_blocks(9, difficulty=DIFF, miner_id="someone-else")
        snap_path = tmp_path / "wrong.p1s"
        _snapshot_at(other, 8, snap_path)
        with pytest.raises(ValueError, match="does not match"):
            ArchiveChain(path, snap_path, DIFF)

    def test_nonlinear_store_refused(self, tmp_path, blocks):
        """A node-style log (no genesis record) fails the linearity
        gate instead of serving wrong heights."""
        path = tmp_path / "chain.dat"
        store = SegmentedStore(path, segment_bytes=SEG_BYTES)
        # Records out of line: skip genesis AND drop a middle block.
        for h, block in enumerate(blocks[2:], start=2):
            store.append(block, height=h)
        store.close()
        snap_path = tmp_path / "snap.p1s"
        _snapshot_at(blocks, 8, snap_path)
        with pytest.raises(ValueError):
            ArchiveChain(path, snap_path, DIFF)

    def test_pruned_cold_bodies_refuse_proofs_keep_headers(
        self, tmp_path, blocks
    ):
        path = tmp_path / "chain.dat"
        _linear_store(path, blocks)
        snap_path = tmp_path / "snap.p1s"
        _snapshot_at(blocks, 8, snap_path)
        store = SegmentedStore(path)
        store.acquire()
        first = store.segments[0]
        assert store.prune_below(first.max_height + 1) >= 1
        store.close()
        arch = ArchiveChain(path, snap_path, DIFF)
        try:
            # Headers below the pruned floor still serve (the plane
            # survives the bodies)...
            for h in range(first.max_height + 1):
                assert arch.header_bytes_at(h) == blocks[h].header.serialize()
            # ...but proofs there honestly refuse.
            assert arch.tx_proof(blocks[1].txs[0].txid()) is None
        finally:
            arch.close()



def _tree(path: pathlib.Path) -> dict[str, bytes]:
    """Every file of a store (a single file, or a manifest and its
    ``.d`` directory of segments and sidecars), by name."""
    files = {path.name: path.read_bytes()}
    seg_dir = path.with_name(path.name + ".d")
    if seg_dir.is_dir():
        files.update({f"{seg_dir.name}/{f.name}": f.read_bytes() for f in sorted(seg_dir.iterdir())})
    return files


def _ref_blocks(blocks):
    from p1_tpu.core import Block as RefBlock

    return [RefBlock.deserialize(b.serialize()) for b in blocks]


class TestCrossPackage:
    """The same blocks through both packages: the same bytes on disk, and
    each package reads the other's stores to the same state."""

    def test_make_blocks_byte_identical(self, blocks):
        assert [b.serialize() for b in blocks] == [b.serialize() for b in ref_make_blocks(8, difficulty=DIFF)]

    @pytest.mark.parametrize("writer", ["append", "save_chain"])
    def test_single_file_store_byte_identical(self, tmp_path, blocks, writer):
        ref_blocks = _ref_blocks(blocks)
        if writer == "append":
            _fill_store(tmp_path / "port.dat", blocks)
            store = RefStore(tmp_path / "ref.dat")
            for b in ref_blocks[1:]:
                store.append(b)
            store.close()
        else:
            chain, ref_chain = Chain(DIFF), RefChain(DIFF)
            for b, rb in zip(blocks[1:], ref_blocks[1:]):
                chain.add_block(b)
                ref_chain.add_block(rb)
            save_chain(chain, tmp_path / "port.dat")
            ref_save_chain(ref_chain, tmp_path / "ref.dat")
        assert (tmp_path / "port.dat").read_bytes() == (tmp_path / "ref.dat").read_bytes()

    @pytest.mark.parametrize("segment_bytes", [400, SEG_BYTES, 4096])
    def test_segmented_store_byte_identical(self, tmp_path, blocks, segment_bytes):
        _linear_store(tmp_path / "port.dat", blocks, segment_bytes)
        ref = RefSegmentedStore(tmp_path / "ref.dat", segment_bytes=segment_bytes)
        for h, b in enumerate(_ref_blocks(blocks)):
            ref.append(b, height=h)
        ref.close()
        port_tree, ref_tree = _tree(tmp_path / "port.dat"), _tree(tmp_path / "ref.dat")
        rename = {k.replace("ref.dat", "port.dat"): v for k, v in ref_tree.items()}
        assert sorted(port_tree) == sorted(rename)
        for name in port_tree:
            assert port_tree[name] == rename[name], name
        sealed = segment_bytes < 4096
        assert any(n.endswith(".hdrx") for n in port_tree) == sealed
        assert any(n.endswith(".sdx") for n in port_tree) == sealed

    @pytest.mark.parametrize("direction", ["port_reads_ref", "ref_reads_port"])
    def test_store_loads_in_the_other_package(self, tmp_path, blocks, direction):
        path = tmp_path / "chain.dat"
        if direction == "port_reads_ref":
            store = RefStore(path)
            for b in _ref_blocks(blocks)[1:]:
                store.append(b)
            store.close()
        else:
            _fill_store(path, blocks)
        port = ChainStore(path).load_chain(DIFF)
        ref = RefStore(path).load_chain(DIFF)
        assert port.tip_hash == ref.tip_hash == blocks[-1].block_hash()
        assert port.height == ref.height == len(blocks) - 1
        assert port.balances_snapshot() == ref.balances_snapshot()
        assert port.state_root() == ref.state_root()

    @pytest.mark.parametrize("flip", [len(MAGIC) + 2, 300, -7])
    def test_corruption_scans_the_same(self, tmp_path, blocks, flip):
        data = bytearray(_fill_store(tmp_path / "chain.dat", blocks))
        data[flip] ^= 0x10
        got, want = ChainStore.scan(bytes(data)), RefStore.scan(bytes(data))
        assert (got.spans, got.bad_spans) == (want.spans, want.bad_spans)
        for cls, name in ((ChainStore, "port.dat"), (RefStore, "ref.dat")):
            (tmp_path / name).write_bytes(bytes(data))
            st = cls(tmp_path / name)
            st.acquire()
            st.close()
        assert (tmp_path / "port.dat").read_bytes() == (tmp_path / "ref.dat").read_bytes()

    def test_packed_headers_equal(self, tmp_path, blocks):
        _fill_store(tmp_path / "chain.dat", blocks)
        assert ChainStore(tmp_path / "chain.dat").packed_headers() == RefStore(tmp_path / "chain.dat").packed_headers()

    def test_segmented_loads_in_the_other_package(self, tmp_path, blocks):
        _linear_store(tmp_path / "chain.dat", blocks)
        port = SegmentedStore(tmp_path / "chain.dat")
        ref = RefSegmentedStore(tmp_path / "chain.dat")
        try:
            assert [b.serialize() for b in port.load_blocks()] == [b.serialize() for b in ref.load_blocks()]
        finally:
            port.close()
            ref.close()


class TestNodeDegradation:
    @pytest.mark.slow
    def test_enospc_degrades_serves_and_recovers(self, tmp_path):
        """End-to-end acceptance: a node whose disk fills mid-sync (a)
        enters degraded serve-only mode without dropping the peer
        connection, (b) still answers headers queries, and (c) resumes
        persisting + catches back up once space returns.

        Slow smoke: the tier-1 copy of this e2e runs on
        SimNet at PRODUCTION backoff deadlines in milliseconds of wall
        time (tests/test_chaos.py TestStoreRecoverySim) — this socket
        variant keeps the real-kernel path covered, same migration
        pattern as the stall-failover port."""

        async def scenario():
            chain_blocks = make_blocks(10, difficulty=DIFF)
            peer = HostilePeer(chain_blocks, plan=FaultPlan(batch_limit=2))
            await peer.start()
            # Write #1 = magic, writes #2..4 = records: the 4th record
            # append hits persistent ENOSPC mid-IBD.
            store = FaultStore(
                tmp_path / "victim.dat",
                plan=StoreFaultPlan(fail_writes_from=5),
            )
            node = Node(
                _config(
                    peers=[f"127.0.0.1:{peer.port}"],
                    store_path=str(tmp_path / "victim.dat"),
                    sync_stall_timeout_s=0.5,
                    sync_backoff_base_s=0.05,
                    sync_backoff_max_s=0.2,
                ),
                store=store,
            )
            await node.start()
            try:
                # (a) the store fails on record 4; the node degrades.
                assert await wait_until(lambda: node._store_degraded)
                status = node.status()["storage"]
                assert status["degraded"] is True
                assert status["errors"] >= 1
                assert node.metrics.store_errors >= 1
                # The connection that delivered the fatal block is NOT
                # unwound: the peer session survives the disk fault.
                assert node.peer_count() == 1
                height_frozen = node.chain.height
                assert height_frozen < 10
                # (b) serve-only: a light client still gets our headers.
                from p1_tpu_torch.node.client import get_headers

                headers = await get_headers(
                    "127.0.0.1", node.port, DIFF, timeout=10.0
                )
                assert len(headers) == height_frozen + 1
                # Blocks pushed while degraded are deferred, not taken.
                assert node.chain.height == height_frozen
                # (c) space returns: the recovery loop flushes pending
                # records, clears the flag, and backfills to the full
                # advertised chain.
                store.clear_faults()
                assert await wait_until(
                    lambda: not node._store_degraded, timeout=10.0
                )
                assert node.metrics.store_recoveries == 1
                assert await wait_until(
                    lambda: node.chain.height == 10, timeout=20.0
                )
                # Everything accepted is durably on disk, in order.
                assert await wait_until(
                    lambda: len(ChainStore(store.path).load_blocks()) == 10
                )
                assert node.status()["storage"]["pending_records"] == 0
            finally:
                await node.stop()
                await peer.stop()
            # Restart on the recovered store: full resume, nothing torn.
            revived = Node(
                _config(store_path=str(tmp_path / "victim.dat"))
            )
            await revived.start()
            try:
                assert revived.chain.height == 10
            finally:
                await revived.stop()

        run(scenario())

    def test_store_degraded_exit_signals_fatal(self, tmp_path):
        """The --store-degraded-exit escape hatch: the node signals the
        CLI (store_fatal) instead of entering degraded mode."""

        async def scenario():
            chain_blocks = make_blocks(3, difficulty=DIFF)
            peer = HostilePeer(chain_blocks)
            await peer.start()
            store = FaultStore(
                tmp_path / "fatal.dat",
                plan=StoreFaultPlan(fail_write_at=2),  # first record
            )
            node = Node(
                _config(
                    peers=[f"127.0.0.1:{peer.port}"],
                    store_path=str(tmp_path / "fatal.dat"),
                    store_degraded_exit=True,
                ),
                store=store,
            )
            await node.start()
            try:
                assert await wait_until(lambda: node.store_fatal.is_set())
                assert node.status()["storage"]["degraded"] is True
            finally:
                await node.stop()
                await peer.stop()

        run(scenario())

    def test_mining_pauses_while_degraded(self, tmp_path):
        """A degraded miner stops sealing blocks (they could never be
        persisted or honestly gossiped) and resumes after recovery."""

        async def scenario():
            store = FaultStore(
                tmp_path / "miner.dat",
                plan=StoreFaultPlan(fail_writes_from=4),  # after 2 blocks
            )
            node = Node(
                _config(
                    mine=True,
                    store_path=str(tmp_path / "miner.dat"),
                    sync_backoff_base_s=0.05,
                    sync_backoff_max_s=0.2,
                ),
                store=store,
            )
            await node.start()
            try:
                assert await wait_until(lambda: node._store_degraded)
                frozen = node.chain.height
                import asyncio

                await asyncio.sleep(0.8)
                assert node.chain.height == frozen  # no sealing while down
                store.clear_faults()
                assert await wait_until(
                    lambda: not node._store_degraded, timeout=10.0
                )
                assert await wait_until(
                    lambda: node.chain.height > frozen, timeout=20.0
                )
            finally:
                await node.stop()

        run(scenario())


class TestSegmentEIO:
    def test_segment_eio_degrades_serve_only_and_recovers(self, tmp_path):
        """A segment going EIO under a live body refetch degrades the
        node to serve-only (the store recovery loop) WITHOUT dropping the
        requesting peer; clearing the fault recovers end to end and the
        syncing peer reaches the tip."""
        from p1_tpu_torch.node.netsim import SimNet

        net = SimNet(
            seed=7,
            difficulty=8,
            store_dir=tmp_path,
            segmented_store=True,
            segment_bytes=400,
            device="cpu",
        )

        async def main():
            v = await net.add_node(body_cache_blocks=2)
            for _ in range(8):
                await net.mine_on(v, spacing_s=0.5)
            v.chain.evict_bodies(2)
            assert v.chain.bodies_evicted > 0
            store = net.stores[net.host_name(0)]
            store.plan = StoreFaultPlan(fail_preads_from=1)
            j = await net.add_node(
                peers=[net.host_name(0)], sync_stall_timeout_s=3.0
            )
            assert await net.run_until(
                lambda: v.status()["storage"]["degraded"],
                60,
                wall_limit_s=60,
            )
            # The failing segment is remembered, the peer session is
            # NOT torn down, and header serving never stopped.
            assert store.read_failed_segments
            assert v.peer_count() >= 1
            assert len(
                v.chain.headers_after([v.chain.genesis.block_hash()])
            ) == v.chain.height
            store.clear_faults()
            assert await net.run_until(
                lambda: not v._store_degraded, 120, wall_limit_s=60
            )
            assert await net.run_until(
                lambda: j.chain.height == v.chain.height,
                120,
                wall_limit_s=60,
            )
            await net.stop_all()

        net.run(main())


class TestManifestRace:
    """Threads of one process rewriting one segmented store's manifest at
    once (a node's loop and its sidecar spill do) each write a temporary
    file of their own: every rename succeeds, every read between the
    renames parses, and no temporary file is left."""

    WRITERS = 4
    REWRITES = 150

    def test_concurrent_manifest_rewrites_all_parse(self, blocks, tmp_path):
        path = tmp_path / "chain.dat"
        store = SegmentedStore(path, segment_bytes=SEG_BYTES)
        for i, block in enumerate(blocks[1:], start=1):
            store.append(block, height=i)
        store._write_manifest()
        want = read_manifest(path)
        assert want is not None and len(want["segments"]) > 1
        errors: list[BaseException] = []
        bad_reads = []
        start = threading.Barrier(self.WRITERS + 1)
        done = threading.Event()

        def writer():
            start.wait()
            try:
                for _ in range(self.REWRITES):
                    store._write_manifest()
            except BaseException as e:  # noqa: BLE001 - reported below
                errors.append(e)

        def reader():
            start.wait()
            while not done.is_set():
                if read_manifest(path) != want:
                    bad_reads.append(path.read_bytes())

        threads = [threading.Thread(target=writer) for _ in range(self.WRITERS)]
        watcher = threading.Thread(target=reader)
        for t in (*threads, watcher):
            t.start()
        for t in threads:
            t.join()
        done.set()
        watcher.join()
        try:
            assert not errors, errors[:3]
            assert not bad_reads, f"{len(bad_reads)} torn manifest reads"
            assert read_manifest(path) == want
            assert not list(tmp_path.glob("chain.dat.mf.*"))
            # The store still loads through its manifest.
            assert store.load_chain(DIFF, trusted=True).height == len(blocks) - 1
        finally:
            store.close()
