"""Offline store maintenance: the `p1 compact` and `p1 fsck` engines.

Extracted from ``cli.py`` (which keeps only parsing + dispatch).  Both
commands keep their CLI contract exactly: JSON report on stdout, human
diagnostics on stderr, and the documented exit codes (`p1 fsck`: 0 clean
/ 1 salvaged / 2 unrecoverable; `p1 compact`: 0 ok / 2 refused / 3
snapshot self-check failed).

The port's copy of ``p1_tpu/chain/tooling.py``: the same JSON keys, exit
codes and output files.  Its untrusted loads (``balances``, ``compact``,
``fsck``, ``snapshot``) revalidate their signature windows on the card,
unless the caller pinned the plain version
(``keys.set_sig_backend("device", device="cpu")``; ``--device cpu`` on the
command line).
"""

from __future__ import annotations

import json
import os
import sys


def load_store(
    path: str, expected_difficulty: int | None = None, retarget=None
):
    """(blocks, chain) from a persisted store, difficulty inferred from the
    records (every block declares the chain difficulty — validation
    enforces it — so the store is self-describing; the retarget rule is
    NOT, so retarget chains need their flags).  Raises SystemExit 2 for an
    empty/missing store, an ``expected_difficulty`` mismatch, or records
    that do not connect to the selected genesis (wrong retarget flags)."""
    from p1_tpu_torch.chain import ChainStore

    store = ChainStore(path)
    try:
        blocks = store.load_blocks()
    finally:
        store.close()
    if not blocks:
        print(f"{path}: empty or missing chain store", file=sys.stderr)
        raise SystemExit(2)
    stored = blocks[0].header.difficulty
    if expected_difficulty is not None and expected_difficulty != stored:
        # A wrong flag would otherwise silently yield an empty chain.
        print(
            f"--difficulty {expected_difficulty} does not match the store's "
            f"chain (difficulty {stored})",
            file=sys.stderr,
        )
        raise SystemExit(2)
    try:
        chain = store.load_chain(stored, blocks, retarget=retarget)
    except ValueError as e:  # none-connected guard (store.py)
        print(str(e), file=sys.stderr)
        raise SystemExit(2)
    return blocks, chain


def run_balances(
    store_path: str,
    account: str | None,
    expected_difficulty: int | None = None,
    retarget=None,
) -> int:
    """`p1 balances`: account balances from a persisted chain, plus the
    offline conservation audit when no single account is selected."""
    from p1_tpu_torch.chain import balances

    _, chain = load_store(
        store_path, expected_difficulty, retarget=retarget
    )
    ledger = balances(chain.main_chain())
    if account is not None:
        print(
            json.dumps(
                {
                    "config": "balances",
                    "height": chain.height,
                    "account": account,
                    "balance": ledger.get(account, 0),
                }
            )
        )
        return 0
    # Offline audit: the store loads through full consensus validation, so
    # the view must agree with the incremental ledger, hold nothing
    # negative, and conserve exactly — total = coinbase minted minus the
    # fees burned by the rare coinbase-less blocks.  A False here means a
    # corrupted store or a consensus bug — surface it in the exit code.
    minted = burned = 0
    for b in chain.main_chain():
        if b.txs and b.txs[0].is_coinbase:
            minted += b.txs[0].amount
        else:
            burned += sum(t.fee for t in b.txs)
    conserved = (
        sum(ledger.values()) == minted - burned
        and all(v >= 0 for v in ledger.values())
        and {a: v for a, v in ledger.items() if v} == chain.balances_snapshot()
    )
    print(
        json.dumps(
            {
                "config": "balances",
                "height": chain.height,
                "conserved": conserved,
                "balances": dict(sorted(ledger.items())),
            }
        )
    )
    return 0 if conserved else 1


def run_snapshot(
    action: str,
    store_path: str | None,
    file_path: str | None,
    interval: int = 0,
    retarget=None,
) -> int:
    """`p1 snapshot` engine — the established exit-code contract:

    - **create** (``--store`` → ``--file``): materialize the store's
      latest checkpoint state (balances + nonces + merkle state root +
      anchor block) into a CRC-framed snapshot file.  Exit 0 written /
      2 unrecoverable (bad store, or no checkpoint height yet).
    - **verify** (``--file``): full integrity pass — framing, manifest,
      chunk digests, state root.  Exit 0 clean / 1 salvageable issue
      (framing noise past a complete verified snapshot) / 2
      unrecoverable.
    - **info** (``--file``): print the manifest (no chunk verification).
      Exit 0 / 2 unreadable.

    The verify/info reports spell out the trust model: a verified
    snapshot proves the FILE matches its own manifest — whether the
    state is true is only provable by replaying the chain's history
    (what a node's background revalidation does before flipping out of
    the ASSUMED state)."""
    from p1_tpu_torch.chain import snapshot as chain_snapshot

    if action == "create":
        if not store_path or not file_path:
            print("snapshot create needs --store and --file", file=sys.stderr)
            return 2
        _, chain = load_store(store_path, retarget=retarget)
        if interval > 0:
            chain.checkpoint_interval = interval
            # Recorded roots followed the default cadence during the
            # load; re-derive the requested height from the rollback
            # path (snapshot_state cross-checks any recorded root).
            chain.state_checkpoints.clear()
        state = chain.snapshot_state()
        if state is None:
            print(
                f"{store_path}: chain height {chain.height} holds no "
                f"checkpoint at interval {chain.checkpoint_interval} — "
                "nothing to snapshot",
                file=sys.stderr,
            )
            return 2
        height, block, balances, nonces, root = state
        manifest_payload, chunks = chain_snapshot.build_records(
            height, block, balances, nonces
        )
        try:
            chain_snapshot.write_snapshot(file_path, manifest_payload, chunks)
        except OSError as e:
            print(f"could not write {file_path}: {e}", file=sys.stderr)
            return 2
        print(
            json.dumps(
                {
                    "config": "snapshot",
                    "action": "create",
                    "store": store_path,
                    "file": file_path,
                    "height": height,
                    "block_hash": block.block_hash().hex(),
                    "state_root": root.hex(),
                    "accounts": len(
                        set(balances) | set(nonces)
                    ),
                    "chunks": len(chunks),
                    "bytes": os.path.getsize(file_path),
                }
            )
        )
        return 0
    if not file_path:
        print(f"snapshot {action} needs --file", file=sys.stderr)
        return 2
    if action == "verify":
        report = chain_snapshot.verify_file(file_path)
        verdict = report.pop("verdict")
        print(json.dumps({"config": "snapshot", "action": "verify", **report}))
        return verdict
    # info
    try:
        manifest_payload, chunk_payloads, issues = chain_snapshot.read_records(
            file_path
        )
        manifest = chain_snapshot.parse_manifest(manifest_payload)
    except (OSError, chain_snapshot.SnapshotError) as e:
        print(str(e), file=sys.stderr)
        return 2
    print(
        json.dumps(
            {
                "config": "snapshot",
                "action": "info",
                "file": file_path,
                "height": manifest.height,
                "block_hash": manifest.block_hash.hex(),
                "state_root": manifest.state_root.hex(),
                "accounts": manifest.accounts,
                "chunks": len(manifest.chunk_digests),
                "chunks_present": len(chunk_payloads),
                "issues": issues,
                "trust": "integrity proves the file matches its manifest; "
                "the STATE is unproven until a node replays the history "
                "(ASSUMED -> VALIDATED flip)",
            }
        )
    )
    return 0


def run_compact(
    store_path: str,
    out_path: str | None,
    retarget=None,
    store_cls=None,
) -> int:
    """Store maintenance: the append-only log keeps every side branch and
    reorged-away block forever (that's what makes restarts deterministic);
    compaction snapshots just the current main branch, shrinking the file
    while resume behavior for the surviving chain is unchanged.

    Segmented stores compact PER SEGMENT: only segments holding records
    off the current main branch are rewritten (tmp + rename + dir-fsync
    each), clean segments' bytes are never touched — O(dirty), not
    O(chain).  ``store_cls`` is the fault-injection seam for the
    single-file snapshot write (tests drive ENOSPC through it)."""
    from p1_tpu_torch.chain import ChainStore, save_chain
    from p1_tpu_torch.chain.segstore import is_segmented

    if not os.path.exists(store_path):
        print(f"{store_path}: empty or missing chain store", file=sys.stderr)
        return 2
    if is_segmented(store_path):
        return _compact_segmented(store_path, out_path, retarget=retarget)
    # Lock FIRST, then load: records appended between an unlocked read and
    # the rewrite would be silently dropped, and replacing the inode under
    # a live node would orphan everything it appends afterwards.
    src = ChainStore(store_path)
    try:
        try:
            # allow_v2: compaction IS the upgrade path for pre-checksum
            # stores (the snapshot below is written in v3 framing).
            src.acquire(allow_v2=True)
        except RuntimeError as e:
            print(f"{e} — stop it before compacting", file=sys.stderr)
            return 2
        blocks = src.load_blocks()
        if not blocks:
            print(f"{store_path}: empty chain store", file=sys.stderr)
            return 2
        try:
            chain = src.load_chain(
                blocks[0].header.difficulty,
                blocks,
                retarget=retarget,
            )
        except ValueError as e:
            # Without this, compacting a retarget store with forgotten
            # flags would REPLACE it with a genesis-only snapshot of the
            # wrong chain — the one unrecoverable failure mode here.
            print(str(e), file=sys.stderr)
            return 2
        before = os.path.getsize(store_path)
        out = out_path or store_path
        dst = None
        if out_path and os.path.realpath(out) != os.path.realpath(store_path):
            # The destination needs the same in-use guard: replacing it
            # would orphan a live node's inode there.
            dst = ChainStore(out)
            try:
                dst.acquire()
            except RuntimeError as e:
                print(f"{e} — stop it before overwriting", file=sys.stderr)
                return 2
        else:
            out = store_path
        try:
            # Always write a sibling temp file and atomically replace, so
            # a crash mid-write can never leave EITHER path deleted or
            # truncated.
            tmp = f"{out}.compact.{os.getpid()}"
            try:
                save_chain(
                    chain,
                    tmp,
                    **({"store_cls": store_cls} if store_cls else {}),
                )
            except OSError as e:
                # ENOSPC/EIO mid-rewrite: the ORIGINAL store was never
                # touched (we only wrote the sibling tmp) — remove the
                # partial tmp and report, leaving the log byte-identical
                # and the writer flock released by the finally below.
                if os.path.exists(tmp):
                    os.unlink(tmp)
                print(
                    f"compaction write failed ({e}) — original store "
                    "left untouched",
                    file=sys.stderr,
                )
                return 2
            # Prove the snapshot BEFORE it replaces the original: the
            # main branch is linear, so its packed headers verify (PoW +
            # linkage + difficulty) in one ``replay_packed`` call straight off the
            # bytes just written — a torn or miswritten snapshot can
            # never clobber a good log.
            from p1_tpu_torch.chain import replay_packed

            raw_headers, n_headers = ChainStore(tmp).packed_headers()
            snap = replay_packed(raw_headers, retarget=retarget)
            if not snap.valid:
                os.unlink(tmp)
                print(
                    f"snapshot self-check failed at record "
                    f"{snap.first_invalid} of {n_headers} — original store "
                    "left untouched",
                    file=sys.stderr,
                )
                return 3
            os.replace(tmp, out)
            # The rename itself must survive a metadata-journal loss:
            # save_chain fsynced the tmp's data and directory entry, but
            # the replace is a second directory mutation.
            from p1_tpu_torch.chain.store import fsync_dir

            fsync_dir(os.path.dirname(os.path.abspath(out)))
        finally:
            if dst is not None:
                dst.close()
    finally:
        src.close()
    print(
        json.dumps(
            {
                "config": "compact",
                "height": chain.height,
                "records_before": len(blocks),
                "records_after": chain.height + 1,
                "bytes_before": before,
                "bytes_after": os.path.getsize(out),
                "out": out,
            }
        )
    )
    return 0


def _compact_segmented(
    store_path: str, out_path: str | None, retarget=None
) -> int:
    """Per-segment compaction: drop records off the current main branch,
    rewriting ONLY the segments that hold any (tmp + rename + dir-fsync
    per segment — a crash at any point leaves every segment either old
    or new, never half-written).  ``--out`` is refused: a segmented
    store is a directory of bounded files, compacted in place by
    design."""
    from p1_tpu_torch.chain.segstore import SegmentedStore
    from p1_tpu_torch.chain.store import _CRC, _LEN, MAGIC, ChainStore, fsync_dir
    from p1_tpu_torch.core.hashutil import sha256d

    if out_path:
        print(
            "segmented stores compact in place (bounded per-segment "
            "rewrites); --out applies to single-file stores only",
            file=sys.stderr,
        )
        return 2
    store = SegmentedStore(store_path)
    try:
        try:
            store.acquire()
        except RuntimeError as e:
            print(f"{e} — stop it before compacting", file=sys.stderr)
            return 2
        blocks = store.load_blocks()
        if not blocks:
            print(f"{store_path}: empty chain store", file=sys.stderr)
            return 2
        try:
            chain = store.load_chain(
                blocks[0].header.difficulty,
                blocks,
                retarget=retarget,
                orphans_ok=store.pruned_below > 0,
            )
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return 2
        main = set()
        h = chain.tip_hash
        while h in chain:
            main.add(h)
            hdr = chain.header_of(h)
            if hdr is None or chain.height_of(h) == chain.base_height:
                break
            h = hdr.prev_hash
        # With a pruned store the surviving records park as orphans off
        # the missing history: treat every connected record as keepable
        # (compaction must never widen a prune's loss).
        if store.pruned_below > 0:
            main.update(b.block_hash() for b in blocks)
        before_records = len(blocks)
        rewritten = kept = 0
        for seg, scan in store.scan_segments():
            if scan is None or not scan.spans:
                continue
            path = store._seg_path(seg)
            data = path.read_bytes()
            frames = []
            for off, n in scan.spans:
                if sha256d(data[off : off + 80]) in main:
                    frames.append(data[off - _LEN.size : off + n + _CRC.size])
            kept += len(frames)
            if len(frames) == len(scan.spans):
                continue  # clean segment: bytes never touched
            tmp = path.with_name(f"{path.name}.seg.{os.getpid()}")
            try:
                with open(tmp, "wb") as f:
                    f.write(MAGIC)
                    for frame in frames:
                        f.write(frame)
                    f.flush()
                    os.fsync(f.fileno())
                # Self-check the rewrite before it replaces anything.
                vscan = ChainStore.scan(tmp.read_bytes())
                if not vscan.clean or len(vscan.spans) != len(frames):
                    raise OSError("segment self-check failed")
            except OSError as e:
                if tmp.exists():
                    tmp.unlink()
                print(
                    f"compaction write failed ({e}) — {path} left "
                    "untouched",
                    file=sys.stderr,
                )
                return 2
            os.replace(tmp, path)
            fsync_dir(path.parent)
            seg.records = len(frames)
            seg.bytes = os.path.getsize(path)
            if seg.sealed:
                # The packed-header sidecar mirrors the new record set.
                from p1_tpu_torch.chain.headerplane import write_segment_index

                write_segment_index(
                    path.read_bytes(), store.hdrx_path(seg)
                )
            rewritten += 1
        store._write_manifest()
        store.reindex_spans()
    finally:
        store.close()
    print(
        json.dumps(
            {
                "config": "compact",
                "layout": "segmented",
                "height": chain.height,
                "records_before": before_records,
                "records_after": kept,
                "segments": len(store.segments),
                "segments_rewritten": rewritten,
                "out": store_path,
            }
        )
    )
    return 0


def _fsck_segmented(store_path: str, json_out: bool) -> int:
    """Per-segment fsck: scan/report, then salvage ONLY the segments
    that need it — mid-log corruption loses at most one segment's bad
    span, and no other segment's bytes are ever rewritten.  Same exit
    contract (0 clean / 1 salvaged / 2 unrecoverable); the JSON report
    carries one row per segment with its own verdict."""
    from p1_tpu_torch.chain.segstore import SegmentedStore, _torn_magic
    from p1_tpu_torch.chain.store import ChainStore

    store = SegmentedStore(store_path)
    lf = None
    try:
        import fcntl

        store.path.parent.mkdir(parents=True, exist_ok=True)
        lf = open(store.lock_path, "a+b")
        try:
            # Lock first (a live node's appends must not race a
            # salvage), scan without healing: fsck reports BEFORE it
            # mutates, per segment.
            fcntl.flock(lf, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            print(
                f"{store.path} is locked by another process (a running "
                "node?)",
                file=sys.stderr,
            )
            return 2
        rows = []
        worst = 0
        salvaged_any = False
        segments = store._segments_for_read()
        if not segments:
            print(
                f"{store_path}: unreadable manifest and no segments",
                file=sys.stderr,
            )
            return 2
        for seg, scan in store.scan_segments():
            row = {
                "segment": seg.name,
                "pruned": seg.pruned,
                "sealed": seg.sealed,
            }
            if scan is None:
                row["verdict"] = 0  # pruned body: nothing to scan
                rows.append(row)
                continue
            row.update(
                records_valid=len(scan.spans),
                bad_spans=len(scan.bad_spans),
                bytes_quarantined=scan.quarantined_bytes,
                torn_tail_bytes=(
                    scan.size - scan.torn_tail
                    if scan.torn_tail is not None
                    else 0
                ),
            )
            if scan.clean:
                row["verdict"] = 0
                rows.append(row)
                continue
            # Salvage this segment only: quarantine + rebuild / truncate.
            path = store._seg_path(seg)
            data = store._read_bytes_path(path)
            if _torn_magic(data):
                os.truncate(path, 0)
                row["verdict"] = 1
                row["records_salvaged"] = 0
                salvaged_any = True
                rows.append(row)
                continue
            if scan.bad_spans:
                store._heal_segment(path, data, scan)
            if scan.torn_tail is not None:
                os.truncate(path, scan.torn_tail)
            vscan = ChainStore.scan(store._read_bytes_path(path))
            if not vscan.clean:
                row["verdict"] = 2
                worst = 2
            else:
                row["verdict"] = 1
                row["records_salvaged"] = len(vscan.spans)
                salvaged_any = True
            rows.append(row)
        status = (
            "unrecoverable"
            if worst == 2
            else ("salvaged" if salvaged_any else "clean")
        )
        report = {
            "config": "fsck",
            "store": store_path,
            "layout": "segmented",
            "pruned_below": store.pruned_below,
            "segments": rows,
            "status": status,
        }
        print(json.dumps(report))
        return 2 if worst == 2 else (1 if salvaged_any else 0)
    finally:
        if lf is not None:
            lf.close()
        store.close()


def run_fsck(
    store_path: str, out_path: str | None, json_out: bool = False
) -> int:
    """Offline store integrity scan + salvage (the disk counterpart of
    Bitcoin's -checkblocks/salvagewallet tooling).  Exit contract:

    - **0 clean** — every record checksum-valid, nothing rewritten (a
      lossless v2→v3 upgrade also exits 0: no information was lost);
    - **1 salvaged** — corruption or a torn tail was found; every
      checksum-valid record was rewritten into a fresh verified store,
      bad spans quarantined to the ``.quarantine`` sidecar;
    - **2 unrecoverable** — missing/empty/locked store, unrecognizable
      magic, or zero salvageable records.

    Unlike ``p1 compact`` this preserves insertion order and side
    branches (it salvages the LOG, not the main branch), so the
    self-check is framing-level — every salvaged record re-reads
    checksum-valid and byte-identical — rather than the linear-chain
    ``replay_packed`` proof compaction can afford.

    Segmented stores (chain/segstore.py) scan and salvage PER SEGMENT —
    ``_fsck_segmented``; ``json_out`` (`p1 fsck --json`) emits the
    machine-readable per-segment report (one row per segment with its
    own verdict/spans/salvage counts) for both layouts, same exit
    codes."""
    import struct

    from p1_tpu_torch.chain import ChainStore
    from p1_tpu_torch.chain.segstore import is_segmented
    from p1_tpu_torch.chain.store import fsync_dir
    from p1_tpu_torch.core.block import Block

    if not os.path.exists(store_path) or os.path.getsize(store_path) == 0:
        print(f"{store_path}: empty or missing chain store", file=sys.stderr)
        return 2
    if is_segmented(store_path):
        if out_path:
            print(
                "segmented stores salvage in place (bounded per-segment "
                "rewrites); --out applies to single-file stores only",
                file=sys.stderr,
            )
            return 2
        return _fsck_segmented(store_path, json_out)

    def _emit(report: dict, status: str, verdict: int) -> None:
        """One print, two shapes: the legacy flat report (default), or
        the --json per-segment shape shared with segmented stores."""
        if not json_out:
            print(json.dumps({**report, "status": status}))
            return
        row = {
            "segment": os.path.basename(report["store"]),
            "pruned": False,
            "sealed": False,
            "verdict": verdict,
            "records_valid": report["records_valid"],
            "bad_spans": report["bad_spans"],
            "bytes_quarantined": report["bytes_quarantined"],
            "torn_tail_bytes": report["torn_tail_bytes"],
        }
        if "records_salvaged" in report:
            row["records_salvaged"] = report["records_salvaged"]
        print(
            json.dumps(
                {
                    "config": "fsck",
                    "store": report["store"],
                    "layout": "single",
                    "version": report["version"],
                    "segments": [row],
                    "status": status,
                }
            )
        )

    store = ChainStore(store_path)
    try:
        try:
            # Lock first (a live node's in-flight appends must not race
            # the rewrite), scan without healing: fsck owns the salvage
            # decision and must report BEFORE mutating.
            store.acquire(allow_v2=True, heal=False)
        except RuntimeError as e:
            print(str(e), file=sys.stderr)
            return 2
        data = store._read_bytes()
        scan = store.scan(data)
        report = {
            "config": "fsck",
            "store": store_path,
            "version": scan.version,
            "records_valid": len(scan.spans),
            "bad_spans": len(scan.bad_spans),
            "bytes_quarantined": scan.quarantined_bytes,
            "torn_tail_bytes": (
                scan.size - scan.torn_tail if scan.torn_tail is not None else 0
            ),
        }
        if scan.version == 3 and scan.clean:
            _emit(report, "clean", 0)
            return 0

        # Salvage: every checksum-valid record that still parses as a
        # block, in original insertion order, into a fresh v3 store.
        blocks, parse_failures = [], 0
        for off, n in scan.spans:
            try:
                blocks.append(Block.deserialize(data[off : off + n]))
            except ValueError:
                parse_failures += 1
        report["parse_failures"] = parse_failures
        if not blocks:
            _emit(report, "unrecoverable", 2)
            print(
                f"{store_path}: no salvageable records", file=sys.stderr
            )
            return 2
        if scan.bad_spans:
            # Evidence first, durably, before the original bytes go away.
            qpath = store.quarantine_path()
            with open(qpath, "ab") as qf:
                for s, e in scan.bad_spans:
                    qf.write(struct.pack(">QI", s, e - s))
                    qf.write(data[s:e])
                qf.flush()
                os.fsync(qf.fileno())
            report["quarantine"] = str(qpath)
        out = out_path or store_path
        tmp = f"{out}.fsck.{os.getpid()}"
        dst = ChainStore(tmp, fsync=False)
        try:
            for block in blocks:
                dst.append(block)
            dst.sync()
            dst._fsync_dir()
        finally:
            dst.close()
        # Self-check BEFORE the replace: the fresh store must re-scan
        # clean with every record byte-identical to what was salvaged —
        # a miswritten salvage must never clobber the evidence.
        vdata = ChainStore(tmp)._read_checked()
        vscan = ChainStore.scan(vdata)
        ok = (
            vscan.version == 3
            and vscan.clean
            and len(vscan.spans) == len(blocks)
            and all(
                vdata[off : off + n] == block.serialize()
                for (off, n), block in zip(vscan.spans, blocks)
            )
        )
        if not ok:
            os.unlink(tmp)
            print(
                "salvage self-check failed — original store left untouched",
                file=sys.stderr,
            )
            return 2
        os.replace(tmp, out)
        fsync_dir(os.path.dirname(os.path.abspath(out)))
        lossless = (
            not scan.bad_spans
            and scan.torn_tail is None
            and not parse_failures
        )
        report.update(
            {
                "records_salvaged": len(blocks),
                "out": out,
            }
        )
        _emit(
            report,
            "upgraded" if lossless else "salvaged",
            0 if lossless else 1,
        )
        return 0 if lossless else 1
    finally:
        store.close()
