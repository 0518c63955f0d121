"""Archive-scale benchmark of the port: a synthetic multi-million-block
SEGMENTED store, and what it costs to build, resume, boot and query.

    python -m p1_tpu_torch.benchmarks.archive_scale [--blocks 100000]
        [--segment-mb 16] [--queries 2000] [--keep DIR]

The port of ``benchmarks/archive_scale.py``; all host code.  The store
is coinbase-only and LINEAR (genesis at record 0, ordinal == height —
the compacted archive shape), crafted at the BYTE level: one template
coinbase transaction whose seq field is patched per height, headers
packed directly, records appended through ``SegmentedStore.append_raw``
— no Block objects in the build loop.  The first blocks are
cross-checked byte-identical against the object serializer, so the
synthetic store is exactly what a node would have written.

Phases, each its own figure:

- **ingest** (``archive_ingest_bps``) — crafted records/s through the
  segmented append plane (CRC framing, rolls, hdrx seals; fsync off);
- **resume** (``archive_resume_bps``) — whole-archive packed-header
  extraction (``SegmentedStore.packed_headers``): the scan-everything
  rate a header-plane rebuild or full PoW replay pays;
- **boot** (``archive_boot_s`` / ``archive_boot_rss_mb``) — a FRESH
  process (``python -m p1_tpu_torch.benchmarks.archive_scale --phase
  boot``) opens ``ArchiveChain`` (snapshot ledger + mmap'd header plane
  + bounded tail replay) and serves header/balance/proof queries; peak
  RSS is VmHWM from /proc.  That process imports no torch: the header
  plane and the stores are host code, and torch's import alone would
  add hundreds of MB to the very figure measured.
- **query** (``archive_query_qps``) — random-height header queries
  against the booted archive (mmap page touches, no object builds).

Default is a 100k-block store; ``bench`` runs the 10M shape only under
``P1_BENCH_ARCHIVE=1``.
"""

from __future__ import annotations

import argparse
import json
import os
import struct
import subprocess
import sys
import time
from pathlib import Path

#: The checkout root, where ``python -m p1_tpu_torch...`` resolves.
ROOT = Path(__file__).resolve().parents[2]
_U32 = struct.Struct(">I")
_HDR = struct.Struct(">I32s32sIII")
_MINER = "bench-miner"

#: Snapshot cadence for the synthetic archive: the boot's tail replay
#: is bounded by one interval, so keep it small relative to the store.
SNAP_INTERVAL = 4096


def _tx_template(miner: str) -> tuple[bytearray, int]:
    """(mutable coinbase tx bytes, offset of the u64 seq field)."""
    from p1_tpu_torch.core.tx import Transaction

    a = Transaction.coinbase(miner, 0).serialize()
    b = Transaction.coinbase(miner, 1).serialize()
    assert len(a) == len(b)
    # seq is the only differing field; it is a big-endian u64 ending at
    # the last differing byte.
    last_diff = max(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
    seq_off = last_diff - 7
    return bytearray(a), seq_off


def build_archive(
    store_path: Path,
    n_blocks: int,
    segment_bytes: int,
    difficulty: int = 1,
    snap_interval: int = SNAP_INTERVAL,
) -> dict:
    """Craft the linear store + its snapshot sidecar; returns timings."""
    from hashlib import sha256

    from p1_tpu_torch.chain import snapshot as snapmod
    from p1_tpu_torch.chain.segstore import SegmentedStore
    from p1_tpu_torch.core.block import Block
    from p1_tpu_torch.core.genesis import make_genesis
    from p1_tpu_torch.core.tx import BLOCK_REWARD, Transaction
    from p1_tpu_torch.core.header import BlockHeader

    def sha256d(b: bytes) -> bytes:
        return sha256(sha256(b).digest()).digest()

    genesis = make_genesis(difficulty)
    tx, seq_off = _tx_template(_MINER)
    pack_seq = struct.Struct(">Q").pack_into
    base = (max(n_blocks - 1, 1) // snap_interval) * snap_interval
    anchor_payload: bytes | None = None
    store = SegmentedStore(
        store_path, fsync=False, segment_bytes=segment_bytes
    )
    t0 = time.perf_counter()
    store.append_raw(genesis.serialize(), height=0)
    prev = genesis.block_hash()
    ts0 = genesis.header.timestamp
    tx_len_prefix = _U32.pack(1) + _U32.pack(len(tx))
    for h in range(1, n_blocks):
        pack_seq(tx, seq_off, h)
        txid = sha256d(tx)
        hdr = _HDR.pack(1, prev, txid, ts0 + h, difficulty, 0)
        payload = hdr + tx_len_prefix + bytes(tx)
        if h <= 3:
            # Self-check: crafted bytes are EXACTLY what the object
            # layer serializes — the synthetic store is real.
            real = Block(
                header=BlockHeader(1, prev, txid, ts0 + h, difficulty, 0),
                txs=[Transaction.coinbase(_MINER, h)],
            ).serialize()
            assert payload == real, "crafted record diverged from objects"
        store.append_raw(payload, height=h)
        if h == base:
            anchor_payload = payload
        prev = sha256d(hdr)
        if h % 262144 == 0:
            # The span dict is the only O(chain) term in the builder;
            # the archive boot reindexes lazily from disk anyway.
            store._body_spans.clear()
    store.sync()
    build_s = time.perf_counter() - t0
    segments = len(store.segments)
    store.close()
    # The snapshot sidecar: the miner's whole subsidy stream at the
    # base height — byte-for-byte what chain.snapshot_state() packages
    # for this chain shape.
    assert anchor_payload is not None
    anchor = Block.deserialize(anchor_payload)
    balances = {_MINER: base * BLOCK_REWARD}
    manifest, chunks = snapmod.build_records(base, anchor, balances, {})
    snap_path = store_path.with_name(store_path.name + ".archsnap")
    snapmod.write_snapshot(snap_path, manifest, chunks)
    return {
        "build_s": round(build_s, 3),
        "archive_ingest_bps": round((n_blocks - 1) / build_s),
        "segments": segments,
        "snapshot_base": base,
        "store_bytes": sum(
            f.stat().st_size
            for f in store_path.with_name(store_path.name + ".d").iterdir()
        ),
    }


def measure_resume(store_path: Path) -> dict:
    """Whole-archive packed-header extraction rate (the full-scan
    resume/rebuild shape)."""
    from p1_tpu_torch.chain.segstore import SegmentedStore

    store = SegmentedStore(store_path)
    t0 = time.perf_counter()
    raw, count = store.packed_headers()
    dt = time.perf_counter() - t0
    store.close()
    return {
        "archive_resume_bps": round(count / dt),
        "resume_records": count,
        "resume_s": round(dt, 3),
    }


def boot_phase(store_path: str, difficulty: int, queries: int) -> None:
    """Process body: boot the archive, serve queries, report the peak
    resident set (``rss.PeakSampler``: VmHWM, or sampled where ``/proc``
    keeps none)."""
    import random
    from hashlib import sha256

    from p1_tpu_torch.benchmarks.rss import PeakSampler
    from p1_tpu_torch.chain.headerplane import ArchiveChain

    snap = store_path + ".archsnap"
    with PeakSampler() as rss:
        t0 = time.perf_counter()
        arch = ArchiveChain(store_path, snap, difficulty)
        boot_s = time.perf_counter() - t0
        rng = random.Random(18)
        height = arch.height
        # Header queries: random heights across the WHOLE archive.
        t0 = time.perf_counter()
        for _ in range(queries):
            h = rng.randrange(0, height + 1)
            assert arch.header_bytes_at(h) is not None
        query_s = time.perf_counter() - t0
        # Balance + cold proofs (plane txid lookups + one record read).
        assert arch.balance(_MINER) > 0
        tx, seq_off = _tx_template(_MINER)
        proofs = 0
        t0 = time.perf_counter()
        for _ in range(min(100, queries)):
            h = rng.randrange(1, height + 1)
            struct.Struct(">Q").pack_into(tx, seq_off, h)
            txid = sha256(sha256(bytes(tx)).digest()).digest()
            proof = arch.tx_proof(txid)
            assert proof is not None and proof.height == h
            proofs += 1
        proof_s = time.perf_counter() - t0
    arch.close()
    print(
        json.dumps(
            {
                "archive_boot_s": round(boot_s, 4),
                "archive_boot_rss_mb": round(rss.peak_kb() / 1024.0, 1),
                "archive_query_qps": round(queries / query_s),
                "archive_proof_qps": round(proofs / proof_s),
                "height": height,
                "torch_imported": "torch" in sys.modules,
            }
        )
    )


def measure_boot(store_path: Path, difficulty: int, queries: int) -> dict:
    """Run the boot phase in a FRESH process so VmHWM is the archive
    serving footprint, not this builder's."""
    path = os.environ.get("PYTHONPATH")
    env = {**os.environ, "PYTHONPATH": str(ROOT) + (os.pathsep + path if path else "")}
    proc = subprocess.run(
        [
            sys.executable,
            "-m",
            "p1_tpu_torch.benchmarks.archive_scale",
            "--phase",
            "boot",
            "--store",
            str(store_path),
            "--difficulty",
            str(difficulty),
            "--queries",
            str(queries),
        ],
        capture_output=True,
        text=True,
        timeout=1800,
        cwd=ROOT,
        env=env,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"boot phase failed: {proc.stderr[-2000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    if out["torch_imported"]:
        raise RuntimeError("the boot process imported torch: its RSS is not the archive's")
    return out


def bench_archive(
    n_blocks: int,
    segment_bytes: int = 16 << 20,
    difficulty: int = 1,
    queries: int = 2000,
    keep: str | None = None,
) -> dict:
    import tempfile

    ctx = (
        tempfile.TemporaryDirectory(prefix="p1archive")
        if keep is None
        else None
    )
    tmp = Path(ctx.name) if ctx is not None else Path(keep)
    tmp.mkdir(parents=True, exist_ok=True)
    try:
        store_path = tmp / "archive.dat"
        out = {"blocks": n_blocks, "segment_bytes": segment_bytes}
        if not store_path.exists():
            out.update(build_archive(store_path, n_blocks, segment_bytes))
        out.update(measure_resume(store_path))
        out.update(measure_boot(store_path, difficulty, queries))
        return out
    finally:
        if ctx is not None:
            ctx.cleanup()


def bench_quick(blocks: int = 100_000) -> dict:
    """The ``bench`` probe: the 100k shape (seconds of wall time), same
    code path as the 10M acceptance run."""
    return bench_archive(blocks)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--blocks", type=int, default=100_000)
    ap.add_argument("--segment-mb", type=int, default=16)
    ap.add_argument("--difficulty", type=int, default=1)
    ap.add_argument("--queries", type=int, default=2000)
    ap.add_argument(
        "--keep", default=None, help="build/reuse the store in this dir"
    )
    ap.add_argument(
        "--phase", choices=("all", "boot"), default="all"
    )
    ap.add_argument("--store", default=None, help="(boot phase) store path")
    args = ap.parse_args()
    if args.phase == "boot":
        boot_phase(args.store, args.difficulty, args.queries)
        return
    out = bench_archive(
        args.blocks,
        segment_bytes=args.segment_mb << 20,
        difficulty=args.difficulty,
        queries=args.queries,
        keep=args.keep,
    )
    print(json.dumps(out))


if __name__ == "__main__":
    main()
