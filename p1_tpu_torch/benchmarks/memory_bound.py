"""Memory-bounded operation benchmark of the port: peak RSS and refetch latency.

    python -m p1_tpu_torch.benchmarks.memory_bound [--blocks 10000,100000]
        [--body-cache 1024]

The port of ``benchmarks/memory_bound.py``; host code.  The governor's
memory-bounded operation keeps headers and metadata resident but evicts
block *bodies* once they are durably refetchable from the append-only
store (``Chain.evict_bodies`` / ``ChainStore.read_body``), and streams
the resume itself through the same eviction (``load_chain(body_cache=N)``)
so boot never materializes the O(chain) object graph either.

For each chain length it prints, from a fresh process each (``python -m
p1_tpu_torch.benchmarks.memory_bound --measure STORE``; a high-water
mark never comes back down, so resident and bounded resumes must not
share a process), one JSON line with:

- **resident** — ``load_chain(trusted=True)`` with ``body_cache=0``:
  the fully-resident behaviour (the "before" column).
- **bounded** — ``load_chain(trusted=True, body_cache=N)``: peak RSS,
  resume wall time, bodies evicted, and the on-demand body refetch
  latency (p50/p95 over deep-history ``chain.get`` calls, which miss
  the keep window by construction).

The fixture: difficulty 1, one signed transfer every other block,
built once and copied at each requested height; the transfers are
signed up front in worker processes.  The measuring processes import no
torch (the stores are host code): their RSS is interpreter + chain,
what a node's memory plan has to budget for, and torch's import alone
would add hundreds of MB to it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

DIFFICULTY = 1
#: The checkout root, where ``python -m p1_tpu_torch...`` resolves.
ROOT = Path(__file__).resolve().parents[2]


def build_store(heights: list[int], outdir: Path) -> dict[int, Path]:
    """One incremental build, snapshotted at each requested height;
    returns {height: store path}.  The builder keeps the chain resident
    (validity needs the ledger anyway) and appends as it goes — the
    store file at height H is byte-identical to a node that mined/synced
    H blocks."""
    from p1_tpu_torch.benchmarks.host_ingest import signed_transfers
    from p1_tpu_torch.chain.chain import Chain
    from p1_tpu_torch.chain.store import ChainStore
    from p1_tpu_torch.core.block import Block, merkle_root
    from p1_tpu_torch.core.header import BlockHeader
    from p1_tpu_torch.core.keys import Keypair
    from p1_tpu_torch.core.tx import Transaction
    from p1_tpu_torch.hashx import get_backend
    from p1_tpu_torch.miner import Miner

    alice = Keypair.from_seed_text("memory-bound-alice")
    chain = Chain(DIFFICULTY)
    tag = chain.genesis.block_hash()
    miner = Miner(backend=get_backend("cpu"))
    top = max(heights)
    transfers = iter(signed_transfers(alice, "bob", top // 2, tag))
    path = outdir / f"membench-{top}.chain"
    store = ChainStore(path, fsync=False)
    snapshots: dict[int, Path] = {}
    try:
        for height in range(1, top + 1):
            txs = [Transaction.coinbase(alice.account, height)]
            if height > 1 and height % 2 == 0:
                txs.append(next(transfers))
            parent = chain.tip
            draft = BlockHeader(
                version=1,
                prev_hash=parent.block_hash(),
                merkle_root=merkle_root([tx.txid() for tx in txs]),
                # +1 s per block: strictly increasing (the consensus
                # floor) without overflowing uint32 at 100k heights the
                # way a cumulative +height cadence does.
                timestamp=parent.header.timestamp + 1,
                difficulty=DIFFICULTY,
                nonce=0,
            )
            sealed = miner.search_nonce(draft)
            assert sealed is not None
            block = Block(sealed, tuple(txs))
            res = chain.add_block(block)
            assert res.status.value == "accepted", res
            store.append(block)
            if height in heights:
                store.sync()
                snap = outdir / f"membench-{height}.chain"
                if snap != path:
                    snap.write_bytes(path.read_bytes())
                snapshots[height] = snap
    finally:
        store.close()
    return snapshots


def measure(store_path: Path, body_cache: int) -> dict:
    """One resume measurement, in THIS process (``main`` runs it via a
    fresh subprocess per data point)."""
    from p1_tpu_torch.benchmarks.rss import PeakSampler
    from p1_tpu_torch.chain.store import ChainStore

    store = ChainStore(store_path, fsync=False)
    with PeakSampler() as rss:
        t0 = time.perf_counter()
        chain = store.load_chain(DIFFICULTY, trusted=True, body_cache=body_cache)
        resume_s = time.perf_counter() - t0
    out = {
        "body_cache": body_cache,
        "blocks": chain.height,
        "resume_s": round(resume_s, 3),
        # VmHWM (reset by execve, unlike ru_maxrss, which a child of a
        # large parent inherits), sampled where /proc keeps none.
        "peak_rss_bytes": rss.peak_kb() * 1024,
        "resident_body_bytes": chain.resident_body_bytes,
        "bodies_evicted": chain.bodies_evicted,
        "torch_imported": "torch" in sys.modules,
    }
    if body_cache > 0 and chain.height > body_cache:
        # Deep-history refetch latency: every sampled height is below
        # the keep window, so each get() is a real pread + deserialize.
        deep = chain.height - body_cache
        step = max(1, deep // 256)
        lats = []
        for h in range(1, deep, step):
            bh = chain._main_hashes[h]
            t0 = time.perf_counter()
            blk = chain.get(bh)
            lats.append(time.perf_counter() - t0)
            assert blk is not None and blk.block_hash() == bh
        lats.sort()
        out["refetch_samples"] = len(lats)
        out["refetch_us_p50"] = round(lats[len(lats) // 2] * 1e6, 1)
        out["refetch_us_p95"] = round(lats[int(len(lats) * 0.95)] * 1e6, 1)
    store.close()
    return out


def measure_in_process(store_path: Path, body_cache: int) -> dict:
    """``measure`` in a fresh ``python -m`` process of this module, which
    must not have imported torch."""
    path = os.environ.get("PYTHONPATH")
    env = {**os.environ, "PYTHONPATH": str(ROOT) + (os.pathsep + path if path else "")}
    proc = subprocess.run(
        [sys.executable, "-m", "p1_tpu_torch.benchmarks.memory_bound", "--measure", str(store_path),
         "--body-cache", str(body_cache)],
        capture_output=True, text=True, check=True, cwd=ROOT, env=env,
    )  # fmt: skip
    out = json.loads(proc.stdout)
    if out["torch_imported"]:
        raise RuntimeError("the measuring process imported torch: its RSS is not the chain's")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--blocks",
        default="10000,100000",
        help="comma-separated chain lengths to measure (default 10k,100k)",
    )
    ap.add_argument(
        "--body-cache",
        type=int,
        default=1024,
        help="keep-recent window for the bounded runs (default 1024)",
    )
    ap.add_argument(
        "--measure",
        help="(internal) run one resume measurement against this store "
        "and print its JSON — main spawns one subprocess per "
        "data point so ru_maxrss high-water marks stay independent",
    )
    args = ap.parse_args()
    if args.measure:
        print(json.dumps(measure(Path(args.measure), args.body_cache)))
        return

    heights = sorted({int(x) for x in args.blocks.split(",") if x})
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        snapshots = build_store(heights, Path(tmp))
        build_s = time.perf_counter() - t0
        for height in heights:
            snap = snapshots[height]
            row = {"blocks": height, "store_bytes": snap.stat().st_size}
            for label, cache in (
                ("resident", 0),
                ("bounded", args.body_cache),
            ):
                row[label] = measure_in_process(snap, cache)
            results.append(row)
    print(
        json.dumps(
            {
                "metric": "resume_peak_rss_bytes",
                "value": results[-1]["bounded"]["peak_rss_bytes"],
                "unit": "bytes",
                "vs_resident": round(
                    results[-1]["bounded"]["peak_rss_bytes"]
                    / results[-1]["resident"]["peak_rss_bytes"],
                    3,
                ),
                "body_cache": args.body_cache,
                "build_s": round(build_s, 1),
                "runs": results,
            }
        )
    )


if __name__ == "__main__":
    sys.exit(main())
