"""Query-plane benchmark of the port: the read serving tier, host-side.

    python -m p1_tpu_torch.benchmarks.query_plane [--blocks 120] [--txs 48]
        [--repeats 3]

The port of ``benchmarks/query_plane.py``: queries/s of the serving
plane — inclusion proofs above all — with the serial-per-proof baseline
measured in the SAME run, printed as one JSON line.  All host code; the
fixture chain is mined with the hashlib ``cpu`` backend at difficulty 1
(fixture data, not the measured path).

Measurements (all on one fixture chain of ``--blocks`` blocks carrying
``--txs`` signed transfers each):

- **proof_serial_qps** — every proof rebuilt from scratch (txid list +
  full merkle branch per query, cache disabled) and wire-encoded: what
  GETPROOF costs without the tier.
- **proof_batched_qps** — cold proof cache, queries clustered by block:
  one merkle-tree construction amortized across every transaction of a
  block (chain/proof.py ``build_block_proofs``), wire-encode included.
- **proof_cached_qps** — steady state: the bounded LRU holds the
  serialized payloads, each serve is a dict hit plus the 4-byte
  tip-height patch (protocol.patch_proof_tip): a replica worker's hot
  loop per query.
- **filter_build_bps / filter_match_bps** — blocks/s building compact
  filters (the connect-time cost) and matching a wallet's watch set
  against a prebuilt filter stream (the light-client download loop),
  plus filter bytes/block (the light client's bandwidth price).
- **replica_index_bps** — blocks/s through ``ReplicaView`` attach (the
  mmap scan + txid index a ``serve`` worker pays once at startup).

JSON keys: {"metric": "proof_cached_qps", "value": ..., ...} with the
serial/batched/filter figures as extra keys; ``vs_serial`` is the
headline speedup (cached / serial).
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

def build_chain(n_blocks: int, txs_per_block: int, difficulty: int = 1):
    """A valid chain with signed transfers (same fixture recipe as
    host_ingest.py; the transfers signed up front in worker processes)."""
    from p1_tpu_torch.benchmarks.host_ingest import signed_transfers
    from p1_tpu_torch.chain.chain import Chain
    from p1_tpu_torch.core.block import Block, merkle_root
    from p1_tpu_torch.core.header import BlockHeader
    from p1_tpu_torch.core.keys import Keypair
    from p1_tpu_torch.core.tx import Transaction
    from p1_tpu_torch.hashx import get_backend
    from p1_tpu_torch.miner import Miner

    alice = Keypair.from_seed_text("query-plane-alice")
    chain = Chain(difficulty)
    tag = chain.genesis.block_hash()
    miner = Miner(backend=get_backend("cpu"))
    transfers = signed_transfers(alice, "bob", max(0, n_blocks - 1) * txs_per_block, tag)
    for height in range(1, n_blocks + 1):
        txs = [Transaction.coinbase(alice.account, height)]
        if height > 1:
            start = (height - 2) * txs_per_block
            txs += transfers[start : start + txs_per_block]
        parent = chain.tip
        draft = BlockHeader(
            version=1,
            prev_hash=parent.block_hash(),
            merkle_root=merkle_root([tx.txid() for tx in txs]),
            timestamp=parent.header.timestamp + 60,
            difficulty=difficulty,
            nonce=0,
        )
        sealed = miner.search_nonce(draft)
        assert sealed is not None
        res = chain.add_block(Block(sealed, tuple(txs)))
        assert res.status.value == "accepted", res
    return chain


def _transfer_txids(chain) -> list[bytes]:
    out = []
    for block in chain.main_chain():
        for tx in block.txs:
            if not tx.is_coinbase:
                out.append(tx.txid())
    return out


def bench_proofs(chain, txids, repeats: int = 3) -> dict:
    """serial / batched / cached proofs-per-second over ``txids``."""
    from p1_tpu_torch.chain.proof import ProofCache
    from p1_tpu_torch.core.block import merkle_branch
    from p1_tpu_torch.chain.proof import TxProof
    from p1_tpu_torch.node import protocol

    # Serial baseline: the pre-cache GETPROOF path — txid index lookup,
    # whole-block txid list, O(ntx) merkle branch, fresh encode.  Kept
    # inline (not Chain.tx_proof, which now batches by design) so the
    # baseline stays measurable forever.
    def serial_one(txid: bytes) -> bytes:
        bhash = chain._tx_index[txid]
        entry = chain._index[bhash]
        block = chain._block_at(bhash)
        tids = [tx.txid() for tx in block.txs]
        index = tids.index(txid)
        proof = TxProof(
            tx=block.txs[index],
            header=block.header,
            height=entry.height,
            tip_height=chain.height,
            index=index,
            branch=merkle_branch(tids, index),
        )
        return protocol.encode_proof(proof)

    sample = txids[: min(len(txids), 2000)]
    best_serial = 0.0
    for _ in range(repeats):
        t0 = time.perf_counter()
        for txid in sample:
            serial_one(txid)
        dt = time.perf_counter() - t0
        best_serial = max(best_serial, len(sample) / dt)

    def payload(txid: bytes) -> bytes:
        entry = chain.tx_proof_entry(txid)
        if entry.payload is None:
            chain.proof_cache.note_payload(
                entry, protocol.encode_proof(entry.proof)
            )
        return protocol.patch_proof_tip(entry.payload, chain.height)

    # Batched: cold cache each repeat, every transfer proof cut once —
    # the first-touch cost of a block's whole proof set.
    best_batched = 0.0
    for _ in range(repeats):
        chain.proof_cache = ProofCache(max_bytes=256 << 20)
        t0 = time.perf_counter()
        for txid in txids:
            payload(txid)
        dt = time.perf_counter() - t0
        best_batched = max(best_batched, len(txids) / dt)

    # Cached: steady state over the warm LRU (the previous loop warmed
    # payloads too).
    best_cached = 0.0
    for _ in range(repeats):
        t0 = time.perf_counter()
        for txid in txids:
            payload(txid)
        dt = time.perf_counter() - t0
        best_cached = max(best_cached, len(txids) / dt)

    return {
        "proof_serial_qps": round(best_serial),
        "proof_batched_qps": round(best_batched),
        "proof_cached_qps": round(best_cached),
        "proofs_sampled": len(txids),
    }


def bench_filters(chain, repeats: int = 3) -> dict:
    """Filter build + match rates and the bytes/block price."""
    from p1_tpu_torch.chain import filters

    blocks = list(chain.main_chain())[1:]
    best_build = 0.0
    built: list[tuple[bytes, bytes]] = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        built = [(b.block_hash(), filters.block_filter(b)) for b in blocks]
        dt = time.perf_counter() - t0
        best_build = max(best_build, len(blocks) / dt)
    watch = [b"bob", b"nobody-watches-this-account"]
    best_match = 0.0
    for _ in range(repeats):
        t0 = time.perf_counter()
        hits = sum(
            1
            for bhash, f in built
            if filters.matches_any(f, bhash, watch)
        )
        dt = time.perf_counter() - t0
        best_match = max(best_match, len(built) / dt)
    total_bytes = sum(len(f) for _, f in built)
    return {
        "filter_build_bps": round(best_build),
        "filter_match_bps": round(best_match),
        "filter_bytes_per_block": round(total_bytes / max(1, len(built)), 1),
        "filter_matched_blocks": hits,
    }


def bench_replica(chain, difficulty: int) -> dict:
    """ReplicaView attach rate (mmap scan + txid index) from a real
    on-disk store of the fixture chain."""
    from p1_tpu_torch.chain.store import save_chain
    from p1_tpu_torch.node.queryplane import ReplicaView

    with tempfile.TemporaryDirectory() as tmp:
        store = Path(tmp) / "chain.dat"
        save_chain(chain, store)
        t0 = time.perf_counter()
        view = ReplicaView(store, difficulty)
        dt = time.perf_counter() - t0
        assert view.tip_height == chain.height
        view.close()
        return {
            "replica_index_bps": round((chain.height + 1) / dt),
        }


def bench_quick(blocks: int = 60, txs: int = 24, repeats: int = 3) -> dict:
    """The ``bench`` hook: a small same-session measurement of the three
    proof rates (serial baseline included, same run)."""
    chain = build_chain(blocks, txs, difficulty=1)
    txids = _transfer_txids(chain)
    return bench_proofs(chain, txids, repeats=repeats)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--blocks", type=int, default=120)
    ap.add_argument("--txs", type=int, default=48, help="transfers per block")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()

    chain = build_chain(args.blocks, args.txs, difficulty=1)
    txids = _transfer_txids(chain)
    proofs = bench_proofs(chain, txids, repeats=args.repeats)
    filt = bench_filters(chain, repeats=args.repeats)
    replica = bench_replica(chain, difficulty=1)

    import os

    try:
        load_1m, load_5m, _ = os.getloadavg()
    except OSError:
        load_1m = load_5m = None

    print(
        json.dumps(
            {
                "metric": "proof_cached_qps",
                "value": proofs["proof_cached_qps"],
                "unit": "proofs/s",
                "vs_serial": round(
                    proofs["proof_cached_qps"]
                    / max(1, proofs["proof_serial_qps"]),
                    1,
                ),
                "batched_vs_serial": round(
                    proofs["proof_batched_qps"]
                    / max(1, proofs["proof_serial_qps"]),
                    1,
                ),
                "blocks": args.blocks,
                "txs_per_block": args.txs,
                "load_avg_1m": load_1m,
                "load_avg_5m": load_5m,
                "cpu_count": os.cpu_count(),
                **proofs,
                **filt,
                **replica,
            }
        )
    )


if __name__ == "__main__":
    main()
