"""Snapshot-boot benchmark of the port: seconds from cold store to serving queries.

    python -m p1_tpu_torch.benchmarks.snapshot_boot [--blocks 100000]
        [--accounts 1000] [--tx-every 50] [--store S] [--device cpu]

The port of ``benchmarks/snapshot_boot.py``: a fresh node joining a long
chain serves balance/header/proof queries in seconds from a state
snapshot, against the full revalidation it replaces — both measured in
the SAME run, on the same store.

Three timed paths over one mined store:

- **revalidate** — ``ChainStore.load_chain(trusted=False)``: the full
  untrusted boot (PoW, merkle, batched Ed25519 on the active batch rung —
  ``hashx/csrc/ed25519_msm.cu`` on the card under the default
  ``device`` rung, its plain PyTorch version under ``--device cpu`` —
  connect-time ledger): what a snapshotless new node pays.
- **trusted** — ``load_chain(trusted=True)``: the fast restart of a
  node's OWN store, for context.
- **snapshot** — ``load_snapshot`` (CRC framing + chunk digests + state
  root) → ``Chain.from_snapshot`` → first balance + header + tip-proof
  query answered.  O(accounts), independent of chain length.

The default shape mines coinbase-only blocks with a rotating miner
identity (``--accounts`` distinct ids) plus two signed transfers every
``--tx-every`` blocks, so the revalidation baseline pays real signature
checks without the fixture build drowning in pure-Python signing.

One JSON line; ``bench_quick`` is ``bench``'s probe (small store, same
code path) read against ``RECORDED_SNAPSHOT_BOOT_S``.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

def build_store(
    path,
    n_blocks: int,
    accounts: int = 1000,
    tx_every: int = 50,
    difficulty: int = 1,
):
    """Mine an ``n_blocks`` chain to ``path``: coinbase rotates over
    ``accounts`` miner ids (so the ledger holds that many balances) and
    every ``tx_every``-th block carries two signed transfers (so the
    revalidation baseline pays real Ed25519 work; the transfers are
    signed up front in worker processes)."""
    from p1_tpu_torch.benchmarks.host_ingest import signed_transfers
    from p1_tpu_torch.chain import ChainStore
    from p1_tpu_torch.core.block import Block, merkle_root
    from p1_tpu_torch.core.genesis import make_genesis
    from p1_tpu_torch.core.header import BlockHeader
    from p1_tpu_torch.core.keys import Keypair
    from p1_tpu_torch.core.tx import BLOCK_REWARD, Transaction
    from p1_tpu_torch.hashx import get_backend
    from p1_tpu_torch.miner import Miner

    alice = Keypair.from_seed_text("snapshot-boot-alice")
    bob = Keypair.from_seed_text("snapshot-boot-bob")
    miner = Miner(backend=get_backend("cpu"))
    genesis = make_genesis(difficulty)
    chain_tag = genesis.block_hash()
    # Which heights carry alice's two transfers: her coinbase heights
    # fund them, each costs 2 (amount + fee).
    funds = transfers = 0
    for height in range(1, n_blocks + 1):
        funds += BLOCK_REWARD if height % tx_every == 1 else 0
        if tx_every and height % tx_every == 0 and funds >= 4:
            transfers += 2
            funds -= 4
    signed = iter(signed_transfers(alice, bob.account, transfers, chain_tag))
    store = ChainStore(path, fsync=False)
    store.acquire()
    store.append(genesis)
    prev = genesis
    alice_funds = 0
    for height in range(1, n_blocks + 1):
        # Alice's coinbase heights fund her transfers later.
        mine_to_alice = height % tx_every == 1
        miner_id = (
            alice.account if mine_to_alice else f"acct-{height % accounts:06d}"
        )
        txs = [Transaction.coinbase(miner_id, height)]
        if mine_to_alice:
            alice_funds += txs[0].amount
        if tx_every and height % tx_every == 0 and alice_funds >= 4:
            for _ in range(2):
                txs.append(next(signed))
                alice_funds -= 2
        header = BlockHeader(
            version=1,
            prev_hash=prev.block_hash(),
            merkle_root=merkle_root([tx.txid() for tx in txs]),
            timestamp=prev.header.timestamp + 1,
            difficulty=difficulty,
            nonce=0,
        )
        sealed = miner.search_nonce(header)
        assert sealed is not None
        prev = Block(sealed, tuple(txs))
        store.append(prev)
    store.sync()
    store.close()


def bench_store(path, difficulty: int = 1, interval: int = 0) -> dict:
    """All three boot measurements over an existing store; also writes
    (and fully verifies) the snapshot file next to it."""
    from p1_tpu_torch.chain import ChainStore
    from p1_tpu_torch.chain import snapshot as chain_snapshot
    from p1_tpu_torch.chain.chain import Chain

    out: dict = {}

    # Untrusted full revalidation (the figure a snapshot boot replaces).
    store = ChainStore(path)
    t0 = time.perf_counter()
    chain = store.load_chain(difficulty, trusted=False)
    out["revalidate_boot_s"] = round(time.perf_counter() - t0, 3)
    out["height"] = chain.height
    store.close()

    # Trusted resume, for context.
    store = ChainStore(path)
    t0 = time.perf_counter()
    store.load_chain(difficulty, trusted=True)
    out["trusted_boot_s"] = round(time.perf_counter() - t0, 3)
    store.close()

    # Snapshot create (NOT part of the boot figure: the SERVING side
    # pays it once per checkpoint) ...
    if interval > 0:
        chain.checkpoint_interval = interval
        chain.state_checkpoints.clear()
    state = chain.snapshot_state()
    assert state is not None, "store too short for a checkpoint"
    height, block, balances, nonces, _root = state
    manifest_payload, chunks = chain_snapshot.build_records(
        height, block, balances, nonces
    )
    snap_file = Path(str(path) + ".bench-snapshot")
    chain_snapshot.write_snapshot(snap_file, manifest_payload, chunks)
    out["snapshot_height"] = height
    out["snapshot_accounts"] = len(set(balances) | set(nonces))
    out["snapshot_bytes"] = snap_file.stat().st_size

    # ... and the snapshot BOOT: verify + build the assumed chain +
    # answer one balance, one header, and one tip-proof query.
    t0 = time.perf_counter()
    snap = chain_snapshot.load_snapshot(snap_file)
    assumed = Chain.from_snapshot(difficulty, snap)
    anchor = assumed.tip
    assert assumed.balance(anchor.txs[0].recipient) >= 0
    assert assumed.header_of(assumed.tip_hash) is not None
    proof = assumed.tx_proof(anchor.txs[0].txid())
    assert proof is not None
    # Microseconds kept: at ``bench``'s shape the boot is a few ms.
    out["snapshot_boot_s"] = round(time.perf_counter() - t0, 6)
    out["boot_speedup"] = round(
        out["revalidate_boot_s"] / max(out["snapshot_boot_s"], 1e-9), 1
    )
    snap_file.unlink()
    return out


def bench_quick(blocks: int = 2000, repeats: int = 3) -> dict:
    """The ``bench`` probe: a small same-shape store, best-of-N on the
    snapshot boot (the revalidation baseline runs once — it dominates
    the probe's budget as it is)."""
    with tempfile.TemporaryDirectory(prefix="p1snapboot") as tmp:
        path = Path(tmp) / "store.dat"
        build_store(path, blocks)
        best: dict = {}
        for _ in range(repeats):
            out = bench_store(path)
            if not best or out["snapshot_boot_s"] < best["snapshot_boot_s"]:
                best = out
        return best


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--blocks", type=int, default=100_000)
    ap.add_argument("--accounts", type=int, default=1000)
    ap.add_argument("--tx-every", type=int, default=50)
    ap.add_argument("--difficulty", type=int, default=1)
    ap.add_argument(
        "--store", default=None, help="reuse this store instead of mining"
    )
    ap.add_argument(
        "--interval", type=int, default=0, help="checkpoint interval override"
    )
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()
    if args.device == "cpu":
        from p1_tpu_torch.core import keys

        keys.set_sig_backend("device", device="cpu")
    if args.store:
        out = bench_store(args.store, args.difficulty, args.interval)
        out["blocks"] = out["height"]
    else:
        with tempfile.TemporaryDirectory(prefix="p1snapboot") as tmp:
            path = Path(tmp) / "store.dat"
            t0 = time.perf_counter()
            build_store(
                path,
                args.blocks,
                accounts=args.accounts,
                tx_every=args.tx_every,
                difficulty=args.difficulty,
            )
            build_s = time.perf_counter() - t0
            out = bench_store(path, args.difficulty, args.interval)
            out["build_s"] = round(build_s, 3)
    print(json.dumps({"config": "snapshot_boot", **out}))


if __name__ == "__main__":
    main()
