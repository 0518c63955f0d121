"""Host ingest benchmark of the port: the serialization plane, end to end.

    python -m p1_tpu_torch.benchmarks.host_ingest [--blocks 1000] [--txs 2]
        [--replay-n 20000] [--repeats 3] [--cores 1,2,4] [--device cpu]

The port of ``benchmarks/host_ingest.py``, measured on the machine it
runs on and printed as ONE JSON line:

- **ingest** — blocks/s through the object-plane pipeline a gossip frame
  pays: ``Block.deserialize(wire bytes)`` → ``Chain.add_block`` (the full
  stateless ``check_block`` and the connect-time ledger), with every
  transfer's signature already in the verify-once memo, the state
  mempool admission leaves a block in;
- **resume** — blocks/s through ``ChainStore.load_chain(trusted=True)``
  from a real on-disk store: the node-restart path;
- **staged ingest** (``--cores``) — blocks/s through the staged pipeline
  (``node/pipeline.py``): deserialize on the loop, signature
  pre-verification on the validate lane (cold cache), ``add_block`` on
  the loop, fsynced appends on the store lane; a ladder of worker counts
  plus the unstaged control through the same harness;
- **replay** — headers/s verifying a mined header chain from
  ``BlockHeader`` objects (``replay_fast``: the native engine where it
  builds, else the hashlib oracle), the hashlib oracle, the pre-packed
  native ceiling, and ``replay_device`` — one launch of
  ``hashx/csrc/verify_chain.cu`` on the card (its plain PyTorch version
  under ``--device cpu``).

Difficulty 1 keeps mining the fixtures cheap while the PoW checks stay
real.  ``build_blocks`` is also the signed chain that
``sig_verify.bench_revalidate`` and ``chip_smoke.py`` save to a store and
load back untrusted; the same arguments give byte-identical blocks in
both packages.  The port signs in pure Python, a ladder per signature,
so the transfers are signed up front in worker processes
(``sig_verify.sign_many``): RFC 8032 signing is deterministic, so the
signatures are the ones ``Transaction.transfer`` would make one by one.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path


def signed_transfers(key, recipient: str, count: int, chain_tag: bytes, seq0: int = 0) -> list:
    """``count`` transfers of 1 (fee 1) from ``key`` to ``recipient`` with
    seq ``seq0``, ``seq0 + 1``, ...: ``Transaction.transfer``'s, signed
    in worker processes."""
    import dataclasses

    from p1_tpu_torch.benchmarks.sig_verify import sign_many
    from p1_tpu_torch.core.tx import Transaction

    unsigned = [
        Transaction(key.account, recipient, 1, 1, seq, chain=chain_tag)
        for seq in range(seq0, seq0 + count)
    ]
    sigs = sign_many((key._seed, tx.signing_bytes()) for tx in unsigned)
    return [
        dataclasses.replace(tx, pubkey=key.pubkey, sig=sig)
        for tx, sig in zip(unsigned, sigs)
    ]


def build_blocks(n_blocks: int, txs_per_block: int, difficulty: int):
    """Mine a valid n-block chain carrying signed transfers; return the
    chain and the wire bytes of every post-genesis block (what gossip
    would deliver)."""
    from p1_tpu_torch.chain.chain import Chain
    from p1_tpu_torch.core.block import Block, merkle_root
    from p1_tpu_torch.core.header import BlockHeader
    from p1_tpu_torch.core.keys import Keypair
    from p1_tpu_torch.core.tx import Transaction
    from p1_tpu_torch.hashx import get_backend
    from p1_tpu_torch.miner import Miner

    alice = Keypair.from_seed_text("host-ingest-alice")
    chain = Chain(difficulty)
    tag = chain.genesis.block_hash()
    miner = Miner(backend=get_backend("cpu"))
    # Transfers only once the ledger can afford them (coinbase at height h
    # is spendable from height h+1's perspective here since the ledger
    # credits on connect): heights 2..n, seq counting up across them.
    transfers = signed_transfers(alice, "bob", max(0, n_blocks - 1) * txs_per_block, tag)
    raws: list[bytes] = []
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
            timestamp=parent.header.timestamp + height,
            difficulty=difficulty,
            nonce=0,
        )
        sealed = miner.search_nonce(draft)
        assert sealed is not None
        block = Block(sealed, tuple(txs))
        res = chain.add_block(block)
        assert res.status.value == "accepted", res
        raws.append(block.serialize())
    return chain, raws


def bench_ingest(raws: list[bytes], difficulty: int, repeats: int) -> float:
    """Best-of-N blocks/s: deserialize -> full-validation add_block."""
    from p1_tpu_torch.chain.chain import AddStatus, Chain
    from p1_tpu_torch.core.block import Block

    best = 0.0
    for _ in range(repeats):
        chain = Chain(difficulty)
        t0 = time.perf_counter()
        for raw in raws:
            res = chain.add_block(Block.deserialize(raw))
            assert res.status is AddStatus.ACCEPTED
        dt = time.perf_counter() - t0
        best = max(best, len(raws) / dt)
    return best


async def _staged_drive(raws: list[bytes], difficulty: int, cores: int, path: Path) -> float:
    """One staged-ingest pass in the node's pipeline shape, blocks/s.

    Drives the stage split as ``Node._handle_block`` does — deserialize on
    the loop, signature pre-verification on the validate lane,
    ``add_block`` on the loop, fsynced append on the store lane — with the
    1-deep overlap a node gets from its peer coroutines: validate(i+1) and
    store(i) run on their lanes while connect(i) runs on the loop.
    ``cores == 0`` runs the same harness through the inline (unstaged)
    pipeline, the staging-overhead control.  A fresh ``SignatureCache``
    per pass makes the validate stage pay real signature math every run.
    """
    import asyncio

    from p1_tpu_torch.chain.chain import AddStatus, Chain
    from p1_tpu_torch.chain.store import ChainStore
    from p1_tpu_torch.chain.validate import preverify_signatures
    from p1_tpu_torch.core.block import Block
    from p1_tpu_torch.core.sigcache import SignatureCache
    from p1_tpu_torch.node.pipeline import NodePipeline

    cache = SignatureCache()
    chain = Chain(difficulty)
    chain.sig_cache = cache
    tag = chain.genesis.block_hash()
    store = ChainStore(path, fsync=True)
    pipeline = NodePipeline(workers=cores)

    async def validate(idx: int):
        block = Block.deserialize(raws[idx])
        await pipeline.run_validate(preverify_signatures, block.txs, tag, cache, nbytes=len(raws[idx]))
        return block

    try:
        t0 = time.perf_counter()
        # Store jobs ride the lane's FIFO (submission order is append
        # order), so the loop only back-pressures at a bounded depth.
        store_jobs: list = []
        nxt = asyncio.ensure_future(validate(0))
        for i in range(len(raws)):
            block = await nxt
            if i + 1 < len(raws):
                nxt = asyncio.ensure_future(validate(i + 1))
            res = chain.add_block(block)
            assert res.status is AddStatus.ACCEPTED, res
            if len(store_jobs) >= 8:
                await store_jobs.pop(0)
            store_jobs.append(asyncio.ensure_future(pipeline.run_store(store.append, block, nbytes=len(raws[i]))))
        for job in store_jobs:
            await job
        dt = time.perf_counter() - t0
    finally:
        pipeline.drain_and_close()
        store.close()
    assert chain.height == len(raws)
    return len(raws) / dt


def bench_staged_ingest(raws: list[bytes], difficulty: int, cores_ladder: list[int], repeats: int, tmpdir: str) -> dict:
    """Best-of-N staged blocks/s per rung of the cores ladder, plus the
    unstaged (cores=0) control through the same harness."""
    import asyncio

    from p1_tpu_torch.core import keys

    out: dict = {}
    prev_workers = keys.verify_workers()
    run = 0
    try:
        for cores in [0, *cores_ladder]:
            # As Node.__init__: the pipeline's worker count sizes the
            # verify pool.
            keys.set_verify_workers(cores)
            best = 0.0
            for _ in range(repeats):
                run += 1
                path = Path(tmpdir) / f"staged_{cores}_{run}.chain"
                best = max(best, asyncio.run(_staged_drive(raws, difficulty, cores, path)))
            out[cores] = best
    finally:
        keys.set_verify_workers(prev_workers)
    return out


def bench_resume(raws: list[bytes], difficulty: int, repeats: int, tmpdir: str) -> float:
    """Best-of-N blocks/s through the trusted-resume path from disk."""
    from p1_tpu_torch.chain.store import ChainStore
    from p1_tpu_torch.core.block import Block

    path = Path(tmpdir) / "ingest_bench.chain"
    store = ChainStore(path, fsync=False)
    try:
        for raw in raws:
            store.append(Block.deserialize(raw))
    finally:
        store.close()
    best = 0.0
    for _ in range(repeats):
        store = ChainStore(path, fsync=False)
        try:
            t0 = time.perf_counter()
            chain = store.load_chain(difficulty, trusted=True)
            dt = time.perf_counter() - t0
        finally:
            store.close()
        assert chain.height == len(raws)
        best = max(best, len(raws) / dt)
    return best


def bench_replay(n_headers: int, repeats: int, device: str = "cuda") -> dict:
    """Headers/s from objects (``replay_fast``), the hashlib oracle, the
    pre-packed native ceiling (where the native engine builds), and
    ``replay_device`` on ``device`` (``verify_chain.cu`` on the card)."""
    from p1_tpu_torch.chain.replay import generate_headers, replay_device, replay_fast, replay_host
    from p1_tpu_torch.hashx import get_backend
    from p1_tpu_torch.hashx.native_build import NativeBuildError

    headers = generate_headers(n_headers, difficulty=1, backend=get_backend("cpu"))
    for h in headers:  # warm encodings: the as-held-by-a-node plane
        h.serialize()
    out: dict = {"replay_n": n_headers}
    best = 0.0
    for _ in range(repeats):
        report = replay_fast(headers)
        assert report.valid
        best = max(best, report.headers_per_sec)
    out["replay_object_hps"] = round(best)
    out["replay_method"] = report.method
    best = 0.0
    for _ in range(repeats):
        host = replay_host(headers)
        assert host.valid
        best = max(best, host.headers_per_sec)
    out["replay_host_hps"] = round(best)
    try:
        from p1_tpu_torch.hashx.native_backend import verify_header_chain

        raw = b"".join(h.serialize() for h in headers)
        best = 0.0
        for _ in range(repeats):
            t0 = time.perf_counter()
            assert verify_header_chain(raw, len(headers), 1) is None
            best = max(best, len(headers) / (time.perf_counter() - t0))
        out["replay_native_raw_hps"] = round(best)
    except (NativeBuildError, OSError):  # no toolchain: the ceiling row is absent
        pass
    replay_device(headers, device=device)  # the kernel's build and load
    best = 0.0
    for _ in range(repeats):
        dev = replay_device(headers, device=device)
        assert dev.valid
        best = max(best, dev.headers_per_sec)
    out["replay_device_hps"] = round(best)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--blocks", type=int, default=1000)
    ap.add_argument("--txs", type=int, default=2, help="transfers per block")
    ap.add_argument("--replay-n", type=int, default=20_000)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument(
        "--cores",
        default=None,
        help="staged-ingest mode: a worker count (`4`) or a scaling ladder "
        "(`1,2,4`); each rung runs the staged harness with that many pipeline "
        "workers (and a matching verify pool), plus an unstaged cores=0 control",
    )
    ap.add_argument(
        "--device",
        choices=("cuda", "cpu"),
        default="cuda",
        help="where replay_device and the device signature rung run "
        "(cpu: the kernels' plain PyTorch versions)",
    )
    args = ap.parse_args(argv)

    from p1_tpu_torch.core import keys

    if args.device == "cpu":
        keys.set_sig_backend("device", device="cpu")
    difficulty = 1
    chain, raws = build_blocks(args.blocks, args.txs, difficulty)
    # Warm the signature memo (the mempool-admission state a block meets).
    for block in chain.main_chain():
        for tx in block.txs:
            assert tx.verify_signature()

    ingest_bps = bench_ingest(raws, difficulty, args.repeats)
    staged: dict = {}
    with tempfile.TemporaryDirectory() as tmpdir:
        resume_bps = bench_resume(raws, difficulty, args.repeats, tmpdir)
        if args.cores:
            ladder = sorted({int(c) for c in str(args.cores).split(",") if int(c) > 0})
            rungs = bench_staged_ingest(raws, difficulty, ladder, args.repeats, tmpdir)
            from p1_tpu_torch.hashx.perf_record import RECORDED_STAGED_INGEST_BPS

            top = ladder[-1]
            unstaged = rungs[0]
            staged = {
                "staged_cores": top,
                "staged_ingest_bps": round(rungs[top], 1),
                "staged_ingest_vs_recorded": round(rungs[top] / RECORDED_STAGED_INGEST_BPS, 2),
                "staged_scaling_bps": {str(c): round(rungs[c], 1) for c in ladder},
                "unstaged_driver_bps": round(unstaged, 1),
            }
            if 1 in ladder and unstaged > 0:
                staged["staged_1core_overhead_pct"] = round((unstaged - rungs[1]) / unstaged * 100.0, 1)
    replay = bench_replay(args.replay_n, args.repeats, device=args.device)

    from p1_tpu_torch.hashx.perf_record import RECORDED_HOST_INGEST_BPS

    print(
        json.dumps(
            {
                "metric": "host_ingest_blocks_per_sec",
                "value": round(ingest_bps, 1),
                "unit": "blocks/s",
                "vs_recorded": round(ingest_bps / RECORDED_HOST_INGEST_BPS, 2),
                "n_blocks": args.blocks,
                "txs_per_block": args.txs,
                "resume_bps": round(resume_bps, 1),
                "sig_backend": keys.backend(),
                **staged,
                **replay,
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
