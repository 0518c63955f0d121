"""Signed test chains for the store benchmarks: the port's ``build_blocks``.

The port holds only ``build_blocks`` of ``benchmarks/host_ingest.py``: the
chain that ``sig_verify.bench_revalidate`` and ``chip_smoke.py`` save to a
store and load back untrusted.  The same arguments give byte-identical
blocks in both packages.  The port signs in pure Python, a ladder per
signature, so the transfers are signed up front in worker processes
(``sig_verify.sign_many``): RFC 8032 signing is deterministic, so the
signatures are the ones ``Transaction.transfer`` would make one by one.
The ingest, resume and replay measurements of the JAX package's harness
are not ported.
"""

from __future__ import annotations


def build_blocks(n_blocks: int, txs_per_block: int, difficulty: int):
    """Mine a valid n-block chain carrying signed transfers; return the
    chain and the wire bytes of every post-genesis block (what gossip
    would deliver)."""
    import dataclasses

    from p1_tpu_torch.benchmarks.sig_verify import sign_many
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
    unsigned = [
        Transaction(alice.account, "bob", 1, 1, seq, chain=tag)
        for seq in range(max(0, n_blocks - 1) * txs_per_block)
    ]
    sigs = sign_many((alice._seed, tx.signing_bytes()) for tx in unsigned)
    transfers = [
        dataclasses.replace(tx, pubkey=alice.pubkey, sig=sig)
        for tx, sig in zip(unsigned, sigs)
    ]
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
