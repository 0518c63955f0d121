"""Test chains mined from a seed: the port's ``make_blocks``.

The port's copy of ``make_blocks`` from ``p1_tpu/node/testing.py``: the
same arguments give byte-identical blocks in both packages, so the
chain-store crash soak (``chain/testing.append_soak``) and the tests can
build a chain in either package and compare.  The module's hostile-peer
harness (``FaultPlan``, ``HostilePeer``) needs the node and comes with the
slice that ports the simulation and fault planes.
"""

from __future__ import annotations

from p1_tpu_torch.core.block import Block, merkle_root
from p1_tpu_torch.core.header import BlockHeader
from p1_tpu_torch.core.tx import Transaction

__all__ = ["make_blocks"]


def make_blocks(
    n: int,
    difficulty: int = 12,
    miner_id: str = "hostile",
    txs_at: dict[int, tuple] | None = None,
) -> list[Block]:
    """Genesis plus ``n`` mined blocks at ``difficulty`` (fixed-rule
    chain, cpu backend — a few ms per block at difficulty 12).  Each
    block carries its height's coinbase plus any extra transactions from
    ``txs_at[height]`` (the caller funds and signs those; validation on
    the victim is the full consensus check, so they must be real)."""
    from p1_tpu_torch.core.genesis import make_genesis
    from p1_tpu_torch.hashx import get_backend
    from p1_tpu_torch.miner import Miner

    miner = Miner(backend=get_backend("cpu"))
    blocks = [make_genesis(difficulty)]
    for height in range(1, n + 1):
        parent = blocks[-1]
        txs = (
            Transaction.coinbase(miner_id, height),
            *(txs_at or {}).get(height, ()),
        )
        draft = BlockHeader(
            version=1,
            prev_hash=parent.block_hash(),
            merkle_root=merkle_root([tx.txid() for tx in txs]),
            timestamp=parent.header.timestamp + 1,
            difficulty=difficulty,
            nonce=0,
        )
        sealed = miner.search_nonce(draft)
        assert sealed is not None
        blocks.append(Block(sealed, txs))
    return blocks
