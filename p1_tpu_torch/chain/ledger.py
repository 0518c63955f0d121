"""Account ledger: balances + account nonces as consensus state.

Capability parity: the reference is "a Bitcoin-like toy cryptocurrency"
whose "chain-validation code paths" are a named capability (BASELINE.json:5
via SURVEY.md §0).  Round 4 makes account state *consensus*: a block that
spends money its sender does not have — or replays an already-confirmed
authorization — cannot connect to the main chain.

The port's copy of ``p1_tpu/chain/ledger.py``: the same balances,
nonces, fee accounting and error text.

Two layers live here:

- ``Ledger`` — the incremental account state at the chain tip.  ``Chain``
  applies blocks as the tip advances and *undoes* them across reorgs using
  the exact removed/added paths ``add_block`` already computes, so keeping
  the ledger current is O(blocks moved), never O(chain).  ``apply_block``
  is transactional: it validates the whole block against the running state
  (in tx order — a transfer may spend coins received earlier in the same
  block, including the block's own coinbase) and raises ``LedgerError``
  without mutating anything if any transfer overdraws or reuses a
  sequence number.
- ``balances`` — the original pure *view* over an arbitrary block
  iterable, kept for audit (``p1 balances`` on a store) and as a test
  oracle against the incremental state.  The view itself never rejects;
  on a consensus-valid main chain it can never print a negative balance
  because ``Chain`` refused the overdraw at connect time.

Rules (mirrored exactly by the view): the coinbase credits its recipient
the block subsidy; each transfer debits sender ``amount + fee`` (must not
overdraw at its position in block order) and credits the recipient; the
summed fees credit the block's miner (its coinbase recipient) at block end,
or are burned for the rare coinbase-less block.

**Sequence numbers are strict account nonces** (the Ethereum account-model
rule): transfer i from an account must carry ``seq`` equal to the number
of transfers that account has already confirmed on this chain, so one
signed authorization spends exactly once — a hostile miner re-including a
confirmed transfer in a later block fails ``seq == nonce`` and the block
cannot connect.  Nonces are part of the undo state: a reorg that abandons
a spend rolls the nonce back, and the transaction becomes valid to
re-confirm on the new branch (the mempool resurrects it).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

from p1_tpu_torch.core.block import Block


class LedgerError(Exception):
    """A block's transfers overdraw an account or reuse a sequence number
    (contextual invalidity)."""


@dataclasses.dataclass
class _BlockDelta:
    """Net effect of one block: balance shifts + per-sender transfer counts."""

    balances: dict[str, int]
    nonces: dict[str, int]


class Ledger:
    """Mutable account state (balances + nonces) with transactional block
    apply/undo."""

    def __init__(self) -> None:
        self._balances: dict[str, int] = {}
        #: account -> number of transfers it has confirmed (= the seq its
        #: NEXT transfer must carry).  Absent key = 0.
        self._nonces: dict[str, int] = {}

    def balance(self, account: str) -> int:
        return self._balances.get(account, 0)

    def nonce(self, account: str) -> int:
        """The seq the account's next transfer must carry."""
        return self._nonces.get(account, 0)

    def snapshot(self) -> dict[str, int]:
        """Copy of all non-zero balances (JSON-ready, for status/CLI)."""
        return {a: v for a, v in self._balances.items() if v}

    def nonces_snapshot(self) -> dict[str, int]:
        """Copy of all non-zero account nonces — the other half of the
        consensus state a snapshot (chain/snapshot.py) must carry: a
        snapshot that restored balances but forgot nonces would re-open
        every confirmed authorization for replay."""
        return {a: n for a, n in self._nonces.items() if n}

    def copy(self) -> "Ledger":
        """Independent copy of the full state — what checkpoint-state
        materialization rolls back (``Chain.snapshot_state``) without
        touching the live tip ledger."""
        dup = Ledger()
        dup._balances = dict(self._balances)
        dup._nonces = dict(self._nonces)
        return dup

    @classmethod
    def restore(
        cls, balances: dict[str, int], nonces: dict[str, int]
    ) -> "Ledger":
        """A ledger seeded from externally supplied state (a verified
        snapshot).  Zero entries are dropped on the way in so the
        invariant ``_shift`` maintains (no zero-valued keys) holds from
        the first block applied."""
        ledger = cls()
        ledger._balances = {a: v for a, v in balances.items() if v}
        ledger._nonces = {a: n for a, n in nonces.items() if n}
        return ledger

    def apply_block(self, block: Block) -> None:
        """Credit/debit ``block``'s transactions; all-or-nothing.

        Raises ``LedgerError`` (leaving the ledger untouched) if any
        transfer overdraws its sender or carries a wrong sequence number
        at its position in block order.
        """
        self._shift(self._block_delta(block, check=True), +1)

    def undo_block(self, block: Block) -> None:
        """Reverse a previously-applied block (reorg rollback).  Never
        fails: the inverse of a valid application is always consistent."""
        self._shift(self._block_delta(block, check=False), -1)

    def _shift(self, delta: _BlockDelta, sign: int) -> None:
        """Merge a block delta into the state (zero entries are dropped) —
        the ONE place the merge rule lives."""
        for account, d in delta.balances.items():
            v = self._balances.get(account, 0) + sign * d
            if v:
                self._balances[account] = v
            else:
                self._balances.pop(account, None)
        for account, n in delta.nonces.items():
            v = self._nonces.get(account, 0) + sign * n
            if v:
                self._nonces[account] = v
            else:
                self._nonces.pop(account, None)

    def _block_delta(self, block: Block, check: bool) -> _BlockDelta:
        """Net effect of ``block``; with ``check`` the running (base +
        partial delta) balance is enforced non-negative at every debit and
        every transfer's seq must equal its sender's running nonce, in tx
        order."""
        delta: dict[str, int] = {}
        counts: dict[str, int] = {}
        miner: str | None = None
        fees = 0
        for i, tx in enumerate(block.txs):
            if i == 0 and tx.is_coinbase:
                miner = tx.recipient
                delta[miner] = delta.get(miner, 0) + tx.amount
                continue
            if check:
                expected = self._nonces.get(tx.sender, 0) + counts.get(
                    tx.sender, 0
                )
                if tx.seq != expected:
                    raise LedgerError(
                        f"tx {tx.txid().hex()[:16]} has seq {tx.seq}, "
                        f"{tx.sender} is at nonce {expected} (replay or gap)"
                    )
                cost = tx.amount + tx.fee
                have = self._balances.get(tx.sender, 0) + delta.get(
                    tx.sender, 0
                )
                if have < cost:
                    raise LedgerError(
                        f"tx {tx.txid().hex()[:16]} overdraws {tx.sender}: "
                        f"spends {cost}, has {have}"
                    )
            counts[tx.sender] = counts.get(tx.sender, 0) + 1
            delta[tx.sender] = delta.get(tx.sender, 0) - (tx.amount + tx.fee)
            delta[tx.recipient] = delta.get(tx.recipient, 0) + tx.amount
            fees += tx.fee
        if miner is not None and fees:
            delta[miner] = delta.get(miner, 0) + fees
        return _BlockDelta(delta, counts)


def balances(blocks: Iterable[Block]) -> dict[str, int]:
    """Account -> balance over ``blocks`` (pass ``chain.main_chain()``).

    Pure audit view — applies the same rules as ``Ledger`` but never
    rejects, so it can also describe hypothetical or pre-consensus block
    sequences in tests.
    """
    ledger = Ledger()
    for block in blocks:
        ledger._shift(ledger._block_delta(block, check=False), +1)
    return dict(ledger._balances)
