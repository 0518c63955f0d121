"""Ledger scale benchmark of the port: the in-RAM account map at 1M accounts.

    python -m p1_tpu_torch.benchmarks.ledger_scale [--accounts 1000000]
        [--sender-frac 0.1]

The port of ``benchmarks/ledger_scale.py``; host code.  Snapshot sync
makes the ledger the thing a new node downloads, so its in-RAM
representation is a scale surface of its own.  Two candidate
representations, measured head to head on the machine it runs on:

- **two-dict** (the shipped ``Ledger``): ``balances: dict[str, int]`` +
  ``nonces: dict[str, int]``.  Costs the key string twice for accounts
  that carry both, but values are bare ints and accounts without
  nonces (most of them — only SENDERS have nonces) pay one entry.
- **slotted-entry**: one ``dict[str, _Account]`` with
  ``__slots__ = ("balance", "nonce")``.  One key per account, but an
  object shell per entry where the two-dict pays an int.

Reported per representation: RSS growth building N accounts (VmRSS
delta — the whole-process figure), per-lookup latency over random
accounts, and per-block apply latency (``Ledger.apply_block`` with a
transfer-carrying block) for the shipped form.  One JSON line.
"""

from __future__ import annotations

import argparse
import gc
import json
import random
import time

def _vm_rss() -> int:
    with open("/proc/self/status") as fh:
        for line in fh:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no VmRSS")


class _Account:
    __slots__ = ("balance", "nonce")

    def __init__(self, balance: int, nonce: int):
        self.balance = balance
        self.nonce = nonce


def _accounts(n: int):
    return [f"acct-{i:09d}" for i in range(n)]


def bench_two_dict(names, sender_frac: float, rng) -> dict:
    gc.collect()
    rss0 = _vm_rss()
    balances: dict[str, int] = {}
    nonces: dict[str, int] = {}
    for name in names:
        balances[name] = 100
        if rng.random() < sender_frac:
            nonces[name] = 3
    gc.collect()
    grew = _vm_rss() - rss0
    probe = rng.sample(names, min(100_000, len(names)))
    t0 = time.perf_counter()
    acc = 0
    for name in probe:
        acc += balances.get(name, 0) + nonces.get(name, 0)
    dt = time.perf_counter() - t0
    assert acc > 0
    out = {
        "rss_bytes": grew,
        "bytes_per_account": round(grew / len(names), 1),
        "lookup_ns": round(1e9 * dt / len(probe), 1),
    }
    del balances, nonces
    return out


def bench_slotted(names, sender_frac: float, rng) -> dict:
    gc.collect()
    rss0 = _vm_rss()
    table: dict[str, _Account] = {}
    for name in names:
        table[name] = _Account(100, 3 if rng.random() < sender_frac else 0)
    gc.collect()
    grew = _vm_rss() - rss0
    probe = rng.sample(names, min(100_000, len(names)))
    t0 = time.perf_counter()
    acc = 0
    for name in probe:
        entry = table.get(name)
        if entry is not None:
            acc += entry.balance + entry.nonce
    dt = time.perf_counter() - t0
    assert acc > 0
    out = {
        "rss_bytes": grew,
        "bytes_per_account": round(grew / len(names), 1),
        "lookup_ns": round(1e9 * dt / len(probe), 1),
    }
    del table
    return out


def bench_apply(n_accounts: int, rng) -> dict:
    """Per-block ledger apply/undo on the SHIPPED Ledger with the map
    pre-grown to ``n_accounts`` — the latency a tip move pays at scale."""
    from p1_tpu_torch.chain.ledger import Ledger
    from p1_tpu_torch.core.keys import Keypair
    from p1_tpu_torch.core.tx import Transaction

    ledger = Ledger.restore(
        {f"acct-{i:09d}": 100 for i in range(n_accounts)}, {}
    )
    alice = Keypair.from_seed_text("ledger-scale-alice")
    ledger._balances[alice.account] = 10_000

    class _FakeBlock:
        def __init__(self, txs):
            self.txs = txs

    rounds = 200
    t0 = time.perf_counter()
    for i in range(rounds):
        txs = [Transaction.coinbase("miner", i + 1)]
        for j in range(4):
            txs.append(
                Transaction(
                    sender=alice.account,
                    recipient=f"acct-{rng.randrange(n_accounts):09d}",
                    amount=1,
                    fee=0,
                    # Each round is undone, so the nonce rewinds too.
                    seq=j,
                )
            )
        block = _FakeBlock(tuple(txs))
        ledger.apply_block(block)
        ledger.undo_block(block)
    dt = time.perf_counter() - t0
    return {"apply_undo_us_per_block": round(1e6 * dt / rounds, 1)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--accounts", type=int, default=1_000_000)
    ap.add_argument(
        "--sender-frac",
        type=float,
        default=0.1,
        help="fraction of accounts that also carry a nonce entry",
    )
    args = ap.parse_args()
    rng = random.Random(0)
    names = _accounts(args.accounts)
    # Two-dict FIRST, slotted second, each measured as RSS growth from
    # its own baseline; the name list is shared (and excluded from both
    # growth figures by construction).
    two = bench_two_dict(names, args.sender_frac, random.Random(1))
    gc.collect()
    slotted = bench_slotted(names, args.sender_frac, random.Random(1))
    apply_stats = bench_apply(min(args.accounts, 1_000_000), rng)
    print(
        json.dumps(
            {
                "config": "ledger_scale",
                "accounts": args.accounts,
                "sender_frac": args.sender_frac,
                "two_dict": two,
                "slotted": slotted,
                **apply_stats,
                "winner": (
                    "two_dict"
                    if two["rss_bytes"] <= slotted["rss_bytes"]
                    else "slotted"
                ),
            }
        )
    )


if __name__ == "__main__":
    main()
