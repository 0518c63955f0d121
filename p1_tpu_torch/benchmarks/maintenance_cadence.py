"""Maintenance-cadence benchmark of the port: the always-on node's steady costs.

    python -m p1_tpu_torch.benchmarks.maintenance_cadence [--accounts 100000]
        [--delta 64] [--repeats 3] [--blocks 192]

The port of ``benchmarks/maintenance_cadence.py``; host code.  Two
figures, measured in ONE run on one ledger shape:

- **continuous snapshots** — rebuilds/sec for the incremental
  per-checkpoint snapshot build (``build_records_incremental``,
  O(delta): only the accounts the blocks since the last checkpoint
  touched re-encode and re-hash) against the full rebuild
  (``build_records``, O(accounts)) it replaces.  The ratio is the
  cadence headroom: how much tighter a node can publish snapshot
  heights without the build dominating its block budget.
- **live rebase latency** — milliseconds for ``Chain.rebase`` to
  advance an in-RAM base past a deep history (the in-RAM half of
  ``maintain rebase``).  This is the stall a rebase costs a serving
  node's event loop.

Shapes: ``--accounts`` ledger entries (default 100k; the 1M shape is
``--accounts 1000000``), ``--delta`` dirty accounts per incremental
build, ``--blocks`` in-RAM chain length for the rebase probe.

One JSON line; ``bench_quick`` is ``bench``'s probe (small shapes, same
code paths) read against ``RECORDED_SNAPSHOT_CADENCE_BPS`` /
``RECORDED_REBASE_MS`` in ``p1_tpu_torch/hashx/perf_record.py``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

def _ledger(accounts: int) -> tuple[dict, dict]:
    balances = {f"acct-{i:07d}": 50 + (i % 97) for i in range(accounts)}
    nonces = {k: i % 5 for i, k in enumerate(balances)}
    return balances, nonces


def bench_snapshot_cadence(
    accounts: int = 100_000, delta: int = 64, repeats: int = 3
) -> dict:
    """Incremental vs full snapshot build over one ``accounts``-sized
    ledger, ``delta`` dirty accounts per incremental round.  Both paths
    build the SAME post-mutation state (the identity is test-pinned in
    tests/test_torch_maintenance.py; here we only time it)."""
    from p1_tpu_torch.chain.snapshot import build_records, build_records_incremental
    from p1_tpu_torch.node.testing import make_blocks

    block = make_blocks(1, difficulty=1)[-1]
    balances, nonces = _ledger(accounts)
    # Warm state: the residue every steady-state checkpoint build has.
    _, _, state, _ = build_records_incremental(
        None, 4, block, balances, nonces, set(balances)
    )
    keys = sorted(balances)
    full_s = []
    incr_s = []
    reused = 0
    for r in range(repeats):
        dirty = {keys[(r * delta + j) % accounts] for j in range(delta)}
        for k in dirty:
            balances[k] += 1  # in-place: no key shift, the honest delta
        t0 = time.perf_counter()
        build_records(4, block, balances, nonces)
        full_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        _, chunks, state, got = build_records_incremental(
            state, 4, block, balances, nonces, dirty
        )
        incr_s.append(time.perf_counter() - t0)
        reused = got
    full = min(full_s)
    incr = min(incr_s)
    return {
        "accounts": accounts,
        "delta_accounts": delta,
        "snapshot_full_builds_per_sec": round(1.0 / full, 1),
        "snapshot_incr_builds_per_sec": round(1.0 / incr, 1),
        "snapshot_cadence_speedup": round(full / incr, 1),
        "snapshot_chunks_reused": reused,
        "snapshot_chunks_total": len(chunks),
    }


def bench_rebase(blocks: int = 192, interval: int = 16) -> dict:
    """In-RAM rebase latency: a ``blocks``-deep chain advances its base
    to the newest checkpoint ``interval`` blocks behind the tip — the
    on-loop cost of ``maintain rebase`` (the durable store half runs
    off-loop and is the archive bench's territory)."""
    from p1_tpu_torch.chain.chain import Chain
    from p1_tpu_torch.node.testing import make_blocks

    mined = make_blocks(blocks, difficulty=1)
    chain = Chain(1)
    chain.checkpoint_interval = interval
    for b in mined[1:]:
        res = chain.add_block(b, trusted=True)
        assert res.status.value == "accepted", res
    target = ((chain.height - interval) // interval) * interval
    t0 = time.perf_counter()
    stats = chain.rebase(target)
    rebase_ms = (time.perf_counter() - t0) * 1e3
    return {
        "rebase_blocks": blocks,
        "rebase_ms": round(rebase_ms, 3),
        "rebase_dropped_blocks": stats["dropped_blocks"],
        "rebase_freed_bytes": stats["freed_bytes"],
    }


def bench_quick(
    accounts: int = 20_000, delta: int = 64, blocks: int = 96
) -> dict:
    """The ``bench`` probe: small shapes, the same code paths as the
    100k run at a fraction of the cost."""
    out = bench_snapshot_cadence(accounts=accounts, delta=delta, repeats=3)
    out.update(bench_rebase(blocks=blocks, interval=16))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--accounts", type=int, default=100_000)
    ap.add_argument("--delta", type=int, default=64)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--blocks", type=int, default=192)
    args = ap.parse_args(argv)
    out = bench_snapshot_cadence(
        accounts=args.accounts, delta=args.delta, repeats=args.repeats
    )
    out.update(bench_rebase(blocks=args.blocks))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
